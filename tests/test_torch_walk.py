"""The PyTorch package's walk against the JAX package's, end to end.

The JAX tiny pipeline's weights are carried into the port's tiny bundle by
``from_jax_params``; both walk 2 prompts x 3 frames at 64x64 with pndm-4 and
``batch_size=2`` (the port pads its last dispatch to the bucket of 2).  The
frames must agree within 2/255 per pixel.  Also: resume regenerates only
missing frames, unported options raise, the port imports neither jax nor
the JAX package, and its audio schedule equals the JAX package's.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
from stable_diffusion_videos_tpu_torch.models.weights import (
    from_jax_params, load_state_dict)
from stable_diffusion_videos_tpu_torch.pipeline import \
    StableDiffusionWalkPipeline

from torch_threads import few_torch_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")
WALK = dict(prompts=["a red fox", "a blue lighthouse"], seeds=[7, 1234],
            num_interpolation_steps=3, height=64, width=64,
            num_inference_steps=4, batch_size=2, negative_prompt="blurry",
            make_video=False)


@pytest.fixture(scope="module")
def jax_pipeline():
    from stable_diffusion_videos_tpu.pipeline import \
        StableDiffusionWalkPipeline as JaxWalk
    return JaxWalk.tiny()


def port_pipeline(jax_pipeline) -> StableDiffusionWalkPipeline:
    jm = jax_pipeline.models
    models = SDModels.tiny()
    for module, part, cfg in ((models.unet, "unet", models.unet_config),
                              (models.vae, "vae", models.vae_config),
                              (models.text_encoder, "text_encoder",
                               models.text_config)):
        load_state_dict(module, from_jax_params(jm.params[part], cfg))
    return StableDiffusionWalkPipeline(models, CPU, batch_bucket=2)


def frames(run_dir: Path) -> dict:
    return {p.relative_to(run_dir).as_posix(): np.asarray(Image.open(p),
                                                          np.int32)
            for p in sorted(run_dir.glob("**/frame*.png"))}


def click_track(path: Path, sr: int = 22050, seconds: float = 1.0) -> Path:
    """A 220 Hz tone gated into 50 ms clicks twice a second, as a WAV
    written by the JAX package's ``save_wav``."""
    from stable_diffusion_videos_tpu.audio import save_wav
    t = np.arange(int(sr * seconds)) / sr
    save_wav(str(path), (0.1 * np.sin(2 * np.pi * 220 * t)
                         * (t % 0.5 < 0.05)).astype(np.float32), sr)
    return path


def test_walk_matches_jax(jax_pipeline, tmp_path):
    jax_dir = Path(jax_pipeline.walk(output_dir=str(tmp_path / "jax"),
                                     name="w", **WALK))
    port = port_pipeline(jax_pipeline)
    port_dir = Path(port.walk(output_dir=str(tmp_path / "port"), name="w",
                              **WALK))
    want, got = frames(jax_dir), frames(port_dir)
    assert sorted(got) == sorted(want) and len(got) == 3
    for name in want:
        assert got[name].shape == (64, 64, 3)
        assert np.abs(got[name] - want[name]).max() <= 2, name
    assert got["w_000000/frame000000.png"].std() > 0
    jcfg = json.loads((jax_dir / "prompt_config.json").read_text())
    pcfg = json.loads((port_dir / "prompt_config.json").read_text())
    assert sorted(pcfg) == sorted(jcfg)
    assert pcfg["framework"] == "stable_diffusion_videos_tpu_torch"


def test_resume_regenerates_only_missing_frames(tmp_path):
    pipe = StableDiffusionWalkPipeline.tiny(CPU)
    run = Path(pipe.walk(output_dir=str(tmp_path), name="r", **WALK))
    clip = run / "r_000000"
    before = frames(run)
    (clip / "frame000002.png").unlink()
    os.utime(clip / "frame000000.png", (1, 1))
    pipe.walk(output_dir=str(tmp_path), name="r", resume=True,
              make_video=False)
    after = frames(run)
    assert sorted(after) == sorted(before)
    np.testing.assert_array_equal(after["r_000000/frame000002.png"],
                                  before["r_000000/frame000002.png"])
    assert os.stat(clip / "frame000000.png").st_mtime == 1


def test_walk_with_video_and_audio(tmp_path):
    wav = click_track(tmp_path / "beat.wav")
    pipe = StableDiffusionWalkPipeline.tiny(CPU)
    video = pipe.walk(**{**WALK, "make_video": True}, fps=3,
                      audio_filepath=str(wav), output_dir=str(tmp_path),
                      name="v")
    assert Path(video).exists() and Path(video).stat().st_size > 0
    assert len(list((tmp_path / "v").glob("**/frame*.png"))) == 3


@pytest.mark.parametrize("where,kw", [
    ("pipeline", dict(mesh=object())), ("engine", dict(mesh=object())),
    ("engine", dict(spatial_shard=True)), ("engine", dict(debug=True))])
def test_unported_options_raise(where, kw, tmp_path):
    """What the port still refuses: the mesh (one card), spatial sharding
    and the debug program."""
    from stable_diffusion_videos_tpu_torch.runtime.engine import Engine
    with pytest.raises(NotImplementedError):
        if where == "pipeline":
            StableDiffusionWalkPipeline.tiny(CPU, **kw)
        else:
            Engine(SDModels.tiny(), CPU, **kw)
    with pytest.raises(TypeError, match="unexpected"):
        StableDiffusionWalkPipeline.tiny(CPU).walk(
            output_dir=str(tmp_path), **WALK, upsample_model="x.pth")


def test_port_never_imports_jax(tmp_path):
    """A walk with video and audio, one with dpm x ``step_cache=2``, one
    with lcm under ``frozen_noise``, a tiny SDXL-shaped walk under ``fast``,
    decodes through the tiny decoder and in tiles, an img2img, an inpaint,
    a vid2vid of the first walk's video, a tiny refiner's img2img, a TAESD
    encode, a walk with a ControlNet, an IP-Adapter and prompt
    weighting on a bundle with a LoRA and a textual-inversion file merged,
    a walk with the safety checker, Real-ESRGAN upsampling, ToMe and FreeU,
    and ``generate_images`` import neither jax nor the JAX package, not
    even its host-only modules."""
    from safetensors.numpy import save_file
    wav = click_track(tmp_path / "beat.wav")
    rng = np.random.default_rng(0)
    attn = "lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn1"
    save_file({f"{attn}_to_q.lora_down.weight":
               rng.standard_normal((4, 32), dtype=np.float32),
               f"{attn}_to_q.lora_up.weight":
               rng.standard_normal((32, 4), dtype=np.float32)},
              str(tmp_path / "lora.safetensors"))
    save_file({"emb_params": rng.standard_normal((2, 32), dtype=np.float32)},
              str(tmp_path / "mytrigger.safetensors"))
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from stable_diffusion_videos_tpu_torch.pipeline import "
        "StableDiffusionWalkPipeline as P\n"
        "P.tiny(torch.device('cpu')).walk(prompts=['a', 'b'], seeds=[1, 2], "
        "num_interpolation_steps=2, height=32, width=32, "
        "num_inference_steps=2, batch_size=2, make_video=True, fps=2, "
        f"audio_filepath={str(wav)!r}, "
        f"output_dir={str(tmp_path)!r}, name='n')\n"
        "P.tiny(torch.device('cpu'), scheduler='dpm', step_cache=2).walk("
        "prompts=['a', 'b'], seeds=[1, 2], num_interpolation_steps=2, "
        "height=32, width=32, num_inference_steps=3, batch_size=2, "
        f"make_video=False, output_dir={str(tmp_path)!r}, name='d')\n"
        "P.tiny(torch.device('cpu'), scheduler='lcm', frozen_noise=True)"
        ".walk(prompts=['a', 'b'], seeds=[1, 2], num_interpolation_steps=2, "
        "height=32, width=32, num_inference_steps=2, batch_size=2, "
        f"make_video=False, output_dir={str(tmp_path)!r}, name='l')\n"
        "P.tiny_xl(torch.device('cpu'), fast=True).walk(prompts=['a', 'b'], "
        "seeds=[1, 2], num_interpolation_steps=2, height=32, width=32, "
        "num_inference_steps=3, batch_size=2, make_video=False, "
        f"output_dir={str(tmp_path)!r}, name='x')\n"
        "from stable_diffusion_videos_tpu_torch.models.bundle import "
        "SDModels\n"
        "from stable_diffusion_videos_tpu_torch.runtime.engine import "
        "Engine\n"
        "lat = torch.randn(1, 12, 20, 4)\n"
        "for kw in (dict(tiny_decoder=True),\n"
        "           dict(vae_tile=8, vae_tile_overlap=2)):\n"
        "    e = Engine(SDModels.tiny(taesd=True), torch.device('cpu'), "
        "**kw)\n"
        "    assert e.decode_latents(lat).shape == (1, 24, 40, 3)\n"
        "    assert e.models.taesd.encode(torch.rand(1, 3, 8, 8)).shape == "
        "(1, 4, 4, 4)\n"
        "p = P.tiny(torch.device('cpu'))\n"
        "img = (torch.rand(2, 32, 32, 3) * 255).to(torch.uint8).numpy()\n"
        "assert len(p.img2img(img, 'a', num_inference_steps=3)) == 2\n"
        "assert p.inpaint(img[0], img[0, :, :, 0] > 127, 'a', "
        "num_inference_steps=3, output_type='np').shape == (1, 32, 32, 3)\n"
        "import glob\n"
        f"src = sorted(glob.glob({str(tmp_path)!r} + '/n/n.*'))[0]\n"
        "p.vid2vid(src, 'a', num_inference_steps=2, batch_size=2, "
        f"output_filepath={str(tmp_path / 'v.mp4')!r})\n"
        "r = Engine(SDModels.tiny_refiner(), torch.device('cpu'))\n"
        "assert r.img2img(r.embed_text('a'), r.embed_text(''), "
        "r.encode_image(torch.rand(1, 16, 16, 3) * 2 - 1), "
        "pooled=r.embed_text_pooled('a'), num_inference_steps=3)"
        ".shape == (1, 16, 16, 3)\n"
        "from stable_diffusion_videos_tpu_torch.models import (controlnet, "
        "ip_adapter, lora_file, safety, textual_inversion)\n"
        "m = textual_inversion.apply_textual_inversion(lora_file.apply_lora("
        f"SDModels.tiny(), {str(tmp_path / 'lora.safetensors')!r}), "
        f"{str(tmp_path / 'mytrigger.safetensors')!r})\n"
        "ip = ip_adapter.IPAdapter.random(m.unet_config, embed_dim=16, "
        "vision=safety.CLIPVisionConfig.tiny())\n"
        "P(m, torch.device('cpu'), controlnet=controlnet.ControlNetBundle"
        ".tiny(), ip_adapter=ip, prompt_weighting=True).walk(prompts=["
        "'a (b:1.2) mytrigger', 'c'], seeds=[1, 2], num_interpolation_steps"
        "=2, height=32, width=32, num_inference_steps=2, batch_size=2, "
        f"make_video=False, output_dir={str(tmp_path)!r}, name='c', "
        "control_image=img[0], ip_image=img[1])\n"
        "from stable_diffusion_videos_tpu_torch.pipeline import "
        "image_generation, upsampling\n"
        "up = upsampling.RealESRGANModel.tiny(torch.device('cpu'))\n"
        "torch.save({'params_ema': up.net.state_dict()}, "
        f"{str(tmp_path / 'esrgan.pth')!r})\n"
        "s = P(SDModels.tiny(with_safety=True), torch.device('cpu'), "
        "tome=0.5, freeu=True)\n"
        "s.walk(prompts=['a', 'b'], seeds=[1, 2], num_interpolation_steps=2, "
        "height=32, width=32, num_inference_steps=2, batch_size=2, "
        f"make_video=False, output_dir={str(tmp_path)!r}, name='s', "
        f"upsample=True, upsample_weights={str(tmp_path / 'esrgan.pth')!r})\n"
        "assert len(image_generation.generate_images(s, 'a', batch_size=2, "
        "num_inference_steps=2, height=32, width=32, upsample=True, "
        f"output_dir={str(tmp_path)!r}, name='g')) == 2\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'stable_diffusion_videos_tpu'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "EAGER_IMPORT"}
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300,
                   cwd=Path(__file__).resolve().parent.parent, env=env)
    assert len(list(tmp_path.glob("n/**/frame*.png"))) == 2
    assert len(list(tmp_path.glob("d/**/frame*.png"))) == 2
    assert len(list(tmp_path.glob("l/**/frame*.png"))) == 2
    assert len(list(tmp_path.glob("x/**/frame*.png"))) == 2
    assert len(list(tmp_path.glob("c/**/frame*.png"))) == 2
    upsampled = sorted(tmp_path.glob("s/**/frame*.png"))
    assert [Image.open(p).size for p in upsampled] == [(128, 128)] * 2
    assert len(list(tmp_path.glob("g/*.jpg"))) == 2
    videos = [p for p in (tmp_path / "n").glob("n.*")
              if p.suffix in (".mp4", ".avi")]
    assert len(videos) == 1 and videos[0].stat().st_size > 0
    assert [p.stat().st_size > 0 for p in tmp_path.glob("v.*")] == [True]


@pytest.mark.parametrize("offset,duration,fps,margin,smooth", [
    (0.0, 1.0, 12, 1.0, 0.0), (0.25, 0.5, 30, 2.0, 0.3)])
def test_timesteps_match_jax(tmp_path, offset, duration, fps, margin,
                             smooth):
    """The port's audio schedule equals the JAX package's exactly."""
    from stable_diffusion_videos_tpu.audio.analysis import \
        get_timesteps_arr as jax_timesteps
    from stable_diffusion_videos_tpu_torch.audio.analysis import \
        get_timesteps_arr
    wav = click_track(tmp_path / "beat.wav")
    kw = dict(offset=offset, duration=duration, fps=fps, margin=margin,
              smooth=smooth)
    want = jax_timesteps(str(wav), **kw)
    got = get_timesteps_arr(str(wav), **kw)
    assert got.shape == (int(duration * fps),)
    np.testing.assert_array_equal(got, want)
