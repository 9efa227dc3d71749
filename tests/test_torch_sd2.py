"""SD 2.x on the PyTorch package against the JAX package, on the CPU, and
the bundles' random weights.

PNDM refuses a v-prediction model (the JAX package's PNDM reads its output
as epsilon); the SD 2.x-shaped tiny walk of ``tests/test_walk_e2e.py``
(per-level head counts, the exact-GELU tower, ddim under v-prediction)
gives the JAX package's frames within 2/255; the published SD 2.x configs
and SDXL's VAE equal the JAX package's field by field; ``SDModels.random``
builds each family's published geometry; and the random weights, now drawn
and cast one tensor at a time, keep their values.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from stable_diffusion_videos_tpu_torch.core.schedulers import (
    SchedulerConfig, get_scheduler)
from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
from stable_diffusion_videos_tpu_torch.models.clip_text import CLIPTextConfig
from stable_diffusion_videos_tpu_torch.models.unet import UNetConfig
from stable_diffusion_videos_tpu_torch.models.vae import (AutoencoderKL,
                                                          VAEConfig)
from stable_diffusion_videos_tpu_torch.models.weights import \
    random_state_dict
from stable_diffusion_videos_tpu_torch.pipeline import \
    StableDiffusionWalkPipeline
from stable_diffusion_videos_tpu_torch.runtime.engine import Engine

from test_torch_sdxl import CPU, jax_models, load_port
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

V_PRED = SchedulerConfig(prediction_type="v_prediction")


@pytest.mark.parametrize("prediction_type", ["v_prediction", "sample"])
def test_pndm_refuses_other_prediction_types(prediction_type):
    """PNDM's multistep combines epsilon predictions: it refuses any other
    prediction type, naming the samplers that read it, and so does a
    dispatch of the engine's default sampler on such a bundle."""
    cfg = SchedulerConfig(prediction_type=prediction_type)
    with pytest.raises(ValueError, match="ddim, dpm, euler, euler_ancestral,"
                                         " lms, unipc and lcm"):
        get_scheduler("pndm").make_tables(cfg, 10)
    eng = Engine(dataclasses.replace(SDModels.tiny(), scheduler_config=cfg),
                 CPU)
    with pytest.raises(ValueError, match=prediction_type):
        eng.denoise_frames(np.zeros((1, 7, 32), np.float32),
                           np.zeros((1, 7, 32), np.float32),
                           np.zeros((1, 8, 8, 4), np.float32),
                           num_inference_steps=3)
    # every other sampler builds its tables under v-prediction
    for name in ("ddim", "dpm", "euler", "euler_ancestral", "lms", "unipc",
                 "lcm"):
        get_scheduler(name).make_tables(V_PRED, 10)


def sd2_tiny() -> SDModels:
    """The SD 2.x-shaped tiny bundle of ``tests/test_walk_e2e.py``: heads
    (2, 4) on both levels, the exact-GELU tower, v-prediction."""
    ucfg = UNetConfig(sample_size=8, block_out_channels=(32, 64),
                      layers_per_block=1, cross_attention_dim=32,
                      attention_head_dim=(2, 4), attn_levels=(True, True))
    return SDModels.build(ucfg, VAEConfig.tiny(), CLIPTextConfig.tiny_v2(),
                          0, 0.1, torch.float32, scheduler_config=V_PRED)


def frames(run_dir: Path) -> dict:
    return {p.relative_to(run_dir).as_posix(): np.asarray(Image.open(p),
                                                          np.int32)
            for p in sorted(run_dir.glob("**/frame*.png"))}


def test_sd2_walk_matches_jax(tmp_path):
    from stable_diffusion_videos_tpu.pipeline import \
        StableDiffusionWalkPipeline as JaxWalk
    port = sd2_tiny()
    jm = jax_models(port, seed=7)
    assert jm.scheduler_config.prediction_type == "v_prediction"
    walk = dict(prompts=["x marks", "y axis"], seeds=[1, 2],
                num_interpolation_steps=3, height=64, width=64,
                num_inference_steps=4, batch_size=2, negative_prompt="blur",
                make_video=False, name="v")
    jax_dir = Path(JaxWalk(jm, scheduler="ddim").walk(
        output_dir=str(tmp_path / "jax"), **walk))
    port_dir = Path(StableDiffusionWalkPipeline(
        load_port(port, jm), CPU, scheduler="ddim", batch_bucket=2).walk(
            output_dir=str(tmp_path / "port"), **walk))
    want, got = frames(jax_dir), frames(port_dir)
    assert sorted(got) == sorted(want) and len(got) == 3
    for name in want:
        assert got[name].shape == (64, 64, 3)
        assert np.abs(got[name] - want[name]).max() <= 2, name
    assert got["v_000000/frame000000.png"].std() > 0


@pytest.mark.parametrize("name", [
    "UNetConfig.sd_v2", "CLIPTextConfig.sd_v2", "VAEConfig.sd_xl"])
def test_sd2_configs_match_jax(name):
    """SD 2.1 768-v's UNet (at 96² latents) and OpenCLIP-H tower, and the
    SDXL VAE (the JAX package's ``sd_xl_configs``), field by field."""
    from stable_diffusion_videos_tpu.models import bundle as B
    port, want = {
        "UNetConfig.sd_v2": (UNetConfig.sd_v2(96), B.UNetConfig.sd_v2(96)),
        "CLIPTextConfig.sd_v2": (CLIPTextConfig.sd_v2(),
                                 B.CLIPTextConfig.sd_v2()),
        "VAEConfig.sd_xl": (VAEConfig.sd_xl(), B.SDModels.sd_xl_configs()[1]),
    }[name]
    assert dataclasses.asdict(port) == {
        f.name: getattr(want, f.name) for f in dataclasses.fields(want)}


def test_random_builds_each_family(monkeypatch):
    """``SDModels.random`` hands ``build`` each family's published
    geometry (the build itself is not run: SDXL's is 3.4B parameters)."""
    calls = {}
    monkeypatch.setattr(SDModels, "build", classmethod(
        lambda cls, *a, **kw: calls.setdefault("last", (a, kw))))
    monkeypatch.setattr(SDModels, "refiner", classmethod(lambda cls, m: m))
    for family in ("sd1", "sd2", "sdxl", "sdxl_refiner"):
        calls.clear()
        SDModels.random(family)
        (ucfg, vcfg, tcfg, seed, std, dtype, taesd), kw = calls["last"]
        assert (seed, std, dtype, taesd) == (1, 0.02, torch.bfloat16, None)
        want = {"sd1": (UNetConfig.sd_v1(), VAEConfig.sd_v1(),
                        CLIPTextConfig.sd_v1(), {}),
                "sd2": (UNetConfig.sd_v2(96), VAEConfig.sd_v1(),
                        CLIPTextConfig.sd_v2(),
                        dict(scheduler_config=V_PRED)),
                "sdxl": (UNetConfig.sd_xl(), VAEConfig.sd_xl(),
                         CLIPTextConfig.sd_xl_l(),
                         dict(text_config_2=CLIPTextConfig.sd_xl_g())),
                "sdxl_refiner": (UNetConfig.sd_xl_refiner(),
                                 VAEConfig.sd_xl(), CLIPTextConfig.sd_xl_g(),
                                 {})}
        assert (ucfg, vcfg, tcfg, kw) == want[family]
    with pytest.raises(ValueError,
                       match="'sd1', 'sd2', 'sdxl' and 'sdxl_refiner'"):
        SDModels.random("sdxl_base")


def test_default_batch_follows_the_default_size():
    tiny = SDModels.tiny()
    for sample_size, batch in ((64, 8), (96, 8), (128, 8), (512, 1)):
        models = dataclasses.replace(tiny, unet_config=dataclasses.replace(
            tiny.unet_config, sample_size=sample_size))
        assert models.default_batch_size == batch, sample_size


def test_random_draws_keep_their_values():
    """Drawing and casting one tensor at a time gives the values of the
    earlier all-at-once float32 draws, cast: the tiny bundle's weights, and
    the SD 1.x KL decoder's at its published geometry in bf16."""
    def drawn_at_once(module, seed, std):
        rng = np.random.default_rng(seed)
        return {k: rng.standard_normal(tuple(v.shape), dtype=np.float32) * std
                for k, v in module.state_dict().items()}

    tiny = SDModels.tiny(seed=3)
    for i, module in enumerate((tiny.unet, tiny.vae, tiny.text_encoder)):
        want = drawn_at_once(module, 3 + i, 0.1)
        for k, v in module.state_dict().items():
            assert torch.equal(v, torch.from_numpy(want[k])), k
    with torch.device("meta"):
        vae = AutoencoderKL(VAEConfig.sd_v1())
    got = random_state_dict(vae, 2, 0.02, torch.bfloat16)
    want = drawn_at_once(vae, 2, 0.02)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.dtype == torch.bfloat16
        assert torch.equal(v, torch.from_numpy(want[k]).to(torch.bfloat16)), k
