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
        assert kw.pop("device") is None  # drawn by numpy on the host
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_random_draws_on_a_device_generator(dtype):
    """``random_state_dict(..., device=)``: one ``torch.Generator`` on the
    device seeded with the seed, ``torch.randn`` in float32 tensor by tensor
    in state-dict order, times std, cast; every shape the module's, the
    same draws for a seed and others for another seed.  ``SDModels.build``
    on a device draws each network from its seed that way, onto the
    device.  (The numpy route stays the default: the test above.)"""
    with torch.device("meta"):
        vae = AutoencoderKL(VAEConfig.tiny())
    got = random_state_dict(vae, 2, 0.02, dtype, CPU)
    again = random_state_dict(vae, 2, 0.02, dtype, CPU)
    other = random_state_dict(vae, 3, 0.02, dtype, CPU)
    gen = torch.Generator(CPU).manual_seed(2)
    assert list(got) == list(vae.state_dict())
    for (k, v), ref in zip(got.items(), vae.state_dict().values()):
        assert v.shape == ref.shape and v.dtype == dtype
        assert v.device == CPU
        want = (torch.randn(tuple(ref.shape), generator=gen) * 0.02).to(dtype)
        assert torch.equal(v, want) and torch.equal(v, again[k]), k
    assert not any(torch.equal(v, other[k]) for k, v in got.items()
                   if v.numel() > 1)
    models = SDModels.build(UNetConfig.tiny(), VAEConfig.tiny(),
                            CLIPTextConfig.tiny(), 3, 0.1, dtype, device=CPU)
    for i, module in enumerate((models.unet, models.vae,
                                models.text_encoder)):
        want = random_state_dict(module, 3 + i, 0.1, dtype, CPU)
        for k, v in module.state_dict().items():
            assert v.dtype == dtype and torch.equal(v, want[k]), k


@pytest.mark.parametrize("addon", ["controlnet", "ip_adapter", "safety"])
def test_addon_random_draws_on_a_device_generator(addon, monkeypatch):
    """``ControlNetBundle.random``, ``IPAdapter.random`` (its tower) and
    ``SafetyChecker.random`` with ``device=`` draw through
    ``random_state_dict``'s device route, onto that device: the same
    weights for a seed, every shape the numpy route's, and what numpy
    draws (the IP-Adapter's projection and K/V) or sets (the checker's
    LayerNorms and thresholds) unchanged.  ControlNet at the tiny UNet's
    geometry (its ``random`` is SD 1.x's)."""
    from stable_diffusion_videos_tpu_torch.models.controlnet import (
        ControlNet, ControlNetBundle)
    from stable_diffusion_videos_tpu_torch.models.ip_adapter import IPAdapter
    from stable_diffusion_videos_tpu_torch.models.safety import (
        CLIPVisionConfig, CLIPVisionEncoder, SafetyChecker, SafetyConfig)
    if addon == "controlnet":
        monkeypatch.setattr(UNetConfig, "sd_v1", UNetConfig.tiny)
        with torch.device("meta"):
            shapes = ControlNet(UNetConfig.tiny())

        def make(device):
            return ControlNetBundle.random(
                seed=5, dtype=torch.float32, device=device).module
        drawn = random_state_dict(shapes, 5, 0.02, torch.float32, CPU)
    elif addon == "ip_adapter":
        vision = CLIPVisionConfig.tiny()
        with torch.device("meta"):
            shapes = CLIPVisionEncoder(vision)

        def make(device):
            ip = IPAdapter.random(UNetConfig.tiny(), seed=6, vision=vision,
                                  embed_dim=16, device=device)
            return torch.nn.ModuleDict({"proj": ip.proj,
                                        "image_encoder": ip.image_encoder})
        drawn = {f"image_encoder.{k}": v for k, v in random_state_dict(
            shapes, 7, 0.02, device=CPU).items()}
    else:
        with torch.device("meta"):
            shapes = SafetyChecker(SafetyConfig.tiny())

        def make(device):
            return SafetyChecker.random(SafetyConfig.tiny(), seed=2, std=0.2,
                                        device=device)
        drawn = random_state_dict(shapes, 2, 0.2, device=CPU)
    got = make(CPU).state_dict()
    again, numpy_route = make(CPU).state_dict(), make(None).state_dict()
    assert list(got) == list(numpy_route)
    for k, v in got.items():
        assert v.device == CPU and v.shape == numpy_route[k].shape, k
        assert torch.equal(v, again[k]), k
        if k not in drawn:  # the IP-Adapter's projection: numpy's draws
            assert torch.equal(v, numpy_route[k]), k
        elif addon == "safety" and (k.endswith("_weights") or torch.equal(
                numpy_route[k], torch.full_like(v, float(v.flatten()[0])))):
            # set, not drawn: thresholds 0.5, LayerNorm scales 1, biases 0
            assert torch.equal(v, numpy_route[k]), k
        else:
            assert torch.equal(v, drawn[k].to(v.dtype)), k
