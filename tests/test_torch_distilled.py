"""The distilled operating point on the PyTorch package: lcm-4, cond-only
(``guidance_interval=(0.0, 0.0)``, guidance 1.0), batch 8, and frozen
transition noise.

On the committed trained student ``tests/goldens/structured_lcm_bundle``
both engines denoise the 8 structured prompts from the same numpy noise,
free and under ``frozen_noise``, the port fed the JAX engine's own noise
fields; the frames must agree within 2/255 a pixel, and
``utils/metrics.quality_vs_exact`` must read PSNR >= 50 dB and SSIM >= 0.999
on every frame.  Frozen noise must cut the frame-to-frame flicker of a walk
trajectory, by ``tests/test_frozen_noise.py``'s bound on the JAX package's
noise fields, and with the port's own generator too.  The frozen-noise
properties, on the port alone: identical rows give identical frames under
frozen noise and different ones without it, the flag is a no-op for
deterministic samplers, and a walk's frames do not depend on how they are
grouped into dispatches.  The ``cuda`` case runs
lcm-4 on the card against the CPU.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
from stable_diffusion_videos_tpu_torch.pipeline import \
    StableDiffusionWalkPipeline
from stable_diffusion_videos_tpu_torch.pipeline.walk import dispatch_seed
from stable_diffusion_videos_tpu_torch.runtime.engine import Engine

from test_torch_sampler_engines import JaxNoise
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

BUNDLE = Path(__file__).parent / "goldens" / "structured_lcm_bundle"
CPU = torch.device("cpu")
DISTILLED = dict(scheduler="lcm", guidance_interval=(0.0, 0.0),
                 batch_bucket=8)
RUN = dict(num_inference_steps=4, guidance_scale=1.0)
MIN_PSNR, MIN_SSIM = 50.0, 0.999


@pytest.fixture(scope="module")
def structured():
    """(JAX bundle, port bundle on the same weights, cond, uncond, noise):
    the 8 structured prompts, embedded once by the JAX engine."""
    from stable_diffusion_videos_tpu.models.bundle import SDModels as JModels
    from stable_diffusion_videos_tpu.runtime.engine import Engine as JEngine
    from stable_diffusion_videos_tpu.training import make_structured_dataset
    from stable_diffusion_videos_tpu_torch.models.clip_text import (
        CLIPTextConfig, CLIPTextEncoder)
    from stable_diffusion_videos_tpu_torch.models.tokenizer import \
        HashTokenizer
    from stable_diffusion_videos_tpu_torch.models.unet import (
        UNet2DCondition, UNetConfig)
    from stable_diffusion_videos_tpu_torch.models.vae import (AutoencoderKL,
                                                              VAEConfig)
    from stable_diffusion_videos_tpu_torch.models.weights import (
        from_jax_params, load_state_dict)
    from test_torch_structured import config
    jm = JModels.load(str(BUNDLE))
    meta = json.loads((BUNDLE / "bundle.json").read_text())
    cfgs = (config(UNetConfig, meta["unet_config"]),
            config(VAEConfig, meta["vae_config"]),
            config(CLIPTextConfig, meta["text_config"]))
    with torch.device("meta"):
        mods = (UNet2DCondition(cfgs[0]), AutoencoderKL(cfgs[1]),
                CLIPTextEncoder(cfgs[2]))
    for mod, part, cfg in zip(mods, ("unet", "vae", "text_encoder"), cfgs):
        load_state_dict(mod, from_jax_params(jm.params[part], cfg))
        mod.eval()
    port = SDModels(*cfgs, *mods, HashTokenizer(
        vocab_size=meta["tokenizer_vocab_size"]))
    _, prompts = make_structured_dataset(32)
    eng = JEngine(jm, batch_bucket=len(prompts))
    cond = np.array(eng.embed_text(prompts))
    uncond = np.array(eng.embed_text(""))
    h = cfgs[0].sample_size
    noise = np.random.default_rng(7).standard_normal(
        (len(prompts), h, h, 4)).astype(np.float32)
    return jm, port, cond, uncond, noise


@pytest.mark.parametrize("frozen", [False, True], ids=["free", "frozen"])
def test_lcm4_matches_jax_on_the_distilled_checkpoint(structured, frozen):
    import jax
    import jax.numpy as jnp

    from stable_diffusion_videos_tpu.runtime.engine import Engine as JEngine
    from stable_diffusion_videos_tpu.utils.metrics import quality_vs_exact
    jm, port, cond, uncond, noise = structured
    key = jax.random.PRNGKey(2)
    want = np.asarray(JEngine(jm, frozen_noise=frozen, **DISTILLED)
                      .denoise_frames(jnp.asarray(cond), jnp.asarray(uncond),
                                      jnp.asarray(noise), key=key, **RUN))
    got = Engine(port, CPU, frozen_noise=frozen, **DISTILLED).denoise_frames(
        cond, uncond, noise, generator=JaxNoise(key, frozen=frozen), **RUN)
    assert got.shape == want.shape == (8, 32, 32, 3)
    assert np.abs(got - want).max() <= 2 / 255
    q = quality_vs_exact(got, want)
    assert q["psnr_min"] >= MIN_PSNR and q["ssim_min"] >= MIN_SSIM, q
    assert want.std() > 0.05  # the student's patterns, not a flat field


def walk_flicker(structured, frozen, generator):
    """``utils/metrics.temporal_flicker`` of an 8-frame walk trajectory on
    the student: ``tests/test_frozen_noise.py``'s inputs (embeddings of the
    first two structured prompts lerped, two noise fields of numpy seed 23
    slerped)."""
    from stable_diffusion_videos_tpu.utils.metrics import temporal_flicker
    from stable_diffusion_videos_tpu_torch.core.interp import lerp, slerp
    _, port, cond, uncond, _ = structured
    h = port.unet_config.sample_size
    rng = np.random.default_rng(23)
    n0, n1 = (torch.from_numpy(rng.standard_normal((h, h, 4),
                                                   dtype=np.float32))
              for _ in range(2))
    t = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    embeds = lerp(t, torch.from_numpy(cond[0]), torch.from_numpy(cond[1]))
    eng = Engine(port, CPU, frozen_noise=frozen, **DISTILLED)
    return temporal_flicker(eng.denoise_frames(
        embeds, uncond, slerp(t, n0, n1), generator=generator, **RUN))


def test_frozen_noise_cuts_walk_flicker_on_the_distilled_checkpoint(
        structured):
    """With the JAX package's noise fields the port reproduces its finding
    (``tests/test_frozen_noise.py``: frozen flicker_ssim below 0.7 of
    free); with the port's own generator frozen noise still flickers
    less."""
    import jax
    free, frozen = (walk_flicker(structured, f, JaxNoise(
        jax.random.PRNGKey(2), frozen=f)) for f in (False, True))
    assert frozen["flicker_ssim"] < 0.7 * free["flicker_ssim"], (frozen,
                                                                 free)
    assert frozen["flicker_mad"] < free["flicker_mad"], (frozen, free)
    free, frozen = (walk_flicker(structured, f,
                                 torch.Generator().manual_seed(2))
                    for f in (False, True))
    assert frozen["flicker_ssim"] < free["flicker_ssim"], (frozen, free)
    assert frozen["flicker_mad"] < free["flicker_mad"], (frozen, free)


def identical_rows(scheduler, frozen, eta=0.0):
    """Frames of 8 identical rows (same latent, same context), with the
    engine's own generator."""
    models = SDModels.tiny()
    rng = np.random.default_rng(3)
    ctx = np.repeat(rng.standard_normal((1, 7, 32), dtype=np.float32), 8, 0)
    noise = np.repeat(rng.standard_normal((1, 8, 8, 4), dtype=np.float32),
                      8, 0)
    eng = Engine(models, CPU, scheduler=scheduler, frozen_noise=frozen)
    return eng.denoise_frames(ctx, ctx[:1], noise, num_inference_steps=4,
                              guidance_scale=2.0, eta=eta,
                              generator=torch.Generator().manual_seed(5))


STOCHASTIC = [("lcm", 0.0), ("euler_ancestral", 0.0), ("ddim", 1.0)]


@pytest.mark.parametrize("scheduler,eta", STOCHASTIC)
def test_frozen_noise_makes_identical_rows_identical(scheduler, eta):
    frames = identical_rows(scheduler, True, eta)
    for b in range(1, 8):
        np.testing.assert_array_equal(frames[0], frames[b])


@pytest.mark.parametrize("scheduler,eta", STOCHASTIC)
def test_free_noise_keeps_rows_independent(scheduler, eta):
    frames = identical_rows(scheduler, False, eta)
    assert max(float(np.abs(frames[0] - frames[b]).max())
               for b in range(1, 8)) > 1e-4


@pytest.mark.parametrize("scheduler", ["dpm", "ddim", "unipc"])
def test_frozen_flag_is_a_noop_for_deterministic_samplers(scheduler):
    np.testing.assert_array_equal(identical_rows(scheduler, False),
                                  identical_rows(scheduler, True))


def clip_frames(tmp_path, batch_size, tag):
    pipe = StableDiffusionWalkPipeline.tiny(CPU, scheduler="lcm",
                                            frozen_noise=True,
                                            batch_bucket=4)
    out = tmp_path / tag
    pipe.make_clip_frames("a", "b", 1, 2, num_interpolation_steps=5,
                          save_path=out, num_inference_steps=3,
                          guidance_scale=2.0, batch_size=batch_size,
                          height=16, width=16)
    from PIL import Image
    return [np.asarray(Image.open(p)) for p in sorted(out.glob("frame*.png"))]


def test_frozen_walk_frames_do_not_depend_on_the_batching(tmp_path):
    """Batch 4 (two dispatches) and batch 2 (three, an uneven tail) give the
    same frames: one seed a video under frozen noise, so every dispatch
    draws the same per-step fields (both pad to the bucket of 4)."""
    a = clip_frames(tmp_path, 4, "b4")
    b = clip_frames(tmp_path, 2, "b2")
    assert len(a) == len(b) == 5
    for fa, fb in zip(a, b):
        np.testing.assert_array_equal(fa, fb)


def test_dispatch_seeds_decouple_clips_and_batches():
    """Without frozen noise a dispatch's seed mixes both clip seeds and the
    batch index: clips that share ``seed_a`` draw different noise."""
    seeds = {dispatch_seed(a, b, i) for a, b, i in
             [(1, 2, 0), (1, 3, 0), (1, 2, 1), (2, 1, 0), (2 ** 40, 2, 0),
              (-1, 2, 0)]}
    assert len(seeds) == 6
    assert dispatch_seed(1, 2, 0) == dispatch_seed(1, 2, 0)
    assert all(0 <= s < 2 ** 64 for s in seeds)


@pytest.fixture
def cuda():
    """The card, with TF32 off for the test (cuDNN would otherwise run
    fp32 convolutions in TF32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels)")
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = before


@pytest.mark.cuda
def test_lcm4_on_the_card_matches_the_cpu(cuda):
    """lcm-4 cond-only under frozen noise, fp32 on the tiny bundle, through
    the kernels on the card and the plain versions on the CPU, fed the same
    noise fields: frames within 1e-3 (a whole UNet and decoder stacked on
    kernels that each hold 1e-4)."""
    rng = np.random.default_rng(4)
    cond = rng.standard_normal((8, 7, 32), dtype=np.float32)
    noise = rng.standard_normal((8, 8, 8, 4), dtype=np.float32)
    fields = torch.from_numpy(
        rng.standard_normal((4, 1, 4, 8, 8), dtype=np.float32))
    out = {}
    for dev in (CPU, cuda):
        eng = Engine(SDModels.tiny(), dev, frozen_noise=True, **DISTILLED)
        out[dev.type] = eng.denoise_frames(
            cond, cond[:1], noise, generator=lambda i, lat: fields[i].to(
                lat.device), **RUN)
    assert np.isfinite(out["cuda"]).all()
    np.testing.assert_allclose(out["cuda"], out["cpu"], atol=1e-3, rtol=0)
