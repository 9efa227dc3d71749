"""img2img of the PyTorch package against the JAX package's.

The mid-schedule entry: the warm-up samplers' tables rebuilt from
``start_index`` (pndm, lms, unipc, and euler, which lms builds on) at k0 in
{1, 12, 25} of 50 steps, fp32 1e-5; ``k0``'s half-to-even rounding
(strength 0.75 at 50 steps enters at 12); the sliced tables are copies, so
a txt2img dispatch after an img2img one reads the tables it read before.
``Engine.img2img`` for all eight samplers at strength 0.6 and 0.75 (10
steps, where 0.75 rounds 2.5 down to 2) on the tiny bundles, both engines
given the same re-noising field and the port fed the JAX key chain's step
fields, frames within 1e-4.  On the committed trained checkpoint
``tests/goldens/structured_bundle``, pndm-50 img2img at strength 0.6 from
the structured images, each engine encoding them itself: frames within
2/255, PSNR >= 50 dB and SSIM >= 0.999 (``utils/metrics.quality_vs_exact``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_diffusion_videos_tpu_torch.core.schedulers import (
    SchedulerConfig, get_scheduler)
from stable_diffusion_videos_tpu_torch.runtime.engine import Engine

from test_torch_sampler_engines import (ENGINE_TOL, JaxNoise, engine_inputs,
                                        tiny_bundles)
from test_torch_structured import (GUIDANCE, MIN_PSNR, MIN_SSIM,
                                   structured)  # noqa: F401 (fixture)
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")
SAMPLERS = ("pndm", "ddim", "dpm", "euler", "euler_ancestral", "lms",
            "unipc", "lcm")
TABLE_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def bundles():
    return tiny_bundles()


def image_inputs(seed: int = 11):
    """(init latents (2, 8, 8, 4), re-noising field (1, 8, 8, 4))."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 8, 8, 4), dtype=np.float32),
            rng.standard_normal((1, 8, 8, 4), dtype=np.float32))


@pytest.mark.parametrize("k0", [1, 12, 25])
@pytest.mark.parametrize("name", ["pndm", "lms", "unipc", "euler"])
def test_start_index_tables_match_jax(name, k0):
    from stable_diffusion_videos_tpu.core.schedulers import \
        SchedulerConfig as JConfig
    from stable_diffusion_videos_tpu.core.schedulers import \
        get_scheduler as jget
    want = jget(name).make_tables(JConfig(), 50, start_index=k0)
    got = get_scheduler(name).make_tables(SchedulerConfig(), 50,
                                          start_index=k0)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        if hasattr(w, "shape"):
            np.testing.assert_allclose(np.asarray(got[key], np.float64),
                                       np.asarray(w, np.float64),
                                       err_msg=key, **TABLE_TOL)
        else:
            assert got[key] == w, key
    # the truncated head restarts the warm-up: as many loop steps as the
    # plain schedule less k0
    full = get_scheduler(name).make_tables(SchedulerConfig(), 50)
    n = get_scheduler(name).num_loop_steps
    assert n(got) == n(full) - k0


@pytest.mark.parametrize("name,strength,k0", [
    ("pndm", 0.75, 12), ("ddim", 0.75, 12), ("dpm", 0.6, 20),
    ("pndm", 0.6, 20), ("lms", 0.25, 38)])
def test_entry_rounds_half_to_even(bundles, name, strength, k0):
    """strength 0.75 at 50 steps: 12.5 rounds to 12 (not 13), over the
    plain schedule for pndm (whose loop has 51 steps) as for ddim."""
    eng = Engine(bundles[1], CPU, scheduler=name)
    _, run, got = eng._entry_tables(name, eng.sched, 50, 0.0, strength)
    assert got == k0
    full = eng._tables(name, eng.sched, 50, 0.0)
    assert eng.sched.num_loop_steps(run) == eng.sched.num_loop_steps(full) \
        - k0
    assert run["init_noise_sigma"] == 1.0


def test_entry_leaves_the_cached_tables_alone(bundles):
    """dpm's entry sets the first step to first order on a copy: the
    cached txt2img tables, and a dispatch on them, are unchanged."""
    eng = Engine(bundles[1], CPU, scheduler="dpm")
    cond, uncond, noise = engine_inputs()
    run = dict(num_inference_steps=6, guidance_scale=3.0)
    before = eng.denoise_frames(cond, uncond, noise, **run)
    cached = {k: np.copy(v) for k, v in
              eng._tables("dpm", eng.sched, 6, 0.0).items()
              if isinstance(v, np.ndarray)}
    lat, field = image_inputs()
    eng.img2img(cond, uncond, lat, strength=0.5, noise=field, **run)
    for k, v in eng._tables("dpm", eng.sched, 6, 0.0).items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, cached[k], err_msg=k)
    np.testing.assert_array_equal(
        eng.denoise_frames(cond, uncond, noise, **run), before)


def test_strength_is_validated(bundles):
    cond, uncond, _ = engine_inputs()
    lat, field = image_inputs()
    with pytest.raises(ValueError, match="strength"):
        Engine(bundles[1], CPU).img2img(cond, uncond, lat, strength=0.0)
    with pytest.raises(ValueError, match="no ControlNet"):
        Engine(bundles[1], CPU).img2img(cond, uncond, lat, control="x")


@pytest.mark.parametrize("strength", [0.6, 0.75])
@pytest.mark.parametrize("scheduler", SAMPLERS)
def test_img2img_matches_jax(bundles, scheduler, strength):
    from stable_diffusion_videos_tpu.runtime.engine import Engine as JEngine
    jm, pm = bundles
    cond, uncond, _ = engine_inputs()
    lat, field = image_inputs()
    key = jax.random.PRNGKey(5)
    run = dict(strength=strength, num_inference_steps=10,
               guidance_scale=3.0)
    want = np.asarray(JEngine(jm, scheduler=scheduler, batch_bucket=8)
                      .img2img(jnp.asarray(cond), jnp.asarray(uncond),
                               jnp.asarray(lat), key=key,
                               noise=jnp.asarray(field), **run))
    # the JAX engine splits off the re-noising key first; its program's
    # step fields come from what is left
    got = Engine(pm, CPU, scheduler=scheduler, batch_bucket=8).img2img(
        cond, uncond, lat, noise=field,
        generator=JaxNoise(jax.random.split(key)[0]), **run)
    assert got.shape == want.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got, want, **ENGINE_TOL)
    assert got.std() > 0


def test_img2img_matches_jax_on_the_trained_checkpoint(structured):
    from stable_diffusion_videos_tpu.runtime.engine import Engine as JEngine
    from stable_diffusion_videos_tpu.training import make_structured_dataset
    from stable_diffusion_videos_tpu.utils.metrics import quality_vs_exact
    jm, port, cond, uncond, _ = structured
    images, _ = make_structured_dataset(32)
    field = np.random.default_rng(9).standard_normal(
        (1, 16, 16, 4)).astype(np.float32)
    # restyle each pattern toward the next one's prompt
    cond = np.roll(cond, 1, axis=0)
    run = dict(strength=0.6, num_inference_steps=50, guidance_scale=GUIDANCE)
    jeng = JEngine(jm, batch_bucket=len(cond))
    want = np.asarray(jeng.img2img(
        jnp.asarray(cond), jnp.asarray(uncond),
        jeng.encode_image(jnp.asarray(images)), noise=jnp.asarray(field),
        **run))
    peng = Engine(port, CPU)
    got = peng.img2img(cond, uncond, peng.encode_image(images), noise=field,
                       **run)
    assert got.shape == want.shape == (8, 32, 32, 3)
    assert np.abs(got - want).max() <= 2 / 255
    q = quality_vs_exact(got, want)
    assert q["psnr_min"] >= MIN_PSNR and q["ssim_min"] >= MIN_SSIM, q
    assert want.std() > 0.05
