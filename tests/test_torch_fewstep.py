"""The PyTorch package's few-step path against the JAX package's.

DPM-Solver++ 2M tables equal JAX's key for key (4, 14, 20 and 50 steps; 14
is the ``lower_order_final`` case; and "linspace" spacing at 20) and a 20-step run of its step holds
fp32 1e-5.  The engine's two pure functions, ``_interval_segments`` and
``_full_trunk_mask``, equal JAX's over a grid of loop lengths, cache
periods and intervals (one of whose bounds lands on .5 and rounds to
even).  The engines, on the JAX tiny bundle's weights carried across by
``from_jax_params`` and the same numpy inputs, give float frames within
1e-4 of each other under dpm, DeepCache and limited-interval CFG; a
``walk()`` with dpm x ``step_cache=2`` matches JAX's within 2/255 a pixel.
Also: ``step_cache=1`` is the uncached run bit for bit, the ``fast`` preset
and the kwargs that override it, and ``set_scheduler``.
"""

import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stable_diffusion_videos_tpu.core.schedulers import \
    get_scheduler as j_get
from stable_diffusion_videos_tpu.core.schedulers.base import \
    SchedulerConfig as JConfig
from stable_diffusion_videos_tpu.runtime.engine import Engine as JEngine
from stable_diffusion_videos_tpu_torch.core.schedulers import (
    SchedulerConfig, get_scheduler)
from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
from stable_diffusion_videos_tpu_torch.models.weights import (
    from_jax_params, load_state_dict)
from stable_diffusion_videos_tpu_torch.pipeline import \
    StableDiffusionWalkPipeline
from stable_diffusion_videos_tpu_torch.runtime.engine import Engine

from torch_threads import few_torch_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")
ENGINE_TOL = dict(atol=1e-4, rtol=1e-4)
INTERVALS = [None, (0.1, 0.85), (0.25, 0.75), (0.1, 0.7), (0.0, 0.5),
             (0.5, 1.0), (0.3, 0.3), (0.0, 0.0)]


@pytest.mark.parametrize("steps,spacing", [
    (4, "leading"), (14, "leading"), (20, "leading"), (50, "leading"),
    (20, "linspace")])
def test_dpm_tables_match_jax(steps, spacing):
    want = j_get("dpm").make_tables(JConfig(timestep_spacing=spacing), steps)
    got = get_scheduler("dpm").make_tables(
        SchedulerConfig(timestep_spacing=spacing), steps)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, str):
            assert got[k] == v
        else:
            assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                          err_msg=k)
    # first order at index 0, and at the end only below 15 steps
    assert got["first_order"][-1] == (steps < 15)


def test_dpm_twenty_step_run_matches_jax():
    js, ps = j_get("dpm"), get_scheduler("dpm")
    jt = js.make_tables(JConfig(), 20)
    pt = ps.make_tables(SchedulerConfig(), 20)
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((2, 4, 8, 8), dtype=np.float32)
    eps = rng.standard_normal((20, 2, 4, 8, 8), dtype=np.float32)
    jx, jstate = jnp.asarray(x0), js.init_state(jt, x0.shape)
    px = torch.from_numpy(x0)
    pstate = ps.init_state(pt, px)
    assert ps.num_loop_steps(pt) == js.num_loop_steps(jt) == 20
    for i in range(20):
        assert ps.timestep(pt, i) == int(js.timestep(jt, i))
        jstate, jx = js.step(jt, jstate, i, jnp.asarray(eps[i]), jx)
        pstate, px = ps.step(pt, pstate, i, torch.from_numpy(eps[i]), px)
        assert px.dtype == torch.float32
        np.testing.assert_allclose(px.numpy(), np.asarray(jx), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("interval", INTERVALS, ids=str)
def test_interval_segments_and_trunk_mask_match_jax(interval):
    stand_in = types.SimpleNamespace(guidance_interval=interval)
    for n in (1, 2, 4, 5, 8, 10, 20, 21, 50, 51):
        want = JEngine._interval_segments(stand_in, n)
        got = Engine._interval_segments(stand_in, n)
        assert got == want, (n, interval)
        for k in (1, 2, 3, 4, 5):
            np.testing.assert_array_equal(
                Engine._full_trunk_mask(got, n, k),
                JEngine._full_trunk_mask(want, n, k), err_msg=f"{n} {k}")


def test_interval_bound_on_a_half_rounds_to_even():
    """0.1 x 5 = 0.5 and 0.7 x 5 = 3.5: Python's round gives 0 and 4."""
    stand_in = types.SimpleNamespace(guidance_interval=(0.1, 0.7))
    assert Engine._interval_segments(stand_in, 5) == [(0, 4, True),
                                                      (4, 5, False)]
    assert Engine(SDModels.tiny(), CPU,
                  guidance_interval=(0.0, 1.0)).guidance_interval is None


@pytest.fixture(scope="module")
def jax_models():
    from stable_diffusion_videos_tpu.models.bundle import SDModels as JModels
    return JModels.tiny()


def port_models(jm) -> SDModels:
    models = SDModels.tiny()
    for module, part, cfg in ((models.unet, "unet", models.unet_config),
                              (models.vae, "vae", models.vae_config),
                              (models.text_encoder, "text_encoder",
                               models.text_config)):
        load_state_dict(module, from_jax_params(jm.params[part], cfg))
    return models


def engine_inputs():
    rng = np.random.default_rng(3)
    cond = rng.standard_normal((2, 7, 32), dtype=np.float32)
    uncond = rng.standard_normal((1, 7, 32), dtype=np.float32)
    noise = rng.standard_normal((2, 8, 8, 4), dtype=np.float32)
    return cond, uncond, noise


def port_frames(models, scheduler, steps, **kw) -> np.ndarray:
    cond, uncond, noise = engine_inputs()
    eng = Engine(models, CPU, scheduler=scheduler, **kw)
    return eng.denoise_frames(cond, uncond, noise, num_inference_steps=steps)


@pytest.mark.parametrize("scheduler,steps,kw", [
    ("dpm", 6, {}),
    ("dpm", 6, dict(step_cache=2)),
    ("dpm", 6, dict(step_cache=1)),
    ("pndm", 8, dict(step_cache=3, step_cache_policy="ends",
                     guidance_interval=(0.1, 0.85)))],
    ids=["dpm6", "dpm6_k2", "dpm6_k1", "pndm8_k3_ends_interval"])
def test_engine_matches_jax(jax_models, scheduler, steps, kw):
    cond, uncond, noise = engine_inputs()
    want = JEngine(jax_models, scheduler=scheduler, **kw).denoise_frames(
        jnp.asarray(cond), jnp.asarray(uncond), jnp.asarray(noise),
        num_inference_steps=steps)
    got = port_frames(port_models(jax_models), scheduler, steps, **kw)
    assert got.shape == (2, 16, 16, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), **ENGINE_TOL)
    assert got.std() > 0


@pytest.mark.parametrize("scheduler", ["dpm", "pndm"])
def test_step_cache_1_is_the_uncached_run(jax_models, scheduler):
    models = port_models(jax_models)
    exact = port_frames(models, scheduler, 4)
    np.testing.assert_array_equal(
        port_frames(models, scheduler, 4, step_cache=1), exact)
    np.testing.assert_array_equal(
        port_frames(models, scheduler, 4, step_cache=1,
                    step_cache_policy="ends"), exact)
    approx = port_frames(models, scheduler, 4, step_cache=2)
    assert not np.array_equal(approx, exact)  # the splice is engaged


def test_walk_with_dpm_and_step_cache_matches_jax(tmp_path):
    from stable_diffusion_videos_tpu.pipeline import \
        StableDiffusionWalkPipeline as JaxWalk
    walk = dict(prompts=["a red fox", "a blue lighthouse"], seeds=[7, 1234],
                num_interpolation_steps=3, height=64, width=64,
                num_inference_steps=5, batch_size=2, negative_prompt="blurry",
                make_video=False)
    jax_pipe = JaxWalk.tiny(scheduler="dpm", step_cache=2)
    port = StableDiffusionWalkPipeline(port_models(jax_pipe.models), CPU,
                                       scheduler="dpm", step_cache=2,
                                       batch_bucket=2)
    jax_dir = Path(jax_pipe.walk(output_dir=str(tmp_path / "jax"), name="w",
                                 **walk))
    port_dir = Path(port.walk(output_dir=str(tmp_path / "port"), name="w",
                              **walk))
    want = sorted(jax_dir.glob("**/frame*.png"))
    got = sorted(port_dir.glob("**/frame*.png"))
    assert [p.relative_to(port_dir) for p in got] == \
        [p.relative_to(jax_dir) for p in want] and len(got) == 3
    from PIL import Image
    for g, w in zip(got, want):
        a = np.asarray(Image.open(g), np.int32)
        b = np.asarray(Image.open(w), np.int32)
        assert a.shape == (64, 64, 3) and np.abs(a - b).max() <= 2, g.name
    cfg = json.loads((port_dir / "prompt_config.json").read_text())
    assert cfg["scheduler"] == "dpm"


def test_fast_preset_and_explicit_kwargs_win():
    from stable_diffusion_videos_tpu.pipeline import \
        StableDiffusionWalkPipeline as JaxWalk
    for kw in ({}, dict(step_cache=2), dict(guidance_interval=(0.2, 0.9)),
               dict(step_cache=4, guidance_interval=(0.0, 1.0),
                    step_cache_policy="ends")):
        want = JaxWalk.tiny(fast=True, **kw).engine
        got = StableDiffusionWalkPipeline.tiny(CPU, fast=True, **kw)
        assert got.fast
        for name in ("step_cache", "step_cache_split", "step_cache_policy",
                     "guidance_interval"):
            assert getattr(got.engine, name) == getattr(want, name), (kw,
                                                                      name)
    plain = StableDiffusionWalkPipeline.tiny(CPU).engine
    assert plain.step_cache is None and plain.guidance_interval is None


def test_set_scheduler_switches_and_refuses_unknown_names():
    eng = Engine(SDModels.tiny(), CPU)
    eng.set_scheduler("dpm")
    assert eng.scheduler_name == "dpm" and eng.sched.name == "dpm"
    with pytest.raises(KeyError, match="heun"):
        eng.set_scheduler("heun")
    assert eng.scheduler_name == "dpm"
    with pytest.raises(ValueError, match="step_cache"):
        Engine(SDModels.tiny(), CPU, step_cache=0)
    with pytest.raises(ValueError, match="policy"):
        Engine(SDModels.tiny(), CPU, step_cache_policy="nope")
    with pytest.raises(ValueError, match="guidance_interval"):
        Engine(SDModels.tiny(), CPU, guidance_interval=(0.9, 0.1))
