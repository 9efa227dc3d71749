"""The PyTorch package's samplers against the JAX package's: ddim, euler,
euler_ancestral, lms, unipc and lcm.

Tables equal JAX's key for key, and runs of the steps, with a fixed
model-output function of the scaled input and the timestep, hold fp32 1e-5,
at 1, 2, 3, 5 and 50 steps (the edge counts of ``tests/test_schedulers.py``)
under the default SD 1.x config, Karras sigmas (the sigma samplers),
v-prediction with zero terminal SNR and trailing spacing, and clipped x0
(ddim, lcm).  The stochastic samplers get the JAX package's own noise
fields, replayed from its key chain, and under frozen noise one field a
step.  The timestep fed to the UNet is the table's own value: fractional
under Karras sigmas.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_diffusion_videos_tpu.core.schedulers import \
    get_scheduler as j_get
from stable_diffusion_videos_tpu.core.schedulers.base import \
    SchedulerConfig as JConfig
from stable_diffusion_videos_tpu_torch.core.schedulers import (
    SchedulerConfig, get_scheduler)
from stable_diffusion_videos_tpu_torch.core.schedulers.base import \
    transition_noise

from torch_threads import few_torch_threads  # noqa: F401 (autouse)

TOL = dict(atol=1e-5, rtol=1e-5)
SIGMA_SAMPLERS = ("euler", "euler_ancestral", "lms")
CONFIGS = {
    "default": {},
    "karras": dict(use_karras_sigmas=True),
    "v_zero_snr_trailing": dict(prediction_type="v_prediction",
                                rescale_betas_zero_snr=True,
                                timestep_spacing="trailing"),
    "clip_linspace_cos": dict(clip_sample=True, timestep_spacing="linspace",
                              beta_schedule="squaredcos_cap_v2"),
}


def cases(step_counts):
    out = []
    for name in ("ddim", "euler", "euler_ancestral", "lms", "unipc", "lcm"):
        for cfg in CONFIGS:
            if cfg == "karras" and name not in SIGMA_SAMPLERS:
                continue
            if cfg == "clip_linspace_cos" and name not in ("ddim", "lcm"):
                continue
            out += [(name, cfg, n) for n in step_counts]
    return out


def tables(name, cfg, steps, **kw):
    return (j_get(name).make_tables(JConfig(**CONFIGS[cfg]), steps, **kw),
            get_scheduler(name).make_tables(SchedulerConfig(**CONFIGS[cfg]),
                                            steps, **kw))


@pytest.mark.parametrize("name,cfg,steps", cases([1, 2, 3, 50]))
def test_tables_match_jax(name, cfg, steps):
    want, got = tables(name, cfg, steps)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, (str, bool, int)):
            assert got[k] == v, k
        else:
            assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                          err_msg=k)


def model_output(x: np.ndarray, t: float) -> np.ndarray:
    """The fixed stand-in for the UNet: linear in its input, shifted by a
    function of the timestep (computed once, in float64)."""
    return (0.9 * x + np.float32(0.05 * np.sin(0.01 * t))).astype(np.float32)


def run_both(name, cfg, steps, frozen=False, **kw):
    """Both samplers from the same latents, fed the same model outputs and
    (stochastic samplers) the JAX package's noise fields; yields each loop
    index's (port, JAX) samples as NCHW numpy."""
    js, ps = j_get(name), get_scheduler(name)
    jt, pt = tables(name, cfg, steps, **kw)
    if frozen:
        jt = {**jt, "frozen_noise": True}
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((2, 4, 6, 6), dtype=np.float32)
    key = jax.random.PRNGKey(11)
    jstate = js.init_state(jt, (2, 6, 6, 4), key=key)
    jx = jnp.asarray(x0.transpose(0, 2, 3, 1)) * js.init_noise_sigma(jt)
    px = torch.from_numpy(x0) * ps.init_noise_sigma(pt)
    pstate = ps.init_state(pt, px)
    n = ps.num_loop_steps(pt)
    assert n == js.num_loop_steps(jt)
    for i in range(n):
        t = ps.timestep(pt, i)
        assert t == js.timestep(jt, i).item()
        inp = ps.scale_model_input(pt, pstate, i, px)
        jinp = js.scale_model_input(jt, jstate, i, jx)
        np.testing.assert_allclose(inp.numpy().transpose(0, 2, 3, 1),
                                   np.asarray(jinp), **TOL)
        noise = None
        if "key" in jstate:
            # the JAX step splits its state key; replay the split
            key, sub = jax.random.split(jstate["key"])
            shape = (6, 6, 4) if frozen else (2, 6, 6, 4)
            field = np.asarray(jax.random.normal(sub, shape))
            noise = torch.from_numpy(np.ascontiguousarray(
                field.transpose(2, 0, 1)[None] if frozen
                else field.transpose(0, 3, 1, 2)))
        eps = model_output(inp.numpy(), t)
        jstate, jx = js.step(jt, jstate, i,
                             jnp.asarray(eps.transpose(0, 2, 3, 1)), jx)
        pstate, px = ps.step(pt, pstate, i, torch.from_numpy(eps), px,
                             noise if ps.draws_noise(pt) else None)
        assert px.dtype == torch.float32
        yield i, px.numpy(), np.asarray(jx).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("name,cfg,steps", cases([1, 2, 3, 5, 50]))
def test_run_matches_jax(name, cfg, steps):
    for i, got, want in run_both(name, cfg, steps):
        np.testing.assert_allclose(got, want, err_msg=f"step {i}", **TOL)
    assert np.isfinite(got).all() and got.std() > 0


@pytest.mark.parametrize("name,kw", [
    ("ddim", dict(eta=0.5)), ("ddim", dict(eta=1.0)),
    ("euler_ancestral", {}), ("lcm", {})])
@pytest.mark.parametrize("frozen", [False, True], ids=["free", "frozen"])
def test_stochastic_run_matches_jax(name, kw, frozen):
    for i, got, want in run_both(name, "default", 5, frozen=frozen, **kw):
        np.testing.assert_allclose(got, want, err_msg=f"step {i}", **TOL)


def test_only_stochastic_samplers_draw_noise():
    cfg = SchedulerConfig()
    draws = {name: get_scheduler(name).draws_noise(
        get_scheduler(name).make_tables(cfg, 4))
        for name in ("pndm", "dpm", "ddim", "euler", "euler_ancestral",
                     "lms", "unipc", "lcm")}
    assert draws == dict(pndm=False, dpm=False, ddim=False, euler=False,
                         euler_ancestral=True, lms=False, unipc=False,
                         lcm=True)
    ddim = get_scheduler("ddim")
    assert ddim.draws_noise(ddim.make_tables(cfg, 4, eta=0.3))


def test_transition_noise_frozen_is_one_field_broadcast():
    x = torch.zeros(3, 4, 5, 6)
    free = transition_noise(torch.Generator().manual_seed(1), x)
    frozen = transition_noise(torch.Generator().manual_seed(1), x,
                              frozen=True)
    assert free.shape == (3, 4, 5, 6) and frozen.shape == (1, 4, 5, 6)
    assert free.dtype == frozen.dtype == torch.float32
    assert not torch.equal(free[0], free[1])
    # a seed gives the same field again
    torch.testing.assert_close(transition_noise(
        torch.Generator().manual_seed(1), x, frozen=True), frozen, rtol=0,
        atol=0)


def test_karras_timesteps_are_fractional_floats_as_in_jax():
    """The UNet gets the table's own timestep: JAX's float32 value under
    Karras sigmas, not its integer part."""
    for name in SIGMA_SAMPLERS:
        jt, pt = tables(name, "karras", 10)
        got = [get_scheduler(name).timestep(pt, i) for i in range(10)]
        want = [float(np.asarray(jt["timesteps"])[i]) for i in range(10)]
        assert all(isinstance(t, float) for t in got)
        assert got == want
        assert any(t != int(t) for t in got)
    jt, pt = tables("lcm", "default", 4)
    got = [get_scheduler("lcm").timestep(pt, i) for i in range(4)]
    assert got == [999, 759, 519, 279] == np.asarray(jt["timesteps"]).tolist()
    assert all(isinstance(t, int) for t in got)


def test_engine_feeds_the_unet_fractional_timesteps():
    from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
    from stable_diffusion_videos_tpu_torch.runtime.engine import Engine
    models = SDModels.tiny()
    models.scheduler_config = SchedulerConfig(use_karras_sigmas=True)
    seen = []
    hook = models.unet.register_forward_pre_hook(
        lambda mod, args: seen.append(args[1].tolist()))
    try:
        Engine(models, torch.device("cpu"), scheduler="euler").denoise_frames(
            np.zeros((1, 7, 32), np.float32), np.zeros((1, 7, 32), np.float32),
            np.zeros((1, 8, 8, 4), np.float32), num_inference_steps=3)
    finally:
        hook.remove()
    jt, _ = tables("euler", "karras", 3)
    want = [float(t) for t in np.asarray(jt["timesteps"])]
    assert seen == [[t, t] for t in want]
