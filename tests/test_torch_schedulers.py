"""The PyTorch package's sampler, interpolation, noise and guidance against
the JAX package's, on the same numpy inputs (fp32, tolerance 1e-5)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stable_diffusion_videos_tpu.core import interp as JI
from stable_diffusion_videos_tpu.core.rng import noise_for_seed as j_noise
from stable_diffusion_videos_tpu.core.schedulers import \
    get_scheduler as j_get
from stable_diffusion_videos_tpu.core.schedulers.base import \
    SchedulerConfig as JConfig
from stable_diffusion_videos_tpu_torch.core import interp as PI
from stable_diffusion_videos_tpu_torch.core.rng import noise_for_seed
from stable_diffusion_videos_tpu_torch.core.schedulers import (
    SchedulerConfig, get_scheduler)
from stable_diffusion_videos_tpu_torch.runtime.engine import apply_guidance

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("steps", [4, 50])
def test_pndm_tables_match_jax(steps):
    want = j_get("pndm").make_tables(JConfig(), steps)
    got = get_scheduler("pndm").make_tables(SchedulerConfig(), steps)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, str):
            assert got[k] == v
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                          err_msg=k)


def test_pndm_five_step_run_matches_jax():
    js, ps = j_get("pndm"), get_scheduler("pndm")
    jt = js.make_tables(JConfig(), 5)
    pt = ps.make_tables(SchedulerConfig(), 5)
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((2, 4, 8, 8), dtype=np.float32)
    eps = rng.standard_normal((ps.num_loop_steps(pt), 2, 4, 8, 8),
                              dtype=np.float32)
    jx, jstate = jnp.asarray(x0), js.init_state(jt, x0.shape)
    px = torch.from_numpy(x0)
    pstate = ps.init_state(pt, px)
    assert ps.num_loop_steps(pt) == js.num_loop_steps(jt) == 6
    for i in range(ps.num_loop_steps(pt)):
        assert ps.timestep(pt, i) == int(js.timestep(jt, i))
        jstate, jx = js.step(jt, jstate, i, jnp.asarray(eps[i]), jx)
        pstate, px = ps.step(pt, pstate, i, torch.from_numpy(eps[i]), px)
        np.testing.assert_allclose(px.numpy(), np.asarray(jx), **TOL)


def test_only_pndm_is_ported():
    """Every sampler of the JAX package is served (the name is historical:
    pndm came first); an unknown name raises."""
    from stable_diffusion_videos_tpu.core.schedulers import SCHEDULER_NAMES
    assert len(SCHEDULER_NAMES) == 8
    for name in SCHEDULER_NAMES:
        assert get_scheduler(name).name == name
    with pytest.raises(KeyError, match="heun"):
        get_scheduler("heun")


@pytest.mark.parametrize("near", [False, True], ids=["slerp", "lerp_branch"])
@pytest.mark.parametrize("t", [0.37, [0.0, 0.25, 0.6, 1.0]],
                         ids=["scalar", "vector"])
def test_slerp_and_lerp_match_jax(near, t):
    rng = np.random.default_rng(1)
    v0 = rng.standard_normal((4, 8, 8), dtype=np.float32)
    v1 = (v0 + 1e-3 * rng.standard_normal(v0.shape, dtype=np.float32)
          if near else rng.standard_normal(v0.shape, dtype=np.float32))
    tt = np.asarray(t, np.float32)
    for jf, pf in ((JI.slerp, PI.slerp), (JI.lerp, PI.lerp)):
        want = np.asarray(jf(jnp.asarray(tt), jnp.asarray(v0),
                             jnp.asarray(v1)))
        got = pf(tt, torch.from_numpy(v0), torch.from_numpy(v1)).numpy()
        np.testing.assert_allclose(got, want, **TOL)


def test_noise_for_seed_is_bit_equal_to_jax():
    for seed in (0, 42, 2 ** 31 + 5):
        want = j_noise(seed, (2, 8, 8, 4))  # NHWC, impl="torch"
        got = noise_for_seed(seed, (2, 4, 8, 8), torch.device("cpu"))
        np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1), want)


@pytest.mark.parametrize("rescale", [0.0, 0.7])
def test_apply_guidance_matches_jax(rescale):
    from stable_diffusion_videos_tpu.runtime.engine import \
        apply_guidance as j_apply
    rng = np.random.default_rng(2)
    u, c = rng.standard_normal((2, 2, 4, 8, 8), dtype=np.float32)
    want = np.asarray(j_apply(jnp.asarray(u), jnp.asarray(c), 7.5, rescale))
    got = apply_guidance(torch.from_numpy(u), torch.from_numpy(c), 7.5,
                         rescale).numpy()
    np.testing.assert_allclose(got, want, **TOL)
