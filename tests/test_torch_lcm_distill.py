"""The PyTorch package's LCM distiller against the JAX package's.

``boundary_coefficients`` equals the JAX package's and the port's own
``lcm`` sampler tables (fp32 1e-6). Both distillers then run two steps on
the same tiny bundle (``test_torch_sampler_engines.tiny_bundles``), the JAX
one on a one-device mesh; its origin-schedule indices and noise are
re-derived from each step key and handed to the port's ``train_step``.
Tolerances, fp32: the pseudo-Huber loss 1e-5 relative; the first step's
gradient rtol 1e-4 and atol 1e-4 of the largest gradient element (as the
UNet trainer's test, whose atol of 1e-5 is 1e-4 of its largest); the
student and the EMA target after two AdamW steps at lr 1e-3 within a
quarter of lr a step (``test_torch_training.assert_adam_close``). That
bound is wider than the UNet trainer's twentieth because the first step's
loss is near 0 by construction (student, target and teacher are one
network), so its gradients are near 1e-7, within a factor of ten of Adam's
eps of 1e-8: an element whose gradient the two packages' orders of
summation leave 4e-10 apart then moves by a few hundredths of lr more in
one than in the other.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_diffusion_videos_tpu_torch.core.schedulers import SchedulerConfig
from stable_diffusion_videos_tpu_torch.core.schedulers.lcm import LCM
from stable_diffusion_videos_tpu_torch.models.weights import from_jax_params
from stable_diffusion_videos_tpu_torch.training import (LCMDistillConfig,
                                                        LCMDistiller)
from stable_diffusion_videos_tpu_torch.training.lcm_distill import \
    boundary_coefficients

from test_torch_sampler_engines import tiny_bundles
from test_torch_training import (CPU, LOSS_TOL, assert_unet_close,
                                 noise_level_grads, one_device_mesh,
                                 train_data)
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

LR = 1e-3


def test_boundary_coefficients_match_jax_and_the_sampler():
    from stable_diffusion_videos_tpu.training.lcm_distill import \
        boundary_coefficients as jax_coefficients
    t = np.array([0, 1, 19, 259, 499, 999])
    for got, want in zip(boundary_coefficients(t), jax_coefficients(t)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=1e-6)
    tables = LCM().make_tables(SchedulerConfig(), 4)
    c_skip, c_out = boundary_coefficients(tables["timesteps"])
    np.testing.assert_allclose(c_skip.numpy(), tables["c_skip"], atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(c_out.numpy(), tables["c_out"], atol=1e-6,
                               rtol=1e-6)


def jax_idx_and_noise(key, shape, n_ts):
    """The JAX distill step's draws from its key."""
    ki, kn = jax.random.split(key)
    idx = jax.random.randint(ki, (shape[0],), 0, n_ts - 1)
    return np.array(idx), np.array(jax.random.normal(kn, shape, jnp.float32))


@pytest.fixture(scope="module")
def distilled():
    from stable_diffusion_videos_tpu.training import \
        LCMDistillConfig as JConfig
    from stable_diffusion_videos_tpu.training import LCMDistiller as JDist
    jm, pm = tiny_bundles()
    jd = JDist(jm, mesh=one_device_mesh(),
               config=JConfig(learning_rate=LR))
    pd = LCMDistiller(pm, config=LCMDistillConfig(learning_rate=LR),
                      device=CPU)
    lat, ctx = train_data()
    uctx = np.random.default_rng(9).standard_normal((1, 7, 32),
                                                    dtype=np.float32)
    n_ts = pd._ts.shape[0]
    probe = LCMDistiller(pm, config=LCMDistillConfig(learning_rate=LR),
                         device=CPU)
    idx, noise = jax_idx_and_noise(jax.random.PRNGKey(40), lat.shape, n_ts)
    loss = probe.loss(torch.from_numpy(lat), torch.from_numpy(ctx),
                      torch.from_numpy(uctx).expand(2, -1, -1),
                      torch.from_numpy(idx), torch.from_numpy(noise))
    grads = jax_first_gradient(jm, lat, ctx, uctx, idx, noise)
    noisy = noise_level_grads(probe.student.master, loss, threshold=1e-12)
    first = (loss.item(), grads, {n: p.grad for n, p in
                                  probe.student.master.named_parameters()})
    losses = []
    for i in range(2):
        key = jax.random.PRNGKey(40 + i)
        losses.append((
            pd.train_step(lat, ctx, uctx,
                          *jax_idx_and_noise(key, lat.shape, n_ts)),
            jd.step(lat, ctx, uctx, key=key)))
    return (jm, pm), jd, pd, losses, noisy, first


def jax_first_gradient(jm, lat, ctx, uctx, idx, noise):
    """The JAX distiller's loss and gradient at its first step (its
    ``loss_fn``, ``training/lcm_distill.py``, written out: student, target
    and teacher are the bundle's UNet)."""
    from stable_diffusion_videos_tpu.core.schedulers.base import \
        alphas_cumprod_for
    from stable_diffusion_videos_tpu.core.schedulers.lcm import \
        lcm_timesteps
    from stable_diffusion_videos_tpu.training.lcm_distill import \
        boundary_coefficients as jax_coefficients
    unet, base = jm.unet(), jm.params["unet"]
    acp = jnp.asarray(alphas_cumprod_for(jm.scheduler_config), jnp.float32)
    ts = jnp.asarray(lcm_timesteps(jm.scheduler_config, 50, 50), jnp.int32)

    def consistency(params, x, t, a, c):
        eps = unet.apply(params, x, t.astype(jnp.float32), c)
        c_skip, c_out = (v[:, None, None, None] for v in jax_coefficients(t))
        return c_skip * x + c_out * (x - jnp.sqrt(1.0 - a) * eps) \
            / jnp.sqrt(a)

    def loss_fn(params, x0, c, uc, i, n):
        t_hi, t_lo = ts[i], ts[i + 1]
        a_hi, a_lo = (acp[t][:, None, None, None] for t in (t_hi, t_lo))
        x_t = jnp.sqrt(a_hi) * x0 + jnp.sqrt(1.0 - a_hi) * n
        eps2 = unet.apply(base, jnp.concatenate([x_t, x_t]),
                          jnp.concatenate([t_hi, t_hi]).astype(jnp.float32),
                          jnp.concatenate([uc, c]))
        eps_hat = eps2[:2] + 3.0 * (eps2[2:] - eps2[:2])
        x0_t = (x_t - jnp.sqrt(1.0 - a_hi) * eps_hat) / jnp.sqrt(a_hi)
        x_s = jnp.sqrt(a_lo) * x0_t + jnp.sqrt(1.0 - a_lo) * eps_hat
        d = consistency(params, x_t, t_hi, a_hi, c) - jax.lax.stop_gradient(
            consistency(base, jax.lax.stop_gradient(x_s), t_lo, a_lo, c))
        return jnp.mean(jnp.sqrt(d * d + 1e-6) - 1e-3)

    uc = np.broadcast_to(uctx, (2,) + uctx.shape[1:])
    return jax.value_and_grad(loss_fn)(base, *map(jnp.asarray, (
        lat, ctx, uc, idx, noise)))


def test_first_loss_and_gradient_match_jax(distilled):
    (_, pm), _, _, _, _, (loss, (jloss, jgrads), grads) = distilled
    np.testing.assert_allclose(loss, float(jloss), **LOSS_TOL)
    want = from_jax_params(jgrads, pm.unet_config)
    scale = max(np.abs(np.asarray(w)).max() for w in want.values())
    for name, g in grads.items():
        np.testing.assert_allclose(
            g.numpy(), np.asarray(want[name]).reshape(g.shape), rtol=1e-4,
            atol=1e-4 * scale, err_msg=name)


def test_two_steps_match_jax(distilled):
    (_, pm), jd, pd, losses, noisy, _ = distilled
    for got, want in losses:
        np.testing.assert_allclose(got, want, **LOSS_TOL)
    for ema in (False, True):
        assert_unet_close(pd.export_params(ema=ema).unet,
                          jd.export_params(ema=ema)["unet"], pm.unet_config,
                          lr=LR, steps=2, noise_level=noisy, share=0.25)


def test_teacher_and_bundle_stay_unchanged(distilled):
    (_, pm), _, pd, _, _, _ = distilled
    fresh = tiny_bundles()[1].unet.state_dict()
    for k, v in pm.unet.state_dict().items():
        assert torch.equal(v, fresh[k]), k
    assert pd.teacher is pm.unet and pd.step_count == 2
    moved = [not torch.equal(s, t) for s, t in zip(
        pd.student.parameters(), pd.target.parameters())]
    assert any(moved)
