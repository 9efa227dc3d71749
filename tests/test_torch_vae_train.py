"""The PyTorch package's VAE trainer against the JAX package's.

Both train the same tiny bundle's VAE (``test_torch_sampler_engines.
tiny_bundles``) on the same images; the JAX trainer runs on a one-device
mesh and draws the posterior noise from its step key, which the test
re-derives and hands to the port's ``train_step``.  ``kl_weight`` 0.1, so
the KL term moves the weights visibly.  Tolerances, fp32: the
reconstruction MSE 1e-5 relative; weights after two clipped Adam steps as
``test_torch_training.assert_adam_close`` says; the reconstruction PSNR
1e-4 dB.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_diffusion_videos_tpu_torch.models.weights import from_jax_params
from stable_diffusion_videos_tpu_torch.training import VAETrainer

from test_torch_sampler_engines import tiny_bundles
from test_torch_training import (CPU, LOSS_TOL, assert_adam_close,
                                 noise_level_grads, one_device_mesh)
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

LR, KL = 1e-3, 0.1


def images(seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)


def jax_noise(key, imgs):
    """The JAX step's posterior noise: normal of the posterior mean's
    (B, h, w, 4) shape."""
    b, h, w, _ = imgs.shape
    return np.array(jax.random.normal(key, (b, h // 2, w // 2, 4),
                                      jnp.float32))


@pytest.fixture(scope="module")
def trained():
    from stable_diffusion_videos_tpu.training import VAETrainer as JTrainer
    jm, pm = tiny_bundles()
    jt = JTrainer(jm, mesh=one_device_mesh(), learning_rate=LR,
                  kl_weight=KL, max_grad_norm=0.5)
    pt = VAETrainer(pm, learning_rate=LR, kl_weight=KL, max_grad_norm=0.5,
                    device=CPU)
    probe = VAETrainer(pm, learning_rate=LR, kl_weight=KL, device=CPU)
    imgs = images()
    noisy = noise_level_grads(probe.weights.master, probe.loss(
        torch.from_numpy(imgs),
        torch.from_numpy(jax_noise(jax.random.PRNGKey(30), imgs)))[0])
    recs = []
    for i in range(2):
        key = jax.random.PRNGKey(30 + i)
        recs.append((pt.train_step(imgs, jax_noise(key, imgs)),
                     jt.step(imgs, key=key)))
    return (jm, pm), jt, pt, recs, noisy


def test_two_steps_match_jax(trained):
    (_, pm), jt, pt, recs, noisy = trained
    for got, want in recs:
        np.testing.assert_allclose(got, want, **LOSS_TOL)
    want = from_jax_params(jt.export_params(), pm.vae_config)
    got = pt.export_params().vae.state_dict()
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert_adam_close(got[k].numpy(), w, LR, 2, k,
                          rounding_only=k in noisy)


def test_recon_psnr_matches_jax(trained):
    _, jt, pt, _, _ = trained
    imgs = images(1)
    np.testing.assert_allclose(pt.recon_psnr(imgs), jt.recon_psnr(imgs),
                               atol=1e-4, rtol=0)


def test_step_draws_noise_from_the_step_count(trained):
    (_, pm), _, _, _, _ = trained
    a, b = (VAETrainer(pm, device=CPU) for _ in range(2))
    imgs = images(2)
    assert a.step(imgs) == b.step(imgs)
    assert a.step_count == 1 and np.isfinite(a.recon_psnr(imgs))
    fresh = tiny_bundles()[1].vae.state_dict()
    for k, v in pm.vae.state_dict().items():
        assert torch.equal(v, fresh[k]), k
