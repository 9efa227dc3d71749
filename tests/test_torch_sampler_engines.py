"""The PyTorch package's engine against the JAX package's with the
deterministic samplers this port adds: euler (Karras sigmas), lms and
unipc, under CFG on the tiny geometry; and ddim's table cache keyed on eta.

Both engines run the same weights: random numpy values filled into the JAX
tiny bundle's parameter tree (its shapes from ``jax.eval_shape``, so no
initialiser runs), carried into the port by ``from_jax_params``.  Float
frames must agree within 1e-4.  ``tests/test_torch_stochastic_engines.py``
holds the stochastic samplers, with the helpers defined here.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_diffusion_videos_tpu_torch.core.schedulers import \
    SchedulerConfig
from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
from stable_diffusion_videos_tpu_torch.models.weights import (
    from_jax_params, load_state_dict)
from stable_diffusion_videos_tpu_torch.runtime.engine import Engine

from torch_threads import few_torch_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")
ENGINE_TOL = dict(atol=1e-4, rtol=1e-4)


def jax_tiny_models(seed: int = 0):
    """The JAX package's tiny bundle with every parameter drawn N(0, 0.1)
    from a numpy seed into the shapes its initialisers would give."""
    from stable_diffusion_videos_tpu.models import bundle as B
    ucfg, vcfg, tcfg = (B.UNetConfig.tiny(), B.VAEConfig.tiny(),
                        B.CLIPTextConfig.tiny())
    lat = jnp.zeros((1, ucfg.sample_size, ucfg.sample_size, 4))
    ctx = jnp.zeros((1, 7, ucfg.cross_attention_dim))
    img = ucfg.sample_size * vcfg.scale_factor
    inits = {
        "unet": lambda k: B.UNet2DCondition(ucfg).init(
            k, lat, jnp.zeros((1,)), ctx),
        "vae": lambda k: B.AutoencoderKL(vcfg).init(
            k, jnp.zeros((1, img, img, 3))),
        "text_encoder": lambda k: B.CLIPTextEncoder(tcfg).init(
            k, jnp.zeros((1, 77), jnp.int32)),
    }
    rng = np.random.default_rng(seed)
    params = {part: jax.tree.map(
        lambda s: rng.standard_normal(s.shape, dtype=np.float32) * 0.1,
        jax.eval_shape(init, jax.random.PRNGKey(0)))
        for part, init in inits.items()}
    return B.SDModels(ucfg, vcfg, tcfg, params,
                      B.HashTokenizer(vocab_size=tcfg.vocab_size),
                      B.SchedulerConfig(), dtype=jnp.float32)


def tiny_bundles():
    """(JAX tiny bundle, port tiny bundle on the same weights)."""
    jm = jax_tiny_models()
    pm = SDModels.tiny()
    for module, part, cfg in ((pm.unet, "unet", pm.unet_config),
                              (pm.vae, "vae", pm.vae_config),
                              (pm.text_encoder, "text_encoder",
                               pm.text_config)):
        load_state_dict(module, from_jax_params(jm.params[part], cfg))
    return jm, pm


@pytest.fixture(scope="module")
def bundles():
    return tiny_bundles()


class JaxNoise:
    """The port engine's noise source that replays the JAX engine's key
    chain: each step splits the key and draws a field of the padded
    latents' shape (one ``(h, w, 4)`` field under frozen noise), NHWC,
    returned NCHW."""

    def __init__(self, key, frozen: bool = False):
        self.key, self.frozen = key, frozen

    def __call__(self, i, lat):
        self.key, sub = jax.random.split(self.key)
        b, c, h, w = lat.shape
        if self.frozen:
            field = np.asarray(jax.random.normal(sub, (h, w, c)))
            return torch.from_numpy(np.ascontiguousarray(
                field.transpose(2, 0, 1)[None]))
        field = np.asarray(jax.random.normal(sub, (b, h, w, c)))
        return torch.from_numpy(np.ascontiguousarray(
            field.transpose(0, 3, 1, 2)))


def engine_inputs():
    rng = np.random.default_rng(3)
    cond = rng.standard_normal((2, 7, 32), dtype=np.float32)
    uncond = rng.standard_normal((1, 7, 32), dtype=np.float32)
    noise = rng.standard_normal((2, 8, 8, 4), dtype=np.float32)
    return cond, uncond, noise


def engine_frames(bundles, scheduler, run, sched_cfg=None, key_seed=5):
    """(port frames, JAX frames) of one dispatch on the tiny bundles, the
    port fed the JAX engine's noise fields."""
    from stable_diffusion_videos_tpu.core.schedulers.base import \
        SchedulerConfig as JConfig
    from stable_diffusion_videos_tpu.runtime.engine import Engine as JEngine
    jm, pm = bundles
    jm = dataclasses.replace(jm, scheduler_config=JConfig(**(sched_cfg or {})))
    pm = dataclasses.replace(
        pm, scheduler_config=SchedulerConfig(**(sched_cfg or {})))
    cond, uncond, noise = engine_inputs()
    key = jax.random.PRNGKey(key_seed)
    run = dict(num_inference_steps=5, guidance_scale=3.0, **run)
    # one bucket for both, so the padded batch draws the same fields
    want = JEngine(jm, scheduler=scheduler, batch_bucket=8).denoise_frames(
        jnp.asarray(cond), jnp.asarray(uncond), jnp.asarray(noise), key=key,
        **run)
    got = Engine(pm, CPU, scheduler=scheduler, batch_bucket=8).denoise_frames(
        cond, uncond, noise, generator=JaxNoise(key), **run)
    assert got.shape == (2, 16, 16, 3) and got.dtype == np.float32
    assert got.std() > 0
    return got, np.asarray(want)


@pytest.mark.parametrize("scheduler,sched_cfg", [
    ("euler", dict(use_karras_sigmas=True)), ("lms", {}), ("unipc", {})],
    ids=["euler_karras", "lms", "unipc"])
def test_engine_matches_jax(bundles, scheduler, sched_cfg):
    got, want = engine_frames(bundles, scheduler, {}, sched_cfg)
    np.testing.assert_allclose(got, want, **ENGINE_TOL)


def test_table_cache_keys_on_eta(bundles):
    """ddim's tables hold eta, so a dispatch at another eta builds its own
    (a cache keyed on (name, steps) would hand eta 0.5 the eta-0 tables)."""
    _, pm = bundles
    eng = Engine(pm, CPU, scheduler="ddim")
    cond, uncond, noise = engine_inputs()
    run = dict(num_inference_steps=3, guidance_scale=3.0)
    plain = eng.denoise_frames(cond, uncond, noise, **run)
    noisy = eng.denoise_frames(cond, uncond, noise, eta=0.5, **run)
    assert np.abs(noisy - plain).max() > 1e-3
    np.testing.assert_array_equal(
        eng.denoise_frames(cond, uncond, noise, eta=0.0, **run), plain)
    assert sorted(eng._tables_cache) == [("ddim", 3, 0.0), ("ddim", 3, 0.5)]
