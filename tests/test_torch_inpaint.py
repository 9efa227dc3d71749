"""inpaint of the PyTorch package against the JAX package's.

``Engine.inpaint`` for all eight samplers on the tiny bundles (10 steps,
CFG 3): the port is fed the JAX engine's first field ``noise0`` (drawn from
``split(key, 3)[1]`` over the padded batch) and its step fields (from the
third key), frames within 1e-4.  The latent mask of the pipelines: the
port's nearest-exact resize equals ``jax.image.resize(..., "nearest")`` bit
for bit on masks whose edges and sides are not multiples of 8.  Under
``vae_tile`` the port's inpaint decodes its latents once, in tiles (the
JAX engine tiled-decodes frames that were already decoded there and
fails): an all-zero mask keeps the clean latents, so the frames are the
tiled decode of the source.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_diffusion_videos_tpu_torch.pipeline.walk import latent_mask
from stable_diffusion_videos_tpu_torch.runtime.engine import Engine

from test_torch_img2img import SAMPLERS, image_inputs
from test_torch_sampler_engines import (ENGINE_TOL, JaxNoise, engine_inputs,
                                        tiny_bundles)
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def bundles():
    return tiny_bundles()


def half_mask(b: int = 2, side: int = 8) -> np.ndarray:
    """(b, side, side, 1): regenerate the left columns, keep the rest."""
    m = np.zeros((b, side, side, 1), np.float32)
    m[:, :, :side // 2 - 1] = 1.0
    return m


@pytest.mark.parametrize("scheduler", SAMPLERS)
def test_inpaint_matches_jax(bundles, scheduler):
    from stable_diffusion_videos_tpu.runtime.engine import Engine as JEngine
    jm, pm = bundles
    cond, uncond, _ = engine_inputs()
    lat, _ = image_inputs()
    mask = half_mask()
    key = jax.random.PRNGKey(8)
    run = dict(num_inference_steps=10, guidance_scale=3.0)
    want = np.asarray(JEngine(jm, scheduler=scheduler, batch_bucket=8)
                      .inpaint(jnp.asarray(cond), jnp.asarray(uncond),
                               jnp.asarray(lat), jnp.asarray(mask), key=key,
                               **run))
    _, kn, ks = jax.random.split(key, 3)
    noise0 = np.asarray(jax.random.normal(kn, (8, 8, 8, 4), jnp.float32))
    got = Engine(pm, CPU, scheduler=scheduler, batch_bucket=8).inpaint(
        cond, uncond, lat, mask, noise=noise0[:2], generator=JaxNoise(ks),
        **run)
    assert got.shape == want.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got, want, **ENGINE_TOL)
    assert got.std() > 0


@pytest.mark.parametrize("size,lat", [((64, 64), (8, 8)),
                                      ((70, 45), (8, 5)),
                                      ((40, 56), (5, 7))])
def test_latent_mask_matches_jax_resize(size, lat):
    """A rectangle whose edges fall off the 8-pixel grid, and random
    values, at sides that are and are not multiples of 8."""
    h, w = size
    m = np.zeros(size, np.float32)
    m[3:h - 5, 11:w - 2] = 1.0
    noisy = np.random.default_rng(2).uniform(0, 1, size).astype(np.float32)
    for mask in (m, noisy, (m * 255).astype(np.uint8)):
        want = np.asarray(jax.image.resize(
            jnp.asarray(mask if mask.dtype != np.uint8 else mask / 255.0,
                        jnp.float32), lat, "nearest"))
        got = latent_mask(mask, *lat).numpy()
        np.testing.assert_array_equal(got, want)


def test_tiled_inpaint_decodes_once(bundles):
    _, pm = bundles
    cond, uncond, _ = engine_inputs()
    lat = np.random.default_rng(4).standard_normal(
        (2, 12, 10, 4)).astype(np.float32)
    tiled = Engine(pm, CPU, scheduler="ddim", vae_tile=6, vae_tile_overlap=2)
    run = dict(num_inference_steps=4, guidance_scale=3.0)
    keep = tiled.inpaint(cond, uncond, lat, np.zeros((2, 12, 10, 1)), **run)
    np.testing.assert_allclose(keep, tiled.decode_latents_tiled(lat),
                               atol=1e-6, rtol=1e-6)
    mask = np.zeros((2, 12, 10, 1), np.float32)
    mask[:, :6] = 1.0
    got = tiled.inpaint(cond, uncond, lat, mask, output_dtype="uint8", **run)
    assert got.shape == (2, 24, 20, 3) and got.dtype == np.uint8
    kept = np.round(np.clip(keep, 0, 1) * 255)
    assert np.abs(got[:, :12].astype(int) - kept[:, :12]).max() > 8
