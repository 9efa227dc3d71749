"""Frames of the PyTorch package against the JAX package's on the committed
trained checkpoint ``tests/goldens/structured_bundle``.

The JAX bundle's weights are carried into the port by ``from_jax_params``,
with the port's configs read from ``bundle.json``.  The 8 structured prompts
are embedded once by the JAX engine; both engines denoise them from the same
numpy noise at CFG 3.0 (the JAX package's gate tests on this checkpoint use
it), with pndm-50, dpm-20 x ``step_cache=2`` under "ends", and the ``fast``
preset (pndm-50 x ``step_cache=3`` x ``guidance_interval=(0.1, 0.85)``).
The frames must agree within 2/255 a pixel, and
``utils/metrics.quality_vs_exact`` of the port's frames against JAX's must
read PSNR >= 50 dB and SSIM >= 0.999 on every frame.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
from stable_diffusion_videos_tpu_torch.models.clip_text import (
    CLIPTextConfig, CLIPTextEncoder)
from stable_diffusion_videos_tpu_torch.models.tokenizer import HashTokenizer
from stable_diffusion_videos_tpu_torch.models.unet import (UNet2DCondition,
                                                           UNetConfig)
from stable_diffusion_videos_tpu_torch.models.vae import (AutoencoderKL,
                                                          VAEConfig)
from stable_diffusion_videos_tpu_torch.models.weights import (
    from_jax_params, load_state_dict)
from stable_diffusion_videos_tpu_torch.pipeline import \
    StableDiffusionWalkPipeline

from torch_threads import few_torch_threads  # noqa: F401 (autouse)

BUNDLE = Path(__file__).parent / "goldens" / "structured_bundle"
CPU = torch.device("cpu")
GUIDANCE = 3.0
MIN_PSNR, MIN_SSIM = 50.0, 0.999


def config(cls, fields: dict):
    """A port config from the bundle's JSON: the fields the port has, lists
    as tuples."""
    names = {f.name for f in cls.__dataclass_fields__.values()}
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in fields.items() if k in names})


@pytest.fixture(scope="module")
def structured():
    """(JAX bundle, port bundle on the same weights, cond, uncond, noise)."""
    from stable_diffusion_videos_tpu.models.bundle import SDModels as JModels
    from stable_diffusion_videos_tpu.runtime.engine import Engine as JEngine
    from stable_diffusion_videos_tpu.training import make_structured_dataset
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


@pytest.mark.parametrize("scheduler,steps,kw", [
    ("pndm", 50, {}),
    ("dpm", 20, dict(step_cache=2, step_cache_policy="ends")),
    ("pndm", 50, dict(fast=True))], ids=["pndm50", "dpm20_k2_ends", "fast"])
def test_frames_match_jax_on_the_trained_checkpoint(structured, scheduler,
                                                    steps, kw):
    from stable_diffusion_videos_tpu.pipeline import \
        StableDiffusionWalkPipeline as JaxWalk
    from stable_diffusion_videos_tpu.utils.metrics import quality_vs_exact
    jm, port, cond, uncond, noise = structured
    # the pipelines' constructors apply the fast preset; the engines run
    jeng = JaxWalk(jm, scheduler=scheduler, batch_bucket=len(cond),
                   safety=False, **kw).engine
    peng = StableDiffusionWalkPipeline(port, CPU, scheduler=scheduler,
                                       **kw).engine
    run = dict(num_inference_steps=steps, guidance_scale=GUIDANCE)
    want = np.asarray(jeng.denoise_frames(
        jnp.asarray(cond), jnp.asarray(uncond), jnp.asarray(noise), **run))
    got = peng.denoise_frames(cond, uncond, noise, **run)
    assert got.shape == want.shape == (8, 32, 32, 3)
    assert np.abs(got - want).max() <= 2 / 255
    q = quality_vs_exact(got, want)
    assert q["psnr_min"] >= MIN_PSNR and q["ssim_min"] >= MIN_SSIM, q
    assert want.std() > 0.05  # the checkpoint's patterns, not a flat field
