"""The PyTorch package's models and weight bridge against the JAX package.

Tiny UNet, VAE decoder and CLIP text encoder run on JAX params carried
across by ``from_jax_params`` (atol=rtol=1e-4, as
tests/test_torch_parity.py); ``from_jax_params`` reproduces the JAX
exporters key for key; the port's SD 1.x geometry matches the committed
diffusers-named manifest.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_diffusion_videos_tpu.models import weights as JW
from stable_diffusion_videos_tpu.models.clip_text import \
    CLIPTextEncoder as JCLIP
from stable_diffusion_videos_tpu.models.unet import UNet2DCondition as JUNet
from stable_diffusion_videos_tpu.models.vae import AutoencoderKL as JVAE
from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
from stable_diffusion_videos_tpu_torch.models.clip_text import (
    CLIPTextConfig, CLIPTextEncoder)
from stable_diffusion_videos_tpu_torch.models.unet import (UNet2DCondition,
                                                           UNetConfig)
from stable_diffusion_videos_tpu_torch.models.vae import (AutoencoderKL,
                                                          VAEConfig)
from stable_diffusion_videos_tpu_torch.models.weights import (
    from_jax_params, load_state_dict)

TOL = dict(atol=1e-4, rtol=1e-4)
GOLDEN = Path(__file__).parent / "goldens" / "sd1_full_geometry.npz"


def jax_configs():
    from stable_diffusion_videos_tpu.models.clip_text import CLIPTextConfig
    from stable_diffusion_videos_tpu.models.unet import UNetConfig as JU
    from stable_diffusion_videos_tpu.models.vae import VAEConfig as JV
    return JU.tiny(), JV.tiny(), CLIPTextConfig.tiny()


def randomised(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: rng.standard_normal(
        a.shape, dtype=np.float32) * 0.2, params)


@pytest.fixture(scope="module")
def jax_tiny():
    """JAX tiny params, every leaf redrawn from a numpy seed."""
    ju, jv, jt = jax_configs()
    k = jax.random.PRNGKey(0)
    unet = JUNet(ju).init(k, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                          jnp.zeros((1, 7, 32)))
    vae = JVAE(jv).init(k, jnp.zeros((1, 16, 16, 3)))
    text = JCLIP(jt).init(k, jnp.zeros((1, 77), jnp.int32))
    return {"unet": randomised(unet, 1), "vae": randomised(vae, 2),
            "text_encoder": randomised(text, 3)}


def test_tiny_unet_matches_jax(jax_tiny):
    ju = jax_configs()[0]
    rng = np.random.default_rng(4)
    lat = rng.standard_normal((2, 8, 8, 4), dtype=np.float32)
    ctx = rng.standard_normal((2, 7, 32), dtype=np.float32)
    t = np.array([3.0, 977.0], np.float32)
    want = np.asarray(JUNet(ju).apply(jax_tiny["unet"], lat, t, ctx))
    cfg = UNetConfig.tiny()
    unet = load_state_dict(UNet2DCondition(cfg),
                           from_jax_params(jax_tiny["unet"], cfg))
    with torch.no_grad():
        got = unet(torch.from_numpy(lat.transpose(0, 3, 1, 2)),
                   torch.from_numpy(t), torch.from_numpy(ctx))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, **TOL)


def test_tiny_vae_decoder_matches_jax(jax_tiny):
    jv = jax_configs()[1]
    z = np.random.default_rng(5).standard_normal((2, 4, 4, 4),
                                                 dtype=np.float32)
    want = np.asarray(JVAE(jv).apply(jax_tiny["vae"], z, method=JVAE.decode))
    vae = load_state_dict(AutoencoderKL(VAEConfig.tiny()),
                          from_jax_params(jax_tiny["vae"], VAEConfig.tiny()))
    with torch.no_grad():
        got = vae.decode(torch.from_numpy(z.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, **TOL)


def test_tiny_clip_matches_jax(jax_tiny):
    jt = jax_configs()[2]
    ids = np.random.default_rng(6).integers(0, 1000, (2, 77)).astype(np.int32)
    want = np.asarray(JCLIP(jt).apply(jax_tiny["text_encoder"], ids)[0])
    enc = load_state_dict(CLIPTextEncoder(CLIPTextConfig.tiny()),
                          from_jax_params(jax_tiny["text_encoder"],
                                          CLIPTextConfig.tiny()))
    with torch.no_grad():
        got = enc(torch.from_numpy(ids).long())[0].numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("part", ["unet", "vae", "text_encoder"])
def test_from_jax_params_matches_jax_exporters(jax_tiny, part):
    ju, jv, jt = jax_configs()
    export, jcfg, pcfg = {
        "unet": (JW.export_unet, ju, UNetConfig.tiny()),
        "vae": (JW.export_vae, jv, VAEConfig.tiny()),
        "text_encoder": (JW.export_text_encoder, jt, CLIPTextConfig.tiny()),
    }[part]
    want = export(jax_tiny[part], jcfg)
    got = from_jax_params(jax_tiny[part], pcfg)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("manifest_key,build", [
    ("unet_shapes", lambda: UNet2DCondition(UNetConfig.sd_v1())),
    ("vae_shapes", lambda: AutoencoderKL(VAEConfig.sd_v1()))],
    ids=["unet", "vae"])
def test_sd1_geometry_matches_committed_manifest(manifest_key, build):
    shapes = json.loads(str(np.load(GOLDEN)[manifest_key]))
    with torch.device("meta"):
        module = build()
    skipped = getattr(module, "SKIPPED_PREFIXES", ())
    want = {k: tuple(s) for k, s in shapes.items()
            if not k.startswith(skipped)}
    got = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    assert got == want


def test_load_state_dict_is_strict(jax_tiny):
    sd = from_jax_params(jax_tiny["vae"], VAEConfig.tiny())
    assert any(k.startswith("encoder.") for k in sd)  # dropped, not an error
    load_state_dict(AutoencoderKL(VAEConfig.tiny()), sd)
    missing = {k: v for k, v in sd.items() if k != "post_quant_conv.bias"}
    with pytest.raises(KeyError, match="post_quant_conv.bias"):
        load_state_dict(AutoencoderKL(VAEConfig.tiny()), missing)
    with pytest.raises(KeyError, match="decoder.extra"):
        load_state_dict(AutoencoderKL(VAEConfig.tiny()),
                        {**sd, "decoder.extra.weight": np.zeros(1)})
    bad = dict(sd, **{"post_quant_conv.bias": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        load_state_dict(AutoencoderKL(VAEConfig.tiny()), bad)


@pytest.mark.parametrize("kw", ["ctrl_down", "ctrl_mid", "ip_context",
                                "text_embeds", "time_ids"])
def test_unet_refuses_unported_inputs(kw):
    """Inputs the UNet cannot take raise ValueError naming them: ControlNet
    residuals of the wrong count or beside DeepCache's ``cache_split``,
    image tokens without spliced IP-Adapter projections, and SDXL's
    text_time inputs on a UNet without text_time conditioning."""
    m = SDModels.tiny()
    bad = {"ctrl_down": dict(ctrl_down=(torch.zeros(1, 32, 8, 8),)),
           "ctrl_mid": dict(ctrl_mid=torch.zeros(1, 64, 4, 4),
                            cache_split=1),
           "ip_context": dict(ip_context=torch.zeros(1, 4, 32)),
           "text_embeds": dict(text_embeds=1),
           "time_ids": dict(time_ids=1)}[kw]
    with pytest.raises(ValueError, match=kw):
        m.unet(torch.zeros(1, 4, 8, 8), torch.zeros(1), torch.zeros(1, 7, 32),
               **bad)


@pytest.mark.parametrize("kw,match", [
    (dict(cache_split=2), "cache_split must be in"),
    (dict(deep_feature=torch.zeros(1, 64, 8, 8)), "requires cache_split")],
    ids=["split_out_of_bounds", "deep_feature_without_split"])
def test_unet_checks_step_cache_inputs(kw, match):
    """As the JAX UNet: the tiny UNet's split must be in [1, 1], and a deep
    feature needs a split."""
    m = SDModels.tiny()
    with pytest.raises(ValueError, match=match):
        m.unet(torch.zeros(1, 4, 8, 8), torch.zeros(1), torch.zeros(1, 7, 32),
               **kw)


def test_bundles():
    tiny = SDModels.tiny(seed=3)
    again = SDModels.tiny(seed=3)
    assert tiny.dtype == torch.float32 and tiny.default_batch_size == 8
    for a, b in zip(tiny.unet.state_dict().values(),
                    again.unet.state_dict().values()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="sd3"):
        SDModels.random("sd3")
