"""The encoders of the PyTorch package against the JAX package's.

The asymmetric downsample (the VAE encoder's (0, 1) padding) and the tiny
KL encoder's mean and log-variance at fp32 1e-4; ``Engine.encode_image``
whole and in overlapping tiles (a last tile that clamps back, and a
non-square image with an axis below one tile) at 1e-4.  The TAESD encoder:
one set of random weights, handed to the JAX converter in the upstream
layout (which for the encoder is diffusers' without the ``encoder.layers.``
prefix) and to the port under diffusers ``AutoencoderTiny`` names, at the
published stage structure (narrow) and the tiny geometry, 1e-4;
``from_jax_params`` gives the same diffusers dict, and ``with_taesd``
carries the encoder.  Last, the full-width encoders' GroupNorm and
attention calls, and those of the full-width SD 1.x UNet with a ControlNet,
an IP-Adapter and a weighted context of two windows, recorded on the meta
device, are all keys that ``chip_smoke.py`` phase 3 checks.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_diffusion_videos_tpu_torch.models import layers
from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
from stable_diffusion_videos_tpu_torch.models.taesd import (AutoencoderTiny,
                                                            TAESDConfig)
from stable_diffusion_videos_tpu_torch.models.vae import (AutoencoderKL,
                                                          VAEConfig)
from stable_diffusion_videos_tpu_torch.models.weights import (
    from_jax_params, load_state_dict, random_state_dict)
from stable_diffusion_videos_tpu_torch.runtime.engine import Engine

from test_torch_sampler_engines import tiny_bundles
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
TOL = dict(atol=1e-4, rtol=1e-4)
GEOMETRIES = {"sd_stages_narrow": TAESDConfig(width=8),
              "tiny": TAESDConfig.tiny()}


@pytest.fixture(scope="module")
def bundles():
    return tiny_bundles()


def images(shape, seed=3) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


@pytest.mark.parametrize("asymmetric", [True, False])
def test_downsample_matches_jax(asymmetric):
    from stable_diffusion_videos_tpu.models.layers import Downsample2D as J
    x = images((2, 9, 10, 8))
    module = J(8, asymmetric=asymmetric)
    params = module.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(module.apply(params, jnp.asarray(x)))
    port = layers.Downsample2D(8, asymmetric=asymmetric)
    kernel = np.asarray(params["params"]["conv"]["kernel"])
    load_state_dict(port, {"conv.weight": kernel.transpose(3, 2, 0, 1),
                           "conv.bias": params["params"]["conv"]["bias"]})
    with torch.no_grad():
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    # an odd side: the two paddings give 4 and 5 rows
    assert got.transpose(0, 2, 3, 1).shape == want.shape
    assert want.shape == ((2, 4, 5, 8) if asymmetric else (2, 5, 5, 8))
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, **TOL)


def test_tiny_encoder_matches_jax(bundles):
    from stable_diffusion_videos_tpu.models.vae import AutoencoderKL as JVAE
    jm, pm = bundles
    x = images((2, 16, 12, 3))
    mean, logvar = JVAE(jm.vae_config).apply(
        jm.params["vae"], jnp.asarray(x), method=JVAE.encode)
    with torch.no_grad():
        got = pm.vae.encode(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    for g, w in zip(got, (mean, logvar)):
        assert tuple(g.shape) == (2, 4, 8, 6)
        np.testing.assert_allclose(g.numpy().transpose(0, 2, 3, 1),
                                   np.asarray(w), **TOL)
    assert got[0].std() > 0


@pytest.mark.parametrize("tile,shape", [(None, (2, 16, 16, 3)),
                                        (6, (2, 24, 20, 3)),
                                        (6, (1, 10, 28, 3))],
                         ids=["whole", "tiled", "tiled_narrow_axis"])
def test_encode_image_matches_jax(bundles, tile, shape):
    from stable_diffusion_videos_tpu.runtime.engine import Engine as JEngine
    jm, pm = bundles
    x = images(shape)
    kw = {} if tile is None else dict(vae_tile=tile, vae_tile_overlap=2)
    want = np.asarray(JEngine(jm, **kw).encode_image(jnp.asarray(x)))
    got = Engine(pm, CPU, **kw).encode_image(x)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (shape[0], shape[1] // 2,
                                              shape[2] // 2, 4)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def taesd_encoder_weights(cfg: TAESDConfig, seed: int = 0) -> dict:
    """The encoder's diffusers-named arrays, N(0, 0.05) from a seed."""
    with torch.device("meta"):
        shapes = AutoencoderTiny(cfg, encoder=True).encoder
    return {f"encoder.{k}": v
            for k, v in random_state_dict(shapes, seed, 0.05).items()}


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_taesd_encoder_matches_jax(geometry):
    from stable_diffusion_videos_tpu.models.taesd import (
        TAESDEncoder, convert_taesd_encoder)
    cfg = GEOMETRIES[geometry]
    diffusers = taesd_encoder_weights(cfg)
    # the upstream encoder Sequential has no Clamp: its indices are
    # diffusers' own
    upstream = {k.removeprefix("encoder.layers."): v
                for k, v in diffusers.items()}
    jcfg, jparams = convert_taesd_encoder(upstream)
    assert (jcfg.width, jcfg.num_stages, jcfg.blocks_per_stage) == (
        cfg.width, cfg.num_stages, cfg.blocks_per_stage)
    f = cfg.scale_factor
    x = np.random.default_rng(1).uniform(
        0, 1, (2, 6 * f, 5 * f, 3)).astype(np.float32)
    want = np.asarray(TAESDEncoder(jcfg).apply(jparams, jnp.asarray(x)))
    with torch.device("meta"):
        port = AutoencoderTiny(cfg, encoder=True)
    decoder = random_state_dict(AutoencoderTiny(cfg), 1, 0.05)
    load_state_dict(port, {**decoder, **diffusers})
    with torch.no_grad():
        got = port.encode(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    assert got.shape == (2, 4, 6, 5)
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, **TOL)
    assert got.std() > 0
    bridged = from_jax_params(jparams, cfg)
    assert sorted(bridged) == sorted(diffusers)
    for k, v in diffusers.items():
        np.testing.assert_array_equal(bridged[k], v, err_msg=k)


def test_with_taesd_carries_the_encoder():
    cfg = TAESDConfig.tiny()
    decoder = random_state_dict(AutoencoderTiny(cfg), 1, 0.05)
    tiny = SDModels.tiny()
    assert tiny.with_taesd(cfg, decoder).taesd.encoder is None
    both = tiny.with_taesd(cfg, {**decoder, **taesd_encoder_weights(cfg)})
    x = torch.rand(1, 3, 8, 8)
    assert tuple(both.taesd.encode(x).shape) == (1, 4, 4, 4)
    with pytest.raises(ValueError, match="encoder"):
        tiny.with_taesd(cfg, decoder).taesd.encode(x)
    assert SDModels.tiny(taesd=True).taesd.encoder is not None


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def recorded_kernel_keys(monkeypatch, run) -> tuple:
    """Run ``run()`` on meta tensors with the models' two ops replaced by
    recorders of the keys the wrappers count launches by: -> (attention
    keys, GroupNorm keys)."""
    attn, gn = set(), set()

    def attention(q, k, v, scale=None):
        b, sq, h, d = q.shape
        attn.add((b, sq, k.shape[1], h, d, q.dtype))
        return torch.empty_like(q)

    def groupnorm(x, scale, bias, num_groups=32, eps=1e-5, silu=True):
        gn.add((tuple(x.shape), float(eps), bool(silu), x.dtype,
                scale.dtype))
        return torch.empty_like(x)

    monkeypatch.setattr(layers, "attention", attention)
    monkeypatch.setattr(layers, "fused_groupnorm_silu", groupnorm)
    with torch.no_grad():
        run()
    return attn, gn


def assert_checked(smoke, attn, gn):
    bf16 = torch.bfloat16
    checked_attn = {(*s, bf16) for s in smoke.ATTN_SHAPES
                    + smoke.FAMILY_ATTN_SHAPES + smoke.EDIT_ATTN_SHAPES
                    + smoke.ADDON_ATTN_SHAPES}
    checked_gn = {(*c, bf16, bf16) for c in smoke.GN_SHAPES
                  + smoke.FAMILY_GN_SHAPES + smoke.EDIT_GN_SHAPES}
    assert attn and gn
    assert sorted(attn - checked_attn, key=str) == []
    assert sorted(gn - checked_gn, key=str) == []


def test_full_width_encoders_run_at_checked_keys(monkeypatch):
    """The SD 1.x encoder at 512², batch 8 (also the 512² tiles of a
    1024² tiled encode) and the SDXL encoder at 1024², batch 1."""
    smoke = chip_smoke()
    with torch.device("meta"):
        vae = AutoencoderKL(VAEConfig.sd_v1()).to(torch.bfloat16)

    def run():
        for shape in ((8, 3, 512, 512), (1, 3, 1024, 1024)):
            mean, _ = vae.encode(torch.empty(shape, device="meta"))
            assert tuple(mean.shape) == (shape[0], 4, shape[2] // 8,
                                         shape[3] // 8)
    attn, gn = recorded_kernel_keys(monkeypatch, run)
    assert_checked(smoke, attn, gn)
    # every new key is one the encoders run
    assert {(*c, torch.bfloat16, torch.bfloat16)
            for c in smoke.EDIT_GN_SHAPES if c[0][0] in (1, 8)} <= gn


def test_full_width_addons_run_at_checked_keys(monkeypatch):
    """The SD 1.x UNet at 512², CFG batch 16, in bf16: with an SD 1.x
    ControlNet's residuals, with an IP-Adapter's image tokens (4) at every
    cross-attention, and over a weighted context of two windows (154
    keys)."""
    from stable_diffusion_videos_tpu_torch.models.controlnet import \
        ControlNet
    from stable_diffusion_videos_tpu_torch.models.ip_adapter import \
        IPAdapter
    from stable_diffusion_videos_tpu_torch.models.unet import (
        UNet2DCondition, UNetConfig)
    smoke = chip_smoke()
    cfg = UNetConfig.sd_v1()
    with torch.device("meta"):
        unet = UNet2DCondition(cfg).to(torch.bfloat16)
        net = ControlNet(cfg).to(torch.bfloat16)
    bundle = SDModels(cfg, VAEConfig.sd_v1(), None, unet, None, None, None)
    ip_unet = IPAdapter.random(cfg).splice(bundle).unet
    meta = dict(device="meta")
    x, t = torch.empty(16, 4, 64, 64, **meta), torch.empty(16, **meta)
    ctx = torch.empty(16, 77, 768, **meta)

    def run():
        down, mid = net(x, t, ctx, torch.empty(16, 3, 512, 512, **meta))
        unet(x, t, ctx, ctrl_down=down, ctrl_mid=mid)
        ip_unet(x, t, ctx, ip_context=torch.empty(16, 4, 768, **meta))
        unet(x, t, torch.empty(16, 154, 768, **meta))
    attn, gn = recorded_kernel_keys(monkeypatch, run)
    assert_checked(smoke, attn, gn)
    # every add-on row is one these runs reach
    assert {(*s, torch.bfloat16) for s in smoke.ADDON_ATTN_SHAPES} <= attn
    assert len(smoke.ADDON_ATTN_SHAPES) == 8


@pytest.fixture
def cuda():
    """The card, with TF32 off for the test (cuDNN would otherwise run
    fp32 convolutions in TF32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels)")
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = before


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["encode", "tiled_encode", "taesd_encode",
                                  "img2img", "inpaint"])
def test_edit_paths_on_the_card_match_the_cpu(cuda, path):
    """fp32 tiny bundle: the encoders (the KL one through the kernels),
    and pndm img2img and inpaint dispatches, on the card against the CPU
    within 1e-3 (a model stacked on kernels that each hold 1e-4)."""
    x = images((2, 24, 20, 3))
    rng = np.random.default_rng(8)
    cond = rng.standard_normal((2, 7, 32), dtype=np.float32)
    uncond = rng.standard_normal((1, 7, 32), dtype=np.float32)
    field = rng.standard_normal((1, 12, 10, 4), dtype=np.float32)
    mask = np.zeros((2, 12, 10, 1), np.float32)
    mask[:, :, :5] = 1.0
    run = dict(num_inference_steps=6, guidance_scale=3.0, noise=field)
    out = []
    for dev in (CPU, cuda):
        eng = Engine(SDModels.tiny(taesd=True), dev,
                     **(dict(vae_tile=6, vae_tile_overlap=2)
                        if path == "tiled_encode" else {}))
        if path in ("encode", "tiled_encode"):
            got = eng.encode_image(x)
        elif path == "taesd_encode":
            got = eng.models.taesd.encode(torch.from_numpy(
                (x.transpose(0, 3, 1, 2) + 1) / 2).to(dev))
        else:
            lat = eng.encode_image(x)
            got = (eng.img2img(cond, uncond, lat, strength=0.6, **run)
                   if path == "img2img" else
                   eng.inpaint(cond, uncond, lat, mask, **run))
        out.append(np.asarray(got.cpu() if torch.is_tensor(got) else got))
    on_cpu, on_card = out
    assert np.isfinite(on_card).all() and on_card.std() > 0
    np.testing.assert_allclose(on_card, on_cpu, atol=1e-3, rtol=0)
