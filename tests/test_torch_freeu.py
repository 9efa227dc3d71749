"""FreeU in the PyTorch package against the JAX package's.

``fourier_lowpass_scale`` (NCHW, FFT over the last two axes) against the
JAX filter (NHWC, axes 1 and 2) at even and odd sizes, fp32 1e-5; the tiny
UNet with FreeU on the JAX tiny bundle's weights, 1e-4, with the change
FreeU makes held to JAX's; neutral factors leave the UNet as it was; and
``with_freeu(True)`` picks each family's published factors, as the JAX
bundle does.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
from stable_diffusion_videos_tpu_torch.models.unet import (
    UNet2DCondition, UNetConfig, fourier_lowpass_scale)

from test_torch_sampler_engines import ENGINE_TOL, tiny_bundles
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

OPS_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def bundles():
    return tiny_bundles()


@pytest.mark.parametrize("shape,threshold,scale", [
    ((2, 5, 8, 8), 1, 0.2), ((2, 5, 8, 8), 2, 0.9), ((1, 3, 7, 9), 1, 0.5),
    ((2, 4, 16, 16), 1, 1.4), ((1, 2, 1, 1), 1, 0.2)])
def test_filter_matches_jax(shape, threshold, scale):
    from stable_diffusion_videos_tpu.models.unet import \
        fourier_lowpass_scale as jfilter
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    got = fourier_lowpass_scale(torch.from_numpy(x), threshold, scale)
    want = jfilter(jnp.asarray(x.transpose(0, 2, 3, 1)), threshold, scale)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(
        0, 3, 1, 2), **OPS_TOL)


def test_filter_keeps_the_input_dtype():
    x = torch.randn(2, 4, 8, 8).to(torch.bfloat16)
    out = fourier_lowpass_scale(x, 1, 0.9)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, fourier_lowpass_scale(
        x.float(), 1, 0.9).to(torch.bfloat16))


def unet_inputs():
    rng = np.random.default_rng(5)
    return (rng.standard_normal((2, 8, 8, 4), dtype=np.float32),
            np.asarray([5.0, 900.0], np.float32),
            rng.standard_normal((2, 7, 32), dtype=np.float32))


def port_unet(unet, lat, t, ctx) -> np.ndarray:
    with torch.no_grad():
        out = unet(torch.from_numpy(lat.transpose(0, 3, 1, 2)),
                   torch.from_numpy(t), torch.from_numpy(ctx))
    return out.numpy().transpose(0, 2, 3, 1)


def test_unet_with_freeu_matches_jax(bundles):
    from stable_diffusion_videos_tpu.models.unet import \
        UNet2DCondition as JUNet
    jm, pm = bundles
    lat, t, ctx = unet_inputs()
    factors = (1.5, 1.6, 0.9, 0.2)
    out = {}
    for freeu in (factors, None):
        want = JUNet(jm.unet_config, freeu=freeu).apply(
            jm.params["unet"], jnp.asarray(lat), jnp.asarray(t),
            jnp.asarray(ctx))
        got = port_unet((pm.with_freeu(freeu) if freeu else pm).unet, lat,
                        t, ctx)
        out[freeu] = (got, np.asarray(want))
        np.testing.assert_allclose(*out[freeu], **ENGINE_TOL)
    (got, want), (got0, want0) = out[factors], out[None]
    assert np.abs(got - got0).max() > 1e-2
    np.testing.assert_allclose(got - got0, want - want0, atol=1e-5)


def test_neutral_factors_change_nothing(bundles):
    _, pm = bundles
    lat, t, ctx = unet_inputs()
    np.testing.assert_allclose(
        port_unet(pm.with_freeu((1, 1, 1, 1)).unet, lat, t, ctx),
        port_unet(pm.unet, lat, t, ctx), **OPS_TOL)


def test_family_defaults_match_jax(bundles):
    """SD 1.x (768-wide context), SD 2.x (1024) and SDXL (text_time): the
    published factors, as the JAX bundle picks them; the copy shares the
    weights, the plain bundle keeps FreeU off, and a bad tuple raises."""
    from stable_diffusion_videos_tpu.models import bundle as J
    _, pm = bundles
    for ucfg, want in ((UNetConfig.tiny(), (1.5, 1.6, 0.9, 0.2)),
                       (dataclasses.replace(UNetConfig.tiny(),
                                            cross_attention_dim=1024),
                        (1.4, 1.6, 0.9, 0.2)),
                       (UNetConfig.tiny_xl(), (1.3, 1.4, 0.9, 0.2))):
        with torch.device("meta"):
            unet = UNet2DCondition(ucfg)
        models = dataclasses.replace(pm, unet_config=ucfg, unet=unet)
        jucfg = J.UNetConfig(**dataclasses.asdict(ucfg))
        jmodels = J.SDModels(jucfg, J.VAEConfig.tiny(),
                             J.CLIPTextConfig.tiny(), {}, None)
        assert models.with_freeu(True).unet.freeu == want
        assert jmodels.with_freeu(True).freeu == want
    f = pm.with_freeu((1.2, 1.3, 0.8, 0.5))
    assert f.unet.freeu == (1.2, 1.3, 0.8, 0.5) and pm.unet.freeu is None
    assert f.unet.conv_in.weight is pm.unet.conv_in.weight
    assert pm.with_freeu(None).unet.freeu is None
    with pytest.raises(ValueError, match="b1, b2, s1, s2"):
        pm.with_freeu((1.0, 1.0, 1.0))


@pytest.fixture
def cuda():
    """The card, with TF32 off for the test (cuDNN and cuBLAS would
    otherwise run fp32 convolutions and matmuls in TF32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = before


@pytest.mark.cuda
def test_freeu_on_the_card(cuda):
    """The filter fp32 1e-5 and a FreeU UNet (the port's tiny bundle: the
    card's machine has no flax) 1e-4, the card against the CPU."""
    x = torch.randn(2, 64, 8, 8)
    torch.testing.assert_close(
        fourier_lowpass_scale(x.to(cuda), 1, 0.2).cpu(),
        fourier_lowpass_scale(x, 1, 0.2), **OPS_TOL)
    unet = SDModels.tiny().with_freeu(True).unet
    lat, t, ctx = (torch.from_numpy(a) for a in unet_inputs())
    args = [lat.permute(0, 3, 1, 2), t, ctx]
    with torch.no_grad():
        want = unet(*args)
        got = unet.to(cuda)(*(a.to(cuda) for a in args)).cpu()
    torch.testing.assert_close(got, want, **ENGINE_TOL)
