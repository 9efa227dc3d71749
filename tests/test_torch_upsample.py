"""Real-ESRGAN upsampling in the PyTorch package against the JAX package's.

RRDBNet at scales 4, 2 and 1 (the input pixel-unshuffled by 2 and 4) on
the same weights (a JAX tree drawn from a numpy seed, carried over by
``from_jax_params``), 1e-4; ``load_realesrgan`` on basicsr-named ``.pth``
files under ``params_ema`` and ``params`` and on a ``.safetensors`` file:
the same geometry as the JAX loader infers and the same outputs;
``RealESRGANModel._run`` tiled against the JAX model's tiled ``_run``;
PIL in and out, and ``upsample_imagefolder``.
"""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from stable_diffusion_videos_tpu_torch.models.rrdbnet import (RRDBNet,
                                                              RRDBNetConfig)
from stable_diffusion_videos_tpu_torch.models.weights import (
    from_jax_params, load_realesrgan, load_state_dict, random_state_dict)
from stable_diffusion_videos_tpu_torch.pipeline.upsampling import \
    RealESRGANModel

from torch_threads import few_torch_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")
TOL = dict(atol=1e-4, rtol=1e-4)


def jax_rrdbnet(scale: int, seed: int = 0, std: float = 0.05):
    """(JAX config, params): the tiny geometry at ``scale``, every weight
    N(0, std) from a numpy seed, conv_last's bias 0.5 so the output sits
    inside [0, 1] rather than at the clip."""
    from stable_diffusion_videos_tpu.models import rrdbnet as J
    cfg = J.RRDBNetConfig(num_feat=16, num_block=2, num_grow_ch=8,
                          scale=scale)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda s: rng.standard_normal(s.shape, dtype=np.float32) * std,
        jax.eval_shape(lambda k: J.RRDBNet(cfg).init(
            k, jnp.zeros((1, 8, 8, 3))), jax.random.PRNGKey(0)))
    params["params"]["conv_last"]["bias"] += 0.5
    return cfg, params


def port_config(jcfg) -> RRDBNetConfig:
    return RRDBNetConfig(**dataclasses.asdict(jcfg))


def port_net(jcfg, params) -> RRDBNet:
    cfg = port_config(jcfg)
    with torch.device("meta"):
        net = RRDBNet(cfg)
    return load_state_dict(net, from_jax_params(params, cfg)).eval()


def frames(shape, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.mark.parametrize("scale", [4, 2, 1])
def test_rrdbnet_matches_jax(scale):
    from stable_diffusion_videos_tpu.models.rrdbnet import RRDBNet as JNet
    jcfg, params = jax_rrdbnet(scale)
    x = frames((2, 8, 12, 3))
    want = np.asarray(JNet(jcfg).apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port_net(jcfg, params)(torch.from_numpy(
            x.transpose(0, 3, 1, 2))).numpy().transpose(0, 2, 3, 1)
    assert got.shape == (2, 8 * scale, 12 * scale, 3) == want.shape
    inside = (got > 0) & (got < 1)
    assert inside.mean() > 0.5 and got[inside].std() > 1e-3
    np.testing.assert_allclose(got, want, **TOL)


def basicsr_state(params, jcfg) -> dict:
    """The JAX tree as a basicsr-named torch state dict."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            from_jax_params(params, port_config(jcfg)).items()}


@pytest.mark.parametrize("fmt", ["params_ema", "params", "safetensors"])
def test_load_realesrgan_matches_jax(fmt, tmp_path):
    """An x2-shaped net (conv_first reads 12 channels): the geometry both
    loaders infer and the net each loads, on the same file."""
    from stable_diffusion_videos_tpu.models.rrdbnet import RRDBNet as JNet
    from stable_diffusion_videos_tpu.models.weights import \
        load_realesrgan as jload
    jcfg, params = jax_rrdbnet(2, seed=3)
    sd = basicsr_state(params, jcfg)
    if fmt == "safetensors":
        from safetensors.torch import save_file
        path = tmp_path / "net.safetensors"
        save_file(sd, str(path))
    else:
        path = tmp_path / "net.pth"
        torch.save({fmt: sd}, path)
    cfg, loaded = load_realesrgan(path)
    want_cfg, want_params = jload(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want_cfg)
    assert cfg.scale == 2 and cfg.in_channels == 3
    model = RealESRGANModel(cfg, loaded, CPU)
    x = frames((1, 6, 10, 3), seed=4)
    want = np.asarray(JNet(want_cfg).apply(want_params, jnp.asarray(x)))
    np.testing.assert_allclose(model(x), want, **TOL)


def test_tiled_run_matches_jax():
    """Tiles of 8 with 2 pixels of context on a 20 x 28 frame (partial
    tiles at both far edges)."""
    from stable_diffusion_videos_tpu.pipeline.upsampling import \
        RealESRGANModel as JModel
    jcfg, params = jax_rrdbnet(4, seed=5)
    x = frames((2, 20, 28, 3), seed=6)
    want = JModel(jcfg, params, tile=8, tile_pad=2)._run(x)
    port = RealESRGANModel(port_config(jcfg), basicsr_state(params, jcfg),
                           CPU, tile=8, tile_pad=2)
    got = port._run(torch.from_numpy(x))
    assert got.shape == (2, 80, 112, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    whole = RealESRGANModel(port.config, basicsr_state(params, jcfg), CPU)
    assert np.abs(whole._run(torch.from_numpy(x)).numpy() - want).max() > 1e-3


def test_pil_and_imagefolder(tmp_path):
    from stable_diffusion_videos_tpu.pipeline.upsampling import \
        RealESRGANModel as JModel
    jcfg, params = jax_rrdbnet(4, seed=7)
    port = RealESRGANModel(port_config(jcfg), basicsr_state(params, jcfg),
                           CPU)
    jmodel = JModel(jcfg, params)
    src = tmp_path / "in"
    src.mkdir()
    img = Image.fromarray((frames((12, 16, 3), seed=8) * 255).astype(np.uint8))
    img.save(src / "a.png")
    img.convert("L").save(src / "b.jpg")
    (src / "notes.txt").write_text("not an image")
    out = port(img)
    assert isinstance(out, Image.Image) and out.size == (64, 48)
    assert np.abs(np.asarray(out, np.int32)
                  - np.asarray(jmodel(img), np.int32)).max() <= 1
    port.upsample_imagefolder(src, tmp_path / "port")
    jmodel.upsample_imagefolder(src, tmp_path / "jax")
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir()) \
        == ["a_out.png", "b_out.jpg"]
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "port" / "a_out.png")),
        np.asarray(out))
    assert Image.open(tmp_path / "port" / "b_out.jpg").size == (64, 48)
    arr = port(frames((1, 4, 4, 3)))
    assert isinstance(arr, np.ndarray) and arr.dtype == np.float32
    assert arr.shape == (1, 16, 16, 3)


def test_tiny_and_missing_weights():
    """A tensor on another device than the model's raises rather than
    being copied there."""
    model = RealESRGANModel.tiny(CPU, seed=1)
    out = model(torch.rand(1, 5, 7, 3))
    assert out.shape == (1, 20, 28, 3) and out.dtype == torch.float32
    with pytest.raises(ValueError, match="upsampler on cpu"):
        model(torch.rand(1, 5, 7, 3, device="meta"))
    with pytest.raises(FileNotFoundError, match="RealESRGAN weights"):
        RealESRGANModel.from_pretrained(None, CPU)


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
def test_upsampler_on_the_card(cuda):
    """Whole and tiled, fp32 on the card against the CPU (1e-4); bf16
    finite, in [0, 1] and within 0.05 of the untiled fp32 output at every
    pixel (an 8-bit mantissa through 32 convolutions of this random net).
    The bf16 net runs untiled, so it is held against the untiled fp32
    output: the tiled one differs from it by the 2-pixel pad's missing
    context, which is not a bf16 error (port-drawn weights: the card's
    machine has no flax)."""
    cfg = RRDBNetConfig.tiny()
    with torch.device("meta"):
        shapes = RRDBNet(cfg)
    sd = {k: torch.from_numpy(v) for k, v in
          random_state_dict(shapes, 9, 0.1).items()}
    sd["conv_last.bias"] += 0.5
    x = torch.from_numpy(frames((2, 20, 28, 3), seed=10))
    wants = {}
    for tile in (0, 8):
        wants[tile] = RealESRGANModel(cfg, sd, CPU, tile=tile, tile_pad=2)(x)
        got = RealESRGANModel(cfg, sd, cuda, tile=tile, tile_pad=2)(
            x.to(cuda))
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), wants[tile], **TOL)
    half = RealESRGANModel(cfg, sd, cuda, dtype=torch.bfloat16)(
        x.to(cuda)).cpu()
    assert half.dtype == torch.float32 and torch.isfinite(half).all()
    assert 0.0 <= half.min().item() and half.max().item() <= 1.0
    assert (half - wants[0]).abs().max().item() < 0.05
