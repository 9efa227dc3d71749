"""The PyTorch package's decode options against the JAX package's: the TAESD
tiny decoder and the tiled KL decode.

TAESD: one set of random weights, handed to the JAX converter in the
upstream madebyollin layout (a parameter-free Clamp at index 0, conv_in at
1) and to the port under diffusers ``AutoencoderTiny`` names (conv_in at
``decoder.layers.0``); both decoders must agree within 1e-4, at the
published stage structure (narrow) and at the tiny geometry, and
``from_jax_params`` must give the same diffusers dict.  The engines, on the
trained ``tests/goldens/structured_lcm_bundle`` with the tiny TAESD
attached, decode the same latents within 1e-4 through ``tiny_decoder``, and
``decode_latents_tiled`` agrees within 1e-4 on a latent whose last tile
clamps back and on a non-square one with an axis below one tile.  A tiled
dispatch asked for uint8 returns the blend quantised.  The ``cuda`` cases
run the tiled and the tiny decode on the card against the CPU.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
from stable_diffusion_videos_tpu_torch.models.taesd import (AutoencoderTiny,
                                                            TAESDConfig)
from stable_diffusion_videos_tpu_torch.models.weights import (
    from_jax_params, load_state_dict, random_state_dict)
from stable_diffusion_videos_tpu_torch.runtime.engine import Engine

from torch_threads import few_torch_threads  # noqa: F401 (autouse)

BUNDLE = Path(__file__).parent / "goldens" / "structured_lcm_bundle"
CPU = torch.device("cpu")
TOL = dict(atol=1e-4, rtol=1e-4)
GEOMETRIES = {"sd_stages_narrow": TAESDConfig(width=8),
              "tiny": TAESDConfig.tiny()}


def weights(cfg: TAESDConfig, seed: int = 0):
    """(diffusers-named dict, the same arrays in the madebyollin layout),
    drawn N(0, 0.05) from a numpy seed (outputs of order 1)."""
    with torch.device("meta"):
        shapes = AutoencoderTiny(cfg)
    diffusers = random_state_dict(shapes, seed, 0.05)
    upstream = {}
    for k, v in diffusers.items():
        idx, rest = k.removeprefix("decoder.layers.").split(".", 1)
        upstream[f"{int(idx) + 1}.{rest}"] = v
    return diffusers, upstream


def port_taesd(cfg, diffusers) -> AutoencoderTiny:
    with torch.device("meta"):
        taesd = AutoencoderTiny(cfg)
    return load_state_dict(taesd, diffusers).eval()


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_taesd_decoder_matches_jax(geometry):
    import jax.numpy as jnp

    from stable_diffusion_videos_tpu.models.taesd import (
        TAESDDecoder, convert_taesd_decoder)
    cfg = GEOMETRIES[geometry]
    diffusers, upstream = weights(cfg)
    jcfg, jparams = convert_taesd_decoder(upstream)
    assert (jcfg.width, jcfg.num_stages, jcfg.blocks_per_stage) == (
        cfg.width, cfg.num_stages, cfg.blocks_per_stage)
    z = np.random.default_rng(1).standard_normal(
        (2, 4, 6, 5)).astype(np.float32) * 2
    want = np.asarray(TAESDDecoder(jcfg).apply(
        jparams, jnp.asarray(z.transpose(0, 2, 3, 1))))
    with torch.no_grad():
        got = port_taesd(cfg, diffusers).decode(torch.from_numpy(z)).numpy()
    f = cfg.scale_factor
    assert got.shape == (2, 3, 6 * f, 5 * f)
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, **TOL)
    assert got.std() > 0
    # the weight bridge maps the JAX tree to the same diffusers names
    bridged = from_jax_params(jparams, cfg)
    assert sorted(bridged) == sorted(diffusers)
    for k, v in diffusers.items():
        np.testing.assert_array_equal(bridged[k], v, err_msg=k)


def test_decode_options_are_validated():
    tiny = SDModels.tiny()
    with pytest.raises(ValueError, match="pixel factor"):
        tiny.with_taesd(TAESDConfig.sd(), weights(TAESDConfig.sd())[0])
    with pytest.raises(ValueError, match="tiny_decoder"):
        Engine(tiny, CPU, tiny_decoder=True)
    assert tiny.taesd_decoder() is None
    assert SDModels.tiny(taesd=True).taesd_decoder() is not None
    with pytest.raises(ValueError, match="vae_tile_overlap"):
        Engine(tiny, CPU, vae_tile=8, vae_tile_overlap=8)
    with pytest.raises(ValueError, match="vae_tile"):
        Engine(tiny, CPU).decode_latents_tiled(np.zeros((1, 8, 8, 4)))


@pytest.fixture(scope="module")
def structured():
    """(JAX bundle, port bundle on the same weights), the tiny TAESD of
    ``weights(TAESDConfig.tiny())`` attached to both."""
    from stable_diffusion_videos_tpu.models.bundle import SDModels as JModels
    from stable_diffusion_videos_tpu.models.taesd import convert_taesd_decoder
    from stable_diffusion_videos_tpu_torch.models.clip_text import (
        CLIPTextConfig, CLIPTextEncoder)
    from stable_diffusion_videos_tpu_torch.models.tokenizer import \
        HashTokenizer
    from stable_diffusion_videos_tpu_torch.models.unet import (
        UNet2DCondition, UNetConfig)
    from stable_diffusion_videos_tpu_torch.models.vae import (AutoencoderKL,
                                                              VAEConfig)
    from test_torch_structured import config
    meta = json.loads((BUNDLE / "bundle.json").read_text())
    cfgs = (config(UNetConfig, meta["unet_config"]),
            config(VAEConfig, meta["vae_config"]),
            config(CLIPTextConfig, meta["text_config"]))
    jm = JModels.load(str(BUNDLE))
    with torch.device("meta"):
        mods = (UNet2DCondition(cfgs[0]), AutoencoderKL(cfgs[1]),
                CLIPTextEncoder(cfgs[2]))
    for mod, part, cfg in zip(mods, ("unet", "vae", "text_encoder"), cfgs):
        load_state_dict(mod, from_jax_params(jm.params[part], cfg))
        mod.eval()
    port = SDModels(*cfgs, *mods, HashTokenizer(
        vocab_size=meta["tokenizer_vocab_size"]))
    diffusers, upstream = weights(TAESDConfig.tiny(), seed=3)
    jcfg, jparams = convert_taesd_decoder(upstream)
    return (jm.with_taesd((jcfg, {"taesd_decoder": jparams})),
            port.with_taesd(TAESDConfig.tiny(), diffusers))


def latents(shape, seed=5):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 4


def test_tiny_decoder_engine_matches_jax(structured):
    from stable_diffusion_videos_tpu.runtime.engine import Engine as JEngine
    jm, pm = structured
    lat = latents((2, 16, 16, 4))
    want = JEngine(jm, tiny_decoder=True).decode_latents(lat)
    got = Engine(pm, CPU, tiny_decoder=True).decode_latents(lat)
    assert got.shape == (2, 32, 32, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert 0.0 <= got.min() and got.max() <= 1.0 and got.std() > 0
    # the KL decoder gives other frames from the same latents
    assert np.abs(Engine(pm, CPU).decode_latents(lat) - got).max() > 0.05


@pytest.mark.parametrize("shape", [(2, 16, 16, 4), (2, 13, 6, 4)],
                         ids=["clamped_last_tile", "non_square_sub_tile"])
def test_decode_latents_tiled_matches_jax(structured, shape):
    from stable_diffusion_videos_tpu.runtime.engine import Engine as JEngine
    jm, pm = structured
    lat = latents(shape)
    tiles = dict(vae_tile=8, vae_tile_overlap=2)
    want = np.asarray(JEngine(jm, **tiles).decode_latents_tiled(lat))
    eng = Engine(pm, CPU, **tiles)
    got = eng.decode_latents_tiled(lat)
    assert got.shape == (shape[0], 2 * shape[1], 2 * shape[2], 3)
    np.testing.assert_allclose(got, want, **TOL)
    # decode_latents takes the tiled path too; the whole-frame decode
    # differs at the seams
    np.testing.assert_array_equal(eng.decode_latents(lat), got)
    assert np.abs(Engine(pm, CPU).decode_latents(lat) - got).max() > 1e-3


def test_one_tile_is_the_whole_decode(structured):
    _, pm = structured
    lat = latents((2, 8, 6, 4))
    np.testing.assert_array_equal(
        Engine(pm, CPU, vae_tile=8, vae_tile_overlap=2).decode_latents_tiled(
            lat), Engine(pm, CPU).decode_latents(lat))


def test_tiled_dispatch_quantises_after_the_blend(structured):
    """Asked for uint8, a tiled dispatch returns the blended float frames
    rounded (the JAX engine returns the float frames, and its walk rounds
    them on the host by the same rule)."""
    _, pm = structured
    eng = Engine(pm, CPU, scheduler="lcm", vae_tile=8, vae_tile_overlap=2,
                 guidance_interval=(0.0, 0.0))
    rng = np.random.default_rng(6)
    cond = rng.standard_normal((2, 77, 32), dtype=np.float32)
    noise = rng.standard_normal((2, 12, 16, 4), dtype=np.float32)
    run = dict(num_inference_steps=2, guidance_scale=1.0)
    floats = eng.denoise_frames(cond, cond[:1], noise, **run)
    u8 = eng.denoise_frames(cond, cond[:1], noise, output_dtype="uint8",
                            **run)
    assert u8.dtype == np.uint8 and u8.shape == (2, 24, 32, 3)
    np.testing.assert_array_equal(
        u8, (np.clip(floats, 0.0, 1.0) * 255).round().astype(np.uint8))


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
@pytest.mark.parametrize("kw", [dict(vae_tile=8, vae_tile_overlap=2),
                                dict(tiny_decoder=True)],
                         ids=["tiled", "tiny_decoder"])
def test_decode_on_the_card_matches_the_cpu(cuda, kw):
    """fp32 tiny bundle: the tiled KL decode (through the kernels on the
    card) and the tiny decoder (cuDNN convolutions) against the CPU, within
    1e-3 (a decoder stacked on kernels that each hold 1e-4)."""
    lat = latents((2, 20, 13, 4))
    out = {dev.type: Engine(SDModels.tiny(taesd=True), dev,
                            **kw).decode_latents(lat)
           for dev in (CPU, cuda)}
    assert out["cuda"].shape == (2, 40, 26, 3)
    assert np.isfinite(out["cuda"]).all()
    np.testing.assert_allclose(out["cuda"], out["cpu"], atol=1e-3, rtol=0)
