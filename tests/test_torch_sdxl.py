"""SDXL-base on the PyTorch package against the JAX package, on the CPU.

The CLIP tower with exact GELU, the penultimate output, the pooled output
and its projection (fp32, 1e-5); the tiny SDXL-shaped UNet with text_time,
whole and split by DeepCache (1e-4); the engine's two-tower embedding
(1e-4); the published configs field by field; the full-width SDXL UNet's
and bigG tower's state-dict names and shapes against the JAX exporters,
with no compute; both layouts diffusers writes for the transformers'
``proj_in``/``proj_out``.  ``tests/test_torch_sdxl_engines.py`` holds the
dispatches and the walk, with the helpers defined here.

Both packages run the same weights: random numpy values filled into the JAX
parameter trees (their shapes from ``jax.eval_shape``, so no initialiser
runs), carried into the port by ``from_jax_params``.  The ``cuda`` cases
(the D=64 attention kernel, one SDXL-width transformer on the card) skip
without a card.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
from stable_diffusion_videos_tpu_torch.models.clip_text import (
    CLIPTextConfig, CLIPTextEncoder)
from stable_diffusion_videos_tpu_torch.models.unet import (UNet2DCondition,
                                                           UNetConfig)
from stable_diffusion_videos_tpu_torch.models.weights import (
    from_jax_params, load_state_dict, random_state_dict)
from stable_diffusion_videos_tpu_torch.pipeline import \
    StableDiffusionWalkPipeline
from stable_diffusion_videos_tpu_torch.runtime.engine import Engine

from torch_threads import few_torch_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")
CLIP_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)


def jax_config(cls, port_config):
    """The JAX package's config class filled with the port config's
    fields."""
    return cls(**dataclasses.asdict(port_config))


def filled(init, rng, std):
    """A parameter tree of ``init``'s shapes drawn N(0, std) from ``rng``."""
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape, dtype=np.float32) * std,
        jax.eval_shape(init, jax.random.PRNGKey(0)))


def jax_models(port: SDModels, seed: int = 0, std: float = 0.1):
    """The JAX package's bundle of ``port``'s geometry, every parameter
    drawn from a numpy seed, with the port's tokenizers' padding."""
    from stable_diffusion_videos_tpu.core.schedulers import SchedulerConfig
    from stable_diffusion_videos_tpu.models import bundle as B
    ucfg = jax_config(B.UNetConfig, port.unet_config)
    vcfg = jax_config(B.VAEConfig, port.vae_config)
    tcfg = jax_config(B.CLIPTextConfig, port.text_config)
    lat = jnp.zeros((1, ucfg.sample_size, ucfg.sample_size, 4))
    ctx = jnp.zeros((1, 7, ucfg.cross_attention_dim))
    xl = (() if ucfg.addition_embed_dim is None else
          (jnp.zeros((1, ucfg.addition_pooled_dim)),
           jnp.zeros((1, ucfg.addition_num_ids))))
    img = ucfg.sample_size * vcfg.scale_factor
    ids = jnp.zeros((1, 77), jnp.int32)
    inits = {
        "unet": lambda k: B.UNet2DCondition(ucfg).init(
            k, lat, jnp.zeros((1,)), ctx, *xl),
        "vae": lambda k: B.AutoencoderKL(vcfg).init(
            k, jnp.zeros((1, img, img, 3))),
        "text_encoder": lambda k: B.CLIPTextEncoder(tcfg).init(k, ids),
    }
    tcfg2, tok2 = None, None
    if port.text_config_2 is not None:
        tcfg2 = jax_config(B.CLIPTextConfig, port.text_config_2)
        inits["text_encoder_2"] = lambda k: B.CLIPTextEncoder(tcfg2).init(
            k, ids)
        tok2 = B.HashTokenizer(vocab_size=tcfg2.vocab_size)
        tok2.pad_token_id = port.tokenizer_2.pad_token_id
    rng = np.random.default_rng(seed)
    params = {part: filled(init, rng, std) for part, init in inits.items()}
    sched = SchedulerConfig(**dataclasses.asdict(port.scheduler_config))
    return B.SDModels(ucfg, vcfg, tcfg, params,
                      B.HashTokenizer(vocab_size=tcfg.vocab_size), sched,
                      dtype=jnp.float32, text_config_2=tcfg2,
                      tokenizer_2=tok2)


def load_port(port: SDModels, jm) -> SDModels:
    """``port`` with every module filled from the JAX bundle's params."""
    parts = [(port.unet, "unet", port.unet_config),
             (port.vae, "vae", port.vae_config),
             (port.text_encoder, "text_encoder", port.text_config)]
    if port.text_encoder_2 is not None:
        parts.append((port.text_encoder_2, "text_encoder_2",
                      port.text_config_2))
    for module, part, cfg in parts:
        load_state_dict(module, from_jax_params(jm.params[part], cfg))
    return port


@pytest.fixture(scope="module")
def xl_bundles():
    """(JAX tiny SDXL bundle, the port's ``tiny_xl`` on its weights)."""
    port = SDModels.tiny_xl()
    jm = jax_models(port)
    return jm, load_port(port, jm)


# ---------------------------------------------------------------------------
# CLIP towers
# ---------------------------------------------------------------------------

TOWERS = {
    # bigG-shaped: exact GELU, penultimate sequence output, projection
    "bigG": CLIPTextConfig(vocab_size=1000, hidden_size=32,
                           intermediate_size=64, num_layers=3, num_heads=2,
                           hidden_act="gelu", penultimate_hidden=True,
                           projection_dim=24),
    # OpenCLIP-H-shaped (SD 2.x): exact GELU, last layer after the LN
    "H": CLIPTextConfig.tiny_v2(),
    # a pinned EOS id: the pooled row is its first occurrence
    "eos_id": CLIPTextConfig(vocab_size=1000, hidden_size=32,
                             intermediate_size=64, num_layers=2, num_heads=2,
                             projection_dim=8, eos_token_id=500),
}


@pytest.mark.parametrize("tower", sorted(TOWERS))
def test_clip_tower_matches_jax(tower):
    from stable_diffusion_videos_tpu.models.clip_text import \
        CLIPTextConfig as JConfig
    from stable_diffusion_videos_tpu.models.clip_text import \
        CLIPTextEncoder as JCLIP
    cfg = TOWERS[tower]
    jcfg = jax_config(JConfig, cfg)
    params = filled(lambda k: JCLIP(jcfg).init(
        k, jnp.zeros((1, 77), jnp.int32)), np.random.default_rng(2), 0.1)
    # BOS 998; EOS 999, the highest id (CLIP's argmax rule), or the pinned
    # id, below BOS (argmax would pick the BOS row)
    eos = cfg.eos_token_id or 999
    ids = np.random.default_rng(6).integers(0, 490, (3, 77)).astype(np.int32)
    ids[:, 0] = 998
    ids[0, 5:] = eos  # EOS at 5, then padding with it
    ids[1, 40:] = 0  # EOS at 40, then OpenCLIP's padding
    ids[1, 40] = eos
    ids[2, 76] = eos
    want_h, want_p = (np.asarray(a) for a in JCLIP(jcfg).apply(params, ids))
    enc = load_state_dict(CLIPTextEncoder(cfg), from_jax_params(params, cfg))
    with torch.no_grad():
        got_h, got_p = enc(torch.from_numpy(ids).long())
    assert got_p.shape == (3, cfg.projection_dim or cfg.hidden_size)
    np.testing.assert_allclose(got_h.numpy(), want_h, **CLIP_TOL)
    np.testing.assert_allclose(got_p.numpy(), want_p, **CLIP_TOL)


# ---------------------------------------------------------------------------
# the UNet with text_time
# ---------------------------------------------------------------------------

def unet_inputs(cfg, b: int = 2, seed: int = 4):
    rng = np.random.default_rng(seed)
    s = cfg.sample_size
    return dict(
        sample=rng.standard_normal((b, s, s, 4), dtype=np.float32),
        t=np.array([981.0, 301.0][:b], np.float32),
        ctx=rng.standard_normal((b, 7, cfg.cross_attention_dim),
                                dtype=np.float32),
        pooled=rng.standard_normal((b, cfg.addition_pooled_dim),
                                   dtype=np.float32),
        ids=np.tile(np.array([64, 64, 0, 0, 64, 64], np.float32), (b, 1)))


def test_tiny_xl_unet_matches_jax(xl_bundles):
    """The full pass, and the DeepCache split at 1: the full pass's deep
    feature and the shallow pass fed it, against JAX's."""
    from stable_diffusion_videos_tpu.models.unet import UNet2DCondition as JU
    jm, pm = xl_bundles
    x = unet_inputs(pm.unet_config)
    jargs = (jnp.asarray(x["sample"]), jnp.asarray(x["t"]),
             jnp.asarray(x["ctx"]), jnp.asarray(x["pooled"]),
             jnp.asarray(x["ids"]))
    ju = JU(jm.unet_config)
    want = np.asarray(ju.apply(jm.params["unet"], *jargs))
    want_eps, want_deep = ju.apply(jm.params["unet"], *jargs, cache_split=1)
    want_shallow, _ = ju.apply(jm.params["unet"], *jargs, cache_split=1,
                               deep_feature=want_deep)
    nchw = torch.from_numpy(x["sample"].transpose(0, 3, 1, 2))
    args = (nchw, torch.from_numpy(x["t"]), torch.from_numpy(x["ctx"]))
    kw = dict(text_embeds=torch.from_numpy(x["pooled"]),
              time_ids=torch.from_numpy(x["ids"]))
    with torch.no_grad():
        got = pm.unet(*args, **kw)
        eps, deep = pm.unet(*args, cache_split=1, **kw)
        shallow, _ = pm.unet(*args, cache_split=1, deep_feature=deep, **kw)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, **TOL)
    np.testing.assert_allclose(eps.numpy(), got.numpy(), **TOL)
    np.testing.assert_allclose(deep.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want_deep), **TOL)
    np.testing.assert_allclose(shallow.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want_shallow), **TOL)
    # the conditioning is read: other time ids move the output
    with torch.no_grad():
        moved = pm.unet(*args, text_embeds=kw["text_embeds"],
                        time_ids=kw["time_ids"] * 2)
    assert (moved - got).abs().max() > 1e-3


def test_xl_unet_requires_text_time(xl_bundles):
    _, pm = xl_bundles
    with pytest.raises(ValueError, match="text_embeds and time_ids"):
        pm.unet(torch.zeros(1, 4, 8, 8), torch.zeros(1),
                torch.zeros(1, 7, 32))
    with pytest.raises(ValueError, match=r"cache_split must be in \[1, 1\]"):
        pm.unet(torch.zeros(1, 4, 8, 8), torch.zeros(1),
                torch.zeros(1, 7, 32), cache_split=2,
                text_embeds=torch.zeros(1, 16), time_ids=torch.zeros(1, 6))


# ---------------------------------------------------------------------------
# engines and the walk
# ---------------------------------------------------------------------------

def xl_engine_inputs():
    rng = np.random.default_rng(3)
    return dict(
        cond=rng.standard_normal((2, 77, 32), dtype=np.float32),
        uncond=rng.standard_normal((1, 77, 32), dtype=np.float32),
        noise=rng.standard_normal((2, 8, 8, 4), dtype=np.float32),
        pooled=rng.standard_normal((2, 16), dtype=np.float32))


def test_xl_engine_embeds_both_towers(xl_bundles):
    """The context is the two towers' penultimate states side by side (16 +
    16), the pooled output tower 2's projection, both as the JAX engine's;
    a dispatch without pooled raises, and a non-SDXL bundle refuses it."""
    from stable_diffusion_videos_tpu.runtime.engine import Engine as JEngine
    jm, pm = xl_bundles
    eng, jeng = Engine(pm, CPU), JEngine(jm)
    prompts = ["a red fox", "a lighthouse at dusk"]
    got = eng.embed_text(prompts)
    assert got.shape == (2, 77, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jeng.embed_text(prompts)), **TOL)
    np.testing.assert_allclose(eng.embed_text_pooled(prompts).numpy(),
                               np.asarray(jeng.embed_text_pooled(prompts)),
                               **TOL)
    x = xl_engine_inputs()
    with pytest.raises(ValueError, match="pooled="):
        eng.denoise_frames(x["cond"], x["uncond"], x["noise"],
                           num_inference_steps=2)
    sd1 = Engine(SDModels.tiny(), CPU)
    with pytest.raises(ValueError, match="no text_time"):
        sd1.denoise_frames(x["cond"], x["uncond"], x["noise"],
                           pooled=x["pooled"], num_inference_steps=2)
    with pytest.raises(ValueError, match="SDXL bundle"):
        sd1.embed_text_pooled("a")


def test_refiner_ids_are_refused(xl_bundles):
    """text_time takes SDXL-base's 6 ids or the refiner's 5 (served since
    the edit paths came); any other count is refused."""
    _, pm = xl_bundles
    for ids in (5, 6):
        Engine(dataclasses.replace(pm, unet_config=dataclasses.replace(
            pm.unet_config, addition_num_ids=ids)), CPU)
    other = dataclasses.replace(pm, unet_config=dataclasses.replace(
        pm.unet_config, addition_num_ids=4))
    with pytest.raises(ValueError, match="refiner"):
        Engine(other, CPU)


def test_xl_presets():
    """``fast`` on SDXL is step_cache=2 with CFG everywhere; the default
    walk batch is the family's (1 at 1024²), not the SD 1.x preset's 16."""
    pipe = StableDiffusionWalkPipeline.tiny_xl(CPU, fast=True)
    assert (pipe.engine.step_cache, pipe.engine.guidance_interval) == (2,
                                                                       None)
    sd1 = StableDiffusionWalkPipeline.tiny(CPU, fast=True)
    assert (sd1.engine.step_cache, sd1.engine.guidance_interval) == (
        3, (0.1, 0.85))
    big = dataclasses.replace(pipe.models, unet_config=dataclasses.replace(
        pipe.models.unet_config, sample_size=512))
    assert big.default_size == 1024 and big.default_batch_size == 1
    assert pipe.models.default_batch_size == 8
    assert pipe.models.tokenizer_2("a")["input_ids"][0, -1] == 0


# ---------------------------------------------------------------------------
# the published geometry, without compute
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "UNetConfig.sd_xl", "UNetConfig.tiny_xl", "CLIPTextConfig.sd_xl_g",
    "CLIPTextConfig.sd_xl_l"])
def test_configs_match_jax(name):
    from stable_diffusion_videos_tpu.models import bundle as B
    cls_name, ctor = name.split(".")
    port = getattr({"UNetConfig": UNetConfig,
                    "CLIPTextConfig": CLIPTextConfig}[cls_name], ctor)()
    want = getattr(getattr(B, cls_name), ctor)()
    assert dataclasses.asdict(port) == {
        f.name: getattr(want, f.name) for f in dataclasses.fields(want)}


def shape_tree(init):
    """Zero-stride arrays of ``init``'s parameter shapes: the JAX exporters
    read shapes through them and no memory is spent."""
    return jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape),
        jax.eval_shape(init, jax.random.PRNGKey(0)))


def test_full_width_sdxl_state_dicts_match_jax_exporters():
    """SDXL-base's UNet (2.6B parameters) and the bigG tower, built on the
    meta device, have the names and shapes the JAX package's exporters give
    its trees: a wrong head count, depth or add_embedding width at the
    published geometry would show here."""
    from stable_diffusion_videos_tpu.models import weights as JW
    from stable_diffusion_videos_tpu.models.clip_text import (
        CLIPTextConfig as JC, CLIPTextEncoder as JCLIP)
    from stable_diffusion_videos_tpu.models.unet import (
        UNet2DCondition as JU, UNetConfig as JUC)
    ju, jt = JUC.sd_xl(), JC.sd_xl_g()
    want_unet = JW.export_unet(shape_tree(lambda k: JU(ju).init(
        k, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 77, 2048)), jnp.zeros((1, 1280)),
        jnp.zeros((1, 6)))), ju)
    want_text = JW.export_text_encoder(shape_tree(lambda k: JCLIP(jt).init(
        k, jnp.zeros((1, 77), jnp.int32))), jt)
    with torch.device("meta"):
        unet = UNet2DCondition(UNetConfig.sd_xl())
        text = CLIPTextEncoder(CLIPTextConfig.sd_xl_g())
    for module, want in ((unet, want_unet), (text, want_text)):
        got = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        assert got == {k: tuple(v.shape) for k, v in want.items()}
    assert got["text_projection.weight"] == (1280, 1280)
    assert tuple(unet.add_embedding.linear_1.weight.shape) == (1280, 2816)
    assert len(unet.mid_block.attentions[0].transformer_blocks) == 10


# ---------------------------------------------------------------------------
# loading diffusers' two projection layouts
# ---------------------------------------------------------------------------

def test_load_state_dict_takes_both_projection_layouts():
    """diffusers stores SD 2.x's and SDXL's transformer ``proj_in`` and
    ``proj_out`` as Linear weights (C, C), SD 1.x's as 1x1 convolutions
    (C, C, 1, 1): both load, to the same module and the same output.  Any
    other 2-D weight for a 4-D parameter still raises."""
    cfg = UNetConfig.tiny_xl()
    with torch.device("meta"):
        shapes = UNet2DCondition(cfg)
    conv = random_state_dict(shapes, 3, 0.1)
    proj = [k for k in conv if k.endswith((".proj_in.weight",
                                           ".proj_out.weight"))]
    assert len(proj) == 8  # 1 down, 2 up, 1 mid transformer x (in, out)
    linear = {k: (v[:, :, 0, 0] if k in proj else v) for k, v in conv.items()}
    assert all(linear[k].ndim == 2 for k in proj)
    a = load_state_dict(UNet2DCondition(cfg), conv)
    b = load_state_dict(UNet2DCondition(cfg), linear)
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    x = unet_inputs(cfg, b=1)
    args = (torch.from_numpy(x["sample"].transpose(0, 3, 1, 2)),
            torch.from_numpy(x["t"]), torch.from_numpy(x["ctx"]))
    kw = dict(text_embeds=torch.from_numpy(x["pooled"]),
              time_ids=torch.from_numpy(x["ids"]))
    with torch.no_grad():
        assert torch.equal(a(*args, **kw), b(*args, **kw))
    bad = dict(conv, **{"conv_in.weight": conv["conv_in.weight"][:, :, 0, 0]})
    with pytest.raises(ValueError, match="conv_in.weight"):
        load_state_dict(UNet2DCondition(cfg), bad)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h", [
    (2, 1024, 1024, 20), (2, 4096, 77, 10), (1, 300, 500, 5),
    (2, 144, 77, 20)])
def test_d64_attention_kernel_matches_plain(cuda, b, sq, sk, h):
    """bf16 attention at SD 2.x's and SDXL's head size runs the depth-64
    instantiation and agrees with the plain version (bf16 2e-2, and within
    1e-2 relative to the output's own size)."""
    from stable_diffusion_videos_tpu_torch.ops import build
    from stable_diffusion_videos_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    assert build.library().sdv_flash_attention_depth(64) == 64
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(b, sq, h, 64, device=cuda, generator=g).bfloat16()
    k = torch.randn(b, sk, h, 64, device=cuda, generator=g).bfloat16()
    v = torch.randn(b, sk, h, 64, device=cuda, generator=g).bfloat16()
    got = flash_attention(q, k, v).float()
    want = flash_attention_reference(q, k, v).float()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
    assert ((got - want).norm() / want.norm()).item() < 1e-2


@pytest.mark.cuda
def test_sdxl_width_transformer_on_the_card_matches_the_cpu(cuda):
    """One of SDXL's level-2 spatial transformers (1280 channels, 20 heads
    of 64, depth 10, context 2048) at 32² in fp32 with TF32 off: the card's
    kernels against the CPU's plain versions."""
    from stable_diffusion_videos_tpu_torch.models.layers import \
        SpatialTransformer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device("meta"):
        blk = SpatialTransformer(1280, 2048, 20, depth=10)
    blk = load_state_dict(blk, random_state_dict(blk, 8, 0.02),
                          torch.float32).eval()
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 1280, 32, 32, generator=g)
    ctx = torch.randn(2, 77, 2048, generator=g)
    with torch.no_grad():
        want = blk(x, ctx)
        got = blk.to(cuda)(x.to(cuda), ctx.to(cuda)).cpu()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
