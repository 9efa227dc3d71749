"""The SDXL refiner on the PyTorch package against the JAX package's.

The geometry: the JAX package's ``UNetConfig.sd_xl_refiner()`` gives the
mid block transformer depth 0 (its depth tuple's last entry), while its
loader's path from the published ``unet/config.json``
(``transformer_layers_per_block`` = 4) gives 4; the port's constructor is
the published one, field by field, and its full-width UNet (2.3B
parameters, on the meta device) has the names and shapes the JAX exporter
gives the published geometry's tree.  The tiny refiner (an explicit depth
tuple given to both packages, with a transformer in the mid block under a
deepest level without attention): the bigG-only context, the 5 time ids
with the aesthetic score, and an img2img dispatch within 1e-4.  Last, the
full-width refiner UNet's kernel calls at 1024², CFG batch 2, recorded on
the meta device, are all keys that ``chip_smoke.py`` phase 3 checks.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
from stable_diffusion_videos_tpu_torch.models.unet import (UNet2DCondition,
                                                           UNetConfig)
from stable_diffusion_videos_tpu_torch.runtime.engine import Engine

from test_torch_encode import (assert_checked, chip_smoke,
                               recorded_kernel_keys)
from test_torch_sdxl import jax_models, load_port, shape_tree
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")
TOL = dict(atol=1e-4, rtol=1e-4)
#: the fields of stabilityai/stable-diffusion-xl-refiner-1.0's
#: unet/config.json that the JAX package's loader reads
PUBLISHED_REFINER_UNET = {
    "addition_embed_type": "text_time", "addition_time_embed_dim": 256,
    "attention_head_dim": [6, 12, 24, 24],
    "block_out_channels": [384, 768, 1536, 1536],
    "cross_attention_dim": 1280,
    "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D",
                         "CrossAttnDownBlock2D", "DownBlock2D"],
    "flip_sin_to_cos": True, "freq_shift": 0, "in_channels": 4,
    "layers_per_block": 2, "out_channels": 4,
    "projection_class_embeddings_input_dim": 2560, "sample_size": 128,
    "transformer_layers_per_block": 4}


def published_jax_config():
    """The JAX loader's refiner config: ``_unet_config_from_json``, then
    the pooled width and id count that ``load_sd_checkpoint`` derives from
    the bigG tower's projection (1280)."""
    from stable_diffusion_videos_tpu.models.weights import \
        _unet_config_from_json
    cfg = _unet_config_from_json(PUBLISHED_REFINER_UNET)
    return cfg.replace(addition_pooled_dim=1280, addition_num_ids=5)


def test_refiner_constructor_and_published_config_disagree_at_the_mid_block():
    from stable_diffusion_videos_tpu.models.unet import UNetConfig as JUC
    n = 4
    assert JUC.sd_xl_refiner().depth(n - 1) == 0     # the constructor
    assert published_jax_config().depth(n - 1) == 4  # the published path
    port = UNetConfig.sd_xl_refiner()
    assert port.depth(n - 1) == 4
    want = published_jax_config()
    assert dataclasses.asdict(port) == {
        f.name: getattr(want, f.name) for f in dataclasses.fields(want)}


def test_full_width_refiner_unet_matches_jax_exporter():
    from stable_diffusion_videos_tpu.models import weights as JW
    from stable_diffusion_videos_tpu.models.unet import UNet2DCondition as JU
    ju = published_jax_config()
    want = JW.export_unet(shape_tree(lambda k: JU(ju).init(
        k, jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 77, 1280)), jnp.zeros((1, 1280)),
        jnp.zeros((1, 5)))), ju)
    with torch.device("meta"):
        unet = UNet2DCondition(UNetConfig.sd_xl_refiner())
    got = {k: tuple(v.shape) for k, v in unet.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in want.items()}
    assert len(unet.mid_block.attentions[0].transformer_blocks) == 4
    assert tuple(unet.add_embedding.linear_1.weight.shape) == (1536, 2560)
    assert 2.2e9 < sum(v.numel() for v in unet.parameters()) < 2.4e9


@pytest.fixture(scope="module")
def refiner_bundles():
    """(JAX tiny refiner bundle, the port's ``tiny_refiner`` on its
    weights): the JAX refiner layout, tower 2's parameters as tower 1's."""
    port = SDModels.tiny_refiner()
    jm = jax_models(port)
    jm.params["text_encoder"] = jm.params["text_encoder_2"]
    return jm, load_port(port, jm)


def test_tiny_refiner_layout_and_conditioning(refiner_bundles):
    from stable_diffusion_videos_tpu.runtime.engine import Engine as JEngine
    jm, pm = refiner_bundles
    assert pm.text_encoder is pm.text_encoder_2
    assert pm.text_config == pm.text_config_2
    assert pm.unet_config.depth(2) == 1 and not pm.unet_config.attn_levels[2]
    eng, jeng = Engine(pm, CPU), JEngine(jm)
    ctx = eng.embed_text("a red fox")
    assert tuple(ctx.shape) == (1, 77, 16)   # tower 2's states alone
    np.testing.assert_allclose(ctx.numpy(),
                               np.asarray(jeng.embed_text("a red fox")),
                               **TOL)
    np.testing.assert_allclose(eng.embed_text_pooled("a red fox").numpy(),
                               np.asarray(jeng.embed_text_pooled(
                                   "a red fox")), **TOL)

    def pad(x):
        return torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    _, ids = eng._added_conds(pad, torch.zeros(2, 16), None, 2, 3, 8, 8)
    want = [[16, 16, 0, 0, 2.5]] * 3 + [[16, 16, 0, 0, 6.0]] * 3
    np.testing.assert_array_equal(ids.numpy(), np.float32(want))


def test_tiny_refiner_img2img_matches_jax(refiner_bundles):
    """ddim-10 at strength 0.6, CFG 3, from an image both engines encode."""
    from stable_diffusion_videos_tpu.runtime.engine import Engine as JEngine
    jm, pm = refiner_bundles
    rng = np.random.default_rng(6)
    image = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    field = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    prompts = ["a red fox", "a lighthouse"]
    run = dict(strength=0.6, num_inference_steps=10, guidance_scale=3.0)
    jeng = JEngine(jm, scheduler="ddim", batch_bucket=8)
    want = np.asarray(jeng.img2img(
        jeng.embed_text(prompts), jeng.embed_text(""),
        jeng.encode_image(jnp.asarray(image)), noise=jnp.asarray(field),
        pooled=jeng.embed_text_pooled(prompts), key=jax.random.PRNGKey(2),
        **run))
    eng = Engine(pm, CPU, scheduler="ddim", batch_bucket=8)
    got = eng.img2img(eng.embed_text(prompts), eng.embed_text(""),
                      eng.encode_image(image), noise=field,
                      pooled=eng.embed_text_pooled(prompts), **run)
    assert got.shape == want.shape == (2, 16, 16, 3) and got.std() > 0
    np.testing.assert_allclose(got, want, **TOL)


def test_full_width_refiner_runs_at_checked_keys(monkeypatch):
    """The refiner UNet at 1024² under CFG (batch 2): every GroupNorm and
    attention call is a key phase 3 checks, and each of the phase's
    refiner rows is one the UNet runs."""
    smoke = chip_smoke()
    with torch.device("meta"):
        unet = UNet2DCondition(UNetConfig.sd_xl_refiner()).to(torch.bfloat16)

    def run():
        meta = dict(device="meta")
        eps = unet(torch.empty(2, 4, 128, 128, **meta),
                   torch.empty(2, **meta), torch.empty(2, 77, 1280, **meta),
                   text_embeds=torch.empty(2, 1280, **meta),
                   time_ids=torch.empty(2, 5, **meta))
        assert tuple(eps.shape) == (2, 4, 128, 128)
    attn, gn = recorded_kernel_keys(monkeypatch, run)
    assert_checked(smoke, attn, gn)
    bf16 = torch.bfloat16
    assert {(*c, bf16, bf16) for c in smoke.EDIT_GN_SHAPES
            if c[0][0] == 2} <= gn
    assert {(*s, bf16) for s in smoke.EDIT_ATTN_SHAPES} <= attn
