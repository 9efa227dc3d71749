"""IP-Adapter and its CLIP image tower on the PyTorch package against the
JAX package, on the CPU.

The CLIP preprocessing's resize (the port's antialiased bicubic against
``jax.image.resize(..., "cubic")``, a downscale 512→224, an upscale 100→224
and non-square shortest-side crops: normalised pixels within 1e-4); the
image tower under quick_gelu (fp32, 1e-5) and its exact-GELU variant, which
must differ; the projection and the uncond tokens (1e-5); ``attn2_scopes``
for SD 1.x and tiny_xl, name by name; ``load_ip_adapter`` on one ``.bin``
(and one ``.safetensors``) with one image-encoder directory handed to both
packages (1e-5); engine, img2img and inpaint dispatches with image tokens
(1e-4); a walk with ``ip_image`` (frames within 2/255); ``ip_scale=0`` and
an adapter with no image equal to no adapter, exactly.

The JAX adapter's trees are filled from a numpy seed (shapes from
``jax.eval_shape``) and carried across by ``IPAdapter.from_jax_params``;
the base bundles are ``tests/test_torch_sdxl.py``'s.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
from stable_diffusion_videos_tpu_torch.models.ip_adapter import (
    IPAdapter, attn2_scopes, jax_vision_state_dict, load_ip_adapter,
    preprocess_clip_image)
from stable_diffusion_videos_tpu_torch.models.safety import (
    CLIPVisionConfig, CLIPVisionEncoder)
from stable_diffusion_videos_tpu_torch.models.unet import (UNet2DCondition,
                                                           UNetConfig)
from stable_diffusion_videos_tpu_torch.models.weights import load_state_dict
from stable_diffusion_videos_tpu_torch.pipeline import \
    StableDiffusionWalkPipeline
from stable_diffusion_videos_tpu_torch.runtime.engine import Engine

from test_torch_sdxl import CPU, TOL, filled, jax_models, load_port
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

#: the CLIP-normalised pixels: both resizes are Keys cubic (a = -0.5) with
#: an antialiasing kernel on a downscale; they differ in summation order
RESIZE_TOL = dict(atol=1e-4, rtol=0)
#: the tower and the projection, fp32
TOWER_TOL = dict(atol=1e-5, rtol=1e-5)
EMBED_DIM = 16


def jax_adapter(unet_config, seed: int = 21, std: float = 0.1):
    """The JAX ``IPAdapter`` of ``unet_config``: projection, K/V kernels
    and the tiny image tower, every parameter from a numpy seed."""
    from stable_diffusion_videos_tpu.models import ip_adapter as J
    from stable_diffusion_videos_tpu.models.safety import \
        CLIPVisionConfig as JVision
    rng = np.random.default_rng(seed)
    cross = unet_config.cross_attention_dim
    proj = filled(lambda k: J.ImageProjection(cross, 4).init(
        k, jnp.zeros((1, EMBED_DIM))), rng, std)
    kernels = tuple(
        tuple(jnp.asarray(rng.standard_normal(
            (cross, unet_config.block_out_channels[level]),
            dtype=np.float32) * std) for _ in range(2))
        for _, _, level in J.attn2_scopes(unet_config))
    vcfg = JVision.tiny()
    enc = filled(lambda k: J.CLIPVisionEncoder(vcfg).init(
        k, jnp.zeros((1, vcfg.image_size, vcfg.image_size, 3))), rng, std)
    vision = {"encoder": enc, "projection": jnp.asarray(rng.standard_normal(
        (vcfg.hidden_size, EMBED_DIM), dtype=np.float32) * std)}
    return J.IPAdapter(proj_params=proj, attn_kernels=kernels, num_tokens=4,
                       embed_dim=EMBED_DIM, vision_config=vcfg,
                       vision_params=vision)


@pytest.fixture(scope="module")
def bundles():
    """(JAX tiny bundle, the port's on its weights, the JAX adapter, the
    port's on its weights)."""
    port = SDModels.tiny()
    jm = jax_models(port)
    pm = load_port(port, jm)
    jip = jax_adapter(pm.unet_config)
    return jm, pm, jip, IPAdapter.from_jax_params(pm.unet_config, jip)


def image(side: int = 32, seed: int = 2) -> np.ndarray:
    return (np.random.default_rng(seed).random((side, side, 3)) * 255
            ).round().astype(np.uint8)


@pytest.mark.parametrize("shape", [(1, 512, 512), (1, 100, 100),
                                   (2, 300, 500), (1, 150, 120)],
                         ids=["down_512", "up_100", "wide", "tall"])
def test_resize_matches_jax(shape):
    from stable_diffusion_videos_tpu.models.ip_adapter import \
        preprocess_clip_image as jax_preprocess
    x = np.random.default_rng(1).random(shape + (3,), dtype=np.float32)
    want = np.asarray(jax_preprocess(jnp.asarray(x), 224))
    got = preprocess_clip_image(torch.from_numpy(x), 224)
    assert tuple(got.shape) == (shape[0], 3, 224, 224)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               **RESIZE_TOL)


def port_tower(jip, hidden_act: str) -> CLIPVisionEncoder:
    jc = jip.vision_config
    cfg = CLIPVisionConfig(
        image_size=jc.image_size, patch_size=jc.patch_size,
        hidden_size=jc.hidden_size, intermediate_size=jc.intermediate_size,
        num_layers=jc.num_layers, num_heads=jc.num_heads,
        projection_dim=EMBED_DIM, hidden_act=hidden_act)
    tower = CLIPVisionEncoder(cfg)
    return load_state_dict(tower, jax_vision_state_dict(
        jip.vision_params["encoder"], jip.vision_params["projection"], cfg))


def test_tower_matches_jax_under_quick_gelu_and_not_under_gelu(bundles):
    """The JAX package's tower hard-codes quick_gelu: the port's agrees
    under quick_gelu and differs under the exact GELU an OpenCLIP tower's
    config.json declares."""
    from stable_diffusion_videos_tpu.models.safety import CLIPVisionEncoder \
        as JTower
    _, _, jip, _ = bundles
    pix = np.random.default_rng(4).standard_normal((2, 32, 32, 3),
                                                   dtype=np.float32)
    want = np.asarray(JTower(jip.vision_config).apply(
        jip.vision_params["encoder"], jnp.asarray(pix)))
    x = torch.from_numpy(pix).permute(0, 3, 1, 2)
    with torch.no_grad():
        quick = port_tower(jip, "quick_gelu")(x, project=False).numpy()
        exact = port_tower(jip, "gelu")(x, project=False).numpy()
        embed = port_tower(jip, "quick_gelu")(x).numpy()
    np.testing.assert_allclose(quick, want, **TOWER_TOL)
    np.testing.assert_allclose(
        embed, want @ np.asarray(jip.vision_params["projection"]),
        **TOWER_TOL)
    # ten times the agreement's tolerance apart
    assert np.abs(exact - want).max() > 10 * TOWER_TOL["atol"]
    assert CLIPVisionConfig.from_json({"vision_config": {
        "hidden_act": "gelu"}}).hidden_act == "gelu"
    assert CLIPVisionConfig.from_json({}).hidden_act == "quick_gelu"


def test_projection_and_uncond_tokens_match_jax(bundles):
    _, _, jip, pip = bundles
    emb = np.random.default_rng(5).standard_normal((2, EMBED_DIM),
                                                   dtype=np.float32)
    np.testing.assert_allclose(
        pip.image_tokens(image_embeds=emb).numpy(),
        np.asarray(jip.image_tokens(image_embeds=emb)), **TOWER_TOL)
    np.testing.assert_allclose(pip.uncond_tokens().numpy(),
                               np.asarray(jip.uncond_tokens()), **TOWER_TOL)
    # an image at the tower's size needs no resize: the whole path agrees
    np.testing.assert_allclose(pip.image_tokens(image()).numpy(),
                               np.asarray(jip.image_tokens(image())),
                               **TOWER_TOL)


@pytest.mark.parametrize("family", ["sd1", "tiny_xl"])
def test_attn2_scopes_match_jax(family):
    """diffusers' processor order, name by name, against the JAX scopes;
    every name is a cross-attention of the port's UNet."""
    from stable_diffusion_videos_tpu.models.ip_adapter import \
        attn2_scopes as jax_scopes
    cfg = UNetConfig.sd_v1() if family == "sd1" else UNetConfig.tiny_xl()
    n = len(cfg.block_out_channels)

    def diffusers(outer, block):
        if outer == "mid_attn":
            pre = "mid_block.attentions.0"
        else:
            side, level, _, j = outer.split("_")
            pre = (f"down_blocks.{level}.attentions.{j}" if side == "down"
                   else f"up_blocks.{n - 1 - int(level)}.attentions.{j}")
        return f"{pre}.transformer_blocks.{block.split('_')[1]}.attn2"

    want = [(diffusers(o, b), lv) for o, b, lv in jax_scopes(cfg)]
    got = attn2_scopes(cfg)
    assert got == want
    assert len(got) == {"sd1": 16, "tiny_xl": 8}[family]
    with torch.device("meta"):
        unet = UNet2DCondition(cfg)
    for name, level in got:
        attn = unet.get_submodule(name)
        assert attn.to_k.in_features == cfg.cross_attention_dim
        assert attn.to_q.out_features == cfg.block_out_channels[level]


def write_encoder_dir(root: Path, jip) -> Path:
    """A transformers CLIPVisionModelWithProjection directory of the JAX
    adapter's tower (config.json and model.safetensors)."""
    from safetensors.numpy import save_file
    jc = jip.vision_config
    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_text(json.dumps(dict(
        architectures=["CLIPVisionModelWithProjection"],
        hidden_act="quick_gelu", hidden_size=jc.hidden_size,
        image_size=jc.image_size, intermediate_size=jc.intermediate_size,
        num_attention_heads=jc.num_heads, num_hidden_layers=jc.num_layers,
        patch_size=jc.patch_size, projection_dim=EMBED_DIM)))
    cfg = CLIPVisionConfig.from_json(json.loads(
        (root / "config.json").read_text()))
    sd = jax_vision_state_dict(jip.vision_params["encoder"],
                               jip.vision_params["projection"], cfg)
    save_file({k: np.ascontiguousarray(v, np.float32) for k, v in sd.items()},
              str(root / "model.safetensors"))
    return root


@pytest.mark.parametrize("suffix", [".bin", ".safetensors"])
def test_load_ip_adapter_from_one_file(bundles, tmp_path, suffix):
    """One checkpoint (nested ``.bin`` or flat ``.safetensors``, K/V at the
    odd processor indices) and one image-encoder directory, loaded by both
    packages: the same tokens from an image and the same UNet output."""
    from safetensors.numpy import save_file

    from stable_diffusion_videos_tpu.models.ip_adapter import \
        load_ip_adapter as jax_load
    jm, pm, jip, _ = bundles
    p = jip.proj_params["params"]
    proj = {"proj.weight": np.asarray(p["proj"]["kernel"]).T,
            "proj.bias": np.asarray(p["proj"]["bias"]),
            "norm.weight": np.asarray(p["norm"]["scale"]),
            "norm.bias": np.asarray(p["norm"]["bias"])}
    kv = {}
    for i, (k, v) in enumerate(jip.attn_kernels):
        kv[f"{2 * i + 1}.to_k_ip.weight"] = np.asarray(k).T
        kv[f"{2 * i + 1}.to_v_ip.weight"] = np.asarray(v).T
    path = tmp_path / f"ip-adapter{suffix}"
    if suffix == ".bin":
        torch.save({"image_proj": {k: torch.from_numpy(np.ascontiguousarray(
            v)) for k, v in proj.items()},
            "ip_adapter": {k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in kv.items()}}, path)
    else:
        save_file({f"{g}.{k}": np.ascontiguousarray(v, np.float32)
                   for g, d in (("image_proj", proj), ("ip_adapter", kv))
                   for k, v in d.items()}, str(path))
    enc = write_encoder_dir(tmp_path / "image_encoder", jip)
    want = jax_load(str(path), jm, image_encoder=str(enc))
    got = load_ip_adapter(path, pm, image_encoder=enc)
    assert got.image_encoder.config.hidden_act == "quick_gelu"
    np.testing.assert_allclose(got.image_tokens(image()).numpy(),
                               np.asarray(want.image_tokens(image())),
                               **TOWER_TOL)
    for (k, v), (jk, jv) in zip(got.kv, want.attn_kernels):
        np.testing.assert_array_equal(k.numpy(), np.asarray(jk).T)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv).T)
    with pytest.raises(ValueError, match="attention layers"):
        load_ip_adapter(path, SDModels.tiny_xl())


def engine_inputs(cfg, b: int = 2, seed: int = 6):
    rng = np.random.default_rng(seed)
    s = cfg.sample_size
    return dict(cond=rng.standard_normal((b, 77, cfg.cross_attention_dim),
                                         dtype=np.float32),
                uncond=rng.standard_normal((1, 77, cfg.cross_attention_dim),
                                           dtype=np.float32),
                noise=rng.standard_normal((b, s, s, 4), dtype=np.float32),
                embeds=rng.standard_normal((b, EMBED_DIM),
                                           dtype=np.float32))


@pytest.mark.parametrize("entry", ["denoise", "img2img", "inpaint"])
def test_dispatch_with_image_tokens_matches_jax(bundles, entry):
    """pndm-4 dispatches of 2 frames (bucket 8) with per-frame image tokens
    at scale 0.7; img2img (ddim-10, strength 0.6) and inpaint (pndm-4, the
    left half masked) from given latents and field."""
    from stable_diffusion_videos_tpu.runtime.engine import Engine as JEngine
    jm, pm, jip, pip = bundles
    x = engine_inputs(pm.unet_config)
    tokens = np.asarray(jip.image_tokens(image_embeds=x["embeds"]))
    sched = "ddim" if entry == "img2img" else "pndm"
    jeng = JEngine(jm, scheduler=sched, batch_bucket=8, ip_adapter=jip)
    eng = Engine(pm, CPU, scheduler=sched, batch_bucket=8, ip_adapter=pip)
    rng = np.random.default_rng(7)
    lat = rng.standard_normal((2, 8, 8, 4), dtype=np.float32)
    field = rng.standard_normal((1, 8, 8, 4), dtype=np.float32)
    mask = np.zeros((2, 8, 8, 1), np.float32)
    mask[:, :, :4] = 1.0
    run = dict(guidance_scale=3.0, ip_scale=0.7)
    text = (x["cond"], x["uncond"])
    jtext = tuple(map(jnp.asarray, text))
    if entry == "denoise":
        want = jeng.denoise_frames(*jtext, jnp.asarray(x["noise"]),
                                   ip_tokens=jnp.asarray(tokens),
                                   num_inference_steps=4, **run)
        got = eng.denoise_frames(*text, x["noise"], ip_tokens=tokens,
                                 num_inference_steps=4, **run)
    elif entry == "img2img":
        kw = dict(strength=0.6, num_inference_steps=10, **run)
        want = jeng.img2img(*jtext, jnp.asarray(lat), noise=jnp.asarray(
            field), ip_tokens=jnp.asarray(tokens), **kw)
        got = eng.img2img(*text, lat, noise=field, ip_tokens=tokens, **kw)
    else:
        # JAX's inpaint draws noise0 from split(key, 3)[1] over the padded
        # batch; the port takes that field as noise=
        key = jax.random.PRNGKey(0)
        noise0 = np.asarray(jax.random.normal(
            jax.random.split(key, 3)[1], (8, 8, 8, 4)))[:2]
        want = jeng.inpaint(*jtext, jnp.asarray(lat), jnp.asarray(mask),
                            key=key, ip_tokens=jnp.asarray(tokens),
                            num_inference_steps=4, **run)
        got = eng.inpaint(*text, lat, mask, noise=noise0, ip_tokens=tokens,
                          num_inference_steps=4, **run)
    assert got.shape == (2, 16, 16, 3) and got.std() > 0
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_scale_zero_and_no_image_equal_no_adapter(bundles):
    """An adapter dispatch at ``ip_scale=0``, and one with no image (the
    uncond tokens at scale 0), give the adapter-free frames exactly."""
    _, pm, _, pip = bundles
    x = engine_inputs(pm.unet_config)
    run = dict(num_inference_steps=3, guidance_scale=3.0)
    plain = Engine(pm, CPU).denoise_frames(x["cond"], x["uncond"],
                                           x["noise"], **run)
    eng = Engine(pm, CPU, ip_adapter=pip)
    tokens = pip.image_tokens(image_embeds=x["embeds"])
    np.testing.assert_array_equal(eng.denoise_frames(
        x["cond"], x["uncond"], x["noise"], ip_tokens=tokens, ip_scale=0.0,
        **run), plain)
    np.testing.assert_array_equal(eng.denoise_frames(
        x["cond"], x["uncond"], x["noise"], **run), plain)
    steered = eng.denoise_frames(x["cond"], x["uncond"], x["noise"],
                                 ip_tokens=tokens, **run)
    assert np.abs(steered - plain).max() > 1e-4
    # the base bundle's UNet is untouched by the splice
    assert not hasattr(pm.unet.mid_block.attentions[0].transformer_blocks[0]
                       .attn2, "to_k_ip")
    with pytest.raises(ValueError, match="no IP-Adapter"):
        Engine(pm, CPU).denoise_frames(x["cond"], x["uncond"], x["noise"],
                                       ip_tokens=tokens, **run)


def frames(run_dir: Path) -> dict:
    return {p.relative_to(run_dir).as_posix(): np.asarray(Image.open(p),
                                                          np.int32)
            for p in sorted(run_dir.glob("**/frame*.png"))}


def test_walk_with_ip_image_matches_jax(bundles, tmp_path):
    """A walk of 3 frames with one image prompt at the tower's size (the
    tokens through each package's tower): frames within 2/255."""
    from stable_diffusion_videos_tpu.pipeline import \
        StableDiffusionWalkPipeline as JaxWalk
    jm, pm, jip, pip = bundles
    walk = dict(prompts=["a red fox", "a blue lighthouse"], seeds=[7, 1234],
                num_interpolation_steps=3, height=32, width=32,
                num_inference_steps=4, batch_size=2, make_video=False,
                name="w", ip_image=image(), ip_scale=0.8)
    jax_dir = Path(JaxWalk(jm, ip_adapter=jip).walk(
        output_dir=str(tmp_path / "jax"), **walk))
    port_dir = Path(StableDiffusionWalkPipeline(
        pm, CPU, batch_bucket=2, ip_adapter=pip).walk(
            output_dir=str(tmp_path / "port"), **walk))
    want, got = frames(jax_dir), frames(port_dir)
    assert sorted(got) == sorted(want) and len(got) == 3
    for name in want:
        assert np.abs(got[name] - want[name]).max() <= 2, name
