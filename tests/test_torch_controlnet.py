"""ControlNet on the PyTorch package against the JAX package, on the CPU.

The residuals of the tiny and tiny_xl ControlNets against the JAX
``ControlNet.apply`` (fp32, atol=rtol 1e-5); the zero taps' exact no-op;
the linear ``conditioning_scale``; the count check; ``load_controlnet`` on
one diffusers-named file (a model directory and a bare file) handed to both
packages (1e-5); engine dispatches with one net under CFG and two nets
under ``guess_mode`` and ``guidance_interval`` (1e-4); ``control`` with
``step_cache`` refused; img2img with a control map (1e-4); a walk with a
per-frame control sequence (frames within 2/255).

Both packages run the same weights: the JAX ControlNet's parameter tree is
filled from a numpy seed (shapes from ``jax.eval_shape``, so no initialiser
runs) and carried into the port by ``ControlNetBundle.from_jax_params``;
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
from stable_diffusion_videos_tpu_torch.models.controlnet import (
    ControlNetBundle, load_controlnet)
from stable_diffusion_videos_tpu_torch.pipeline import \
    StableDiffusionWalkPipeline
from stable_diffusion_videos_tpu_torch.runtime.engine import Engine

from test_torch_sdxl import (CPU, TOL, filled, jax_config, jax_models,
                             load_port)
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

#: the residuals, one UNet-trunk pass in fp32
RES_TOL = dict(atol=1e-5, rtol=1e-5)
COND_CHANNELS = (8, 16)


def jax_controlnet(port_config, seed: int = 11, std: float = 0.1):
    """The JAX ``ControlNetBundle`` of ``port_config``'s geometry with every
    parameter (the zero taps too) drawn from a numpy seed."""
    from stable_diffusion_videos_tpu.models.controlnet import (
        ControlNet, ControlNetBundle as JBundle)
    from stable_diffusion_videos_tpu.models.unet import UNetConfig as JConfig
    cfg = jax_config(JConfig, port_config)
    mod = ControlNet(cfg, cond_channels=COND_CHANNELS)
    s, f = cfg.sample_size, 2 ** (len(COND_CHANNELS) - 1)
    xl = ({} if cfg.addition_embed_dim is None else dict(
        text_embeds=jnp.zeros((1, cfg.addition_pooled_dim)),
        time_ids=jnp.zeros((1, cfg.addition_num_ids))))
    params = filled(lambda k: mod.init(
        k, jnp.zeros((1, s, s, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 7, cfg.cross_attention_dim)),
        jnp.zeros((1, s * f, s * f, 3)), **xl), np.random.default_rng(seed),
        std)
    return JBundle(cfg, params, COND_CHANNELS)


def port_controlnet(jb, port_config) -> ControlNetBundle:
    return ControlNetBundle.from_jax_params(port_config, jb.params,
                                            COND_CHANNELS)


@pytest.fixture(scope="module")
def bundles():
    """(JAX tiny bundle, the port's on its weights, JAX ControlNets seeded
    11 and 12, the port's on theirs)."""
    port = SDModels.tiny()
    jm = jax_models(port)
    pm = load_port(port, jm)
    jnets = [jax_controlnet(pm.unet_config, seed) for seed in (11, 12)]
    return jm, pm, jnets, [port_controlnet(j, pm.unet_config)
                           for j in jnets]


def trunk_inputs(cfg, b: int = 2, seed: int = 0):
    """NHWC latents, timesteps, context and control maps, numpy."""
    rng = np.random.default_rng(seed)
    s = cfg.sample_size
    return (rng.standard_normal((b, s, s, 4), dtype=np.float32),
            np.array([10.0, 700.0][:b], np.float32),
            rng.standard_normal((b, 7, cfg.cross_attention_dim),
                                dtype=np.float32),
            rng.random((b, 2 * s, 2 * s, 3), dtype=np.float32))


def port_residuals(pb, lat, t, ctx, cmap, scale=1.0, **xl):
    with torch.no_grad():
        return pb.module(torch.from_numpy(lat).permute(0, 3, 1, 2),
                         torch.from_numpy(t), torch.from_numpy(ctx),
                         torch.from_numpy(cmap).permute(0, 3, 1, 2),
                         conditioning_scale=scale,
                         **{k: torch.from_numpy(v) for k, v in xl.items()})


def assert_residuals_match(jax_out, port_out):
    jdown, jmid = jax_out
    pdown, pmid = port_out
    assert len(pdown) == len(jdown)
    for j, p in zip(list(jdown) + [jmid], list(pdown) + [pmid]):
        np.testing.assert_allclose(p.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(j), **RES_TOL)


@pytest.mark.parametrize("xl", [False, True], ids=["tiny", "tiny_xl"])
def test_residuals_match_jax(xl):
    from stable_diffusion_videos_tpu.models.controlnet import ControlNet
    port = SDModels.tiny_xl() if xl else SDModels.tiny()
    jb = jax_controlnet(port.unet_config)
    pb = port_controlnet(jb, port.unet_config)
    lat, t, ctx, cmap = trunk_inputs(port.unet_config)
    kw = {}
    if xl:
        rng = np.random.default_rng(3)
        cfg = port.unet_config
        kw = dict(text_embeds=rng.standard_normal(
            (2, cfg.addition_pooled_dim), dtype=np.float32),
            time_ids=np.array([[16, 16, 0, 0, 16, 16]] * 2, np.float32))
    want = ControlNet(jb.config, cond_channels=COND_CHANNELS).apply(
        jb.params, lat, t, ctx, cmap, conditioning_scale=0.7,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    assert_residuals_match(want, port_residuals(pb, lat, t, ctx, cmap, 0.7,
                                                **kw))


def test_zero_taps_are_an_exact_noop(bundles):
    _, pm, _, _ = bundles
    pb = ControlNetBundle.tiny(seed=3).zeroed()
    lat, t, ctx, cmap = trunk_inputs(pm.unet_config)
    down, mid = port_residuals(pb, lat, t, ctx, cmap)
    assert all(not r.any() for r in (*down, mid))
    x = torch.from_numpy(lat).permute(0, 3, 1, 2)
    with torch.no_grad():
        plain = pm.unet(x, torch.from_numpy(t), torch.from_numpy(ctx))
        steered = pm.unet(x, torch.from_numpy(t), torch.from_numpy(ctx),
                          ctrl_down=down, ctrl_mid=mid)
    assert torch.equal(plain, steered)


def test_conditioning_scale_is_linear(bundles):
    _, pm, _, pnets = bundles
    args = trunk_inputs(pm.unet_config)
    one = port_residuals(pnets[0], *args, scale=1.0)
    two = port_residuals(pnets[0], *args, scale=2.5)
    zero = port_residuals(pnets[0], *args, scale=0.0)
    for a, b, z in zip((*one[0], one[1]), (*two[0], two[1]),
                       (*zero[0], zero[1])):
        torch.testing.assert_close(b, 2.5 * a, atol=1e-6, rtol=1e-6)
        assert not z.any()


def test_residual_count_mismatch_raises(bundles):
    _, pm, _, pnets = bundles
    lat, t, ctx, cmap = trunk_inputs(pm.unet_config)
    down, mid = port_residuals(pnets[0], lat, t, ctx, cmap)
    with pytest.raises(ValueError, match="ControlNet down residuals"):
        pm.unet(torch.from_numpy(lat).permute(0, 3, 1, 2),
                torch.from_numpy(t), torch.from_numpy(ctx),
                ctrl_down=down[:-1], ctrl_mid=mid)


@pytest.mark.parametrize("layout", ["directory", "bare_file"])
def test_load_controlnet_from_one_file(tmp_path, layout):
    """One diffusers-named safetensors file (and, as a model directory, its
    config.json), loaded by both packages: the same residuals."""
    from safetensors.numpy import save_file

    from stable_diffusion_videos_tpu.models.controlnet import ControlNet
    from stable_diffusion_videos_tpu.models.weights import \
        load_controlnet as jax_load
    pb = ControlNetBundle.tiny(seed=4)
    sd = {k: v.numpy() for k, v in pb.module.state_dict().items()}
    root = tmp_path / "cn"
    root.mkdir()
    weights = root / "diffusion_pytorch_model.safetensors"
    save_file(sd, str(weights))
    target = weights
    if layout == "directory":
        cfg = pb.config
        (root / "config.json").write_text(json.dumps(dict(
            _class_name="ControlNetModel", sample_size=cfg.sample_size,
            block_out_channels=list(cfg.block_out_channels),
            layers_per_block=cfg.layers_per_block,
            cross_attention_dim=cfg.cross_attention_dim,
            attention_head_dim=cfg.attention_head_dim,
            down_block_types=["CrossAttnDownBlock2D", "DownBlock2D"],
            conditioning_embedding_out_channels=list(COND_CHANNELS))))
        target = root
    jb = jax_load(str(target))
    got = load_controlnet(target)
    assert got.cond_channels == tuple(jb.cond_channels) == COND_CHANNELS
    assert got.config.heads(0) == jb.config.heads(0)
    args = trunk_inputs(got.config)
    want = ControlNet(jb.config, cond_channels=jb.cond_channels).apply(
        jb.params, *args)
    assert_residuals_match(want, port_residuals(got, *args))


def engine_inputs(cfg, b: int = 2, seed: int = 5):
    rng = np.random.default_rng(seed)
    s = cfg.sample_size
    return dict(cond=rng.standard_normal((b, 77, cfg.cross_attention_dim),
                                         dtype=np.float32),
                uncond=rng.standard_normal((1, 77, cfg.cross_attention_dim),
                                           dtype=np.float32),
                noise=rng.standard_normal((b, s, s, 4), dtype=np.float32),
                maps=[rng.random((b, 2 * s, 2 * s, 3), dtype=np.float32),
                      rng.random((1, 2 * s, 2 * s, 3), dtype=np.float32)])


@pytest.mark.parametrize("case", ["one_net_cfg", "two_nets_guess_interval"])
def test_engine_dispatch_matches_jax(bundles, case):
    """pndm-4 dispatches of 2 frames (bucket 8, the JAX package's CPU
    mesh): one net under CFG at scale 0.8; two nets (per-frame maps and one
    broadcast map, scales 1.0 and 0.5) under ``guess_mode`` with limited-
    interval CFG, whose cond-only segments slice the maps."""
    from stable_diffusion_videos_tpu.runtime.engine import Engine as JEngine
    jm, pm, jnets, pnets = bundles
    x = engine_inputs(pm.unet_config)
    if case == "one_net_cfg":
        kw, ctrl = {}, dict(control=x["maps"][0], control_scale=0.8)
        jn, pn = jnets[0], pnets[0]
    else:
        kw = dict(guidance_interval=(0.25, 0.75))
        ctrl = dict(control=x["maps"], control_scale=[1.0, 0.5],
                    guess_mode=True)
        jn, pn = jnets, pnets
    run = dict(num_inference_steps=4, guidance_scale=3.0)
    want = JEngine(jm, batch_bucket=8, controlnet=jn, **kw).denoise_frames(
        jnp.asarray(x["cond"]), jnp.asarray(x["uncond"]),
        jnp.asarray(x["noise"]), **run, **ctrl)
    eng = Engine(pm, CPU, batch_bucket=8, controlnet=pn, **kw)
    got = eng.denoise_frames(x["cond"], x["uncond"], x["noise"], **run,
                             **ctrl)
    plain = eng.denoise_frames(x["cond"], x["uncond"], x["noise"], **run)
    assert got.shape == (2, 16, 16, 3) and got.std() > 0
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert np.abs(got - plain).max() > 1e-3  # the control steers


def test_control_with_step_cache_raises(bundles):
    _, pm, _, pnets = bundles
    x = engine_inputs(pm.unet_config)
    eng = Engine(pm, CPU, controlnet=pnets[0], step_cache=2)
    with pytest.raises(ValueError, match="step_cache"):
        eng.denoise_frames(x["cond"], x["uncond"], x["noise"],
                           num_inference_steps=3, control=x["maps"][0])
    with pytest.raises(ValueError, match="no ControlNet"):
        Engine(pm, CPU).denoise_frames(x["cond"], x["uncond"], x["noise"],
                                       num_inference_steps=3,
                                       control=x["maps"][0])


def test_img2img_with_control_matches_jax(bundles):
    """ddim-10 at strength 0.6 from given latents and field, one control
    map for both frames."""
    from stable_diffusion_videos_tpu.runtime.engine import Engine as JEngine
    jm, pm, jnets, pnets = bundles
    x = engine_inputs(pm.unet_config)
    rng = np.random.default_rng(8)
    lat = rng.standard_normal((2, 8, 8, 4), dtype=np.float32)
    field = rng.standard_normal((1, 8, 8, 4), dtype=np.float32)
    run = dict(strength=0.6, num_inference_steps=10, guidance_scale=3.0,
               control_scale=0.9)
    want = JEngine(jm, scheduler="ddim", batch_bucket=8,
                   controlnet=jnets[0]).img2img(
        jnp.asarray(x["cond"]), jnp.asarray(x["uncond"]), jnp.asarray(lat),
        control=x["maps"][1], noise=jnp.asarray(field), **run)
    got = Engine(pm, CPU, scheduler="ddim", controlnet=pnets[0]).img2img(
        x["cond"], x["uncond"], lat, control=x["maps"][1], noise=field,
        **run)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def frames(run_dir: Path) -> dict:
    return {p.relative_to(run_dir).as_posix(): np.asarray(Image.open(p),
                                                          np.int32)
            for p in sorted(run_dir.glob("**/frame*.png"))}


def test_walk_with_control_sequence_matches_jax(bundles, tmp_path):
    """A walk of 3 frames a clip with a per-frame control sequence (one map
    a frame, followed by absolute frame index): frames within 2/255 of the
    JAX package's, and the resume config records no array."""
    from stable_diffusion_videos_tpu.pipeline import \
        StableDiffusionWalkPipeline as JaxWalk
    jm, pm, jnets, pnets = bundles
    seq = np.random.default_rng(9).random((3, 32, 32, 3), dtype=np.float32)
    walk = dict(prompts=["a red fox", "a blue lighthouse"], seeds=[7, 1234],
                num_interpolation_steps=3, height=32, width=32,
                num_inference_steps=4, batch_size=2, make_video=False,
                name="w", control_image=seq, controlnet_scale=0.9)
    jax_dir = Path(JaxWalk(jm, controlnet=jnets[0]).walk(
        output_dir=str(tmp_path / "jax"), **walk))
    port_dir = Path(StableDiffusionWalkPipeline(
        pm, CPU, batch_bucket=2, controlnet=pnets[0]).walk(
            output_dir=str(tmp_path / "port"), **walk))
    want, got = frames(jax_dir), frames(port_dir)
    assert sorted(got) == sorted(want) and len(got) == 3
    for name in want:
        assert np.abs(got[name] - want[name]).max() <= 2, name
    cfg = json.loads((port_dir / "prompt_config.json").read_text())
    assert cfg["control_image"] is None and cfg["controlnet_scale"] == 0.9
