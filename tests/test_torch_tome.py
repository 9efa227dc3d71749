"""ToMe-SD token merging in the PyTorch package against the JAX package's.

``ops/tome.py``: the 2x2 partition, the plan (integer arrays equal), merge,
unmerge and ``tome_wrap`` (fp32 1e-5); the tiny UNet with ``tome`` and a
pndm dispatch under ``step_cache=2`` (1e-4), both on the JAX tiny bundle's
weights.  A plan is compared only where the similarities it sorts are
separated (a different summation order may swap near-ties; the premise is
asserted) or tie exactly (blocks of one basis vector: every src token's
best cosine is the same number, so the order is the stable sort's).  The
ControlNet never merges, and ``with_tome`` validates its ratio.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stable_diffusion_videos_tpu.ops import tome as jtome
from stable_diffusion_videos_tpu_torch.models import layers
from stable_diffusion_videos_tpu_torch.models.bundle import SDModels
from stable_diffusion_videos_tpu_torch.models.controlnet import \
    ControlNetBundle
from stable_diffusion_videos_tpu_torch.ops.tome import (bipartite_partition,
                                                        build_plan, merge,
                                                        tome_wrap, unmerge)
from stable_diffusion_videos_tpu_torch.runtime.engine import Engine

from test_torch_sampler_engines import ENGINE_TOL, engine_inputs, \
    tiny_bundles
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")
OPS_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def bundles():
    return tiny_bundles()


def separated_tokens(seed: int, b=2, s=64, c=16) -> np.ndarray:
    """Random tokens whose src tokens' best dst cosines (the sort keys)
    and top-two dst cosines (the argmax) differ by at least 1e-5, a
    hundred times what a 16-term fp32 dot product can move."""
    x = np.random.default_rng(seed).standard_normal((b, s, c))
    src, dst = (np.asarray(t) for t in jtome.bipartite_partition(8, 8))
    m = x / np.linalg.norm(x, axis=-1, keepdims=True)
    sim = np.einsum("bsc,bdc->bsd", m[:, src], m[:, dst])
    top = np.sort(sim, axis=-1)
    assert (top[..., -1] - top[..., -2]).min() > 1e-5
    assert np.diff(np.sort(top[..., -1], axis=-1)).min() > 1e-5
    return x.astype(np.float32)


def plan_arrays(plan) -> dict:
    """A plan's index arrays (the port's from any device, or JAX's) as
    numpy."""
    return {k: np.asarray(v.cpu() if torch.is_tensor(v) else v)
            for k, v in plan._asdict().items() if k != "n_merge"}


@pytest.mark.parametrize("h,w,sy,sx", [(8, 12, 2, 2), (7, 9, 2, 2),
                                       (8, 8, 2, 4)])
def test_partition_matches_jax(h, w, sy, sx):
    src, dst = bipartite_partition(h, w, sy, sx)
    want_src, want_dst = jtome.bipartite_partition(h, w, sy, sx)
    np.testing.assert_array_equal(src.numpy(), want_src)
    np.testing.assert_array_equal(dst.numpy(), want_dst)


@pytest.mark.parametrize("n_merge", [1, 20, 48, 60])
def test_plan_matches_jax(n_merge):
    """n_merge 60 is capped at the 48 src tokens."""
    x = separated_tokens(0)
    got = plan_arrays(build_plan(torch.from_numpy(x), 8, 8, n_merge))
    want = plan_arrays(jtome.build_plan(jnp.asarray(x), 8, 8, n_merge))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_plan_of_exact_ties_matches_jax():
    """Each 2x2 block one scaled basis vector: every src token's best
    cosine is the same float, so the merged set is the first n_merge src
    tokens in src order and each joins its own block's dst."""
    blocks = np.zeros((1, 4, 4, 16), np.float32)
    blocks[0].reshape(16, 16)[np.arange(16), np.arange(16)] = 2.0
    x = np.repeat(np.repeat(blocks, 2, axis=1), 2, axis=2).reshape(1, 64, 16)
    got = plan_arrays(build_plan(torch.from_numpy(x), 8, 8, 32))
    want = plan_arrays(jtome.build_plan(jnp.asarray(x), 8, 8, 32))
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["merged"][0], np.arange(32))


def test_merge_unmerge_and_wrap_match_jax():
    x = separated_tokens(1)
    w = np.random.default_rng(2).standard_normal((16, 16)).astype(np.float32)
    plan, jplan = (build_plan(torch.from_numpy(x), 8, 8, 20),
                   jtome.build_plan(jnp.asarray(x), 8, 8, 20))
    xm = merge(torch.from_numpy(x), plan)
    np.testing.assert_allclose(xm.numpy(), np.asarray(jtome.merge(
        jnp.asarray(x), jplan)), **OPS_TOL)
    out = unmerge(xm * 2.0, plan, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(jtome.unmerge(
        jtome.merge(jnp.asarray(x), jplan) * 2.0, jplan, 64)), **OPS_TOL)
    got = tome_wrap(lambda t: t @ torch.from_numpy(w), torch.from_numpy(x),
                    8, 8, 0.3)
    want = jtome.tome_wrap(lambda t: t @ jnp.asarray(w), jnp.asarray(x), 8,
                           8, 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OPS_TOL)


def test_constant_blocks_merge_losslessly():
    """Random constant 2x2 blocks (near-ties across blocks, so the plan may
    order them otherwise than JAX's): merge -> identity -> unmerge gives x
    back, as JAX's does."""
    blocks = np.random.default_rng(1).standard_normal(
        (1, 4, 4, 8)).astype(np.float32)
    x = np.repeat(np.repeat(blocks, 2, axis=1), 2, axis=2).reshape(1, 64, 8)
    got = tome_wrap(lambda t: t, torch.from_numpy(x), 8, 8, 0.5)
    want = jtome.tome_wrap(lambda t: t, jnp.asarray(x), 8, 8, 0.5)
    np.testing.assert_allclose(got.numpy(), x, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OPS_TOL)


def test_ratio_zero_runs_the_full_token_set():
    x = torch.randn(2, 64, 16)
    calls = []

    def fn(t):
        calls.append(tuple(t.shape))
        return t * 2.0
    torch.testing.assert_close(tome_wrap(fn, x, 8, 8, 0.0), x * 2.0)
    assert calls == [(2, 64, 16)]


def test_unet_with_tome_matches_jax(bundles):
    """ToMe moves the tiny UNet's output by about 2e-4, so beside the
    outputs (1e-4) the change ToMe makes is held to JAX's within 1e-5."""
    from stable_diffusion_videos_tpu.models.unet import UNet2DCondition
    jm, pm = bundles
    rng = np.random.default_rng(4)
    lat = rng.standard_normal((2, 8, 8, 4), dtype=np.float32)
    ctx = rng.standard_normal((2, 7, 32), dtype=np.float32)
    t = np.asarray([5.0, 900.0], np.float32)
    out = {}
    for tome in ((0.5, 0), None):
        want = UNet2DCondition(jm.unet_config, tome=tome).apply(
            jm.params["unet"], jnp.asarray(lat), jnp.asarray(t),
            jnp.asarray(ctx))
        unet = (pm.with_tome(*tome) if tome else pm).unet
        with torch.no_grad():
            got = unet(torch.from_numpy(lat.transpose(0, 3, 1, 2)),
                       torch.from_numpy(t), torch.from_numpy(ctx))
        out[tome] = (got.numpy().transpose(0, 2, 3, 1), np.asarray(want))
        np.testing.assert_allclose(*out[tome], **ENGINE_TOL)
    (got, want), (got0, want0) = out[(0.5, 0)], out[None]
    assert np.abs(got - got0).max() > 1e-4
    np.testing.assert_allclose(got - got0, want - want0, atol=1e-5)


def test_tome_dispatch_with_step_cache_matches_jax(bundles):
    from stable_diffusion_videos_tpu.runtime.engine import Engine as JEngine
    jm, pm = bundles
    cond, uncond, noise = engine_inputs()
    run = dict(num_inference_steps=5, guidance_scale=3.0)
    want = JEngine(jm.with_tome(0.5), batch_bucket=8,
                   step_cache=2).denoise_frames(
        jnp.asarray(cond), jnp.asarray(uncond), jnp.asarray(noise), **run)
    got = Engine(pm.with_tome(0.5), CPU, step_cache=2).denoise_frames(
        cond, uncond, noise, **run)
    np.testing.assert_allclose(got, np.asarray(want), **ENGINE_TOL)


def test_controlnet_does_not_merge(bundles, monkeypatch):
    """A ToMe bundle's dispatch feeds the UNet the same ControlNet
    residuals as the plain bundle's (the first step, where both UNets see
    the same latents), and only the UNet's transformer blocks merge."""
    _, pm = bundles
    cn = ControlNetBundle.tiny()
    calls = []
    orig = layers.tome_wrap
    monkeypatch.setattr(layers, "tome_wrap",
                        lambda fn, x, *a: calls.append(x.shape) or orig(
                            fn, x, *a))
    residuals = {}
    for label, models in (("plain", pm), ("tome", pm.with_tome(0.5))):
        seen = []
        hook = models.unet.register_forward_pre_hook(
            lambda m, args, kw: seen.append(
                (kw["ctrl_down"], kw["ctrl_mid"])), with_kwargs=True)
        cn_merges = []
        cn_hook = cn.module.register_forward_pre_hook(
            lambda *_: cn_merges.append(len(calls)))
        cn_done = cn.module.register_forward_hook(
            lambda *_: cn_merges.append(len(calls)) and None)
        cond, uncond, noise = engine_inputs()
        Engine(models, CPU, controlnet=cn).denoise_frames(
            cond, uncond, noise, num_inference_steps=2,
            control=np.full((16, 16, 3), 0.5, np.float32))
        for h in (hook, cn_hook, cn_done):
            h.remove()
        residuals[label] = seen[0]
        # launches of tome_wrap between each ControlNet call's start and end
        residuals[f"{label} cn merges"] = sum(
            b - a for a, b in zip(cn_merges[::2], cn_merges[1::2]))
    for a, b in zip(residuals["plain"][0], residuals["tome"][0]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(residuals["plain"][1], residuals["tome"][1],
                               rtol=0, atol=0)
    assert residuals["plain cn merges"] == residuals["tome cn merges"] == 0
    assert len(calls) > 0  # the ToMe UNet merged


def test_with_tome_validates_and_shares_weights(bundles):
    _, pm = bundles
    for bad in (1.0, -0.1, 1.5):
        with pytest.raises(ValueError, match=r"\[0, 1\)"):
            pm.with_tome(bad)
    assert pm.with_tome(0.0).unet.tome is None
    t = pm.with_tome(0.25, max_level=1)
    assert t.unet.tome == (0.25, 1) and pm.unet.tome is None
    assert t.unet.conv_in.weight is pm.unet.conv_in.weight
    ratios = {tb.tome_ratio for blk in (*t.unet.down_blocks, *t.unet.up_blocks)
              for st in blk.attentions for tb in st.transformer_blocks}
    assert ratios == {0.25}
    assert {tb.tome_ratio for st in pm.unet.down_blocks[0].attentions
            for tb in st.transformer_blocks} == {0.0}
    assert {tb.tome_ratio for st in t.unet.mid_block.attentions
            for tb in st.transformer_blocks} == {0.0}


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
def test_tome_on_the_card(cuda):
    """The plans of the separated input on the card equal the CPU's; merge
    and unmerge fp32 1e-5; a ToMe UNet (the port's tiny bundle: the card's
    machine has no flax) 1e-4."""
    x = torch.from_numpy(separated_tokens(0))
    for n_merge in (20, 48):
        got = plan_arrays(build_plan(x.to(cuda), 8, 8, n_merge))
        want = plan_arrays(build_plan(x, 8, 8, n_merge))
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    plan = build_plan(x, 8, 8, 20)
    on = plan._replace(**{f: getattr(plan, f).to(cuda) for f in (
        "src_idx", "dst_idx", "kept", "merged", "assign")})
    torch.testing.assert_close(merge(x.to(cuda), on).cpu(), merge(x, plan),
                               **OPS_TOL)
    torch.testing.assert_close(unmerge(merge(x, plan).to(cuda), on, 64).cpu(),
                               unmerge(merge(x, plan), plan, 64), **OPS_TOL)
    unet = SDModels.tiny().with_tome(0.5).unet
    args = [torch.randn(2, 4, 8, 8), torch.tensor([5.0, 900.0]),
            torch.randn(2, 7, 32)]
    with torch.no_grad():
        want = unet(*args)
        got = unet.to(cuda)(*(a.to(cuda) for a in args)).cpu()
    torch.testing.assert_close(got, want, **ENGINE_TOL)
