"""Gradients through the PyTorch package's two kernels, against the JAX
package's autodiff.

The JAX package's Pallas kernels carry no backward: its trainers
differentiate ``xla_attention`` (``ops/attention.py``) and flax's
``nn.GroupNorm`` inside ``GroupNorm32`` (``models/layers.py``) with XLA.
The port's plain backwards (``flash_attention_backward_reference``,
``groupnorm_backward_reference``), which its backward kernels are held
against on the card, are held here against ``jax.vjp`` of those two on the
same numpy inputs and cotangents: fp32, atol 1e-5 and rtol 1e-4 (sums over
up to 4096 terms taken in another order).  Each ``autograd.Function`` is
checked with ``torch.autograd.gradcheck`` in fp64 on the CPU, where it runs
the plain forward and backward.  The plain forward's saved log-sum-exp is
held against numpy's, the backward given it against ``jax.vjp``, and so is
the materialised route's q-row chunk plan run through the plain math with a
cap that cuts it into two chunks.  The ``cuda`` cases hold the backward
kernels against the plain backwards on every route (fused, fused with its q
loop split, materialised; D not a multiple of 8), with and without the
saved log-sum-exp, check that each route repeats bit for bit and that the
GroupNorm backward makes two launches, and that a loss through the
wrappers reaches every input on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stable_diffusion_videos_tpu.ops.attention import xla_attention
from stable_diffusion_videos_tpu_torch.ops.flash_attention import (
    FlashAttentionFunction, flash_attention, flash_attention_backward,
    flash_attention_backward_reference, flash_attention_reference,
    materialised_backward_reference, materialised_chunks)
from stable_diffusion_videos_tpu_torch.ops.groupnorm import (
    GroupNormFunction, fused_groupnorm_silu, groupnorm_backward_reference,
    groupnorm_reference, groupnorm_silu_backward)

TOL = dict(atol=1e-5, rtol=1e-4)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


@pytest.mark.parametrize("b,sq,sk,h,d", [(2, 64, 64, 2, 40),
                                         (2, 64, 77, 2, 16),
                                         (1, 128, 128, 1, 512),
                                         (1, 40, 9, 3, 80)],
                         ids=["self_d40", "cross_77", "vae_d512", "ragged"])
def test_attention_backward_matches_jax_vjp(b, sq, sk, h, d):
    q, k, v, do = _arrays(b + sq + d, (b, sq, h, d), (b, sk, h, d),
                          (b, sk, h, d), (b, sq, h, d))
    out, vjp = jax.vjp(xla_attention, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o = flash_attention_reference(tq, tk, tv)
    np.testing.assert_allclose(o.numpy(), np.asarray(out), **TOL)
    got = flash_attention_backward_reference(tq, tk, tv, o, tdo)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=f"d{name}")
    # autograd through the CPU route (the plain forward) agrees as well
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    (flash_attention(*leaves) * tdo).sum().backward()
    for name, leaf, w in zip("qkv", leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), **TOL,
                                   err_msg=f"autograd d{name}")


def test_plain_forward_keeps_each_rows_log_sum_exp():
    q, k, v = _arrays(5, (2, 33, 3, 16), (2, 21, 3, 16), (2, 21, 3, 16))
    scale = 0.3
    o, lse = flash_attention_reference(*map(torch.from_numpy, (q, k, v)),
                                       scale, return_lse=True)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k) * scale
    m = s.max(-1, keepdims=True)
    want = (m[..., 0] + np.log(np.exp(s - m).sum(-1))) * np.log2(np.e)
    assert lse.shape == (2, 3, 33)
    np.testing.assert_allclose(lse.numpy(), want, **TOL)
    np.testing.assert_array_equal(
        o.numpy(), flash_attention_reference(
            *map(torch.from_numpy, (q, k, v)), scale).numpy())


def _jax_attention_vjp(q, k, v, do):
    out, vjp = jax.vjp(xla_attention, *map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("b,sq,sk,h,d", [(2, 64, 77, 2, 16),
                                         (1, 40, 9, 3, 80)],
                         ids=["cross_77", "ragged"])
def test_backward_given_the_saved_lse_matches_jax_vjp(b, sq, sk, h, d):
    q, k, v, do = _arrays(b + sq, (b, sq, h, d), (b, sk, h, d),
                          (b, sk, h, d), (b, sq, h, d))
    _, want = _jax_attention_vjp(q, k, v, do)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_reference(tq, tk, tv, return_lse=True)
    got = flash_attention_backward(tq, tk, tv, o, tdo, None, lse)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=f"d{name}")
    # the Function saves the lse its forward made and hands it back
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    (FlashAttentionFunction.apply(*leaves, None) * tdo).sum().backward()
    for name, leaf, w in zip("qkv", leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), w, **TOL,
                                   err_msg=f"Function d{name}")


def test_materialised_chunk_plan_matches_jax_vjp():
    """A cap that holds P and dS (4 bytes a score, keys padded to 128) of
    256 q rows: 300 q rows run as two chunks whose dk and dv are summed in
    order."""
    b, sq, sk, h, d = 1, 300, 77, 2, 24
    cap = 4 * b * h * 128 * 256
    assert materialised_chunks(b * h, sq, sk, cap) == [(0, 256), (256, 300)]
    assert materialised_chunks(b * h, sq, sk) == [(0, 300)]
    assert materialised_chunks(1, 4096, 4096) == [(0, 4096)]
    q, k, v, do = _arrays(11, (b, sq, h, d), (b, sk, h, d), (b, sk, h, d),
                          (b, sq, h, d))
    _, want = _jax_attention_vjp(q, k, v, do)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_reference(tq, tk, tv, return_lse=True)
    for saved in (lse, None):
        got = materialised_backward_reference(tq, tk, tv, o, tdo, None,
                                              saved, cap)
        for name, g, w in zip("qkv", got, want):
            np.testing.assert_allclose(g.numpy(), w, **TOL,
                                       err_msg=f"d{name}")


def _jax_groupnorm(eps, silu):
    from stable_diffusion_videos_tpu.models.layers import GroupNorm32
    gn = GroupNorm32(32, epsilon=eps)

    def f(x_nhwc, scale, bias):
        params = {"params": {"norm": {"scale": scale, "bias": bias}}}
        return gn.apply(params, x_nhwc, silu=silu)
    return f


@pytest.mark.parametrize("shape", [(2, 64, 8, 8), (1, 96, 5, 7),
                                   (2, 128, 16, 16)])
@pytest.mark.parametrize("eps,silu", [(1e-5, True), (1e-6, False)])
def test_groupnorm_backward_matches_jax_vjp(shape, eps, silu):
    n, c, h, w = shape
    x, dy = _arrays(c + h, shape, shape)
    x = x * 2 + 0.5
    scale, bias = _arrays(c, (c,), (c,))
    nhwc = (0, 2, 3, 1)
    out, vjp = jax.vjp(_jax_groupnorm(eps, silu),
                       jnp.asarray(x.transpose(nhwc)), jnp.asarray(scale),
                       jnp.asarray(bias))
    dx, dscale, dbias = vjp(jnp.asarray(dy.transpose(nhwc)))
    tx, ts, tb, tdy = map(torch.from_numpy, (x, scale, bias, dy))
    np.testing.assert_allclose(
        groupnorm_reference(tx, ts, tb, 32, eps, silu).numpy(),
        np.asarray(out).transpose(0, 3, 1, 2), **TOL)
    got = groupnorm_backward_reference(tx, ts, tb, tdy, 32, eps, silu)
    np.testing.assert_allclose(got[0].numpy(),
                               np.asarray(dx).transpose(0, 3, 1, 2), **TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(dscale),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(dbias),
                               atol=1e-4, rtol=1e-4)


def test_groupnorm_backward_keeps_each_inputs_dtype():
    x = torch.randn(2, 64, 4, 4).to(torch.bfloat16)
    scale, bias = torch.ones(64), torch.zeros(64, dtype=torch.bfloat16)
    dx, dscale, dbias = groupnorm_silu_backward(x, scale, bias,
                                                torch.randn_like(x))
    assert (dx.dtype, dscale.dtype, dbias.dtype) == (
        torch.bfloat16, torch.float32, torch.bfloat16)
    dq, dk, dv = flash_attention_backward(
        *(torch.randn(1, 8, 2, 16, dtype=torch.bfloat16) for _ in range(5)))
    assert {t.dtype for t in (dq, dk, dv)} == {torch.bfloat16}


def test_attention_function_passes_gradcheck():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g, dtype=torch.float64,
                           requires_grad=True)
               for s in ((2, 5, 2, 8), (2, 3, 2, 8), (2, 3, 2, 8)))
    assert torch.autograd.gradcheck(
        lambda a, b, c: FlashAttentionFunction.apply(a, b, c, None),
        (q, k, v))
    assert torch.autograd.gradcheck(
        lambda a, b, c: FlashAttentionFunction.apply(a, b, c, 0.3),
        (q, k, v))


@pytest.mark.parametrize("silu", [True, False])
def test_groupnorm_function_passes_gradcheck(silu):
    g = torch.Generator().manual_seed(1)
    x, scale, bias = (torch.randn(s, generator=g, dtype=torch.float64,
                                  requires_grad=True)
                      for s in ((2, 8, 3, 3), (8,), (8,)))
    assert torch.autograd.gradcheck(
        lambda a, b, c: GroupNormFunction.apply(a, b, c, 4, 1e-5, silu),
        (x, scale, bias))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,sq,sk,h,d", [
    (2, 256, 256, 8, 40), (2, 256, 77, 8, 40), (2, 128, 128, 8, 80),
    (2, 64, 77, 8, 160), (1, 300, 300, 1, 512), (1, 100, 33, 2, 64),
    (2, 256, 256, 8, 160), (1, 1024, 1024, 1, 512), (2, 300, 77, 8, 36),
    (1, 130, 150, 2, 100)])
def test_attention_backward_kernel_matches_plain(cuda, dtype, tol, b, sq,
                                                 sk, h, d):
    q, k, v, do = (torch.from_numpy(a).to(cuda, dtype) for a in _arrays(
        d, (b, sq, h, d), (b, sk, h, d), (b, sk, h, d), (b, sq, h, d)))
    routes = flash_attention_backward.by_route.copy()
    o = flash_attention(q, k, v)
    want = flash_attention_backward_reference(q, k, v, o, do)
    # without a saved log-sum-exp (the bf16 routes run the LSE pass)
    for got, ref in zip(flash_attention_backward(q, k, v, o, do), want):
        torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                   rtol=tol)
    # through autograd, with the forward's saved log-sum-exp
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    torch.autograd.backward(flash_attention(*leaves), do)
    for leaf, ref in zip(leaves, want):
        torch.testing.assert_close(leaf.grad.float(), ref.float(), atol=tol,
                                   rtol=tol)
    if dtype == torch.bfloat16:
        # every bf16 call on a tensor-core route, chosen by depth
        route = "fused" if d <= 80 else "materialised"
        by_route = flash_attention_backward.by_route
        assert by_route[route] - routes[route] == 2
        assert by_route["lse_pass"] - routes["lse_pass"] == 1
        assert by_route["fused_split"] - routes["fused_split"] == (
            2 if d <= 80 and sk <= 128 else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(2, 320, 64, 64), (1, 128, 256, 256),
                                   (2, 96, 5, 5), (1, 128, 512, 512),
                                   (2, 1280, 8, 8)])
@pytest.mark.parametrize("silu", [True, False])
def test_groupnorm_backward_kernel_matches_plain(cuda, dtype, tol, shape,
                                                 silu):
    x = (torch.randn(shape, device=cuda) * 2 + 0.5).to(dtype)
    dy = torch.randn(shape, device=cuda).to(dtype)
    scale, bias = torch.randn(shape[1], device=cuda), \
        torch.randn(shape[1], device=cuda)
    got = groupnorm_silu_backward(x, scale, bias, dy, 32, 1e-5, silu)
    want = groupnorm_backward_reference(x, scale, bias, dy, 32, 1e-5, silu)
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=tol,
                               rtol=tol)
    # the weights' gradients sum over every pixel: relative to their size
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, atol=1e-3 * w.abs().max().item(),
                                   rtol=1e-3)


@pytest.mark.cuda
def test_a_loss_through_both_wrappers_reaches_every_input(cuda):
    x = torch.randn(2, 64, 8, 8, device=cuda, requires_grad=True)
    scale = torch.ones(64, device=cuda, requires_grad=True)
    bias = torch.zeros(64, device=cuda, requires_grad=True)
    calls = (flash_attention_backward_reference.calls,
             groupnorm_backward_reference.calls)
    launches = (flash_attention_backward.launches,
                groupnorm_silu_backward.launches)
    y = fused_groupnorm_silu(x, scale, bias, 32, 1e-5, True)
    t = y.flatten(2).transpose(1, 2).reshape(2, 64, 2, 32)
    o = flash_attention(t, t, t)
    assert y.grad_fn is not None and o.grad_fn is not None
    o.square().sum().backward()
    for leaf in (x, scale, bias):
        assert leaf.grad is not None and leaf.grad.abs().sum() > 0
    assert (flash_attention_backward.launches,
            groupnorm_silu_backward.launches) == (launches[0] + 1,
                                                  launches[1] + 1)
    assert (flash_attention_backward_reference.calls,
            groupnorm_backward_reference.calls) == calls


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,d", [(2, 300, 77, 4, 40),
                                         (2, 300, 300, 4, 64),
                                         (1, 256, 77, 2, 160),
                                         (1, 384, 384, 1, 512)],
                         ids=["fused_split", "fused", "materialised_160",
                              "materialised_512"])
def test_backward_kernels_repeat_bit_for_bit(cuda, dtype, b, sq, sk, h, d):
    """No atomics in either backward: a second call gives the same bits
    (the trainers' remat and resume checks rely on it), on every route;
    the GroupNorm backward in two launches a call."""
    from stable_diffusion_videos_tpu_torch.ops import build
    q, k, v, do = (torch.from_numpy(a).to(cuda, dtype) for a in _arrays(
        3, (b, sq, h, d), (b, sk, h, d), (b, sk, h, d), (b, sq, h, d)))
    o = flash_attention(q, k, v)
    first = flash_attention_backward(q, k, v, o, do)
    for a, b_ in zip(first, flash_attention_backward(q, k, v, o, do)):
        assert torch.equal(a, b_)
    x = torch.randn(2, 320, 32, 32, device=cuda).to(dtype)
    args = (x, torch.randn(320, device=cuda), torch.randn(320, device=cuda),
            torch.randn_like(x), 32, 1e-5, True)
    lib = build.library()
    before = lib.sdv_groupnorm_backward_launches()
    first = groupnorm_silu_backward(*args)
    assert lib.sdv_groupnorm_backward_launches() - before == 2
    for a, b_ in zip(first, groupnorm_silu_backward(*args)):
        assert torch.equal(a, b_)
