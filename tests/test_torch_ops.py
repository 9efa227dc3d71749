"""The PyTorch package's ops against the JAX package's.

On the CPU each op's wrapper takes its plain PyTorch version, which is held
against the JAX op on the same numpy inputs: the Pallas flash-attention
kernel run in interpret mode (and ``xla_attention``, which the JAX kernel
runs for a ragged key length), and the Pallas GroupNorm kernel, which
interprets on the CPU.  Tolerance fp32 1e-5.  The ``cuda`` cases hold the
hand-written kernels against the plain versions and run only on a GPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: E402

from stable_diffusion_videos_tpu.ops.attention import xla_attention
from stable_diffusion_videos_tpu.ops.flash_attention import \
    flash_attention as jax_flash_attention
from stable_diffusion_videos_tpu.ops.groupnorm import \
    fused_groupnorm_silu as jax_groupnorm
from stable_diffusion_videos_tpu_torch.ops.attention import (attention,
                                                             masked_attention)
from stable_diffusion_videos_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_reference)
from stable_diffusion_videos_tpu_torch.ops.groupnorm import (
    fused_groupnorm_silu, groupnorm_reference)

TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(b, sq, sk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), dtype=np.float32),
            rng.standard_normal((b, sk, h, d), dtype=np.float32),
            rng.standard_normal((b, sk, h, d), dtype=np.float32))


@pytest.mark.parametrize("b,s,h,d", [(2, 128, 2, 16), (1, 256, 2, 40),
                                     (1, 128, 1, 512)],
                         ids=["d16", "d40", "d512_one_head"])
def test_attention_matches_jax_flash_kernel(b, s, h, d):
    q, k, v = _qkv(b, s, s, h, d)
    want = np.asarray(jax_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), interpret=True))
    got = flash_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("d", [40, 160])
def test_attention_ragged_keys_match_jax(d):
    """Sk=77 (every cross-attention): the JAX kernel runs xla_attention."""
    q, k, v = _qkv(2, 64, 77, 2, d, seed=1)
    want = np.asarray(jax_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), interpret=True))
    np.testing.assert_allclose(
        want, np.asarray(xla_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v))), **TOL)
    got = attention(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_causal_masked_attention_matches_jax():
    from stable_diffusion_videos_tpu.ops.attention import \
        masked_attention as jax_masked
    q, k, v = _qkv(2, 77, 77, 2, 16, seed=2)
    want = np.asarray(jax_masked(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True))
    got = masked_attention(*map(torch.from_numpy, (q, k, v)),
                           causal=True).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shape", [(2, 64, 8, 8), (1, 320, 4, 4)],
                         ids=["cpg2", "cpg10"])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("silu", [True, False])
def test_groupnorm_matches_jax_kernel(shape, eps, silu):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(shape, dtype=np.float32) * 2 + 0.5)
    scale = rng.standard_normal(shape[1], dtype=np.float32)
    bias = rng.standard_normal(shape[1], dtype=np.float32)
    want = np.asarray(jax_groupnorm(
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(scale),
        jnp.asarray(bias), num_groups=32, eps=eps, silu=silu))
    got = fused_groupnorm_silu(torch.from_numpy(x), torch.from_numpy(scale),
                               torch.from_numpy(bias), 32, eps, silu).numpy()
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, **TOL)


def test_cpu_tensors_take_the_plain_versions():
    q = torch.randn(1, 8, 1, 4)
    x = torch.randn(1, 32, 2, 2)
    launches = (flash_attention.launches, fused_groupnorm_silu.launches)
    calls = (flash_attention_reference.calls, groupnorm_reference.calls)
    flash_attention(q, q, q)
    fused_groupnorm_silu(x, torch.ones(32), torch.zeros(32))
    assert (flash_attention.launches, fused_groupnorm_silu.launches) \
        == launches
    assert (flash_attention_reference.calls, groupnorm_reference.calls) \
        == (calls[0] + 1, calls[1] + 1)


def test_ops_reject_bad_shapes():
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 1, 8),
                        torch.zeros(1, 4, 1, 8))
    with pytest.raises(ValueError):
        fused_groupnorm_silu(torch.zeros(1, 30, 2, 2), torch.ones(30),
                             torch.zeros(30))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,sq,sk,h,d", [
    (2, 256, 256, 8, 40), (2, 256, 77, 8, 80), (2, 64, 77, 8, 160),
    (1, 1024, 1024, 1, 512), (2, 128, 77, 2, 20),
    # Sq not a multiple of the bf16 kernel's q tile (192 rows at D <= 80,
    # 128 at D=160, 64 at D=512), with ragged and with whole key tiles
    (2, 200, 77, 8, 40), (1, 300, 500, 2, 160), (1, 100, 256, 1, 512),
    (2, 1000, 1000, 4, 80)])
def test_flash_attention_kernel_matches_plain(cuda, dtype, tol, b, sq, sk, h,
                                              d):
    q, k, v = (torch.from_numpy(a).to(cuda, dtype)
               for a in _qkv(b, sq, sk, h, d, seed=4))
    got = flash_attention(q, k, v).float()
    want = flash_attention_reference(q, k, v).float()
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    # relative to the output's own size, which at long Sk is far below tol
    assert ((got - want).norm() / want.norm()).item() < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
# one shape on each path of the kernel: groups of 80 or 160 KB stay on chip
# (clusters of 4 or 7 blocks), as do groups of 60 or 120 KB and 160 or 320
# KB (clusters of 3 or 5, and 7 or 14); groups of 4 or 8 MB are streamed;
# 25-element channels are not 16-byte aligned and move element by element;
# 300 channels a group are more than an on-chip block has threads
@pytest.mark.parametrize("shape", [(2, 320, 64, 64), (2, 960, 32, 32),
                                   (2, 640, 64, 64), (1, 256, 512, 512),
                                   (2, 96, 5, 5), (1, 9600, 4, 4)],
                         ids=["on_chip", "cluster_of_3", "cluster_of_7",
                              "streamed", "unaligned", "wide_groups"])
@pytest.mark.parametrize("eps,silu", [(1e-5, True), (1e-6, False)])
@pytest.mark.parametrize("weights", ["fp32", "like_x"])
def test_groupnorm_kernel_matches_plain(cuda, dtype, tol, shape, eps, silu,
                                        weights):
    x = (torch.randn(shape, device=cuda) * 2 + 0.5).to(dtype)
    wdt = torch.float32 if weights == "fp32" else dtype
    scale, bias = torch.randn(shape[1], device=cuda).to(wdt), \
        torch.randn(shape[1], device=cuda).to(wdt)
    torch.testing.assert_close(
        fused_groupnorm_silu(x, scale, bias, 32, eps, silu).float(),
        groupnorm_reference(x, scale, bias, 32, eps, silu).float(),
        atol=tol, rtol=tol)
