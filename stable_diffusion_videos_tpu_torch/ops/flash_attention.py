"""Flash attention op: the hand-written CUDA kernels and their plain versions.

Counterpart of ``stable_diffusion_videos_tpu/ops/flash_attention.py``.  The
kernel (``csrc/flash_attention.cu``) serves every UNet self- and
cross-attention and the VAE mid-block attention on the card.  Shapes follow
the JAX package: q ``(B, Sq, H, D)``, k/v ``(B, Sk, H, D)``.

Dispatch is by the tensor's device only: a CUDA tensor launches the kernel
(or raises), a CPU tensor takes ``flash_attention_reference``, through which
autograd differentiates.  On the card a call that needs a gradient goes
through ``FlashAttentionFunction``, whose backward launches the backward
kernel (``csrc/attention_backward.cu``, ``flash_attention_backward``); it
never takes the plain math there.  The JAX package's Pallas kernel has no
backward: its trainers differentiate ``xla_attention`` with XLA, which the
plain backward ``flash_attention_backward_reference`` writes out.

``flash_attention.launches`` counts the forward kernel's launches and
``flash_attention.by_shape`` the same launches by ``(B, Sq, Sk, H, D,
dtype)``; ``flash_attention_backward`` has the same two counters.
"""

from __future__ import annotations

import collections

import torch

from . import build


def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    """fp32 for bf16 and fp32 inputs; fp64 stays fp64 (gradient checks)."""
    return torch.promote_types(t.dtype, torch.float32)


def _check(q, k, v) -> None:
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[2:] != (h, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share one dtype")


def _contiguous(*ts):
    """Contiguous and 16-byte aligned (the bf16 path's TMA loads)."""
    return [t if t.is_contiguous() and t.data_ptr() % 16 == 0
            else t.clone(memory_format=torch.contiguous_format) for t in ts]


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              scale: float | None = None) -> torch.Tensor:
    """Plain PyTorch attention: fp32 scores, fp32 softmax, fp32 product,
    output in q's dtype."""
    flash_attention_reference.calls += 1
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    ct = _compute_dtype(q)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(ct), k.to(ct)) * scale
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.to(ct)).to(q.dtype)


flash_attention_reference.calls = 0


def flash_attention_backward_reference(q, k, v, o, do,
                                       scale: float | None = None) -> tuple:
    """Plain backward of attention, written out: the scores in fp32, each
    row's log-sum-exp, P = exp(s - lse), D_i = rowsum(do∘o), dP = do·vᵀ,
    dS = P∘(dP - D_i); dq = dS·k·scale, dk = dSᵀ·q·scale, dv = Pᵀ·do, each
    in its input's dtype."""
    flash_attention_backward_reference.calls += 1
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    ct = _compute_dtype(q)
    qf, kf, vf, of, dof = (t.to(ct) for t in (q, k, v, o, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    delta = (dof * of).sum(-1).transpose(1, 2)[..., None]  # (B, H, Sq, 1)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


flash_attention_backward_reference.calls = 0


def _forward(q, k, v, scale):
    """One forward call by the inputs' device: the kernel or the plain
    version."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    b, sq, h, d = q.shape
    if q.dtype == torch.bfloat16 and d > 512:
        raise ValueError(f"the bf16 attention kernel takes D <= 512, got {d}")
    lib = build.library()
    code = build.dtype_code(q)
    scale = float(scale) if scale is not None else d ** -0.5
    # the bf16 (TMA) path needs rows of a multiple of 16 bytes: zero columns
    # add nothing to q·kᵀ, and give output columns that are cut off below
    pad = -d % 8 if q.dtype == torch.bfloat16 else 0
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v))
    q, k, v = _contiguous(q, k, v)
    o = torch.empty_like(q)
    err = lib.sdv_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq,
        k.shape[1], h, d + pad, scale, code,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash attention kernel")
    flash_attention.launches += 1
    flash_attention.by_shape[(b, sq, k.shape[1], h, d, q.dtype)] += 1
    return o[..., :d].contiguous() if pad else o


def flash_attention_backward(q, k, v, o, do,
                             scale: float | None = None) -> tuple:
    """(dq, dk, dv) of attention, given its output ``o`` and the output's
    cotangent ``do``, by the inputs' device: the backward kernel on the card
    (float32 or bfloat16, D <= 512), the plain backward on the CPU."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, o, do, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    b, sq, h, d = q.shape
    if d > 512:
        raise ValueError(f"the attention backward kernel takes D <= 512, "
                         f"got {d}")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"be q's shape {tuple(q.shape)}")
    lib = build.library()
    code = build.dtype_code(q)
    scale = float(scale) if scale is not None else d ** -0.5
    q, k, v, o, do = _contiguous(q, k, v, o, do.to(q.dtype))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    stats = torch.empty(2, b * h * sq, device=q.device, dtype=torch.float32)
    err = lib.sdv_flash_attention_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats[0].data_ptr(),
        stats[1].data_ptr(), b, sq, k.shape[1], h, d, scale, code,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash attention backward kernel")
    flash_attention_backward.launches += 1
    flash_attention_backward.by_shape[(b, sq, k.shape[1], h, d, q.dtype)] += 1
    return dq, dk, dv


flash_attention_backward.launches = 0
flash_attention_backward.by_shape = collections.Counter()


class FlashAttentionFunction(torch.autograd.Function):
    """Attention with its gradient: the forward and the backward each by
    the inputs' device (the kernels on the card, the plain versions on the
    CPU, where this serves the gradient checks)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o = _forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o)
        ctx.scale = scale
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        return (*flash_attention_backward(q, k, v, o, do, ctx.scale), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None) -> torch.Tensor:
    """Non-causal softmax(q·kᵀ·scale)·v; scale defaults to ``D**-0.5``.
    Any Sk (ragged key tiles are masked in the kernel); on the card any D
    in float32 and D <= 512 in bfloat16, and D <= 512 where a gradient is
    taken."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, scale)
    return _forward(q, k, v, scale)


flash_attention.launches = 0
flash_attention.by_shape = collections.Counter()
