"""Flash attention op: the hand-written CUDA kernels and their plain versions.

Counterpart of ``stable_diffusion_videos_tpu/ops/flash_attention.py``.  The
kernel (``csrc/flash_attention.cu``) serves every UNet self- and
cross-attention and the VAE mid-block attention on the card.  Shapes follow
the JAX package: q ``(B, Sq, H, D)``, k/v ``(B, Sk, H, D)``.

Dispatch is by the tensor's device only: a CUDA tensor launches the kernel
(or raises), a CPU tensor takes ``flash_attention_reference``, through which
autograd differentiates.  On the card a call that needs a gradient goes
through ``FlashAttentionFunction``: its forward also keeps each row's
log-sum-exp (log2 domain, ``(B, H, Sq)``), and its backward launches the
backward kernels (``csrc/attention_backward.cu``, ``flash_attention_backward``)
with it; it never takes the plain math there.  The JAX package's Pallas
kernel has no backward: its trainers differentiate ``xla_attention`` with
XLA, which the plain backward ``flash_attention_backward_reference`` writes
out.

The backward's route is chosen by dtype and depth before any launch:
``"fused"`` for bf16 up to D=80, ``"materialised"`` above (its q rows in
the chunks of ``materialised_chunks``; ``materialised_backward_reference``
runs the same plan through the plain math), ``"fma"`` for float32 or when
``sdv_attention_backward_tensor_cores(0)`` is set.

``flash_attention.launches`` counts the forward kernel's launches and
``flash_attention.by_shape`` the same launches by ``(B, Sq, Sk, H, D,
dtype)``; ``flash_attention_backward`` has the same two counters and
``by_route``, its calls by route (``"fused"`` with its q loop split over
blocks also counts ``"fused_split"``; a call without a saved log-sum-exp
counts ``"lse_pass"`` for the forward kernel it runs to get one).
"""

from __future__ import annotations

import collections

import torch

from . import build


#: log2(e): the log-sum-exp is kept in the log2 domain, as the kernels
#: exponentiate with exp2
LOG2E = 1.4426950408889634
#: bytes of P and dS (bf16) the materialised route holds at once before it
#: cuts the q rows into chunks
MATERIALISED_CAP = 512 << 20
#: q rows of the materialised route's tiles; keys are padded to the same
_TILE = 128


def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    """fp32 for bf16 and fp32 inputs; fp64 stays fp64 (gradient checks)."""
    return torch.promote_types(t.dtype, torch.float32)


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t in dtype, itself when it already is (no call: microseconds of
    host time a launch)."""
    return t if t.dtype == dtype else t.to(dtype)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _padded_depth(d: int) -> int:
    """The depth a bf16 head of size d runs at (csrc's padded_depth)."""
    return next(p for p in (48, 64, 80, 160, 512) if d <= p)


def _stat_ld(sq: int) -> int:
    """Row stride of the per-row statistics on the card (csrc's stat_ld):
    Sq rounded up to 4 values, so every row starts on 16 bytes."""
    return _round_up(sq, 4)


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
                              v: torch.Tensor, scale: float | None = None,
                              return_lse: bool = False):
    """Plain PyTorch attention: fp32 scores, fp32 softmax, fp32 product,
    output in q's dtype.  With ``return_lse``, also each row's log-sum-exp
    of the scaled scores in the log2 domain, ``(B, H, Sq)`` in the compute
    dtype: ``(o, lse)``."""
    flash_attention_reference.calls += 1
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    ct = _compute_dtype(q)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(ct), k.to(ct)) * scale
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(ct)).to(q.dtype)
    if not return_lse:
        return o
    return o, torch.logsumexp(logits, dim=-1) * LOG2E


flash_attention_reference.calls = 0


def _probabilities(s, lse):
    """P from the scaled scores s (B, H, Sq, Sk) and, if given, the rows'
    log-sum-exp in the log2 domain."""
    if lse is None:
        return torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    return torch.exp2(s * LOG2E - lse.to(s.dtype)[..., None])


def flash_attention_backward_reference(q, k, v, o, do,
                                       scale: float | None = None,
                                       lse=None) -> tuple:
    """Plain backward of attention, written out: the scores in fp32,
    P = exp(s - lse) (each row's log-sum-exp computed here, or the
    forward's ``lse``, log2 domain), D_i = rowsum(do∘o), dP = do·vᵀ,
    dS = P∘(dP - D_i); dq = dS·k·scale, dk = dSᵀ·q·scale, dv = Pᵀ·do, each
    in its input's dtype."""
    flash_attention_backward_reference.calls += 1
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    ct = _compute_dtype(q)
    qf, kf, vf, of, dof = (t.to(ct) for t in (q, k, v, o, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = _probabilities(s, lse)
    delta = (dof * of).sum(-1).transpose(1, 2)[..., None]  # (B, H, Sq, 1)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


flash_attention_backward_reference.calls = 0


def materialised_chunks(bh: int, sq: int, sk: int,
                        cap: int = MATERIALISED_CAP) -> list:
    """The materialised route's q-row chunks ``[(r0, r1), ...]``: whole
    tiles of 128 rows whose P and dS (bf16, keys padded to 128) fit ``cap``
    bytes, at least one tile a chunk; one chunk when every row fits."""
    rows = max(_TILE, cap // (4 * bh * _round_up(sk, _TILE)) // _TILE * _TILE)
    return [(r0, min(sq, r0 + rows)) for r0 in range(0, sq, rows)]


def _run_chunks(chunk, chunks) -> None:
    """Each chunk in order, told whether it is the first and the last: dk
    and dv are summed over the chunks in this order."""
    for i, (r0, r1) in enumerate(chunks):
        chunk(r0, r1, i == 0, i == len(chunks) - 1)


def materialised_backward_reference(q, k, v, o, do,
                                    scale: float | None = None, lse=None,
                                    cap: int = MATERIALISED_CAP) -> tuple:
    """The materialised route's plan run through the plain math: for each
    chunk of q rows (``materialised_chunks``), P and dS of those rows, dq
    of those rows, and dk, dv summed over the chunks in order, as the
    kernels sum them in fp32 scratch."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    ct = _compute_dtype(q)
    qf, kf, vf, of, dof = (t.to(ct) for t in (q, k, v, o, do))
    b, sq, h, _ = q.shape
    if lse is None:
        lse = flash_attention_reference(q, k, v, scale, return_lse=True)[1]
    delta = (dof * of).sum(-1).transpose(1, 2)[..., None]
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)

    def chunk(r0, r1, first, last):
        s = torch.einsum("bqhd,bkhd->bhqk", qf[:, r0:r1], kf) * scale
        p = _probabilities(s, lse[:, :, r0:r1])
        ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof[:, r0:r1], vf)
                  - delta[:, :, r0:r1])
        dq[:, r0:r1] = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
        dk.add_(torch.einsum("bhqk,bqhd->bkhd", ds, qf[:, r0:r1]))
        dv.add_(torch.einsum("bhqk,bqhd->bkhd", p, dof[:, r0:r1]))
    _run_chunks(chunk, materialised_chunks(b * h, sq, k.shape[1], cap))
    return dq.to(q.dtype), (dk * scale).to(k.dtype), dv.to(v.dtype)


def _launch_forward(lib, q, k, v, o, lse, scale, code):
    b, sq, h, d = q.shape
    err = lib.sdv_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        0 if lse is None else lse.data_ptr(), b, sq, k.shape[1], h, d, scale,
        code, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash attention kernel")


def _forward(q, k, v, scale, with_lse: bool = False):
    """One forward call by the inputs' device: the kernel or the plain
    version.  With ``with_lse``, ``(o, lse)``: each row's log-sum-exp for
    the backward (log2 domain, ``(B, H, Sq)``; on the card a view of rows
    padded to ``_stat_ld(Sq)``, and None for float32, whose backward takes
    its own)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale, return_lse=with_lse)
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
    lse = None
    if with_lse and q.dtype == torch.bfloat16:
        lse = torch.empty(b, h, _stat_ld(sq), device=q.device,
                          dtype=torch.float32)
    _launch_forward(lib, q, k, v, o, lse, scale, code)
    flash_attention.launches += 1
    flash_attention.by_shape[(b, sq, k.shape[1], h, d, q.dtype)] += 1
    o = o[..., :d].contiguous() if pad else o
    if not with_lse:
        return o
    return o, None if lse is None else lse[..., :sq]


def _stat_rows(t, b, h, sq):
    """fp32 per-row statistics (B, H, Sq) as the kernels read them: rows
    ``_stat_ld(Sq)`` apart, 16-byte aligned (a copy unless ``t`` is the
    forward's own view)."""
    ld = _stat_ld(sq)
    if (t.dtype == torch.float32 and t.shape == (b, h, sq)
            and t.stride() == (h * ld, ld, 1) and t.data_ptr() % 16 == 0):
        return t
    buf = torch.zeros(b, h, ld, device=t.device, dtype=torch.float32)
    buf[..., :sq] = t
    return buf[..., :sq]


def _route(lib, q) -> str:
    """The backward's route, by dtype and depth (before any launch)."""
    if (q.dtype != torch.bfloat16
            or not lib.sdv_attention_backward_tensor_cores(-1)):
        return "fma"
    return "fused" if _padded_depth(q.shape[-1]) <= 80 else "materialised"


def _splits(q, sk) -> int:
    """Blocks a (b, h) the fused dk/dv kernel splits its q loop over: with
    Sk <= 128 there is one key block a (b, h), so enough to fill the card's
    SMs (one block an SM), else 1."""
    b, sq, h, _ = q.shape
    if sk > _TILE:
        return 1
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    tiles = -(-sq // 64)
    per = -(-tiles // min(tiles, -(-sms // (b * h))))
    return -(-tiles // per)


def _backward_tensor_cores(lib, route, q, k, v, o, do, lse, scale):
    """The bf16 routes on padded, contiguous inputs; -> (dq, dk, dv)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if lse is None:
        # the forward kernel, its output thrown away, as the LSE pass
        lse = torch.empty(b, h, _stat_ld(sq), device=q.device,
                          dtype=torch.float32)
        _launch_forward(lib, q, k, v, torch.empty_like(q), lse, scale,
                        build.dtype_code(q))
        flash_attention_backward.by_route["lse_pass"] += 1
    else:
        lse = _stat_rows(lse, b, h, sq)
    delta = torch.empty(b, h, _stat_ld(sq), device=q.device,
                        dtype=torch.float32)
    build.check(lib.sdv_attention_backward_delta(
        o.data_ptr(), do.data_ptr(), delta.data_ptr(), b, sq, h, d, stream),
        "attention backward D_i pass")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dp = _padded_depth(d)
    if route == "fused":
        splits = _splits(q, sk)
        partial = (torch.empty(2 * splits * b * h * _TILE * dp,
                               device=q.device, dtype=torch.float32)
                   if splits > 1 else None)
        build.check(lib.sdv_attention_backward_fused(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), 0 if partial is None else partial.data_ptr(), b,
            sq, sk, h, d, scale, splits, stream),
            "attention backward (fused)")
        if splits > 1:
            flash_attention_backward.by_route["fused_split"] += 1
        return dq, dk, dv
    chunks = materialised_chunks(b * h, sq, sk)
    skp = _round_up(sk, _TILE)
    rows_p = _round_up(chunks[0][1] - chunks[0][0], _TILE)
    scores = torch.empty(2, b * h, rows_p, skp, device=q.device,
                         dtype=torch.bfloat16)
    acc = (torch.empty(2, b * h, skp, dp, device=q.device,
                       dtype=torch.float32) if len(chunks) > 1 else None)

    def chunk(r0, r1, first, last):
        build.check(lib.sdv_attention_backward_chunk(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), scores[0].data_ptr(),
            scores[1].data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            0 if acc is None else acc.data_ptr(), b, sq, sk, h, d, r0,
            _round_up(r1 - r0, _TILE), skp, scale, int(first), int(last),
            stream), "attention backward (materialised)")
    _run_chunks(chunk, chunks)
    return dq, dk, dv


def flash_attention_backward(q, k, v, o, do, scale: float | None = None,
                             lse=None) -> tuple:
    """(dq, dk, dv) of attention, given its output ``o``, the output's
    cotangent ``do`` and, if kept, the forward's per-row log-sum-exp
    ``lse`` (log2 domain, ``(B, H, Sq)``), by the inputs' device: the
    backward kernels on the card (float32 or bfloat16, D <= 512), the plain
    backward on the CPU.  Without ``lse`` the bf16 routes run the forward
    kernel once to get it."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, o, do, scale, lse)
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
    route = _route(lib, q)
    if route == "fma":
        q, k, v, o, do = _contiguous(q, k, v, o, _as(do, q.dtype))
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        stats = torch.empty(2, b * h * sq, device=q.device,
                            dtype=torch.float32)
        err = lib.sdv_flash_attention_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            stats[0].data_ptr(), stats[1].data_ptr(), b, sq, k.shape[1], h,
            d, scale, code, torch.cuda.current_stream(q.device).cuda_stream)
        build.check(err, "flash attention backward kernel")
    else:
        # every bf16 call on the tensor cores: a depth that is not a
        # multiple of 8 gets zero columns, as the forward's, cut off below
        pad = -d % 8
        ts = (q, k, v, o, _as(do, q.dtype))
        if pad:
            ts = (torch.nn.functional.pad(t, (0, pad)) for t in ts)
        dq, dk, dv = _backward_tensor_cores(lib, route, *_contiguous(*ts),
                                            lse, scale)
        if pad:
            dq, dk, dv = (t[..., :d].contiguous() for t in (dq, dk, dv))
    flash_attention_backward.launches += 1
    flash_attention_backward.by_shape[(b, sq, k.shape[1], h, d, q.dtype)] += 1
    flash_attention_backward.by_route[route] += 1
    return dq, dk, dv


flash_attention_backward.launches = 0
flash_attention_backward.by_shape = collections.Counter()
flash_attention_backward.by_route = collections.Counter()


class FlashAttentionFunction(torch.autograd.Function):
    """Attention with its gradient: the forward and the backward each by
    the inputs' device (the kernels on the card, the plain versions on the
    CPU, where this serves the gradient checks); the forward keeps each
    row's log-sum-exp for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = _forward(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*flash_attention_backward(q, k, v, o, do, ctx.scale, lse),
                None)


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, scale: float | None = None):
    """The forward a gradient's forward runs, without autograd: ``(o,
    lse)``, ``lse`` each row's log-sum-exp (log2 domain, ``(B, H, Sq)``)
    for ``flash_attention_backward``, or None in float32 on the card."""
    _check(q, k, v)
    return _forward(q, k, v, scale, with_lse=True)


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
