"""Flash attention op: the hand-written CUDA kernel and its plain version.

Counterpart of ``stable_diffusion_videos_tpu/ops/flash_attention.py``.  The
kernel (``csrc/flash_attention.cu``) serves every UNet self- and
cross-attention and the VAE mid-block attention on the card.  Shapes follow
the JAX package: q ``(B, Sq, H, D)``, k/v ``(B, Sk, H, D)``.

Dispatch is by the tensor's device only: a CUDA tensor launches the kernel
(or raises), a CPU tensor takes ``flash_attention_reference``.
``flash_attention.launches`` counts the kernel's launches, and
``flash_attention.by_shape`` the same launches by ``(B, Sq, Sk, H, D,
dtype)``.
"""

from __future__ import annotations

import collections

import torch

from . import build


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              scale: float | None = None) -> torch.Tensor:
    """Plain PyTorch attention: fp32 scores, fp32 softmax, fp32 product,
    output in q's dtype."""
    flash_attention_reference.calls += 1
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


flash_attention_reference.calls = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None) -> torch.Tensor:
    """Non-causal softmax(q·kᵀ·scale)·v; scale defaults to ``D**-0.5``.
    Any Sk (ragged key tiles are masked in the kernel); on the card any D
    in float32 and D <= 512 in bfloat16."""
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[2:] != (h, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share one dtype")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
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
    # contiguous, and 16-byte aligned for the bf16 path's TMA loads
    q, k, v = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
               else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    o = torch.empty_like(q)
    err = lib.sdv_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq,
        k.shape[1], h, d + pad, scale, code,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash attention kernel")
    flash_attention.launches += 1
    flash_attention.by_shape[(b, sq, k.shape[1], h, d, q.dtype)] += 1
    return o[..., :d].contiguous() if pad else o


flash_attention.launches = 0
flash_attention.by_shape = collections.Counter()
