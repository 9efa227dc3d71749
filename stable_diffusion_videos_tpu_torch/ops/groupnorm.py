"""GroupNorm(+SiLU) op: the hand-written CUDA kernel and its plain version.

Counterpart of ``stable_diffusion_videos_tpu/ops/groupnorm.py``.  The kernel
(``csrc/groupnorm.cu``) serves every ``GroupNorm32`` of the UNet and the
VAE decoder on the card.  Activations are NCHW, so one (item, group) pair is
one contiguous run of ``C/G·H·W`` elements.

Dispatch is by the tensor's device only: a CUDA tensor launches the kernel
(or raises), a CPU tensor takes ``groupnorm_reference``.
``fused_groupnorm_silu.launches`` counts the kernel's launches, and
``fused_groupnorm_silu.by_shape`` the same launches by ``(shape, eps, silu,
x dtype, weight dtype)``.
"""

from __future__ import annotations

import collections

import torch

from . import build


def groupnorm_reference(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, num_groups: int = 32,
                        eps: float = 1e-5, silu: bool = True) -> torch.Tensor:
    """Plain PyTorch GroupNorm(+SiLU), fp32 statistics (mean, then the mean
    of centred squares), output in x's dtype."""
    groupnorm_reference.calls += 1
    n, c = x.shape[:2]
    xf = x.float().reshape(n, num_groups, -1)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.ndim - 2)
    y = y * scale.float().reshape(shape) + bias.float().reshape(shape)
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


groupnorm_reference.calls = 0


def fused_groupnorm_silu(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, num_groups: int = 32,
                         eps: float = 1e-5, silu: bool = True) -> torch.Tensor:
    """(N, C, *spatial) -> GroupNorm(x)·scale + bias [-> SiLU], fp32
    statistics, in x's dtype.  No size limit and no fallback."""
    n, c = x.shape[:2]
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} "
                         "groups")
    if x.device.type == "cpu":
        return groupnorm_reference(x, scale, bias, num_groups, eps, silu)
    if x.device.type != "cuda":
        raise ValueError(f"no GroupNorm kernel for device {x.device}")
    if c // num_groups > 512:
        raise ValueError(f"the GroupNorm kernel takes at most 512 channels a "
                         f"group, got {c // num_groups}")
    lib = build.library()
    code = build.dtype_code(x)
    x = x.contiguous()
    hw = x.numel() // (n * c)
    if scale.numel() != c or bias.numel() != c:
        raise ValueError("scale and bias must have one value per channel")
    # the kernel reads fp32 or bf16 weights as they are (the model's are in
    # its dtype); any other dtype, or a pair of two dtypes, goes as fp32
    w_dtype = scale.dtype if scale.dtype == bias.dtype and scale.dtype in (
        torch.float32, torch.bfloat16) else torch.float32
    scale, bias = (w.detach().to(x.device, w_dtype).contiguous()
                   for w in (scale, bias))
    y = torch.empty_like(x)
    err = lib.sdv_groupnorm_silu(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        build.DTYPE_CODES[str(w_dtype)], y.data_ptr(), n, c, hw, num_groups,
        float(eps), int(silu), code,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "groupnorm kernel")
    fused_groupnorm_silu.launches += 1
    fused_groupnorm_silu.by_shape[(tuple(x.shape), float(eps), bool(silu),
                                   x.dtype, w_dtype)] += 1
    return y


fused_groupnorm_silu.launches = 0
fused_groupnorm_silu.by_shape = collections.Counter()
