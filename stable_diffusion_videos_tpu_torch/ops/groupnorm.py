"""GroupNorm(+SiLU) op: the hand-written CUDA kernels and their plain versions.

Counterpart of ``stable_diffusion_videos_tpu/ops/groupnorm.py``.  The kernel
(``csrc/groupnorm.cu``) serves every ``GroupNorm32`` of the UNet and the
VAE on the card.  Activations are NCHW, so one (item, group) pair is one
contiguous run of ``C/G·H·W`` elements.

Dispatch is by the tensor's device only: a CUDA tensor launches the kernel
(or raises), a CPU tensor takes ``groupnorm_reference``, through which
autograd differentiates.  On the card a call that needs a gradient goes
through ``GroupNormFunction``, whose backward launches the backward kernel
(``csrc/groupnorm_backward.cu``, ``groupnorm_silu_backward``: one cluster
launch for dx and the per-channel sums, one small launch for dγ and dβ); it
never takes the plain math there.  The JAX package's trainers differentiate flax's
``nn.GroupNorm`` with XLA, which the plain backward
``groupnorm_backward_reference`` writes out.

``fused_groupnorm_silu.launches`` counts the forward kernel's launches, and
``fused_groupnorm_silu.by_shape`` the same launches by ``(shape, eps, silu,
x dtype, weight dtype)``; ``groupnorm_silu_backward`` has the same two
counters.
"""

from __future__ import annotations

import collections

import torch

from . import build


def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    """fp32 for bf16 and fp32 inputs; fp64 stays fp64 (gradient checks)."""
    return torch.promote_types(t.dtype, torch.float32)


def _check(x, scale, bias, num_groups) -> None:
    c = x.shape[1]
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} "
                         "groups")
    if scale.numel() != c or bias.numel() != c:
        raise ValueError("scale and bias must have one value per channel")


def groupnorm_reference(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, num_groups: int = 32,
                        eps: float = 1e-5, silu: bool = True) -> torch.Tensor:
    """Plain PyTorch GroupNorm(+SiLU), fp32 statistics (mean, then the mean
    of centred squares), output in x's dtype."""
    groupnorm_reference.calls += 1
    n, c = x.shape[:2]
    ct = _compute_dtype(x)
    xf = x.to(ct).reshape(n, num_groups, -1)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.ndim - 2)
    y = y * scale.to(ct).reshape(shape) + bias.to(ct).reshape(shape)
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


groupnorm_reference.calls = 0


def groupnorm_backward_reference(x, scale, bias, dy, num_groups: int = 32,
                                 eps: float = 1e-5,
                                 silu: bool = True) -> tuple:
    """Plain backward of GroupNorm(+SiLU), written out in fp32: the group
    statistics again, SiLU's derivative σ(y)·(1 + y·(1 - σ(y))) on the
    cotangent g, then dx = rstd·(g·γ - mean(g·γ) - x̂·mean(g·γ·x̂)) over
    each group, dγ = Σ g·x̂ and dβ = Σ g.  -> (dx in x's dtype, dscale and
    dbias in the weights' dtypes)."""
    groupnorm_backward_reference.calls += 1
    n, c = x.shape[:2]
    ct = _compute_dtype(x)
    xf = x.to(ct).reshape(n, num_groups, -1)
    mean = xf.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((xf - mean).square().mean(dim=-1, keepdim=True) + eps)
    xhat = ((xf - mean) * rstd).reshape(n, c, -1)
    gamma = scale.to(ct).reshape(1, c, 1)
    g = dy.to(ct).reshape(n, c, -1)
    if silu:
        y = xhat * gamma + bias.to(ct).reshape(1, c, 1)
        sig = torch.sigmoid(y)
        g = g * sig * (1 + y * (1 - sig))
    dscale, dbias = (g * xhat).sum((0, 2)), g.sum((0, 2))
    gg = (g * gamma).reshape(n, num_groups, -1)
    xh = xhat.reshape(n, num_groups, -1)
    dx = rstd * (gg - gg.mean(-1, keepdim=True)
                 - xh * (gg * xh).mean(-1, keepdim=True))
    return (dx.reshape(x.shape).to(x.dtype), dscale.to(scale.dtype),
            dbias.to(bias.dtype))


groupnorm_backward_reference.calls = 0


def _weight_dtype(scale, bias) -> torch.dtype:
    """The kernel reads fp32 or bf16 weights as they are (the model's are in
    its dtype); any other dtype, or a pair of two dtypes, goes as fp32."""
    return scale.dtype if scale.dtype == bias.dtype and scale.dtype in (
        torch.float32, torch.bfloat16) else torch.float32


def _as(t: torch.Tensor, dtype: torch.dtype, device=None) -> torch.Tensor:
    """t in dtype (on device, if given), itself when it already is: no
    call, which costs microseconds of host time a launch."""
    device = t.device if device is None else device
    return t if t.dtype == dtype and t.device == device else t.to(device,
                                                                   dtype)


def _forward(x, scale, bias, num_groups, eps, silu):
    """One forward call by x's device: the kernel or the plain version."""
    if x.device.type == "cpu":
        return groupnorm_reference(x, scale, bias, num_groups, eps, silu)
    if x.device.type != "cuda":
        raise ValueError(f"no GroupNorm kernel for device {x.device}")
    n, c = x.shape[:2]
    if c // num_groups > 512:
        raise ValueError(f"the GroupNorm kernel takes at most 512 channels a "
                         f"group, got {c // num_groups}")
    lib = build.library()
    code = build.dtype_code(x)
    x = x.contiguous()
    hw = x.numel() // (n * c)
    w_dtype = _weight_dtype(scale, bias)
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


def groupnorm_silu_backward(x, scale, bias, dy, num_groups: int = 32,
                            eps: float = 1e-5, silu: bool = True) -> tuple:
    """(dx, dscale, dbias) of GroupNorm(+SiLU) given the output's cotangent
    ``dy``, by x's device: the backward kernel on the card (x float32 or
    bfloat16), the plain backward on the CPU.  dx comes in x's dtype,
    dscale and dbias in the weights' dtypes."""
    _check(x, scale, bias, num_groups)
    if x.device.type == "cpu":
        return groupnorm_backward_reference(x, scale, bias, dy, num_groups,
                                            eps, silu)
    if x.device.type != "cuda":
        raise ValueError(f"no GroupNorm kernel for device {x.device}")
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} is not x's shape "
                         f"{tuple(x.shape)}")
    lib = build.library()
    code = build.dtype_code(x)
    n, c = x.shape[:2]
    x, dy = x.contiguous(), _as(dy, x.dtype).contiguous()
    hw = x.numel() // (n * c)
    # the kernel reads the weights and writes their gradients in their own
    # dtype (fp32 or bf16), so no cast runs around it
    w_dtype = _weight_dtype(scale, bias)
    ws, wb = (_as(w.detach(), w_dtype, x.device).contiguous()
              for w in (scale, bias))
    dx = torch.empty_like(x)
    dscale, dbias = torch.empty(2, c, device=x.device, dtype=w_dtype).unbind()
    scratch = torch.empty(
        lib.sdv_groupnorm_backward_scratch(n, c, hw, num_groups),
        device=x.device, dtype=torch.float32)
    err = lib.sdv_groupnorm_silu_backward(
        x.data_ptr(), dy.data_ptr(), ws.data_ptr(), wb.data_ptr(),
        build.DTYPE_CODES[str(w_dtype)], dx.data_ptr(), dscale.data_ptr(),
        dbias.data_ptr(), scratch.data_ptr(), n, c, hw, num_groups,
        float(eps), int(silu), code,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "groupnorm backward kernel")
    groupnorm_silu_backward.launches += 1
    groupnorm_silu_backward.by_shape[(tuple(x.shape), float(eps), bool(silu),
                                      x.dtype, w_dtype)] += 1
    return dx, _as(dscale, scale.dtype), _as(dbias, bias.dtype)


groupnorm_silu_backward.launches = 0
groupnorm_silu_backward.by_shape = collections.Counter()


class GroupNormFunction(torch.autograd.Function):
    """GroupNorm(+SiLU) with its gradient: the forward and the backward
    each by x's device (the kernels on the card, the plain versions on the
    CPU, where this serves the gradient checks)."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, silu):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (num_groups, eps, silu)
        return _forward(x, scale, bias, num_groups, eps, silu)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, scale, bias = ctx.saved_tensors
        dx, dscale, dbias = groupnorm_silu_backward(x, scale, bias, dy,
                                                    *ctx.args)
        return (dx, dscale.reshape(scale.shape), dbias.reshape(bias.shape),
                None, None, None)


def fused_groupnorm_silu(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, num_groups: int = 32,
                         eps: float = 1e-5, silu: bool = True) -> torch.Tensor:
    """(N, C, *spatial) -> GroupNorm(x)·scale + bias [-> SiLU], fp32
    statistics, in x's dtype.  No size limit and no fallback."""
    _check(x, scale, bias, num_groups)
    if x.device.type == "cpu":
        return groupnorm_reference(x, scale, bias, num_groups, eps, silu)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return GroupNormFunction.apply(x, scale, bias, num_groups, eps, silu)
    return _forward(x, scale, bias, num_groups, eps, silu)


fused_groupnorm_silu.launches = 0
fused_groupnorm_silu.by_shape = collections.Counter()
