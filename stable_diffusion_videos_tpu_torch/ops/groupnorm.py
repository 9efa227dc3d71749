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
x dtype, weight dtype, groups)``; ``groupnorm_silu_backward`` has the same
two counters.

The split-statistics GroupNorm (``split_groupnorm_silu``) serves a tensor
whose groups span several ranks' slabs (the spatially sharded UNet,
``parallel/spatial.py``): ``groupnorm_partials`` takes each (item, group)
run's Welford partial (count, mean, M2) of the local slab, the caller
all-gathers them, and ``groupnorm_apply`` merges the ranks' partials in
rank order (Chan's formula) and normalises, scales, shifts and applies the
SiLU.  Each has its kernel (``csrc/groupnorm.cu``) and its plain version,
dispatched by device as above, with ``launches`` and ``by_shape`` counters
(``(shape, silu, x dtype, weight dtype, groups, parts)`` for the apply).
On the card each builds a launch plan at the first call of a key (the
shapes, dtypes, groups, parts, eps, silu and card: ``partials_geometry``,
``apply_geometry``), and a call then checks only what can differ (the
devices, contiguity, the partials' shape) and hands the kernel the plan's
address, the tensors' pointers and the current stream.
"""

from __future__ import annotations

import collections
import ctypes
import math

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
                                   x.dtype, w_dtype, num_groups)] += 1
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
                                      x.dtype, w_dtype, num_groups)] += 1
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


# ---------------------------------------------------------------------------
# split statistics: a group spread over several ranks' slabs
# ---------------------------------------------------------------------------
def groupnorm_partials_reference(x: torch.Tensor,
                                 num_groups: int = 32) -> torch.Tensor:
    """Plain per-(item, group) moments of x: (N, G, 3) fp32 rows of (count,
    mean, M2), M2 the sum of squares about the mean."""
    groupnorm_partials_reference.calls += 1
    n = x.shape[0]
    xf = x.to(_compute_dtype(x)).reshape(n, num_groups, -1)
    mean = xf.mean(dim=-1)
    m2 = (xf - mean[..., None]).square().sum(dim=-1)
    count = torch.full_like(mean, xf.shape[-1])
    return torch.stack([count, mean, m2], dim=-1).float()


groupnorm_partials_reference.calls = 0


def merge_partials(parts: torch.Tensor) -> tuple:
    """(P, N, G, 3) partials -> (mean, var) of each group, (N, G) each,
    merged in order p = 0, 1, ... with Chan's formula, in fp32."""
    n, mean, m2 = parts[0].unbind(-1)
    for p in range(1, parts.shape[0]):
        nb, mb, m2b = parts[p].unbind(-1)
        tot = n + nb
        delta = mb - mean
        wb = nb / tot
        mean, m2 = mean + delta * wb, m2 + m2b + delta * delta * n * wb
        n = tot
    return mean, m2 / n


def groupnorm_apply_reference(x: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor, parts: torch.Tensor,
                              num_groups: int = 32, eps: float = 1e-5,
                              silu: bool = True) -> torch.Tensor:
    """Plain apply pass: the ranks' partials (P, N, G, 3) merged in rank
    order, then (x - mean)·rstd·scale + bias [-> SiLU], in x's dtype."""
    groupnorm_apply_reference.calls += 1
    n, c = x.shape[:2]
    ct = _compute_dtype(x)
    mean, var = merge_partials(parts.float())
    mean, rstd = mean[..., None].to(ct), torch.rsqrt(var + eps)[..., None]
    xf = x.to(ct).reshape(n, num_groups, -1)
    y = ((xf - mean) * rstd.to(ct)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.ndim - 2)
    y = y * scale.to(ct).reshape(shape) + bias.to(ct).reshape(shape)
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


groupnorm_apply_reference.calls = 0


# ---------------------------------------------------------------------------
# split statistics: the kernels' launch plans, built once a key
# ---------------------------------------------------------------------------
#: routes (``SPLIT_*`` in csrc/groupnorm.cu): element by element (rows not
#: 16-byte aligned), a warp a run and a cluster of blocks a run (partials),
#: tiles of channel rows (apply)
ELEMENT, WARP, BLOCK, TILE = 0, 1, 2, 3
SPLIT_THREADS = 256
MAX_CLUSTER = 8
#: partials: a run of at most WARP_RUN_BYTES goes to one warp (one round
#: of its lanes' 8 loads); a longer run is split over a cluster when there
#: are fewer runs than SMs, each block owning at least MIN_SLICE_BYTES
#: (sizes chosen on the card, H100 SXM: PERF.md)
WARP_RUN_BYTES = 4 << 10
MIN_SLICE_BYTES = 32 << 10
#: apply: tiles of at most APPLY_TILE_BYTES, a channel a thread at most, and
#: at least TILES_PER_SM a card's SM where the slab allows
APPLY_TILE_BYTES = 32 << 10
TILES_PER_SM = 4


class PartialsPlan(ctypes.Structure):
    """``PartialsPlan`` of csrc/groupnorm.cu, field for field."""
    _fields_ = ([("hw", ctypes.c_longlong), ("slice", ctypes.c_longlong)]
                + [(f, ctypes.c_int) for f in (
                    "n", "c", "g", "dtype", "route", "grid", "threads",
                    "cluster")])


class ApplyPlan(ctypes.Structure):
    """``ApplyPlan`` of csrc/groupnorm.cu, field for field."""
    _fields_ = ([("hw", ctypes.c_longlong), ("tiles", ctypes.c_longlong)]
                + [(f, ctypes.c_int) for f in (
                    "n", "c", "g", "dtype", "w_dtype", "parts", "silu")]
                + [("eps", ctypes.c_float)]
                + [(f, ctypes.c_int) for f in (
                    "route", "rows", "cols", "col_tiles", "chan_tiles")])


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, m: int) -> int:
    return _cdiv(a, m) * m


def partials_geometry(shape, elem_bytes: int, num_groups: int,
                      sms: int) -> dict:
    """The partials kernel's launch geometry for a slab of ``shape`` (N, C,
    *spatial) of ``elem_bytes`` elements on a card of ``sms`` SMs:
    ``PartialsPlan``'s fields but the dtype."""
    n, c = shape[:2]
    hw = math.prod(shape[2:])
    vec = 16 // elem_bytes
    m, ng = c // num_groups * hw, n * num_groups
    run_bytes = m * elem_bytes
    geo = dict(hw=hw, slice=0, n=n, c=c, g=num_groups, route=ELEMENT,
               grid=ng, threads=SPLIT_THREADS, cluster=1)
    if hw % vec or run_bytes >= 1 << 31:
        return geo
    if run_bytes <= WARP_RUN_BYTES:
        # as many warps a block as spread the runs over every SM
        warps = max(1, min(SPLIT_THREADS // 32, _cdiv(ng, sms)))
        return {**geo, "route": WARP, "grid": _cdiv(ng, warps),
                "threads": warps * 32}
    # a block a run; with fewer runs than SMs, a cluster a run, wide enough
    # that the runs fill twice the SMs, no block owning less than
    # MIN_SLICE_BYTES, none empty
    cs = 1 if ng >= sms else max(1, min(MAX_CLUSTER, _cdiv(2 * sms, ng),
                                        run_bytes // MIN_SLICE_BYTES))
    slice_ = _round_up(_cdiv(m, cs), vec)
    cs = _cdiv(m, slice_)
    return {**geo, "route": BLOCK, "slice": slice_, "grid": ng * cs,
            "cluster": cs}


def apply_geometry(shape, elem_bytes: int, num_groups: int,
                   sms: int) -> dict:
    """The apply kernel's launch geometry (``ApplyPlan``'s fields but the
    dtypes, parts, eps and silu), as ``partials_geometry``.  A tile is rows
    of whole channels when a channel fits APPLY_TILE_BYTES (no more rows
    than leave TILES_PER_SM tiles an SM), else one channel's columns in
    near-equal parts; one block a tile."""
    n, c = shape[:2]
    hw = math.prod(shape[2:])
    vec = 16 // elem_bytes
    geo = dict(hw=hw, tiles=0, n=n, c=c, g=num_groups, route=ELEMENT,
               rows=0, cols=0, col_tiles=0, chan_tiles=0)
    if hw % vec or c // num_groups * hw * elem_bytes >= 1 << 31:
        return geo
    row_bytes = hw * elem_bytes
    if row_bytes <= APPLY_TILE_BYTES:
        rows = max(1, min(APPLY_TILE_BYTES // row_bytes, SPLIT_THREADS, c,
                          _cdiv(n * c, TILES_PER_SM * sms)))
        cols, col_tiles = hw, 1
    else:
        rows = 1
        cols = _round_up(_cdiv(hw, _cdiv(row_bytes, APPLY_TILE_BYTES)), vec)
        col_tiles = _cdiv(hw, cols)
    chan_tiles = _cdiv(c, rows)
    return {**geo, "tiles": n * chan_tiles * col_tiles, "route": TILE,
            "rows": rows, "cols": cols, "col_tiles": col_tiles,
            "chan_tiles": chan_tiles}


class _Launch:
    """One split kernel's launch plan for one key: the C struct (kept
    alive, passed by address), the entry point, the card's index, the
    counter key and, for the partials, an output to copy the layout of
    (``torch.empty_like`` of a tensor is cheaper on the host than
    ``torch.empty`` of a shape)."""

    __slots__ = ("plan", "ptr", "fn", "stream", "index", "key", "like",
                 "parts_shape", "w_dtype", "cast")

    def __init__(self, plan, fn, x, key):
        self.plan, self.ptr, self.fn, self.key = (
            plan, ctypes.addressof(plan), fn, key)
        self.index = x.get_device()
        # the current stream's handle, read at every call
        self.stream = torch._C._cuda_getCurrentRawStream


_PARTIALS_PLANS: dict = {}
_APPLY_PLANS: dict = {}


def _card(x: torch.Tensor):
    """-> (kernel library, x's dtype code, the SM count of x's card)."""
    lib = build.library()
    for which, struct in enumerate((PartialsPlan, ApplyPlan)):
        if lib.sdv_groupnorm_split_plan_bytes(which) != ctypes.sizeof(struct):
            raise RuntimeError(f"{struct.__name__} does not match the "
                               "kernel library's")
    props = torch.cuda.get_device_properties(x.get_device())
    return lib, build.dtype_code(x), props.multi_processor_count


def _partials_key(x: torch.Tensor, num_groups: int) -> tuple:
    """What a partials plan depends on: x's shape, dtype and card, the
    groups."""
    return x.shape, x.dtype, num_groups, x.get_device()


def _apply_key(x, scale, bias, parts, num_groups, eps, silu) -> tuple:
    """What an apply plan depends on: the shapes and dtypes of x and the
    weights, x's card, the groups, the ranks' partials, eps and silu."""
    return (x.shape, x.dtype, scale.shape, scale.dtype, bias.shape,
            bias.dtype, num_groups, parts.shape[0], eps, silu,
            x.get_device())


def _partials_launch(key: tuple, x: torch.Tensor,
                     num_groups: int) -> _Launch:
    """Build the partials plan of ``key`` (x's), cache and return it."""
    n, c = x.shape[:2]
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} "
                         "groups")
    lib, code, sms = _card(x)
    plan = PartialsPlan(dtype=code, **partials_geometry(
        tuple(x.shape), x.element_size(), num_groups, sms))
    launch = _Launch(plan, lib.sdv_groupnorm_partials, x,
                     (tuple(x.shape), x.dtype, num_groups))
    launch.like = torch.empty(n, num_groups, 3, device=x.device,
                              dtype=torch.float32)
    _PARTIALS_PLANS[key] = launch
    return launch


def _apply_launch(key, x, scale, bias, parts, num_groups, eps,
                  silu) -> _Launch:
    """Build the apply plan of ``key`` (this call's), cache and return
    it."""
    _check(x, scale, bias, num_groups)
    n_parts = parts.shape[0]
    parts_shape = (n_parts, x.shape[0], num_groups, 3)
    if tuple(parts.shape) != parts_shape:
        raise ValueError(f"partials {tuple(parts.shape)} do not match x "
                         f"{tuple(x.shape)} at {num_groups} groups")
    lib, code, sms = _card(x)
    w_dtype = _weight_dtype(scale, bias)
    plan = ApplyPlan(dtype=code, w_dtype=build.DTYPE_CODES[str(w_dtype)],
                     parts=n_parts, silu=int(silu), eps=float(eps),
                     **apply_geometry(tuple(x.shape), x.element_size(),
                                      num_groups, sms))
    launch = _Launch(plan, lib.sdv_groupnorm_apply, x,
                     (tuple(x.shape), bool(silu), x.dtype, w_dtype,
                      num_groups, n_parts))
    launch.parts_shape, launch.w_dtype = parts_shape, w_dtype
    launch.cast = scale.dtype != w_dtype or bias.dtype != w_dtype
    _APPLY_PLANS[key] = launch
    return launch


def groupnorm_partials(x: torch.Tensor, num_groups: int = 32) -> torch.Tensor:
    """(N, C, *spatial) -> (N, G, 3) fp32 Welford partials of each group's
    run, by x's device: the kernel on the card, the plain version on the
    CPU.  On the card the launch plan of (shape, dtype, groups, card) is
    built at its first call; a call checks only x's contiguity."""
    if x.is_cuda:
        key = _partials_key(x, num_groups)
        launch = _PARTIALS_PLANS.get(key)
        if launch is None:
            launch = _partials_launch(key, x, num_groups)
        if not x.is_contiguous():
            x = x.contiguous()
        out = torch.empty_like(launch.like)
        err = launch.fn(launch.ptr, x.data_ptr(), out.data_ptr(),
                        launch.stream(launch.index))
        if err:
            build.check(err, "groupnorm partials kernel")
        groupnorm_partials.launches += 1
        groupnorm_partials.by_shape[launch.key] += 1
        return out
    if x.shape[1] % num_groups:
        raise ValueError(f"{x.shape[1]} channels do not split into "
                         f"{num_groups} groups")
    if x.device.type == "cpu":
        return groupnorm_partials_reference(x, num_groups)
    raise ValueError(f"no GroupNorm kernel for device {x.device}")


groupnorm_partials.launches = 0
groupnorm_partials.by_shape = collections.Counter()


def groupnorm_apply(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    parts: torch.Tensor, num_groups: int = 32,
                    eps: float = 1e-5, silu: bool = True) -> torch.Tensor:
    """GroupNorm(+SiLU) of x with the statistics of the ranks' partials
    ``parts`` (P, N, G, 3), merged in rank order, by x's device.  On the
    card the launch plan of (shapes, dtypes, groups, P, eps, silu, card) is
    built at its first call; a call checks the partials' shape and the
    tensors' devices and contiguity."""
    if x.is_cuda:
        key = _apply_key(x, scale, bias, parts, num_groups, eps, silu)
        launch = _APPLY_PLANS.get(key)
        if launch is None:
            launch = _apply_launch(key, x, scale, bias, parts, num_groups,
                                   eps, silu)
        if parts.shape != launch.parts_shape:
            raise ValueError(f"partials {tuple(parts.shape)} do not match x "
                             f"{tuple(x.shape)} at {num_groups} groups")
        index = launch.index
        if not x.is_contiguous():
            x = x.contiguous()
        if (launch.cast or scale.get_device() != index
                or bias.get_device() != index or not scale.is_contiguous()
                or not bias.is_contiguous()):
            scale, bias = (_as(w.detach(), launch.w_dtype, x.device)
                           .contiguous() for w in (scale, bias))
        if (parts.dtype != torch.float32 or parts.get_device() != index
                or not parts.is_contiguous()):
            parts = _as(parts, torch.float32, x.device).contiguous()
        y = torch.empty_like(x)
        err = launch.fn(launch.ptr, x.data_ptr(), scale.data_ptr(),
                        bias.data_ptr(), parts.data_ptr(), y.data_ptr(),
                        launch.stream(index))
        if err:
            build.check(err, "groupnorm apply kernel")
        groupnorm_apply.launches += 1
        groupnorm_apply.by_shape[launch.key] += 1
        return y
    _check(x, scale, bias, num_groups)
    if tuple(parts.shape[1:]) != (x.shape[0], num_groups, 3):
        raise ValueError(f"partials {tuple(parts.shape)} do not match x "
                         f"{tuple(x.shape)} at {num_groups} groups")
    if x.device.type == "cpu":
        return groupnorm_apply_reference(x, scale, bias, parts, num_groups,
                                         eps, silu)
    raise ValueError(f"no GroupNorm kernel for device {x.device}")


groupnorm_apply.launches = 0
groupnorm_apply.by_shape = collections.Counter()


def split_groupnorm_silu(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, gather, num_groups: int = 32,
                         eps: float = 1e-5, silu: bool = True) -> torch.Tensor:
    """GroupNorm(+SiLU) of a tensor whose groups span several ranks' slabs
    (x is this rank's): the local partials, ``gather`` (partials (N, G, 3)
    -> every rank's, stacked (P, N, G, 3) in rank order), then the apply
    pass.  Forward only: no gradient flows through it."""
    return groupnorm_apply(x, scale, bias, gather(groupnorm_partials(
        x, num_groups)), num_groups, eps, silu)
