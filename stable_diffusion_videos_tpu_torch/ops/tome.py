"""Token Merging for Stable Diffusion (ToMe-SD, Bolya & Hoffman 2023).

Counterpart of ``stable_diffusion_videos_tpu/ops/tome.py``, with its
semantics and not its TPU formulation: before a transformer block's
self-attention, the ``n_merge`` src tokens most cosine-similar to a dst token
(one dst a 2x2 region, its top-left corner) are averaged into that dst, the
attention runs on the reduced set, and each merged token copies its dst's
output back.  Here the kept and dst tokens are gathers, the merged tokens
are summed into their dst by ``scatter_add``, and the unmerge is one gather
of row ids.  Plain PyTorch, no kernel of its own.

As in the JAX package: ``n_merge = int(ratio * S)`` capped at the src
partition, the metric cast to fp32 before it is normalised (eps 1e-6), the
merged mean taken over 1 + the tokens merged in, the reduced order kept src
tokens first, then dst tokens; ties in redundancy keep src order (a stable
sort, as ``jnp.argsort``) and ties between dst tokens go to the first.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class MergePlan(NamedTuple):
    """A data-dependent merge assignment of static shapes."""
    src_idx: torch.Tensor  # (S_src,) token positions of the src partition
    dst_idx: torch.Tensor  # (S_dst,) token positions of the dst partition
    kept: torch.Tensor     # (B, S_src - n) src-list indices kept unmerged
    merged: torch.Tensor   # (B, n) src-list indices merged away
    assign: torch.Tensor   # (B, n) dst-list index each merged token joins
    n_merge: int


def bipartite_partition(h: int, w: int, sy: int = 2, sx: int = 2,
                        device: Optional[torch.device] = None) -> tuple:
    """(src, dst) token positions of an h x w grid, each in raster order:
    one dst a sy x sx region (its top-left corner), the rest src.  Built
    on ``device`` without a copy from the host, so a dispatch never waits
    on it."""
    pos = torch.arange(h * w, device=device)
    is_dst = ((pos // w) % sy == 0) & ((pos % w) % sx == 0)
    order = torch.argsort(is_dst.to(torch.uint8), stable=True)
    n_src = h * w - len(range(0, h, sy)) * len(range(0, w, sx))
    return order[:n_src], order[n_src:]


def build_plan(metric: torch.Tensor, h: int, w: int, n_merge: int,
               sy: int = 2, sx: int = 2) -> MergePlan:
    """(B, S, C) features -> the plan merging the ``n_merge`` src tokens
    most cosine-similar to any dst token."""
    b, s, c = metric.shape
    if s != h * w:
        raise ValueError(f"{s} tokens are not a {h}x{w} grid")
    src_idx, dst_idx = bipartite_partition(h, w, sy, sx, metric.device)
    n_merge = min(int(n_merge), src_idx.shape[0])
    m = metric.float()
    m = m / (m.norm(dim=-1, keepdim=True) + 1e-6)
    sim = torch.bmm(m[:, src_idx], m[:, dst_idx].transpose(1, 2))
    node_max = sim.amax(dim=-1)                       # (B, S_src)
    node_assign = sim.argmax(dim=-1)                  # first of equal maxima
    order = torch.argsort(-node_max, dim=-1, stable=True)
    merged = order[:, :n_merge]
    return MergePlan(src_idx, dst_idx, order[:, n_merge:], merged,
                     torch.gather(node_assign, 1, merged), n_merge)


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (B, n) of ``t`` (B, S, C) -> (B, n, C)."""
    return torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[-1]))


def merge(x: torch.Tensor, plan: MergePlan) -> torch.Tensor:
    """(B, S, C) -> (B, S - n_merge, C): the kept src tokens, then the dst
    tokens, each the mean of itself and the src tokens merged into it."""
    xf = x.float()
    x_src, x_dst = xf[:, plan.src_idx], xf[:, plan.dst_idx]
    idx = plan.assign[..., None].expand(-1, -1, x.shape[-1])
    dst_sum = x_dst.scatter_add(1, idx, _rows(x_src, plan.merged))
    counts = torch.ones(x_dst.shape[:2], device=x.device).scatter_add(
        1, plan.assign, torch.ones(plan.assign.shape, device=x.device))
    return torch.cat([_rows(x_src, plan.kept), dst_sum / counts[..., None]],
                     dim=1).to(x.dtype)


def unmerge(out: torch.Tensor, plan: MergePlan, s_total: int) -> torch.Tensor:
    """(B, S - n_merge, C) block output -> (B, S, C): kept and dst tokens
    back at their positions, each merged token a copy of its dst's row.
    Each position learns which reduced row supplies it, then one gather."""
    b, n_kept = plan.kept.shape
    dev = out.device
    s_dst = plan.dst_idx.shape[0]
    rows = torch.empty((b, s_total), dtype=torch.long, device=dev)
    rows[:, plan.dst_idx] = n_kept + torch.arange(s_dst, device=dev)
    rows.scatter_(1, plan.src_idx[plan.kept],
                  torch.arange(n_kept, device=dev).expand(b, -1))
    rows.scatter_(1, plan.src_idx[plan.merged], n_kept + plan.assign)
    return _rows(out, rows)


def tome_wrap(fn, x: torch.Tensor, h: int, w: int, ratio: float,
              sy: int = 2, sx: int = 2) -> torch.Tensor:
    """``unmerge(fn(merge(x)))``: ``fn`` (a self-attention) on the merged
    tokens.  ``ratio`` is the share of ALL tokens to merge (tomesd's
    convention), capped at the src partition (1 - 1/(sy·sx))."""
    s = x.shape[1]
    n_merge = int(ratio * s)
    if n_merge <= 0:
        return fn(x)
    plan = build_plan(x, h, w, n_merge, sy, sx)
    return unmerge(fn(merge(x, plan)), plan, s)
