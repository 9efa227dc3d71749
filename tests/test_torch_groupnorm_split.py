"""The split-statistics GroupNorm's launch plans and kernels.

On the CPU: the plans of every split row ``chip_smoke.py``'s phase 3 checks
(SD 1.x's spatial UNet at CFG batch 16 and 8, SDXL-base's at 1024² and CFG
batch 2) are walked as the kernels walk them (``csrc/groupnorm.cu``): every
(item, group) run and every element is read exactly once, and every run,
slice and tile starts on 16 bytes and holds whole 16-byte vectors; and the
plan cache keys on every argument a plan depends on.  On the card (``-m cuda``): both kernels
against their plain versions and bit-equal from call to call.
"""

from __future__ import annotations

import ctypes
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from stable_diffusion_videos_tpu_torch.ops import groupnorm as gn

ROOT = Path(__file__).resolve().parents[1]
SMS = 132  # an H100 SXM's


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _smoke()
#: (shape, element bytes) of every split row phase 3 checks
ROWS = sorted({(shape, eb) for shape, _ in SMOKE.MESH_SPLIT_GN
               for eb in (2, 4)}
              | {(shape, 2) for shape, _ in SMOKE.MESH_SPLIT_HALF_GN
                 + SMOKE.MESH_SPLIT_XL_GN})


def spans_partition(spans, total) -> bool:
    """Do the (start, length) spans cover [0, total) each element once?"""
    at = 0
    for start, length in sorted(spans):
        if start != at or length <= 0:
            return False
        at += length
    return at == total


@pytest.mark.parametrize("shape,eb", ROWS, ids=str)
def test_partials_plan_reads_every_element_once(shape, eb):
    p = gn.partials_geometry(shape, eb, 32, SMS)
    n, c = shape[:2]
    hw, vec = p["hw"], 16 // eb
    m, ng = c // 32 * hw, n * 32
    assert hw == int(np.prod(shape[2:])) and hw % vec == 0
    assert (m * eb) % 16 == 0  # every run starts on 16 bytes
    if p["route"] == gn.WARP:
        # warp w of block b: runs b·W + w, + grid·W, ...
        assert m * eb <= gn.WARP_RUN_BYTES
        warps = p["threads"] // 32
        assert p["threads"] % 32 == 0 and 1 <= warps <= 8
        stride = p["grid"] * warps
        runs = [r for first in range(stride)
                for r in range(first, ng, stride)]
        assert sorted(runs) == list(range(ng))
        # no more warps a block than spread the runs over every SM
        assert warps <= max(1, -(-ng // SMS))
        return
    assert p["route"] == gn.BLOCK and m * eb > gn.WARP_RUN_BYTES
    cs, slice_ = p["cluster"], p["slice"]
    assert 1 <= cs <= gn.MAX_CLUSTER and p["threads"] == gn.SPLIT_THREADS
    # cluster q (blocks q·cs ... q·cs + cs - 1) takes run q; block `rank` of
    # it owns [rank·slice, rank·slice + slice), none empty, on 16 bytes
    assert p["grid"] == ng * cs and slice_ % vec == 0
    spans = []
    for rank in range(cs):
        start = min(rank * slice_, m)
        spans.append((start, min(start + slice_, m) - start))
        assert spans[-1][1] > 0 and (start * eb) % 16 == 0
    assert spans_partition(spans, m)
    assert slice_ * eb >= gn.MIN_SLICE_BYTES or cs == 1
    if ng < SMS and m * eb >= 8 * gn.MIN_SLICE_BYTES:
        assert p["grid"] >= SMS  # few long runs still fill the card


def apply_tile(p, t, eb):
    """Tile t of an apply plan as the kernel decodes it -> (item, first
    channel, channels, first element, bytes)."""
    per_item = p["chan_tiles"] * p["col_tiles"]
    n, rem = divmod(t, per_item)
    ct, jt = divmod(rem, p["col_tiles"])
    c0 = ct * p["rows"]
    rows = min(p["rows"], p["c"] - c0)
    j0 = jt * p["cols"]
    cols = min(p["cols"], p["hw"] - j0)
    return n, c0, rows, (n * p["c"] + c0) * p["hw"] + j0, rows * cols * eb


@pytest.mark.parametrize("shape,eb", ROWS, ids=str)
def test_apply_plan_writes_every_element_once(shape, eb):
    p = gn.apply_geometry(shape, eb, 32, SMS)
    vec = 16 // eb
    assert p["route"] == gn.TILE and p["cols"] % vec == 0
    assert 1 <= p["rows"] <= gn.SPLIT_THREADS  # a channel a thread
    if p["rows"] > 1:
        assert p["cols"] == p["hw"] and p["col_tiles"] == 1
    spans = []
    for t in range(p["tiles"]):  # block t takes tile t
        n, c0, rows, start, nbytes = apply_tile(p, t, eb)
        assert 0 <= n < shape[0] and 0 <= c0 < p["c"] and rows >= 1
        assert nbytes <= gn.APPLY_TILE_BYTES or p["rows"] == 1
        assert nbytes % 16 == 0 and (start * eb) % 16 == 0
        spans.append((start, nbytes // eb))
    assert spans_partition(spans, int(np.prod(shape)))
    # no more rows a tile than leave TILES_PER_SM tiles an SM
    assert p["rows"] <= max(1, -(-shape[0] * shape[1]
                                 // (gn.TILES_PER_SM * SMS)))
    # the kernel follows each vector's row by increments, not divisions
    vpr = p["cols"] // vec
    for t in (0, p["tiles"] - 1):
        nvec = apply_tile(p, t, eb)[4] // 16
        for tid in range(gn.SPLIT_THREADS):
            row, col = divmod(tid, vpr)
            for i in range(tid, nvec, gn.SPLIT_THREADS):
                assert (row, col) == divmod(i, vpr)
                row += gn.SPLIT_THREADS // vpr
                col += gn.SPLIT_THREADS % vpr
                if col >= vpr:
                    col, row = col - vpr, row + 1


@pytest.mark.parametrize("shape", [(2, 64, 7, 5), (4, 96, 3, 3)], ids=str)
def test_unaligned_rows_take_the_element_route(shape):
    for eb in (2, 4):
        assert gn.partials_geometry(shape, eb, 32,
                                    SMS)["route"] == gn.ELEMENT
        assert gn.apply_geometry(shape, eb, 32, SMS)["route"] == gn.ELEMENT


def test_plan_structs_match_the_kernels_layout():
    """The ctypes structs have the C structs' sizes and field offsets (x86-64
    alignment: the two 64-bit fields first, then 4-byte ones)."""
    assert ctypes.sizeof(gn.PartialsPlan) == 16 + 8 * 4
    assert ctypes.sizeof(gn.ApplyPlan) == 16 + 13 * 4 + 4
    assert gn.PartialsPlan.n.offset == 16 and gn.ApplyPlan.eps.offset == 44


def test_plan_cache_keys_on_every_argument(monkeypatch):
    """A new plan when eps, silu, the dtypes or the number of ranks'
    partials differ; the same plan object when nothing does."""
    class Lib:
        sdv_groupnorm_partials = sdv_groupnorm_apply = object()

    monkeypatch.setattr(gn, "_card", lambda x: (
        Lib, gn.build.dtype_code(x), SMS))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    monkeypatch.setattr(gn, "_APPLY_PLANS", {})
    monkeypatch.setattr(gn, "_PARTIALS_PLANS", {})
    x = torch.zeros(2, 64, 8, 8)
    w = torch.ones(64)

    def plan(x=x, w=w, parts=2, eps=1e-5, silu=True):
        # the wrapper's lookup
        p = torch.zeros(parts, 2, 32, 3)
        key = gn._apply_key(x, w, w, p, 32, eps, silu)
        got = gn._APPLY_PLANS.get(key)
        return got if got is not None else gn._apply_launch(
            key, x, w, w, p, 32, eps, silu)

    base = plan()
    assert plan() is base and len(gn._APPLY_PLANS) == 1
    variants = [plan(eps=1e-6), plan(silu=False), plan(parts=4),
                plan(x=x.bfloat16()), plan(w=w.bfloat16())]
    assert len({id(v) for v in variants + [base]}) == 6
    assert len(gn._APPLY_PLANS) == 6
    assert [v.plan.eps for v in (base, variants[0])] == [
        pytest.approx(1e-5), pytest.approx(1e-6)]
    assert (base.plan.silu, variants[1].plan.silu) == (1, 0)
    assert (base.plan.parts, variants[2].plan.parts) == (2, 4)
    assert (base.plan.dtype, variants[3].plan.dtype) == (0, 1)
    assert (base.plan.w_dtype, variants[4].plan.w_dtype) == (0, 1)
    assert base.key == ((2, 64, 8, 8), True, torch.float32, torch.float32,
                        32, 2)
    # bf16 x with fp32 weights reads them as they are; mixed ones go fp32
    assert not plan(x=x.bfloat16()).cast
    p2 = torch.zeros(2, 2, 32, 3)
    mixed = gn._apply_launch(gn._apply_key(x, w, w.bfloat16(), p2, 32, 1e-5,
                                           True),
                             x, w, w.bfloat16(), p2, 32, 1e-5, True)
    assert mixed.cast and mixed.w_dtype == torch.float32
    # partials: one plan a (shape, dtype, groups); they read no weights
    a = gn._partials_launch(gn._partials_key(x, 32), x, 32)
    b = gn._partials_launch(gn._partials_key(x.bfloat16(), 32),
                            x.bfloat16(), 32)
    assert len(gn._PARTIALS_PLANS) == 2 and (a.plan.dtype, b.plan.dtype) == (
        0, 1)
    assert gn._PARTIALS_PLANS[gn._partials_key(x, 32)] is a
    assert a.key == ((2, 64, 8, 8), torch.float32, 32)
    assert a.like.shape == (2, 32, 3) and a.like.dtype == torch.float32
    bad = torch.zeros(2, 60, 4, 4)
    with pytest.raises(ValueError, match="do not split"):
        gn._partials_launch(gn._partials_key(bad, 32), bad, 32)
    p3 = torch.zeros(2, 2, 16, 3)
    with pytest.raises(ValueError, match="do not match"):
        gn._apply_launch(gn._apply_key(x, w, w, p3, 32, 1e-5, True), x, w, w,
                         p3, 32, 1e-5, True)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


#: N·G < 132 with long runs (SDXL's half slabs: clusters of 5 blocks) and
#: with shorter ones (a block a run), runs of at most 4 KB (a warp a run)
#: and a little over (a block), mid-size runs, unaligned HW (the element route)
CUDA_SHAPES = [(2, 320, 128, 64), (2, 640, 32, 16), (16, 1280, 8, 4),
               (8, 2560, 8, 4), (16, 320, 32, 16), (3, 64, 7, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("n_parts", [2, 4])
def test_split_kernels_match_plain_on_the_card(cuda, dtype, n_parts):
    tol = SMOKE.TOL[str(dtype).split(".")[1]]
    g = torch.Generator(device=cuda).manual_seed(18)
    for shape in CUDA_SHAPES:
        xs = [(torch.randn(shape, device=cuda, generator=g) * (r + 1)
               + r - 0.5).to(dtype) for r in range(n_parts)]
        scale, bias = (torch.randn(shape[1], device=cuda, generator=g)
                       .to(dtype) for _ in range(2))
        for x in (xs[0], torch.cat([torch.zeros(1, device=cuda, dtype=dtype),
                                    xs[0].flatten()])[1:].view(shape)):
            # (the second: a slab whose base is off 16 bytes)
            got = gn.groupnorm_partials(x, 32)
            torch.testing.assert_close(
                got, gn.groupnorm_partials_reference(x, 32),
                **SMOKE.TOL["float32"])
            assert torch.equal(got, gn.groupnorm_partials(x, 32))
            parts = torch.stack([got] + [gn.groupnorm_partials(o, 32)
                                         for o in xs[1:]])
            for silu in (True, False):
                args = (x, scale, bias, parts, 32, 1e-5, silu)
                y = gn.groupnorm_apply(*args)
                torch.testing.assert_close(
                    y.float(), gn.groupnorm_apply_reference(*args).float(),
                    **tol)
                assert torch.equal(y, gn.groupnorm_apply(*args))
