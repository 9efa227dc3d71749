"""Time this checkout's split-statistics GroupNorm kernels against another
build of them, on the card, in one process.

The other build is a directory holding a ``groupnorm.cu`` whose split
entry points take their arguments one by one
(``sdv_groupnorm_partials(x, partials, N, C, HW, G, dtype, stream)``,
``sdv_groupnorm_apply(x, scale, bias, w_dtype, partials, P, y, N, C, HW,
G, eps, silu, dtype, stream)``): the parent commit's (before the launch
plans), or ``tools/split_groupnorm/tma``, the design on TMA bulk copies.
It is built alone with ``nvcc`` into ``--build-dir`` (headers it does not
hold come from this checkout's ``csrc``), loaded with ``ctypes`` and
called through wrappers that do the work the parent's wrappers did a
call.  A build that exports the launch-plan entry points is refused.

Every bf16 split row of ``chip_smoke.py``'s phase 3 (SD 1.x's spatial
UNet at CFG batch 16 and 8, SDXL-base's at 1024² and batch 2) is checked
against the plain versions for both sides, then timed back to back and on
the device clock (queued behind a device sleep), in turns other, this,
this, other; each side's reading is the lesser of its two.
``torch.var_mean`` over the grouped view is timed beside the partials.

``--routes`` adds, for the rows whose partials plan takes a warp a run,
that plan against one block a run (this checkout's kernels, the same
wrapper-free call) on both clocks, in turns.  Run from the repository
root::

    mkdir -p DIR && for f in groupnorm.cu common.cuh groupnorm_common.cuh; do
      git show <commit>:stable_diffusion_videos_tpu_torch/csrc/$f > DIR/$f
    done
    python3 tools/split_groupnorm/compare.py --other-csrc DIR \\
        --build-dir DIR/build --out split_gn.json --routes
    python3 tools/split_groupnorm/compare.py \\
        --other-csrc tools/split_groupnorm/tma --build-dir BUILD --out tma.json
    # the same, a block a unit of work instead of persistent grids
    python3 tools/split_groupnorm/compare.py -D SPLIT_TMA_PERSISTENT=0 \\
        --other-csrc tools/split_groupnorm/tma --build-dir BUILD2 --out tma0.json
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from stable_diffusion_videos_tpu_torch.ops import build  # noqa: E402
from stable_diffusion_videos_tpu_torch.ops import groupnorm as gn  # noqa: E402


def chip_smoke():
    """The repository's ``chip_smoke.py`` as a module: its rows, timers,
    tolerances and bounds."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_other(csrc: Path, out: Path, defines=()) -> ctypes.CDLL:
    """The other build's groupnorm.cu compiled alone (with the macro
    ``defines``) and loaded, its kernels' attributes set."""
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libother_groupnorm.so"
    subprocess.run([build._nvcc(), *build.ARCH, "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-I", str(build.CSRC),
                    *(f"-D{d}" for d in defines), "-o", str(so),
                    str(csrc / "groupnorm.cu")], check=True)
    lib = ctypes.CDLL(str(so))
    if hasattr(lib, "sdv_groupnorm_split_plan_bytes"):
        raise SystemExit(f"{csrc}: its split kernels take launch plans; this "
                         "script calls the argument-list entry points only")
    P, I, LL, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    lib.sdv_groupnorm_partials.argtypes = [P, P, I, I, LL, I, I, P]
    lib.sdv_groupnorm_partials.restype = I
    lib.sdv_groupnorm_apply.argtypes = [P, P, P, I, P, I, P, I, I, LL, I, F,
                                        I, I, P]
    lib.sdv_groupnorm_apply.restype = I
    lib.sdv_prepare_groupnorm.restype = I
    if lib.sdv_prepare_groupnorm() != 0:
        raise RuntimeError("the other build's kernels could not be prepared")
    return lib


def other_wrappers(lib):
    """(partials, apply) calling the other build's entry points with the
    per-call work the parent's wrappers did: checks, the library and dtype
    lookups, contiguity, weight casts, the output, the stream, the ctypes
    conversions and the counters."""
    counts = {}

    def partials(x, num_groups=32):
        if x.shape[1] % num_groups:
            raise ValueError("channels")
        build.library()
        code = build.dtype_code(x)
        x = x.contiguous()
        n, c = x.shape[:2]
        out = torch.empty(n, num_groups, 3, device=x.device,
                          dtype=torch.float32)
        err = lib.sdv_groupnorm_partials(
            x.data_ptr(), out.data_ptr(), n, c, x.numel() // (n * c),
            num_groups, code, torch.cuda.current_stream(x.device).cuda_stream)
        build.check(err, "other groupnorm partials kernel")
        key = (tuple(x.shape), x.dtype, num_groups)
        counts[key] = counts.get(key, 0) + 1
        return out

    def apply(x, scale, bias, parts, num_groups=32, eps=1e-5, silu=True):
        gn._check(x, scale, bias, num_groups)
        if tuple(parts.shape[1:]) != (x.shape[0], num_groups, 3):
            raise ValueError("partials")
        build.library()
        code = build.dtype_code(x)
        x = x.contiguous()
        n, c = x.shape[:2]
        w_dtype = gn._weight_dtype(scale, bias)
        scale, bias = (gn._as(w.detach(), w_dtype, x.device).contiguous()
                       for w in (scale, bias))
        parts = gn._as(parts, torch.float32, x.device).contiguous()
        y = torch.empty_like(x)
        err = lib.sdv_groupnorm_apply(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            build.DTYPE_CODES[str(w_dtype)], parts.data_ptr(),
            parts.shape[0], y.data_ptr(), n, c, x.numel() // (n * c),
            num_groups, float(eps), int(silu), code,
            torch.cuda.current_stream(x.device).cuda_stream)
        build.check(err, "other groupnorm apply kernel")
        key = (tuple(x.shape), bool(silu), x.dtype, w_dtype, num_groups,
               parts.shape[0])
        counts[key] = counts.get(key, 0) + 1
        return y

    return partials, apply


def in_turns(fn_other, fn_this, read) -> tuple:
    """``read(fn)`` in turns other, this, this, other -> (other, this),
    each the lesser of its two readings."""
    a, b, c, d = read(fn_other), read(fn_this), read(fn_this), read(fn_other)
    return min(a, d), min(b, c)


def block_plan(geo: dict) -> dict:
    """The partials geometry ``geo`` of a warp-route row redone as one
    block a run (``partials_geometry``'s block route at cluster 1)."""
    m = geo["c"] // geo["g"] * geo["hw"]
    return {**geo, "route": gn.BLOCK, "slice": m, "grid": geo["n"] * geo["g"],
            "threads": gn.SPLIT_THREADS, "cluster": 1}


def time_routes(smoke, rows, dev, g) -> dict:
    """This checkout's partials kernel on the rows whose plan is a warp a
    run: that plan against one block a run, called straight through the
    entry point (no wrapper), on both clocks, in turns."""
    lib = build.library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {"rows": [], "warp_ms": 0.0, "block_ms": 0.0, "warp_queued": 0.0,
           "block_queued": 0.0}
    for shape, _ in rows:
        geo = gn.partials_geometry(shape, 2, 32, sms)
        if geo["route"] != gn.WARP:
            continue
        x = (torch.randn(shape, device=dev, generator=g) * 2 + 0.5).to(
            torch.bfloat16)
        want = gn.groupnorm_partials_reference(x, 32)
        plans = [gn.PartialsPlan(dtype=build.dtype_code(x), **p)
                 for p in (geo, block_plan(geo))]
        part = torch.empty(shape[0], 32, 3, device=dev)

        def call(plan):
            return lambda: build.check(lib.sdv_groupnorm_partials(
                ctypes.addressof(plan), x.data_ptr(), part.data_ptr(),
                torch._C._cuda_getCurrentRawStream(dev.index or 0)),
                "groupnorm partials kernel")

        warp, block = (call(p) for p in plans)
        for name, fn in (("warp", warp), ("block", block)):
            fn()
            smoke.compare(torch, f"{shape} partials, {name} route", part,
                          want, "float32")
        ms = in_turns(warp, block, lambda fn: smoke.time_ms(torch, fn))
        reps = int(min(100, max(5, 20.0 / ms[1])))
        q = in_turns(warp, block,
                     lambda fn: smoke.queued_times(torch, fn, reps)[0])
        row = {"shape": list(shape), "warp_ms": ms[0], "block_ms": ms[1],
               "warp_queued": q[0], "block_queued": q[1],
               "warps_a_block": geo["threads"] // 32, "grid": geo["grid"]}
        out["rows"].append(row)
        for k in ("warp_ms", "block_ms", "warp_queued", "block_queued"):
            out[k] += row[k]
        print(f"route {shape}: warp {ms[0]:.4f} / block {ms[1]:.4f} ms back "
              f"to back, warp {q[0]:.4f} / block {q[1]:.4f} ms on the device",
              flush=True)
        del x
    print(f"routes, {len(out['rows'])} warp-route bf16 rows: " + ", ".join(
        f"{k} {out[k]:.4f}" for k in ("warp_ms", "block_ms", "warp_queued",
                                      "block_queued")), flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other-csrc", type=Path, required=True)
    ap.add_argument("--build-dir", type=Path, required=True)
    ap.add_argument("--out", type=Path)
    ap.add_argument("-D", dest="defines", action="append", default=[],
                    help="a macro for the other build (NAME=VALUE)")
    ap.add_argument("--routes", action="store_true",
                    help="also time the warp route against a block a run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    smoke = chip_smoke()
    build.library()
    o_partials, o_apply = other_wrappers(load_other(
        args.other_csrc, args.build_dir, args.defines))
    g = torch.Generator(device=dev).manual_seed(18)
    dt, eb = torch.bfloat16, 2
    families = {"SD 1.x": smoke.MESH_SPLIT_GN + smoke.MESH_SPLIT_HALF_GN,
                "SDXL": smoke.MESH_SPLIT_XL_GN}
    fields = ("other_ms", "this_ms", "other_queued", "this_queued",
              "other_host_us", "this_host_us", "library_ms", "bound_ms")
    result = {"device": torch.cuda.get_device_name(0),
              "other": str(args.other_csrc), "defines": args.defines,
              "rows": [], "sums": {}}

    def back_to_back(fn):
        return smoke.time_ms(torch, fn)

    for family, rows in families.items():
        sums = {k: {f: 0.0 for f in fields} for k in ("partials", "apply")}
        for shape, silu in rows:
            x = (torch.randn(shape, device=dev, generator=g) * 2 + 0.5).to(dt)
            x2 = (torch.randn(shape, device=dev, generator=g) * 3 - 1).to(dt)
            scale, bias = (torch.randn(shape[1], device=dev,
                                       generator=g).to(dt) for _ in range(2))
            want = gn.groupnorm_partials_reference(x, 32)
            for fn in (o_partials, gn.groupnorm_partials):
                smoke.compare(torch, f"{shape} partials", fn(x, 32), want,
                              "float32")
            parts = torch.stack([gn.groupnorm_partials(x, 32),
                                 gn.groupnorm_partials(x2, 32)])
            a_args = (x, scale, bias, parts, 32, 1e-5, silu)
            want = gn.groupnorm_apply_reference(*a_args)
            for fn in (o_apply, gn.groupnorm_apply):
                smoke.compare(torch, f"{shape} apply", fn(*a_args), want,
                              "bfloat16")
            n = float(math.prod(shape))
            xg = x.view(shape[0], 32, -1)
            row = {"shape": list(shape), "silu": silu}
            for kernel, other, this, bound, library in (
                    ("partials", lambda: o_partials(x, 32),
                     lambda: gn.groupnorm_partials(x, 32),
                     smoke.bound_ms(5 * n, eb * n + shape[0] * 32 * 12,
                                    smoke.PEAK_OPS[4])[0],
                     lambda: torch.var_mean(xg, dim=-1)),
                    ("apply", lambda: o_apply(*a_args),
                     lambda: gn.groupnorm_apply(*a_args),
                     smoke.gn_bound(shape, silu, eb)[0], None)):
                ms = in_turns(other, this, back_to_back)
                reps = int(min(100, max(5, 20.0 / ms[1])))
                q = in_turns(other, this,
                             lambda fn: smoke.queued_times(torch, fn, reps))
                lib_ms = back_to_back(library) if library else 0.0
                r = dict(zip(fields, (ms[0], ms[1], q[0][0], q[1][0],
                                      q[0][1], q[1][1], lib_ms, bound)))
                row[kernel] = r
                for f in fields:
                    sums[kernel][f] += r[f]
                print(f"{family} {shape} silu={silu} {kernel}: other "
                      f"{r['other_ms']:.4f} / this {r['this_ms']:.4f} ms back "
                      f"to back, other {r['other_queued']:.4f} / this "
                      f"{r['this_queued']:.4f} ms on the device, host "
                      f"{r['other_host_us']:.1f} / {r['this_host_us']:.1f} "
                      f"us; library {lib_ms:.4f}, bound {bound:.4f} ms",
                      flush=True)
            result["rows"].append(row)
            del x, x2, xg, parts
        for kernel, s in sums.items():
            s["rows"] = len(rows)
            print(f"{family}, {len(rows)} bf16 rows, {kernel}: "
                  + ", ".join(f"{f} {v:.4f}" for f, v in s.items()
                              if f != "rows"), flush=True)
        result["sums"][family] = sums
    if args.routes:
        result["routes"] = time_routes(
            smoke, [r for rows in families.values() for r in rows], dev, g)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
