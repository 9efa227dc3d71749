"""One run of one cell of the port's benchmark.

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration (``portbench/configs/<config>.json``), its traffic mix
(``portbench/traffic/<traffic>.json``), whose ``entry`` names the program's
entry point (``portbench/entries/<entry>.py``), the limits of its check
(``portbench/limits/<workload>.json``) and a reader for every metric
(``portbench/metrics/<metric>.py``, ``read(obs) -> number or None``).

A run draws the weights on the card from the seed, builds the port
(``port.py``), lets the entry warm up the cell's shapes (set-up ends
there), runs the window, reads the memory peak, and with ``--trace 1``
profiles a fixed stretch of the same traffic and times the UNet.  Then it
frees the program, works the checked frames out again with the plain
reference and compares.  The last lines of standard error give each
compared number beside its limit; the last line of standard output is the
result.  Without a CUDA device the run stops before anything is built.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: top-level module names no run may load (the JAX package's name is a
#: prefix of the port's, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "stable_diffusion_videos_tpu")
STRETCH = "portbench.stretch"


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(root: Path, kind: str, name: str):
    """``portbench/<kind>/<name>.py`` of ``root``, by file."""
    path = Path(root) / "portbench" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(root: Path, workload: str) -> dict:
    """A cell's manifest entries and files, found by name."""
    root = Path(root)
    manifest = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    wl = cells[workload]
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[wl["config"]]
    mix = load_json(root / "portbench" / "traffic" / f"{wl['traffic']}.json")

    def reports(metric):
        return workload in metric.get("workloads", [workload])

    return {
        "manifest": manifest, "workload": wl,
        "config": load_json(root / cfg_entry["file"]),
        "mix": mix,
        "entry": load_module(root, "entries", mix["entry"]),
        "limits": load_json(root / "portbench" / "limits"
                            / f"{workload}.json"),
        "end_to_end": [m for m in manifest["end_to_end"] if reports(m)],
        "per_layer": [m for m in manifest["per_layer"] if reports(m)],
    }


def read_png(path):
    import numpy as np
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def forbidden_modules() -> list:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def compare(program, reference) -> dict:
    """The numbers the check compares: the worst frame's mean absolute
    difference and the largest difference of one pixel channel, both in
    uint8 levels."""
    import numpy as np
    d = np.abs(program.astype(np.int16) - reference.astype(np.int16))
    return {"frame_mae": float(d.reshape(len(d), -1).mean(1).max()),
            "pixel_max": float(d.max())}


def _unet_ms(run, rows: int, reps: int = 5) -> float:
    """Mean ms of the bundle's UNet at ``rows`` rows, CUDA events over
    ``reps`` calls after a warm one."""
    import torch
    m, cfg = run.models, run.config
    f = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    g = torch.Generator(run.device).manual_seed(0)
    x = torch.randn(rows, 4, run.height // f, run.width // f, generator=g,
                    device=run.device)
    t = torch.full((rows,), 500.0, device=run.device)
    ctx = torch.randn(rows, 77, cfg["unet"]["cross_attention_dim"],
                      generator=g, device=run.device)
    kw = {}
    if m.is_xl:
        kw = dict(text_embeds=torch.randn(
            rows, m.unet_config.addition_pooled_dim, generator=g,
            device=run.device), time_ids=torch.tensor(
                [run.height, run.width, 0, 0, run.height, run.width],
                dtype=torch.float32, device=run.device).expand(rows, 6))
    with torch.inference_mode():
        m.unet(x, t, ctx, **kw)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            m.unet(x, t, ctx, **kw)
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _profile(run, entry, state) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import traces
    acts = [ProfilerActivity.CPU]
    on_card = torch.device(run.device).type == "cuda"
    if on_card:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(STRETCH):
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            work = entry.stretch(run, state)
            if on_card:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    names = {r[0] for r in run.spans.records}
    out = traces.reduce_profile(prof, STRETCH, names, wall)
    out["work"] = work
    return out


def run_workload(root, workload: str, seed: int, seconds: float,
                 trace: bool, device: str = "cuda",
                 t0: float | None = None, control: bool = False) -> dict:
    """One run of ``workload`` on ``device`` -> the result dict (the last
    line's keys, then ``checks``).  The command line runs it on the card;
    tests call it on the CPU with small configurations.  ``control`` (never
    in the benchmark's own runs) also computes the checked frames with the
    reference in float8 and adds its numbers under ``control``."""
    import tempfile

    import torch

    from . import port, reference, traces, weights
    t0 = time.perf_counter() if t0 is None else t0
    cell = resolve(root, workload)
    config, mix, entry, limits = (cell["config"], cell["mix"],
                                  cell["entry"], cell["limits"])
    f = 2 ** (len(config["vae"]["block_out_channels"]) - 1)
    side = config["unet"]["sample_size"] * f
    on_card = torch.device(device).type == "cuda"
    out_dir = Path(tempfile.mkdtemp(prefix="portbench-"))
    run = types.SimpleNamespace(
        root=Path(root), name=workload, workload=cell["workload"],
        config=config, mix=mix, limits=limits, seed=int(seed),
        seconds=float(seconds), trace=bool(trace), device=device,
        spans=traces.Spans(on=False), out_dir=out_dir,
        height=mix.get("height", side), width=mix.get("width", side),
        read_png=read_png, log=log)
    try:
        log(f"imports {time.perf_counter() - t0:.3f} s")
        dtype = weights.DTYPES[config["dtype"]]
        shapes = reference.models.build(config)
        port.check_widths(config, shapes)
        drawn = weights.draw(shapes, run.seed, config["weight_std"], dtype,
                             device)
        run.models = port.bundle(config, drawn, device)
        del drawn
        log(f"weights drawn and the port built {time.perf_counter() - t0:.3f} s")
        state = entry.setup(run)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t0
        log(f"set-up {setup_s:.3f} s")
        run.spans.on = run.trace
        window = entry.window(run, state)
        if on_card:
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        log(f"window {window['seconds']:.3f} s, "
            f"{window.get('frames', window['attempted'])} done")
        obs = {"setup_s": setup_s, "window": window, "memory_peak": peak,
               "spans": run.spans.seconds(), "config": config, "mix": mix}
        if run.trace:
            obs["trace"] = _profile(run, entry, state)
            if on_card and hasattr(entry, "unet_rows"):
                obs["unet_call_ms"] = _unet_ms(run,
                                               entry.unet_rows(run, state))
        _cross_check(run)
        spec, items, program = entry.check(run, state,
                                           window, limits["sample"]["frames"])
        entry.teardown(run, state)
        del state
        run.models = None
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        drawn = weights.draw(shapes, run.seed, config["weight_std"], dtype,
                             device)
        mods = reference.build(config, drawn, device)
        del drawn
        ref = reference.frames(config, mods, spec, items, device,
                               block=limits["sample"]["block"])
        ref = ref.cpu().numpy()
        numbers = compare(program, ref)
        if control:
            controls = compare(reference.frames(
                config, mods, spec, items, device, control=True,
                block=limits["sample"]["block"]).cpu().numpy(), ref)
        del mods, ref
        log(f"reference {time.perf_counter() - t_ref:.3f} s over "
            f"{len(items)} frames")
    finally:
        import shutil
        shutil.rmtree(out_dir, ignore_errors=True)

    metrics = {}
    specs = cell["per_layer"] if run.trace else cell["end_to_end"]
    for m in specs:
        value = load_module(root, "metrics", m["name"]).read(obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {k: {"value": v, "limit": limits["numbers"][k]["limit"]}
              for k, v in numbers.items()}
    failed = int(window.get("failed", 0))
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": int(window["attempted"]),
              "failed": failed, "metrics": metrics, "device": dev}
    if run.trace:
        tr = obs["trace"]
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        result["breakdown"] = {
            "device_ops": [[n[:160], s] for n, s, _ in tr["kernels"][:10]],
            "idle_gaps": [[n, s] for n, s in tr["idle_gaps"][:10]]}
        log("device seconds by family: " + json.dumps(tr["families"]))
    if control:
        result["control"] = controls
    result["checks"] = checks
    return result


def _cross_check(run) -> None:
    """The port's own launch counters, printed beside the benchmark's
    counts: a cross-check, never the count of work behind a metric."""
    try:
        from stable_diffusion_videos_tpu_torch.ops import (flash_attention,
                                                           groupnorm)
        log(f"port counters: flash_attention launches "
            f"{getattr(flash_attention.flash_attention, 'launches', '?')}, "
            f"fused_groupnorm_silu launches "
            f"{getattr(groupnorm.fused_groupnorm_silu, 'launches', '?')}")
    except Exception as e:  # the counters are not the yardstick
        log(f"port counters unavailable: {e!r}")


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(prog="python3 -m portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # build and kernel caches at fixed paths inside the checkout
    cache = ROOT / ".portbench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"
    import torch
    chips = resolve(ROOT, args.workload)["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); torch.cuda.is_available() = "
            f"{torch.cuda.is_available()}, device_count() = "
            f"{torch.cuda.device_count()}")
        return 3
    log(f"card: {power_limit()}")
    result = run_workload(ROOT, args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", t0)
    found = forbidden_modules()
    if found:
        log(f"the run loaded forbidden modules: {found}")
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
