"""The serving cells' capacity sweep, read once on the card:

    python3 -m portbench.sweep --workload <serve cell> --seed <n> \
        --seconds 20 --rates 2 3 4 5 [--repeat 1] [--out sweep.json]

One set-up, then ``--repeat`` windows a rate (each on the next seed) of
the cell's open loop with the mix's rate replaced: each window's p50, p95
and mean latency, the requests due by the window's end whose dispatch had
not begun then (the backlog), and the queue wait of the window's first
and second half (a backlog that grows shows as a second half that waits
longer).  The highest rate whose backlog stays flat is the capacity.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json

from .run import ROOT, log, resolve
from .stats import percentile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--repeat", type=int, default=1,
                    help="windows a rate, each on the next seed")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import types

    import torch

    from . import port, reference, traces, weights
    if not torch.cuda.is_available():
        log("needs a CUDA device")
        return 3
    cell = resolve(ROOT, args.workload)
    config, mix, entry = cell["config"], cell["mix"], cell["entry"]
    import tempfile
    from pathlib import Path
    f = 2 ** (len(config["vae"]["block_out_channels"]) - 1)
    side = config["unet"]["sample_size"] * f
    run = types.SimpleNamespace(
        root=ROOT, name=args.workload, config=config, mix=dict(mix),
        limits=cell["limits"], seed=args.seed, seconds=args.seconds,
        trace=False, device="cuda", spans=traces.Spans(),
        out_dir=Path(tempfile.mkdtemp(prefix="portbench-sweep-")),
        height=mix.get("height", side), width=mix.get("width", side),
        log=log)
    shapes = reference.models.build(config)
    run.models = port.bundle(config, weights.draw(
        shapes, args.seed, config["weight_std"],
        weights.DTYPES[config["dtype"]], "cuda"), "cuda")
    state = entry.setup(run)
    rows = []
    for rate, k in [(r, k) for r in args.rates for k in range(args.repeat)]:
        run.mix = dict(mix, rate_per_s=rate)
        run.seed = args.seed + k
        state["dispatches"].clear()
        w = entry.window(run, state)
        recs = w["records"]
        start = min(r["due"] for r in recs)
        end = start + args.seconds
        began = {}
        for t0, _, seeds in state["dispatches"]:
            for s in seeds:
                began.setdefault(s, t0)
        backlog = sum(1 for r in recs if began.get(r["seed"], 1e30) > end)
        half = start + args.seconds / 2
        wait = [(r["due"] < half, began[r["seed"]] - r["due"])
                for r in recs if r["seed"] in began]
        first = [x for h, x in wait if h]
        second = [x for h, x in wait if not h]
        row = {"rate_per_s": rate, "seed": run.seed,
               "requests": len(recs), "late_max_s": w["late_s"],
               "mean_s": sum(w["latencies"]) / len(recs),
               "failed": w["failed"],
               "p50_s": percentile(w["latencies"], 50),
               "p95_s": percentile(w["latencies"], 95),
               "backlog_at_end": backlog,
               "wait_first_half_mean_s": sum(first) / max(1, len(first)),
               "wait_second_half_mean_s": sum(second) / max(1, len(second)),
               "rows_mean": sum(w["dispatch_rows"])
               / max(1, len(w["dispatch_rows"])),
               "images_per_s": (len(recs) - w["failed"]) / w["seconds"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    entry.teardown(run, state)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"workload": args.workload, "rows": rows}, fh,
                      indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
