"""The check's control, read on the card at a cell's own size:

    python3 -m portbench.control --workload <name> --seeds <n> ... \
        [--seconds 1] [--out control.json]

For each seed, one run of the cell with a short window (its longest walk
or request still runs whole and is compared as in a run), then the
checked frames worked out twice by the reference: in float32 (what a run
compares against) and in float8 e4m3 (``reference.models.fp8_fake`` on
every linear layer's and convolution's weight and input), the precision
below the configuration's bfloat16.  Prints, a seed a line, the program's
numbers and the control's.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import time

from .run import ROOT, log, run_workload


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        log("needs a CUDA device")
        return 3
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = run_workload(ROOT, args.workload, seed, args.seconds, False,
                         "cuda", control=True)
        row = {"seed": seed, "program": {k: c["value"] for k, c in
                                         r["checks"].items()},
               "control": r["control"], "correct": r["correct"],
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "rows": rows}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
