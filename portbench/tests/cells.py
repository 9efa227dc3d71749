"""Tiny cells for the CPU tests: a copy of the benchmark (``BENCHMARK.json``
and ``portbench/``) in a temporary directory, with a configuration, a
traffic mix, limits and a workload added as new files and entries, the way
a later change adds a cell."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"

WALK = {"entry": "walk", "sampler": "pndm", "steps": 3, "guidance": 7.5,
        "batch": 2, "prompts_per_walk": 3, "interpolation_steps": 3,
        "fps": 30, "make_video": True, "warmup_steps": 2,
        "prompt_words": [5, 20],
        "words": ["red", "fox", "snow", "old", "city", "night", "lantern",
                  "river", "painting", "of", "a", "the"]}
#: the server takes sides of 64 pixels or more
SERVE = dict(WALK, entry="serve", steps=3, rate_per_s=4.0, max_batch=4,
             batch_delay_ms=25, client_threads=8, drain_s=60,
             profile_seconds=1, height=64, width=64)
#: limits of the tiny cells: the program in bfloat16 reads about 0.2-0.5
#: levels of mean difference and at most 3 at a pixel from the float32
#: reference here, the float8 control 3-4.5 on the mean
LIMITS = {"frame_mae": {"limit": 1.5}, "pixel_max": {"limit": 16.0}}


def copy_benchmark(dst: Path) -> Path:
    dst = Path(dst)
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dst


def add_cell(root: Path, name: str, config: str, mix: dict,
             sample: dict | None = None, limits: dict | None = None) -> str:
    """A workload ``name`` of the tiny ``config`` (``tests/data``) under
    ``mix``, added as new files and manifest entries."""
    root = Path(root)
    b = json.loads((root / "BENCHMARK.json").read_text())
    if config not in {c["name"] for c in b["configs"]}:
        shutil.copy(DATA / f"{config}.json",
                    root / "portbench" / "configs" / f"{config}.json")
        b["configs"].append({"name": config, "source": "tests/data",
                             "file": f"portbench/configs/{config}.json",
                             "reduced": [], "why": "tiny"})
    (root / "portbench" / "traffic" / f"{name}.json").write_text(
        json.dumps(mix))
    (root / "portbench" / "limits" / f"{name}.json").write_text(json.dumps(
        {"sample": sample or {"per_walk": 1, "frames": 2, "block": 2},
         "numbers": limits or LIMITS}))
    b["workloads"].append({"name": name, "config": config, "traffic": name,
                           "chips": 1, "why": "tiny"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m and (m["name"].endswith(
                ".serve" if mix["entry"] == "serve" else ".walk")
                or m["name"] == ("images_per_s" if mix["entry"] == "serve"
                                 else "frames_per_s")):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return name
