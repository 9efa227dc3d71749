"""Per-stage timing and frames/s of a pipeline, and an optional trace.

Counterpart of ``stable_diffusion_videos_tpu/utils/profiling.py``.
``StageTimer.summary()`` returns a JSON-ready dict of seconds a stage
(embed, denoise, transfer, save, encode, upsample, audio) and the frames
made.  On a CUDA device the work is asynchronous, so a stage that enqueues
device work ends where that work ends: ``stage(name, sync=device)``
synchronizes the device before its clock stops, and ``add(name, seconds)``
takes an interval the caller closed at a copy to the host or an event.
``trace()`` wraps a block in ``torch.profiler`` when ``SDV_PROFILE_DIR`` is
set, and does nothing otherwise.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from collections import defaultdict

import torch

logger = logging.getLogger("sdv_torch")


class StageTimer:
    """Wall-clock seconds by named stage, and the frames made."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.frames = 0
        self._lock = threading.Lock()

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        """Time the block; with ``sync`` (a device), a CUDA device is
        synchronized before the clock stops, so the stage holds the device
        work the block enqueued."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None and torch.device(sync).type == "cuda":
                torch.cuda.synchronize(sync)
            self.add(name, time.perf_counter() - t0)

    def add_frames(self, n: int) -> None:
        with self._lock:
            self.frames += int(n)

    def summary(self) -> dict:
        with self._lock:
            totals, frames = dict(self.totals), self.frames
        total = sum(totals.values())
        out = {"stages_s": {k: round(v, 4) for k, v in totals.items()},
               "total_s": round(total, 4), "frames": frames}
        denoise = totals.get("denoise", 0.0)
        if frames and denoise > 0:
            out["frames_per_s_denoise"] = round(frames / denoise, 3)
        if frames and total > 0:
            out["frames_per_s_total"] = round(frames / total, 3)
        return out

    def log(self, prefix: str = "perf") -> None:
        logger.info("%s %s", prefix, json.dumps(self.summary()))


@contextlib.contextmanager
def trace(name: str = "sdv"):
    """A ``torch.profiler`` trace of the block (CPU and CUDA activity,
    written as a Chrome trace under ``$SDV_PROFILE_DIR/<name>``) when
    ``SDV_PROFILE_DIR`` is set, else nothing."""
    profile_dir = os.environ.get("SDV_PROFILE_DIR")
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = os.path.join(profile_dir, name)
    os.makedirs(out, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out, f"{os.getpid()}.json"))
