"""Host spans from the benchmark's own files, and the reduction of a
``torch.profiler`` trace to device time by kernel family, the device's
busy and idle time and the longest idle gaps by what the host was doing.

The family table is ``runtime/profile.py``'s (``FAMILIES``), copied and
widened: besides the port's kernels (``flash_``, ``gn_``) it names the
kernels PyTorch itself may choose for the same functions (flash and
memory-efficient SDPA, cuDNN's fused attention, native ``group_norm``),
so that a change of implementation moves the time, not the yardstick.
"""

from __future__ import annotations

import contextlib
import threading
import time

#: kernel-name fragments -> family, the first match wins
FAMILIES = (
    # attention: the port's kernels, SDPA's flash / memory-efficient /
    # cuDNN routes
    ("flash_fwd", "attention"), ("flash_wgmma", "attention"),
    ("flash_attn", "attention"), ("pytorch_flash", "attention"),
    ("fmha", "attention"), ("efficient_attention", "attention"),
    ("cudnn_generated_fort_native_sdpa", "attention"),
    ("sdpa", "attention"),
    # GroupNorm(+SiLU): the port's kernels, PyTorch's native group_norm
    ("gn_silu", "groupnorm"), ("gn_apply", "groupnorm"),
    ("gn_partials", "groupnorm"), ("groupnorm", "groupnorm"),
    ("group_norm", "groupnorm"), ("computefusedparams", "groupnorm"),
    ("conv", "convolution"), ("cudnn", "convolution"),
    ("xmma", "convolution"), ("implicit_gemm", "convolution"),
    ("gemm", "matmul"), ("nvjet", "matmul"), ("cutlass", "matmul"),
    ("memcpy", "copies"), ("memset", "copies"),
)


def family(name: str) -> str:
    low = name.lower()
    return next((f for frag, f in FAMILIES if frag in low), "elementwise")


class Spans:
    """Host spans around the calls into the program's layers.  Off, a
    span costs one attribute check; on, it records (name, start, end,
    thread) and, under a profiler, marks the trace with the span's name."""

    def __init__(self, on: bool = False):
        self.on = on
        self.records: list = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        import torch
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            with self._lock:
                self.records.append((name, t0, time.perf_counter(),
                                     threading.get_ident()))

    def wrap(self, obj, attr: str, name: str):
        """Replace ``obj.attr`` (a method) on this instance by one that
        runs inside a span."""
        fn = getattr(obj, attr)

        def spanned(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)
        setattr(obj, attr, spanned)

    def seconds(self) -> dict:
        out: dict = {}
        for name, t0, t1, _ in self.records:
            out[name] = out.get(name, 0.0) + (t1 - t0)
        return out


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _events(prof):
    """(name, on the device, is an annotation, start ns, end ns) of every
    event: from the profiler's raw results (building ``prof.events()``'s
    tree takes a minute for one pndm-50 dispatch)."""
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        yield (e.name(), e.device_type() == DeviceType.CUDA,
               e.is_user_annotation(), start, start + e.duration_ns())


def reduce_profile(prof, stretch: str, span_names, window_s: float) -> dict:
    """Device time by family and kernel, busy seconds (the union of every
    device activity but the annotations the spans mirror on the device
    timeline), the idle gaps labelled by the innermost of the benchmark's
    spans open at the gap's middle, within the annotation ``stretch``.
    ``window_s``: the stretch's wall seconds by the host clock."""
    marks_names = set(span_names) | {stretch}
    dev, marks = [], []
    for name, on_dev, note, a, b in _events(prof):
        if on_dev and not note and name not in marks_names:
            dev.append((name, a, b))
        elif not on_dev and name in marks_names:
            marks.append((name, a, b))
    outer = [m for m in marks if m[0] == stretch]
    lo, hi = ((outer[0][1], outer[0][2]) if outer else
              (min((d[1] for d in dev), default=0),
               max((d[2] for d in dev), default=0)))
    kernels: dict = {}
    families: dict = {}
    for name, a, b in dev:
        s = (b - a) * 1e-9
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += s
        k[1] += 1
        families[family(name)] = families.get(family(name), 0.0) + s
    busy = _union([(max(a, lo), min(b, hi)) for _, a, b in dev
                   if b > lo and a < hi])
    busy_s = sum(b - a for a, b in busy) * 1e-9
    gaps, at = [], lo
    for a, b in busy + [[hi, hi]]:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    inner = sorted((m for m in marks if m[0] != stretch),
                   key=lambda m: m[2] - m[1])
    by_label: dict = {}
    for a, b in gaps:
        mid = (a + b) / 2
        label = next((m[0] for m in inner if m[1] <= mid <= m[2]),
                     "outside any span")
        by_label[label] = by_label.get(label, 0.0) + (b - a) * 1e-9
    return {
        "window_s": window_s,
        "busy_s": busy_s,
        "families": families,
        "kernels": sorted(([n, s, c] for n, (s, c) in kernels.items()),
                          key=lambda k: -k[1]),
        "idle_gaps": sorted(by_label.items(), key=lambda g: -g[1]),
    }
