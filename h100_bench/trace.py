"""The traced part of a window: `torch.profiler` over a bounded run of
steady steps, and what the per-layer readers take from its trace.

The profiler records the card's activity alone (CUPTI: kernels, copies,
fills), so that the host runs the program at its own pace: recording every
host operation as well doubled a `tpu_fast` step's host time on an H100.
A device second is busy when any operation runs in it: the union of their
intervals, never their sum, since NCCL's kernels run beside the compute
stream's. Each operation belongs to the first stage (`stages/*.json`, by
priority) one of whose patterns its name contains, else to "rest". Host
spans are the harness's own, around its calls into the program, on the
wall clock (`time.time_ns`), which the trace's timestamps share once its
`baseTimeNanoseconds` is added; an idle gap of the device is put down to
the innermost span open at its middle.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
REST = "rest"
NO_SPAN = "trainer loop"
TOP_OPS = 25


@dataclasses.dataclass
class TraceSummary:
    steps: int                  # training steps inside the traced window
    window_s: float
    busy_s: float               # union of every device operation
    busy_s_without: Dict[str, float]   # union without one stage's ops
    stage_s: Dict[str, float]   # summed device seconds by stage
    span_s: Dict[str, float]    # summed host seconds by span
    gaps: List[Tuple[str, int, float, float]]  # (span, count, total, longest)
    top_ops: List[Tuple[str, str, float]]  # (operation, stage, seconds)


def classify(name: str, stages: List[dict]) -> str:
    low = name.lower()
    for s in stages:
        if any(p in low for p in s["patterns"]):
            return s["name"]
    return REST


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def summarize(events: List[dict], spans: List[Tuple[float, float, str]],
              stages: List[dict], steps: int) -> TraceSummary:
    """The summary of chrome-trace `events` and host `spans` (start, end,
    name), both in the trace's microseconds, of `steps` traced steps. The
    window runs from the first span's start to the end of the last device
    operation or span."""
    ops = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e or \
                e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        ops.append((a, b, classify(e.get("name", ""), stages),
                    e.get("name", "")))
    if not ops or not spans:
        raise ValueError(f"trace has {len(ops)} device operations and "
                         f"{len(spans)} host spans")
    start = min(a for a, _, _ in spans)
    end = max(max(op[1] for op in ops), max(b for _, b, _ in spans))
    kept = [op for op in ops if op[1] > start]
    clipped = [(max(a, start), min(b, end), s) for a, b, s, _ in kept]
    names = [op[3] for op in kept]
    busy = union([(a, b) for a, b, _ in clipped])
    stage_s: Dict[str, float] = defaultdict(float)
    for a, b, s in clipped:
        stage_s[s] += (b - a) * 1e-6
    op_s: Dict[Tuple[str, str], float] = defaultdict(float)
    for (a, b, s), name in zip(clipped, names):
        op_s[name, s] += (b - a) * 1e-6
    top = sorted(op_s.items(), key=lambda kv: -kv[1])[:TOP_OPS]
    without = {s: _length(union([(a, b) for a, b, t in clipped if t != s]))
               * 1e-6 for s in stage_s}
    span_s: Dict[str, float] = defaultdict(float)
    for a, b, s in spans:
        span_s[s] += (b - a) * 1e-6
    return TraceSummary(steps=steps, window_s=(end - start) * 1e-6,
                        busy_s=_length(busy) * 1e-6, busy_s_without=without,
                        stage_s=dict(stage_s), span_s=dict(span_s),
                        gaps=_gaps(busy, spans, start, end),
                        top_ops=[(n, s, t) for (n, s), t in top])


def _gaps(busy, spans, start, end):
    """Idle stretches of the device, grouped by the host span open at each
    one's middle: (span, count, seconds, longest seconds), largest first."""
    holes, at = [], start
    for a, b in busy:
        if a > at:
            holes.append((at, a))
        at = max(at, b)
    if end > at:
        holes.append((at, end))
    spans = sorted(spans)
    starts = [a for a, _, _ in spans]
    by: Dict[str, List[float]] = defaultdict(list)
    for a, b in holes:
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid)
        # the innermost open span: the latest-starting one that covers mid
        name = next((s for sa, sb, s in reversed(spans[:i]) if sb >= mid),
                    NO_SPAN)
        by[name].append((b - a) * 1e-6)
    out = [(name, len(v), sum(v), max(v)) for name, v in by.items()]
    return sorted(out, key=lambda g: -g[2])


class Tracer:
    """Profiles the training steps `start` .. `start + count - 1` of a
    window: the step wrapper calls `before(i)` and `after(i)` around step
    i. The profiler stops after a device sync, so the trace holds every
    operation the traced steps enqueued."""

    def __init__(self, start: int, count: int, stages: List[dict]):
        self.start, self.count, self.stages = start, count, stages
        self.prof = None
        self.done = 0
        self.summary = None
        self.spans: List[Tuple[int, int, str]] = []

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CUDA])

    def warm(self, device) -> None:
        """Starts and stops the profiler once on `device`, so that CUPTI's
        start-up falls in set-up and not in the window."""
        with self._profile():
            torch.ones(1, device=device).add_(1)
            torch.cuda.synchronize(device)

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span named `name` while the profiler runs."""
        if self.prof is None:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((t0, time.time_ns(), name))

    @property
    def active(self) -> bool:
        return self.prof is not None

    def before(self, i: int) -> None:
        if i == self.start and self.summary is None:
            self.prof = self._profile()
            self.prof.start()

    def after(self, i: int) -> None:
        if self.prof is not None:
            self.done += 1
            if self.done >= self.count:
                self.finish()

    def finish(self) -> None:
        """Stops the profiler (if it runs) and reads its trace."""
        if self.prof is None:
            return
        torch.cuda.synchronize()
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.unlink(path)
        self.prof = None
        base = int(trace["baseTimeNanoseconds"])
        spans = [((a - base) / 1e3, (b - base) / 1e3, name)
                 for a, b, name in self.spans]
        self.summary = summarize(trace["traceEvents"], spans, self.stages,
                                 self.done)
