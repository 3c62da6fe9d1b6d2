"""The program's own host spans in a traced window, beside the harness's.

The port marks the phases of its trainer and step with spans of its own
(`cpc_tpu_torch/utils/profiling.py`: `trainer.feed`, `trainer.step`,
`step.forward`, `step.backward`, `step.optimizer`, ...), kept in memory on
`time.time_ns`, the clock that `trace.Tracer` already places its spans on.
`ProgramTracer` is `trace.Tracer` that starts the program's recorder with
the profiler and takes its spans when the profiler stops; a program that
has no recorder gives none, and the summary is then the harness's alone.

`summarize_program` is `trace.summarize` over the harness's spans and the
program's together, so that each idle gap is put down to the innermost of
them, and adds what the program's spans alone can say:
  * `self_s`: host seconds by span name, less what the program's spans
    nested in it on the same thread cover;
  * `launches`: the trace's kernel launches (the CUDA runtime's and
    driver's launch calls, a graph's launch counted once) by the innermost
    program span open at the launch's host timestamp, whatever thread made
    it (autograd's device thread launches the backward while the trainer's
    thread waits in `step.backward`);
  * `device_s`: device seconds of each kernel, copy and fill, joined to
    the runtime call that launched it by `args.correlation`, by that call's
    innermost program span;
  * `kernels` and `kernels_joined`: the window's kernels, and those joined
    to a call inside a program span.
Work outside every program span is counted under `trace.NO_SPAN`. The
window, busy time, stages and the harness's span seconds are
`trace.summarize`'s over the harness's spans: a program span that starts
before the window's first harness span is left out, so that none moves
the window.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
import threading
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

from h100_bench.trace import (DEVICE_CATS, NO_SPAN, Tracer, TraceSummary,
                              summarize)

RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
            "cuLaunchKernelEx", "cudaGraphLaunch")

# (start, end, name, thread id), in the trace's microseconds
ProgramSpan = Tuple[float, float, str, int]


@dataclasses.dataclass
class ProgramTraceSummary(TraceSummary):
    self_s: Dict[str, float]    # host seconds by span, less nested spans
    launches: Dict[str, int]    # kernel launches by innermost program span
    device_s: Dict[str, float]  # device seconds by the launch's span
    kernels: int                # kernels in the window
    kernels_joined: int         # of them, launched inside a program span


def _corr(event: dict) -> Optional[int]:
    return (event.get("args") or {}).get("correlation")


def _self_seconds(spans: List[ProgramSpan],
                  program: List[ProgramSpan]) -> Dict[str, float]:
    """Host seconds by name of `spans`, each less the outermost of the
    `program` spans nested in it on its thread (one thread's spans nest:
    they are context managers)."""
    by_thread: Dict[int, List[ProgramSpan]] = defaultdict(list)
    for s in sorted(program, key=lambda s: (s[0], -s[1])):
        by_thread[s[3]].append(s)
    starts = {t: [s[0] for s in v] for t, v in by_thread.items()}
    out: Dict[str, float] = defaultdict(float)
    for span in spans:
        a, b, name, tid = span
        mine = by_thread.get(tid, [])
        covered, reach = 0.0, a
        for s in mine[bisect.bisect_left(starts.get(tid, []), a):]:
            if s[0] >= b:
                break
            if s is span or s[1] > b or s[0] < reach:
                continue
            covered += s[1] - s[0]
            reach = s[1]
        out[name] += (b - a - covered) * 1e-6
    return dict(out)


def _innermost(times: List[float],
               spans: List[ProgramSpan]) -> List[str]:
    """The innermost of the nested `spans` open at each of the sorted
    `times` (NO_SPAN where none is)."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else NO_SPAN)
    return out


def summarize_program(events: List[dict],
                      spans: List[Tuple[float, float, str]],
                      program: List[ProgramSpan], stages: List[dict],
                      steps: int, harness_thread: int
                      ) -> ProgramTraceSummary:
    """`trace.summarize` of `events` over the harness's `spans` (start,
    end, name; run on thread `harness_thread`) and the program's spans
    `program`, all in the trace's microseconds, with the program's
    accounts."""
    start = min(a for a, _, _ in spans) if spans else 0.0
    program = [s for s in program if s[0] >= start]
    base = summarize(events, spans + [(a, b, n) for a, b, n, _ in program],
                     stages, steps)
    end = start + base.window_s * 1e6
    self_s = _self_seconds(
        [(a, b, n, harness_thread) for a, b, n in spans] + program, program)

    calls = sorted((float(e["ts"]), e) for e in events
                   if e.get("cat") in RUNTIME_CATS and e.get("ph") == "X"
                   and start <= float(e.get("ts", -1)) <= end)
    owner = _innermost([t for t, _ in calls], program)
    span_of: Dict[int, str] = {}
    launches: Dict[str, int] = defaultdict(int)
    for (_, e), name in zip(calls, owner):
        if _corr(e) is not None:
            span_of[_corr(e)] = name
        if e.get("name") in LAUNCHES:
            launches[name] += 1
    device_s: Dict[str, float] = defaultdict(float)
    kernels = joined = 0
    for e in events:
        if e.get("ph") != "X" or "dur" not in e or \
                e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if b <= start:
            continue
        name = span_of.get(_corr(e), NO_SPAN)
        device_s[name] += (min(b, end) - max(a, start)) * 1e-6
        if e.get("cat") == "kernel":
            kernels += 1
            joined += name != NO_SPAN
    fields = {f.name: getattr(base, f.name)
              for f in dataclasses.fields(TraceSummary)}
    return ProgramTraceSummary(**fields, self_s=self_s,
                               launches=dict(launches),
                               device_s=dict(device_s), kernels=kernels,
                               kernels_joined=joined)


def _recorder():
    """The program's (record, take) pair, or None for a program that has
    no span recorder."""
    try:
        from cpc_tpu_torch.utils.profiling import record_spans, take_spans
    except ImportError:
        return None
    return record_spans, take_spans


class ProgramTracer(Tracer):
    """`trace.Tracer` that records the program's spans over the traced
    steps and summarizes them with the trace (`summarize_program`)."""

    def __init__(self, start: int, count: int, stages: List[dict]):
        super().__init__(start, count, stages)
        self._take = None
        self.thread = None  # the stepping thread's id, set at the start

    def before(self, i: int) -> None:
        starting = self.prof is None and self.summary is None
        super().before(i)
        if starting and self.prof is not None:
            rec = _recorder()
            if rec is not None:
                rec[0]()
                self._take = rec[1]
            self.thread = threading.get_native_id()

    def finish(self) -> None:
        if self.prof is None:
            return
        program = self._take() if self._take is not None else []
        self._take = None
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

        def us(t):
            return (t - base) / 1e3
        spans = [(us(a), us(b), name) for a, b, name in self.spans]
        prog = [(us(a), us(b), name, tid) for a, b, name, tid in program]
        self.summary = summarize_program(trace["traceEvents"], spans, prog,
                                         self.stages, self.done,
                                         self.thread)
