"""Profiler traces, the program's host spans and the numerics debug switch.

Port of `cpc_tpu/utils/profiling.py`, with spans of its own:

  * `sync(x)` waits for x's device and returns a float fetched from it,
    so a clock read after it sees finished work.
  * `span(name)` marks a phase of the trainer or the step on the host
    (`train/trainer.py`, `train/train_step.py`: `trainer.feed`,
    `step.forward`, `step.optimizer`, ...). While no one records, it
    returns one shared no-op object: no allocation and no clock read.
    Between `record_spans()` and `take_spans()` each closed span is kept
    in memory as (start_ns, end_ns, name, thread id) on `time.time_ns`,
    the wall clock that a `torch.profiler` trace's `baseTimeNanoseconds`
    places its own timestamps on; a span still open at `take_spans()` is
    dropped. The thread id is the system's (`threading.get_native_id`),
    as the profiler's trace names threads, read once a thread: it is a
    system call, which costs microseconds where system calls are trapped.
  * `trace(log_dir)` records a `torch.profiler` region (CPU, and CUDA where
    there is a GPU) and writes its Chrome trace under `log_dir`, which
    TensorBoard's profile plugin and chrome://tracing read, with the
    program's spans of the region as complete events of category
    `program_span`. Unlike the JAX package, a profiler that fails to start
    or to write raises.
  * `enable_nan_debug()` turns on autograd's anomaly mode, the counterpart
    of `jax_debug_nans`: a backward function that returns NaN raises with
    the forward's traceback, and the training step (`train.train_step`)
    checks its loss and gradients and raises FloatingPointError at the
    first non-finite value, naming the step and the pass.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import List, Optional, Tuple

import torch

#: a closed span: (start_ns, end_ns, name, thread id)
Span = Tuple[int, int, str, int]
SPAN_CATEGORY = "program_span"

_spans: Optional[List[Span]] = None  # the recording's list, None when off
_thread = threading.local()


def sync(x) -> float:
    """Waits for the device of x (a tensor, or the first of a dict or
    sequence of them); returns its sum."""
    if not isinstance(x, torch.Tensor):
        x = next(iter(x.values() if isinstance(x, dict) else x))
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    return float(x.detach().float().sum())


class _Off:
    """The span of a process that records none."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "into", "start")

    def __init__(self, name: str, into: List[Span]):
        self.name, self.into = name, into

    def __enter__(self):
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.time_ns()
        if self.into is _spans:  # else its recording stopped while open
            self.into.append((self.start, end, self.name, _native_id()))
        return False


def _native_id() -> int:
    try:
        return _thread.id
    except AttributeError:
        _thread.id = threading.get_native_id()
        return _thread.id


def span(name: str):
    """A context manager around one phase named `name`."""
    if _spans is None:
        return _OFF
    return _Span(name, _spans)


def record_spans() -> None:
    """Starts keeping the spans that open from now on."""
    global _spans
    if _spans is not None:
        raise RuntimeError("the program's spans are already being recorded")
    _spans = []


def take_spans() -> List[Span]:
    """Stops recording; the spans closed since `record_spans()`, by start
    (an enclosing span before those it holds)."""
    global _spans
    if _spans is None:
        raise RuntimeError("the program's spans are not being recorded")
    got, _spans = _spans, None
    return sorted(got, key=lambda s: (s[0], -s[1]))


@contextlib.contextmanager
def trace(log_dir: str):
    """A torch.profiler region; its Chrome trace, with the program's spans
    of the region, goes to `<log_dir>/trace.json` when the region ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    record_spans()
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield prof
    finally:
        spans = take_spans()
    prof.export_chrome_trace(path)
    if not os.path.getsize(path):
        raise RuntimeError(f"the profiler wrote an empty trace to {path}")
    _add_spans(path, spans)


def _add_spans(path: str, spans: List[Span]) -> None:
    """Writes `spans` into the Chrome trace at `path` as complete events,
    in its microseconds from its `baseTimeNanoseconds`."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc["baseTimeNanoseconds"])
    pid = os.getpid()
    doc["traceEvents"].extend(
        {"ph": "X", "cat": SPAN_CATEGORY, "name": name, "pid": pid,
         "tid": tid, "ts": (a - base) / 1e3, "dur": (b - a) / 1e3}
        for a, b, name, tid in spans)
    with open(path, "w") as f:
        json.dump(doc, f)


def enable_nan_debug(enable: bool = True) -> None:
    """Turns autograd's anomaly mode, and with it the step's finiteness
    checks, on (or off)."""
    torch.autograd.set_detect_anomaly(enable)
