"""Step timing, profiler traces and the numerics debug switch.

Port of `cpc_tpu/utils/profiling.py`:

  * `sync(x)` waits for x's device and returns a float fetched from it,
    so a clock read after it sees finished work.
  * `trace(log_dir)` records a `torch.profiler` region (CPU, and CUDA where
    there is a GPU) and writes its Chrome trace under `log_dir`, which
    TensorBoard's profile plugin and chrome://tracing read. Unlike the JAX
    package, a profiler that fails to start or to write raises.
  * `StepTimer` keeps wall-clock step times with a device sync at each
    tick: `summary()` -> steps, mean_ms, p50_ms, p95_ms and, given the
    audio seconds a batch, audio_sec_per_sec.
  * `enable_nan_debug()` turns on autograd's anomaly mode, the counterpart
    of `jax_debug_nans`: a backward function that returns NaN raises with
    the forward's traceback, and the training step (`train.train_step`)
    checks its loss and gradients and raises FloatingPointError at the
    first non-finite value, naming the step and the pass.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch


def sync(x) -> float:
    """Waits for the device of x (a tensor, or the first of a dict or
    sequence of them); returns its sum."""
    if not isinstance(x, torch.Tensor):
        x = next(iter(x.values() if isinstance(x, dict) else x))
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    return float(x.detach().float().sum())


@contextlib.contextmanager
def trace(log_dir: str):
    """A torch.profiler region; its Chrome trace goes to
    `<log_dir>/trace.json` when the region ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)
    if not os.path.getsize(path):
        raise RuntimeError(f"the profiler wrote an empty trace to {path}")


class StepTimer:
    """Wall-clock step timer with a device sync at each tick.

    timer = StepTimer(audio_sec_per_batch); timer.start()
    for ...: out = step(...); timer.tick(out["loss"])
    timer.summary() -> {"steps", "mean_ms", "p50_ms", "p95_ms",
                        "audio_sec_per_sec"}
    The first `warmup` ticks are left out of the summary."""

    def __init__(self, audio_sec_per_batch: Optional[float] = None,
                 warmup: int = 2):
        self.audio_sec_per_batch = audio_sec_per_batch
        self.warmup = warmup
        self._times = []
        self._last = None

    def start(self) -> None:
        self._last = time.perf_counter()

    def tick(self, sync_on) -> float:
        sync(sync_on)
        now = time.perf_counter()
        dt = now - self._last if self._last is not None else 0.0
        self._last = now
        self._times.append(dt)
        return dt

    def summary(self) -> dict:
        ts = np.asarray(self._times[self.warmup:] or self._times)
        out = {
            "steps": int(len(ts)),
            "mean_ms": float(ts.mean() * 1e3),
            "p50_ms": float(np.percentile(ts, 50) * 1e3),
            "p95_ms": float(np.percentile(ts, 95) * 1e3),
        }
        if self.audio_sec_per_batch:
            out["audio_sec_per_sec"] = float(
                self.audio_sec_per_batch / max(ts.mean(), 1e-9))
        return out


def enable_nan_debug(enable: bool = True) -> None:
    """Turns autograd's anomaly mode, and with it the step's finiteness
    checks, on (or off)."""
    torch.autograd.set_detect_anomaly(enable)
