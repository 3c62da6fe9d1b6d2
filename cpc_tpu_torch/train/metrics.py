"""Metric logging: JSON lines to stdout and `<workdir>/metrics.jsonl`.

Port of `cpc_tpu/train/metrics.py::MetricWriter` without its TensorBoard
output, which waits (ROADMAP.md A7). One record per call: step, wall time,
prefix ("train" | "val") and the metrics, arrays as lists. Under data
parallelism only rank 0 has a writer with a workdir and an echo.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch


def _scalarize(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().float().cpu().numpy()
    a = np.asarray(v)
    if a.ndim == 0:
        return float(a)
    return [float(x) for x in a.ravel()]


class MetricWriter:
    def __init__(self, workdir: Optional[str] = None, echo: bool = True):
        self.echo = echo
        self._jsonl = None
        if workdir:
            os.makedirs(workdir, exist_ok=True)
            self._jsonl = open(os.path.join(workdir, "metrics.jsonl"), "a",
                               buffering=1)

    def write(self, step: int, metrics: Dict, prefix: str = "train") -> None:
        rec = {"step": step, "time": time.time(), "prefix": prefix}
        rec.update({k: _scalarize(v) for k, v in metrics.items()})
        line = json.dumps(rec)
        if self.echo:
            print(line, flush=True)
        if self._jsonl:
            self._jsonl.write(line + "\n")

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
