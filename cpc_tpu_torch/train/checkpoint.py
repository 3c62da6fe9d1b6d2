"""Checkpoints: `torch.save` of the model, the optimizer, the step and the
batcher's position.

Port of `cpc_tpu/train/checkpoint.py::CheckpointManager`, with orbax's
payload as one file per step, `<dir>/step_<step>.pt`, written to a
temporary name and renamed, so a reader sees all of a file or none. The
newest `max_to_keep` files are kept, as orbax's `max_to_keep`. Saving is
synchronous; resume is exact (the batcher continues at the next batch of the
right epoch, and the optimizer state carries over bit for bit).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> List[int]:
        """Steps of the checkpoints on disk, ascending."""
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self.directory)) if m)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def save(self, step: int, model_state: Dict, opt_state: Dict,
             batcher_state: Dict) -> None:
        payload = {
            "model": model_state,
            "optimizer": opt_state,
            "meta": {"step": int(step),
                     "batcher": {k: int(v) for k, v in batcher_state.items()}},
        }
        tmp = self._path(step) + f".{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))
        if self.max_to_keep > 0:  # 0 keeps every checkpoint
            for old in self.steps()[:-self.max_to_keep]:
                os.remove(self._path(old))

    def restore_latest(self, map_location=None) -> Optional[Dict]:
        """The newest checkpoint's payload ({"model", "optimizer", "meta"}),
        or None when there is none."""
        steps = self.steps()
        if not steps:
            return None
        return torch.load(self._path(steps[-1]), map_location=map_location,
                          weights_only=True)
