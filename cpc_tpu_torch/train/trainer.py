"""Trainer: the loop around the step, on one device.

Port of the single-device path of `cpc_tpu/train/trainer.py::Trainer`: the
step loop over the Batcher (whose thread assembles the next int16 batch
while the device runs this one), logging of loss, accuracy, grad_norm and
`audio_sec_per_sec` every `log_every` steps and at the end, validation every
`eval_every` steps, a checkpoint every `checkpoint_every` steps and at the
end, exact resume (`maybe_resume`), and SIGTERM handling: the loop saves a
checkpoint and returns. The supervisor, multi-host runs and the parallel
modes wait (ROADMAP.md §A9, §A13).
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from typing import Dict, Optional

import torch

from cpc_tpu_torch.config import CPCConfig, to_dict
from cpc_tpu_torch.data.dataset import SnippetDataset
from cpc_tpu_torch.data.loader import Batcher, to_device
from cpc_tpu_torch.train.checkpoint import CheckpointManager
from cpc_tpu_torch.train.metrics import MetricWriter
from cpc_tpu_torch.train.train_step import init_state, make_step_fns


class Trainer:
    def __init__(
        self,
        cfg: CPCConfig,
        train_dataset: SnippetDataset,
        val_dataset: Optional[SnippetDataset] = None,
        workdir: Optional[str] = None,
        device="cuda",
    ):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = init_state(cfg, self.device)
        self.steps = make_step_fns(cfg, self.model)
        self.batcher = Batcher(
            train_dataset, cfg.data.batch_size, shuffle=cfg.data.shuffle,
            seed=cfg.train.seed, prefetch=cfg.data.prefetch,
            transfer_dtype=cfg.data.transfer_dtype,
            num_workers=cfg.data.num_workers)
        self.val_batcher = None
        if val_dataset is not None:
            self.val_batcher = Batcher(
                val_dataset, cfg.data.batch_size, shuffle=False, seed=0,
                transfer_dtype=cfg.data.transfer_dtype)
        self.writer = MetricWriter(workdir)
        self.ckpt = (CheckpointManager(
            os.path.join(workdir, cfg.train.checkpoint_dir),
            cfg.train.keep_checkpoints) if workdir else None)
        if workdir:
            # the resolved config, so a run can be reproduced and resumed
            os.makedirs(workdir, exist_ok=True)
            with open(os.path.join(workdir, "config.json"), "w") as f:
                json.dump(to_dict(cfg), f, indent=1)
        self.step = 0
        self.preempted = False

    def maybe_resume(self) -> bool:
        """Restores the newest checkpoint if there is one; True if it did."""
        if self.ckpt is None:
            return False
        got = self.ckpt.restore_latest(map_location=self.device)
        if got is None:
            return False
        self.model.load_state_dict(got["model"])
        self.steps.optimizer.load_state_dict(got["optimizer"])
        self.step = int(got["meta"]["step"])
        self.batcher.restore(got["meta"]["batcher"])
        return True

    def _save(self) -> None:
        self.ckpt.save(self.step, self.model.state_dict(),
                       self.steps.optimizer.state_dict(),
                       self.batcher.state())

    # distinct from None: signal.signal() returns None when the previous
    # handler was installed from C, and that case must still be restored
    _NOT_INSTALLED = object()

    def _install_sigterm_handler(self):
        """SIGTERM (a preemption notice) flags the loop, which saves and
        returns. Handlers exist only in the main thread; elsewhere this is
        a no-op."""
        if threading.current_thread() is not threading.main_thread():
            return self._NOT_INSTALLED

        def handler(signum, frame):
            self.preempted = True
        return signal.signal(signal.SIGTERM, handler)

    def train(self, num_steps: Optional[int] = None) -> Dict:
        total = num_steps if num_steps is not None else self.cfg.train.num_steps
        self.preempted = False
        prev = self._install_sigterm_handler()
        try:
            return self._train_loop(total)
        finally:
            if prev is not self._NOT_INSTALLED:
                signal.signal(signal.SIGTERM,
                              prev if prev is not None else signal.SIG_DFL)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _train_loop(self, total: int) -> Dict:
        data = self.cfg.data
        audio_sec_per_batch = (data.batch_size * data.snippet_samples
                               / data.sample_rate)
        it = iter(self.batcher)
        try:
            return self._run(it, total, audio_sec_per_batch)
        finally:
            it.close()  # stops the prefetch thread

    def _run(self, it, total: int, audio_sec_per_batch: float) -> Dict:
        cfg = self.cfg.train
        last: Dict = {}
        self._sync()
        t_log, since_log = time.perf_counter(), 0
        while self.step < total:
            _, _, host_batch = next(it)
            metrics = self.steps.train_step(to_device(host_batch,
                                                      self.device))
            self.step += 1
            since_log += 1
            end = self.step == total
            if self.step % cfg.log_every == 0 or end:
                self._sync()  # the clock reads finished work
                dt = max(time.perf_counter() - t_log, 1e-9)
                last = {k: v.float().cpu() for k, v in metrics.items()}
                last["audio_sec_per_sec"] = since_log * audio_sec_per_batch / dt
                last["steps_per_sec"] = since_log / dt
                self.writer.write(self.step, last, "train")
                t_log, since_log = time.perf_counter(), 0
            if self.val_batcher is not None and self.step % cfg.eval_every == 0:
                self.writer.write(self.step, self.validate(), "val")
            saved = False
            if self.ckpt is not None and (
                    self.step % cfg.checkpoint_every == 0 or end):
                self._save()
                saved = True
            if self.preempted:
                if self.ckpt is not None and not saved:
                    self._save()
                self.writer.write(self.step, {"preempted": 1.0, **last},
                                  "train")
                break
        return last

    def validate(self, max_batches: int = 50) -> Dict:
        """Mean InfoNCE loss and per-k accuracy over the validation set."""
        if self.val_batcher is None:
            raise ValueError("validate() needs a validation dataset")
        agg: Dict = {}
        n = 0
        for i, (_, _, host_batch) in enumerate(self.val_batcher.one_epoch()):
            if i >= max_batches:
                break
            m = self.steps.eval_step(to_device(host_batch, self.device))
            for k, v in m.items():
                agg[k] = agg.get(k, 0.0) + v.float().cpu()
            n += 1
        return {k: v / max(n, 1) for k, v in agg.items()}

    def close(self) -> None:
        self.writer.close()
        self.batcher.close()
        if self.val_batcher is not None:
            self.val_batcher.close()
