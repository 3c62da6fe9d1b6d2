"""Trainer: the loop around the step, on one device or data-parallel.

Port of `cpc_tpu/train/trainer.py::Trainer`: the step loop over the Batcher
(whose thread assembles the next int16 batch while the device runs this
one), logging of loss, accuracy, grad_norm and `audio_sec_per_sec` every
`log_every` steps and at the end, validation every `eval_every` steps, a
checkpoint every `checkpoint_every` steps and at the end, exact resume
(`maybe_resume`), and SIGTERM handling: the loop saves a checkpoint and
returns.

With a `mesh` (`parallel.mesh.ProcessMesh`, from `parallel.multihost.
initialize`) every rank runs this loop on its card: the same seeded model
and Batcher on every rank, rank 0's state broadcast after init and after a
resume (`multihost.replicate`), each rank's rows of every global batch
(`multihost.shard_batch`) through the data-parallel step, and the ranks'
SIGTERM flags agreed on at every step (`multihost.any_true`), so that all
save at the same step. Rank 0 alone writes the workdir (config.json,
metrics.jsonl, checkpoints; a barrier follows each save); every rank
restores from it. `audio_sec_per_sec` counts the global batch.

Under train.parallel 'cp' | 'dpcp' (context parallelism, `parallel/cp.py`)
the same loop runs the CP steps: the model's gar takes ring attention
(`init_state`), every rank stages the WHOLE global batch (or index vector),
and the step takes its shard after preparing it; checkpoints, metrics and
resume are as under data parallelism. Without a mesh 'cp' runs a ring of
one rank. A 'model' axis under 'dp' (train.mesh_axes data,model) holds
replicas of the model, as in the JAX trainer (`train_step.dp_mesh`).

Under `data.device_corpus` the trainer uploads the training corpus to its
card once (`data.loader.load_device_corpus`; every rank its own copy under
data parallelism), the Batcher yields index vectors in the same order, and
the trainer stages this rank's indices (`multihost.shard_batch`) instead of
its rows of the batch: the step gathers the same rows on the card. The
validation corpus reuses the training corpus when both index the same
snippets. Metrics go to metrics.jsonl and to TensorBoard under
`<workdir>/tb` (`train.metrics`). Supervision (`train.supervisor`),
profiling and nan-debug (`utils.profiling`) wrap `train()` from the CLI.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from typing import Dict, List, Optional

import torch

from cpc_tpu_torch.config import CPCConfig, to_dict
from cpc_tpu_torch.data.dataset import SnippetDataset
from cpc_tpu_torch.data.loader import (Batcher, load_device_corpus,
                                      to_device)
from cpc_tpu_torch.parallel import multihost
from cpc_tpu_torch.train.checkpoint import CheckpointManager
from cpc_tpu_torch.train.metrics import MetricWriter
from cpc_tpu_torch.train.train_step import (dp_mesh, init_state,
                                             make_step_fns)


class Trainer:
    def __init__(
        self,
        cfg: CPCConfig,
        train_dataset: SnippetDataset,
        val_dataset: Optional[SnippetDataset] = None,
        workdir: Optional[str] = None,
        device="cuda",
        mesh=None,
    ):
        self.cfg = cfg
        self.device = torch.device(device)
        self.mesh = mesh
        if mesh is not None and self.device != mesh.device:
            raise ValueError(f"device {self.device} is not the mesh's "
                             f"device {mesh.device} for rank {mesh.rank}")
        if cfg.train.parallel == "dp":
            # a 'model' axis holds replicas: its ranks share their rows
            mesh = self.mesh = dp_mesh(cfg, mesh)
        self.model = init_state(cfg, self.device)
        self.steps = make_step_fns(cfg, self.model, mesh)
        # data parallelism stages this rank's rows; a CP step takes the
        # global batch and shards it itself
        self._rows_of = mesh if cfg.train.parallel == "dp" else None
        if mesh is not None:
            multihost.replicate(self._state_tensors(), mesh)
        dc = cfg.data.device_corpus
        self._corpus = (load_device_corpus(train_dataset, self.device)
                        if dc else None)
        self.batcher = Batcher(
            train_dataset, cfg.data.batch_size, shuffle=cfg.data.shuffle,
            seed=cfg.train.seed, prefetch=cfg.data.prefetch,
            transfer_dtype=cfg.data.transfer_dtype,
            num_workers=cfg.data.num_workers, yield_indices=dc)
        self.val_batcher = None
        self._val_corpus = None
        if val_dataset is not None:
            if dc:
                self._val_corpus = (
                    self._corpus if _same_snippets(val_dataset, train_dataset)
                    else load_device_corpus(val_dataset, self.device))
            self.val_batcher = Batcher(
                val_dataset, cfg.data.batch_size, shuffle=False, seed=0,
                transfer_dtype=cfg.data.transfer_dtype, yield_indices=dc)
        main = multihost.is_main(mesh)
        self.writer = MetricWriter(workdir if main else None, echo=main)
        self.ckpt = (CheckpointManager(
            os.path.join(workdir, cfg.train.checkpoint_dir),
            cfg.train.keep_checkpoints) if workdir else None)
        if workdir and main:
            # the resolved config, so a run can be reproduced and resumed
            os.makedirs(workdir, exist_ok=True)
            with open(os.path.join(workdir, "config.json"), "w") as f:
                json.dump(to_dict(cfg), f, indent=1)
        self.step = 0
        self.preempted = False

    def _state_tensors(self) -> List[torch.Tensor]:
        """The model's and the optimizer's tensors, which every rank holds
        alike."""
        opt = self.steps.optimizer
        return [*self.model.state_dict().values(), *opt.mu.values(),
                *opt.nu.values()]

    def maybe_resume(self) -> bool:
        """Restores the newest checkpoint if there is one; True if it did.
        Under a mesh every rank reads it, then takes rank 0's state."""
        if self.ckpt is None:
            return False
        got = self.ckpt.restore_latest(map_location=self.device)
        if got is not None:
            self.model.load_state_dict(got["model"])
            self.steps.optimizer.load_state_dict(got["optimizer"])
            self.step = int(got["meta"]["step"])
            self.batcher.restore(got["meta"]["batcher"])
        if self.mesh is None:
            return got is not None
        b = self.batcher.state()
        place = torch.tensor([got is not None, self.step,
                              self.steps.optimizer.count, b["seed"],
                              b["epoch"], b["pos"]], dtype=torch.int64)
        multihost.replicate([place, *self._state_tensors()], self.mesh)
        resumed, self.step, self.steps.optimizer.count, *b = place.tolist()
        self.batcher.restore(dict(zip(("seed", "epoch", "pos"), b)))
        return bool(resumed)

    def _save(self) -> None:
        """Rank 0 writes the checkpoint; every rank waits for it."""
        if multihost.is_main(self.mesh):
            self.ckpt.save(
                self.step, multihost.host_local(self.model.state_dict()),
                multihost.host_local(self.steps.optimizer.state_dict()),
                self.batcher.state())
        multihost.barrier(self.mesh)

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

    def _stage(self, host_batch) -> torch.Tensor:
        """This rank's rows of a host batch (or of an index vector), on its
        device; all of them for a CP step."""
        return to_device(multihost.shard_batch(host_batch, self._rows_of),
                         self.device)

    def _train_loop(self, total: int) -> Dict:
        data = self.cfg.data
        # the global batch: every rank steps on its share of it
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
            staged = self._stage(host_batch)
            metrics = (self.steps.train_step(staged) if self._corpus is None
                       else self.steps.train_step(self._corpus, staged))
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
            preempted = self.preempted
            if multihost.active(self.mesh):
                preempted = multihost.any_true(preempted, self.mesh)
            if preempted:
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
            staged = self._stage(host_batch)
            m = (self.steps.eval_step(staged) if self._val_corpus is None
                 else self.steps.eval_step(self._val_corpus, staged))
            for k, v in m.items():
                agg[k] = agg.get(k, 0.0) + v.float().cpu()
            n += 1
        return {k: v / max(n, 1) for k, v in agg.items()}

    def close(self) -> None:
        self.writer.close()
        self.batcher.close()
        if self.val_batcher is not None:
            self.val_batcher.close()


def _same_snippets(a, b) -> bool:
    """True when datasets a and b index the same snippets: the same object,
    or the same kind over the same files at the same snippet geometry."""
    return a is b or (type(a) is type(b) and a.files == b.files
                      and a.snippet_samples == b.snippet_samples
                      and a.snippet_stride == b.snippet_stride)
