"""Host batching with a prefetch thread, and the host-to-device hand-off.

Port of `cpc_tpu/data/loader.py`: `Batcher` yields (epoch, step, batch)
with int16 batches (B, S) assembled by a background thread while the device
runs the previous step, in an order fixed by (seed, epoch): numpy's
`default_rng((seed, epoch))` shuffle, so both packages give the same batches
(tests/test_torch_port_data.py). Its state is (seed, epoch, pos), which a
checkpoint stores for exact resume. `to_device` copies the int16 batch
through a pinned host buffer with a non-blocking copy; `device_prepare`
dequantizes and normalizes on the device. Under data parallelism every rank
runs the same Batcher, so every rank assembles the same global batch and
keeps the same state; each takes its rows (`parallel.multihost.
shard_batch`) before `to_device`, so that it copies only its own share.

The device-resident corpus (`data.device_corpus`): `load_device_corpus`
uploads every snippet once as one (N, S) int16 tensor, and the Batcher
built with `yield_indices` yields the (B,) int32 snippet indices instead
of the batch, in the same (seed, epoch, pos) order with the same resume
state; the step gathers its rows on the device.
"""

from __future__ import annotations

import concurrent.futures
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from cpc_tpu_torch.data.dataset import SnippetDataset
from cpc_tpu_torch.ops.dsp import prepare_waveform


def device_prepare(batch: torch.Tensor, normalize: bool = True
                   ) -> torch.Tensor:
    """Device half of the pipeline: int16 -> float32, normalized."""
    return prepare_waveform(batch, normalize=normalize)


def to_device(batch: np.ndarray, device) -> torch.Tensor:
    """Host batch -> tensor on `device`. To a GPU the copy goes through a
    pinned buffer and does not block the host; PyTorch's pinned-memory
    allocator keeps that buffer until the copy has run."""
    host = torch.from_numpy(np.ascontiguousarray(batch))
    device = torch.device(device)
    if device.type == "cpu":
        return host
    return host.pin_memory().to(device, non_blocking=True)


class Batcher:
    """Iterates (epoch, step, batch (B, S)) with background prefetch; int16
    batches by default (`transfer_dtype`), float32 otherwise. Every batch is
    full: an epoch's last len(dataset) % B snippets are dropped. It starts
    at epoch 0, batch 0; `restore` resumes elsewhere. With `yield_indices`
    it yields the (B,) int32 snippet indices and decodes nothing."""

    def __init__(
        self,
        dataset: SnippetDataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        prefetch: int = 2,
        transfer_dtype: str = "int16",
        num_workers: int = 0,
        yield_indices: bool = False,
    ):
        if len(dataset) < batch_size:
            raise ValueError(
                f"dataset has {len(dataset)} snippets < batch_size {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.transfer_dtype = transfer_dtype
        self.epoch = 0
        self.pos = 0  # batch index within the current epoch
        self.yield_indices = yield_indices
        self._pool = (concurrent.futures.ThreadPoolExecutor(num_workers)
                      if num_workers > 0 else None)

    def state(self) -> dict:
        return {"seed": self.seed, "epoch": self.epoch, "pos": self.pos}

    def restore(self, state: dict) -> None:
        self.seed = int(state["seed"])
        self.epoch = int(state["epoch"])
        self.pos = int(state["pos"])

    def _epoch_order(self, epoch: int) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        return order

    def batches_per_epoch(self) -> int:
        return len(self.dataset) // self.batch_size

    def _assemble(self, order: np.ndarray, b: int) -> np.ndarray:
        idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
        if self.yield_indices:
            return idxs.astype(np.int32)
        getter = (self.dataset.snippet_int16 if self.transfer_dtype == "int16"
                  else self.dataset.__getitem__)
        if self._pool is not None:
            snips = np.stack(list(self._pool.map(getter,
                                                 (int(i) for i in idxs))))
        else:
            snips = np.stack([getter(int(i)) for i in idxs])
        if self.transfer_dtype != "int16":
            snips = snips.astype(np.float32)
        return snips

    def one_epoch(self, epoch: int = 0) -> Iterator[tuple]:
        """One epoch's (epoch, step, batch), synchronously, leaving the
        resumable state alone: the validation iterator."""
        order = self._epoch_order(epoch)
        for b in range(self.batches_per_epoch()):
            yield epoch, b, self._assemble(order, b)

    def __iter__(self) -> Iterator[tuple]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            epoch, pos = self.epoch, self.pos
            try:
                while not stop.is_set():
                    order = self._epoch_order(epoch)
                    n_batches = self.batches_per_epoch()
                    while pos < n_batches and not stop.is_set():
                        q.put((epoch, pos, self._assemble(order, pos)))
                        pos += 1
                    epoch, pos = epoch + 1, 0
            except Exception as e:  # surface decode errors to the consumer
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                epoch, pos, batch = item
                # .state() after a yield resumes at the next batch
                self.epoch, self.pos = epoch, pos + 1
                if self.pos >= self.batches_per_epoch():
                    self.epoch, self.pos = epoch + 1, 0
                yield epoch, pos, batch
        finally:
            stop.set()
            # drain so the producer can leave its q.put; broad except: this
            # also runs at interpreter shutdown, where module globals may
            # already be gone
            while not q.empty():
                try:
                    q.get_nowait()
                except Exception:
                    break

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)


def load_device_corpus(dataset: SnippetDataset, device,
                       budget_bytes: int = 4 << 30) -> torch.Tensor:
    """Every snippet of `dataset` as one (N, S) int16 tensor on `device`,
    uploaded in one copy, for the device_corpus step to index. Raises when
    the corpus exceeds `budget_bytes`: the card's memory also holds the
    parameters, gradients, optimizer state and activations."""
    n = len(dataset)
    s = len(dataset.snippet_int16(0))
    total = n * s * 2
    if total > budget_bytes:
        raise ValueError(
            f"device_corpus: corpus is {total / 2**30:.2f} GiB "
            f"({n} snippets x {s} samples) > the {budget_bytes / 2**30:.0f} "
            "GiB HBM budget; use the host streaming path (or a packed "
            "memmap corpus) instead")
    host = np.empty((n, s), np.int16)
    for i in range(n):
        host[i] = dataset.snippet_int16(i)
    return torch.from_numpy(host).to(device)
