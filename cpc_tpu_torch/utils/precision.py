"""fp32 computes in fp32, the same bits every run: TF32 off around a call
that runs an fp32 model's convs and products on the card, and cuDNN's
deterministic algorithms around the fp32 conv backwards that need them.

torch's defaults let cuDNN round fp32 conv inputs to TF32's 10-bit
mantissa (`torch.backends.cudnn.allow_tf32 = True`), so an fp32 model on
the card would not compute what the JAX package's fp32 presets compute
(ROADMAP C15). The port sets the flags for the length of a call instead
of process-wide: the training and evaluation steps
(`train/train_step.py`, `parallel/cp.py`, `parallel/tp.py`), offline
extraction (`eval/features.py`), the probes' extraction
(`eval/probes.py`), streams and served artifacts (`eval/streaming.py`,
`serve.py`). Outside the call the flags read as the caller left them, and
a bf16 or fp16 model keeps them as they are (`exact_for`).

cuDNN's choice of algorithms is the caller's, except in the backward of
the fp32 convs whose default algorithms sum with atomics
(`ops.conv_cuda._Repeatable`: the conv1d encoder's first layer, the
scalogram encoder's Conv2d layers; ROADMAP C16), which runs inside
`cudnn_deterministic()`.
"""

from __future__ import annotations

import contextlib
import threading

import torch


class _Scoped:
    """`flags` ((module, name, value), ...) set inside a block, the
    caller's restored after. The process's flags are global, and ranks
    played by threads (`ops.ring_util.run_thread_ranks`) enter and leave
    their blocks in any order: the first block in saves the caller's flags
    and sets them, the last one out restores them."""

    def __init__(self, flags):
        self._flags = flags
        self._lock = threading.Lock()
        self._depth = 0
        self._kept = None

    @contextlib.contextmanager
    def __call__(self):
        with self._lock:
            if self._depth == 0:
                self._kept = [getattr(m, k) for m, k, _ in self._flags]
                for m, k, v in self._flags:
                    setattr(m, k, v)
            self._depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._depth -= 1
                if self._depth == 0:
                    for (m, k, _), v in zip(self._flags, self._kept):
                        setattr(m, k, v)


#: TF32 off for cuDNN and cuBLAS inside the block.
fp32_exact = _Scoped(((torch.backends.cudnn, "allow_tf32", False),
                      (torch.backends.cuda.matmul, "allow_tf32", False)))

#: cuDNN's deterministic algorithms inside the block.
cudnn_deterministic = _Scoped(((torch.backends.cudnn, "deterministic",
                                True),))


def exact_for(dtype: torch.dtype):
    """`fp32_exact()` for a model that computes in fp32, else a block that
    leaves the settings alone."""
    return fp32_exact() if dtype == torch.float32 \
        else contextlib.nullcontext()
