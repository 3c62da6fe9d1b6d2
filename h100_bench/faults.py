"""Faults planted under the trainer's step, for the tests and calibration
runs that show the comparison fails them. Each patches one function of
the program for the time of a `with` block:

- frozen: the optimizer's update does nothing (the step returns its state
  unchanged);
- half_batch: the step's prepared waveform keeps the first half of its
  rows, so the loss is the mean over the rest;
- no_exchange: the data-parallel all_reduce does nothing, so no rank sees
  another's latents or gradients.
"""

from __future__ import annotations

import contextlib

FAULTS = ("frozen", "half_batch", "no_exchange")


@contextlib.contextmanager
def planted(name: str):
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    from cpc_tpu_torch.parallel import dp
    from cpc_tpu_torch.train import train_step as ts

    if name == "frozen":
        where, attr = ts.Optimizer, "step"
        new = lambda self, grads, scalars=None: None  # noqa: E731
    elif name == "half_batch":
        where, attr = ts, "device_prepare"
        kept = ts.device_prepare

        def new(batch, normalize=True):
            return kept(batch[:batch.shape[0] // 2], normalize)
    else:
        where, attr = dp, "all_reduce"
        new = lambda t, group, index=None: None  # noqa: E731
    old = getattr(where, attr)
    setattr(where, attr, new)
    try:
        yield
    finally:
        setattr(where, attr, old)
