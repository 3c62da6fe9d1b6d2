"""Roofline arithmetic: the least time a function could take on a card,
the larger of its operations over the card's peak rate and its bytes over
the memory rate (`peaks.json`)."""

from __future__ import annotations

from typing import Optional, Tuple


def bound_s(work: Optional[Tuple[float, float]], peak: dict) -> float:
    """Seconds for (operations, bytes) at the bf16 peak; 0 for None."""
    if work is None:
        return 0.0
    flops, nbytes = work
    return max(flops / peak["bf16_flops_per_s"],
               nbytes / peak["hbm_bytes_per_s"])


def layer_bound_s(parts, dims: dict, peak: dict) -> float:
    """A step's bound over the kernel functions of `parts` (counting
    modules): the forward's and the backward's, each its own function."""
    return sum(bound_s(p.forward(dims), peak) + bound_s(p.backward(dims), peak)
               for p in parts if p.applies(dims))


def step_model_flops(parts, dims: dict) -> float:
    """The operations one rank's training step requires: three times the
    forward's (the backward's two products per forward product), without
    recomputation."""
    return 3.0 * sum(p.model_flops(dims) for p in parts if p.applies(dims))
