"""The comparison that decides `correct`: the trainer's first steps against
the float32 reference's on the same weights and rows.

Numbers, each a gap between the program's reading and the reference's:

- loss_gap: the largest over the checked steps of |loss - loss_ref| /
  |loss_ref|;
- grad_gap: the first gradient as the optimizer takes it (the program's
  from its Adam state after one step, mu / (1 - beta1)); for each leaf the
  gap between the two norms, over the larger of the reference's norm of
  that leaf and of the median leaf; the worst leaf;
- change_gap: the same of each leaf's change after the checked steps,
  over the leaves that the reference's first gradient moves: a leaf whose
  reference gradient norm is under a thousandth of the median leaf's (a
  key's bias under softmax) moves by rounding alone and is left out;
- acc_gap: the largest over the steps of the per-k accuracy's mean,
  absolute.

`limits/<cell>.json` names the numbers compared and their limits; the
rest are printed beside them.
"""

from __future__ import annotations

import math
import statistics
import sys
from typing import Dict

MOVED = 1e-3  # a leaf moves when its reference gradient is this share of
              # the median leaf's


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys
              ) -> Dict[str, float]:
    """Each leaf's gap between the two norms, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    keys = list(keys)
    median = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
            for k in keys}


def moved(ref: dict):
    """The leaves whose reference first gradient is at least MOVED of the
    median leaf's."""
    g = ref["grad_norm"]
    median = statistics.median(g.values())
    return [k for k in g if g[k] >= MOVED * median]


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The gaps between the program's readings and the reference's (each
    a dict: loss, acc (lists), grad_norm, change_norm (name -> norm))."""
    loss = max(abs(a - b) / abs(b) if math.isfinite(a) else math.inf
               for a, b in zip(prog["loss"], ref["loss"]))
    acc = max(abs(a - b) if math.isfinite(a) else math.inf
              for a, b in zip(prog["acc"], ref["acc"]))
    g = ref["grad_norm"]
    return {"loss_gap": loss,
            "grad_gap": max(leaf_gaps(prog["grad_norm"], g, g).values()),
            "change_gap": max(leaf_gaps(prog["change_norm"],
                                        ref["change_norm"],
                                        moved(ref)).values()),
            "acc_gap": acc}


def verdict(nums: Dict[str, float], limits: Dict[str, float]):
    """(correct, checks): correct when every limited number is finite and
    at or under its limit; checks maps each to {value, limit}."""
    checks = {k: {"value": nums[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def report(nums: Dict[str, float], checks: dict) -> None:
    """Each number on standard error, the compared ones with their limits
    last."""
    for k, v in nums.items():
        if k not in checks:
            print(f"reading {k} {v!r} (not compared)", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
