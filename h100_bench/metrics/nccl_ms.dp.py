"""Device ms a step in NCCL's kernels on rank 0: the pool's gather, its
backward and the gradients' average (parallel/dp.py)."""

from h100_bench.metrics._layer import stage_ms


def read(rec):
    return stage_ms(rec, "nccl")
