"""% of rank 0's traced window in which no kernel but NCCL's ran: NCCL's
kernels wait inside for the other ranks, so they count as idle."""

from h100_bench.metrics._layer import idle_share


def read(rec):
    return idle_share(rec, without="nccl")
