"""Host ms a step inside multihost.any_true, the ranks' agreement on the stop
flag over gloo (parallel/multihost.py), on rank 0."""

from h100_bench.metrics._span import per_step_ms


def read(rec):
    return per_step_ms(rec, "agree")
