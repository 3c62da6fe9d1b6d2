"""Host ms a step waiting on the trainer's Batcher (data/loader.py) for the
next batch: the span around its iterator's next, over the traced steps."""

from h100_bench.metrics._span import per_step_ms


def read(rec):
    return per_step_ms(rec, "feed")
