"""Host ms a step inside the train_step call (train/train_step.py): the step's
enqueue, over the traced steps."""

from h100_bench.metrics._span import per_step_ms


def read(rec):
    return per_step_ms(rec, "step")
