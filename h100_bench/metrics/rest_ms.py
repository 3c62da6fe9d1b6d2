"""Device ms a step in operations that no stage's patterns claim: the optimizer
(train/train_step.py::Optimizer), elementwise work, casts and reductions."""

from h100_bench.metrics._layer import stage_ms


def read(rec):
    return stage_ms(rec, "rest")
