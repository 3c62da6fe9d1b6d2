"""The whole step's share of the card's bf16 peak: the model's required
operations a step (counts/*.py: forward x 3, no recomputation) times the
traced steps, over the traced window. In %. Under a mesh (`mfu.dp`) each
rank does one rank's share, so every rank's operations over every card's
peak is one rank's over one card's, on rank 0's window."""

from h100_bench.metrics._layer import mfu


def read(rec):
    return mfu(rec)
