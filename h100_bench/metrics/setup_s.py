"""Seconds from the start of the benchmark's process to its first timed step:
library load, corpus, the trainer, weights on the card, its checked first
steps (and, on a checkout's first run, the kernels' build)."""


def read(rec):
    return rec.setup_s
