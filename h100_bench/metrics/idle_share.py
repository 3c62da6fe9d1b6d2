"""% of the traced window in which no operation ran on the card: 1 - the union
of every kernel, copy and fill interval over the window."""

from h100_bench.metrics._layer import idle_share


def read(rec):
    return idle_share(rec)
