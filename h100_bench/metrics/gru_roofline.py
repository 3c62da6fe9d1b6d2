"""The GRU kernels (ops/gru_cuda.py -> csrc/gru_scan.cu): the bound of gru_scan
and its backward (counts/gru.py) over the kernels' device time (stage gru).
In %."""

from h100_bench.metrics._layer import roofline_share


def read(rec):
    return roofline_share(rec, "gru", "gru")
