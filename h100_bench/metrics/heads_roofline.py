"""The fused heads + InfoNCE kernels (ops/infonce_fused.py ->
csrc/infonce_fused.cu): the bound of the scoring forward and backward
(counts/heads.py) over their device time (stage heads). In %."""

from h100_bench.metrics._layer import roofline_share


def read(rec):
    return roofline_share(rec, "heads", "heads")
