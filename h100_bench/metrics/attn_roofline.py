"""The flash attention kernels (ops/attention_cuda.py ->
csrc/flash_attention.cu): the bound of the forward and the backward of every
layer (counts/flash.py) over their device time (stage flash). In %."""

from h100_bench.metrics._layer import roofline_share


def read(rec):
    return roofline_share(rec, "flash", "flash")
