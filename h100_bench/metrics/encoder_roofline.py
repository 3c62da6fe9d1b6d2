"""The conv encoder (models/encoder.py on cuDNN through ops/conv_cuda.py): the
bound of its stack's forward and backward (counts/conv1d.py) over its
kernels' device time (stage conv_encoder). In %."""

from h100_bench.metrics._layer import roofline_share


def read(rec):
    return roofline_share(rec, "conv_encoder", "conv1d")
