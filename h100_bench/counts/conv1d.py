"""The strided Conv1d encoder (models/encoder.py, convolutions on cuDNN):
its stack as one function from the waveform (B, S) to z (B, T, C), each
input and output byte counted once, in the compute dtype."""


def applies(d):
    return d["model"]["encoder"]["kind"] == "conv1d"


def latents(model, samples):
    """Output steps of the stack: SAME padding gives ceil(t / s) a layer."""
    if model["encoder"]["kind"] != "conv1d":
        return None
    t = samples
    for s in model["encoder"]["strides"]:
        t = -(-t // s)
    return t


def _layers(d):
    """(t_out, k, c_in, c_out) of each layer."""
    enc = d["model"]["encoder"]
    out, t, c_in = [], d["S"], 1
    for ch, k, s in zip(enc["channels"], enc["kernels"], enc["strides"]):
        t = -(-t // s)
        out.append((t, k, c_in, ch))
        c_in = ch
    return out


def _weights_bytes(d):
    return d["itemsize"] * sum(k * ci * co + co for _, k, ci, co in _layers(d))


def _products(d):
    return [2.0 * d["B"] * t * k * ci * co for t, k, ci, co in _layers(d)]


def forward(d):
    z = d["B"] * d["T"] * d["model"]["encoder"]["channels"][-1]
    nbytes = d["itemsize"] * (d["B"] * d["S"] + z) + _weights_bytes(d)
    return sum(_products(d)), nbytes


def backward(d):
    """The weight gradient of every layer and the input gradient of every
    layer but the first (the waveform needs none)."""
    p = _products(d)
    z = d["B"] * d["T"] * d["model"]["encoder"]["channels"][-1]
    nbytes = d["itemsize"] * (d["B"] * d["S"] + z) + 2 * _weights_bytes(d)
    return sum(p) + sum(p[1:]), nbytes


def model_flops(d):
    return sum(_products(d))
