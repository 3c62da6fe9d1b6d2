"""The GRU gar (models/gru.py): one input projection for all steps on
cuBLAS, then the recurrence kernels (ops/gru_cuda.py -> csrc/gru_scan.cu).
The kernel functions' bytes are those of gru_scan and its backward: xproj
(T, B, 3H), wh (H, 3H), bh and the outputs in the compute dtype, h0 and
dh0 (B, H) in fp32."""


def applies(d):
    return d["model"]["ar"]["kind"] == "gru"


def _per_layer(d):
    T, B, H, it = d["T"], d["B"], d["A"], d["itemsize"]
    xp, hs, w = T * B * 3 * H, T * B * H, H * 3 * H + 3 * H
    return T, B, H, it, xp, hs, w


def forward(d):
    T, B, H, it, xp, hs, w = _per_layer(d)
    nbytes = it * (xp + w + hs) + 4 * B * H
    n = d["model"]["ar"]["num_layers"]
    return n * 2.0 * T * B * H * 3 * H, n * nbytes


def backward(d):
    """The gates again, dh = dhp wh^T and dwh = h^T dhp."""
    T, B, H, it, xp, hs, w = _per_layer(d)
    nbytes = it * (2 * xp + 2 * w + 2 * hs) + 2 * 4 * B * H
    n = d["model"]["ar"]["num_layers"]
    return n * 3 * 2.0 * T * B * H * 3 * H, n * nbytes


def model_flops(d):
    T, B, H = d["T"], d["B"], d["A"]
    total, d_in = 0.0, d["D"]
    for _ in range(d["model"]["ar"]["num_layers"]):
        total += 2.0 * T * B * d_in * 3 * H + 2.0 * T * B * H * 3 * H
        d_in = H
    return total
