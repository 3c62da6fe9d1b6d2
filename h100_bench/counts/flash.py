"""Causal flash attention (ops/attention_cuda.py ->
csrc/flash_attention.cu), once a transformer layer: q, k, v, o (B, T, H,
Dh) in the compute dtype and lse (B, H, T) fp32; the one-pass backward
takes do, lse and dres (B, H, T) fp32 and writes dq, dk, dv. Operations
over the causal half of the scores, T (T + 1) / 2 positions a head. The
model's required operations are counted with the transformer."""


def applies(d):
    ar = d["model"]["ar"]
    return ar["kind"] == "transformer" and ar["attn_impl"] in ("flash",
                                                                "flash16")


def _qkv(d):
    return d["B"] * d["T"] * d["A"]


def _work(d, products):
    dh = d["A"] // d["model"]["ar"]["num_heads"]
    causal = d["T"] * (d["T"] + 1) // 2
    return (products * 2.0 * dh * causal * d["B"]
            * d["model"]["ar"]["num_heads"])


def _stats(d):
    return 4 * d["B"] * d["model"]["ar"]["num_heads"] * d["T"]


def forward(d):
    nbytes = d["itemsize"] * 4 * _qkv(d) + _stats(d)
    n = d["model"]["ar"]["num_layers"]
    return n * _work(d, 2), n * nbytes


def backward(d):
    nbytes = d["itemsize"] * 7 * _qkv(d) + 2 * _stats(d)
    n = d["model"]["ar"]["num_layers"]
    return n * _work(d, 5), n * nbytes


def model_flops(d):
    return 0.0
