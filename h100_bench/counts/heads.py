"""The K prediction heads and same-step InfoNCE. The kernel functions are
the fused scoring kernels (ops/infonce_fused.py -> csrc/infonce_fused.cu):
p (T, B, K*D) and z (T, C, D) in the compute dtype in; nll, correct and
lse (T, K*B) fp32 out; the backward takes the cotangent and lse (fp32)
with p and z, and writes dz (T, C, D) fp32 and dp (K, T, B, D). The heads'
product itself is a cuBLAS matmul. Same-step negatives only; the kernel
functions are those of the fused path (`loss.fuse_heads`)."""


def applies(d):
    return d["model"]["loss"]["negatives"] == "same_step"


def _scores(d):
    return 2.0 * d["T"] * d["K"] * d["B"] * d["C"] * d["D"]


def forward(d):
    if not d["model"]["loss"]["fuse_heads"]:
        return None
    T, B, C, K, D, it = d["T"], d["B"], d["C"], d["K"], d["D"], d["itemsize"]
    nbytes = it * (T * B * K * D + T * C * D) + 3 * 4 * T * K * B
    return _scores(d), nbytes


def backward(d):
    """The scores again, dz and dp."""
    if not d["model"]["loss"]["fuse_heads"]:
        return None
    T, B, C, K, D, it = d["T"], d["B"], d["C"], d["K"], d["D"], d["itemsize"]
    nbytes = (2 * 4 * T * K * B + 2 * it * T * B * K * D + it * T * C * D
              + 4 * T * C * D)
    return 3 * _scores(d), nbytes


def model_flops(d):
    """The heads over the T - K steps that predict, and their scores."""
    tp = d["T"] - d["K"]
    heads = 2.0 * tp * d["B"] * d["A"] * d["K"] * d["D"]
    return heads + 2.0 * tp * d["K"] * d["B"] * d["C"] * d["D"]
