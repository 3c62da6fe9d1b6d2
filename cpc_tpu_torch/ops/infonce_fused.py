"""Fused prediction heads + same-step InfoNCE: hand-written CUDA kernels and
their plain versions.

Port of `cpc_tpu/ops/infonce_fused.py`: `fused_heads_infonce`,
`validity_mask_tm` and the custom-VJP pair `_heads_nll` / `_fwd_rule` /
`_bwd_rule`. The TPU kernels replaced are `_fwd_kernel` and `_bwd_kernel`;
the CUDA kernels are `csrc/infonce_fused.cu`, whose source note gives their
design and what bounds them on an H100.

    c_tm (T, B, A), z_tm (T, C, D), W (A, K*D)  in the compute dtype
    p = c_tm @ W  (T, B, K*D), time-major flat: a plain matrix product
    nll, correct, lse (T, K*B) fp32, row tau = target step, flat k*B + b

For target step tau the K prediction blocks are p[tau-1-k, :, kD:(k+1)D]
(clamped to 0..T-1); they score against z_tm[tau] over the C candidates in
fp32, with positives at column shift + b and argmax ties to the first
maximum. Rows outside the window (tau = 0, tau-1-k >= T-K) are garbage that
`reduce_heads_nll` masks. The backward writes dz (T, C, D) fp32, cast to
z's dtype, and dp (K, T, B, D) in p's dtype, tau-indexed with exact zeros
out of window; the folds dc = sum_k dp_k W_k^T and dW_k = c^T dp_k are
plain matrix products in fp32, as `_bwd_rule` leaves them to XLA.

The forward also keeps each row's log-sum-exp, so the backward's softmax is
exp(s - lse), without a second sweep for the max and sum; the plain version
does the same.

Dispatch is by the device of `c`: a CPU tensor goes through
`_HeadsNllPlain` (`heads_nll_reference`, `heads_nll_backward_reference`), a
CUDA tensor through `_HeadsNllCuda`, whose two halves are the kernels, which
run or raise. `heads_route` names the kernels a CUDA tensor runs: "mma"
(bf16, tensor cores; the backward one launch with no scratch) or "simt"
(fp32, and bf16 that 16-byte copies do not fit; the backward three launches
through an fp32 scratch of delta). The kernels have no bound on C (columns
are swept in tiles), so the JAX package's v5e envelope
(`MEASURED_C_ENVELOPE`) has no counterpart here.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from cpc_tpu_torch.ops._build import check_launch, load_library
from cpc_tpu_torch.ops.infonce import (WIRE_DTYPES, check_labels,
                                       first_argmax, on_device,
                                       tensor_core_route)
from cpc_tpu_torch.parallel.dp import gather_pool


def validity_mask_tm(T: int, K: int, B: int, Tp: int,
                     device=None) -> torch.Tensor:
    """(T, K*B) fp32 mask of the tau-indexed flat output."""
    tau = torch.arange(T, device=device)[:, None]
    rows = torch.arange(K * B, device=device)[None, :]
    t = tau - 1 - rows // B
    return ((t >= 0) & (t < Tp)).float()


def _blocks(p: torch.Tensor, K: int) -> torch.Tensor:
    """(T, K, B, D): block [tau, k] = p[clamp(tau-1-k), :, kD:(k+1)D]."""
    T, B, KD = p.shape
    D = KD // K
    tau = torch.arange(T, device=p.device)
    return torch.stack([p[(tau - 1 - k).clamp(0, T - 1), :, k * D:(k + 1) * D]
                        for k in range(K)], dim=1)


def _scores(p: torch.Tensor, z_tm: torch.Tensor, K: int):
    """(blocks (T, K, B, D), scores (T, K, B, C) fp32)."""
    pk = _blocks(p, K)
    s = torch.einsum("tkbd,tcd->tkbc", pk.float(), z_tm.float())
    return pk, s


def heads_nll_reference(p: torch.Tensor, z_tm: torch.Tensor, shift: int,
                        K: int):
    """Plain version of the forward kernel: (nll, correct, lse), each
    (T, K*B) fp32."""
    T, B, _ = p.shape
    C = z_tm.shape[1]
    _, s = _scores(p, z_tm, K)
    m = s.max(dim=-1, keepdim=True).values
    lse = m[..., 0] + torch.log(torch.exp(s - m).sum(dim=-1))
    labels = shift + torch.arange(B, device=p.device)
    hit = torch.arange(C, device=p.device) == labels[:, None]   # (B, C)
    s_lab = torch.where(hit, s, torch.zeros((), device=p.device)).sum(-1)
    correct = (first_argmax(s) == labels).float()
    flat = (T, K * B)
    return (lse - s_lab).reshape(flat), correct.reshape(flat), lse.reshape(flat)


def heads_nll_backward_reference(g_nll: torch.Tensor, lse: torch.Tensor,
                                 p: torch.Tensor, z_tm: torch.Tensor,
                                 shift: int, K: int):
    """Plain version of the backward kernels: (dz (T, C, D) fp32,
    dp (K, T, B, D) in p's dtype) from the cotangent g_nll (T, K*B) and the
    forward's lse."""
    T, B, _ = p.shape
    C = z_tm.shape[1]
    pk, s = _scores(p, z_tm, K)
    labels = shift + torch.arange(B, device=p.device)
    onehot = (torch.arange(C, device=p.device) == labels[:, None]).float()
    valid = validity_mask_tm(T, K, B, T - K, p.device)
    coef = (g_nll.float() * valid).reshape(T, K, B, 1)
    delta = (torch.exp(s - lse.reshape(T, K, B, 1)) - onehot) * coef
    dz = torch.einsum("tkbc,tkbd->tcd", delta, pk.float())
    dp = torch.einsum("tkbc,tcd->ktbd", delta, z_tm.float()).to(p.dtype)
    return dz, dp


def _check(p: torch.Tensor, z_tm: torch.Tensor, K: int, shift: int) -> None:
    """Raises on anything the kernels do not take."""
    if p.dim() != 3 or z_tm.dim() != 3:
        raise ValueError(f"p must be (T, B, K*D) and z_tm (T, C, D), got "
                         f"{tuple(p.shape)} and {tuple(z_tm.shape)}")
    T, B, KD = p.shape
    if K < 1 or KD % K or z_tm.shape[0] != T or z_tm.shape[2] != KD // K:
        raise ValueError(f"p {tuple(p.shape)} and z_tm {tuple(z_tm.shape)} "
                         f"do not fit K={K}")
    if min(T, B, KD, z_tm.shape[1]) < 1:
        raise ValueError(f"empty input {tuple(p.shape)} {tuple(z_tm.shape)}")
    check_labels(B, z_tm.shape[1], shift)
    if p.dtype not in WIRE_DTYPES or z_tm.dtype != p.dtype:
        raise TypeError(f"p and z_tm must share a dtype in {WIRE_DTYPES}, "
                        f"got {p.dtype} and {z_tm.dtype}")
    for name, t in (("p", p), ("z_tm", z_tm)):
        if t.device != p.device:
            raise ValueError(f"{name} on {t.device}, p on {p.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


# the wire dtypes the tensor-core kernels take
_MMA_DTYPES = (torch.bfloat16,)
_ROUTE_CODES = {"simt": 0, "mma": 1}


def heads_route(T: int, B: int, C: int, K: int, D: int, dtype: torch.dtype,
                aligned: bool = True) -> str:
    """Names the kernels `heads_nll_forward` and `heads_nll_backward` launch
    on the card for p (T, B, K*D) and z_tm (T, C, D) of `dtype`. Pure
    Python.

    "mma": bf16 with D a multiple of 8 and both operands 16-byte aligned
    (`aligned`), the training path: tensor-core products, the backward one
    launch with no scratch. "simt": everything else, the fp32 wire (the
    parity configuration) and bf16 shapes that 16-byte copies do not fit:
    SIMT fp32 products, the backward three launches. Raises on inputs that
    no kernel takes."""
    return tensor_core_route((T, B, C, K, D), dtype, aligned, _MMA_DTYPES)


def _route(p: torch.Tensor, z_tm: torch.Tensor, K: int) -> str:
    T, B, KD = p.shape
    aligned = p.data_ptr() % 16 == 0 and z_tm.data_ptr() % 16 == 0
    return heads_route(T, B, z_tm.shape[1], K, KD // K, p.dtype, aligned)


def _launch_fwd(p, z_tm, shift, K):
    _check(p, z_tm, K, shift)
    lib = load_library()
    T, B, KD = p.shape
    C = z_tm.shape[1]
    outs = [torch.empty((T, K * B), dtype=torch.float32, device=p.device)
            for _ in range(3)]
    stream = torch.cuda.current_stream(p.device)
    err = lib.heads_nll_fwd(
        p.data_ptr(), z_tm.data_ptr(), *(o.data_ptr() for o in outs), T, B,
        C, K, KD // K, shift, int(p.dtype == torch.bfloat16),
        _ROUTE_CODES[_route(p, z_tm, K)], p.device.index, stream.cuda_stream)
    check_launch(lib, err, "heads_nll_forward")
    heads_nll_forward.launches += 1
    return tuple(outs)


def _launch_bwd(g_nll, lse, p, z_tm, shift, K):
    _check(p, z_tm, K, shift)
    T, B, KD = p.shape
    C, D = z_tm.shape[1], KD // K
    for name, t in (("g_nll", g_nll), ("lse", lse)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (T, K * B)
                or t.device != p.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous fp32 {(T, K * B)} "
                             f"on {p.device}")
    lib = load_library()
    dev = p.device
    route = _route(p, z_tm, K)
    # the simt route's scratch is freed after the launch, which is safe: the
    # caching allocator reuses it only for work queued later on the same
    # stream
    delta = (torch.empty((T, K, B, C), dtype=torch.float32, device=dev)
             if route == "simt" else None)
    dz = torch.empty((T, C, D), dtype=torch.float32, device=dev)
    dp = torch.empty((K, T, B, D), dtype=p.dtype, device=dev)
    stream = torch.cuda.current_stream(dev)
    err = lib.heads_nll_bwd(
        g_nll.data_ptr(), lse.data_ptr(), p.data_ptr(), z_tm.data_ptr(),
        None if delta is None else delta.data_ptr(), dz.data_ptr(),
        dp.data_ptr(), T, B, C, K, D, shift, T - K,
        int(p.dtype == torch.bfloat16), _ROUTE_CODES[route], dev.index,
        stream.cuda_stream)
    check_launch(lib, err, "heads_nll_backward")
    heads_nll_backward.launches += 1
    return dz, dp


def heads_nll_forward(p: torch.Tensor, z_tm: torch.Tensor, shift: int,
                      K: int):
    """(nll, correct, lse). CPU tensors run `heads_nll_reference`; CUDA
    tensors run the kernel of `heads_route`, and `heads_nll_forward.launches`
    counts its launches."""
    return on_device(p, heads_nll_reference, _launch_fwd, p, z_tm, shift, K)


def heads_nll_backward(g_nll: torch.Tensor, lse: torch.Tensor,
                       p: torch.Tensor, z_tm: torch.Tensor, shift: int,
                       K: int):
    """(dz, dp). CPU tensors run `heads_nll_backward_reference`; CUDA tensors
    run the kernels of `heads_route` (one launch on "mma", three on
    "simt"), and `heads_nll_backward.launches` counts the calls that
    launched them."""
    return on_device(p, heads_nll_backward_reference, _launch_bwd, g_nll,
                     lse, p, z_tm, shift, K)


heads_nll_forward.launches = 0
heads_nll_backward.launches = 0


def _heads_function(name: str, forward_fn, backward_fn):
    """The autograd Function of `_heads_nll` over one pair of halves:
    (c_tm, z_tm, W, shift, K) -> (nll, correct), as `_fwd_rule` and
    `_bwd_rule`."""

    def forward(ctx, c_tm, z_tm, W, shift, K):
        T, B, A = c_tm.shape
        p = (c_tm.reshape(T * B, A) @ W).reshape(T, B, W.shape[-1])
        nll, correct, lse = forward_fn(p.contiguous(), z_tm.contiguous(),
                                       shift, K)
        ctx.save_for_backward(c_tm, z_tm, W, p, lse)
        ctx.shift, ctx.K = shift, K
        ctx.mark_non_differentiable(correct)  # argmax
        return nll, correct

    def backward(ctx, g_nll, _g_correct):
        c_tm, z_tm, W, p, lse = ctx.saved_tensors
        K = ctx.K
        T, B, A = c_tm.shape
        D = z_tm.shape[2]
        Tp = T - K
        dz, dp = backward_fn(g_nll.float().contiguous(), lse,
                             p.contiguous(), z_tm.contiguous(), ctx.shift, K)
        c_v = c_tm[:Tp].reshape(Tp * B, A).float()
        W32 = W.float()
        dc_v = torch.zeros((Tp * B, A), dtype=torch.float32,
                           device=c_tm.device)
        dW_cols = []
        for k in range(K):
            dp_k = dp[k, 1 + k:1 + k + Tp].reshape(Tp * B, D).float()
            dc_v += dp_k @ W32[:, k * D:(k + 1) * D].T
            dW_cols.append(c_v.T @ dp_k)
        dc = torch.zeros_like(c_tm)
        dc[:Tp] = dc_v.reshape(Tp, B, A)
        return (dc, dz.to(z_tm.dtype), torch.cat(dW_cols, 1).to(W.dtype),
                None, None)

    return type(name, (torch.autograd.Function,), {
        "forward": staticmethod(forward), "backward": staticmethod(backward)})


# the plain halves on any device: the CPU path, and the reference the
# kernels are held against on the card
_HeadsNllPlain = _heads_function("_HeadsNllPlain", heads_nll_reference,
                                 heads_nll_backward_reference)
_HeadsNllCuda = _heads_function("_HeadsNllCuda", heads_nll_forward,
                                heads_nll_backward)


def reduce_heads_nll(nll: torch.Tensor, correct: torch.Tensor, K: int,
                     B: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {"loss", "acc" (K,), "acc_mean"}) from the tau-indexed rows:
    mean NLL over the valid (t, k, b) and per-k accuracy."""
    T = nll.shape[0]
    Tp = T - K
    mask = validity_mask_tm(T, K, B, Tp, nll.device)
    denom = Tp * B
    loss = torch.sum(nll * mask) / (denom * K)
    acc = torch.sum((correct * mask).reshape(T, K, B), dim=(0, 2)) / denom
    return loss, {"loss": loss, "acc": acc, "acc_mean": acc.mean()}


def fused_heads_infonce(
    c: torch.Tensor,
    z: torch.Tensor,
    W: torch.Tensor,
    *,
    num_steps: int,
    compute_dtype: Optional[torch.dtype] = None,
    c_time_major: bool = False,
    pool: Optional[torch.Tensor] = None,
    shift: int = 0,
    mesh=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss and per-k accuracy straight from (c, z, W): the same as
    `infonce_loss_and_metrics(heads(c), z, negatives='same_step')`, with
    preds never materialized beyond the heads product.

    c (B, T, A), or (T, B, A) with c_time_major; z (B, T, D); W (A, K*D),
    the JAX package's layout of the heads' weight. pool (C, T, D), default
    z, is the candidate pool, whose rows shift..shift+B-1 are this batch's
    positives. A `mesh` (`parallel.mesh.ProcessMesh`), in place of pool and
    shift, gathers every rank's z into the pool in the compute dtype, as
    the JAX package gathers it: C = size * B, shift = rank * B."""
    K = num_steps
    if c_time_major:
        T, B, _ = c.shape
    else:
        B, T, _ = c.shape
    if T - K <= 0:
        raise ValueError(
            f"sequence of {T} latents is too short for K={K} offsets")
    if mesh is not None and (pool is not None or shift):
        raise ValueError("a mesh gathers the pool: pass pool and shift, "
                         "or a mesh, not both")
    pool = z if pool is None else pool
    if compute_dtype is not None:
        c, pool, W = (t.to(compute_dtype) for t in (c, pool, W))
    if mesh is not None:
        pool, shift = gather_pool(pool, mesh)
    check_labels(B, pool.shape[0], int(shift))
    c_tm = c if c_time_major else c.transpose(0, 1)
    z_tm = pool.transpose(0, 1).contiguous()  # (T, C, D)
    fn = _HeadsNllPlain if c.device.type == "cpu" else _HeadsNllCuda
    nll, correct = fn.apply(c_tm.contiguous(), z_tm, W, int(shift), K)
    return reduce_heads_nll(nll, correct, K, B)
