"""Same-step InfoNCE on materialized predictions: hand-written CUDA kernels
and their plain versions.

Port of `cpc_tpu/ops/infonce_pallas.py`: `fused_infonce`, `validity_mask`
and the custom-VJP `fused_same_step_nll` with `_fwd_rule` / `_bwd_rule`. The
TPU kernels replaced are `_fwd_kernel` and `_bwd_kernel`; the CUDA kernels
are `csrc/infonce_same_step.cu`, whose source note gives their design and
what bounds them on an H100.

    preds_v (B, Tp, K, D), Tp = T - K   wire dtype: float32 or bfloat16
    z_pool (C, T, D)                    the same dtype
    nll, correct, lse (T-1, K*B) fp32   row ti = tau - 1, flat k*B + b

For target step tau = 1..T-1 and head k the rows preds_v[:, tau-1-k, k]
score against the candidates z_pool[:, tau] in fp32, with positives at
column shift + b and argmax ties to the first maximum. Rows outside the
window (t = tau-1-k < 0 or >= Tp) are zero, and `validity_mask` drops them
from the reductions. The backward returns dpreds (B, Tp, K, D) and dz
(C, T, D) in the wire dtype, with dz[:, 0] = 0 (step 0 is never a target);
delta = (softmax - onehot) * g stays fp32 and both products upcast their
other operand, as `_bwd_kernel` does.

Unlike the TPU wrapper, nothing is transposed: the kernels read preds_v and
z_pool through their batch and time strides, so preds_v may be the view
preds[:, :Tp], and they write dpreds in place. The forward also keeps each
row's log-sum-exp, so the backward's softmax is exp(s - lse); the plain
version does the same. There is no K tiling and no row envelope
(`_choose_kt`, `MEASURED_ROWS_ENVELOPE` are facts of the TPU's VMEM): a block
sweeps the candidates in tiles.

Dispatch is by the device of `preds_v`: a CPU tensor goes through
`_SameStepNllPlain` (`same_step_nll_reference`,
`same_step_nll_backward_reference`), a CUDA tensor through
`_SameStepNllCuda`, whose two halves are the kernels, which run or raise.
`same_step_route` names the kernels a CUDA tensor runs:

- "mma" (bf16 with D, the base pointers and the batch, time and candidate
  strides 16-byte aligned: the training path): tensor-core products, the
  fused heads' kernels over a row table of preds_v. The forward is one
  launch; the backward ONE launch with no scratch of delta, and for
  C > 64 an fp32 (C, T, D) scratch of dz that its owner threads sum in a
  fixed order. Its bound on an H100 is the bytes of preds_v; it runs at
  1.4-2x that bound forward and 4-6x backward, where each 64-deep job is a
  few tensor-core products between block barriers (PERF.md §6).
- "simt" (fp32, the parity configuration, and unaligned bf16): SIMT fp32
  products; the forward one launch, the backward three through an fp32
  (T-1, K, B, C) scratch of delta. Bounded by the SIMT pipe's rate.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from cpc_tpu_torch.ops._build import check_launch, load_library
from cpc_tpu_torch.ops.infonce import (WIRE_DTYPES, check_labels,
                                       first_argmax, on_device,
                                       tensor_core_route)


def validity_mask(T: int, K: int, B: int, Tp: int,
                  device=None) -> torch.Tensor:
    """(T-1, K*B) fp32 mask of the kernels' flat output layout."""
    tau = torch.arange(1, T, device=device)[:, None]
    rows = torch.arange(K * B, device=device)[None, :]
    t = tau - 1 - rows // B
    return ((t >= 0) & (t < Tp)).float()


def _scores(preds_v: torch.Tensor, z_pool: torch.Tensor):
    """(blocks (T-1, K, B, D) fp32, scores (T-1, K, B, C) fp32): block
    [ti, k] = preds_v[:, clamp(ti - k), k]."""
    B, Tp, K, D = preds_v.shape
    T = z_pool.shape[1]
    ti = torch.arange(T - 1, device=preds_v.device)
    pk = torch.stack([preds_v[:, (ti - k).clamp(0, Tp - 1), k]
                      for k in range(K)], dim=2)       # (B, T-1, K, D)
    pk = pk.permute(1, 2, 0, 3).float()
    s = torch.einsum("tkbd,ctd->tkbc", pk, z_pool[:, 1:].float())
    return pk, s


def same_step_nll_reference(preds_v: torch.Tensor, z_pool: torch.Tensor,
                            shift: int):
    """Plain version of the forward kernel: (nll, correct, lse), each
    (T-1, K*B) fp32, zero outside the window."""
    B, Tp, K, _ = preds_v.shape
    C, T, _ = z_pool.shape
    dev = preds_v.device
    _, s = _scores(preds_v, z_pool)
    m = s.max(dim=-1, keepdim=True).values
    lse = m[..., 0] + torch.log(torch.exp(s - m).sum(dim=-1))
    labels = shift + torch.arange(B, device=dev)
    hit = torch.arange(C, device=dev) == labels[:, None]   # (B, C)
    s_lab = torch.where(hit, s, torch.zeros((), device=dev)).sum(-1)
    correct = (first_argmax(s) == labels).float()
    mask = validity_mask(T, K, B, Tp, dev)
    flat = (T - 1, K * B)
    return ((lse - s_lab).reshape(flat) * mask, correct.reshape(flat) * mask,
            lse.reshape(flat) * mask)


def same_step_nll_backward_reference(g_nll: torch.Tensor, lse: torch.Tensor,
                                     preds_v: torch.Tensor,
                                     z_pool: torch.Tensor, shift: int):
    """Plain version of the backward kernels: (dpreds (B, Tp, K, D),
    dz (C, T, D)) in the inputs' dtype, from the cotangent g_nll (T-1, K*B)
    and the forward's lse."""
    B, Tp, K, D = preds_v.shape
    C, T, _ = z_pool.shape
    dev = preds_v.device
    pk, s = _scores(preds_v, z_pool)
    labels = shift + torch.arange(B, device=dev)
    onehot = (torch.arange(C, device=dev) == labels[:, None]).float()
    valid = validity_mask(T, K, B, Tp, dev).reshape(T - 1, K, B, 1) > 0
    soft = torch.exp(s - lse.reshape(T - 1, K, B, 1))
    # `where`, not a product: rows outside the window hold any score
    delta = torch.where(valid, (soft - onehot)
                        * g_nll.float().reshape(T - 1, K, B, 1),
                        torch.zeros((), device=dev))
    dz = torch.zeros((C, T, D), dtype=torch.float32, device=dev)
    dz[:, 1:] = torch.einsum("tkbc,tkbd->ctd", delta, pk)
    dp_eff = torch.einsum("tkbc,ctd->tkbd", delta, z_pool[:, 1:].float())
    # dpreds[:, t, k] = dp_eff[t + k, k]
    t = torch.arange(Tp, device=dev)[:, None]
    k = torch.arange(K, device=dev)[None, :]
    dpreds = dp_eff[t + k, k].permute(2, 0, 1, 3)
    return dpreds.to(preds_v.dtype).contiguous(), dz.to(z_pool.dtype)


def check_inputs(preds_v: torch.Tensor, z_pool: torch.Tensor,
                 shift: int) -> None:
    """Raises on anything the same-step and all-steps kernels do not take."""
    if preds_v.dim() != 4 or z_pool.dim() != 3:
        raise ValueError(f"preds_v must be (B, Tp, K, D) and z_pool "
                         f"(C, T, D), got {tuple(preds_v.shape)} and "
                         f"{tuple(z_pool.shape)}")
    B, Tp, K, D = preds_v.shape
    C, T, Dz = z_pool.shape
    if min(B, Tp, K, D, C) < 1:
        raise ValueError(f"empty input {tuple(preds_v.shape)} "
                         f"{tuple(z_pool.shape)}")
    if Dz != D or Tp != T - K:
        raise ValueError(f"preds_v {tuple(preds_v.shape)} does not fit "
                         f"z_pool {tuple(z_pool.shape)}: need Tp = T - K and "
                         f"one D")
    check_labels(B, C, shift)
    if preds_v.dtype not in WIRE_DTYPES or z_pool.dtype != preds_v.dtype:
        raise TypeError(f"preds_v and z_pool must share a dtype in "
                        f"{WIRE_DTYPES}, got {preds_v.dtype} and "
                        f"{z_pool.dtype}")
    if z_pool.device != preds_v.device:
        raise ValueError(f"z_pool on {z_pool.device}, preds_v on "
                         f"{preds_v.device}")
    if preds_v.stride(3) != 1 or (K > 1 and preds_v.stride(2) != D):
        raise ValueError("preds_v must be contiguous in its last two axes "
                         f"(K, D), got strides {preds_v.stride()}")
    if z_pool.stride(2) != 1:
        raise ValueError("z_pool must be contiguous in its last axis, got "
                         f"strides {z_pool.stride()}")


def check_rows(preds_v: torch.Tensor, shape, **rows: torch.Tensor) -> None:
    """g_nll and lse of the backward: contiguous fp32 of `shape`, beside
    preds_v."""
    for name, t in rows.items():
        if (t.dtype != torch.float32 or tuple(t.shape) != tuple(shape)
                or t.device != preds_v.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous fp32 {tuple(shape)} "
                             f"on {preds_v.device}")


# the wire dtypes the tensor-core kernels take
_MMA_DTYPES = (torch.bfloat16,)
_ROUTE_CODES = {"simt": 0, "mma": 1}
# the mma backward's column tile: beyond it dz is summed in an fp32 scratch
_MMA_COLS = 64


def same_step_route(T: int, B: int, C: int, K: int, D: int,
                    dtype: torch.dtype, aligned: bool = True) -> str:
    """Names the kernels `same_step_nll_forward` and `same_step_nll_backward`
    launch on the card for preds_v (B, T-K, K, D) and z_pool (C, T, D) of
    `dtype`. Pure Python.

    "mma": bf16 with D a multiple of 8 and every row 16-byte aligned
    (`aligned`: both base pointers and preds_v's batch and time strides and
    z_pool's candidate and time strides multiples of 8 elements), the
    training path: tensor-core products, the backward one launch with no
    scratch of delta. "simt": everything else, the fp32 wire (the parity
    configuration) and unaligned bf16: SIMT fp32 products, the backward
    three launches. Raises on inputs that no kernel takes."""
    return tensor_core_route((T, B, C, K, D), dtype, aligned, _MMA_DTYPES)


def _route(preds_v: torch.Tensor, z_pool: torch.Tensor) -> str:
    B, Tp, K, D = preds_v.shape
    C, T, _ = z_pool.shape
    strides = (preds_v.stride(0), preds_v.stride(1), z_pool.stride(0),
               z_pool.stride(1))
    aligned = (preds_v.data_ptr() % 16 == 0 and z_pool.data_ptr() % 16 == 0
               and all(s % 8 == 0 for s in strides))
    return same_step_route(T, B, C, K, D, preds_v.dtype, aligned)


def _geometry(preds_v, z_pool, shift, route):
    B, Tp, K, D = preds_v.shape
    C, T, _ = z_pool.shape
    return (T, B, C, K, D, shift, preds_v.stride(0), preds_v.stride(1),
            z_pool.stride(0), z_pool.stride(1),
            int(preds_v.dtype == torch.bfloat16), _ROUTE_CODES[route],
            preds_v.device.index,
            torch.cuda.current_stream(preds_v.device).cuda_stream)


def _launch_fwd(preds_v, z_pool, shift):
    check_inputs(preds_v, z_pool, shift)
    lib = load_library()
    B, _, K, _ = preds_v.shape
    T = z_pool.shape[1]
    outs = [torch.empty((T - 1, K * B), dtype=torch.float32,
                        device=preds_v.device) for _ in range(3)]
    err = lib.same_step_nll_fwd(
        preds_v.data_ptr(), z_pool.data_ptr(), *(o.data_ptr() for o in outs),
        *_geometry(preds_v, z_pool, shift, _route(preds_v, z_pool)))
    check_launch(lib, err, "same_step_nll_forward")
    same_step_nll_forward.launches += 1
    return tuple(outs)


def _launch_bwd(g_nll, lse, preds_v, z_pool, shift):
    check_inputs(preds_v, z_pool, shift)
    B, Tp, K, D = preds_v.shape
    C, T, _ = z_pool.shape
    check_rows(preds_v, (T - 1, K * B), g_nll=g_nll, lse=lse)
    lib = load_library()
    dev = preds_v.device
    route = _route(preds_v, z_pool)
    # a scratch is freed after the launch, which is safe: the caching
    # allocator reuses it only for work queued later on the same stream
    delta = (torch.empty((T - 1, K, B, C), dtype=torch.float32, device=dev)
             if route == "simt" else None)
    dz32 = (torch.empty((C, T, D), dtype=torch.float32, device=dev)
            if route == "mma" and C > _MMA_COLS else None)
    dz = torch.empty((C, T, D), dtype=z_pool.dtype, device=dev)
    dpreds = torch.empty((B, Tp, K, D), dtype=preds_v.dtype, device=dev)
    err = lib.same_step_nll_bwd(
        g_nll.data_ptr(), lse.data_ptr(), preds_v.data_ptr(),
        z_pool.data_ptr(), None if delta is None else delta.data_ptr(),
        None if dz32 is None else dz32.data_ptr(), dz.data_ptr(),
        dpreds.data_ptr(), *_geometry(preds_v, z_pool, shift, route))
    check_launch(lib, err, "same_step_nll_backward")
    same_step_nll_backward.launches += 1
    return dpreds, dz


def same_step_nll_forward(preds_v: torch.Tensor, z_pool: torch.Tensor,
                          shift: int):
    """(nll, correct, lse). CPU tensors run `same_step_nll_reference`; CUDA
    tensors run the kernel of `same_step_route`, and
    `same_step_nll_forward.launches` counts its launches."""
    return on_device(preds_v, same_step_nll_reference, _launch_fwd, preds_v,
                     z_pool, shift)


def same_step_nll_backward(g_nll: torch.Tensor, lse: torch.Tensor,
                           preds_v: torch.Tensor, z_pool: torch.Tensor,
                           shift: int):
    """(dpreds, dz). CPU tensors run `same_step_nll_backward_reference`;
    CUDA tensors run the kernels of `same_step_route` (one launch on "mma",
    three on "simt"), and `same_step_nll_backward.launches` counts the calls
    that launched them."""
    return on_device(preds_v, same_step_nll_backward_reference, _launch_bwd,
                     g_nll, lse, preds_v, z_pool, shift)


same_step_nll_forward.launches = 0
same_step_nll_backward.launches = 0


def nll_function(name: str, forward_fn, backward_fn):
    """The autograd Function (preds_v, z_pool, shift) -> (nll, correct) over
    one pair of halves: forward_fn gives (nll, correct, lse), backward_fn
    takes (g_nll, lse, preds_v, z_pool, shift) and gives (dpreds, dz)."""

    def forward(ctx, preds_v, z_pool, shift):
        nll, correct, lse = forward_fn(preds_v, z_pool, shift)
        ctx.save_for_backward(preds_v, z_pool, lse)
        ctx.shift = shift
        ctx.mark_non_differentiable(correct)  # argmax
        return nll, correct

    def backward(ctx, g_nll, _g_correct):
        preds_v, z_pool, lse = ctx.saved_tensors
        dpreds, dz = backward_fn(g_nll.float().contiguous(), lse, preds_v,
                                 z_pool, ctx.shift)
        return dpreds, dz, None

    return type(name, (torch.autograd.Function,), {
        "forward": staticmethod(forward), "backward": staticmethod(backward)})


# the plain halves on any device: the CPU path, and the reference the
# kernels are held against on the card
_SameStepNllPlain = nll_function("_SameStepNllPlain", same_step_nll_reference,
                                 same_step_nll_backward_reference)
_SameStepNllCuda = nll_function("_SameStepNllCuda", same_step_nll_forward,
                                same_step_nll_backward)


def fused_same_step_nll(preds_v: torch.Tensor, z_pool: torch.Tensor,
                        shift: int = 0):
    """preds_v (B, Tp, K, D), z_pool (C, T, D) -> (nll, correct), each
    (T-1, K*B) fp32, differentiable in preds_v and z_pool; mask with
    `validity_mask` before reducing."""
    fn = _SameStepNllPlain if preds_v.device.type == "cpu" \
        else _SameStepNllCuda
    if z_pool.stride(2) != 1:  # e.g. the encoder's (B, D, T) output, viewed
        z_pool = z_pool.contiguous()
    return fn.apply(preds_v, z_pool, int(shift))


def reduce_same_step_nll(nll: torch.Tensor, correct: torch.Tensor, K: int,
                         B: int
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {"loss", "acc" (K,), "acc_mean"}) from the (T-1, K*B) rows:
    mean NLL over the valid (t, k, b) and per-k accuracy."""
    T = nll.shape[0] + 1
    Tp = T - K
    mask = validity_mask(T, K, B, Tp, nll.device)
    denom = Tp * B  # valid rows per k
    loss = torch.sum(nll * mask) / (denom * K)
    acc = torch.sum((correct * mask).reshape(T - 1, K, B), dim=(0, 2)) / denom
    return loss, {"loss": loss, "acc": acc, "acc_mean": acc.mean()}


def fused_infonce(
    preds_v: torch.Tensor,
    z_pool: torch.Tensor,
    *,
    negatives: str = "same_step",
    shift: int = 0,
    compute_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss and per-k accuracy through the kernels: the scoring, softmax and
    argmax block of `ops.infonce.infonce_loss_and_metrics`.

    preds_v (B, Tp, K, D) predictions over the valid window; z_pool
    (C, T, D) the candidates, whose rows shift..shift+B-1 are this batch's
    positives. compute_dtype is the wire dtype of the products (sums are
    fp32); None keeps the inputs' dtype."""
    if negatives not in ("same_step", "all_steps"):
        raise ValueError(f"unknown negatives mode {negatives!r}")
    B, Tp, K, _ = preds_v.shape
    C, T, _ = z_pool.shape
    if Tp <= 0 or Tp != T - K:
        raise ValueError(f"preds_v covers {Tp} steps, z_pool {T}: need "
                         f"Tp = T - K > 0 for K={K} offsets")
    check_labels(B, C, int(shift))
    if compute_dtype is not None:
        preds_v, z_pool = preds_v.to(compute_dtype), z_pool.to(compute_dtype)
    if negatives == "all_steps":
        from cpc_tpu_torch.ops.infonce_allsteps_cuda import \
            fused_infonce_allsteps
        return fused_infonce_allsteps(preds_v, z_pool, shift=shift)
    nll, correct = fused_same_step_nll(preds_v, z_pool, shift)
    return reduce_same_step_nll(nll, correct, K, B)
