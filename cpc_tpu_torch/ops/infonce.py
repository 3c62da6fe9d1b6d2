"""InfoNCE loss and k-step accuracies: the plain PyTorch reference.

Port of `cpc_tpu/ops/infonce.py::infonce_loss_and_metrics` and
`stacked_targets`, with the same conventions:

  * preds[:, t, k] predicts z[:, t + k + 1] (offsets 1..K), from the window
    t in [0, Tp), Tp = T - K;
  * 'same_step' negatives: the candidates of a (t, k) prediction are the
    pool's latents at step t+k+1 (a C-way softmax);
  * 'all_steps' negatives: every latent of every pool row (C*T-way), the
    positive of batch row i at index (shift + i) * T + (t + k + 1);
  * scores, log-softmax and argmax in fp32; argmax ties go to the first
    maximum, as jnp.argmax (torch.argmax documents no tie rule).

In place of the JAX package's `axis_name`, the candidate pool is an
argument: `pool` (C, T, D), default z, and `shift`, the row of the pool
where this batch's positives start. A cross-replica pool is then z
all-gathered over the replicas and shift = rank * B.

`use_pallas` asks for a kernel on materialized preds, as in the JAX
package: preds[:, :Tp] and the pool are cast to the wire dtype (bf16 with
`pallas_bf16`, else fp32) and go to `ops.infonce_cuda.fused_infonce`, which
runs the same-step kernels or hands over to the all-steps kernels of
`ops.infonce_allsteps_cuda`. A CPU tensor runs their plain versions, a CUDA
tensor the kernels, which run or raise. The fused heads + InfoNCE kernel
takes c and the heads' weight, not preds, and is `ops.infonce_fused`. The
JAX package's `ring=True` is not ported (ROADMAP.md §A13).

`WIRE_DTYPES`, `check_labels`, `on_device` and `tensor_core_route` are
shared by the three kernel modules.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

WIRE_DTYPES = (torch.float32, torch.bfloat16)  # what the kernels take


def check_labels(B: int, C: int, shift: int) -> None:
    """The positives shift..shift+B-1 must be rows of the pool: a label
    outside it would score 0 in a kernel and in its plain version alike."""
    if shift < 0 or shift + B > C:
        raise ValueError(f"positives {shift}..{shift + B - 1} lie outside "
                         f"the pool of {C} candidates")


def on_device(t: torch.Tensor, cpu_fn, cuda_fn, *args):
    """cpu_fn(*args) for a CPU tensor t, cuda_fn(*args) for a CUDA one."""
    if t.device.type == "cpu":
        return cpu_fn(*args)
    if t.device.type != "cuda":
        raise ValueError(f"the InfoNCE kernels run on cpu or cuda, not "
                         f"{t.device}")
    return cuda_fn(*args)


def tensor_core_route(shape, dtype: torch.dtype, aligned: bool,
                      mma_dtypes) -> str:
    """The route rule of the fused heads and the same-step kernels, for
    shape (T, B, C, K, D): "mma" for a wire dtype in `mma_dtypes` with D a
    multiple of 8 and `aligned` rows, else "simt". Raises on a dtype or an
    empty shape that no kernel takes."""
    if dtype not in WIRE_DTYPES:
        raise TypeError(f"the operands must be one of {WIRE_DTYPES}, got "
                        f"{dtype}")
    if min(shape) < 1:
        raise ValueError(f"empty shape (T, B, C, K, D) = {tuple(shape)}")
    mma = dtype in mma_dtypes and shape[4] % 8 == 0 and aligned
    return "mma" if mma else "simt"


def stacked_targets(z: torch.Tensor, num_steps: int) -> torch.Tensor:
    """z (B, T, D) -> targets (B, Tp, K, D), targets[:, t, k] = z[:, t+k+1]."""
    T = z.shape[1]
    Tp = T - num_steps
    if Tp <= 0:
        raise ValueError(
            f"sequence of {T} latents is too short for K={num_steps} offsets")
    return torch.stack([z[:, k + 1:k + 1 + Tp] for k in range(num_steps)],
                       dim=2)


def first_argmax(scores: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis, ties to the first maximum."""
    n = scores.shape[-1]
    cols = torch.arange(n, device=scores.device)
    top = scores == scores.max(dim=-1, keepdim=True).values
    return torch.where(top, cols, n).min(dim=-1).values


def _ce_and_acc(scores: torch.Tensor, labels: torch.Tensor):
    """scores (Tp, K, B, N) fp32, labels (Tp, K, B) -> (loss, acc (K,))."""
    logp = torch.log_softmax(scores, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    correct = (first_argmax(scores) == labels).float()
    return nll.mean(), correct.mean(dim=(0, 2))


def infonce_loss_and_metrics(
    preds: torch.Tensor,
    z: torch.Tensor,
    *,
    negatives: str = "same_step",
    pool: Optional[torch.Tensor] = None,
    shift: int = 0,
    use_pallas: bool = False,
    pallas_bf16: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """InfoNCE loss + per-k accuracy.

    preds (B, T, K, D) predictions W_k c_t; z (B, T, D) encoder latents;
    pool (C, T, D) the candidates, default z; shift the pool row of this
    batch's first positive; use_pallas routes scoring, softmax and argmax
    through the kernels, on a bf16 wire with pallas_bf16. Returns
    (loss, {"loss", "acc" (K,), "acc_mean"})."""
    B, T, K, D = preds.shape
    Tp = T - K
    if negatives not in ("same_step", "all_steps"):
        raise ValueError(f"unknown negatives mode {negatives!r}")
    pool = z if pool is None else pool
    if use_pallas:
        from cpc_tpu_torch.ops.infonce_cuda import fused_infonce
        kdtype = torch.bfloat16 if pallas_bf16 else torch.float32
        return fused_infonce(preds[:, :Tp].to(kdtype), pool.to(kdtype),
                             negatives=negatives, shift=shift)
    preds_v = preds[:, :Tp].float()
    pool = pool.float()
    dev = preds.device
    if negatives == "same_step":
        tgt = stacked_targets(pool, K)  # (C, Tp, K, D)
        scores = torch.einsum("itkd,jtkd->tkij", preds_v, tgt)
        labels = (shift + torch.arange(B, device=dev)).expand(Tp, K, B)
    else:
        flat = pool.reshape(-1, D)
        scores = torch.einsum("itkd,nd->tkin", preds_v, flat)
        t = torch.arange(Tp, device=dev)[:, None, None]
        k = torch.arange(K, device=dev)[None, :, None]
        i = torch.arange(B, device=dev)[None, None, :]
        labels = ((shift + i) * T + (t + k + 1)).expand(Tp, K, B)
    loss, acc = _ce_and_acc(scores, labels)
    return loss, {"loss": loss, "acc": acc, "acc_mean": acc.mean()}
