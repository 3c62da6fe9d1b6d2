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

`use_pallas` asks for a kernel. The fused heads + InfoNCE kernel takes c
and the heads' weight, not preds, and is `ops.infonce_fused`. The K-tiled
kernel on preds (ROADMAP.md §B4) and the all-steps kernel (§B6) are not
ported yet: their routes raise, on any device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


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
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """InfoNCE loss + per-k accuracy.

    preds (B, T, K, D) predictions W_k c_t; z (B, T, D) encoder latents;
    pool (C, T, D) the candidates, default z; shift the pool row of this
    batch's first positive. Returns (loss, {"loss", "acc" (K,),
    "acc_mean"})."""
    B, T, K, D = preds.shape
    Tp = T - K
    if negatives not in ("same_step", "all_steps"):
        raise ValueError(f"unknown negatives mode {negatives!r}")
    if use_pallas:
        item = "§B4 (the K-tiled same-step kernel, cpc_tpu/ops/infonce_pallas.py)" \
            if negatives == "same_step" else \
            "§B6 (the all-steps kernel, cpc_tpu/ops/infonce_allsteps_pallas.py)"
        raise NotImplementedError(
            f"loss.use_pallas on materialized preds needs the kernel of "
            f"ROADMAP.md {item}, not ported yet; set loss.fuse_heads=True "
            f"(same_step) or loss.use_pallas=False")
    pool = z if pool is None else pool
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
