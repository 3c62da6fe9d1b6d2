"""The prediction heads and same-step InfoNCE of the reference
(loss.negatives same_step): parameter `prediction_heads.weight` (K * D,
A)."""

from __future__ import annotations

from typing import Dict

import torch


def specs(model: dict):
    K, d_enc = model["loss"]["prediction_steps"], model["encoder"]["d_enc"]
    d_ar = model["ar"]["d_ar"]
    return [("prediction_heads.weight", (K * d_enc, d_ar),
             ("normal", d_ar ** -0.5))]


def forward(w: Dict[str, torch.Tensor], c: torch.Tensor, z: torch.Tensor,
            model: dict, rnd):
    """(loss, acc_mean): prediction k of c_t is heads_k c_t; it scores
    against every pool row's z at t + k + 1, for t < T - K; the positive is
    the row's own. Mean negative log-softmax of the positive over (t, k, b),
    and the share of (t, k, b) whose positive scores highest (ties to the
    first)."""
    heads = w["prediction_heads.weight"]
    K = model["loss"]["prediction_steps"]
    B, T, _ = c.shape
    Tp = T - K
    D = z.shape[-1]
    preds = (rnd(c[:, :Tp]) @ rnd(heads).t()).view(B, Tp, K, D)
    labels = torch.arange(B, device=c.device)
    nll, hits = [], []
    for k in range(K):
        s = torch.einsum("btd,ctd->tbc", rnd(preds[:, :, k]),
                         rnd(z[:, k + 1:k + 1 + Tp]))
        logp = torch.log_softmax(s, dim=-1)
        nll.append(-logp[:, labels, labels])
        top = s == s.max(dim=-1, keepdim=True).values
        first = torch.where(top, torch.arange(B, device=c.device), B)
        hits.append((first.min(dim=-1).values == labels).float())
    return torch.stack(nll).mean(), torch.stack(hits).mean()


