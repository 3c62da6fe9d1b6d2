"""The causal transformer gar of the reference (ar.kind transformer):
input projection plus a learned position table, pre-LayerNorm blocks of
causal multi-head attention and a tanh-gelu MLP, a final LayerNorm;
parameters named as flax's Dense and LayerNorm under `gar.`."""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

LN_EPS = 1e-6


def specs(model: dict):
    ar = model["ar"]
    if ar.get("dropout", 0.0) > 0:
        raise ValueError("the reference's transformer has no dropout")
    d, hidden = ar["d_ar"], ar["d_ar"] * ar["mlp_ratio"]
    out = _dense("gar.in_proj", model["encoder"]["d_enc"], d)
    out.append(("gar.pos_embed", (ar["max_len"], d), ("normal", 0.02)))
    for i in range(ar["num_layers"]):
        b = f"gar.block{i}"
        out += _norm(f"{b}.ln_attn", d)
        for proj in ("query", "key", "value", "out"):
            out += _dense(f"{b}.attn.{proj}", d, d)
        out += _norm(f"{b}.ln_mlp", d)
        out += _dense(f"{b}.fc1", d, hidden)
        out += _dense(f"{b}.fc2", hidden, d)
    return out + _norm("gar.final_norm", d)


def _dense(name, d_in, d_out):
    return [(f"{name}.weight", (d_out, d_in), ("normal", d_in ** -0.5)),
            (f"{name}.bias", (d_out,), ("zeros",))]


def _norm(name, d):
    return [(f"{name}.weight", (d,), ("ones",)),
            (f"{name}.bias", (d,), ("zeros",))]


def _dense_apply(w, name, x, rnd):
    return rnd(x) @ rnd(w[f"{name}.weight"]).t() + w[f"{name}.bias"]


def _ln(w, name, x):
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"],
                        w[f"{name}.bias"], LN_EPS)


def forward(w: Dict[str, torch.Tensor], z: torch.Tensor, model: dict,
            rnd) -> torch.Tensor:
    """(B, T, D) -> (B, T, d_ar): input projection plus a learned position
    table, pre-LayerNorm blocks of causal multi-head attention (scores
    q k / sqrt(Dh)) and a tanh-gelu MLP, each added to the residual, then a
    final LayerNorm."""
    ar = model["ar"]
    B, T, _ = z.shape
    H = ar["num_heads"]
    x = _dense_apply(w, "gar.in_proj", z, rnd) + w["gar.pos_embed"][:T]
    causal = torch.ones((T, T), dtype=torch.bool, device=z.device).tril()
    for i in range(ar["num_layers"]):
        b = f"gar.block{i}"
        h = _ln(w, f"{b}.ln_attn", x)
        q, k, v = (_dense_apply(w, f"{b}.attn.{p}", h, rnd).view(B, T, H, -1)
                   for p in ("query", "key", "value"))
        dh = q.shape[-1]
        s = torch.einsum("bqhd,bkhd->bhqk", rnd(q), rnd(k)) / math.sqrt(dh)
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", rnd(p), rnd(v))
        x = x + _dense_apply(w, f"{b}.attn.out", o.reshape(B, T, -1), rnd)
        h = _ln(w, f"{b}.ln_mlp", x)
        h = F.gelu(_dense_apply(w, f"{b}.fc1", h, rnd), approximate="tanh")
        x = x + _dense_apply(w, f"{b}.fc2", h, rnd)
    return _ln(w, "gar.final_norm", x)


