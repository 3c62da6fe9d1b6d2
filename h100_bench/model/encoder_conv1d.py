"""The strided Conv1d encoder of the reference (encoder.kind conv1d):
SAME padding, ReLU, no norm; parameters `encoder.conv{i}.weight` (out, in,
k) and `.bias`."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def specs(model: dict):
    enc = model["encoder"]
    if enc["norm"] != "none" or enc["activation"] != "relu" \
            or enc["padding"] != "SAME":
        raise ValueError("the reference's conv1d encoder is SAME, relu, "
                         "no norm")
    out, c_in = [], 1
    for i, (ch, k) in enumerate(zip(enc["channels"], enc["kernels"])):
        out += [(f"encoder.conv{i}.weight", (ch, c_in, k),
                 ("normal", (c_in * k) ** -0.5)),
                (f"encoder.conv{i}.bias", (ch,), ("zeros",))]
        c_in = ch
    return out


def forward(w: Dict[str, torch.Tensor], x: torch.Tensor, model: dict,
            rnd) -> torch.Tensor:
    """(B, S) -> z (B, T, C): strided convolutions, each input padded
    SAME (ceil(t / s) outputs; the zeros split floor / ceil), then ReLU."""
    enc = model["encoder"]
    h = x[:, None, :]
    for i, (k, s) in enumerate(zip(enc["kernels"], enc["strides"])):
        t_in = h.shape[-1]
        t_out = -(-t_in // s)
        pad = max((t_out - 1) * s + k - t_in, 0)
        h = F.pad(h, (pad // 2, pad - pad // 2))
        h = F.conv1d(rnd(h), rnd(w[f"encoder.conv{i}.weight"]),
                     w[f"encoder.conv{i}.bias"], stride=s)
        h = torch.relu(h)
    return h.transpose(1, 2)
