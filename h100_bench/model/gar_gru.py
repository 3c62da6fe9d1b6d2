"""The GRU gar of the reference (ar.kind gru): gates r, u, n as
torch.nn.GRU, zero initial state; parameters `gar.layer{n}.wi` (D, 3H),
`.bi`, `.wh` (H, 3H), `.bh`."""

from __future__ import annotations

from typing import Dict

import torch


def specs(model: dict):
    ar, out = model["ar"], []
    d_in, H = model["encoder"]["d_enc"], ar["d_ar"]
    for n in range(ar["num_layers"]):
        out += [(f"gar.layer{n}.wi", (d_in, 3 * H), ("normal", d_in ** -0.5)),
                (f"gar.layer{n}.bi", (3 * H,), ("zeros",)),
                (f"gar.layer{n}.wh", (H, 3 * H), ("normal", H ** -0.5)),
                (f"gar.layer{n}.bh", (3 * H,), ("zeros",))]
        d_in = H
    return out


def forward(w: Dict[str, torch.Tensor], z: torch.Tensor, model: dict,
            rnd) -> torch.Tensor:
    """(B, T, D) -> (B, T, H): r, u = sigmoid(x W_i + b_i + h W_h + b_h)
    per gate, n = tanh(x_n + r (h W_hn + b_hn)), h' = (1 - u) n + u h."""
    h_in = z
    for n in range(model["ar"]["num_layers"]):
        wi, bi = w[f"gar.layer{n}.wi"], w[f"gar.layer{n}.bi"]
        wh, bh = w[f"gar.layer{n}.wh"], w[f"gar.layer{n}.bh"]
        B, T, _ = h_in.shape
        H = wh.shape[0]
        xp = rnd(h_in) @ rnd(wi) + bi
        wh_r = rnd(wh)
        h = h_in.new_zeros((B, H))
        outs = []
        for t in range(T):
            hp = rnd(h) @ wh_r + bh
            xr, xu, xn = xp[:, t].split(H, dim=-1)
            hr, hu, hn = hp.split(H, dim=-1)
            r = torch.sigmoid(xr + hr)
            u = torch.sigmoid(xu + hu)
            cand = torch.tanh(xn + r * hn)
            h = (1.0 - u) * cand + u * h
            outs.append(h)
        h_in = torch.stack(outs, dim=1)
    return h_in


