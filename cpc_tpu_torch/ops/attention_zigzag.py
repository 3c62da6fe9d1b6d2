"""Load-balanced ("zig-zag") context-parallel causal attention.

Port of `cpc_tpu/ops/attention_zigzag.py::zigzag_causal_mha`. The
contiguous ring (`ops/attention_ring.py`) gives rank R-1 the whole
triangle's worth of tiles and rank 0 one; the zig-zag layout balances it:

  layout:   the global T splits into 2R chunks of C = T / (2R); rank d
            holds chunks d and 2R-1-d, one early and one late, so every
            rank's causal work is the same.
  schedule: the own pair first (three sub-tiles: two under the in-chunk
            causal mask, one full). Then R-1 ring steps, each scoring two
            full (C, C) tiles and no masks:
              tile A: late rows x the owner's early chunk, always;
              tile B: early rows x the owner's early chunk when the owner
                      comes before this rank, else late rows x its late
                      chunk.
            (2R+1) sub-tiles a rank against the contiguous ring's 4R: the
            causal half, exactly, balanced. JAX selects tile B's operands
            with jnp.where (SPMD cannot branch per device); a rank here
            knows its owner on the host and takes the branch.
  reshard:  the public contract stays contiguous (rank d's rows are
            [d*T_loc, (d+1)*T_loc)), as ring_causal_mha's, so the
            positional offsets, the halo encoder and the InfoNCE labels
            need no zig-zag awareness. q, k and v move to the zig-zag
            layout with two permutations each (`_to_zigzag`) and the
            output moves back (`_from_zigzag`); autograd differentiates
            through them (`ops.ring_util.ppermute`), and only the attention
            core has its own backward (the saved lse and the travelling dK
            and dV of the contiguous ring).

It runs at any R, odd ones included. T_loc must be even (the global T must
divide by 2R). The arithmetic is the contiguous ring's (fp32 scores scaled
by Dh**-0.5, -1e30 masks). Plain tensor code: no kernel.
"""

from __future__ import annotations

import torch

from cpc_tpu_torch.ops.attention_ring import (causal, fold, fold_heads,
                                              init_stats, scores,
                                              tile_backward, unfold_heads)
from cpc_tpu_torch.ops.ring_util import ppermute


def _zdev(c: int, R: int) -> int:
    """The zig-zag owner of global chunk c (of 2R): min(c, 2R-1-c)."""
    return c if c < R else 2 * R - 1 - c


def _to_zigzag(x: torch.Tensor, ring) -> torch.Tensor:
    """(.., 2C, ..) contiguous local rows (global chunks 2d, 2d+1) -> the
    zig-zag local rows (chunks d, 2R-1-d), time on axis 1."""
    R, me = ring.size, ring.index
    C = x.shape[1] // 2
    # rank s's first half is chunk 2s, its second 2s+1: one hop each to
    # their zig-zag owner
    r0 = ppermute(x[:, :C], ring, [(s, _zdev(2 * s, R)) for s in range(R)])
    r1 = ppermute(x[:, C:], ring,
                  [(s, _zdev(2 * s + 1, R)) for s in range(R)])
    # r0 brought the even chunk this rank needs, r1 the odd one; chunk d
    # (the early slot) is even iff d is
    early, late = (r0, r1) if me % 2 == 0 else (r1, r0)
    return torch.cat([early, late], dim=1)


def _from_zigzag(x: torch.Tensor, ring) -> torch.Tensor:
    """The inverse of _to_zigzag (time on axis 1)."""
    R, me = ring.size, ring.index
    C = x.shape[1] // 2
    early, late = x[:, :C], x[:, C:]
    even, odd = (early, late) if me % 2 == 0 else (late, early)
    h0 = ppermute(even, ring, [(d, (d if d % 2 == 0 else 2 * R - 1 - d)
                                // 2) for d in range(R)])
    h1 = ppermute(odd, ring, [(d, ((2 * R - 1 - d) if d % 2 == 0 else d)
                               // 2) for d in range(R)])
    return torch.cat([h0, h1], dim=1)


def _halves(x: torch.Tensor):
    C = x.shape[1] // 2
    return x[:, :C], x[:, C:]


class _ZigzagAttn(torch.autograd.Function):
    """(BH, 2C, Dh) ZIG-ZAG-layout local q, k, v -> the same layout's
    output of causal attention over the global 2RC sequence."""

    @staticmethod
    def forward(ctx, q, k, v, scale, ring):
        R, me = ring.size, ring.index
        q_e, q_l = _halves(q.float())
        k_e, k_l = _halves(k)
        v_e, v_l = _halves(v)
        # the own pair: the only masked tiles of the schedule
        st_e = fold(init_stats(q_e),
                    causal(scores(q_e, k_e.float(), scale)), v_e.float())
        st_l = fold(init_stats(q_l), scores(q_l, k_e.float(), scale),
                    v_e.float())
        st_l = fold(st_l, causal(scores(q_l, k_l.float(), scale)),
                    v_l.float())
        chunk = torch.stack([k_e, k_l, v_e, v_l])
        for r in range(1, R):
            chunk = ring.shift(chunk)
            ke, kl, ve, vl = (c.float() for c in chunk)
            st_l = fold(st_l, scores(q_l, ke, scale), ve)       # tile A
            if (me - r) % R < me:                               # tile B
                st_e = fold(st_e, scores(q_e, ke, scale), ve)
            else:
                st_l = fold(st_l, scores(q_l, kl, scale), vl)
        (m_e, l_e, a_e), (m_l, l_l, a_l) = st_e, st_l
        o = torch.cat([a_e / l_e[..., None], a_l / l_l[..., None]],
                      dim=1).to(q.dtype)
        lse = torch.cat([m_e + torch.log(l_e), m_l + torch.log(l_l)], dim=1)
        ctx.save_for_backward(q, k, v, lse, o)
        ctx.scale, ctx.ring = scale, ring
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, lse, o = ctx.saved_tensors
        scale, ring = ctx.scale, ctx.ring
        R, me = ring.size, ring.index
        q_e, q_l = _halves(q.float())
        k_e, k_l = (x.float() for x in _halves(k))
        v_e, v_l = (x.float() for x in _halves(v))
        do = g.float()
        do_e, do_l = _halves(do)
        lse_e, lse_l = _halves(lse)
        dres_e, dres_l = _halves((do * o.float()).sum(dim=-1))
        late = (q_l, do_l, lse_l, dres_l)
        early = (q_e, do_e, lse_e, dres_e)

        def tile(rows, k32, v32, masked=False):
            qc, doc, lsec, dresc = rows
            return tile_backward(qc, k32, v32, doc, lsec, dresc, scale,
                                 masked)

        # the own pair, as the forward's three sub-tiles
        dq_e, dk_e, dv_e = tile(early, k_e, v_e, masked=True)
        dq_l, dk1, dv1 = tile(late, k_e, v_e)
        dk_e, dv_e = dk_e + dk1, dv_e + dv1
        dq2, dk_l, dv_l = tile(late, k_l, v_l, masked=True)
        dq_l = dq_l + dq2
        chunk = torch.stack(list(_halves(k)) + list(_halves(v)))
        grads = torch.stack([dk_e, dk_l, dv_e, dv_l])
        for r in range(1, R):
            # dK and dV travel with their chunks
            chunk = ring.shift(chunk)
            grads = ring.shift(grads)
            ke, kl, ve, vl = (c.float() for c in chunk)
            dq_t, dk_t, dv_t = tile(late, ke, ve)                # tile A
            dq_l = dq_l + dq_t
            grads[0] += dk_t
            grads[2] += dv_t
            if (me - r) % R < me:                                # tile B
                dq_t, dk_t, dv_t = tile(early, ke, ve)
                dq_e = dq_e + dq_t
                grads[0] += dk_t
                grads[2] += dv_t
            else:
                dq_t, dk_t, dv_t = tile(late, kl, vl)
                dq_l = dq_l + dq_t
                grads[1] += dk_t
                grads[3] += dv_t
        # the chunks sit one rotation short of home: one last hop
        grads = ring.shift(grads)
        dq = torch.cat([dq_e, dq_l], dim=1).to(q.dtype)
        dk = torch.cat([grads[0], grads[1]], dim=1).to(k.dtype)
        dv = torch.cat([grads[2], grads[3]], dim=1).to(v.dtype)
        return dq, dk, dv, None, None


def zigzag_causal_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      mesh, axis_name: str = "ctx",
                      scale: float = None) -> torch.Tensor:
    """ring_causal_mha's contract with the balanced zig-zag schedule. q,
    k, v (B, T_loc, H, Dh): this rank's CONTIGUOUS shard; T_loc must be
    even (the global T must divide by 2R). Returns the matching contiguous
    shard of exact causal attention over the global sequence; scale
    defaults to Dh**-0.5."""
    B, T_loc, H, Dh = q.shape
    if T_loc % 2:
        raise ValueError(
            f"zigzag attention needs an even per-device T (2 chunks/device;"
            f" got T_loc={T_loc}): make the global T divide 2*ring_size")
    if scale is None:
        scale = float(Dh) ** -0.5
    ring = mesh.ring(axis_name)
    qz, kz, vz = (_to_zigzag(fold_heads(x), ring) for x in (q, k, v))
    o = _from_zigzag(_ZigzagAttn.apply(qz, kz, vz, scale, ring), ring)
    return unfold_heads(o, B, H)
