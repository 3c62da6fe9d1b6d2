"""Context-parallel causal attention: the time axis sharded over the ranks
of a ring, K and V chunks travelling round it.

Port of `cpc_tpu/ops/attention_ring.py::ring_causal_mha`. Every op of the
transformer but attention is per position, so attention is the one op of
the gar that needs communication:

  layout:   rank d of R holds rows [d*T_loc, (d+1)*T_loc) of q, k and v,
            heads folded into the lead dimension (B*H, T_loc, Dh).
  forward:  R ring steps. Each rank scores its queries against the K/V
            chunk it holds under the GLOBAL causal mask (row and column
            offsets from the ranks), in fp32, folds the tile into running
            statistics (m, l and the output's accumulator: the flash trick
            at chunk granularity), then passes the chunk on.
  backward: the saved log-sum-exp and output. A second ring recomputes
            each tile, forms dS = P * (dO V^T - rowsum(dO * O)) * scale,
            adds dS K to dQ here, and adds each chunk's dK and dV into
            buffers that travel WITH the chunk: after R rotations they are
            home with every rank's share.

A chunk whose owner comes after this rank lies wholly above the causal
diagonal: the JAX module computes its tile and masks all of it, which
folds to nothing (exp(-1e30 - m) is 0, the corrections are 1); this port
skips the tile, with the same result, and still passes the chunk on. The
own chunk is the only one masked. K and V travel packed in one tensor, and
dK and dV in another, so a step makes one transfer of each.

Scores are q k^T * scale in fp32 with scale = Dh**-0.5 by default, masked
to -1e30, and the output is rounded once to q's dtype, as in the JAX ring
(which differs from the 'xla' path's q / sqrt(Dh) in the compute dtype).
Plain tensor code, as the JAX module is plain einsum: no kernel.
"""

from __future__ import annotations

import torch

_NEG = -1e30


def causal(s: torch.Tensor) -> torch.Tensor:
    """Masks columns above the diagonal of each (.., T, T) tile."""
    T = s.shape[-1]
    above = torch.ones((T, T), dtype=torch.bool, device=s.device).triu(1)
    return s.masked_fill(above, _NEG)


def scores(q32, k32, scale: float) -> torch.Tensor:
    return torch.bmm(q32, k32.transpose(1, 2)) * scale


def fold(stats, s, v32):
    """Folds the score tile s and its values into (m, l, acc)."""
    m, l, acc = stats
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.bmm(p, v32)
    return m_new, l, acc


def init_stats(q32):
    return (torch.full(q32.shape[:-1], _NEG, dtype=torch.float32,
                       device=q32.device),
            q32.new_zeros(q32.shape[:-1]), torch.zeros_like(q32))


def tile_backward(q32, k32, v32, do, lse, dres, scale, masked):
    """One tile's (dq, dk, dv) shares, from the saved lse."""
    s = scores(q32, k32, scale)
    if masked:
        s = causal(s)
    p = torch.exp(s - lse[..., None])
    dv = torch.bmm(p.transpose(1, 2), do)
    ds = p * (torch.bmm(do, v32.transpose(1, 2)) - dres[..., None]) * scale
    return torch.bmm(ds, k32), torch.bmm(ds.transpose(1, 2), q32), dv


class _RingAttn(torch.autograd.Function):
    """(BH, T_loc, Dh) local q, k, v -> the (BH, T_loc, Dh) output of
    causal attention over the ring's concatenated sequence."""

    @staticmethod
    def forward(ctx, q, k, v, scale, ring):
        R, me = ring.size, ring.index
        q32 = q.float()
        stats = init_stats(q32)
        kv = torch.stack([k, v])
        for r in range(R):
            owner = (me - r) % R
            if owner <= me:
                s = scores(q32, kv[0].float(), scale)
                stats = fold(stats, causal(s) if owner == me else s,
                             kv[1].float())
            if r < R - 1:
                kv = ring.shift(kv)
        m, l, acc = stats
        o = (acc / l[..., None]).to(q.dtype)
        ctx.save_for_backward(q, k, v, m + torch.log(l), o)
        ctx.scale, ctx.ring = scale, ring
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, lse, o = ctx.saved_tensors
        scale, ring = ctx.scale, ctx.ring
        R, me = ring.size, ring.index
        q32, do = q.float(), g.float()
        dres = (do * o.float()).sum(dim=-1)
        dq = torch.zeros_like(q32)
        dkv = q32.new_zeros((2, *k.shape))
        kv = torch.stack([k, v])
        for r in range(R):
            owner = (me - r) % R
            if owner <= me:
                dq_t, dk_t, dv_t = tile_backward(
                    q32, kv[0].float(), kv[1].float(), do, lse, dres, scale,
                    owner == me)
                dq += dq_t
                dkv[0] += dk_t
                dkv[1] += dv_t
            # dK and dV travel with their chunk
            if r < R - 1:
                kv = ring.shift(kv)
            dkv = ring.shift(dkv)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None)


def fold_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, Dh) -> (B*H, T, Dh)."""
    B, T, H, Dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * H, T, Dh)


def unfold_heads(o: torch.Tensor, B: int, H: int) -> torch.Tensor:
    """(B*H, T, Dh) -> (B, T, H, Dh)."""
    _, T, Dh = o.shape
    return o.reshape(B, H, T, Dh).permute(0, 2, 1, 3)


def ring_causal_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    mesh, axis_name: str = "ctx",
                    scale: float = None) -> torch.Tensor:
    """Causal MHA over a time-sharded sequence. q, k, v (B, T_loc, H, Dh):
    this rank's contiguous shard, in ring (query) order along `axis_name`
    of `mesh`. Returns the matching (B, T_loc, H, Dh) shard of exact
    causal attention over the global R * T_loc sequence; scale defaults to
    Dh**-0.5."""
    B, T_loc, H, Dh = q.shape
    if scale is None:
        scale = float(Dh) ** -0.5
    o = _RingAttn.apply(fold_heads(q), fold_heads(k), fold_heads(v), scale,
                        mesh.ring(axis_name))
    return unfold_heads(o, B, H)
