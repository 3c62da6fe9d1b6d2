"""All-steps InfoNCE over a ring of ranks: the global candidate pool is
never gathered, its chunks travel round the ring.

Port of `cpc_tpu/ops/infonce_ring.py`. 'all_steps' negatives score every
prediction against the GLOBAL pool; where `parallel.dp.gather_pool` builds
it on every rank, here each rank keeps its own chunk and the chunks go
round the ring (`ops.ring_util.Ring.shift`):

  forward:  R ring steps. Each rank scores its local prediction rows
            against the chunk it holds, in fp32, and folds the tile into
            running statistics (max m, sum l, the positive's score, the
            running argmax: the flash-attention trick applied round the
            ring), then passes the chunk on. The last chunk is scored
            without the rotation that would follow it.
  backward: the saved log-sum-exp alone. A second ring recomputes each
            score tile, forms delta = (softmax - onehot) * g, adds
            delta @ chunk to dp here and delta^T @ p to the chunk's dz,
            which travels WITH the chunk: after R rotations every dz is
            home with every rank's share.

Argmax ties: inside a tile the first maximum wins (`infonce.first_argmax`),
across tiles the lower global column wins, so the ring's accuracy equals
the gathered pool's first-index argmax whatever the order of visits.

The kernel (`_RingNLL`) takes each row's GLOBAL positive column (owner *
n_loc + local index; -1 for a row with none), so one kernel serves two
chunk geometries:

  * `ring_infonce_allsteps`: data parallelism, ranks own BATCH chunks; the
    loss and accuracy are this rank's means (the step averages them, as it
    averages every DP metric);
  * `ring_infonce_allsteps_ctx`: context parallelism, ranks own TIME
    chunks of the same rows; the loss and accuracy are global. With
    `data_axis` one ring runs over the flattened (data, ctx) ranks,
    data-major, and every prediction scores against the global B * T pool.

A score tile is computed in blocks of rows (`_ROW_BLOCK_BYTES` of fp32
scores a block): the statistics of a row do not depend on other rows, so
the blocking changes no forward value, and the peak memory stays a block
whatever B * T. The backward's dz sums over rows block by block, a
different fp32 summation order from one product. Plain tensor code, as the
JAX module is plain einsum: no kernel.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from cpc_tpu_torch.ops.ring_util import psum_global

_NEG = -1e30
_ROW_BLOCK_BYTES = 1 << 28


def _blocks(rows: int, n_loc: int):
    step = max(1, _ROW_BLOCK_BYTES // (4 * max(n_loc, 1)))
    for a in range(0, rows, step):
        yield slice(a, min(rows, a + step))


def _first_argmax(s: torch.Tensor) -> torch.Tensor:
    n = s.shape[-1]
    cols = torch.arange(n, device=s.device, dtype=torch.int32)
    top = s == s.max(dim=-1, keepdim=True).values
    return torch.where(top, cols, n).amin(dim=-1).long()


def _positive(labels: torch.Tensor, owner: int, n_loc: int):
    """(local column, whether the row's positive lies in owner's chunk)."""
    local = labels - owner * n_loc
    hit = (local >= 0) & (local < n_loc)
    return local.clamp(0, n_loc - 1), hit


class _RingNLL(torch.autograd.Function):
    """p_flat (rows, D) local predictions; z_flat (n_loc, D) this rank's
    candidate chunk; labels (rows,) the GLOBAL positive column of each row
    (-1: none, a masked row). Returns (nll, correct) per row against the
    global pool that the ring's chunks make up."""

    @staticmethod
    def forward(ctx, p_flat, z_flat, labels, ring):
        rows = p_flat.shape[0]
        n_loc = z_flat.shape[0]
        R, me = ring.size, ring.index
        p32 = p_flat.float()
        dev = p_flat.device
        m = torch.full((rows,), _NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((rows,), dtype=torch.float32, device=dev)
        slab = torch.zeros((rows,), dtype=torch.float32, device=dev)
        av = torch.full((rows,), _NEG, dtype=torch.float32, device=dev)
        ai = torch.full((rows,), torch.iinfo(torch.int32).max,
                        dtype=torch.long, device=dev)
        z = z_flat
        for r in range(R):
            owner = (me - r) % R
            z32 = z.float()
            local, hit = _positive(labels, owner, n_loc)
            for b in _blocks(rows, n_loc):
                s = p32[b] @ z32.T
                pos = s.gather(1, local[b, None])[:, 0]
                slab[b] += torch.where(hit[b], pos, 0.0)
                tile_max = s.max(dim=-1).values
                tile_arg = owner * n_loc + _first_argmax(s)
                # ties go to the LOWER global column, so the accuracy is the
                # gathered pool's first-index argmax in any visiting order
                better = (tile_max > av[b]) | ((tile_max == av[b])
                                               & (tile_arg < ai[b]))
                av[b] = torch.where(better, tile_max, av[b])
                ai[b] = torch.where(better, tile_arg, ai[b])
                m_new = torch.maximum(m[b], tile_max)
                s.sub_(m_new[:, None]).exp_()
                l[b] = l[b] * torch.exp(m[b] - m_new) + s.sum(dim=-1)
                m[b] = m_new
            if r < R - 1:
                z = ring.shift(z)
        lse = m + torch.log(l)
        nll = lse - slab
        correct = (ai == labels).float()
        ctx.save_for_backward(p_flat, z_flat, labels, lse)
        ctx.ring = ring
        ctx.mark_non_differentiable(correct)
        return nll, correct

    @staticmethod
    def backward(ctx, g_nll, _g_correct):
        p_flat, z_flat, labels, lse = ctx.saved_tensors
        ring = ctx.ring
        rows, D = p_flat.shape
        n_loc = z_flat.shape[0]
        R, me = ring.size, ring.index
        g = g_nll.float()
        p32 = p_flat.float()
        dp = torch.zeros((rows, D), dtype=torch.float32, device=p32.device)
        dz = torch.zeros((n_loc, D), dtype=torch.float32, device=p32.device)
        z = z_flat
        for r in range(R):
            owner = (me - r) % R
            z32 = z.float()
            local, hit = _positive(labels, owner, n_loc)
            for b in _blocks(rows, n_loc):
                delta = (p32[b] @ z32.T).sub_(lse[b, None]).exp_()
                delta.scatter_add_(1, local[b, None],
                                   -hit[b, None].to(delta.dtype))
                delta.mul_(g[b, None])
                dp[b] += delta @ z32
                dz += delta.T @ p32[b]
            # dz travels with its chunk: after R rotations it is home with
            # every rank's contribution
            if r < R - 1:
                z = ring.shift(z)
            dz = ring.shift(dz)
        return dp.to(p_flat.dtype), dz.to(z_flat.dtype), None, None


def _labels(B: int, Tp: int, K: int, T: int, shift: int, device):
    """The global positive column of each local row r = (t*K + k)*B + i."""
    r = torch.arange(Tp * K * B, device=device)
    i = r % B
    tk = r // B
    return (shift + i) * T + (tk // K + tk % K + 1)


def ring_infonce_allsteps(preds_v: torch.Tensor, z: torch.Tensor, *, mesh,
                          axis_name: str = "data"
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """All-steps InfoNCE over the global pool of every rank's z, never
    gathered: the ring counterpart of infonce_loss_and_metrics(negatives=
    'all_steps', mesh=...). preds_v (B, Tp, K, D) this rank's predictions
    for the window, z (B, T, D) its latents, the ring's chunk. Loss and
    accuracy are this rank's means."""
    B, Tp, K, D = preds_v.shape
    T = z.shape[1]
    ring = mesh.ring(axis_name)
    p_flat = preds_v.permute(1, 2, 0, 3).reshape(Tp * K * B, D)
    labels = _labels(B, Tp, K, T, ring.index * B, preds_v.device)
    nll, correct = _RingNLL.apply(p_flat, z.reshape(B * T, D), labels, ring)
    loss = nll.mean()
    acc = correct.reshape(Tp, K, B).mean(dim=(0, 2))
    return loss, {"loss": loss, "acc": acc, "acc_mean": acc.mean()}


def ring_infonce_allsteps_ctx(preds: torch.Tensor, z: torch.Tensor, *, mesh,
                              axis_name: str = "ctx",
                              data_axis: Optional[str] = None
                              ) -> Tuple[torch.Tensor,
                                         Dict[str, torch.Tensor]]:
    """All-steps InfoNCE with the TIME axis sharded: the loss half of
    context parallelism (`parallel/cp.py`).

    preds (B, T_loc, K, D) this rank's predictions for its steps; z (B,
    T_loc, D) its time chunk. Rank d of the ctx ring holds steps [d*T_loc,
    (d+1)*T_loc); a prediction's positive z_{t+k+1} often lies in another
    rank's chunk, which the ring visits. Rows with t_global >= T_global - K
    (the last rank's) have label -1: they match no column, take no
    gradient and are left out of the global means, which every rank
    returns alike. Equal to the all-steps loss on the gathered arrays, but
    for argmax ties in the accuracy: the ring's pool is time-chunk-major,
    the gathered one batch-major, so a score tie can crown another
    (equally maximal) winner.

    With `data_axis` the batch is sharded too (DP x CP): one ring over the
    flattened (data, ctx) ranks sweeps the global B_glob * T_glob pool. A
    row's positive lies in its own data row (chunk data_rank * R_c +
    t_tgt // T_loc); other rows' chunks are negatives only."""
    B, T_loc, K, D = preds.shape
    ctx_ring = mesh.ring(axis_name)
    R_c, me_c = ctx_ring.size, ctx_ring.index
    ring = ctx_ring if data_axis is None else mesh.ring((data_axis,
                                                         axis_name))
    T_glob = R_c * T_loc
    dev = preds.device
    p_flat = preds.permute(1, 2, 0, 3).reshape(T_loc * K * B, D)
    r = torch.arange(T_loc * K * B, device=dev)
    i = r % B
    tk = r // B
    k = tk % K
    t_glob = me_c * T_loc + tk // K
    t_tgt = t_glob + k + 1
    chunk = t_tgt // T_loc
    if data_axis is not None:
        chunk = mesh.ring(data_axis).index * R_c + chunk
    labels = chunk * (B * T_loc) + i * T_loc + t_tgt % T_loc
    valid = t_glob < T_glob - K
    labels = torch.where(valid, labels, -1)
    nll, correct = _RingNLL.apply(p_flat, z.reshape(B * T_loc, D), labels,
                                  ring)
    w = valid.float()
    ck = (correct * w).reshape(T_loc, K, B).sum(dim=(0, 2))
    wk = w.reshape(T_loc, K, B).sum(dim=(0, 2))
    # one collective: the loss's sum (its gradient passes through) and the
    # counts beside it
    tot = psum_global(torch.cat([(nll * w).sum()[None], w.sum()[None], ck,
                                 wk]), ring)
    loss = tot[0] / tot[1]
    acc = (tot[2:2 + K] / tot[2 + K:]).detach()
    return loss, {"loss": loss, "acc": acc, "acc_mean": acc.mean()}
