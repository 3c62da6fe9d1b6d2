"""The data-parallel step's collectives: the gathered candidate pool and
the averaged gradients and metrics.

Port of `cpc_tpu/parallel/dp.py`. Semantics, as there:
  * parameters and optimizer state replicated (`multihost.replicate`), the
    global batch split along its rows, one rank a share;
  * loss.cross_replica=True: the latents z are gathered inside the loss
    (`gather_pool`), so every rank scores its predictions against the
    GLOBAL pool, this rank's positives at shift = rank * B_local: the loss
    of the whole batch on one device;
  * loss.cross_replica=False: each rank keeps its own pool at shift 0;
  * gradients and metrics are averaged over the ranks (`average`), so the
    update is the single-device step on the global batch.

Both collectives are `all_reduce` sums. The gather writes this rank's rows
into a zeroed (size * B, ...) buffer and sums it over the ranks, which
adds zeros and is exact; its backward sums the pool's gradient over the
ranks in fp32, rounds it once to z's dtype, and keeps this rank's rows:
the transpose of JAX's all_gather, its psum_scatter. torch documents only
`broadcast` and `all_reduce` for CUDA tensors under gloo, so the code that
two gloo ranks sharing a card run is the code NCCL runs. All-gather and
reduce-scatter under NCCL are later work (ROADMAP.md A5). A mesh of thread
ranks (`mesh.thread_meshes`) sums through its ThreadGroup
(`ops.ring_util.all_reduce`).
"""

from __future__ import annotations

import functools
from typing import Callable, List, Sequence, Tuple

import torch

from cpc_tpu_torch.ops.ring_util import all_reduce
from cpc_tpu_torch.parallel.mesh import ProcessMesh


class _GatherPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, mesh):
        B = z.shape[0]
        rows = slice(mesh.rank * B, (mesh.rank + 1) * B)
        pool = z.new_zeros((mesh.size * B, *z.shape[1:]))
        pool[rows] = z
        all_reduce(pool, mesh.group, mesh.rank)
        ctx.mesh, ctx.rows, ctx.dtype = mesh, rows, z.dtype
        return pool

    @staticmethod
    def backward(ctx, g):
        total = torch.empty(g.shape, dtype=torch.float32, device=g.device)
        total.copy_(g)
        all_reduce(total, ctx.mesh.group, ctx.mesh.rank)
        return total[ctx.rows].to(ctx.dtype), None


def gather_pool(z: torch.Tensor, mesh: ProcessMesh
                ) -> Tuple[torch.Tensor, int]:
    """(pool, shift): every rank's z (B, ...) stacked in rank order,
    (size * B, ...), and the pool row of this rank's first positive. The
    pool's gradient flows back to each rank's z."""
    return _GatherPool.apply(z, mesh), mesh.rank * z.shape[0]


def average(tensors: Sequence[torch.Tensor], mesh: ProcessMesh
            ) -> List[torch.Tensor]:
    """The mean over the ranks of each tensor, in its dtype: one all_reduce
    of one fp32 buffer, divided by the world size."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    all_reduce(flat, mesh.group, mesh.rank)
    flat /= mesh.size
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


def dp_train_step(step_fn: Callable, mesh: ProcessMesh) -> Callable:
    """step_fn(batch, mesh=...) -> metrics on this rank's rows. step_fn
    averages its own gradients and metrics; this only binds the mesh."""
    return functools.partial(step_fn, mesh=mesh)


def dp_eval_step(eval_fn: Callable, mesh: ProcessMesh) -> Callable:
    return functools.partial(eval_fn, mesh=mesh)
