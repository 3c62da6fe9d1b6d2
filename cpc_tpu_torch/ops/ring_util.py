"""The ring transport: what the ring kernels (`ops/infonce_ring.py`,
`ops/attention_ring.py`, `ops/attention_zigzag.py`) and the halo encoder
send between ranks.

Port of `cpc_tpu/ops/ring_util.py` (`ring_perm`; JAX's `pvary` has no
counterpart, since nothing here is typed by the axes it varies over). Where
JAX names a mesh axis inside shard_map and calls `lax.ppermute` and
`lax.psum`, the port hands the ring kernels a `Ring`: the ranks along one
axis of the mesh, in ring order, and this rank's place among them.
`Ring.permute(x, perm)` sends x to the ranks that `perm` names and returns
what this rank received, in one call, as `ppermute` does; `all_reduce` sums
a tensor over the ring's ranks in place.

A ring runs on one of two transports:

  * a torch.distributed process group: `permute` is one
    `batch_isend_irecv` of this rank's sends and receives (NCCL on the
    cards, gloo on the CPU), `all_reduce` is `dist.all_reduce`;
  * a `ThreadGroup`: ranks played by threads of one process on one device
    (`run_thread_ranks`), so that R = 2, 3 or 4 runs on a CPU or on one
    card. A permute posts each rank's tensor and copies the one it
    receives; an all_reduce sums the ranks' tensors in rank order, so every
    rank holds the same bits.

A ring of one rank sends nothing (torch cannot send to its own rank): its
permute returns a copy of x and its all_reduce leaves the tensor as it is.
A rank that `perm` gives nothing receives zeros, as in JAX.

The autograd functions differentiate through the transport, as JAX
differentiates through its collectives:

  * `ppermute`: the backward sends the gradient back along the inverse
    permutation;
  * `psum`: a sum whose result every rank consumes in its own way (a batch
    norm's statistics); the backward sums the ranks' gradients;
  * `psum_global`: a sum every rank holds as the one global value of the
    step (the CP loss); the backward passes each rank's gradient through,
    so the parameter gradients of the ranks add up to the gradient of the
    one loss (shard_map's psum of an unvarying output, transposed).

A collective inside a backward must be called by every rank of the ring in
the same order: the ranks build the same graph, and a tensor that one rank
zeroes (the halo at the sequence's ends) is zeroed by arithmetic, never
dropped from the graph. Thread ranks run their backward in their own
thread (`torch.autograd.set_multithreading_enabled(False)`), since on a
card autograd would otherwise run every rank's backward in its one device
thread, where the first collective would wait for ranks that cannot run.

`axis_env(mesh)` names the mesh that a module in the forward finds
(`current_mesh`): the transformer's ring attention reads it as the JAX
module reads its shard_map axis.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0


def ring_perm(R: int) -> List[Tuple[int, int]]:
    """[(j, j+1 mod R)]: each rank forwards its chunk to its neighbour."""
    return [(j, (j + 1) % R) for j in range(R)]


def inverse(perm) -> Tuple[Tuple[int, int], ...]:
    return tuple((d, s) for s, d in perm)


class ThreadGroup:
    """`size` ranks played by threads of one process. `exchange` is the
    one rendezvous: every rank posts an item, then each reads what it needs
    from every rank's post before any rank goes on."""

    def __init__(self, size: int, timeout: float = DEFAULT_TIMEOUT_S):
        self.size = size
        self._posts = [None] * size
        self._barrier = threading.Barrier(size, timeout=timeout)

    def exchange(self, index: int, item, take: Callable):
        self._posts[index] = item
        self._barrier.wait()
        try:
            return take(list(self._posts))
        finally:
            self._barrier.wait()

    def all_reduce(self, t: torch.Tensor, index: int) -> None:
        def total(posts):
            out = posts[0].clone()
            for p in posts[1:]:
                out += p
            return out
        t.copy_(self.exchange(index, t.clone(), total))

    def abort(self) -> None:
        """Releases every rank waiting here with BrokenBarrierError."""
        self._barrier.abort()


def all_reduce(t: torch.Tensor, group, index: int) -> None:
    """Sums t over the ranks of `group` in place: a ThreadGroup's threads
    (`index` is this rank's place in it), else torch.distributed's group
    (None: the default group)."""
    if isinstance(group, ThreadGroup):
        group.all_reduce(t, index)
    else:
        dist.all_reduce(t, group=group)


class Ring:
    """The ranks along one mesh axis. group: a ThreadGroup, a process group,
    or None (the default group); ranks: the group members' ranks, in ring
    order (global ranks for a process group, places for a ThreadGroup);
    index: this rank's place in `ranks`."""

    def __init__(self, group, ranks: Sequence[int], index: int):
        self.group = group
        self.ranks = tuple(ranks)
        self.index = index
        if not 0 <= index < len(self.ranks):
            raise ValueError(f"place {index} outside a ring of "
                             f"{len(self.ranks)}")

    @property
    def size(self) -> int:
        return len(self.ranks)

    def permute(self, x: torch.Tensor, perm) -> torch.Tensor:
        """What this rank receives when every rank j sends its x to the
        ranks d of perm's pairs (j, d): the x of the rank s with (s, index)
        in perm, zeros where there is none."""
        me = self.index
        src = [s for s, d in perm if d == me]
        if len(src) > 1:
            raise ValueError(f"rank {me} receives twice in {perm}")
        if self.size == 1:
            return x.clone() if src else torch.zeros_like(x)
        if isinstance(self.group, ThreadGroup):
            return self.group.exchange(
                me, x, lambda posts: posts[src[0]].clone() if src
                else torch.zeros_like(x))
        x = x.contiguous()
        ops, out = [], None
        for s, d in perm:
            if s == me and d != me:
                ops.append(dist.P2POp(dist.isend, x, self.ranks[d],
                                      self.group))
        if src:
            if src[0] == me:
                out = x.clone()
            else:
                out = torch.empty_like(x)
                ops.append(dist.P2POp(dist.irecv, out, self.ranks[src[0]],
                                      self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out if out is not None else torch.zeros_like(x)

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        """x sent one step round the ring (j -> j+1), what arrives here."""
        return self.permute(x, ring_perm(self.size))

    def all_reduce(self, t: torch.Tensor) -> None:
        """Sums t over the ring's ranks, in place."""
        if self.size > 1:
            all_reduce(t, self.group, self.index)


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ring, perm):
        ctx.ring, ctx.perm = ring, perm
        return ring.permute(x, perm)

    @staticmethod
    def backward(ctx, g):
        return ctx.ring.permute(g, inverse(ctx.perm)), None, None


def ppermute(x: torch.Tensor, ring: Ring, perm) -> torch.Tensor:
    """Ring.permute, differentiable: the gradient goes back to the sender."""
    return _Permute.apply(x, ring, tuple(tuple(p) for p in perm))


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ring, sum_grads):
        ctx.ring, ctx.sum_grads = ring, sum_grads
        out = x.clone()
        ring.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grads:
            g = g.clone()
            ctx.ring.all_reduce(g)
        return g, None, None


def psum(x: torch.Tensor, ring: Ring) -> torch.Tensor:
    """The sum of x over the ring, which each rank then uses in its own way:
    the backward sums the ranks' gradients."""
    return _Psum.apply(x, ring, True)


def psum_global(x: torch.Tensor, ring: Ring) -> torch.Tensor:
    """The sum of x over the ring, held by every rank as the one global
    value of the step (a loss): the backward passes the gradient through,
    so that the ranks' parameter gradients sum to the loss's."""
    return _Psum.apply(x, ring, False)


# --------------------------------------------------------------- axis env
_ENV = threading.local()


@contextlib.contextmanager
def axis_env(mesh):
    """Inside the block, `current_mesh()` is `mesh` (in this thread)."""
    prev = getattr(_ENV, "mesh", None)
    _ENV.mesh = mesh
    try:
        yield mesh
    finally:
        _ENV.mesh = prev


def current_mesh():
    """The mesh of the innermost `axis_env` of this thread, or None."""
    return getattr(_ENV, "mesh", None)


# ----------------------------------------------------------- thread ranks
def run_thread_ranks(groups: Sequence[ThreadGroup], fns: Sequence[Callable],
                     timeout: float = DEFAULT_TIMEOUT_S) -> list:
    """fns[r]() in one thread a rank, each with autograd's backward in its
    own thread; returns their results in rank order. An exception in any
    rank aborts every group, so that no rank waits for it, and is raised
    here with its rank."""
    out: list = [None] * len(fns)
    errors: List[Tuple[int, BaseException]] = []

    def run(r):
        try:
            with torch.autograd.set_multithreading_enabled(False):
                out[r] = fns[r]()
        except BaseException as e:  # raised below, with the rank
            errors.append((r, e))
            for g in groups:
                g.abort()

    threads = [threading.Thread(target=run, args=(r,), daemon=True)
               for r in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    if any(t.is_alive() for t in threads):
        for g in groups:
            g.abort()
        raise TimeoutError(f"thread ranks still running after {timeout} s")
    if errors:
        first = min(errors, key=lambda e: isinstance(
            e[1], threading.BrokenBarrierError))
        raise RuntimeError(f"rank {first[0]} failed: {first[1]!r}") \
            from first[1]
    return out
