"""The optimizer's update over every leaf at once: a hand-written CUDA kernel
pair and its plain version.

Replaces no TPU kernel: the JAX package's optimizer is optax's
clip_by_global_norm -> Adam or AdamW chain, which XLA fuses. The kernels are
in `csrc/adam_multi.cu`; its source note gives the design and what bounds
them on an H100.

    params, grads, mu, nu   one fp32 tensor a leaf in each, in leaf order;
                            params, mu and nu updated in place
    scalars (3,) fp32       the step's row of `Optimizer.scalars`: lr,
                            1 - b1^count, 1 - b2^count, on the device
    norm () fp32            the gradients' global norm, read when clip > 0

`adam_multi_reference` is the tensor code, leaf by leaf: the CPU path and
the reference the kernels are held against on the card. `LeafTable` holds a
fixed set of leaves for the kernels: `norm(grads)` is the sum of squares of
every gradient, per block of `CHUNK` elements, then their square root in a
second launch, in a fixed order (no atomics: two runs give the same bits);
`update(...)` is one launch that clips, updates the moments and the
parameters, and equals `adam_multi_reference` bit for bit given the same
norm. Leaves travel by value in the kernels' parameters, at most
`MAX_LEAVES` a launch: `plan_launches` splits a longer table into more
launches. `takes` says whether the kernels take a set of tensors; a table
raises on anything else, so a card never runs the tensor code in their
place. `adam_multi_sumsq.launches`, `adam_multi_norm.launches` and
`adam_multi_update.launches` count the kernels' launches.

Nothing here runs at import, and nothing builds before a `LeafTable` is
made: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from cpc_tpu_torch.ops._build import check_launch, load_library

PARAM_BYTES = 4096  # CUDA's space for a kernel's parameters
LEAF_BYTES = 44     # a leaf's four pointers, element count and first block
FIXED_BYTES = 256   # the table's leaf count and blocks, the other parameters
MAX_LEAVES = (PARAM_BYTES - FIXED_BYTES) // LEAF_BYTES  # 87 a launch
CHUNK = 4096        # elements a block: 256 threads, 4 float4 each
# (csrc/adam_multi.cu's kMaxLeaves and kChunk; the CPU tests hold them equal)


class Launch(NamedTuple):
    """One launch of each kernel: the leaves it takes (indices, ascending),
    the index of its first block among the partial sums, and the first
    block of each of its leaves, then its number of blocks."""
    leaves: Tuple[int, ...]
    block_base: int
    block_starts: Tuple[int, ...]


def plan_launches(numels: Sequence[int]) -> List[Launch]:
    """The launches over leaves of `numels` elements, in leaf order, at
    most MAX_LEAVES a launch. Block b of a launch takes elements
    [c CHUNK, min((c + 1) CHUNK, n)) of the leaf whose blocks hold b, c = b
    - its first block; the partial sums are numbered on across launches.
    Empty leaves are in no launch. Pure Python."""
    live = [i for i, n in enumerate(numels) if n > 0]
    launches, base = [], 0
    for a in range(0, len(live), MAX_LEAVES):
        leaves = tuple(live[a:a + MAX_LEAVES])
        starts = [0]
        for i in leaves:
            starts.append(starts[-1] + (numels[i] + CHUNK - 1) // CHUNK)
        launches.append(Launch(leaves, base, tuple(starts)))
        base += starts[-1]
    return launches


def adam_multi_reference(params, grads, mu, nu, scalars: torch.Tensor,
                         norm: Optional[torch.Tensor], *, b1: float,
                         b2: float, eps: float, clip: float,
                         weight_decay: float) -> None:
    """The update in tensor code, leaf by leaf, in place on params, mu and
    nu (optax's numerics; `train/train_step.py`'s docstring). Every
    division is by a device tensor, so the eager step and a CUDA graph of it
    compute the same bits (a CUDA tensor divided by a Python scalar is
    multiplied by its reciprocal instead)."""
    lr, bc1, bc2 = scalars.unbind()
    if clip > 0:  # optax: select(norm < clip, g, (g / norm) clip)
        grads = [torch.where(norm < clip, g, g / norm * clip) for g in grads]
    for p, g, m, v in zip(params, grads, mu, nu):
        m.mul_(b1).add_((1.0 - b1) * g)
        v.mul_(b2).add_((1.0 - b2) * (g * g))
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay > 0:
            u = u + weight_decay * p
        p.sub_(lr * u)


def takes(tensors, device: torch.device) -> bool:
    """Whether the kernels take these tensors: each a contiguous float32
    tensor on `device` (a CUDA device, for them to run)."""
    return all(isinstance(t, torch.Tensor) and t.dtype is torch.float32
               and t.device == device and t.is_contiguous()
               for t in tensors)


def _refused(what: str, device: torch.device) -> ValueError:
    return ValueError(f"the optimizer's kernels take {what}: contiguous "
                      f"float32 tensors on {device}")


def adam_multi_sumsq(lib, arrays: "_Arrays", block_base: int,
                     partials: torch.Tensor, device: int, stream) -> None:
    """One launch of the sum of squares over a launch's leaves, into
    partials[block_base:], on `stream`."""
    check_launch(lib, lib.adam_multi_sumsq(
        arrays.g, arrays.n, arrays.starts, arrays.count, block_base,
        partials.data_ptr(), device, stream), "adam_multi_sumsq")
    adam_multi_sumsq.launches += 1


def adam_multi_norm(lib, partials: torch.Tensor, blocks: int,
                    out: torch.Tensor, device: int, stream) -> None:
    """The launch that writes sqrt(sum of partials[:blocks]) into out."""
    check_launch(lib, lib.adam_multi_norm(
        partials.data_ptr(), blocks, out.data_ptr(), device, stream),
        "adam_multi_norm")
    adam_multi_norm.launches += 1


def adam_multi_update(lib, arrays: "_Arrays", norm_ptr, scalars_ptr: int,
                      hyper, device: int, stream) -> None:
    """One launch of the update over a launch's leaves."""
    check_launch(lib, lib.adam_multi_update(
        arrays.g, arrays.p, arrays.mu, arrays.nu, arrays.n, arrays.starts,
        arrays.count, norm_ptr, scalars_ptr, *hyper, device, stream),
        "adam_multi_update")
    adam_multi_update.launches += 1


adam_multi_sumsq.launches = 0
adam_multi_norm.launches = 0
adam_multi_update.launches = 0


class _Arrays:
    """One launch's leaf table as the C entry points take it."""

    def __init__(self, launch: Launch, params, mu, nu):
        k = len(launch.leaves)
        i64 = ctypes.c_longlong * k
        self.leaves = launch.leaves
        self.count = k
        self.g = i64()
        self.p, self.mu, self.nu = (
            i64(*[ts[i].data_ptr() for i in launch.leaves])
            for ts in (params, mu, nu))
        self.n = i64(*[params[i].numel() for i in launch.leaves])
        self.starts = (ctypes.c_int * (k + 1))(*launch.block_starts)


class LeafTable:
    """The kernels' view of a fixed set of leaves on one card: params, mu
    and nu (contiguous fp32, one device, their addresses read here once:
    update them in place, never replace them), the launch plan, and the
    partial sums' buffer. The gradients' addresses are read at every call,
    since autograd makes new gradients every step. Raises on leaves,
    gradients, scalars or a norm the kernels do not take."""

    def __init__(self, params, mu, nu, *, b1: float, b2: float, eps: float,
                 clip: float, weight_decay: float):
        params, mu, nu = list(params), list(mu), list(nu)
        if not params:
            raise ValueError("a leaf table needs at least one leaf")
        self.device = params[0].device
        if self.device.type != "cuda" or \
                not takes(params + mu + nu, self.device):
            raise _refused("parameters and moments", "one CUDA device")
        if [m.shape for m in mu] != [p.shape for p in params] or \
                [v.shape for v in nu] != [p.shape for p in params]:
            raise ValueError("mu and nu must have the leaves' shapes")
        self.lib = load_library()
        self.shapes = [p.shape for p in params]
        self.plan = plan_launches([p.numel() for p in params])
        self.arrays = [_Arrays(launch, params, mu, nu) for launch in self.plan]
        self.blocks = sum(launch.block_starts[-1] for launch in self.plan)
        self.partials = torch.empty(max(self.blocks, 1), dtype=torch.float32,
                                    device=self.device)
        self.clip = clip
        # each as PyTorch rounds it: ctypes passes the fp32 of the double
        self.hyper = (b1, 1.0 - b1, b2, 1.0 - b2, eps, clip, weight_decay,
                      int(clip > 0), int(weight_decay > 0))

    def _point(self, grads) -> None:
        """Reads the gradients' addresses into the launches' tables: one a
        leaf, in leaf order, each of its leaf's shape; raises on others."""
        if len(grads) != len(self.shapes) or \
                not takes(grads, self.device) or \
                any(g.shape != s for g, s in zip(grads, self.shapes)):
            raise _refused("one gradient of its leaf's shape a leaf",
                           self.device)
        for a in self.arrays:
            a.g[:] = [grads[i].data_ptr() for i in a.leaves]

    def norm(self, grads) -> torch.Tensor:
        """sqrt of the sum of squares of every entry of `grads` (one a leaf,
        in leaf order), in fp32: a 0-dim tensor on the card."""
        self._point(grads)
        out = torch.empty((), dtype=torch.float32, device=self.device)
        if not self.blocks:
            return out.zero_()
        dev = self.device.index
        stream = torch.cuda.current_stream(self.device).cuda_stream
        for launch, a in zip(self.plan, self.arrays):
            adam_multi_sumsq(self.lib, a, launch.block_base, self.partials,
                             dev, stream)
        adam_multi_norm(self.lib, self.partials, self.blocks, out, dev,
                        stream)
        return out

    def update(self, grads, scalars: torch.Tensor,
               norm: Optional[torch.Tensor]) -> None:
        """`adam_multi_reference` on the table's leaves: `grads` one a leaf
        in leaf order, `scalars` the step's (3,) row and, when the clip is
        on, `norm` one value, all contiguous fp32 on the table's card."""
        if not (takes([scalars], self.device) and scalars.shape == (3,)):
            raise _refused("a (3,) row of scalars", self.device)
        if self.clip > 0 and not (norm is not None
                                  and takes([norm], self.device)
                                  and norm.numel() == 1):
            raise _refused("one norm", self.device)
        self._point(grads)
        dev = self.device.index
        stream = torch.cuda.current_stream(self.device).cuda_stream
        norm_ptr = norm.data_ptr() if self.clip > 0 else None
        for a in self.arrays:
            adam_multi_update(self.lib, a, norm_ptr, scalars.data_ptr(),
                              self.hyper, dev, stream)
