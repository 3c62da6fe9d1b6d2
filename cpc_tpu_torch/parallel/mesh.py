"""The process mesh: one process (or thread rank) a device, its ranks laid
out along a 'data' axis and, for context parallelism, a 'ctx' axis.

Port of `cpc_tpu/parallel/mesh.py`. Where the JAX package lays a `Mesh`
over the devices of one SPMD program, the port runs one process a card and
its mesh is the torch.distributed process group: `ProcessMesh` names this
process's rank, the world size (the mesh's size), the device it runs on
(the card of its rank on this host), and the mesh's shape.

The mesh is (data, ctx), flattened data-major as JAX flattens a tuple of
axes: rank = data_rank * ctx + ctx_rank. Under data parallelism ctx is 1
and the data axis is the world. `ring(axis)` gives the ranks along an axis
as an `ops.ring_util.Ring`: 'ctx' (this rank's data row, the CP ring),
'data' (this rank's column), or ('data', 'ctx') (the world in flattened
order: the DP x CP InfoNCE ring). Parameters are replicated, the global
batch is split along its rows over the data axis (`rows`), and under
context parallelism each rank of a data row takes its share of the time
axis.

`train.mesh_shape` / `train.mesh_axes` name the axes, 'data' and 'ctx';
one size may be -1 (the rest of the world) and the product must be the
world size (`mesh_size`, `axis_sizes`). 'model' axes (tensor parallelism)
raise, naming ROADMAP.md A10c. `thread_meshes` lays a mesh over ranks
played by threads of one process (`ops.ring_util.ThreadGroup`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import torch

from cpc_tpu_torch.ops.ring_util import Ring, ThreadGroup

AXES = ("data", "ctx")


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """This process's place in a parallel run.

    rank, size: the process's rank and the world size;
    device: where its model and batch live (`rank_device`: the card of its
        rank on this host);
    group: the group of the step's collectives (None: the default group);
    host_group: a gloo group for host-side flags and barriers, which never
        wait for the device (None: the default group, itself gloo);
    ctx: the size of the 'ctx' axis (1 under data parallelism);
    ctx_group, data_group: the groups of this rank's data row and column
        where both axes exceed 1 (else the world's group serves)."""

    rank: int
    size: int
    device: torch.device
    group: Optional[Any] = None
    host_group: Optional[Any] = None
    ctx: int = 1
    ctx_group: Optional[Any] = None
    data_group: Optional[Any] = None

    @property
    def data(self) -> int:
        """The size of the 'data' axis."""
        return self.size // self.ctx

    @property
    def data_rank(self) -> int:
        return self.rank // self.ctx

    @property
    def ctx_rank(self) -> int:
        return self.rank % self.ctx

    def rows(self, batch_size: int) -> slice:
        """This rank's rows of a global batch of `batch_size`: its share
        along the data axis."""
        if batch_size % self.data:
            raise ValueError(
                f"batch_size {batch_size} is not divisible by the "
                f"{self.data}-way data axis; pass a compatible mesh= or "
                f"adjust data.batch_size")
        b = batch_size // self.data
        return slice(self.data_rank * b, (self.data_rank + 1) * b)

    def ring(self, axis) -> Ring:
        """The ranks along `axis` ('data', 'ctx', or ('data', 'ctx'), the
        world in flattened order) as a Ring through this rank."""
        c, d = self.ctx, self.data
        if not isinstance(axis, str) and tuple(axis) == AXES:
            return Ring(self.group, range(self.size), self.rank)
        if axis == "ctx":
            group = self.ctx_group if d > 1 else self.group
            base = self.data_rank * c
            return Ring(group, self._places(group, [base + j
                                                    for j in range(c)]),
                        self.ctx_rank)
        if axis == "data":
            group = self.data_group if c > 1 else self.group
            return Ring(group, self._places(group, [i * c + self.ctx_rank
                                                    for i in range(d)]),
                        self.data_rank)
        raise ValueError(f"unknown mesh axis {axis!r}; the mesh has "
                         f"{AXES}")

    @staticmethod
    def _places(group, ranks: List[int]) -> List[int]:
        """A ThreadGroup addresses its members by place, a process group by
        global rank."""
        return list(range(len(ranks))) if isinstance(group, ThreadGroup) \
            else ranks


def axis_sizes(mesh_shape: Sequence[int], mesh_axes: Sequence[str],
               world: int) -> Dict[str, int]:
    """{'data': n, 'ctx': m} of the mesh `mesh_shape` over `mesh_axes` in a
    world of `world` processes: one -1 takes the rest of the world, and the
    sizes must multiply to it. A missing axis has size 1."""
    shape, axes = list(mesh_shape), tuple(mesh_axes)
    if "model" in axes:
        raise NotImplementedError(
            f"train.mesh_axes={axes}: tensor parallelism over 'model' is "
            f"not ported yet (ROADMAP.md A10c)")
    if len(shape) != len(axes):
        raise ValueError(f"train.mesh_shape={tuple(shape)} and "
                         f"train.mesh_axes={axes} differ in length")
    if len(set(axes)) != len(axes) or not set(axes) <= set(AXES):
        raise ValueError(f"train.mesh_axes={axes}: the port's mesh has the "
                         f"axes {AXES}, each at most once")
    if shape.count(-1) > 1:
        raise ValueError(f"train.mesh_shape={tuple(shape)}: at most one -1")
    if -1 in shape:
        known = 1
        for s in shape:
            known *= s if s != -1 else 1
        shape[shape.index(-1)] = world // known if world % known == 0 else 0
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(
            f"train.mesh_shape={tuple(mesh_shape)}: multi-process training "
            f"needs the mesh to span all {world} global devices, got {n} "
            f"(per-process sub-meshes cannot run one SPMD program)")
    sizes = {"data": 1, "ctx": 1}
    sizes.update(zip(axes, shape))
    return sizes


def mesh_size(mesh_shape: Sequence[int], world: int,
              mesh_axes: Sequence[str] = ("data",)) -> int:
    """The size of the mesh `mesh_shape` over `mesh_axes` in a world of
    `world` processes: -1 spans the rest; the product must equal it."""
    sizes = axis_sizes(mesh_shape, mesh_axes, world)
    return sizes["data"] * sizes["ctx"]


def thread_meshes(world: int, device, ctx: int = 1,
                  timeout: float = 300.0) -> List[ProcessMesh]:
    """A mesh for each of `world` ranks played by threads on `device`, ctx
    of them to a data row: ThreadGroups for the world, each data row and
    each column. Run them with `ops.ring_util.run_thread_ranks`."""
    if world % ctx:
        raise ValueError(f"a ctx axis of {ctx} does not divide {world} ranks")
    d = world // ctx
    world_group = ThreadGroup(world, timeout)
    rows = [ThreadGroup(ctx, timeout) for _ in range(d)]
    cols = [ThreadGroup(d, timeout) for _ in range(ctx)]
    device = torch.device(device)
    return [ProcessMesh(rank=r, size=world, device=device, group=world_group,
                        ctx=ctx, ctx_group=rows[r // ctx],
                        data_group=cols[r % ctx]) for r in range(world)]


def groups_of(meshes: Sequence[ProcessMesh]) -> list:
    """Every ThreadGroup of `meshes`, each once (to abort them together)."""
    seen: list = []
    for m in meshes:
        for g in (m.group, m.ctx_group, m.data_group):
            if isinstance(g, ThreadGroup) and all(g is not s for s in seen):
                seen.append(g)
    return seen


def rank_device(device, local_rank: int) -> torch.device:
    """The device of the rank `local_rank` on its host: `cuda:{local_rank}`
    for a bare 'cuda' (one card a process), the named card for 'cuda:i'
    (every rank on it), the CPU for 'cpu'."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank)
    return device


def check_one_rank_a_device(backend: str, device, local_world: int,
                            n_devices: int) -> None:
    """NCCL runs one rank a card: raises where two of this host's
    `local_world` ranks would share one, on the requested `device` ('cuda'
    puts each on its own, 'cuda:i' all on card i). gloo, asked for by
    name, may share a card."""
    device = torch.device(device)
    if backend != "nccl":
        return
    if local_world > n_devices or (device.index is not None
                                   and local_world > 1):
        raise ValueError(
            f"NCCL cannot run two ranks on one device: {local_world} ranks "
            f"on this host on '{device}' with {n_devices} CUDA device(s). "
            f"Launch one process a card, or ask for backend='gloo' by name "
            f"to rehearse several ranks on one card")
