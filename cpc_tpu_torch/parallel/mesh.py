"""The process mesh: one process (or thread rank) a device, its ranks laid
out along a 'data' axis and, for context parallelism, a 'ctx' axis or, for
tensor parallelism, a 'model' axis.

Port of `cpc_tpu/parallel/mesh.py`. Where the JAX package lays a `Mesh`
over the devices of one SPMD program, the port runs one process a card and
its mesh is the torch.distributed process group: `ProcessMesh` names this
process's rank, the world size (the mesh's size), the device it runs on
(the card of its rank on this host), and the mesh's shape.

The mesh is (data, ctx) or (data, model), flattened data-major as JAX
flattens a tuple of axes (`make_mesh((d, m), ("data", "model"))` reshapes
the devices so): rank = data_rank * inner + inner_rank, inner the size of
'ctx' or 'model'. The two inner axes never combine: JAX has no such mode.
Under data parallelism both are 1 and the data axis is the world.
`ring(axis)` gives the ranks along an axis as an `ops.ring_util.Ring`:
'ctx' (this rank's data row, the CP ring), 'model' (this rank's data row,
the TP group), 'data' (this rank's column), or ('data', 'ctx') (the world
in flattened order: the DP x CP InfoNCE ring). `data_mesh()` is this
rank's column as a mesh of its own: the data-parallel step's collectives
where a 'model' axis holds replicas. Parameters are replicated (or sharded
over 'model' by `parallel/tp.py`), the global batch is split along its
rows over the data axis (`rows`), and under context parallelism each rank
of a data row takes its share of the time axis.

`train.mesh_shape` / `train.mesh_axes` name the axes, 'data', 'ctx' and
'model'; one size may be -1 (the rest of the world) and the product must
be the world size (`mesh_size`, `axis_sizes`). `thread_meshes` lays a mesh
over ranks played by threads of one process (`ops.ring_util.ThreadGroup`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import torch

from cpc_tpu_torch.ops.ring_util import Ring, ThreadGroup

AXES = ("data", "ctx")
MESH_AXES = ("data", "ctx", "model")


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
    model: the size of the 'model' axis (1 but under tensor parallelism,
        or replicas under data parallelism); ctx and model are never both
        above 1;
    ctx_group, model_group: the group of this rank's data row along 'ctx'
        or 'model' where 'data' exceeds 1 (else the world's group serves);
    data_group: the group of this rank's column where an inner axis
        exceeds 1 (under 'model', also where 'data' is 1)."""

    rank: int
    size: int
    device: torch.device
    group: Optional[Any] = None
    host_group: Optional[Any] = None
    ctx: int = 1
    ctx_group: Optional[Any] = None
    data_group: Optional[Any] = None
    model: int = 1
    model_group: Optional[Any] = None

    def __post_init__(self):
        if self.ctx > 1 and self.model > 1:
            raise ValueError(
                f"a mesh has a 'ctx' or a 'model' axis, not both (ctx "
                f"{self.ctx}, model {self.model}): tensor parallelism does "
                f"not combine with context parallelism")
        if self.size % (self.ctx * self.model):
            raise ValueError(f"inner axes of {self.ctx * self.model} do not "
                             f"divide a world of {self.size}")

    @property
    def _inner(self) -> int:
        return self.ctx * self.model

    @property
    def data(self) -> int:
        """The size of the 'data' axis."""
        return self.size // self._inner

    @property
    def data_rank(self) -> int:
        return self.rank // self._inner

    @property
    def ctx_rank(self) -> int:
        return self.rank % self.ctx

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

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
        """The ranks along `axis` ('data', 'ctx', 'model', or ('data',
        'ctx'), the world in flattened order) as a Ring through this
        rank."""
        n, d = self._inner, self.data
        if not isinstance(axis, str) and tuple(axis) == AXES:
            return Ring(self.group, range(self.size), self.rank)
        if axis in ("ctx", "model"):
            size = self.ctx if axis == "ctx" else self.model
            inner = self.ctx_group if axis == "ctx" else self.model_group
            group = inner if d > 1 else self.group
            base = self.data_rank * n
            index = self.ctx_rank if axis == "ctx" else self.model_rank
            if size != n:  # the other inner axis: this rank alone
                return Ring(group, [self.rank], 0)
            return Ring(group, self._places(group, [base + j
                                                    for j in range(n)]),
                        index)
        if axis == "data":
            group = self.data_group if n > 1 else self.group
            return Ring(group, self._places(group, [i * n + self.rank % n
                                                    for i in range(d)]),
                        self.data_rank)
        raise ValueError(f"unknown mesh axis {axis!r}; the mesh has "
                         f"{MESH_AXES}")

    def data_mesh(self) -> "ProcessMesh":
        """This rank's column (the ranks of its model rank) as a mesh of
        its own, for the data-parallel step's collectives where a 'model'
        axis holds replicas; the mesh itself without one."""
        if self.model == 1:
            return self
        return ProcessMesh(rank=self.data_rank, size=self.data,
                           device=self.device, group=self.data_group,
                           host_group=self.host_group)

    @staticmethod
    def _places(group, ranks: List[int]) -> List[int]:
        """A ThreadGroup addresses its members by place, a process group by
        global rank."""
        return list(range(len(ranks))) if isinstance(group, ThreadGroup) \
            else ranks


def axis_sizes(mesh_shape: Sequence[int], mesh_axes: Sequence[str],
               world: int) -> Dict[str, int]:
    """{'data': n, 'ctx': m, 'model': k} of the mesh `mesh_shape` over
    `mesh_axes` in a world of `world` processes: one -1 takes the rest of
    the world, and the sizes must multiply to it. A missing axis has size
    1; 'ctx' and 'model' do not combine."""
    shape, axes = list(mesh_shape), tuple(mesh_axes)
    if len(shape) != len(axes):
        raise ValueError(f"train.mesh_shape={tuple(shape)} and "
                         f"train.mesh_axes={axes} differ in length")
    if len(set(axes)) != len(axes) or not set(axes) <= set(MESH_AXES):
        raise ValueError(f"train.mesh_axes={axes}: the port's mesh has the "
                         f"axes {MESH_AXES}, each at most once")
    if {"ctx", "model"} <= set(axes):
        raise ValueError(
            f"train.mesh_axes={axes}: 'ctx' and 'model' do not combine "
            f"(tensor parallelism with context parallelism has no mode in "
            f"the JAX package either)")
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
    sizes = {"data": 1, "ctx": 1, "model": 1}
    sizes.update(zip(axes, shape))
    return sizes


def mesh_size(mesh_shape: Sequence[int], world: int,
              mesh_axes: Sequence[str] = ("data",)) -> int:
    """The size of the mesh `mesh_shape` over `mesh_axes` in a world of
    `world` processes: -1 spans the rest; the product must equal it."""
    sizes = axis_sizes(mesh_shape, mesh_axes, world)
    return sizes["data"] * sizes["ctx"] * sizes["model"]


def thread_meshes(world: int, device, ctx: int = 1,
                  timeout: float = 300.0, model: int = 1
                  ) -> List[ProcessMesh]:
    """A mesh for each of `world` ranks played by threads on `device`, ctx
    (or model) of them to a data row: ThreadGroups for the world, each
    data row and each column. Run them with
    `ops.ring_util.run_thread_ranks`."""
    if ctx > 1 and model > 1:
        raise ValueError("a mesh has a 'ctx' or a 'model' axis, not both")
    inner = ctx * model
    if world % inner:
        raise ValueError(f"a {'ctx' if ctx > 1 else 'model'} axis of "
                         f"{inner} does not divide {world} ranks")
    d = world // inner
    world_group = ThreadGroup(world, timeout)
    rows = [ThreadGroup(inner, timeout) for _ in range(d)]
    cols = [ThreadGroup(d, timeout) for _ in range(inner)]
    device = torch.device(device)
    return [ProcessMesh(rank=r, size=world, device=device, group=world_group,
                        ctx=ctx, ctx_group=rows[r // inner],
                        data_group=cols[r % inner], model=model,
                        model_group=rows[r // inner] if model > 1 else None)
            for r in range(world)]


def groups_of(meshes: Sequence[ProcessMesh]) -> list:
    """Every ThreadGroup of `meshes`, each once (to abort them together)."""
    seen: list = []
    for m in meshes:
        for g in (m.group, m.ctx_group, m.data_group, m.model_group):
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
