"""The data mesh: one process a device, its ranks along one 'data' axis.

Port of `cpc_tpu/parallel/mesh.py`. Where the JAX package lays a 1-D
`Mesh` over the devices of one SPMD program, the port runs one process a
card and its mesh is the torch.distributed process group: `ProcessMesh`
names this process's rank, the world size (the mesh's size) and the
device it runs on, the card of its rank on this host. Parameters are
replicated, the global batch is split along its rows (`rows`), and the
step's collectives run in `group` (`parallel.dp`).

`train.mesh_shape` is one axis: (-1,) spans every process, (n,) must be the
world size (`mesh_size`). Two-axis meshes (context parallelism under
'dpcp', tensor parallelism over 'model') wait for ROADMAP.md A10.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """This process's place in a data-parallel run.

    rank, size: the process's rank and the world size;
    device: where its model and batch live (`rank_device`: the card of its
        rank on this host);
    group: the group of the step's collectives (None: the default group);
    host_group: a gloo group for host-side flags and barriers, which never
        wait for the device (None: the default group, itself gloo)."""

    rank: int
    size: int
    device: torch.device
    group: Optional[Any] = None
    host_group: Optional[Any] = None

    def rows(self, batch_size: int) -> slice:
        """This rank's rows of a global batch of `batch_size`."""
        if batch_size % self.size:
            raise ValueError(
                f"batch_size {batch_size} is not divisible by the "
                f"{self.size}-way data axis; pass a compatible mesh= or "
                f"adjust data.batch_size")
        b = batch_size // self.size
        return slice(self.rank * b, (self.rank + 1) * b)


def mesh_size(mesh_shape: Sequence[int], world: int) -> int:
    """The size of the 1-D data mesh `mesh_shape` over a world of `world`
    processes: -1 spans them all; any other size must equal it."""
    if len(mesh_shape) != 1:
        raise NotImplementedError(
            f"train.mesh_shape={tuple(mesh_shape)}: the port's data "
            f"parallelism runs on a 1-D mesh of processes; 2-D meshes "
            f"(dpcp, tensor parallelism) are not ported yet (ROADMAP.md A10)")
    n = mesh_shape[0]
    if n == -1:
        return world
    if n != world:
        raise ValueError(
            f"train.mesh_shape={tuple(mesh_shape)}: multi-process training "
            f"needs the mesh to span all {world} global devices, got {n} "
            f"(per-process sub-meshes cannot run one SPMD program)")
    return n


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
