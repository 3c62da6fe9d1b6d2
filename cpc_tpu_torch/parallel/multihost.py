"""Multi-process runtime: the process group's bring-up and what the host
side of a parallel run needs, on one host or across hosts.

Port of `cpc_tpu/parallel/multihost.py`. Every process runs the same step
on its own card (`parallel.dp`, `parallel.cp`, `parallel.tp`); this module
gives the host side:

  * `initialize` forms the torch.distributed group and returns this
    process's `ProcessMesh`: a `tcp://` rendezvous at a coordinator's
    address, else `env://` from a launcher's MASTER_ADDR, MASTER_PORT,
    RANK and WORLD_SIZE (and LOCAL_RANK, LOCAL_WORLD_SIZE where torchrun
    sets them). NCCL on CUDA and gloo on the CPU unless `backend` names
    one; a gloo group beside NCCL carries the host's flags and barriers.
    Every wait is bounded by `timeout`, so a rank that dies fails the
    others instead of hanging them.
  * A rank's card is its LOCAL rank, its place among the ranks of its
    host: LOCAL_RANK and LOCAL_WORLD_SIZE where the launcher sets them;
    the rank and the world under a loopback coordinator (127.0.0.1, which
    only this host reaches); else (`--coordinator` at a host's address, or
    a launcher that sets neither) derived after the rendezvous from every
    rank's hostname (`local_layout`). Ranks that share a host take one
    intra-op thread each (`share_host_threads`), and NCCL's one rank a
    card is checked against the host's cards
    (`mesh.check_one_rank_a_device`).
  * `replicate` broadcasts rank 0's tensors (model, optimizer state and
    resume position) after init or restore.
  * `shard_batch` takes this rank's rows of the global host batch: every
    rank assembles the same seeded batch and copies only its share to its
    card.
  * `host_local` copies tensors to the host for rank 0's checkpoint.
  * `with_ctx` lays the world out as a (data, ctx) mesh for context
    parallelism, `with_model` as a (data, model) mesh for tensor
    parallelism (or model replicas under data parallelism), forming each
    data row's and column's group.
  * `active`, `is_main`, `barrier`, `any_true` (a MAX all_reduce of a host
    flag: the trainer's agreement on preemption, so that every rank saves
    at the same step) and `shutdown`.

Checkpoints, metrics, the resolved config and the synthetic corpus are
rank 0's to write, into a workdir that every rank reads (`train.trainer`,
`train.cli`; the corpus behind a barrier): across hosts the workdir must
be shared, as the JAX package requires of its orbax checkpoints.
"""

from __future__ import annotations

import dataclasses
import datetime
import ipaddress
import os
import socket
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cpc_tpu_torch.ops.ring_util import ThreadGroup
from cpc_tpu_torch.parallel.mesh import (ProcessMesh, check_one_rank_a_device,
                                         rank_device)

DEFAULT_TIMEOUT_S = 300.0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device,
               backend: Optional[str] = None,
               timeout: float = DEFAULT_TIMEOUT_S) -> ProcessMesh:
    """Joins this process to the group and returns its mesh. With
    `coordinator_address` ("host:port" of rank 0) the world is
    `num_processes` processes and this one is `process_id`; without it the
    launcher's environment says so. `device` is 'cuda' (the card of this
    process's local rank), 'cuda:i' (card i, gloo only) or 'cpu'."""
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    local = None
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
        init_method = f"tcp://{coordinator_address}"
        world, rank = num_processes, process_id
        if _loopback(coordinator_address):
            # only this host reaches a loopback coordinator: every rank is
            # here, and a bad layout is refused before the group forms
            local = (rank, world)
    else:
        init_method = "env://"
        world = num_processes if num_processes is not None \
            else int(os.environ["WORLD_SIZE"])
        rank = process_id if process_id is not None \
            else int(os.environ["RANK"])
        if "LOCAL_RANK" in os.environ and "LOCAL_WORLD_SIZE" in os.environ:
            local = (int(os.environ["LOCAL_RANK"]),
                     int(os.environ["LOCAL_WORLD_SIZE"]))
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    if local is not None:
        _place(local, backend, device)
    wait = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, timeout=wait)
    try:
        host_group = None
        if backend != "gloo":
            host_group = dist.new_group(backend="gloo", timeout=wait)
        if local is None:
            names: list = [None] * world
            dist.all_gather_object(names, socket.gethostname(),
                                   group=host_group)
            local = local_layout(names, rank)
            _place(local, backend, device)
    except BaseException:
        dist.destroy_process_group()
        raise
    return ProcessMesh(rank=rank, size=world,
                       device=rank_device(device, local[0]),
                       host_group=host_group)


def _place(local: Tuple[int, int], backend: str, device) -> None:
    """Checks this host's ranks against its cards, shares its cores, and
    makes this rank's card the current one."""
    local_rank, local_world = local
    if not 0 <= local_rank < local_world:
        raise ValueError(f"local rank {local_rank} outside a host of "
                         f"{local_world} ranks")
    n_devices = torch.cuda.device_count() if device.type == "cuda" else 0
    check_one_rank_a_device(backend, device, local_world, n_devices)
    share_host_threads(local_world)
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)


def _loopback(address: str) -> bool:
    """True for a "host:port" whose host is a loopback address."""
    host = address.rsplit(":", 1)[0].strip("[]")
    if host == "localhost":
        return True
    try:
        return ipaddress.ip_address(host).is_loopback
    except ValueError:
        return False


def local_layout(hostnames: Sequence[str], rank: int) -> Tuple[int, int]:
    """(local rank, local world) of `rank` in a world whose rank r runs on
    host `hostnames[r]`: its place among the ranks of its host, in rank
    order, and their number."""
    mine = [r for r, h in enumerate(hostnames) if h == hostnames[rank]]
    return mine.index(rank), len(mine)


def with_ctx(mesh: ProcessMesh, ctx: int,
             timeout: float = DEFAULT_TIMEOUT_S) -> ProcessMesh:
    """`mesh` as a (data, ctx) mesh with ctx ranks to a data row, flattened
    data-major. Where both axes exceed 1 every rank forms every row's and
    column's group (torch.distributed's new_group is collective) and keeps
    its own."""
    data = _inner_axis(mesh, ctx, "ctx")
    ctx_group = data_group = None
    if ctx > 1 and data > 1:
        ctx_group, data_group = _row_and_column(mesh, ctx, timeout)
    return dataclasses.replace(mesh, ctx=ctx, ctx_group=ctx_group,
                               data_group=data_group)


def with_model(mesh: ProcessMesh, model: int,
               timeout: float = DEFAULT_TIMEOUT_S) -> ProcessMesh:
    """`mesh` as a (data, model) mesh with `model` ranks to a data row,
    flattened data-major as JAX's `make_mesh((d, m), ("data", "model"))`
    lays out its devices: rank = data_rank * model + model_rank. Where
    model exceeds 1 every rank forms every column's group (the data
    axis's, which the data-parallel collectives and the pool's gather take
    even with one data row) and, where data exceeds 1, every row's."""
    data = _inner_axis(mesh, model, "model")
    model_group = data_group = None
    if model > 1:
        model_group, data_group = _row_and_column(mesh, model, timeout)
    return dataclasses.replace(mesh, model=model, model_group=model_group,
                               data_group=data_group)


def _inner_axis(mesh: ProcessMesh, n: int, name: str) -> int:
    if mesh.size % n:
        raise ValueError(f"a {name} axis of {n} does not divide a world of "
                         f"{mesh.size}")
    if isinstance(mesh.group, ThreadGroup):
        raise ValueError(f"a thread mesh's axes are fixed where it is made "
                         f"(mesh.thread_meshes(..., {name}={n}))")
    return mesh.size // n


def _row_and_column(mesh: ProcessMesh, n: int, timeout: float):
    """The groups of this rank's data row (n ranks) and column, each
    formed by every rank."""
    wait = datetime.timedelta(seconds=timeout)
    data = mesh.size // n
    rows = [dist.new_group([i * n + j for j in range(n)], timeout=wait)
            for i in range(data)]
    cols = [dist.new_group([i * n + j for i in range(data)], timeout=wait)
            for j in range(n)]
    return rows[mesh.rank // n], cols[mesh.rank % n]


def share_host_threads(local_world: int) -> None:
    """Several ranks on one host: one intra-op thread a process, as torchrun
    sets it, unless OMP_NUM_THREADS says otherwise. Four processes with a
    thread a core each ran the trainer on four H100s 3.1-3.3x slower than
    one process on one card (PERF.md)."""
    if local_world > 1 and "OMP_NUM_THREADS" not in os.environ:
        torch.set_num_threads(1)


def shutdown() -> None:
    """Leaves the group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def active(mesh: Optional[ProcessMesh]) -> bool:
    """True when the run spans more than one process."""
    return mesh is not None and mesh.size > 1


def is_main(mesh: Optional[ProcessMesh]) -> bool:
    """True on rank 0, and in a run without a mesh."""
    return mesh is None or mesh.rank == 0


def barrier(mesh: Optional[ProcessMesh]) -> None:
    """Every rank waits here for the others (writers before readers)."""
    if mesh is not None:
        dist.barrier(group=mesh.host_group)


def any_true(flag: bool, mesh: ProcessMesh) -> bool:
    """OR of a host flag over the ranks. Collective: every rank calls it at
    the same point."""
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.host_group)
    return bool(t.item())


def replicate(tensors: Iterable[torch.Tensor], mesh: ProcessMesh) -> None:
    """Overwrites each tensor, in place, with rank 0's: host tensors over
    the host group, device tensors over the step's group."""
    with torch.no_grad():
        for t in tensors:
            group = mesh.host_group if t.device.type == "cpu" else mesh.group
            dist.broadcast(t, src=0, group=group)


def shard_batch(host_batch: np.ndarray,
                mesh: Optional[ProcessMesh]) -> np.ndarray:
    """This rank's rows of the global host batch (all of it without a
    mesh)."""
    if mesh is None:
        return host_batch
    return np.ascontiguousarray(host_batch[mesh.rows(len(host_batch))])


def host_local(tree):
    """Tensors of a nested dict, copied to the host; other leaves as
    they are."""
    if isinstance(tree, dict):
        return {k: host_local(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree
