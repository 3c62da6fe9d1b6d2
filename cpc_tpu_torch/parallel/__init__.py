"""Data parallelism of the PyTorch port over torch.distributed: the process
mesh (`mesh`), the process group's bring-up and host-side helpers
(`multihost`), and the gathered candidate pool and averaged step (`dp`)."""

from cpc_tpu_torch.parallel.mesh import ProcessMesh  # noqa: F401
