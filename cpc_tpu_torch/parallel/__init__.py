"""The parallel modes of the PyTorch port over torch.distributed: the
process mesh (`mesh`), the process group's bring-up and host-side helpers
on one host or across hosts (`multihost`), data parallelism's gathered
candidate pool and averaged step (`dp`), context parallelism (`cp`) and
tensor parallelism (`tp`)."""

from cpc_tpu_torch.parallel.mesh import ProcessMesh  # noqa: F401
