"""Multi-device scaling: device meshes and data-parallel alignment (the
port's counterpart of ``versalignlib_tpu/parallel``).

The reference is single-node shared memory (OpenMP threads,
DefaultKernel.cpp:45-48); this package is the distributed layer: pair
batches shard data-parallel over a :class:`~.mesh.Mesh` of devices in one
process, and over processes through ``torch.distributed``
(:mod:`.multihost`). Each shard runs the port's kernels on its own device;
the trailing gather of results is the only communication.
"""

from versalignlib_tpu_torch.parallel import multihost
from versalignlib_tpu_torch.parallel.distributed import (distributed_align_batch,
                                                         distributed_score_batch)
from versalignlib_tpu_torch.parallel.mesh import make_mesh

__all__ = [
    "make_mesh",
    "distributed_score_batch",
    "distributed_align_batch",
    "multihost",
]
