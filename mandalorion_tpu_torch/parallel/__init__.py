"""Multi-device and multi-process sharding on torch.distributed.

Counterpart of mandalorion_tpu/parallel/. The reference's axes are
device-mesh dimensions:

- ``reads``: data parallel over read batches (alignment, module A);
- ``loci``: independent genomic loci (modules D/F);

and every batched device dispatch shards over all of them. The merges
are collectives of the mesh's process group (NCCL on CUDA, gloo on the
CPU): module Q's count matrix is an all_reduce, every dispatch's results
an all_gather.
"""

from mandalorion_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh, pipeline_mesh, use_mesh)
from mandalorion_tpu_torch.parallel.dist import (  # noqa: F401
    mesh_count_matrix, sharded_batch_score, sharded_quant_merge)
