"""Data parallelism: training over ``torch.distributed`` and a device mesh
for multi-card inference (``parallel/mesh.py``), and the multi-card
enhancer (``parallel/inference.py``)."""

from fullsubnet_tpu_torch.parallel.mesh import (
    Mesh,
    local_shard_info,
    make_mesh,
    replicate,
    shard_batch,
)
