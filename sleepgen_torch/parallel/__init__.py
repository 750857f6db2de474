"""Data parallelism over ``torch.distributed`` (``mesh.py``)."""
from sleepgen_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    batch_sharding,
    initialize_distributed,
    make_mesh,
    pad_to_multiple,
    prefetch_to_device,
    replicate,
    replicated,
    shard_batch,
    split_seeds,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "batch_sharding",
    "initialize_distributed",
    "make_mesh",
    "pad_to_multiple",
    "prefetch_to_device",
    "replicate",
    "replicated",
    "shard_batch",
    "split_seeds",
]
