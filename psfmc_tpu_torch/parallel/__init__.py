"""Multi-device parallelism: the walker ensemble's evaluation split over
one process a device (``torch.distributed``), its state replicated."""
from .mesh import (
    WALKER_AXIS,
    WalkerMesh,
    WalkerSharding,
    pad_walkers_to_mesh,
    shard_walkers,
    walker_mesh,
    walker_sharding,
)
from .multihost import (
    barrier,
    fetch,
    initialize,
    is_primary,
    process_count,
    process_index,
    put_replicated,
    put_sharded,
)
from .posterior import shard_posterior

__all__ = [
    "WALKER_AXIS",
    "WalkerMesh",
    "WalkerSharding",
    "pad_walkers_to_mesh",
    "shard_walkers",
    "walker_mesh",
    "walker_sharding",
    "shard_posterior",
    "barrier",
    "fetch",
    "initialize",
    "is_primary",
    "process_count",
    "process_index",
    "put_replicated",
    "put_sharded",
]
