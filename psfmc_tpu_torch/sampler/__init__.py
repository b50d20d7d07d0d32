"""Samplers of the port (stretch-move ensemble in this slice)."""
from .ensemble import (
    EnsembleSampler,
    EnsembleState,
    merge_image_accumulators,
    stretch_update,
    welford_batch_update,
)

__all__ = [
    "EnsembleSampler",
    "EnsembleState",
    "merge_image_accumulators",
    "stretch_update",
    "welford_batch_update",
]
