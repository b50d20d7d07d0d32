"""Samplers of the port (stretch-move ensemble in this slice)."""
from .autocorr import AutocorrError, integrated_time
from .ensemble import (
    EnsembleSampler,
    EnsembleState,
    merge_image_accumulators,
    stretch_update,
    welford_batch_update,
)

__all__ = [
    "AutocorrError",
    "integrated_time",
    "EnsembleSampler",
    "EnsembleState",
    "merge_image_accumulators",
    "stretch_update",
    "welford_batch_update",
]
