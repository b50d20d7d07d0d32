"""Samplers of the port (the ensemble sampler: stretch, DE and mixed moves)."""
from .autocorr import AutocorrError, integrated_time
from .ensemble import (
    MOVES,
    EnsembleSampler,
    EnsembleState,
    de_update,
    fresh_image_accumulators,
    merge_image_accumulators,
    mixed_update,
    stretch_update,
    welford_batch_update,
)

__all__ = [
    "AutocorrError",
    "integrated_time",
    "MOVES",
    "EnsembleSampler",
    "EnsembleState",
    "de_update",
    "fresh_image_accumulators",
    "merge_image_accumulators",
    "mixed_update",
    "stretch_update",
    "welford_batch_update",
]
