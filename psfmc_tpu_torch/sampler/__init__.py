"""Samplers of the port: the ensemble sampler (stretch, DE and mixed
moves), its parallel-tempered counterpart with the evidence estimators,
annealed importance sampling, and the No-U-Turn sampler."""
from .ais import AISResult, ais_beta_schedule, ais_evidence
from .autocorr import AutocorrError, function, integrated_time
from .ensemble import (
    MOVES,
    EnsembleSampler,
    EnsembleState,
    de_update,
    fresh_image_accumulators,
    merge_image_accumulators,
    mixed_update,
    run_stretch_move,
    stretch_update,
    welford_batch_update,
)
from .nuts import NUTSSampler, nuts_kernel
from .tempered import (
    PTEnsembleSampler,
    default_beta_ladder,
    evidence_beta_ladder,
)

__all__ = [
    "AutocorrError",
    "function",
    "integrated_time",
    "MOVES",
    "EnsembleSampler",
    "EnsembleState",
    "PTEnsembleSampler",
    "NUTSSampler",
    "nuts_kernel",
    "run_stretch_move",
    "default_beta_ladder",
    "evidence_beta_ladder",
    "AISResult",
    "ais_beta_schedule",
    "ais_evidence",
    "de_update",
    "fresh_image_accumulators",
    "merge_image_accumulators",
    "mixed_update",
    "stretch_update",
    "welford_batch_update",
]
