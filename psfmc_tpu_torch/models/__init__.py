"""Model layer: components, static spec and the batched posterior."""
from .components import (
    ComponentBase,
    Configuration,
    NoiseScale,
    PointSource,
    PSFSelector,
    Sersic,
    Sky,
)
from .multicomponent import MultiComponentModel, as_model
from .posterior import PosteriorFns, build_posterior
from .spec import (
    CompSpec,
    ModelSpec,
    ParamSlot,
    build_model_spec,
    check_in_slice,
    psf_spectra_for,
    spec_from_numpy,
)

__all__ = [
    "ComponentBase",
    "Configuration",
    "NoiseScale",
    "PointSource",
    "PSFSelector",
    "Sersic",
    "Sky",
    "MultiComponentModel",
    "as_model",
    "PosteriorFns",
    "build_posterior",
    "CompSpec",
    "ModelSpec",
    "ParamSlot",
    "build_model_spec",
    "check_in_slice",
    "psf_spectra_for",
    "spec_from_numpy",
]
