"""Model layer: components, static spec and the batched posterior."""
from .components import (
    ComponentBase,
    Configuration,
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
    spec_from_numpy,
)

__all__ = [
    "ComponentBase",
    "Configuration",
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
    "spec_from_numpy",
]
