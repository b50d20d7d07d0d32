"""Posterior analysis: image products, convergence statistics, model
criticism (PSIS-LOO, WAIC, LOO-PIT, prior power-scaling), simulation-based
calibration and plotting (the plots need matplotlib, imported only when
one is drawn)."""
from .images import default_filetypes, save_posterior_images, write_image_products
from .model_comparison import (
    ELPDResult,
    LOOPITResult,
    compare,
    loo_pit,
    pointwise_loglike,
    psis_loo,
    waic,
)
from .sbc import SBCResult, run_sbc, sbc_ranks_from_chains
from .sensitivity import (
    SensitivityResult,
    cjs_distance,
    power_scale_sensitivity,
)
from .statistics import (
    check_convergence_autocorr,
    check_convergence_psrf,
    convergence_summary,
    ess_bulk,
    ess_tail,
    num_effective_samples,
    potential_scale_reduction,
    rhat_rank,
    summary,
    to_inference_dict,
)

__all__ = [
    "ELPDResult",
    "LOOPITResult",
    "SBCResult",
    "SensitivityResult",
    "check_convergence_autocorr",
    "check_convergence_psrf",
    "cjs_distance",
    "compare",
    "convergence_summary",
    "default_filetypes",
    "ess_bulk",
    "ess_tail",
    "loo_pit",
    "num_effective_samples",
    "pointwise_loglike",
    "potential_scale_reduction",
    "power_scale_sensitivity",
    "psis_loo",
    "rhat_rank",
    "run_sbc",
    "save_posterior_images",
    "sbc_ranks_from_chains",
    "summary",
    "to_inference_dict",
    "waic",
    "write_image_products",
]

try:  # matplotlib is optional at import time
    from .plotting import (
        corner_plot,
        plot_autocorr,
        plot_criticism,
        plot_hist,
        plot_profile,
        plot_trace,
        radial_profile,
    )

    __all__ += [
        "corner_plot",
        "plot_autocorr",
        "plot_criticism",
        "plot_hist",
        "plot_profile",
        "plot_trace",
        "radial_profile",
    ]
except ImportError:  # pragma: no cover
    pass
