"""Analysis for the fitting driver: posterior image products and the convergence statistics."""
from .images import default_filetypes, save_posterior_images, write_image_products
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
    "check_convergence_autocorr",
    "check_convergence_psrf",
    "convergence_summary",
    "default_filetypes",
    "ess_bulk",
    "ess_tail",
    "num_effective_samples",
    "potential_scale_reduction",
    "rhat_rank",
    "save_posterior_images",
    "summary",
    "to_inference_dict",
    "write_image_products",
]
