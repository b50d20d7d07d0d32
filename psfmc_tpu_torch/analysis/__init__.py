"""Analysis for the fitting driver: posterior image products and the convergence check."""
from .images import default_filetypes, save_posterior_images, write_image_products
from .statistics import check_convergence_autocorr

__all__ = [
    "check_convergence_autocorr",
    "default_filetypes",
    "save_posterior_images",
    "write_image_products",
]
