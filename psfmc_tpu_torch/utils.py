"""Console helpers of the fitting driver (port of ``utils.print_progress``)."""
from __future__ import annotations

__all__ = ["print_progress"]


def print_progress(sample, max_samples, stage="Burning"):
    """Percent progress printer (reference utils.py:167-171)."""
    next_pct = 100 * (sample + 1) // max_samples
    curr_pct = 100 * sample // max_samples
    if next_pct - curr_pct > 0:
        print(f"{stage}: {next_pct:d}%")
