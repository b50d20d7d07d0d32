"""Native corner (pairwise posterior) plot (port of ``analysis/corner.py``).

A stand-in for the ``corner`` package, in bare matplotlib: a lower
triangle of 2-D histograms with contours and marginal histograms on the
diagonal, honoring the subset of ``corner.corner``'s keywords the
pipeline uses (labels, range quantiles, max_n_ticks, label_kwargs).
matplotlib is imported when a plot is drawn.
"""
from __future__ import annotations

import numpy as np

__all__ = ["corner"]

_range = range  # the kwarg below shadows the builtin (corner.corner API)


def _quantile_range(x, q):
    """Central quantile range [ (1-q)/2, 1-(1-q)/2 ]."""
    lo, hi = np.percentile(x, [50 * (1 - q), 100 - 50 * (1 - q)])
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    return lo, hi


def corner(
    data,
    labels=None,
    bins=20,
    range=None,  # noqa: A002 - matching corner.corner's kwarg name
    max_n_ticks=3,
    label_kwargs=None,
    fig=None,
    color="black",
    **_ignored,
):
    """Corner plot of ``data`` (nsamples, ndim); returns the figure."""
    import matplotlib.pyplot as plt
    from matplotlib.ticker import MaxNLocator

    data = np.asarray(data, dtype=np.float64)
    if data.ndim != 2:
        raise ValueError("corner expects (nsamples, ndim) data")
    ndim = data.shape[1]
    labels = labels if labels is not None else [f"p{i}" for i in _range(ndim)]
    label_kwargs = label_kwargs or {}

    ranges = []
    for i in _range(ndim):
        if range is not None and i < len(range):
            r = range[i]
            if np.isscalar(r):
                ranges.append(_quantile_range(data[:, i], float(r)))
            else:
                ranges.append(tuple(r))
        else:
            ranges.append(_quantile_range(data[:, i], 0.99))

    if fig is None:
        size = max(2.0 * ndim, 5.0)
        fig, axes = plt.subplots(
            ndim, ndim, figsize=(size, size), squeeze=False
        )
    else:
        axes = np.asarray(fig.axes).reshape(ndim, ndim)

    for row in _range(ndim):
        for col in _range(ndim):
            ax = axes[row][col]
            if col > row:
                ax.set_visible(False)
                continue
            if col == row:
                ax.hist(
                    data[:, col],
                    bins=bins,
                    range=ranges[col],
                    histtype="step",
                    color=color,
                )
                ax.set_yticks([])
            else:
                h, xe, ye = np.histogram2d(
                    data[:, col],
                    data[:, row],
                    bins=bins,
                    range=[ranges[col], ranges[row]],
                )
                xc = 0.5 * (xe[:-1] + xe[1:])
                yc = 0.5 * (ye[:-1] + ye[1:])
                ax.contourf(
                    xc, yc, h.T, levels=6, cmap="Greys"
                )
                ax.contour(
                    xc, yc, h.T, levels=4, colors=color, linewidths=0.6
                )
                ax.set_ylim(ranges[row])
            ax.set_xlim(ranges[col])
            ax.xaxis.set_major_locator(MaxNLocator(max_n_ticks))
            ax.yaxis.set_major_locator(MaxNLocator(max_n_ticks))
            if row == ndim - 1:
                ax.set_xlabel(labels[col], **label_kwargs)
                ax.tick_params(axis="x", labelrotation=45)
            else:
                ax.set_xticklabels([])
            if col == 0 and row > 0:
                ax.set_ylabel(labels[row], **label_kwargs)
            else:
                ax.set_yticklabels([])

    fig.subplots_adjust(hspace=0.08, wspace=0.08)
    return fig
