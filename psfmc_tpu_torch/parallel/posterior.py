"""A posterior whose batched calls are split over a walker mesh.

:func:`shard_posterior` wraps a posterior (a :class:`~psfmc_tpu_torch.
models.posterior.PosteriorFns`, a joint posterior or the hierarchical
bundle) so that each batched evaluation the samplers call runs this
rank's rows and gathers the rest (:func:`~psfmc_tpu_torch.parallel.mesh.
shard_rows`); everything else is the wrapped posterior's.  The
posterior-mean images are each rank's walkers' means and ``raw_m2``,
gathered and merged in rank order with the Chan formula
(:func:`~psfmc_tpu_torch.sampler.ensemble.merge_image_accumulators`), so
every rank holds the same bits.
"""
from __future__ import annotations

import torch

from .mesh import check_sharding, shard_rows

__all__ = ["ShardedPosterior", "shard_posterior", "merge_rank_means"]

# the batched calls of a posterior whose rows are independent
_ROW_METHODS = ("log_posterior_batch", "log_likelihood_batch", "log_prior_batch",
                "log_likelihood_prior_batch", "log_posterior_and_grad")


def merge_rank_means(pieces, counts):
    """One batch's mean images from every rank's ``(means, count)``, in
    rank order, by the samplers' Chan merge
    (:func:`~psfmc_tpu_torch.sampler.ensemble.merge_image_accumulators`)."""
    from ..sampler.ensemble import merge_image_accumulators

    out = pieces[0]
    n = torch.full((), counts[0], dtype=torch.int64,
                   device=next(iter(out.values())).device)
    for means, nb in zip(pieces[1:], counts[1:]):
        out, n = merge_image_accumulators(out, n, means, nb)
    return out


class ShardedPosterior:
    """``posterior`` with its batched row calls split over
    ``sharding``'s mesh (see the module doc); every other attribute is
    the wrapped posterior's."""

    def __init__(self, posterior, sharding):
        self.base = posterior
        self.sharding = check_sharding(sharding)
        for name in _ROW_METHODS:
            fn = getattr(posterior, name, None)
            if fn is not None:
                setattr(self, name, shard_rows(fn, sharding))
        means = getattr(posterior, "ensemble_carry_means", None)
        self.ensemble_carry_means = None if means is None else self._sharded_means(means)

    def __getattr__(self, name):  # only what the wrapper does not set itself
        return getattr(self.__dict__["base"], name)

    def _sharded_means(self, means_fn):
        mesh = self.sharding.mesh
        if mesh.group is None:
            return means_fn

        def sharded(thetas):
            n = thetas.shape[0]
            spans = mesh.split(n)
            lo, hi = spans[mesh.rank]
            local = means_fn(thetas[lo:hi])
            keys = list(local)
            shapes = [local[k].shape for k in keys]
            sizes = [local[k].numel() for k in keys]
            flat = mesh.gather_flat(torch.cat([local[k].reshape(-1) for k in keys]))
            pieces = []
            for row in flat:
                parts = row.split(sizes)
                pieces.append({k: p.reshape(s) for k, p, s in zip(keys, parts, shapes)})
            return merge_rank_means(pieces, [b - a for a, b in spans])

        return sharded


def shard_posterior(posterior, sharding):
    """``posterior`` split over ``sharding`` (:class:`ShardedPosterior`),
    or ``posterior`` itself when ``sharding`` is None."""
    if sharding is None or isinstance(posterior, ShardedPosterior):
        return posterior
    return ShardedPosterior(posterior, sharding)
