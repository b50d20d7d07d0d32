"""MCMC trace database: FITS binary table + sampler checkpoint (port of ``database.py``).

The TRACE table is the JAX package's, column for column and card for
card, so either package reads a database the other wrote: one column per
stochastic (``xy`` two wide), then ``lnprobability``, ``walker`` and
``sample``; the sampler's metadata (``MCITER``, ``MCBURN``,
``MCCHAINS``, ``MCACCEPT``, ``MCDATSUM``, ...) and the MAP indices
(``MAPWLKR``, ``MAPSAMP``) ride in the table's header.

The CHECKPOINT extension holds the resume state as in the JAX package
(positions, lnp, accept counts per walker, for a tempered sampler of
every rung with the ladder, swap counts and evidence accumulators;
CKPTVERS, CKPTSMPL, CKPTTEMP, CKPTACCN, CKPTSTEP and CKPTEVID cards; for
NUTS the CKPTACCS (accept-statistic numerator) and CKPTEPS (step size)
cards and a CKPTNUTS extension with the metric ``inv_mass``) and
CKPTIMGS the running image
means: one ``(H, W)`` column per image when every image has one shape,
and for a joint model's bands of several shapes one row of flattened
cells with a ``CKIMSH{i}`` card (``"H,W"``) per column, the JAX
package's two layouts.  The port's ``torch.Generator`` state rides a
CKPTRNG extension and the CKPTRNGK card names its kind (``torch-cuda`` /
``torch-cpu``); the ``prng_key`` column the JAX package's reader
requires holds two words hashed from that state (a JAX resume from it
draws a fresh stream).  :func:`load_checkpoint` reports a JAX
checkpoint's generator as ``rng_kind = 'jax'``, which the port's sampler
cannot restore.

In a multi-process run (:mod:`psfmc_tpu_torch.parallel`) every process
assembles the same table from its replicated sampler state, the primary
alone writes the file, and a barrier after the write keeps every process
from looking for the file before it exists.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np

from .io import fits
from .io.table import Table
from .parallel.multihost import barrier, is_primary
from .profiling import span

__all__ = [
    "save_database",
    "load_database",
    "load_checkpoint",
    "get_sampler_state",
    "row_to_param_vector",
    "annotate_metadata",
    "filter_lowp_walkers",
]

_HEADER_COMMENTS = {
    "MCITER": "number of retained samples",
    "MCBURN": "number of burn-in (discarded) samples",
    "MCCHAINS": "number of walkers run",
    "MCWALKRS": "number of walkers run",
    "MCCONVRG": "Has MCMC sampler converged?",
    "MCACCEPT": "Acceptance fraction (avg of all walkers)",
    "MCDATSUM": "crc32 of obs+ivm data (resume identity check)",
    "MCLNZ": "ln marginal likelihood (tempered-run estimate)",
    "MCLNZERR": "ln evidence error (estimator spread)",
    "MCPPCP": "posterior-predictive p-value (deviance)",
    "MAPLNP": "Log-posterior of the MAP fit",
    "MAPWLKR": "Walker index of maximum posterior model",
    "MAPSAMP": "Sample index of maximum posterior model",
    "PSFIMG": "PSF image of maximum posterior model",
}


def annotate_metadata(input_dict):
    """Attach FITS comments to metadata keys (unknown => model param)."""
    out = OrderedDict()
    for key, value in input_dict.items():
        if isinstance(value, tuple):
            out[key] = value
        else:
            out[key] = (value, _HEADER_COMMENTS.get(key, "psfMC model parameter"))
    return out


def _chain_columns(chain, param_names, param_lens):
    """Split a flat (nsamples, dim) chain into named columns."""
    split_inds = np.cumsum(param_lens)[:-1]
    cols = np.split(chain, split_inds, axis=1)
    out = OrderedDict()
    for name, col in zip(param_names, cols):
        out[name] = col[:, 0] if col.shape[1] == 1 else col
    return out


def save_database(sampler, model, db_name, meta_dict=None):
    """Write the trace database + checkpoint extensions; returns the
    table as :func:`load_database` reads it.

    A sampler with no recorded chain yet (mid-burn checkpoint) writes a
    zero-row trace table whose CHECKPOINT extension still enables resume.
    In a multi-process run only the primary process writes; the others
    return the same table from memory (its cards' values without their
    comments, as a read gives them), after the primary's write.
    """
    with span("psfmc.checkpoint.table"):
        tbl = _trace_table(sampler, model, meta_dict)

    extra_hdus = []
    if sampler.state is not None:
        with span("psfmc.checkpoint.payload"):
            payload = sampler.checkpoint_payload()
            payload["sampler_kind"] = sampler.checkpoint_kind
            extra_hdus = _checkpoint_hdus(payload)
    if not is_primary():
        tbl.meta = OrderedDict((k, v[0] if isinstance(v, tuple) else v)
                               for k, v in tbl.meta.items())
        barrier("save_database")  # pairs with the primary's, after its write
        return tbl
    with span("psfmc.checkpoint.write"):
        tbl.write(db_name, format="fits", extname="TRACE", extra_hdus=extra_hdus)
        barrier("save_database")  # the file exists before any process goes on
    with span("psfmc.checkpoint.reload"):
        return load_database(db_name)


def _trace_table(sampler, model, meta_dict):
    """The trace table: one row a walker and recorded step, its cards."""
    if sampler.chain is None:
        chain = np.zeros((sampler.nwalkers, 0, sum(model.param_lens)))
        lnprobability = np.zeros(chain.shape[:2])
    else:
        chain = np.asarray(sampler.chain, dtype=np.float64)
        lnprobability = np.asarray(sampler.lnprobability, dtype=np.float64)
    nwalkers, niter, dim = chain.shape

    columns = _chain_columns(chain.reshape(nwalkers * niter, dim),
                             model.param_names, model.param_lens)
    walker_col = np.repeat(np.arange(nwalkers, dtype=np.int64), niter)
    sample_col = np.tile(np.arange(niter, dtype=np.int64), nwalkers)
    columns["lnprobability"] = lnprobability.reshape(-1)
    columns["walker"] = walker_col
    columns["sample"] = sample_col

    meta = OrderedDict(meta_dict or {})
    if niter > 0:
        map_row = int(np.argmax(columns["lnprobability"]))
        meta["MAPWLKR"] = int(walker_col[map_row])
        meta["MAPSAMP"] = int(sample_col[map_row])
    return Table(columns, meta=annotate_metadata(meta))


def _rng_key_words(rng_state):
    """Two 32-bit words hashed from a generator's state: the ``prng_key``
    column of a checkpoint the port writes."""
    digest = hashlib.blake2b(np.asarray(rng_state, np.uint8).tobytes(),
                             digest_size=8).digest()
    return np.frombuffer(digest, np.uint32).astype(np.int64)


def _image_hdu(accum):
    """CKPTIMGS: one (H, W) column per image when all have one shape, else
    one row of flattened cells with a ``CKIMSH{i}`` shape card each."""
    shapes = {name: np.asarray(img).shape for name, img in accum.items()}
    if len(set(shapes.values())) == 1:
        img_cols = OrderedDict((k, np.asarray(v, np.float64)) for k, v in accum.items())
        return fits.make_bintable_hdu(list(img_cols), img_cols, extname="CKPTIMGS")
    img_cols = OrderedDict((k, np.asarray(v, np.float64).ravel()[None, :])
                           for k, v in accum.items())
    meta = [(f"CKIMSH{i}", ("%d,%d" % shapes[name], f"shape of column {i}"))
            for i, name in enumerate(img_cols)]
    return fits.make_bintable_hdu(list(img_cols), img_cols, meta=meta,
                                  extname="CKPTIMGS")


def _checkpoint_hdus(payload):
    """CHECKPOINT (per-walker state), CKPTIMGS (image accumulators,
    :func:`_image_hdu`) and CKPTRNG (the generator's state) HDUs.

    A tempered payload's rows hold every rung, row-major ``(ntemps *
    nwalkers)``, the cold rung's lnp padded with zeros, a per-row
    ``beta``, the swap counts in a ``nswap`` column padded with -1, and
    the evidence accumulators in padded ``evid_*`` columns with the
    CKPTEVID card, as the JAX package writes them."""
    ntemps = int(payload.get("ntemps", 1))
    pos = np.asarray(payload["positions"], dtype=np.float64)
    pos = pos.reshape(-1, pos.shape[-1])
    nrows = pos.shape[0]
    key = _rng_key_words(payload["rng_state"])

    def padded(values, fill=0.0):
        out = np.full(nrows, fill, np.float64)
        v = np.ravel(np.asarray(values, np.float64))
        out[:len(v)] = v
        return out

    cols = OrderedDict([
        ("position", pos),
        ("log_prob", padded(payload["log_prob"])),
        ("naccept", np.asarray(payload["naccept"], np.int64).reshape(-1)),
        ("prng_key", np.tile(key[None, :], (nrows, 1))),
    ])
    meta = [
        ("CKPTVERS", (2, "checkpoint format version")),
        ("CKPTSMPL", (str(payload.get("sampler_kind", "ensemble")),
                      "sampler family that wrote this checkpoint")),
        ("CKPTTEMP", (ntemps, "parallel-tempering rungs in checkpoint")),
        ("CKPTACCN", (int(payload.get("accum_count", 0)),
                      "samples in image accumulators")),
        ("CKPTSTEP", (int(payload.get("nsteps", 0)),
                      "steps since last sampler reset")),
        ("CKPTRNGK", (str(payload["rng_kind"]),
                      "generator kind of the CKPTRNG state")),
    ]
    if payload.get("nswap") is not None:
        cols["nswap"] = padded(payload["nswap"], fill=-1.0)
    if payload.get("betas") is not None and ntemps > 1:
        cols["beta"] = np.repeat(np.asarray(payload["betas"], np.float64),
                                 nrows // ntemps)
    if payload.get("lnl_sum") is not None:
        for name in ("lnl_sum", "lnl_sq_sum", "ss_max", "ss_sum"):
            cols[f"evid_{name}"] = padded(payload[name])
        meta.append(("CKPTEVID", (int(payload.get("evid_steps", 0)),
                                  "retained steps in evidence accumulators")))
    if payload.get("sum_accept") is not None:
        meta.append(("CKPTACCS", (float(payload["sum_accept"]),
                                  "acceptance-statistic numerator")))
    if payload.get("nuts_eps") is not None:
        meta.append(("CKPTEPS", (float(payload["nuts_eps"]),
                                 "NUTS warmup-adapted step size")))
    hdr, raw = fits.make_bintable_hdu(list(cols), cols, meta=meta,
                                      extname="CHECKPOINT")
    hdus = [(hdr, raw)]
    accum = payload.get("accum")
    if accum and int(payload.get("accum_count", 0)) > 0:
        hdus.append(_image_hdu(accum))
    inv_mass = payload.get("nuts_inv_mass")
    if inv_mass is not None:
        # NUTS's diagonal metric: its length (the unconstrained dimension)
        # is not the walker-row count, so it gets its own extension
        hdus.append(fits.make_bintable_hdu(
            ["inv_mass"], {"inv_mass": np.asarray(inv_mass, np.float64)},
            extname="CKPTNUTS"))
    state = np.asarray(payload["rng_state"], np.uint8)[None, :]
    hdus.append(fits.make_bintable_hdu(["rng_state"], {"rng_state": state},
                                       extname="CKPTRNG"))
    return hdus


def load_database(db_name):
    """Load the TRACE table from a database file."""
    return Table.read(db_name, format="fits", extname="TRACE")


def load_checkpoint(db_name):
    """Resume state as a payload dict (see ``EnsembleSampler.
    checkpoint_payload``), or None without a CHECKPOINT extension.

    Reads the JAX package's checkpoints too: their generator is reported
    as ``rng_kind = 'jax'`` (no ``rng_state``).  A tempered checkpoint
    (``ntemps > 1``) reads as the JAX loader reads it: positions
    ``(ntemps, nwalkers, dim)``, accept counts ``(ntemps, nwalkers)``, the
    cold rung's lnp, ``nswap``, ``betas`` and the evidence accumulators
    (``lnl_sum``, ``lnl_sq_sum``, ``ss_max``, ``ss_sum``, ``evid_steps``).
    A NUTS checkpoint adds ``sum_accept``, ``nuts_eps`` and
    ``nuts_inv_mass``.
    """
    try:
        ckpt = Table.read(db_name, format="fits", extname="CHECKPOINT")
    except IOError:
        return None
    payload = {
        "version": int(ckpt.meta.get("CKPTVERS", 1)),
        "ntemps": int(ckpt.meta.get("CKPTTEMP", 1)),
        "positions": np.asarray(ckpt["position"], dtype=np.float64),
        "log_prob": np.asarray(ckpt["log_prob"], dtype=np.float64),
        "naccept": np.asarray(ckpt["naccept"], dtype=np.int64),
        "accum": None,
        "accum_count": int(ckpt.meta.get("CKPTACCN", 0)),
        "nsteps": int(ckpt.meta.get("CKPTSTEP", 0)),
        "sampler_kind": str(ckpt.meta.get(
            "CKPTSMPL",
            "nuts" if ckpt.meta.get("CKPTEPS") is not None else "ensemble")),
        "rng_kind": str(ckpt.meta.get("CKPTRNGK", "jax")),
        "rng_state": None,
    }
    ntemps = payload["ntemps"]
    if ntemps > 1:
        payload["positions"] = payload["positions"].reshape(
            ntemps, -1, payload["positions"].shape[-1])
        payload["naccept"] = payload["naccept"].reshape(ntemps, -1)
        payload["log_prob"] = payload["log_prob"].reshape(ntemps, -1)[0]
        if "nswap" in ckpt.colnames:
            payload["nswap"] = np.asarray(
                ckpt["nswap"], np.float64)[:ntemps - 1].astype(np.int64)
        if "evid_lnl_sum" in ckpt.colnames:
            for name, n in (("lnl_sum", ntemps), ("lnl_sq_sum", ntemps),
                            ("ss_max", ntemps - 1), ("ss_sum", ntemps - 1)):
                payload[name] = np.asarray(ckpt[f"evid_{name}"], np.float64)[:n]
            payload["evid_steps"] = int(ckpt.meta.get("CKPTEVID", 0))
        if "beta" in ckpt.colnames:
            payload["betas"] = np.asarray(ckpt["beta"], np.float64).reshape(
                ntemps, -1)[:, 0]
    if "CKPTRNGK" in ckpt.meta:
        rng = Table.read(db_name, format="fits", extname="CKPTRNG")
        payload["rng_state"] = np.asarray(rng["rng_state"][0]).astype(np.uint8)
    if payload["accum_count"] > 0:
        try:
            imgs = Table.read(db_name, format="fits", extname="CKPTIMGS")
        except IOError:
            payload["accum_count"] = 0
        else:
            payload["accum"] = {}
            for i, name in enumerate(imgs.colnames):
                col = np.asarray(imgs[name], np.float64)
                shape = imgs.meta.get(f"CKIMSH{i}")
                if shape is not None:  # the mixed-shape layout
                    col = col.reshape(tuple(int(v) for v in str(shape).split(",")))
                payload["accum"][name] = col
    accs = ckpt.meta.get("CKPTACCS")
    if accs is not None:
        payload["sum_accept"] = float(accs)
    eps = ckpt.meta.get("CKPTEPS")
    if eps is not None:
        payload["nuts_eps"] = float(eps)
        try:
            metric = Table.read(db_name, format="fits", extname="CKPTNUTS")
        except IOError:
            pass
        else:
            payload["nuts_inv_mass"] = np.asarray(metric["inv_mass"], np.float64)
    return payload


def get_sampler_state(database):
    """``(positions (nwalkers, num_params), lnprob (nwalkers,))`` of the last
    retained sample of every walker, from the trace table (the JAX
    package's bug-fixed reading of the reference's).  The CHECKPOINT
    extension (:func:`load_checkpoint`) holds the resume state itself."""
    stochastic_cols = [c for c in database.colnames
                       if c not in ("walker", "sample", "lnprobability")]
    nwalkers = int(database["walker"].max()) + 1
    niter = len(database) // nwalkers
    last_rows = np.arange(nwalkers) * niter + (niter - 1)
    flat = np.concatenate(
        [np.asarray(database[c], dtype=np.float64).reshape(len(database), -1)
         for c in stochastic_cols], axis=1)
    ln_prob = np.asarray(database["lnprobability"], dtype=np.float64)[last_rows]
    return flat[last_rows], ln_prob


def row_to_param_vector(table_row):
    """Concatenate a table row (tuple of per-column values) to a vector."""
    return np.concatenate(
        [np.atleast_1d(np.asarray(v, dtype=np.float64)) for v in table_row]
    )


def filter_lowp_walkers(database, percentile=10):
    """Drop walkers whose every sample is below the lnp percentile
    (reference database.py:112-126)."""
    pct_value = np.percentile(database["lnprobability"], percentile)
    ok_walkers = np.unique(
        database["walker"][database["lnprobability"] > pct_value]
    )
    return database[np.isin(database["walker"], ok_walkers)]
