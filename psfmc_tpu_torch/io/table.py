"""Minimal column-oriented table (astropy.table.Table stand-in).

The reference stores the MCMC trace database as an astropy Table
serialized to a FITS binary table (reference database.py:6-56).  This
class provides the subset of that interface the pipeline and analysis
layers use: named column access, boolean-mask row filtering, column
subsetting, row iteration, ``meta`` header dict, and FITS round-trip via
:mod:`psfmc_tpu_torch.io.fits` (a copy of the JAX package's codec).
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from . import fits

__all__ = ["Table"]


class Table:
    def __init__(self, columns=None, names=None, meta=None):
        """``columns``: list of arrays (paired with ``names``) or dict."""
        self.meta = OrderedDict(meta or {})
        self._cols = OrderedDict()
        if columns is None:
            return
        if isinstance(columns, dict):
            for name, col in columns.items():
                self._cols[name] = np.asarray(col)
        else:
            if names is None:
                raise ValueError("names required when columns is a list")
            for name, col in zip(names, columns):
                self._cols[name] = np.asarray(col)
        self._check_lengths()

    def _check_lengths(self):
        lens = {len(c) for c in self._cols.values()}
        if len(lens) > 1:
            raise ValueError(f"Column length mismatch: {lens}")

    # -- basic interface ----------------------------------------------
    @property
    def colnames(self):
        return list(self._cols.keys())

    def __len__(self):
        if not self._cols:
            return 0
        return len(next(iter(self._cols.values())))

    def __contains__(self, name):
        return name in self._cols

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._cols[key]
        if isinstance(key, (list, tuple)) and key and isinstance(key[0], str):
            sub = Table(meta=self.meta)
            for name in key:
                sub._cols[name] = self._cols[name]
            return sub
        # row selection: boolean mask, index array, slice, or scalar index
        if isinstance(key, (int, np.integer)):
            return tuple(col[key] for col in self._cols.values())
        sub = Table(meta=self.meta)
        for name, col in self._cols.items():
            sub._cols[name] = col[key]
        return sub

    def __setitem__(self, key, value):
        self._cols[key] = np.asarray(value)
        self._check_lengths()

    def __iter__(self):
        """Iterate over rows as tuples of per-column values."""
        for i in range(len(self)):
            yield tuple(col[i] for col in self._cols.values())

    def as_array(self):
        return np.column_stack(
            [c.reshape(len(self), -1) for c in self._cols.values()]
        )

    def copy(self):
        out = Table(meta=self.meta)
        for name, col in self._cols.items():
            out._cols[name] = col.copy()
        return out

    def __repr__(self):
        return (
            f"<Table rows={len(self)} cols={self.colnames} "
            f"meta_keys={list(self.meta.keys())}>"
        )

    # -- FITS round-trip ------------------------------------------------
    def write(self, path, format="fits", overwrite=True, extname="TRACE",
              extra_hdus=()):
        if format != "fits":
            raise ValueError("Only fits format is supported")
        meta_cards = []
        for key, value in self.meta.items():
            meta_cards.append((key, value))
        tbl_header, raw = fits.make_bintable_hdu(
            self.colnames, self._cols, meta=meta_cards, extname=extname
        )
        primary = fits.Header()
        hdus = [(primary, None), (tbl_header, raw)]
        hdus.extend(extra_hdus)
        fits.write_hdus(path, hdus)

    @classmethod
    def read(cls, path, format="fits", extname=None):
        if format != "fits":
            raise ValueError("Only fits format is supported")
        hdus = fits.read_hdus(path)
        structural = {"BITPIX", "NAXIS", "NAXIS1", "NAXIS2", "PCOUNT",
                      "GCOUNT", "TFIELDS", "XTENSION", "EXTNAME", "SIMPLE"}
        for header, data in hdus:
            if str(header.get("XTENSION", "")).strip() != "BINTABLE":
                continue
            if extname is not None and header.get("EXTNAME") != extname:
                continue
            names, columns = fits.read_bintable(header, data)
            meta = OrderedDict()
            for key, value, comment in header.cards():
                if key in structural or key.startswith(("TTYPE", "TFORM")):
                    continue
                if key in ("COMMENT", "HISTORY", ""):
                    continue
                meta[key] = value
            tbl = cls(meta=meta)
            for name in names:
                tbl._cols[name] = columns[name]
            return tbl
        raise IOError(f"No BINTABLE HDU found in {path}")
