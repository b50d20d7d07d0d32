"""Unconstraining reparameterization of the parameter vector (port of ``models/transforms.py``).

The gradient path (:mod:`psfmc_tpu_torch.optimize`) ascends the
posterior in an unconstrained space: the priors have hard supports
(Uniform intervals, Weibull lower bounds, ...) and the radial families
carry the joint constraint ``semi-major >= semi-minor``.  A
:class:`UnconstrainingTransform` compiles a spec into a smooth bijection
``z in R^m <-> theta_continuous`` with a log-Jacobian:

* interval support ``(a, b)``        -> ``x = a + (b - a) sigmoid(z)``
* lower-bounded ``(a, inf)``         -> ``x = a + softplus(z)``
* upper-bounded ``(-inf, b)``        -> ``x = b - softplus(z)``
* unbounded                          -> identity
* a minor axis (``reff_b``, ``fwhm_b``, ``rc_b``, ``rout_b``, ``rb_b``)
  gets the DEPENDENT upper bound ``min(b, major)``, composed with its own
  prior's support kind; a constant major axis is folded in statically;
* discrete slots (the PSF index) are excluded from ``z``.

The sigmoid is ``torch.sigmoid`` and the softplus ``logaddexp(0, z)``:
the JAX package's CPU branch, which is also right on the card, whose
``expf`` and ``logf`` are within 2 ulp.  :meth:`to_constrained` works
on ``(B, m)`` tensors on the caller's device and dtype;
:meth:`to_unconstrained` is host float64 numpy (initialization only).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

__all__ = ["UnconstrainingTransform", "build_transform", "transform_token"]

_IDENTITY, _INTERVAL, _LOWER, _UPPER = 0, 1, 2, 3
# each radial family's (semi-major, semi-minor) attributes
_AXIS_PAIRS = {"sersic": ("reff", "reff_b"), "moffat": ("fwhm", "fwhm_b"),
               "king": ("rc", "rc_b"), "ferrer": ("rout", "rout_b"),
               "nuker": ("rb", "rb_b")}


def _softplus(z):
    return torch.logaddexp(torch.zeros_like(z), z)


def _log_sigmoid(z):
    return -torch.logaddexp(torch.zeros_like(z), -z)


def _softplus_inv(x):
    # log(expm1(x)), stable for large x
    x = np.asarray(x, np.float64)
    return x + np.log(-np.expm1(-x))


class UnconstrainingTransform:
    """Bijection between unconstrained ``z`` and the continuous part of theta.

    ``theta`` is the full flat vector (``spec.num_params``); ``z`` has one
    element per continuous slot element (``num_unconstrained``).
    Discrete offsets (``discrete_offsets``) are left at 0 by
    :meth:`to_constrained`; callers substitute or marginalize them.
    """

    def __init__(self, spec, dtype=torch.float32):
        self.spec = spec
        self.dtype = dtype
        kinds: List[int] = []
        lo: List[float] = []
        hi: List[float] = []
        offsets: List[int] = []
        discrete: List[int] = []
        z_index_of_offset: Dict[int, int] = {}
        for slot in spec.slots:
            if slot.dist.is_discrete:
                discrete.extend(slot.offset + j for j in range(slot.size))
                continue
            a, b = slot.dist.rv_frozen.support()
            a = np.broadcast_to(np.asarray(a, np.float64), (slot.size,))
            b = np.broadcast_to(np.asarray(b, np.float64), (slot.size,))
            for j in range(slot.size):
                aj, bj = float(a[j]), float(b[j])
                if np.isfinite(aj) and np.isfinite(bj):
                    kinds.append(_INTERVAL)
                elif np.isfinite(aj):
                    kinds.append(_LOWER)
                elif np.isfinite(bj):
                    kinds.append(_UPPER)
                else:
                    kinds.append(_IDENTITY)
                lo.append(aj if np.isfinite(aj) else 0.0)
                hi.append(bj if np.isfinite(bj) else 0.0)
                z_index_of_offset[slot.offset + j] = len(offsets)
                offsets.append(slot.offset + j)

        self.kinds = np.asarray(kinds, np.int32)
        self.lo = np.asarray(lo, np.float64)
        self.hi = np.asarray(hi, np.float64)
        self.offsets = np.asarray(offsets, np.int32)
        self.discrete_offsets = np.asarray(discrete, np.int32)
        self.num_unconstrained = len(offsets)

        # (zb, za, kind of zb's own prior): a minor axis bounded by a
        # sampled major axis; a constant major axis is folded in now
        self.reffb_pairs: List[Tuple[int, int, int]] = []
        for cs in spec.comp_specs:
            if cs.kind not in _AXIS_PAIRS:
                continue
            a_name, b_name = _AXIS_PAIRS[cs.kind]
            kind_b, payload_b = cs.params[b_name]
            if kind_b != "theta":
                continue
            zb = z_index_of_offset[payload_b[0]]
            kb = int(self.kinds[zb])
            kind_a, payload_a = cs.params[a_name]
            if kind_a == "theta":
                self.reffb_pairs.append((zb, z_index_of_offset[payload_a[0]], kb))
                continue
            a_val = float(payload_a)
            if kb in (_INTERVAL, _UPPER):
                self.hi[zb] = min(self.hi[zb], a_val)
            elif kb == _LOWER:
                self.kinds[zb] = _INTERVAL
                self.hi[zb] = a_val
            else:  # unbounded prior: now upper-bounded
                self.kinds[zb] = _UPPER
                self.hi[zb] = a_val
        self._pair_by_zb = {zb: (za, kb) for zb, za, kb in self.reffb_pairs}
        self._tensors = {}

    def cache_token(self):
        """Hashable signature of the bijection, for program caches."""
        return (
            tuple(int(k) for k in self.kinds),
            tuple(int(o) for o in self.offsets),
            self.lo.tobytes(),
            self.hi.tobytes(),
            tuple(self.reffb_pairs),
            tuple(int(o) for o in self.discrete_offsets),
        )

    def _consts(self, device, dtype):
        """(kinds, lo, hi, interval width, offsets) on ``device``, made once."""
        key = (str(device), dtype)
        out = self._tensors.get(key)
        if out is None:
            kinds = torch.as_tensor(self.kinds, device=device)
            lo = torch.as_tensor(self.lo, dtype=dtype, device=device)
            hi = torch.as_tensor(self.hi, dtype=dtype, device=device)
            # safe width: every branch is evaluated, and a log(0) in an
            # unselected one would still poison the gradient
            width = torch.where(kinds == _INTERVAL, hi - lo, torch.ones_like(lo))
            offsets = torch.as_tensor(self.offsets, dtype=torch.int64, device=device)
            out = self._tensors[key] = (kinds, lo, hi, width, offsets)
        return out

    # -- z -> theta ---------------------------------------------------------
    def to_constrained(self, z):
        """``(theta (B, num_params), log|J| (B,))`` of a ``(B, m)`` batch
        (or ``(dim,), ()`` of one ``(m,)`` vector); discrete slots are 0."""
        squeeze = z.ndim == 1
        z = torch.atleast_2d(z)
        kinds, lo, hi, width, offsets = self._consts(z.device, z.dtype)
        sig = torch.sigmoid(z)
        sp = _softplus(z)
        ls_pos, ls_neg = _log_sigmoid(z), _log_sigmoid(-z)
        is_int, is_low, is_up = (kinds == _INTERVAL, kinds == _LOWER,
                                 kinds == _UPPER)
        x = torch.where(is_int, lo + width * sig,
                        torch.where(is_low, lo + sp, torch.where(is_up, hi - sp, z)))
        ld = torch.where(is_int, torch.log(width) + ls_pos + ls_neg,
                         torch.where(is_low | is_up, ls_pos, torch.zeros_like(z)))
        if self.reffb_pairs:
            xs, lds = list(x.unbind(-1)), list(ld.unbind(-1))
            for zb, za, kb in self.reffb_pairs:
                major = xs[za]
                if kb in (_INTERVAL, _LOWER):
                    b_eff = torch.minimum(hi[zb], major) if kb == _INTERVAL else major
                    w = b_eff - lo[zb]
                    ok = w > 0
                    w_safe = torch.where(ok, w, torch.ones_like(w))
                    xs[zb] = lo[zb] + w_safe * sig[:, zb]
                    lds[zb] = torch.where(
                        ok, torch.log(w_safe) + ls_pos[:, zb] + ls_neg[:, zb],
                        torch.full_like(w, -float("inf")))
                else:
                    b_eff = torch.minimum(hi[zb], major) if kb == _UPPER else major
                    xs[zb] = b_eff - sp[:, zb]
                    lds[zb] = ls_pos[:, zb]
            x, ld = torch.stack(xs, -1), torch.stack(lds, -1)
        theta = x.new_zeros((x.shape[0], self.spec.num_params))
        theta = theta.index_copy(1, offsets, x)
        logdet = ld.sum(-1)
        return (theta[0], logdet[0]) if squeeze else (theta, logdet)

    # -- theta -> z (host-side; initialization only) --------------------------
    def to_unconstrained(self, theta):
        """Inverse map (numpy, float64); ``theta`` is ``(dim,)`` or ``(n, dim)``."""
        theta = np.asarray(theta, np.float64)
        squeeze = theta.ndim == 1
        theta = np.atleast_2d(theta)
        x = theta[:, self.offsets]
        z = np.array(x)  # identity default
        eps = 1e-9
        for i in range(self.num_unconstrained):
            pair = self._pair_by_zb.get(i)
            if pair is not None:
                za, kb = pair
                if kb in (_INTERVAL, _LOWER):
                    b = (np.minimum(self.hi[i], x[:, za]) if kb == _INTERVAL
                         else x[:, za])
                    p = np.clip((x[:, i] - self.lo[i]) / (b - self.lo[i]), eps, 1 - eps)
                    z[:, i] = np.log(p) - np.log1p(-p)
                else:
                    b = (np.minimum(self.hi[i], x[:, za]) if kb == _UPPER
                         else x[:, za])
                    z[:, i] = _softplus_inv(np.maximum(b - x[:, i], eps))
                continue
            k = self.kinds[i]
            if k == _INTERVAL:
                w = self.hi[i] - self.lo[i]
                p = np.clip((x[:, i] - self.lo[i]) / w, eps, 1 - eps)
                z[:, i] = np.log(p) - np.log1p(-p)
            elif k == _LOWER:
                z[:, i] = _softplus_inv(np.maximum(x[:, i] - self.lo[i], eps))
            elif k == _UPPER:
                z[:, i] = _softplus_inv(np.maximum(self.hi[i] - x[:, i], eps))
        return z[0] if squeeze else z


def build_transform(spec, dtype=torch.float32) -> UnconstrainingTransform:
    return UnconstrainingTransform(spec, dtype=dtype)


def transform_token(transform):
    """Cache token of any transform-like object: its own
    :meth:`~UnconstrainingTransform.cache_token`, else its identity."""
    fn = getattr(transform, "cache_token", None)
    return fn() if fn is not None else ("transform-id", id(transform))
