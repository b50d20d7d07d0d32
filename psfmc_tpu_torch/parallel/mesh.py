"""Walker-ensemble sharding over several devices (port of ``parallel/mesh.py``).

The JAX package shards the walker axis of one global array over a device
mesh and lets XLA insert the partner gather.  The port runs one process a
device (as ``torchrun`` starts them, :func:`~psfmc_tpu_torch.parallel.
multihost.initialize`) and keeps the design explicit: **replicated
state, sharded evaluation**.

* Every rank holds the whole sampler state (positions, lnprob, accept
  counts, the generator's state: 250 x 18 floats for the flagship) and
  the same seed, so every rank draws the same proposals.
* Only the posterior is sharded: rank ``r`` of ``W`` evaluates rows
  ``[floor(r n / W), floor((r + 1) n / W))`` of each batch
  (:meth:`WalkerMesh.rows`; 125 walkers over 2 ranks are 62 + 63), and
  one all-gather gives every rank the whole batch's values, the same bits
  the unsharded call gives (each walker's evaluation is independent of
  the others in the batch).  The accept decisions are therefore the same
  on every rank and in the unsharded run.  This is the port's form of
  the JAX module's "the only cross-device dependency is the partner
  gather".
* Uneven splits pad each rank's rows to ``ceil(n / W)`` before the
  gather and trim after it.
* The posterior-mean images: each rank takes the mean and ``raw_m2`` of
  its own walkers, the pairs are gathered, and every rank merges them in
  rank order with the Chan formula the samplers use.  No ``all_reduce``
  touches replicated state: a gather and an ordered merge keep the ranks
  bit-identical by construction.
* The target axis (the batch fit and the hierarchical fit's
  ``shard="targets"``): rows are target-major, so the split is made in
  whole targets (``blocks=K`` in :func:`shard_rows`), and each rank's
  likelihood holds only its own targets' planes and spectra.

CUDA graphs: under NCCL the all-gather is captured inside the step's
graph (the communicator exists before the first capture: the group's
:func:`~psfmc_tpu_torch.parallel.multihost.initialize` makes it, and the
capture's warm-up runs the collective once).  NCCL refuses two ranks on
one device, so that layout runs gloo, whose collectives go through host
copies and cannot be captured: steps are then eager.  The choice is made
from the group's backend when the mesh is made (:attr:`WalkerMesh.
graphed`, printed there), never after a failed capture; a capture that
fails raises.

``torch.distributed``'s ``DeviceMesh`` and DTensor are not used: a
DTensor's ``Shard(0)`` placement splits rows as ``torch.chunk`` does
(125 over 2 is 63 + 62, but 10 over 4 is 3 + 3 + 3 + 1), and the step
works on plain local tensors with explicit collectives anyway.  Without a
process group :func:`walker_mesh` is a mesh of one rank on one device,
and a fit given it is the unsharded fit.

Usage, one process a device::

    # torchrun --nproc_per_node=N fit.py
    from psfmc_tpu_torch.parallel import initialize, walker_mesh
    initialize()                       # NCCL, cuda:LOCAL_RANK
    db = model_galaxy_mcmc("model.py", mesh=walker_mesh())
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from .multihost import ShardedRows, _group_active, is_primary, process_count, \
    process_index, put_sharded

__all__ = [
    "WALKER_AXIS",
    "WalkerMesh",
    "WalkerSharding",
    "walker_mesh",
    "walker_sharding",
    "shard_walkers",
    "pad_walkers_to_mesh",
    "shard_rows",
    "check_mesh",
    "check_sharding",
    "steps_graphed",
]

WALKER_AXIS = "walkers"


def _gather_fn():
    return getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


class WalkerMesh:
    """A 1-D mesh of ``size`` processes, one device each: this process's
    ``device``, ``rank`` and the process ``group`` (None: one process, no
    collective), its ``backend`` (``"nccl"``, ``"gloo"`` or None)."""

    def __init__(self, device, group=None):
        self.device = torch.device(device)
        self.group = group
        self.size = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)
        self.backend = None if group is None else str(dist.get_backend(group))

    def __repr__(self):
        return (f"WalkerMesh(size={self.size}, rank={self.rank}, device={self.device}, "
                f"backend={self.backend})")

    @property
    def graphed(self) -> bool:
        """Whether steps on this mesh replay captured CUDA graphs: on CUDA
        with no group or NCCL (the collectives captured inside the step);
        under gloo the collectives go through the host and steps are
        eager."""
        return self.device.type == "cuda" and self.backend in (None, "nccl")

    def split(self, n, blocks=None):
        """Every rank's ``(lo, hi)`` rows of an ``n``-row batch, in rank
        order: ``floor(r n / W)`` to ``floor((r + 1) n / W)``, or in whole
        blocks of ``n // blocks`` rows when ``blocks`` is given."""
        w = self.size
        if blocks is None:
            return [(r * n // w, (r + 1) * n // w) for r in range(w)]
        if n % blocks:
            raise ValueError(f"{n} rows do not split into {blocks} blocks")
        unit = n // blocks
        return [(r * blocks // w * unit, (r + 1) * blocks // w * unit) for r in range(w)]

    def rows(self, n, blocks=None):
        """This rank's ``(lo, hi)`` of :meth:`split`."""
        return self.split(n, blocks)[self.rank]

    def _all_gather(self, x):
        """``(size * q, ...)``: every rank's ``(q, ...)`` tensor in rank
        order, on ``x``'s device.  NCCL gathers on the device; gloo through
        host copies."""
        out_shape = (self.size * x.shape[0],) + tuple(x.shape[1:])
        if self.backend == "nccl":
            out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
            _gather_fn()(out, x.contiguous(), group=self.group)
            return out
        host = torch.empty(out_shape, dtype=x.dtype)
        _gather_fn()(host, x.detach().to("cpu").contiguous(), group=self.group)
        return host.to(x.device)

    def gather_rows(self, local, n, blocks=None):
        """The whole ``n``-row batch from every rank's ``local`` rows of
        :meth:`split` (this rank's are ``local``): each rank's rows padded
        with zeros to the largest count, one all-gather, then trimmed.
        Without a group, ``local`` itself."""
        if self.group is None:
            return local
        spans = self.split(n, blocks)
        q = max(hi - lo for lo, hi in spans)
        if local.shape[0] < q:
            local = torch.cat([local, local.new_zeros((q - local.shape[0],)
                                                      + tuple(local.shape[1:]))])
        full = self._all_gather(local)
        return torch.cat([full[r * q: r * q + hi - lo] for r, (lo, hi) in enumerate(spans)])

    def gather_flat(self, flat):
        """``(size, m)``: every rank's 1-D ``flat`` (one length on every
        rank) in rank order; ``flat[None]`` without a group."""
        if self.group is None:
            return flat[None]
        return self._all_gather(flat[None])


class WalkerSharding:
    """The walker axis of a batch split over ``mesh`` (the port's
    ``NamedSharding(mesh, PartitionSpec('walkers'))``)."""

    def __init__(self, mesh: WalkerMesh):
        self.mesh = check_mesh(mesh)

    def rows(self, n, blocks=None):
        return self.mesh.rows(n, blocks)


def check_mesh(mesh):
    """``mesh`` if it is None or a :class:`WalkerMesh`; a ``TypeError``
    naming the expected type otherwise."""
    if mesh is not None and not isinstance(mesh, WalkerMesh):
        raise TypeError(f"mesh must be a psfmc_tpu_torch.parallel.WalkerMesh "
                        f"(from walker_mesh()), got {type(mesh).__name__}")
    return mesh


def check_sharding(sharding):
    """``sharding`` if it is None or a :class:`WalkerSharding`; a
    ``TypeError`` naming the expected type otherwise."""
    if sharding is not None and not isinstance(sharding, WalkerSharding):
        raise TypeError(f"sharding must be a psfmc_tpu_torch.parallel.WalkerSharding "
                        f"(from walker_sharding(mesh)), got {type(sharding).__name__}")
    return sharding


def steps_graphed(device, sharding=None, posterior=None):
    """Whether a sampler's steps on ``device`` replay captured CUDA graphs:
    on CUDA, where every mesh its evaluations gather over has graphed
    steps (:attr:`WalkerMesh.graphed`): its ``sharding``'s and the
    posterior's own ``mesh`` (the hierarchical fit's target axis)."""
    meshes = [sharding.mesh if sharding is not None else None,
              getattr(posterior, "mesh", None)]
    return torch.device(device).type == "cuda" and all(
        m.graphed for m in meshes if m is not None)


def walker_mesh(devices=None):
    """The 1-D walker mesh of every process of the default group (one
    rank, no collective, without a group).

    ``devices``: this process's device (``None``: ``cuda:LOCAL_RANK``
    under a group, else the current CUDA device; ``"cpu"`` for the plain
    path), or one device a process in rank order (this process takes its
    own).  Prints, on the primary, the mesh and whether its steps are
    graphed."""
    size = process_count()
    if devices is None or isinstance(devices, (str, int, torch.device)):
        device = resolve_device(devices)
    else:
        devices = list(devices)
        if len(devices) != size:
            raise ValueError(f"walker_mesh: {len(devices)} devices for {size} processes; "
                             "give one device a process, or this process's device")
        device = resolve_device(devices[process_index()])
    group = dist.group.WORLD if _group_active() else None
    if device.type == "cuda" and group is not None:
        torch.cuda.set_device(device)
    mesh = WalkerMesh(device, group)
    if is_primary():
        print(f"[psfmc] walker mesh: {mesh.size} process(es), backend "
              f"{mesh.backend or 'none'}, {device.type}: steps "
              f"{'graphed' if mesh.graphed else 'eager'}")
    return mesh


def walker_sharding(mesh: WalkerMesh) -> WalkerSharding:
    """The sharding that splits the leading (walker) axis over the mesh."""
    return WalkerSharding(mesh)


def shard_walkers(arr, mesh: WalkerMesh) -> ShardedRows:
    """This rank's rows of a host array with a leading walker axis
    (:func:`~psfmc_tpu_torch.parallel.multihost.put_sharded`)."""
    return put_sharded(arr, walker_sharding(mesh))


def pad_walkers_to_mesh(nwalkers: int, mesh: WalkerMesh) -> int:
    """Smallest even walker count >= nwalkers divisible by 2 * mesh size:
    each half of the ensemble then splits evenly over the mesh."""
    quantum = 2 * check_mesh(mesh).size
    return int(np.ceil(nwalkers / quantum) * quantum)


def _gather_outputs(mesh, out, n, blocks):
    """Every rank's rows of one output (a tensor or a tuple of tensors),
    gathered; a tuple of one dtype in one collective."""
    if not isinstance(out, tuple):
        return mesh.gather_rows(out, n, blocks)
    if len({o.dtype for o in out}) != 1:
        return tuple(mesh.gather_rows(o, n, blocks) for o in out)
    widths = [int(np.prod(o.shape[1:], dtype=np.int64)) for o in out]
    flat = torch.cat([o.reshape(o.shape[0], w) for o, w in zip(out, widths)], dim=1)
    full = mesh.gather_rows(flat, n, blocks)
    parts = torch.split(full, widths, dim=1)
    return tuple(p.reshape((n,) + tuple(o.shape[1:])) for p, o in zip(parts, out))


def shard_rows(fn, sharding, blocks=None):
    """``fn`` over the mesh: ``fn(x, *args)`` evaluates this rank's rows of
    ``x`` (:meth:`WalkerMesh.rows`, in whole blocks of ``n // blocks``
    rows when ``blocks`` is given) and returns every row's value, one
    all-gather a call.  ``fn`` returns a tensor or a tuple of tensors,
    each with one row a row of ``x``, and no row's value may depend on
    another row.  Without a sharding or a group, ``fn`` itself."""
    if check_sharding(sharding) is None or sharding.mesh.group is None:
        return fn
    mesh = sharding.mesh

    def sharded(x, *args):
        n = x.shape[0]
        lo, hi = mesh.rows(n, blocks)
        return _gather_outputs(mesh, fn(x[lo:hi], *args), n, blocks)

    return sharded
