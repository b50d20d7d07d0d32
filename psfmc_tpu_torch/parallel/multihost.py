"""Multi-process execution over ``torch.distributed`` (port of ``parallel/multihost.py``).

A multi-device fit runs one process a device, as ``torchrun`` starts
them, every process the same program from the same seed and the same
inputs (:mod:`psfmc_tpu_torch.parallel.mesh` says what each one
evaluates).  Three things are then process-aware, as in the JAX package:

* **placement**: :func:`put_sharded` keeps this rank's rows of a host
  array (every process holds the whole array, so it just slices);
  :func:`put_replicated` places the whole array;
* **fetch**: :func:`fetch` of a sharded array gathers every rank's rows
  (one collective), so every process receives the full value and the
  host logic downstream (progress, convergence checks, checkpoint
  payloads) stays identical on all of them;
* **output**: the trace database, checkpoints, image products, catalogs
  and progress lines are written by the primary process alone, with a
  :func:`barrier` after each write, so that no process can look for a
  file before it exists (a driver call that resumes branches on it).

:func:`initialize` joins the default process group with a timeout on
every collective: a rank that dies fails the others' next collective
instead of hanging them.  Without a group every helper is its
single-process form, so the package calls them unconditionally.
"""
from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "process_index",
    "process_count",
    "is_primary",
    "put_sharded",
    "put_replicated",
    "fetch",
    "barrier",
    "initialize",
    "COLLECTIVE_TIMEOUT",
]

COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=300)


def _group_active() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize(backend=None, init_method=None, world_size=None, rank=None,
               timeout=COLLECTIVE_TIMEOUT):
    """Join the default process group: ``backend`` ``"nccl"`` where CUDA
    is present and ``"gloo"`` elsewhere unless given, ``init_method``
    ``"env://"`` (``torchrun``'s variables) unless given, world size and
    rank from ``WORLD_SIZE`` / ``RANK`` unless given, and ``timeout`` on
    every collective.  Under NCCL the process's device is
    ``cuda:LOCAL_RANK`` and the communicator is made here, before any
    step is captured.  A no-op when the group exists."""
    if _group_active():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    world_size = int(os.environ.get("WORLD_SIZE", 1) if world_size is None else world_size)
    rank = int(os.environ.get("RANK", 0) if rank is None else rank)
    kwargs = {}
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, timeout=timeout,
                            **kwargs)


def barrier(name: str = "psfmc_barrier") -> None:
    """Block until every process reaches this point (a no-op in one
    process).  Used after the primary's file writes, so that no process
    can race ahead and find a database missing or half written (a driver
    call right after a fit branches on the file's existence; diverging
    branches deadlock the next collective).  ``name`` labels the call
    site, as in the JAX package."""
    if process_count() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def process_index() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if _group_active() else 0


def process_count() -> int:
    """The number of processes, 1 without a process group."""
    return dist.get_world_size() if _group_active() else 1


def is_primary() -> bool:
    """True on the process responsible for all file and console output."""
    return process_index() == 0


class ShardedRows:
    """An array split by rows over a walker mesh: ``local`` holds this
    rank's rows ``sharding.rows(shape[0])``; ``shape`` is the whole
    array's.  The port's counterpart of a JAX global array with a
    walker sharding (:func:`put_sharded`, :func:`fetch`)."""

    def __init__(self, local, sharding, shape):
        self.local = local
        self.sharding = sharding
        self.shape = tuple(shape)


def put_sharded(arr, sharding):
    """This rank's rows of a host array on the mesh's device, as a
    :class:`ShardedRows`.  Every process must hold the identical full
    ``arr`` (seeded inputs guarantee it)."""
    host = np.asarray(arr)
    lo, hi = sharding.rows(host.shape[0])
    local = torch.as_tensor(np.ascontiguousarray(host[lo:hi]), device=sharding.mesh.device)
    return ShardedRows(local, sharding, host.shape)


def put_replicated(x, mesh):
    """A host array, whole, on the mesh's device (every rank holds it)."""
    return torch.as_tensor(np.asarray(x), device=mesh.device)


def fetch(x, dtype=None):
    """``np.asarray`` for tensors, sharded arrays and host arrays.

    A :class:`ShardedRows` gathers every rank's rows first (one
    collective on the mesh): every process receives the full value.  A
    tensor is copied to the host."""
    if isinstance(x, ShardedRows):
        x = x.sharding.mesh.gather_rows(x.local, x.shape[0])
    if isinstance(x, torch.Tensor):
        out = x.detach().to("cpu").numpy()
    else:
        out = np.asarray(x)
    return out if dtype is None else out.astype(dtype, copy=False)
