"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use into ``psfmc_tpu_torch/_build/<name>-<hash>.so``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -shared -Xcompiler -fPIC -Xptxas=-v -o <so> <cu>

The hash covers the source text and the flags, so an edited kernel is
rebuilt and a stale library is never loaded.  ``--use_fast_math`` is
deliberately absent: the kernels rely on the IEEE-accurate ``expf``,
``logf`` and division (within 2 ulp), which is why the port needs no
counterpart of the JAX package's software transcendentals.

Nothing here runs at import time; :func:`load` is called by a kernel
wrapper the first time it launches on a CUDA tensor, and
:func:`build_all` starts one ``nvcc`` per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["SOURCES", "build_all", "load", "function", "build_log",
           "source_path"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_CSRC = os.path.join(_PKG_DIR, "csrc")
_BUILD = os.path.join(_PKG_DIR, "_build")

SOURCES = ("sersic_render", "conv_lnl")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs = {}
_logs = {}


def source_path(name):
    """Path of ``csrc/<name>.cu`` relative to the repository root."""
    return os.path.relpath(
        os.path.join(_CSRC, name + ".cu"), os.path.dirname(_PKG_DIR)
    )


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH or CUDA_HOME); the CUDA kernels of "
        "psfmc_tpu_torch are built from csrc/ on first use"
    )


def _target(name):
    src = os.path.join(_CSRC, name + ".cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    return src, os.path.join(_BUILD, f"{name}-{digest.hexdigest()[:16]}.so")


def _start(name):
    """Start nvcc for one source; returns (Popen or None, tmp, out)."""
    src, out = _target(name)
    if os.path.exists(out):
        return None, None, out
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return proc, tmp, out


def _finish(name, proc, tmp, out):
    if proc is None:
        _logs.setdefault(name, "(cached build)")
        return out
    log, _ = proc.communicate()
    _logs[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    return out


def build_all(names=SOURCES):
    """Compile every source in parallel (one nvcc each); returns .so paths."""
    with _lock:
        started = {n: _start(n) for n in names if n not in _libs}
        return {n: _finish(n, *started[n]) for n in started}


def load(name):
    """The loaded ``ctypes.CDLL`` for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(_finish(name, *_start(name)))
            _libs[name] = lib
        return lib


def function(name, symbol, argtypes):
    """The C function ``symbol`` of ``csrc/<name>.cu``, declared.

    Every argument must be listed: ctypes passes an undeclared trailing
    argument as a 32-bit int, which truncates a pointer or a stream.
    """
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def build_log(name):
    """nvcc's output (``-Xptxas=-v``: registers, spills) for a source."""
    return _logs.get(name, "")
