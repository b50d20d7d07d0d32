#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA device::

    python3 chip_smoke.py

It imports only ``torch``, numpy and the port (``psfmc_tpu_torch``),
never ``jax`` nor ``psfmc_tpu``, and:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel of the port from ``psfmc_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together) and prints the build
   time and ``ptxas`` register/spill lines;
3. kernel phase, at flagship shapes (B = 125 walkers, a half-ensemble;
   2 Sersics; 128x128; float32): each kernel against its plain PyTorch
   version on the card, with its tolerance, and its time (CUDA events)
   beside the plain version's, the least time the card could take, and
   for conv_lnl the ``torch.fft`` formulation as a yardstick;
4. slice phase: the flagship model (synthetic 128x128 observation, 64x64
   PSF, 18 free parameters), 250 walkers drawn from the priors,
   ``init_state`` -> ``run_burn(20)`` -> ``reset`` ->
   ``run_sampling(20)``; checks finiteness, acceptance, that the kernels
   carried the path (launch counts), and the kernel-path lnpost against
   the plain path on the CPU in float64;
5. prints the kernel table as one JSON line, then the result line
   ``{"ok": true, "device": {...}}`` last.

``python3 chip_smoke.py --profile`` adds a torch.profiler breakdown of
device time by kernel over five retained sampler steps.

Any failure exits nonzero before the result line; so does a host
without CUDA, or a directory without the port.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

B_HALF = 125
NWALKERS = 250
BURN = 20
SAMPLE = 20
SEED = 0
STEADY = 10  # steps timed after the checks, per phase

# H100 SXM published peaks (NVIDIA data sheet): memory rate and the fp32
# rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

RENDER_TOL = 5e-6  # max relative error per pixel, kernel vs plain
CONV_LNL_TOL = 2e-5  # relative error of lnl per walker, kernel vs plain
SLICE_RTOL = 1e-4  # kernel-path lnpost (f32, GPU) vs plain path (f64, CPU)
# profile ops per pixel per Sersic (sersic_render.cu::profile, each
# expf/logf counted as one op) and per-pixel ops of the lnL reduction
RENDER_OPS_PER_PIXEL = 31
LNL_OPS_PER_PIXEL = 10


def log(msg):
    print(msg, flush=True)


def card_identity():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, reps=7, inner=10):
    """Median per-call time of ``fn`` in ms, CUDA events, after warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def compare(got, want):
    """(max abs err, max rel err) over the entries where ``want`` is
    finite; raises unless both have the same non-finite entries (a NaN
    or inf the plain version makes, e.g. a Sersic of tiny index whose
    profile overflows float32, must come out of the kernel too)."""
    import torch

    fin = torch.isfinite(want)
    same = torch.equal(fin, torch.isfinite(got)) and torch.equal(
        torch.isnan(want), torch.isnan(got)) and torch.equal(
        want[~fin & ~torch.isnan(want)], got[~fin & ~torch.isnan(got)])
    if not same:
        raise AssertionError("kernel and plain version differ in non-finite entries")
    abs_err = (got[fin] - want[fin]).abs()
    rel = abs_err / want[fin].abs().clamp(min=1e-12)
    return abs_err.max().item(), rel.max().item(), fin.float().mean().item()


def bound(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(post, spec):
    import torch

    from psfmc_tpu_torch.flagship import prior_draws
    from psfmc_tpu_torch.ops import convolve, gaussian_lnlike
    from psfmc_tpu_torch.ops.kernels import _build
    from psfmc_tpu_torch.ops.kernels.conv_lnl import (
        batched_conv_lnl,
        batched_conv_lnl_plain,
    )
    from psfmc_tpu_torch.ops.kernels.sersic_render import (
        pick_tile,
        render_sersics,
        render_sersics_plain,
        render_sersics_tiled,
    )

    h, w = spec.shape
    thetas = torch.as_tensor(prior_draws(spec, B_HALF, seed=1),
                             dtype=torch.float32, device=post.device)
    params, sky = post.render_inputs(thetas)
    params, sky = params.contiguous(), sky.contiguous()
    b, s, _ = params.shape
    rows = []

    plain_img = render_sersics_plain(params, sky, (h, w))
    render_bytes = 4 * (params.numel() + sky.numel() + b * h * w)
    render_ops = b * h * w * (s * RENDER_OPS_PER_PIXEL + 1)
    tile = pick_tile(b)
    for name, fn, replaces in (
        ("sersic_render", lambda: render_sersics(params, sky, (h, w)),
         "psfmc_tpu/ops/pallas/sersic_pallas.py:102"),
        ("sersic_render_tiled",
         lambda: render_sersics_tiled(params, sky, (h, w), tile=tile),
         "psfmc_tpu/ops/pallas/sersic_pallas.py:170"),
    ):
        abs_err, rel, frac = compare(fn(), plain_img)
        log(f"{name}: max rel err {rel:.3e} (tol {RENDER_TOL:g}), "
            f"max abs err {abs_err:.3e}, finite share {frac:.4f}")
        if not rel <= RENDER_TOL:
            raise AssertionError(f"{name} disagrees with its plain version")
        bms, by = bound(render_bytes, render_ops)
        rows.append(dict(
            name=name, route="cuda", source=_build.source_path("sersic_render"),
            replaces=replaces, launches=0, max_abs_err=abs_err,
            max_rel_err=rel, ms=time_ms(fn),
            plain_ms=time_ms(lambda: render_sersics_plain(params, sky, (h, w))),
            bound_ms=bms, bound_by=by, library_ms=None,
        ))

    raws = post.raw_and_ps(thetas)[0]
    consts = post.consts
    want = batched_conv_lnl_plain(raws, consts)
    abs_err, rel, frac = compare(batched_conv_lnl(raws, consts), want)
    log(f"conv_lnl: max rel err {rel:.3e} (tol {CONV_LNL_TOL:g}), "
        f"max abs err {abs_err:.3e}, finite share {frac:.4f}")
    if frac < 0.5:
        raise AssertionError("conv_lnl compared on too few finite walkers")
    if not rel <= CONV_LNL_TOL:
        raise AssertionError("conv_lnl disagrees with its plain version")

    f_psf = torch.as_tensor(spec.f_psf_stack[0], device=post.device).to(torch.complex64)
    f_var = torch.as_tensor(spec.f_var_stack[0], device=post.device).to(torch.complex64)

    def library():  # the torch.fft formulation, a yardstick only
        conv = convolve(raws, f_psf)
        mvar = convolve(raws * raws, f_var)
        return gaussian_lnlike(consts.obs - conv, 1.0 / (mvar + consts.obs_var),
                               consts.good)

    _, lib_rel, _ = compare(library(), want)
    log(f"conv_lnl: torch.fft yardstick rel diff to plain {lib_rel:.3e}")
    w2 = w // 2 + 1
    conv_ops = b * (2 * (8 * h * w * w2 + 16 * h * h * w2 + 6 * h * w2)
                    + LNL_OPS_PER_PIXEL * h * w)
    const_bytes = 4 * sum(t.numel() for t in (
        consts.cw, consts.sw, consts.lf, consts.li, consts.ica, consts.isa,
        consts.psf_r, consts.psf_i, consts.var_r, consts.var_i, consts.obs,
        consts.obs_var, consts.good_f))
    bms, by = bound(4 * raws.numel() + const_bytes + 4 * b, conv_ops)
    rows.append(dict(
        name="conv_lnl", route="cuda", source=_build.source_path("conv_lnl"),
        replaces="psfmc_tpu/ops/pallas/lnpost_batched.py:191", launches=0,
        max_abs_err=abs_err, max_rel_err=rel,
        ms=time_ms(lambda: batched_conv_lnl(raws, consts)),
        plain_ms=time_ms(lambda: batched_conv_lnl_plain(raws, consts)),
        bound_ms=bms, bound_by=by, library_ms=time_ms(library),
    ))
    for r in rows:
        log(f"{r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
            f"library {r['library_ms']})")
    return rows


def slice_phase(post, spec):
    import torch

    from psfmc_tpu_torch.flagship import prior_draws
    from psfmc_tpu_torch.models import build_posterior
    from psfmc_tpu_torch.ops.kernels.conv_lnl import batched_conv_lnl
    from psfmc_tpu_torch.ops.kernels.sersic_render import (
        render_sersics,
        render_sersics_tiled,
    )
    from psfmc_tpu_torch.sampler import EnsembleSampler

    p0 = prior_draws(spec, NWALKERS, seed=SEED)
    sampler = EnsembleSampler(NWALKERS, spec.num_params, post, seed=SEED)
    counted = (render_sersics, render_sersics_tiled, batched_conv_lnl)
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    sampler.init_state(p0)
    sampler.run_burn(BURN)
    sampler.reset()
    sampler.run_sampling(SAMPLE)
    acc_imgs = sampler.accumulated_images  # synchronizes with the card
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    evals = NWALKERS * (1 + BURN + SAMPLE)
    log(f"slice: {NWALKERS} walkers, burn {BURN} + sampling {SAMPLE} in "
        f"{wall:.3f} s wall, {evals / wall:.1f} posterior evaluations/s "
        f"(including the first-call overheads)")
    log(f"slice: launches {launches}")

    lnp = sampler.lnprobability
    if lnp.shape != (NWALKERS, SAMPLE) or not np.all(np.isfinite(lnp)):
        raise AssertionError("non-finite or misshapen lnprobability")
    acc = float(np.mean(sampler.acceptance_fraction))
    log(f"slice: mean acceptance {acc:.4f}")
    if not 0.02 < acc < 0.9:
        raise AssertionError(f"mean acceptance {acc} outside (0.02, 0.9)")
    steps = BURN + SAMPLE
    # init_state: one full-ensemble launch; every step: one per half-
    # ensemble; every retained step renders the ensemble once more for
    # the posterior-mean images (ensemble_carry_means)
    want = {"render_sersics": 1 + 2 * steps + SAMPLE,
            "render_sersics_tiled": 0,
            "batched_conv_lnl": 1 + 2 * steps}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != expected {want}")
    if not all(np.all(np.isfinite(v)) for v in acc_imgs.values()):
        raise AssertionError("non-finite accumulated images")
    log(f"slice: accumulated images {sorted(acc_imgs)} finite, "
        f"{sampler.accumulated_samples} samples")

    thetas = sampler.state.positions[:16]
    got = post.log_posterior_batch(thetas).double().cpu().numpy()
    ref = build_posterior(spec, device="cpu", dtype=torch.float64)
    want_lnp = ref.log_posterior_batch(thetas.cpu().double()).numpy()
    rel = np.max(np.abs(got - want_lnp) / np.abs(want_lnp))
    log(f"slice: kernel lnpost vs CPU float64 plain lnpost, 16 walkers: "
        f"max rel diff {rel:.3e} (rtol {SLICE_RTOL:g})")
    if not (np.all(np.isfinite(got)) and rel <= SLICE_RTOL):
        raise AssertionError("kernel-path lnpost disagrees with the f64 plain path")

    # steady state, after the checks (the launch counts are read above)
    for name, run in (("burn", sampler.run_burn),
                      ("sampling", sampler.run_sampling)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(STEADY)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / STEADY * 1e3
        log(f"slice: steady {name} step {ms:.3f} ms "
            f"({NWALKERS / ms * 1e3:.1f} posterior evaluations/s)")
    log(f"slice: peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return launches, sampler


def profile_phase(sampler, steps=5):
    """Device time by kernel over a few retained steps (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sampler.run_sampling(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        rows.append((dev_us, e.count, e.key))
    busy = sum(r[0] for r in rows) * 1e-6
    log(f"profile: {steps} retained steps, {wall * 1e3:.3f} ms wall, device "
        f"busy {busy * 1e3:.3f} ms, idle share {1.0 - busy / wall:.3f}")
    for dev_us, count, key in sorted(rows, reverse=True)[:15]:
        log(f"profile:   {dev_us / steps / 1e3:9.4f} ms/step  {count // steps:4d} "
            f"launches/step  {key[:90]}")
    if not rows:
        log("profile: the profiler recorded no device time")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    try:
        import psfmc_tpu_torch  # noqa: F401
    except ImportError as err:
        print(f"chip_smoke: the port is not importable here: {err}",
              file=sys.stderr)
        return 3
    from psfmc_tpu_torch.flagship import flagship_components
    from psfmc_tpu_torch.models import build_model_spec, build_posterior
    from psfmc_tpu_torch.ops.kernels import _build

    identity = card_identity()
    log(identity)  # name, power limit: exactly as nvidia-smi prints them
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {len(_build.SOURCES)} kernels in {time.perf_counter() - t0:.2f} s")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    spec = build_model_spec(flagship_components())
    post = build_posterior(spec)
    rows = kernel_phase(post, spec)
    launches, sampler = slice_phase(post, spec)
    if "--profile" in sys.argv[1:]:
        profile_phase(sampler)
    by_name = {"sersic_render": "render_sersics",
               "sersic_render_tiled": "render_sersics_tiled",
               "conv_lnl": "batched_conv_lnl"}
    for r in rows:
        r["launches"] = launches[by_name[r["name"]]]
    for r in rows:
        for k, v in r.items():
            if isinstance(v, float) and not math.isfinite(v):
                raise AssertionError(f"{r['name']}.{k} is not finite")
    log(json.dumps({"kernels": rows, "card": identity}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
