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
   2 Sersics, 1 point source; 128x128; float32): each kernel against its
   plain PyTorch version on the card, with its tolerance, and its time
   (CUDA events) beside the plain version's and the least time the card
   could take (the largest of bytes, fp32 operations and, for the
   profile's transcendentals, special-function results at the SM clock
   the run measures; for conv_lnl and fused_lnl the operations of FFT
   convolutions, with the bound of the matmul-DFT formulation beside
   it); both render wrappers also with 1 and 3 Sersics and at 45x37 (a
   width that is not a multiple of four), and against a float64 render,
   from which they may be no further than the float32 plain version; for
   conv_lnl the ``torch.fft`` formulation as a yardstick, for
   fused_lnl the unfused pair render + conv_lnl.  Both likelihood
   kernels take one route picked by the shape: at 128x128 the FFT route
   (asserted; the matmul-DFT route is timed beside it on the same
   inputs); the same checks run once more at 96x96, the FFT route's
   mixed-radix geometry (rows ``conv_lnl_mixed``, ``fused_lnl_mixed``), at
   98x98 (7^2 x 2), the same geometry with radix-7 stages (rows
   ``conv_lnl_radix7``, ``fused_lnl_radix7``), at 74x74 (2 x 37), the
   padded route, the FFT route's geometry on the image zero-padded to
   150x150 (rows ``conv_lnl_padded``, ``fused_lnl_padded``; 45x75, odd
   sides, held on conv_lnl's), and at 94x94 (2 x 47, a transform of
   192x192 that fits no block), the cluster route, the transform across a
   cluster of 2 blocks (rows ``conv_lnl_cluster``, ``fused_lnl_cluster``),
   each with the matmul-DFT route timed beside it on the same inputs (the
   fused kernel's where its three buffers fit a block); the fused kernel
   also at 256x256, a cluster of 4 (row ``fused_lnl_cluster4``), and at
   1x64, which only its matmul-DFT route holds (row ``fused_lnl_dft``).
   Each likelihood kernel, its plain version and the ``torch.fft``
   yardstick are also held against a float64 ``torch.fft`` convolution on
   the card;
4. slice phase (the posterior + sampler path, ``lnpost="batched"``): the
   flagship model (synthetic 128x128 observation, 64x64 PSF, 18 free
   parameters), 250 walkers drawn from the priors, ``init_state`` ->
   ``run_burn(20)`` -> ``reset`` -> ``run_sampling(20)``; checks
   finiteness, acceptance, that every step was a replay of a captured
   CUDA graph, that the kernels carried the path (launch counts), and
   the kernel-path lnpost against the plain path on the CPU in float64;
   then steady steps, graphed and eager;
5. driver phase (the model-file path, ``PSFMC_LNPOST=pallas``): the
   flagship written as FITS files, a ds9 mask and a model file, then
   ``model_galaxy_mcmc(model, chains=250, burn=20, iterations=20,
   checkpoint_interval=10)``; checks the trace database's layout and
   cards, the five image products and their header stats, the
   acceptance, that the fused kernel carried the likelihood (launch
   counts, with the rejuvenation between burn segments), the
   checkpoints between segments, the fused-path lnpost against the plain
   path on the CPU in float64, that every step was a graph replay, that a
   second call skips sampling and writes the images again, and that a
   fit stopped after its first (mid-burn) checkpoint and resumed is
   bit-identical to the uninterrupted one;
6. graph phase: for each of the moves ``stretch``, ``de`` and ``mixed``,
   250 walkers on the slice path through 4 burn + 6 retained steps with
   ``thin=2`` and ``track_moments``, once as graph replays and once
   eagerly (the sampler's private eager loop, the yardstick): positions,
   lnprob, chain, accept counts, image accumulators and their count,
   moments and the generator's state must be bit-identical, and the
   launch counts equal; then steady graphed and eager steps of the
   driver's (fused) path;
7. tempered phase (parallel tempering on the slice path): the flagship,
   250 walkers on 4 rungs (500 walkers a half-step), ``init_state`` ->
   ``run_burn(60)`` (12 adaptation windows of 5 steps) -> ``reset`` ->
   ``run_sampling(40)``; checks every step a graph replay and no capture
   after the first window (the ladder is written into its buffer in
   place), the render and conv_lnl launches (two a step, each carrying
   every rung), swap acceptance in (0, 1], the cold rung's lnpost against
   the CPU's float64 plain path; then 10 + 6 steps graphed against eager
   bit for bit across an adaptation, the render and conv_lnl kernels at
   500 and 1000 walkers against their plain versions, the replayed step's
   time, and 8 rungs on ``evidence_beta_ladder(8)`` (1000 walkers a
   half-step) with both evidence estimators and its step's time;
8. evidence phase: the flagship as FITS files and a model file through
   ``model_galaxy_mcmc(chains=250, ntemps=4, burn=60, iterations=40,
   checkpoint_interval=20)`` under ``PSFMC_LNPOST=pallas`` (the fused
   kernel): launches, a rejuvenation and a checkpoint after every
   adaptation window, every step a replay, finite ``MCLNZ`` /
   ``MCLNZERR``, ``CKPTTEMP = 4`` with the ``beta``, ``nswap`` and
   ``evid_*`` columns; a second call with 60 iterations resumes every
   rung and its evidence accumulators; then ``model_galaxy_evidence`` at
   the JAX defaults (512 walkers in 4 groups, 3000 steps of 2 sweeps,
   mixed moves; every anneal step a replay, 256 walkers a launch) on the
   flagship model file and on a point-source-plus-sky model file of the
   same data, with both lnZ, their errors, the ln Bayes factor and the
   phase's time;
9. general phase (the JAX package's default likelihood path, ``lnpost=
   "general"``): the general flagship (two 64x64 PSF stars and a sampled
   ``PSF_Index``, a sky with ``dx``/``dy``, a ``NoiseScale``) written as
   FITS files and a model file with a ``psf_files`` list, then
   ``model_galaxy_mcmc`` with ``PSFMC_LNPOST`` unset (250 walkers, 20 burn
   + 20 retained steps); checks that the spec took the general path, the
   chain, acceptance, the ``PSF_Index`` column, that ``PSFIMG`` names the
   MAP sample's PSF, finite images, every step a graph replay, the render
   kernel's exact launches (sampling and image writer), and the card's
   lnpost against the CPU's float64 general path; then graphed against
   eager bit for bit, once more with a walker stranded between burn
   segments and moved by ``rejuvenate_stuck``, and the steady steps; then
   the variants Student-t, Poisson (non-negative counts), ``conv_pad=8``
   (with the render kernel on the padded grid against its plain
   version), ``render_oversample=4`` with ``psf_oversample=2``,
   ``PSFMC_RENDER=pallas_tiled`` and ``PSFMC_KAPPA=newton``, each with a
   lnpost check and a graphed/eager segment of 2 + 2 steps;
10. family phase (the render family and pixel-frame ``Tied``): the family
   flagship (Sky + PointSource + a de Vaucouleurs bulge and a boxy,
   truncated exponential disk, both ``Tied`` to the point source; 128x128,
   one 64x64 PSF) written as FITS files and a model file, then
   ``model_galaxy_mcmc`` with ``PSFMC_LNPOST`` unset (250 walkers, 20 burn
   + 20 retained steps): the batched path (the bulge a row of the render
   kernel, the disk plain PyTorch inside the step's graph, conv_lnl on
   the FFT route) with exact launches, every step a replay, a finite
   chain and images, the database's columns in the JAX layout, lnpost
   against the CPU's float64; graphed against eager and the steady
   steps; then each variant (Moffat, King, Ferrer, Nuker, EdgeDisk, a
   Sersic with Fourier, bending and rotation modes, Gaussian, an offset
   tie, ``render_oversample=4`` with a Nuker and a Moffat, the fused
   kernel on an elliptical bulge + disk, the general path with two PSFs
   and the tiled render) with a lnpost check and a graphed/eager segment
   of 2 + 2 steps;
11. prior family phase: every prior family of the port (all 105 aliases,
   at the JAX package's test grids, :data:`PRIOR_CASES`, the supports'
   edges and beyond, and vector hyperparameters) in float64 and float32
   on the card against the CPU, then one CUDA graph of them all replayed
   bit for bit against the eager call, and a host-callback prior (a
   discrete family with vector hyperparameters) refused by
   ``build_posterior`` on the card;
12. priors phase: the priors flagship (truncated Normal positions with a
   vector ``loc``, Reciprocal sizes, Gamma and truncated Normal indices,
   Triangular and SkewNormal magnitudes) written as FITS files and a
   model file, through ``model_galaxy_mcmc`` with ``PSFMC_LNPOST`` unset
   (250 walkers, 20 burn + 20 retained steps): the batched path with
   exact launches, every step a replay, acceptance, the database's
   columns (the xy columns two wide), finite images, lnpost against the
   CPU's float64; the API phase on its model file and database
   (``MultiComponentModel(model_file)``, ``param_values``, ``log_priors``
   against ``log_prior_batch`` on the card, ``log_posterior`` against the
   CPU's float64, the five image methods, ``simulate``,
   ``get_sampler_state``); graphed against eager, the steady steps; then
   the variants at 2 + 2 steps: a stress prior set (Tukey-lambda
   bisection, noncentral t quadrature, noncentral chi-square mixture, a
   table, per-element tables of a vector hyperparameter, a Binomial), the
   fused kernel, and the general path (two PSFs, a LogNormal
   ``NoiseScale``);
13. joint phase (joint multi-band fits): the joint flagship (band 0 the
   flagship at 128x128 with a TAN WCS at 0.03"/px; band 1 a 96x96
   observation with its own 64x64 PSF star and a WCS rotated by 20
   degrees, its sources tied to band 0's in sky frame, its sizes and index
   in pixel frame; 24 parameters) written as FITS files with WCS headers
   and a model file with two Configurations, through ``model_galaxy_mcmc``
   with ``PSFMC_LNPOST`` unset (250 walkers, 20 burn + 20 retained steps,
   segments of 10): both bands on the batched path and conv_lnl's FFT
   route, band 0's on the radix-2 geometry and band 1's on the mixed-radix
   one, inside one captured step, with exact launches by route, every step
   a replay, a finite chain,
   the database's 24 values under the JAX package's column names, the ten
   image products (128x128 and 96x96), ``MCDATSUM`` over both bands, a
   second call that skips sampling and writes the products from the
   checkpoint's mixed-shape accumulators, lnpost against the CPU's float64
   joint path; band 1's conv_lnl against its plain version and timed on
   the fit's walkers; graphed against eager, the steady steps and the
   device's busy time and kernels per retained step; then the variants
   (both bands on the general path with two PSF stars each, a registration
   offset on a sky tie with band 1 at 98x98 on conv_lnl's FFT route with
   radix-7 stages, the general bands under the tiled render) with a lnpost check
   and a graphed/eager segment of 2 + 2 steps;
14. MAP phase (the gradient path): the MAP flagship (the flagship's
   components and priors, its observation simulated from a truth inside
   the priors) written as FITS files and a model file, through
   ``model_galaxy_map`` (64 starts x 500 Adam steps, Laplace): every Adam
   step a replay of one captured step that launches the render, its
   backward, conv_lnl's residual instantiation (route ``fft_res``) and its
   backward once each (FFT route), exact launches over the run, the MAP beating every pool draw, the five
   products with ``MAPLNP`` and each parameter's card, lnpost at the MAP
   against the CPU's float64, the CPU's float64 fit from the card's best
   start, the positions against the truth, the Laplace std against the
   CPU's float64; the Adam step timed replayed and eager; five Adam steps
   graphed against eager bit for bit; the card's gradient against the
   CPU's float64 autograd at 64 points on the batched, the general and the
   family flagship; ``model_galaxy_mcmc(init="map")`` on the same files
   (20 burn + 20 retained steps); the joint MAP (64 starts x 500 steps,
   band 1's conv_lnl and backward on the FFT route's mixed-radix geometry
   inside the captured step) and two joint MAPs of 50 steps, band 1 at
   98x98 (its conv_lnl and backward on the FFT route with radix-7 stages),
   at 74x74 (both on the padded route) and at 94x94 (both on the cluster
   route); then each backward kernel
   against its plain version at 125 walkers with its times (rows
   ``sersic_render_backward``, ``conv_lnl_backward``,
   ``conv_lnl_backward_mixed``, ``conv_lnl_backward_radix7`` and
   ``conv_lnl_backward_padded`` and ``conv_lnl_backward_cluster`` at
   94x94, with the matmul-DFT route timed beside them), and the forward's
   residual instantiation that their backward reads (rows
   ``conv_lnl_res``, ``conv_lnl_res_mixed``, ``conv_lnl_res_radix7``,
   ``conv_lnl_res_padded`` and ``conv_lnl_res_cluster``: the same lnL bits as conv_lnl, the weights
   against the float64 plain scheme, the forward without residuals timed
   beside it), with the forward + backward pair of an Adam step timed
   against its bound;
15. NUTS phase (the gradient sampler): the MAP flagship's files through
   ``model_galaxy_mcmc(sampler="nuts", chains=8, max_depth=8, burn=100,
   iterations=40, checkpoint_interval=20)``: every piece of every warmup
   and retained step (begin step, begin doubling, leaf, end doubling, the
   end of the step, the window switch) a replay, all captured before the
   first step; the launches exact (one render, conv_lnl residual forward
   and both backward kernels per leaf, plus the start's and the records'
   evaluations); finite step size and metric, the accept statistic in (0,
   1], the divergences, the ``CKPTEPS`` / ``CKPTNUTS`` / ``CKPTACCS``
   cards, the five products, the chain's lnpost against the CPU's float64,
   the retained chains' rank-normalized R-hat and bulk ESS; a second call
   with 60 iterations resumes; the leaf's replay time, the leaves per step,
   the host flag's idle share and the kernels' share of a leaf; 3 + 3
   steps graphed against eager bit for bit; the general flagship (two
   PSFs, the index marginalized in the potential and Gibbs-sampled) at 10
   + 5 steps of depth 4 with its lnpost against the CPU's float64;
16. criticism phase (model criticism): the driver phase's flagship fit
   (``PSFMC_LNPOST=pallas``, 250 walkers, 20 + 20 steps) and a joint
   flagship fit (band 1 at 96x96, 10 + 10 steps) through
   ``model_galaxy_mcmc(criticism=True)``: the seven criticism cards
   (``MCLOOELP``, ``MCLOOSE``, ``MCLOOPEF``, ``MCLOOKBD``, ``MCPITKS``,
   ``MCPITP``, ``MCPSFLAG``) in every product, each held to the CPU's
   float64 recomputation from the same trace within tolerances derived
   from float32's error in one pixel's term (:data:`CRIT_CONV_ETA`) or
   four times the float32 CPU's own distance from float64, the 500 x N
   pointwise matrices held to the CPU's entry by entry likewise, the
   block's launches exact (the render once a replay chunk of 256 draws
   and band; the fused kernel, or the render and conv_lnl once a band,
   for the power-scaling replay of the 500 draws), each of those kernels
   against its plain version at its own batch, and the block's wall time
   split into the pointwise replay (and its device time), PSIS-LOO,
   LOO-PIT and the power-scaling replay;
17. batch fits (:func:`batch_phase`): ``simulate_stack`` of 32 flagship
   mocks and ``fit_batch`` at 38 walkers a target (608 a half-step
   launch, 20 + 20 steps), every step a CUDA graph replay with the render
   and conv_lnl's per-target launches exact, each target's results
   finite and the lnpost at 4 targets x 3 walkers against the CPU's
   float64; the call's wall time, fits per second, the replayed step's
   device time beside one single fit's; chunking (one capture a step
   variant reused by three chunks, graphed equal to eager, each chunk
   fitting its own data); conv_lnl with per-target planes on the radix-2,
   mixed-radix, padded and cluster routes and with per-target spectra
   on the radix-2 and cluster routes at 608 walkers against its plain
   version, timed beside the shared-constants launch, a ``torch.fft``
   composite and (cluster route) the matmul-DFT route; survey mode (a PSF
   star per target; also at 94x94, its per-target spectra on the cluster
   route, no longer the general path); the joint flagship's batch;
   ``run_sbc``;
18. hierarchical fits (:func:`hierarchy_phase`): ``fit_hierarchical`` on
   16 flagship mocks with a population on the first Sersic's index, NUTS
   with 4 chains (64 walkers a leaf), depth 8, 20 + 20 steps, centred and
   non-centred; survey mode at 8 targets; the joint flagship at 4
   targets with band 1 on the mixed-radix, padded and cluster routes
   (graphed against eager on the cluster route);
   the ensemble path (graphed against eager); ``loo_targets``.  Every
   NUTS piece a replay, the launches exact (conv_lnl's residual forwards
   equal its backwards by route and shape on the ``_targets`` keys), the
   chain's lnpost and the potential's gradient against the CPU's float64,
   the kernels against their plain versions at each fit's own batch; then
   the residual forward and the backward with the target axis on every
   route at the leaf's batch and at 608 walkers (the ``*_targets`` rows);
19. cluster phase (:func:`cluster_phase`, conv_lnl's cluster route on its
   own paths): the flagship at a 256x256 observation (a 256x256 transform
   across 4 blocks) through the driver on the default batched path (250
   walkers, 20 + 20 steps, the driver phase's checks) and the MAP
   flagship there through ``model_galaxy_map`` (launches exact, none on
   the matmul-DFT route, the lnpost against the CPU's float64, the
   replayed Adam step's time); then conv_lnl, its residual forward and
   its backward at 101x101, 160x180 and 256x256 against their plain
   versions, each timed beside the matmul-DFT route on the same inputs,
   the ``torch.fft`` composite and its bounds (the ``by_shape`` entries of
   the ``conv_lnl_cluster``, ``conv_lnl_res_cluster`` and
   ``conv_lnl_backward_cluster`` rows);
20. GALFIT phase (:func:`galfit_phase`, a GALFIT user's path through the
   command line): the GALFIT flagship (a feedme of the MAP flagship, a
   sky with its gradients fixed at 0, a ``psf`` and two ``sersic``s, with
   ``J)`` and ``K)``, and a ``G)`` constraint file coupling the host's
   position to the point source's at zero offset) beside the MAP
   flagship's FITS files; ``import_galfit_main`` to a model file with the
   ``Configuration`` block appended (the batched path, the host ``Tied``);
   ``quick_fit_main`` at 64 starts x 500 Adam steps (the launches exact by
   wrapper and route, none on the matmul-DFT route, every step one
   replay, the lnpost at the MAP against the CPU's float64, the five
   products with their Laplace cards) and ``python -m
   psfmc_tpu_torch.cli quick_fit`` once in a subprocess (rc 0, the five
   products); ``model_galaxy_mcmc`` on the imported model (250 walkers,
   20 + 20 steps; launches exact, every step a replay, the last draws'
   lnpost against the CPU's float64); ``summary_main`` on its database,
   plain and with ``--criticism`` (the replays' launches exact);
   ``results_to_feedme`` parsed back, its values the posterior means
   through the inverse conversions; the render, conv_lnl, its residual
   forward and both backward kernels against their plain versions at the
   phase's batches (the MAP's 64 starts, 125 walkers, the replay chunks:
   the ``galfit_checks`` of the kernel rows); each step's wall seconds;
21. fused routes phase (:func:`fused_routes_phase`): the fused kernel's
   fitted paths off the radix-2 geometry (``PSFMC_LNPOST=pallas``): the
   driver phase's fit and checks on the flagship at a 256x256 observation
   (the cluster route over 4 blocks) and at 96x96 with a 48x48 PSF (the
   mixed-radix geometry): launches exact on the fused kernel's route, none
   on its matmul-DFT route nor on conv_lnl, the lnpost against the CPU's
   float64, the resumed fit bit for bit, the replayed retained step's
   time (256x256: beside the cluster phase's batched-path step);
22. mesh phase (:func:`mesh_phase`, multi-device fits through
   ``psfmc_tpu_torch.parallel``, each rank a process of its own started by
   this script with a ``file://`` store and a timeout): (a) one rank on
   NCCL, the flagship fit at full width through ``model_galaxy_mcmc(mesh=
   walker_mesh())`` beside the same fit without a mesh (chains bit for
   bit, images, launches, every step a replay with the all-gathers
   captured, the replayed retained step's time beside the unsharded
   one's); (b) two ranks on the one card under gloo (NCCL refuses two
   ranks on one device), eager steps: the batched and the fused fit bit for
   bit against (a)'s unsharded fits on both ranks, files from rank 0
   only, a second call resuming on both, each rank's kernels on its own
   62 or 63 walkers a half-step (counted exactly, and held to their plain
   versions at that batch), NUTS, ``ais_evidence`` (8 groups; 7 raise),
   ``fit_batch`` (32 mocks) and ``fit_hierarchical`` (``shard="targets"``
   and ``"chains"``) against their one-process runs;
23. global phase (:func:`global_phase`, conv_lnl's and the fused kernel's
   route for the transforms no cluster of 8 holds): at 235x235 and
   251x251 (padded to 480x480 and 504x504), 512x512 and 640x640, 125
   walkers, the render, conv_lnl, its residual forward, its backward and
   the fused kernel against their plain versions, each timed beside the
   matmul-DFT route on the same inputs and the ``torch.fft`` composite
   (rows ``conv_lnl_global``, ``conv_lnl_res_global``,
   ``conv_lnl_backward_global``, ``fused_lnl_global``, each with its other
   shapes ``by_shape``); conv_lnl with per-target spectra at a survey
   batch's walkers (``conv_lnl_targets_global_spectra``); the 512x512
   flagship through the driver on the batched and on the fused path (the
   driver phase's checks, every launch on the global route), its MAP
   (64 starts x 50 steps, the residual forward and the backward), and a
   survey batch at 251x251 (a PSF star a target) on conv_lnl's global
   route with no general-path launch;
24. prints the tempered, evidence, NUTS, criticism, batch, hierarchy,
   cluster, GALFIT, fused routes, mesh and global phases' numbers and
   the kernel table as one JSON line each, then the result line
   ``{"ok": true, "device": {...}}`` last.

Each phase ends in a synchronize of the card (:func:`run_phase`), so an
asynchronous CUDA error names the phase whose launches raised it.

``python3 chip_smoke.py --profile`` adds a torch.profiler breakdown of
device time by kernel over a segment of ten retained sampler steps of
each path (slice, tempered, driver, general, family and joint), graphed and eager, with the device's busy time and idle share
(against the profiled and the unprofiled wall time), and
ten replayed Adam steps of the MAP path (busy time, kernels per step,
idle share), the SM clock cycles that one block of each FFT-route kernel spends in
each of its phases (conv_lnl also at 96x96 and 98x98, its mixed-radix geometry,
and at 74x74, its padded route; a
second build of the two sources with phase stamps;
the first phase of the fused kernel is its render), and the render kernel
under other launch geometries than the wrapper picks.  The breakdown
also covers the priors flagship and the priors' stress variant.

``python3 chip_smoke.py --only nuts,nuts,criticism`` runs only the named
phases after the build (``nuts``, ``criticism``, ``batch``, ``hierarchy``,
``cluster``, ``galfit``, ``fused_routes``, ``mesh``, ``global``, and
``nuts-kernels``: the gradient path's four kernels at NUTS's
batches, a short target for ``compute-sanitizer``), each as often as it
is named, and prints their numbers.

``python3 chip_smoke.py --step-times`` runs only :func:`step_times_phase`
(the joint offset variant's retained step and the joint MAP's Adam step
with band 1 at 74x74, 98x98 and 94x94, replayed back to back) and prints its times with a
digest of every kernel's SASS, to set one tree of the port beside another.

Any failure exits nonzero before the result line; so does a host
without CUDA, or a directory without the port.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

B_HALF = 125
NWALKERS = 250
BURN = 20
SAMPLE = 20
SEED = 0
STEADY = 10  # steps timed after the checks, per phase
SPIN_CYCLES = 5_000_000  # time_ms's head start; main() logs how long it lasts

# H100 SXM published peaks (NVIDIA data sheet): memory rate and the fp32
# rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

RENDER_TOL = 5e-6  # max relative error per pixel, kernel vs plain
CONV_LNL_TOL = 2e-5  # relative error of lnl per walker, kernel vs plain
FUSED_TOL = 2e-5  # relative error of lnl per walker, fused kernel vs plain
SLICE_RTOL = 1e-4  # kernel-path lnpost (f32, GPU) vs plain path (f64, CPU)
IMAGE_TYPES = ("raw_model", "convolved_model", "composite_ivm", "residual",
               "point_source_subtracted")
# One profile evaluation (a pixel of one Sersic; csrc/sersic_profile.cuh::
# add_sersic, with the row's and the walker's terms counted per pixel as
# the plain version computes them): 31 fp32 operations,
# each expf, logf and division counted as one, and 3 results of the
# special-function units, which run at an eighth of the fp32 lanes' rate:
# the ex2 inside each of the two expf and the reciprocal inside the
# division (the accurate logf is a polynomial and needs none).
RENDER_OPS_PER_PIXEL = 31
RENDER_SFU_PER_PIXEL = 3
SFU_RESULTS_PER_CLOCK_PER_SM = 16  # NVIDIA's throughput table, compute capability 9.0
LNL_OPS_PER_PIXEL = 10  # per-pixel operations of the lnL reduction
RAGGED_SHAPE, RAGGED_PSF_SHAPE = (45, 37), (16, 16)  # width not a multiple of 4
CHECKPOINT = 10  # driver segment: mid-phase checkpoints and rejuvenation
CARD = "the card's name and power limit, read by main()"  # beside each time
GRAPH_BURN, GRAPH_SAMPLE = 4, 6  # graph phase: graphed against eager
FLAGSHIP_SHAPE = (128, 128)  # the flagship's observation (the batch phase's)
# 3 x 2^5: the FFT route on its mixed-radix geometry (conv_lnl's and the
# fused kernel's)
MIXED_SHAPE, MIXED_PSF_SHAPE = (96, 96), (48, 48)
# 7^2 x 2: the FFT route on its mixed-radix geometry with radix-7 stages
RADIX7_SHAPE, RADIX7_PSF_SHAPE = (98, 98), (48, 48)
# 2 x 37: the padded route (a 150x150 transform); 45x75, odd sides padded to
# 90x150, is held on conv_lnl's
PADDED_SHAPE, PADDED_PSF_SHAPE = (74, 74), (36, 36)
ODD_SHAPE, ODD_PSF_SHAPE = (45, 75), (24, 36)
# 2 x 47: its 192x192 transform fits no block but a cluster of 2 blocks:
# the cluster route (the former matmul-DFT route timed beside it)
CLUSTER_SHAPE, CLUSTER_PSF_SHAPE = (94, 94), (48, 48)
# a side of 1: what only the matmul-DFT route holds (the fused kernel's row)
DFT_SHAPE, DFT_PSF_SHAPE = (1, 64), (1, 32)
# the cluster route's other shapes, each with its PSF, timed beside the
# matmul-DFT route and torch.fft on the same inputs (cluster_phase): 101x101
# (210x210 over 2 blocks), 160x180 (2 blocks), 256x256 (4 blocks)
CLUSTER_TIMED = (((101, 101), (48, 48)), ((160, 180), (64, 64)), ((256, 256), (64, 64)))
CLUSTER_FIT_SHAPE = (256, 256)  # the flagship's observation on the cluster route
CLUSTER_FIT_PSF_SHAPE = (64, 64)
# the fused kernel's fitted paths off the radix-2 geometry (the
# fused_routes phase): the cluster route over 4 blocks and the mixed radix
FUSED_FITS = ((CLUSTER_FIT_SHAPE, CLUSTER_FIT_PSF_SHAPE), (MIXED_SHAPE, MIXED_PSF_SHAPE))


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
    """Median per-call time of ``fn`` in ms, CUDA events, after warm-up.

    Each timed batch is enqueued behind torch's spin kernel
    (``SPIN_CYCLES`` clock cycles; :func:`spin_ms` measures it), so that
    the launches of a short kernel are already queued when the first one
    starts: the events then bracket the card's time, not the rate at
    which this host enqueues (a kernel of 0.03 ms read 0.05 ms on a slow
    host without it)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def spin_ms():
    """How long :func:`time_ms`'s head start holds the card, in ms."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(SPIN_CYCLES)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


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
        diff = (torch.isfinite(got) != fin) | (torch.isnan(got) != torch.isnan(want))
        at = diff.nonzero()[:4].tolist()
        raise AssertionError("kernel and plain version differ in non-finite entries at "
                             f"{at}: kernel {[got[tuple(i)].item() for i in at]}, plain "
                             f"{[want[tuple(i)].item() for i in at]}")
    abs_err = (got[fin] - want[fin]).abs()
    rel = abs_err / want[fin].abs().clamp(min=1e-12)
    return abs_err.max().item(), rel.max().item(), fin.float().mean().item()


@functools.lru_cache(maxsize=1)
def sfu_results_per_s():
    """The card's special-function rate at the SM clock this run measures:
    :func:`spin_ms` times ``SPIN_CYCLES`` clock cycles."""
    import torch

    clock_hz = SPIN_CYCLES / (spin_ms() * 1e-3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"timing: SM clock {clock_hz / 1e9:.3f} GHz from the spin, {sms} SMs: "
        f"{SFU_RESULTS_PER_CLOCK_PER_SM * sms * clock_hz / 1e12:.3f} T "
        f"special-function results/s")
    return SFU_RESULTS_PER_CLOCK_PER_SM * sms * clock_hz


def bound(nbytes, nops, nsfu=0):
    """(ms, "bytes" or "operations", which term): the least time the card
    could take, the largest of the bytes over the memory rate, the fp32
    operations over the fp32 peak and the special-function results over
    their rate at the measured clock."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "fp32 operations": nops / FP32_FLOP_PER_S * 1e3}
    if nsfu:
        terms["special-function results"] = nsfu / sfu_results_per_s() * 1e3
    term = max(terms, key=terms.get)
    return terms[term], "bytes" if term == "bytes" else "operations", term


def fft_conv_ops(h, w):
    """Operations of one circular convolution by real FFTs: a real
    transform of N points ~2.5 N log2 N, one forward and one inverse,
    times the given half spectrum (6 per complex bin)."""
    n = h * w
    return 5 * n * math.log2(n) + 6 * h * (w // 2 + 1)


def conv_lnl_ops(b, h, w):
    """Operations the conv + lnL function needs per launch: the two
    circular convolutions by real FFTs, the squared image, and the lnL
    reduction."""
    n = h * w
    return b * (2 * fft_conv_ops(h, w) + n + LNL_OPS_PER_PIXEL * n)


def dft_matmul_ops(b, h, w):
    """Operations of the kernels' own formulation: each convolution as
    the real half-spectrum matrix products of ``convolve_rdft``, plus the
    lnL reduction; about 20x the FFT count at 128x128."""
    w2 = w // 2 + 1
    return b * (2 * (8 * h * w * w2 + 16 * h * h * w2 + 6 * h * w2)
                + LNL_OPS_PER_PIXEL * h * w)


def fft_geometry(shape):
    """conv_lnl's geometry at ``shape``: ``"radix2"`` (both sides powers of
    two), ``"mixed"`` (the mixed-radix geometry, stages of radix 2, 3 and
    5), ``"radix7"`` (the same geometry with radix-7 stages: a side with a
    factor of 7), ``"padded"`` (the padded route: the image zero-padded to
    a transform on one of those geometries), ``"cluster"`` (the cluster
    route: such a transform over a cluster of blocks), ``"global"`` (the
    global route: such a transform in global memory), or None on the
    matmul-DFT route."""
    from psfmc_tpu_torch.ops.kernels.conv_lnl import conv_route

    route = conv_route(shape)
    if route != "fft":
        return route if route in ("padded", "cluster", "global") else None
    if all(n & (n - 1) == 0 for n in shape):
        return "radix2"
    return "radix7" if any(n % 7 == 0 for n in shape) else "mixed"


# the FFT route's geometries that read_counts and the rows split its launches
# by (the padded route's launches are its own route's counts)
MIXED_GEOMETRIES = ("mixed", "radix7")


def kernel_phase(post, spec):
    import torch

    from psfmc_tpu_torch.flagship import flagship_components, prior_draws
    from psfmc_tpu_torch.models import build_model_spec, build_posterior
    from psfmc_tpu_torch.ops.kernels import _build
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

    tile = pick_tile(b)
    wrappers = (
        ("sersic_render", render_sersics,
         "psfmc_tpu/ops/pallas/sersic_pallas.py:102"),
        ("sersic_render_tiled",
         lambda p, k, shape: render_sersics_tiled(p, k, shape, tile=tile),
         "psfmc_tpu/ops/pallas/sersic_pallas.py:170"),
    )

    def held(name, fn, p, k, shape, what):
        """One render against the plain version in float32 (tolerance, same
        non-finite entries) and in float64 (no further from it than the
        float32 plain version is)."""
        want = render_sersics_plain(p, k, shape)
        got = fn(p, k, shape)
        abs_err, rel, frac = compare(got, want)
        truth = render_sersics_plain(p.double(), k.double(), shape)

        def truth_err(img):
            fin = torch.isfinite(truth) & torch.isfinite(img)
            return ((img.double() - truth)[fin].abs()
                    / truth[fin].abs().clamp(min=1e-300)).max().item()

        err64, plain_err64 = truth_err(got), truth_err(want)
        log(f"{name}, {what}: max rel err {rel:.3e} (tol {RENDER_TOL:g}), max "
            f"abs err {abs_err:.3e}, finite share {frac:.4f}; against the "
            f"float64 plain version: kernel {err64:.3e}, float32 plain "
            f"version {plain_err64:.3e}")
        if not rel <= RENDER_TOL:
            raise AssertionError(f"{name} disagrees with its plain version, {what}")
        if not err64 <= plain_err64:
            raise AssertionError(f"{name} is further from the float64 render "
                                 f"than the float32 plain version, {what}")
        return abs_err, rel, err64, plain_err64

    # the main path's shape with 1, 2 (the flagship's) and 3 Sersics, and a
    # width that is not a multiple of four: the scalar stores, a cut last run
    ragged_spec = build_model_spec(flagship_components(RAGGED_SHAPE,
                                                       RAGGED_PSF_SHAPE))
    ragged_post = build_posterior(ragged_spec, device=post.device,
                                  lnpost="batched")
    ragged = ragged_post.render_inputs(torch.as_tensor(
        prior_draws(ragged_spec, B_HALF, seed=1), dtype=torch.float32,
        device=post.device))
    by_count = {}
    for shape, (p2, k) in (((h, w), (params, sky)), (RAGGED_SHAPE, ragged)):
        p2 = p2.contiguous()
        for p in (p2[:, :1].contiguous(), p2, torch.cat([p2, p2[:, :1]], 1)):
            for name, fn, _ in wrappers:
                by_count[name, shape, p.shape[1]] = held(
                    name, fn, p, k.contiguous(), shape,
                    f"{shape[0]}x{shape[1]}, {p.shape[1]} Sersics") + (
                    time_ms(lambda: fn(p, k, shape)),)

    render_bytes = 4 * (params.numel() + sky.numel() + b * h * w)
    render_ops = b * h * w * (s * RENDER_OPS_PER_PIXEL + 1)
    render_sfu = b * h * w * s * RENDER_SFU_PER_PIXEL
    for name, fn, replaces in wrappers:
        abs_err, rel, err64, plain_err64, ms = by_count[name, (h, w), s]
        bms, by, term = bound(render_bytes, render_ops, render_sfu)
        rows.append(dict(
            name=name, route="cuda", source=_build.source_path("sersic_render"),
            replaces=replaces, launches=0, max_abs_err=abs_err,
            max_rel_err=rel, ms=ms,
            plain_ms=time_ms(lambda: render_sersics_plain(params, sky, (h, w))),
            bound_ms=bms, bound_by=by, bound_term=term, library_ms=None,
            f64_rel_err=err64, plain_f64_rel_err=plain_err64,
            ms_by_sersics={str(n): by_count[name, (h, w), n][4]
                           for n in (1, 2, 3)},
            ragged_ms=by_count[name, RAGGED_SHAPE, s][4],
        ))

    rows += likelihood_rows(post, spec, thetas, ("conv_lnl", "fft"),
                            ("fused_lnl", "fft"))
    # (shape, PSF, conv_lnl's row, the fused kernel's row, whether the fused
    # row's error is taken against max(|lnL|, |normalization|) a walker: at
    # 1x64 walkers reach lnL = -6 against a normalization of +280, where the
    # float32 plain version itself is 6e-5 from the float64 lnL)
    for shape, psf_shape, conv, fused, norm_scale in (
            (MIXED_SHAPE, MIXED_PSF_SHAPE, ("conv_lnl_mixed", "fft"),
             ("fused_lnl_mixed", "fft"), False),
            (RADIX7_SHAPE, RADIX7_PSF_SHAPE, ("conv_lnl_radix7", "fft"),
             ("fused_lnl_radix7", "fft"), False),
            (PADDED_SHAPE, PADDED_PSF_SHAPE, ("conv_lnl_padded", "padded"),
             ("fused_lnl_padded", "padded"), False),
            (CLUSTER_SHAPE, CLUSTER_PSF_SHAPE, ("conv_lnl_cluster", "cluster"),
             ("fused_lnl_cluster", "cluster"), False),
            (CLUSTER_FIT_SHAPE, CLUSTER_FIT_PSF_SHAPE, None,
             ("fused_lnl_cluster4", "cluster"), False),
            (DFT_SHAPE, DFT_PSF_SHAPE, None, ("fused_lnl_dft", "dft"), True)):
        other_spec = build_model_spec(flagship_components(shape, psf_shape))
        other_post = build_posterior(other_spec, device=post.device,
                                     lnpost="batched")
        other_thetas = torch.as_tensor(prior_draws(other_spec, B_HALF, seed=1),
                                       dtype=torch.float32, device=post.device)
        rows += likelihood_rows(other_post, other_spec, other_thetas, conv, fused,
                                norm_scale)
    padded_row = next(r for r in rows if r["name"] == "conv_lnl_padded")
    padded_row["odd_shape"] = odd_shape_check(post.device)
    for r in rows:
        log(f"{r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.5f} ms by {r['bound_by']} "
            f"({r['bound_term']}), "
            f"{r['ms'] / r['bound_ms']:.1f}x the bound; matmul-DFT "
            f"formulation's bound {r.get('dft_bound_ms')}, "
            f"library {r['library_ms']}, unfused {r.get('unfused_ms')}, "
            f"route {r.get('conv_route')}, matmul-DFT route on the same "
            f"inputs {r.get('dft_route_ms')}"
            + (f", the padded transform's own bound {r['transform_bound_ms']:.5f} ms"
               if "transform_bound_ms" in r else "") + ")")
    return rows


def odd_shape_check(device):
    """conv_lnl's padded route at :data:`ODD_SHAPE` (45x75: odd sides, a
    90x150 transform) at 125 walkers: the forward within
    :data:`CONV_LNL_TOL` of its plain version per walker, the residual
    instantiation's lnL bits the forward's, the backward from its
    residuals within :data:`CONV_BWD_TOL` of each walker's largest
    gradient of the float64 plain backward, and the same bits on a second
    launch of each.  Returns the errors."""
    import torch

    from psfmc_tpu_torch.flagship import flagship_components, prior_draws
    from psfmc_tpu_torch.models import build_model_spec, build_posterior
    from psfmc_tpu_torch.ops.kernels import conv_lnl as CL

    spec = build_model_spec(flagship_components(ODD_SHAPE, ODD_PSF_SHAPE))
    post = build_posterior(spec, device=device, lnpost="batched")
    if CL.conv_route(ODD_SHAPE) != "padded":
        raise AssertionError(f"{ODD_SHAPE} does not take the padded route")
    thetas = torch.as_tensor(prior_draws(spec, B_HALF, seed=1), dtype=torch.float32,
                             device=device)
    raws = post.raw_and_ps(thetas)[0].contiguous()
    consts = post.consts
    routes = dict(CL.batched_conv_lnl.route_launches)
    got = CL.batched_conv_lnl(raws, consts)
    lnl, *residuals = CL.batched_conv_lnl_residuals(raws, consts)
    routes["padded"] += 1
    routes["padded_res"] += 1
    if CL.batched_conv_lnl.route_launches != routes:
        raise AssertionError(f"{ODD_SHAPE}: conv_lnl did not launch on the padded route")
    _, rel, frac = compare(got, CL.batched_conv_lnl_plain(raws, consts))
    grad = torch.ones(B_HALF, dtype=torch.float32, device=device)
    back = CL.batched_conv_lnl_backward(raws, consts, got, grad, residuals)
    c64 = build_posterior(spec, device="cpu", dtype=torch.float64,
                          lnpost="batched").consts
    want = CL.batched_conv_lnl_backward_plain(
        raws.double().cpu(), c64, got.double().cpu(), grad.double().cpu()).to(device)
    keep = torch.isfinite(got)
    back_err = normalized_err(back[keep], want[keep], dims=(1, 2))
    again = (same_bits(got, CL.batched_conv_lnl(raws, consts)) and same_bits(lnl, got)
             and same_bits(back, CL.batched_conv_lnl_backward(raws, consts, got, grad,
                                                              residuals)))
    log(f"conv_lnl at {ODD_SHAPE[0]}x{ODD_SHAPE[1]} (padded to "
        f"{consts.padded_shape[0]}x{consts.padded_shape[1]}): max rel err {rel:.3e} "
        f"(tol {CONV_LNL_TOL:g}), finite share {frac:.4f}; backward max normalized "
        f"err {back_err:.3e} (tol {CONV_BWD_TOL:g}); residual lnL bits and repeat "
        f"launches equal: {again}")
    if not (rel <= CONV_LNL_TOL and frac >= 0.5 and back_err <= CONV_BWD_TOL and again):
        raise AssertionError(f"conv_lnl at {ODD_SHAPE} disagrees on the padded route")
    return {"shape": list(ODD_SHAPE), "max_rel_err": rel, "backward_normalized_err":
            back_err}


def likelihood_rows(post, spec, thetas, conv, fused, norm_scale=False):
    """The conv_lnl row (unless ``conv`` is None) and the fused_lnl row
    (unless ``fused`` is None) at ``spec``'s shape, each ``(row name, the
    route the shape must take)``: each kernel against its plain version,
    against the float64 truth, and its times; off the matmul-DFT route,
    that route on the same inputs too (the fused kernel's where its three
    buffers fit a block).  With ``norm_scale`` each row's error is taken
    against the larger of |lnL| and |normalization| a walker, as
    :func:`batch_kernel_check` takes it."""
    import torch

    from psfmc_tpu_torch.ops import convolve, gaussian_lnlike
    from psfmc_tpu_torch.ops.kernels.conv_lnl import batched_conv_lnl_plain, conv_route

    h, w = spec.shape
    params, sky = post.render_inputs(thetas)
    params, sky = params.contiguous(), sky.contiguous()
    b, s, _ = params.shape
    rows = []
    raws = post.raw_and_ps(thetas)[0]
    consts = post.consts
    want = batched_conv_lnl_plain(raws, consts)

    f_psf = torch.as_tensor(spec.f_psf_stack[0], device=post.device)
    f_var = torch.as_tensor(spec.f_var_stack[0], device=post.device)
    f_psf32, f_var32 = f_psf.to(torch.complex64), f_var.to(torch.complex64)

    def library_of(x):  # the torch.fft formulation, a yardstick only
        conv = convolve(x, f_psf32)
        mvar = convolve(x * x, f_var32)
        return gaussian_lnlike(consts.obs - conv, 1.0 / (mvar + consts.obs_var),
                               consts.good)

    def library():
        return library_of(raws)

    lib = library()
    if conv_route((h, w)) != "global":
        _, lib_rel, _ = compare(lib, want)
    else:  # a yardstick: at these widths cuFFT's and the matmuls' float32 may part
        # on a walker whose variance sum nears 0 (logged, not held)
        both = torch.isfinite(lib) & torch.isfinite(want)
        lib_rel = ((lib - want).abs()[both] / want[both].abs()).max().item()
        log(f"{h}x{w}: walkers finite in the torch.fft yardstick or the plain version "
            f"only: {(torch.isfinite(lib) != torch.isfinite(want)).nonzero().flatten().tolist()}")
    log(f"{h}x{w}: torch.fft yardstick rel diff to conv_lnl's plain version "
        f"{lib_rel:.3e}")

    # the float64 truth of the same raw images, by torch.fft on the card
    raws64 = raws.double()
    truth = gaussian_lnlike(
        consts.obs.double() - convolve(raws64, f_psf.to(torch.complex128)),
        1.0 / (convolve(raws64 * raws64, f_var.to(torch.complex128))
               + consts.obs_var.double()), consts.good)

    def truth_err(v):
        fin = torch.isfinite(truth) & torch.isfinite(v)
        return ((v.double() - truth)[fin].abs() / truth[fin].abs()).max().item()

    def f64_err(v):  # against the float64 lnL, on the rows' own scale
        return norm_scaled_err(v, truth, consts)[0] if norm_scale else truth_err(v)

    # the bound counts what the function needs: FFT convolutions, and the
    # bytes of the data it reads (the DFT operators belong to the matmul-
    # DFT formulation, whose bound is recorded beside it as dft_bound_ms)
    conv_ops = conv_lnl_ops(b, h, w)
    data_bytes = 4 * sum(t.numel() for t in (
        consts.psf_r, consts.psf_i, consts.var_r, consts.var_i, consts.obs,
        consts.obs_var, consts.good_f))
    if conv is not None:
        rows += conv_lnl_row(raws, consts, want, conv, library, truth_err, conv_ops,
                             data_bytes, norm_scale, f64_err)
    if fused is None:
        return rows
    return rows + fused_lnl_row(post, thetas, params, sky, fused, library, truth_err,
                                conv_ops, data_bytes, norm_scale, library_of, f64_err)


def norm_scaled_err(got, want, consts):
    """The largest error a walker over the larger of |lnL| and the
    Gaussian's normalization (+0.5 log(1 / 2 pi var) a good pixel: it
    cancels the chi-square half where a walker passes lnL = 0), over the
    walkers where ``want`` is finite; and the normalization."""
    import torch

    var = consts.obs_var.double()
    norm = 0.5 * torch.where(consts.good, -torch.log(2 * math.pi * var),
                             torch.zeros_like(var)).sum()
    fin = torch.isfinite(want)
    scale = torch.maximum(want.double().abs(), norm.abs())
    return ((got.double() - want.double()).abs()[fin] / scale[fin]).max().item(), norm.item()


def f64_fallback(name, rel, tol, got, want, f64_err, scaled):
    """Where a kernel misses its float32 plain version by more than ``tol``
    (``rel``), it passes if it is within ``tol`` of the float64 lnL
    (``f64_err``) and no further from it than the float32 plain version
    (at wide images the plain matmul DFT's float32 sums are the less
    accurate of the two, as they are far from the data); records both in
    ``scaled`` and returns the error that holds, else raises."""
    if rel <= tol:
        return rel
    k64, p64 = f64_err(got), f64_err(want)
    scaled.update(plain_rel_err=rel, kernel_f64_err=k64, plain_f64_err=p64)
    log(f"{name}: {rel:.3e} from its float32 plain version; against the float64 lnL: "
        f"the kernel {k64:.3e}, the float32 plain version {p64:.3e} (tol {tol:g})")
    if not (k64 <= tol and k64 <= p64):
        raise AssertionError(f"{name} disagrees with its plain version")
    return k64


def conv_lnl_row(raws, consts, want, conv, library, truth_err, conv_ops, data_bytes,
                 norm_scale=False, f64_err=None):
    """:func:`likelihood_rows`' conv_lnl row at ``raws``' shape (with
    ``norm_scale`` its error a walker over the larger of |lnL| and
    |normalization|, :func:`norm_scaled_err`; on the global route, with
    ``f64_err``, :func:`f64_fallback`)."""
    from psfmc_tpu_torch.ops.kernels import _build
    from psfmc_tpu_torch.ops.kernels import conv_lnl as CL
    from psfmc_tpu_torch.ops.kernels.conv_lnl import (
        batched_conv_lnl,
        batched_conv_lnl_plain,
        conv_route,
    )

    b, h, w = raws.shape
    rows = []
    name, route = conv
    if conv_route((h, w)) != route:
        raise AssertionError(f"{h}x{w} takes the {conv_route((h, w))} route, "
                             f"expected {route}")
    geometry = fft_geometry((h, w))
    log(f"{name}: {h}x{w} takes conv_lnl's {route} route"
        + (f" ({geometry} geometry)" if geometry else ""))
    counts = dict(batched_conv_lnl.route_launches)
    got = batched_conv_lnl(raws, consts)
    counts[route] += 1
    if batched_conv_lnl.route_launches != counts:
        raise AssertionError(f"{name} did not launch on the {route} route")
    abs_err, rel, frac = compare(got, want)
    scaled = {}
    if norm_scale:
        scaled = dict(per_walker_rel_err=rel)
        rel, scaled["normalization"] = norm_scaled_err(got, want, consts)
        log(f"{name}: max err {rel:.3e} of max(|lnL|, |normalization| = "
            f"{abs(scaled['normalization']):.1f}) (tol {CONV_LNL_TOL:g}); of |lnL| "
            f"{scaled['per_walker_rel_err']:.3e}")
    log(f"{name}: max rel err {rel:.3e} (tol {CONV_LNL_TOL:g}), "
        f"max abs err {abs_err:.3e}, finite share {frac:.4f}")
    if frac < 0.5:
        raise AssertionError(f"{name} compared on too few finite walkers")
    if f64_err is not None and route == "global":
        rel = f64_fallback(name, rel, CONV_LNL_TOL, got, want, f64_err, scaled)
    if not rel <= CONV_LNL_TOL:
        raise AssertionError(f"{name} disagrees with its plain version")
    log(f"{name}: max rel err against the float64 torch.fft convolution: "
        f"kernel {truth_err(got):.3e}, plain {truth_err(want):.3e}, "
        f"torch.fft (float32) {truth_err(library()):.3e}")
    bms, by, term = bound(4 * raws.numel() + data_bytes + 4 * b, conv_ops)
    rows.append(dict(
        name=name, route="cuda", source=_build.source_path("conv_lnl"),
        replaces="psfmc_tpu/ops/pallas/lnpost_batched.py:191", launches=0,
        max_abs_err=abs_err, max_rel_err=rel,
        ms=time_ms(lambda: batched_conv_lnl(raws, consts)),
        plain_ms=time_ms(lambda: batched_conv_lnl_plain(raws, consts)),
        bound_ms=bms, bound_by=by, bound_term=term,
        library_ms=time_ms(library),
        dft_bound_ms=bound(0, dft_matmul_ops(b, h, w))[0],
        conv_route=route, f64_rel_err=truth_err(got),
        plain_f64_rel_err=truth_err(want), **scaled,
    ))
    if route in ("padded", "cluster", "global"):  # the transform's work: its own bound
        mh, mw = consts.padded_shape
        rows[-1].update(transform_shape=[mh, mw], transform_bound_ms=bound(
            0, conv_lnl_ops(b, mh, mw))[0])
    if route == "cluster":
        rows[-1]["cluster_size"] = CL.cluster_size((h, w))
    if route == "global":  # the route's own traffic through its scratch
        rows[-1].update(global_route_plan(b, (h, w), "forward", data_bytes))
    if route != "dft":  # the matmul-DFT route on the same inputs
        _, dft_rel, _ = compare(CL._launch(raws, consts, "dft"), want)
        if not dft_rel <= CONV_LNL_TOL:
            raise AssertionError("conv_lnl's matmul-DFT route disagrees "
                                 "with the plain version")
        rows[-1]["dft_route_ms"] = time_ms(
            lambda: CL._launch(raws, consts, "dft"))
    return rows


def fused_lnl_row(post, thetas, params, sky, fused, library, truth_err, conv_ops,
                  data_bytes, norm_scale=False, library_of=None, f64_err=None):
    """:func:`likelihood_rows`' fused_lnl row: the whole likelihood from the
    scalars, held to its plain version (with ``norm_scale``, the error a
    walker over the larger of |lnL| and |normalization|); beside it the
    render and conv_lnl kernels on the same inputs and, where its three
    buffers fit a block, its matmul-DFT route; on the global route, whose
    shapes the fused kernel refused before, the render kernel with
    conv_lnl's matmul-DFT route and the render with the torch.fft
    formulation ``library_of`` on the same inputs."""
    import torch

    from psfmc_tpu_torch.ops.kernels import _build
    from psfmc_tpu_torch.ops.kernels import fused_lnl as FL
    from psfmc_tpu_torch.ops.kernels.conv_lnl import batched_conv_lnl
    from psfmc_tpu_torch.ops.kernels.fused_lnl import (
        fused_lnl,
        fused_lnl_plain,
        fused_route,
    )
    from psfmc_tpu_torch.ops.kernels.sersic_render import render_sersics
    from psfmc_tpu_torch.ops.pointsource import pointsource_image

    consts = post.consts
    h, w = consts.shape
    b, s, _ = params.shape
    name, route = fused
    if fused_route((h, w)) != route:
        raise AssertionError(f"{h}x{w} takes the fused kernel's "
                             f"{fused_route((h, w))} route, expected {route}")
    fky, kx = post.pointsource_inputs(thetas)
    fky, kx = fky.contiguous(), kx.contiguous()
    args = (params, sky, fky, kx, consts)
    want = fused_lnl_plain(*args)
    counts = dict(fused_lnl.route_launches)
    got = fused_lnl(*args)
    counts[route] += 1
    if fused_lnl.route_launches != counts:
        raise AssertionError(f"{name} did not launch on the {route} route")
    abs_err, rel, frac = compare(got, want)
    scaled = {}
    if norm_scale:  # the Gaussian's normalization, +0.5 log(1 / 2 pi var) a good pixel
        fin = torch.isfinite(want)
        scaled = dict(per_walker_rel_err=rel, min_abs_lnl=want[fin].abs().min().item())
        rel, scaled["normalization"] = norm_scaled_err(got, want, consts)
        log(f"{name}: max err {rel:.3e} of max(|lnL|, |normalization| = "
            f"{abs(scaled['normalization']):.1f}) (tol {FUSED_TOL:g}); of |lnL| "
            f"{scaled['per_walker_rel_err']:.3e} (smallest |lnL| {scaled['min_abs_lnl']:.3f})")
    log(f"{name}: max rel err {rel:.3e} (tol {FUSED_TOL:g}), "
        f"max abs err {abs_err:.3e}, finite share {frac:.4f}")
    if frac < 0.5:
        raise AssertionError(f"{name} compared on too few finite walkers")
    if f64_err is not None and route == "global":
        rel = f64_fallback(name, rel, FUSED_TOL, got, want, f64_err, scaled)
    if not rel <= FUSED_TOL:
        raise AssertionError(f"{name} disagrees with its plain version")
    log(f"{name}: max rel err against the float64 torch.fft convolution of "
        f"the plain render: kernel {truth_err(got):.3e}, plain "
        f"{truth_err(want):.3e}, torch.fft (float32) {truth_err(library()):.3e}")
    npt = fky.shape[1]

    def unfused():  # the render and conv_lnl kernels on the same inputs
        raw = render_sersics(params, sky, (h, w)) + pointsource_image(fky, kx)
        return batched_conv_lnl(raw, consts)

    _, un_rel, _ = compare(unfused(), want)
    log(f"{name}: unfused render + conv_lnl rel diff to plain {un_rel:.3e}")
    ps_render_ops = b * h * w * (s * RENDER_OPS_PER_PIXEL + 1 + 2 * npt)
    in_bytes = 4 * (params.numel() + sky.numel() + fky.numel() + kx.numel())
    bms, by, term = bound(in_bytes + data_bytes + 4 * b,
                          conv_ops + ps_render_ops,
                          b * h * w * s * RENDER_SFU_PER_PIXEL)
    row = dict(
        name=name, route="cuda", source=_build.source_path("fused_lnl"),
        replaces="psfmc_tpu/ops/pallas/lnpost_pallas.py:183", launches=0,
        max_abs_err=abs_err, max_rel_err=rel,
        ms=time_ms(lambda: fused_lnl(*args)),
        plain_ms=time_ms(lambda: fused_lnl_plain(*args)),
        bound_ms=bms, bound_by=by, bound_term=term, library_ms=None,
        dft_bound_ms=bound(0, dft_matmul_ops(b, h, w) + ps_render_ops)[0],
        unfused_ms=time_ms(unfused), conv_route=route,
        f64_rel_err=truth_err(got), plain_f64_rel_err=truth_err(want), **scaled,
    )
    if route in ("padded", "cluster", "global"):  # the transform's work: its own bound
        mh, mw = consts.padded_shape
        row.update(transform_shape=[mh, mw], transform_bound_ms=bound(
            0, conv_lnl_ops(b, mh, mw) + ps_render_ops)[0])
    if route == "cluster":
        row["cluster_size"] = len(FL.cluster_rank_rows((h, w)))
        row["rank_rows"] = FL.cluster_rank_rows((h, w))
    if route == "global":  # its render pass's tiles, the route's own traffic, and
        # what ran at this shape before (the fused kernel refused it): the
        # render kernel with conv_lnl's matmul-DFT route, and with torch.fft
        from psfmc_tpu_torch.ops.kernels import conv_lnl as CL

        def rendered():
            return render_sersics(params, sky, (h, w)) + pointsource_image(fky, kx)

        row["render_rows"] = FL.global_render_rows((h, w))
        row.update(global_route_plan(b, (h, w), "fused", data_bytes))
        row["dft_route_rel_diff"] = compare(CL._launch(rendered(), consts, "dft"), want)[1]
        row["dft_route_ms"] = time_ms(lambda: CL._launch(rendered(), consts, "dft"))
        row["dft_route_what"] = "the render kernel + conv_lnl's matmul-DFT route"
        row["torch_fft_ms"] = time_ms(lambda: library_of(rendered()))
    if route != "dft" and FL.fused_lnl_smem_bytes((h, w), s, npt) <= FL.FUSED_SMEM_LIMIT:
        _, dft_rel, _ = compare(FL._launch(*args, "dft"), want)
        if not dft_rel <= FUSED_TOL:
            raise AssertionError("fused_lnl's matmul-DFT route disagrees "
                                 "with the plain version")
        row["dft_route_ms"] = time_ms(lambda: FL._launch(*args, "dft"))
    return [row]


def slice_phase(post, spec):
    import torch

    from psfmc_tpu_torch.flagship import prior_draws
    from psfmc_tpu_torch.models import build_posterior
    from psfmc_tpu_torch.ops.kernels.conv_lnl import conv_route
    from psfmc_tpu_torch.sampler import EnsembleSampler

    p0 = prior_draws(spec, NWALKERS, seed=SEED)
    sampler = EnsembleSampler(NWALKERS, spec.num_params, post, seed=SEED)
    counted = counted_kernels()
    torch.cuda.synchronize()
    reset_counts(counted)
    t0 = time.perf_counter()
    sampler.init_state(p0)
    sampler.run_burn(BURN)
    sampler.reset()
    sampler.run_sampling(SAMPLE)
    acc_imgs = sampler.accumulated_images  # synchronizes with the card
    wall = time.perf_counter() - t0
    launches, by_route = read_counts(counted)
    evals = NWALKERS * (1 + BURN + SAMPLE)
    log(f"slice: {NWALKERS} walkers, burn {BURN} + sampling {SAMPLE} in "
        f"{wall:.3f} s wall, {evals / wall:.1f} posterior evaluations/s "
        f"(including the first-call overheads)")
    log(f"slice: launches {launches}, by route {by_route}")

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
            "batched_conv_lnl": 1 + 2 * steps,
            "fused_lnl": 0}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != expected {want}")
    if sampler.device.type == "cuda":  # (the CPU runs no graph)
        if sampler.graph_replays != steps:
            raise AssertionError(f"{sampler.graph_replays} of {steps} steps "
                                 "were graph replays")
        log(f"slice: every one of the {steps} steps was a CUDA graph replay")
    route = conv_route(spec.shape)
    other = "dft" if route == "fft" else "fft"
    if (by_route[f"batched_conv_lnl:{route}"] != want["batched_conv_lnl"]
            or by_route[f"batched_conv_lnl:{other}"] != 0):
        raise AssertionError(f"launches by route {by_route}: every conv_lnl "
                             f"launch should take the {route} route")
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

    steady_phase(sampler, "slice")  # after the checks (counts are read above)
    log(f"slice: peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    launches.update(by_route)
    return launches, sampler


def steady_phase(sampler, label):
    """Steady steps of ``sampler`` as graph replays and eagerly (the
    sampler's private eager loop), in turns graphed, eager, eager,
    graphed, burn and retained (after one untimed round of each, so that
    every graph is captured and every buffer allocated): host-clock ms
    per step ending in a synchronize, and the posterior evaluations per
    second; then the graphed retained step's replays back to back (CUDA
    events), the card's time per step."""
    import torch

    from psfmc_tpu_torch.sampler.ensemble import _eager

    out = {}
    for mode in ("warm-up", "graphed", "eager", "eager", "graphed"):
        for name, run in (("burn", sampler.run_burn),
                          ("sampling", sampler.run_sampling)):
            with _eager(sampler) if mode == "eager" else contextlib.nullcontext():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(STEADY)
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / STEADY * 1e3
            if mode != "warm-up":
                out.setdefault((mode, name), []).append(ms)
    for (mode, name), times in out.items():
        log(f"{label}: steady {name} step, {mode}: " + ", ".join(
            f"{ms:.3f} ms ({NWALKERS / ms * 1e3:.1f} posterior evaluations/s)"
            for ms in times))
    replay_ms = time_ms(lambda: sampler._step("retain"), reps=5, inner=5)
    log(f"{label}: retained-step graph replayed back to back: {replay_ms:.3f} ms "
        f"per step on the card ({NWALKERS / replay_ms * 1e3:.1f} posterior "
        f"evaluations/s)")


def reset_counts(counted):
    for fn in counted:
        fn.launches = 0
        if hasattr(fn, "route_launches"):
            fn.route_launches.update(dict.fromkeys(fn.route_launches, 0))
        if hasattr(fn, "shape_launches"):
            fn.shape_launches.clear()


def read_counts(counted):
    """Launches by wrapper, and by ``<wrapper>:<route>`` for the two
    likelihood kernels; for conv_lnl and its backward also
    ``<wrapper>:<route>:<geometry>``, those of a route's launches that ran
    on the FFT route's mixed-radix geometry, without (``mixed``) or with
    (``radix7``) radix-7 stages (counted by route and shape), and
    ``<wrapper>:<geometry>``, their sum over the routes.  The padded
    route's launches are ``<wrapper>:padded`` and
    ``batched_conv_lnl:padded_res``."""
    counts = {fn.__name__: fn.launches for fn in counted}
    routes = {f"{fn.__name__}:{r}": n for fn in counted
              for r, n in getattr(fn, "route_launches", {}).items()}
    for fn in counted:
        if hasattr(fn, "shape_launches"):
            name = fn.__name__
            for geo in MIXED_GEOMETRIES:
                routes[f"{name}:{geo}"] = 0
                routes.update({f"{name}:{r}:{geo}": 0 for r in fn.route_launches})
            for (route, shape), n in fn.shape_launches.items():
                geo = fft_geometry(shape)
                if geo in MIXED_GEOMETRIES:
                    routes[f"{name}:{geo}"] += n
                    routes[f"{name}:{route}:{geo}"] += n
    return counts, routes


def counted_kernels():
    """Every kernel wrapper of the port (each keeps a ``launches`` count)."""
    from psfmc_tpu_torch.ops.kernels.conv_lnl import batched_conv_lnl
    from psfmc_tpu_torch.ops.kernels.fused_lnl import fused_lnl
    from psfmc_tpu_torch.ops.kernels.sersic_render import (
        render_sersics,
        render_sersics_tiled,
    )

    return (render_sersics, render_sersics_tiled, batched_conv_lnl, fused_lnl)


def global_lnpost_err(out, mc, thetas, got, want, rel, device):
    """The driver's lnpost error on the global route (512x512 and up): a
    walker's lnpost passes 0 on its way up, where the Gaussian's
    normalization (+0.5 log(1 / 2 pi var) a good pixel) cancels its
    chi-square half, so there the error a walker is taken against the
    larger of |lnpost| and |normalization|, as :func:`batch_kernel_check`
    takes conv_lnl's at a batch fit's walkers.  Beside it (into ``out``)
    the relative error against |lnpost| (``rel``), the worst walker's
    values, and the general path's (``torch.fft`` in float32 on the card)
    relative error at the same walkers, the float32 FFT's own.  Returns
    the scaled error."""
    import torch

    from psfmc_tpu_torch.models import build_posterior

    consts = mc.posterior_fns.consts
    var = consts.obs_var.double().cpu()
    norm = 0.5 * torch.where(consts.good.cpu(), -torch.log(2 * math.pi * var),
                             torch.zeros_like(var)).sum().item()
    err = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), abs(norm))))
    general = build_posterior(mc.spec, device=device, lnpost="general")
    gen = general.log_posterior_batch(thetas).double().cpu().numpy()
    gen_rel = float(np.max(np.abs(gen - want) / np.abs(want)))
    worst = int(np.argmax(np.abs(got - want) / np.abs(want)))
    out.update(lnpost_per_walker_rel_err=float(rel), lnpost_normalization=norm,
               lnpost_general_rel_err=gen_rel,
               lnpost_worst=[float(got[worst]), float(want[worst]), float(gen[worst])])
    log(f"driver: on the global route, the lnpost error a walker of max(|lnpost|, "
        f"|normalization| = {abs(norm):.1f}) {err:.3e} (rtol {SLICE_RTOL:g}); of |lnpost| "
        f"{rel:.3e}, the worst walker {got[worst]:.4f} against {want[worst]:.4f} (the "
        f"general path, torch.fft in float32: {gen[worst]:.4f}, of |lnpost| "
        f"{gen_rel:.3e})")
    return err


def driver_phase(shape=(128, 128), psf_shape=(64, 64), device=None, lnpost="pallas"):
    """The model-file driver at full width, on the fused kernel
    (``lnpost="pallas"``, ``PSFMC_LNPOST``'s value) or, with ``lnpost=None``,
    on the default batched path (the render and conv_lnl kernels: the
    cluster phase's 256x256 flagship) (the arguments shrink it for a
    rehearsal on the CPU).  Returns the launches (by wrapper, by route, and
    the replayed retained step's device time), the model and the last
    sample."""
    import torch

    from psfmc_tpu_torch import fitting
    from psfmc_tpu_torch.database import load_database
    from psfmc_tpu_torch.flagship import write_flagship_files
    from psfmc_tpu_torch.io import fits
    from psfmc_tpu_torch.models import as_model, build_posterior
    from psfmc_tpu_torch.ops.kernels.conv_lnl import conv_route
    from psfmc_tpu_torch.ops.kernels.fused_lnl import fused_route

    fused = lnpost == "pallas"
    kernel, other_kernel = (("fused_lnl", "batched_conv_lnl") if fused
                            else ("batched_conv_lnl", "fused_lnl"))

    counted = counted_kernels()
    steps = BURN + SAMPLE
    # the driver's checkpoints and the rejuvenations, counted by wrapping
    # the functions it calls (the wrappers change nothing they return)
    saves, moved, samplers = [], [], []
    save_database = fitting.save_database
    rejuvenate_stuck = fitting.EnsembleSampler.rejuvenate_stuck
    sampler_init = fitting.EnsembleSampler.__init__

    def counting_save(*a, **k):
        saves.append(k.get("meta_dict", {}).get("MCITER"))
        return save_database(*a, **k)

    def counting_rejuvenate(self, *a, **k):
        moved.append(rejuvenate_stuck(self, *a, **k))
        return moved[-1]

    def kept_init(self, *a, **k):
        sampler_init(self, *a, **k)
        samplers.append(self)

    with tempfile.TemporaryDirectory() as tmp:
        model_file = write_flagship_files(tmp, shape, psf_shape)
        out = os.path.join(tmp, "out")
        kwargs = dict(output_name=out, chains=NWALKERS, burn=BURN,
                      iterations=SAMPLE, seed=SEED, device=device,
                      checkpoint_interval=CHECKPOINT)
        if lnpost:
            os.environ["PSFMC_LNPOST"] = lnpost
        else:
            os.environ.pop("PSFMC_LNPOST", None)
        fitting.save_database = counting_save
        fitting.EnsembleSampler.rejuvenate_stuck = counting_rejuvenate
        fitting.EnsembleSampler.__init__ = kept_init
        try:
            torch.cuda.synchronize()
            reset_counts(counted)
            t0 = time.perf_counter()
            db = fitting.model_galaxy_mcmc(model_file, **kwargs)
            wall = time.perf_counter() - t0
            launches, by_route = read_counts(counted)
        finally:
            fitting.save_database = save_database
            fitting.EnsembleSampler.rejuvenate_stuck = rejuvenate_stuck
            fitting.EnsembleSampler.__init__ = sampler_init
        timings = dict(db.phase_seconds)
        log(f"driver: model_galaxy_mcmc, {NWALKERS} walkers, burn {BURN} + "
            f"sampling {SAMPLE} in segments of {CHECKPOINT}: {wall:.3f} s wall; "
            "phases " + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items()))
        log(f"driver: steady step {timings['burn'] / BURN * 1e3:.3f} ms (burn), "
            f"{timings['sampling'] / SAMPLE * 1e3:.3f} ms (sampling, with the "
            f"image accumulation); checkpoint writes and first-call overheads "
            f"included")
        log(f"driver: launches {launches}, by route {by_route}; "
            f"{len(saves)} database writes "
            f"(MCITER {saves}); walkers moved by each rejuvenation {moved}")
        # a rejuvenation between burn segments, a checkpoint between
        # segments of either phase, and the final write
        burn_segs, sample_segs = -(-BURN // CHECKPOINT), -(-SAMPLE // CHECKPOINT)
        want_saves = [0] * (burn_segs - 1) + [CHECKPOINT * (i + 1) for i in
                                              range(sample_segs - 1)] + [SAMPLE]
        if len(moved) != burn_segs - 1 or saves != want_saves:
            raise AssertionError(f"driver: {len(moved)} rejuvenations, database "
                                 f"writes {saves}; want {burn_segs - 1}, {want_saves}")
        # init: one full-ensemble launch; every step: one per half-ensemble;
        # every rejuvenation that moved walkers: one full-ensemble launch
        want = 1 + 2 * steps + sum(n > 0 for n in moved)
        if launches[kernel] != want or launches[other_kernel] != 0:
            raise AssertionError(
                f"driver launches {launches}: want {kernel} {want}, {other_kernel} 0")
        if launches["render_sersics"] == 0:
            raise AssertionError("the render kernel never ran on the driver path")
        replays = [sm.graph_replays for sm in samplers]
        if device != "cpu":  # (the CPU runs no graph)
            if replays != [steps]:
                raise AssertionError(f"driver: graph replays {replays}, want "
                                     f"[{steps}]")
            log(f"driver: every one of the {steps} steps was a CUDA graph replay")
        route = (fused_route if fused else conv_route)(shape)
        on_routes = sum(n for k, n in by_route.items()
                        if k.startswith(f"{kernel}:") and k.count(":") == 1)
        if by_route[f"{kernel}:{route}"] != want or on_routes != want:
            raise AssertionError(f"launches by route {by_route}: every {kernel} "
                                 f"launch should take the {route} route")
        launches.update(by_route)
        if device != "cpu":  # the retained step's graph, replayed back to back
            launches["retain_step_ms"] = time_ms(
                lambda: samplers[0]._step("retain"), reps=5, inner=5)
            log(f"driver ({kernel}, {shape[0]}x{shape[1]}): a replayed retained step "
                f"{launches['retain_step_ms']:.3f} ms ({CARD})")

        db_file = out + "_db.fits"
        db = load_database(db_file)
        mc = as_model(model_file, device=device, lnpost="fused" if fused else "batched")
        names = mc.param_names
        if len(db) != NWALKERS * SAMPLE or db.colnames != names + [
                "lnprobability", "walker", "sample"]:
            raise AssertionError(f"trace table {len(db)} rows, {db.colnames}")
        for name, ln in zip(names, mc.param_lens):
            col = db[name]
            if col.dtype != np.float64 or col.shape[1:] != ((ln,) if ln > 1 else ()):
                raise AssertionError(f"column {name}: {col.dtype} {col.shape}")
        for name in ("walker", "sample"):
            if db[name].dtype != np.int64:
                raise AssertionError(f"column {name}: {db[name].dtype}")
        cards = {k: db.meta.get(k) for k in ("MCITER", "MCBURN", "MCCHAINS",
                                             "MCACCEPT", "MCDATSUM", "MAPWLKR",
                                             "MAPSAMP")}
        log(f"driver: database {len(db)} rows, cards {cards}")
        if (None in cards.values() or cards["MCITER"] != SAMPLE
                or cards["MCBURN"] != BURN or cards["MCCHAINS"] != NWALKERS):
            raise AssertionError(f"database cards {cards}")
        acc = float(cards["MCACCEPT"])
        if not 0.02 < acc < 0.9:
            raise AssertionError(f"mean acceptance {acc} outside (0.02, 0.9)")

        def check_images(base=out):
            for ftype in IMAGE_TYPES:
                img = fits.getdata(f"{base}_{ftype}.fits")
                if img.shape != tuple(shape) or not np.all(np.isfinite(img)):
                    raise AssertionError(f"image {ftype}: {img.shape}")
                hdr = fits.getheader(f"{base}_{ftype}.fits")
                if ("MCCHI2NU" not in hdr or "MCPPCP" not in hdr
                        or not str(hdr.get("PSFIMG", "")).endswith("psf.fits")):
                    raise AssertionError(f"image {ftype}: header stats missing")
            return hdr
        hdr = check_images()
        log(f"driver: five image products {shape[0]}x{shape[1]}, finite; "
            f"MCCHI2NU {hdr['MCCHI2NU']}, MCPPCP {hdr['MCPPCP']}, PSFIMG "
            f"{hdr['PSFIMG']}; mean acceptance {acc:.4f}")

        last = np.stack([np.concatenate([np.atleast_1d(np.asarray(v, float))
                                         for v in row])
                         for row in db[names][SAMPLE - 1::SAMPLE]])
        got = mc.posterior_fns.log_posterior_batch(last[:16]).double().cpu().numpy()
        ref = build_posterior(mc.spec, device="cpu", dtype=torch.float64,
                              lnpost="batched")
        want_lnp = ref.log_posterior_batch(last[:16]).numpy()
        rel = np.max(np.abs(got - want_lnp) / np.abs(want_lnp))
        log(f"driver: {kernel} lnpost vs CPU float64 plain lnpost, 16 walkers: "
            f"max rel diff {rel:.3e} (rtol {SLICE_RTOL:g})")
        if route == "global":
            rel = global_lnpost_err(launches, mc, last[:16], got, want_lnp, rel, device)
        if not (np.all(np.isfinite(got)) and rel <= SLICE_RTOL):
            raise AssertionError(f"the {kernel} path's lnpost disagrees with the f64 "
                                 "plain path")
        launches["lnpost_rel_err"] = float(rel)

        for ftype in IMAGE_TYPES:
            os.remove(f"{out}_{ftype}.fits")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fitting.model_galaxy_mcmc(model_file, **kwargs)
        if "already contains sampled chains" not in buf.getvalue():
            raise AssertionError("the second call did not skip sampling:\n"
                                 + buf.getvalue())
        check_images()
        log("driver: second call skipped sampling and wrote the five images again")

        # a fit stopped right after its first checkpoint (mid-burn), then
        # resumed from it, must reproduce the uninterrupted fit exactly
        class Stop(Exception):
            pass

        def save_then_stop(*a, **k):
            save_database(*a, **k)
            raise Stop

        resumed_out = os.path.join(tmp, "resumed")
        resumed_kwargs = dict(kwargs, output_name=resumed_out)
        fitting.save_database = save_then_stop
        try:
            fitting.model_galaxy_mcmc(model_file, **resumed_kwargs)
            raise AssertionError("the interrupted fit was not stopped")
        except Stop:
            pass
        finally:
            fitting.save_database = save_database
        meta = load_database(resumed_out + "_db.fits").meta
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            resumed = fitting.model_galaxy_mcmc(model_file, **resumed_kwargs)
        if "Resuming from checkpoint" not in buf.getvalue():
            raise AssertionError("the second call did not resume:\n" + buf.getvalue())
        for name in db.colnames:
            if not np.array_equal(resumed[name], db[name]):
                raise AssertionError(f"resumed fit differs in column {name}")
        check_images(resumed_out)
        for ftype in IMAGE_TYPES:
            if not np.array_equal(fits.getdata(f"{resumed_out}_{ftype}.fits"),
                                  fits.getdata(f"{out}_{ftype}.fits")):
                raise AssertionError(f"resumed fit differs in image {ftype}")
        log(f"driver: a fit stopped after its checkpoint at burn "
            f"{meta['MCBURNDN']}/{meta['MCBURN']} and resumed is bit-identical "
            f"to the uninterrupted fit (database and five images)")
        os.environ.pop("PSFMC_LNPOST", None)
        return launches, mc, last


PT_NTEMPS = 4  # the tempered phase: rungs of the flagship fit's ladder
PT_BURN, PT_SAMPLE = 60, 40  # 12 adaptation windows of 5 steps, then retained
PT_EVID_NTEMPS, PT_EVID_BURN, PT_EVID_SAMPLE = 8, 20, 40  # evidence_beta_ladder(8)
PT_EQUAL_BURN, PT_EQUAL_SAMPLE = 10, 6  # graphed against eager (2 windows of 5)
PT_RESUMED = 60  # the driver's second call: iterations, resuming after 40
AIS_NWALKERS, AIS_STEPS, AIS_GROUPS, AIS_SWEEPS = 512, 3000, 4, 2  # the JAX defaults


def pt_state_differs(a, b):
    """What differs between two tempered samplers' states, chains and
    generators (bit for bit)."""
    sa, sb = a.state, b.state
    names = ("positions", "log_like", "log_prior", "betas", "naccept", "nswap",
             "accum_count", "lnl_sum", "lnl_sum_c", "lnl_sq_sum", "lnl_sq_sum_c",
             "evid_steps", "ss_max", "ss_sum")
    pairs = {k: (getattr(sa, k), getattr(sb, k)) for k in names}
    pairs.update({"generator": (a.generator.get_state(), b.generator.get_state()),
                  "chain": (a.chain, b.chain),
                  "lnprobability": (a.lnprobability, b.lnprobability)})
    pairs.update({f"accum.{k}": (v, sb.accum[k]) for k, v in sa.accum.items()})
    return [k for k, (x, y) in pairs.items() if not same_bits(x, y)]


def batch_kernel_check(post, thetas, label, stack=None, norm_scale=False, c64=None):
    """The render and, on the batched path, the conv_lnl kernel at the
    batch ``thetas`` gives them (a tempered half-step's, a NUTS leaf's, a
    batch fit's), each against its plain version; with ``stack`` (a batch
    fit's :class:`~psfmc_tpu_torch.models.posterior.ObsStack`), conv_lnl
    with the stack's per-target constants where it takes the kernel path.
    With a stack, or with ``norm_scale``, conv_lnl's error is taken against
    the larger of |lnL| and |normalization| a walker (see below).  With
    ``c64`` (the float64 CPU posterior's constants), where the kernel
    misses its float32 plain version, it passes if it is within the
    tolerance of the float64 lnL and no further from it than the plain
    version (far from the data the plain version's matmul DFT is the less
    accurate of the two)."""
    import torch

    from psfmc_tpu_torch.ops.kernels.conv_lnl import (
        batched_conv_lnl,
        batched_conv_lnl_plain,
    )
    from psfmc_tpu_torch.ops.kernels.sersic_render import (
        render_sersics,
        render_sersics_plain,
    )

    params, sky = post.render_inputs(thetas)
    params, sky = params.contiguous(), sky.contiguous()
    _, render_rel, _ = compare(render_sersics(params, sky, post.render_shape),
                               render_sersics_plain(params, sky, post.render_shape))
    b = thetas.shape[0]
    out = {"batch": b, "render_max_rel_err": render_rel}
    msg = f"{label}: render at B = {b}: max rel err {render_rel:.3e} (tol {RENDER_TOL:g})"
    conv_rel = 0.0
    if stack is None:
        consts = post.consts if post.grad_mode == "batched" else None
    else:
        consts = stack.consts
        out["targets"] = stack.targets
    if consts is not None:
        raws = post.raw_and_ps(thetas)[0].contiguous()
        got, want = batched_conv_lnl(raws, consts), batched_conv_lnl_plain(raws, consts)
        abs_err, conv_rel, frac = compare(got, want)
        out["conv_lnl_max_rel_err"] = conv_rel
        scale = want.double().abs()
        if stack is None and not norm_scale:
            msg += (f"; conv_lnl at B = {b}: max rel err {conv_rel:.3e} (tol "
                    f"{CONV_LNL_TOL:g}), finite share {frac:.4f}")
        else:
            # a fit's walkers pass lnL = 0 on their way up: the Gaussian's
            # normalization (+0.5 log(1 / 2 pi var) a good pixel) cancels the
            # chi-square half there, so the error is taken against the sum's
            # own scale, the larger of |lnL| and |normalization| a walker
            obs = post if stack is None else stack
            var = obs.obs_var.double()
            norm = 0.5 * torch.where(obs.good, -torch.log(2 * math.pi * var),
                                     torch.zeros_like(var)).sum((-2, -1)).reshape(-1)
            scale = torch.maximum(want.double().abs(),
                                  norm.abs().repeat_interleave(b // norm.numel()))
            fin = torch.isfinite(want)
            err = (got.double() - want.double()).abs()[fin] / scale[fin]
            out["conv_lnl_per_walker_rel_err"] = conv_rel
            out["conv_lnl_min_abs_lnl"] = want[fin].abs().min().item() if fin.any() else None
            conv_rel = out["conv_lnl_max_rel_err"] = err.max().item() if fin.any() else 0.0
            msg += (f"; conv_lnl at B = {b}: max err {conv_rel:.3e} of max(|lnL|, "
                    f"|normalization|) (tol {CONV_LNL_TOL:g}), max abs err {abs_err:.3e}, "
                    f"of |lnL| {out['conv_lnl_per_walker_rel_err']:.3e} (smallest |lnL| "
                    f"{out['conv_lnl_min_abs_lnl']}), finite share {frac:.4f}")
    if consts is not None and c64 is not None and conv_rel > CONV_LNL_TOL:
        want64 = batched_conv_lnl_plain(raws.double().cpu(), c64).to(got.device)
        fin = torch.isfinite(want64)
        kernel64 = ((got.double() - want64).abs() / scale)[fin].max().item()
        plain64 = ((want.double() - want64).abs() / scale)[fin].max().item()
        out.update(conv_lnl_plain_rel_err=conv_rel, conv_lnl_f64_rel_err=kernel64,
                   conv_lnl_plain_f64_rel_err=plain64)
        msg += (f"; against the float64 lnL: the kernel {kernel64:.3e}, its float32 plain "
                f"version {plain64:.3e} (tol {CONV_LNL_TOL:g})")
        if kernel64 <= CONV_LNL_TOL and kernel64 <= plain64:
            conv_rel = out["conv_lnl_max_rel_err"] = kernel64
    log(msg)
    if not (render_rel <= RENDER_TOL and conv_rel <= CONV_LNL_TOL):
        raise AssertionError(f"{label}: a kernel disagrees with its plain version "
                             f"at B = {b}")
    return out


def tempered_phase(post, spec):
    """Parallel tempering at full width on the slice path: the flagship,
    250 walkers on 4 rungs (500 walkers a half-step), ``init_state`` ->
    ``run_burn(60)`` (12 adaptation windows) -> ``reset`` ->
    ``run_sampling(40)``; then graphed against eager, the kernels at the
    tempered batches, and 8 rungs on ``evidence_beta_ladder(8)`` with
    both evidence estimators.  Returns the launches of the 4-rung run, the
    sampler, and the numbers it measured."""
    import torch

    from psfmc_tpu_torch.flagship import prior_draws
    from psfmc_tpu_torch.models import build_posterior
    from psfmc_tpu_torch.ops.kernels.conv_lnl import conv_route
    from psfmc_tpu_torch.sampler import (
        PTEnsembleSampler,
        default_beta_ladder,
        evidence_beta_ladder,
    )
    from psfmc_tpu_torch.sampler.ensemble import _eager

    out = {}
    p0 = prior_draws(spec, NWALKERS, seed=SEED)
    sampler = PTEnsembleSampler(NWALKERS, spec.num_params, post, ntemps=PT_NTEMPS,
                                seed=SEED)
    counted = counted_kernels()
    graphs = []  # graphs captured after each adaptation window
    torch.cuda.synchronize()
    reset_counts(counted)
    t0 = time.perf_counter()
    sampler.init_state(p0)
    sampler.run_burn(PT_BURN, callback=lambda done, total: graphs.append(
        len(sampler._graphs)))
    adapted = sampler.betas.copy()
    sampler.reset()
    sampler.run_sampling(PT_SAMPLE)
    acc_imgs = sampler.accumulated_images  # synchronizes with the card
    wall = time.perf_counter() - t0
    launches, by_route = read_counts(counted)
    steps = PT_BURN + PT_SAMPLE
    half = PT_NTEMPS * NWALKERS // 2
    log(f"tempered: {NWALKERS} walkers x {PT_NTEMPS} rungs ({half} walkers a "
        f"half-step), burn {PT_BURN} + sampling {PT_SAMPLE} in {wall:.3f} s wall "
        f"(including the first-call overheads); launches {launches}, by route "
        f"{by_route}")
    log(f"tempered: ladder {np.array2string(default_beta_ladder(PT_NTEMPS), precision=4)}"
        f" adapted over {len(graphs)} windows to "
        f"{np.array2string(adapted, precision=4)}; swap acceptance per pair "
        f"{np.array2string(sampler.swap_acceptance_fraction, precision=4)}; cold-rung "
        f"acceptance {float(np.mean(sampler.acceptance_fraction)):.4f}")
    # init_state: one launch of every rung; every step: one per half-step,
    # every rung in it; every retained step renders the cold rung once more
    want = {"render_sersics": 1 + 2 * steps + PT_SAMPLE, "render_sersics_tiled": 0,
            "batched_conv_lnl": 1 + 2 * steps, "fused_lnl": 0}
    if launches != want:
        raise AssertionError(f"tempered launch counts {launches} != expected {want}")
    route = conv_route(spec.shape)
    if by_route[f"batched_conv_lnl:{route}"] != want["batched_conv_lnl"]:
        raise AssertionError(f"tempered launches by route {by_route}")
    if len(graphs) != 12 or np.array_equal(adapted, default_beta_ladder(PT_NTEMPS)):
        raise AssertionError(f"tempered: {len(graphs)} windows, ladder {adapted}")
    if post.device.type == "cuda":
        if sampler.graph_replays != steps:
            raise AssertionError(f"tempered: {sampler.graph_replays} of {steps} steps "
                                 "were graph replays")
        if graphs[0] != graphs[-1] or len(sampler._graphs) != 2:
            raise AssertionError(f"tempered: graphs after each window {graphs}, "
                                 f"{len(sampler._graphs)} in all: adaptation captured")
        log(f"tempered: every one of the {steps} steps was a CUDA graph replay; "
            f"graphs after the first window {graphs[0]}, after the last "
            f"{graphs[-1]} (the ladder written in place)")
    swaps = sampler.swap_acceptance_fraction
    if not np.all((swaps > 0) & (swaps <= 1)):
        raise AssertionError(f"tempered: swap acceptance {swaps} outside (0, 1]")
    lnp = sampler.lnprobability
    if lnp.shape != (NWALKERS, PT_SAMPLE) or not np.all(np.isfinite(lnp)):
        raise AssertionError("tempered: non-finite or misshapen lnprobability")
    if not all(np.all(np.isfinite(v)) for v in acc_imgs.values()):
        raise AssertionError("tempered: non-finite accumulated images")
    cold = sampler.chain[:16, -1]
    ref = build_posterior(spec, device="cpu", dtype=torch.float64)
    want_lnp = ref.log_posterior_batch(cold).numpy()
    got = post.log_posterior_batch(cold).double().cpu().numpy()
    rel = max(np.max(np.abs(got - want_lnp) / np.abs(want_lnp)),
              np.max(np.abs(lnp[:16, -1] - want_lnp) / np.abs(want_lnp)))
    log(f"tempered: cold-rung lnpost (recorded, and the kernel path's) vs CPU "
        f"float64 plain lnpost, 16 walkers: max rel diff {rel:.3e} "
        f"(rtol {SLICE_RTOL:g})")
    if not rel <= SLICE_RTOL:
        raise AssertionError("tempered: cold-rung lnpost disagrees with the f64 plain path")
    out["launches"] = dict(launches, **by_route)
    out["swap_acceptance"] = swaps.tolist()
    out["ladder"] = adapted.tolist()

    # graphed against eager, bit for bit, across an adaptation
    runs = {}
    for mode in ("graphed", "eager"):
        sm = PTEnsembleSampler(NWALKERS, spec.num_params, post, ntemps=PT_NTEMPS,
                               seed=SEED)
        torch.cuda.synchronize()
        reset_counts(counted)
        with _eager(sm) if mode == "eager" else contextlib.nullcontext():
            sm.init_state(prior_draws(spec, NWALKERS, seed=SEED + 1))
            sm.run_burn(PT_EQUAL_BURN)
            sm.reset()
            sm.run_sampling(PT_EQUAL_SAMPLE)
        torch.cuda.synchronize()
        runs[mode] = sm, read_counts(counted)[0]
    (g, g_counts), (e, e_counts) = runs["graphed"], runs["eager"]
    differ = pt_state_differs(g, e)
    if differ or g_counts != e_counts:
        raise AssertionError(f"tempered: graphed differs from eager in {differ}; "
                             f"launches {g_counts} / {e_counts}")
    equal_steps = PT_EQUAL_BURN + PT_EQUAL_SAMPLE
    if post.device.type == "cuda" and (g.graph_replays, e.graph_replays) != (
            equal_steps, 0):
        raise AssertionError(f"tempered: replays {g.graph_replays} / {e.graph_replays}")
    log(f"tempered: {equal_steps} steps (an adaptation between two windows) as graph "
        f"replays and eagerly bit-identical (every rung's positions, lnL and "
        f"log-prior, the ladder, accept and swap counts, evidence accumulators, "
        f"image accumulators, chain, generator); launches {g_counts} both")

    # the kernels at the tempered batches (a half-step of 4 and of 8 rungs)
    flat = sampler.state.positions.reshape(-1, spec.num_params)
    out["kernel_checks"] = [batch_kernel_check(post, flat[:half].contiguous(), "tempered"),
                            batch_kernel_check(post, flat.contiguous(), "tempered")]
    out["step_ms"] = time_ms(lambda: sampler._step("retain"), reps=5, inner=5)
    log(f"tempered: retained step at {PT_NTEMPS} rungs replayed back to back: "
        f"{out['step_ms']:.3f} ms on the card ({CARD})")

    # 8 rungs on the evidence ladder, 1000 walkers a half-step
    evid = PTEnsembleSampler(NWALKERS, spec.num_params, post, ntemps=PT_EVID_NTEMPS,
                             betas=evidence_beta_ladder(PT_EVID_NTEMPS), seed=SEED)
    evid.init_state(p0)
    evid.run_burn(PT_EVID_BURN)
    evid.reset()
    evid.run_sampling(PT_EVID_SAMPLE)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ss, ti = evid.log_evidence("stepping-stone"), evid.log_evidence("ti")
    for w in {str(w.message) for w in caught}:
        log(f"tempered: {PT_EVID_NTEMPS} rungs: log_evidence warns: {w}")
    log(f"tempered: {PT_EVID_NTEMPS} rungs on evidence_beta_ladder"
        f"({PT_EVID_NTEMPS}), burn {PT_EVID_BURN} + sampling {PT_EVID_SAMPLE}: "
        f"stepping-stone lnZ {ss[0]:.3f} +/- {ss[1]:.3f}, TI lnZ {ti[0]:.3f} "
        f"+/- {ti[1]:.3f}; swap acceptance "
        f"{np.array2string(evid.swap_acceptance_fraction, precision=4)}")
    if not np.all(np.isfinite(ss + ti)):
        raise AssertionError(f"tempered: evidence not finite: {ss}, {ti}")
    if post.device.type == "cuda" and evid.graph_replays != PT_EVID_BURN + PT_EVID_SAMPLE:
        raise AssertionError(f"tempered: {evid.graph_replays} replays at 8 rungs")
    out["evidence_8"] = {"ss": list(ss), "ti": list(ti)}
    out["step8_ms"] = time_ms(lambda: evid._step("retain"), reps=5, inner=5)
    log(f"tempered: retained step at {PT_EVID_NTEMPS} rungs replayed back to back: "
        f"{out['step8_ms']:.3f} ms on the card ({CARD})")
    log(f"tempered: peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return launches, by_route, sampler, out


PS_MODEL_CUT = "Sersic(xy="  # the flagship model file without its Sersics


def evidence_phase(shape=(128, 128), psf_shape=(64, 64), device=None):
    """The driver's tempered fit and the evidence at full width: the
    flagship as FITS files and a model file, ``model_galaxy_mcmc(ntemps=4,
    burn=60, iterations=40, checkpoint_interval=20)`` under
    ``PSFMC_LNPOST=pallas`` (the fused kernel), a second call with more
    iterations resuming every rung, then ``model_galaxy_evidence`` at the
    JAX defaults on the flagship model file and on a point-source-plus-sky
    model file of the same data.  Returns the launches of each part and
    the numbers measured."""
    import torch

    from psfmc_tpu_torch import fitting
    from psfmc_tpu_torch.database import load_checkpoint, load_database
    from psfmc_tpu_torch.flagship import write_flagship_files
    from psfmc_tpu_torch.io.table import Table

    counted = counted_kernels()
    out = {}
    samplers, saves, moved = [], [], []
    init = fitting.PTEnsembleSampler.__init__
    save_database = fitting.save_database
    rejuvenate = fitting.PTEnsembleSampler.rejuvenate_stuck

    def kept_init(self, *a, **k):
        init(self, *a, **k)
        samplers.append(self)

    def counting_save(*a, **k):
        saves.append(k.get("meta_dict", {}).get("MCITER"))
        return save_database(*a, **k)

    def counting_rejuvenate(self, *a, **k):
        moved.append(rejuvenate(self, *a, **k))
        return moved[-1]

    steps = PT_BURN + PT_SAMPLE
    with tempfile.TemporaryDirectory() as tmp:
        model_file = write_flagship_files(tmp, shape, psf_shape)
        out_name = os.path.join(tmp, "out")
        kwargs = dict(output_name=out_name, chains=NWALKERS, ntemps=PT_NTEMPS,
                      burn=PT_BURN, iterations=PT_SAMPLE, checkpoint_interval=20,
                      seed=SEED, device=device)
        os.environ["PSFMC_LNPOST"] = "pallas"
        fitting.PTEnsembleSampler.__init__ = kept_init
        fitting.save_database = counting_save
        fitting.PTEnsembleSampler.rejuvenate_stuck = counting_rejuvenate
        try:
            torch.cuda.synchronize()
            reset_counts(counted)
            t0 = time.perf_counter()
            db = fitting.model_galaxy_mcmc(model_file, **kwargs)
            wall = time.perf_counter() - t0
            launches, by_route = read_counts(counted)
            first = dict(launches, **by_route)
            log(f"evidence: model_galaxy_mcmc(ntemps={PT_NTEMPS}), {NWALKERS} walkers, "
                f"burn {PT_BURN} + sampling {PT_SAMPLE}: {wall:.3f} s wall; phases "
                + ", ".join(f"{k} {v:.3f} s" for k, v in db.phase_seconds.items())
                + f"; launches {launches}, by route {by_route}; database writes "
                f"(MCITER) {saves}; walkers moved by each rejuvenation {moved}")
            # a rejuvenation and a checkpoint after every adaptation window
            # but the last, a checkpoint between sampling segments, the final
            if len(moved) != 11 or saves != [0] * 11 + [20, PT_SAMPLE]:
                raise AssertionError(f"evidence: rejuvenations {moved}, writes {saves}")
            want = 1 + 2 * steps + sum(n > 0 for n in moved)
            if launches["fused_lnl"] != want or launches["batched_conv_lnl"] != 0 \
                    or by_route["fused_lnl:fft"] != want:
                raise AssertionError(f"evidence: launches {launches} {by_route}; want "
                                     f"fused_lnl {want} on the FFT route")
            if device != "cpu" and [s.graph_replays for s in samplers] != [steps]:
                raise AssertionError(f"evidence: replays "
                                     f"{[s.graph_replays for s in samplers]}")
            db_file = out_name + "_db.fits"
            cards = {k: db.meta.get(k) for k in ("MCITER", "MCLNZ", "MCLNZERR",
                                                 "MCACCEPT")}
            ck = Table.read(db_file, format="fits", extname="CHECKPOINT")
            pay = load_checkpoint(db_file)
            log(f"evidence: cards {cards}; CHECKPOINT CKPTTEMP {ck.meta.get('CKPTTEMP')}, "
                f"CKPTEVID {ck.meta.get('CKPTEVID')}, columns {ck.colnames}; ladder "
                f"{np.array2string(pay['betas'], precision=4)}")
            if not (np.isfinite(cards["MCLNZ"]) and np.isfinite(cards["MCLNZERR"])
                    and ck.meta.get("CKPTTEMP") == PT_NTEMPS
                    and ck.meta.get("CKPTEVID") == PT_SAMPLE
                    and {"beta", "nswap", "evid_lnl_sum", "evid_lnl_sq_sum",
                         "evid_ss_max", "evid_ss_sum"} <= set(ck.colnames)
                    and pay["positions"].shape == (PT_NTEMPS, NWALKERS, 18)):
                raise AssertionError("evidence: the tempered database or checkpoint")
            # more iterations: the second call resumes every rung
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                db2 = fitting.model_galaxy_mcmc(model_file,
                                                **dict(kwargs, iterations=PT_RESUMED))
            pay2 = load_checkpoint(db_file)
            first_rows = np.arange(len(db2)).reshape(NWALKERS, PT_RESUMED)[:, :PT_SAMPLE]
            same = all(np.array_equal(np.asarray(db2[c])[first_rows.ravel()],
                                      np.asarray(db[c])) for c in db.colnames)
            log(f"evidence: a second call with iterations={PT_RESUMED} resumed "
                f"('Resuming from checkpoint' printed: "
                f"{'Resuming from checkpoint' in buf.getvalue()}), the first "
                f"{PT_SAMPLE} samples kept: {same}; CKPTEVID {pay2['evid_steps']}, "
                f"MCLNZ {db2.meta['MCLNZ']:.3f} +/- {db2.meta['MCLNZERR']:.3f}; "
                f"ladder kept: {np.array_equal(pay2['betas'], pay['betas'])}")
            if not ("Resuming from checkpoint" in buf.getvalue() and same
                    and pay2["evid_steps"] == PT_RESUMED and len(db2) == NWALKERS * PT_RESUMED
                    and np.array_equal(pay2["betas"], pay["betas"])
                    and np.isfinite(db2.meta["MCLNZ"])):
                raise AssertionError("evidence: the resumed tempered fit")
            if device != "cpu" and samplers[-1].graph_replays != PT_RESUMED - PT_SAMPLE:
                raise AssertionError(f"evidence: resumed replays {samplers[-1].graph_replays}")
            out["fit"] = {"wall_s": wall, "MCLNZ": cards["MCLNZ"],
                          "MCLNZERR": cards["MCLNZERR"]}
            out["fit_launches"] = first
        finally:
            fitting.PTEnsembleSampler.__init__ = init
            fitting.save_database = save_database
            fitting.PTEnsembleSampler.rejuvenate_stuck = rejuvenate
            del os.environ["PSFMC_LNPOST"]

        # the evidence of two model files of the same data (batched path)
        with open(model_file) as fh:
            text = fh.read()
        ps_file = os.path.join(tmp, "ps_model.py")
        with open(ps_file, "w") as fh:
            fh.write(text[:text.index(PS_MODEL_CUT)])
        results = {}
        for name, path in (("flagship", model_file), ("point source + sky", ps_file)):
            torch.cuda.synchronize()
            reset_counts(counted)
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                res = fitting.model_galaxy_evidence(
                    path, nwalkers=AIS_NWALKERS, nsteps=AIS_STEPS, groups=AIS_GROUPS,
                    sweeps=AIS_SWEEPS, seed=SEED, device=device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, by_route = read_counts(counted)
            for w in {str(w.message) for w in caught}:
                log(f"evidence: {name}: warns: {w}")
            log(f"evidence: model_galaxy_evidence({name}), {res.nwalkers} walkers in "
                f"{AIS_GROUPS} groups, {res.nsteps} steps x {AIS_SWEEPS} sweeps: lnZ "
                f"{res.lnz:.3f} +/- {res.err:.3f} (groups "
                f"{np.array2string(res.lnz_groups, precision=3)}), ESS {res.ess:.1f}, "
                f"acceptance {res.accept_fraction:.4f}, {res.nresample} resamplings; "
                f"{wall:.3f} s wall on the card ({CARD}); launches {launches}")
            half = AIS_NWALKERS // 2
            want = 1 + 2 * AIS_SWEEPS * res.nsteps
            if launches["batched_conv_lnl"] != want or by_route["batched_conv_lnl:fft"] != want:
                raise AssertionError(f"evidence: {name}: conv_lnl launches {by_route}, "
                                     f"want {want} at B = {half}")
            if name == "flagship" and launches["render_sersics"] != want:
                raise AssertionError(f"evidence: render launches {launches}")
            if device != "cpu" and res.graph_replays != res.nsteps:
                raise AssertionError(f"evidence: {res.graph_replays} of {res.nsteps} "
                                     "anneal steps were graph replays")
            if not (np.isfinite(res.lnz) and np.isfinite(res.err)):
                raise AssertionError(f"evidence: {name}: lnZ {res.lnz} +/- {res.err}")
            results[name] = {"lnz": res.lnz, "err": res.err, "wall_s": wall,
                             "launches": dict(launches, **by_route)}
        ln_b = results["flagship"]["lnz"] - results["point source + sky"]["lnz"]
        err_b = math.hypot(results["flagship"]["err"], results["point source + sky"]["err"])
        log(f"evidence: ln Bayes factor (flagship over point source + sky) "
            f"{ln_b:.3f} +/- {err_b:.3f}; the two anneals "
            f"{sum(r['wall_s'] for r in results.values()):.3f} s wall on the card "
            f"({CARD})")
        out["ais"] = results
        out["ln_bayes"] = [ln_b, err_b]
    return out


GENERAL_RTOL = 1e-4  # general-path lnpost (f32, GPU) vs the CPU's f64 general path
GENERAL_FLOOR = 1e-5  # ... with this share of the batch's largest |lnpost| as a floor
GENERAL_VARIANT_STEPS = 2  # burn and retained steps of each variant's segment
# the variants of the general phase: (label, general_components keywords,
# environment)
GENERAL_VARIANTS = (
    ("student", dict(likelihood="student", likelihood_df=4.0), {}),
    ("poisson", dict(likelihood="poisson", counts=True, noise_scale=False), {}),
    ("conv_pad=8", dict(conv_pad=8), {}),
    ("render_oversample=4, psf_oversample=2",
     dict(render_oversample=4, psf_oversample=2), {}),
    ("PSFMC_RENDER=pallas_tiled", {}, {"PSFMC_RENDER": "pallas_tiled"}),
    ("PSFMC_KAPPA=newton", {}, {"PSFMC_KAPPA": "newton"}),
)


def general_lnpost_check(post, spec, thetas, label, ref_lnpost="general"):
    """The card's lnpost of ``thetas`` against the CPU's float64 path
    ``ref_lnpost`` (the plain versions of its kernels; a joint spec takes
    each band's own path, and ``ref_lnpost`` must be None): the same
    non-finite entries, rtol :data:`GENERAL_RTOL` with a floor of
    :data:`GENERAL_FLOOR` of the batch's largest |lnpost| (a sum of pixel
    terms of both signs can cancel near 0 for one walker)."""
    import torch

    from psfmc_tpu_torch.models import JointPosteriorFns, build_posterior

    got = post.log_posterior_batch(thetas).double().cpu().numpy()
    if hasattr(spec, "band_specs"):
        ref = JointPosteriorFns(spec, device="cpu", dtype=torch.float64,
                                lnpost=ref_lnpost)
    else:
        ref = build_posterior(spec, device="cpu", dtype=torch.float64,
                              lnpost=ref_lnpost)
    want = ref.log_posterior_batch(torch.as_tensor(thetas).cpu().double()).numpy()
    fin = np.isfinite(want)
    if not np.array_equal(fin, np.isfinite(got)) or fin.sum() < len(want) // 2:
        raise AssertionError(f"{label}: the card and the CPU differ in which "
                             f"walkers are finite ({fin.sum()} finite on the CPU)")
    diff = np.abs(got[fin] - want[fin])
    scale = np.maximum(np.abs(want[fin]), GENERAL_FLOOR / GENERAL_RTOL
                       * np.abs(want[fin]).max())
    err = float(np.max(diff / scale))
    log(f"{label}: lnpost on the card vs the CPU's float64 "
        f"{ref_lnpost or 'per-band'} path, "
        f"{len(want)} walkers "
        f"({fin.sum()} finite): max rel diff {np.max(diff / np.abs(want[fin])):.3e}, "
        f"with the floor {err:.3e} (rtol {GENERAL_RTOL:g}, floor "
        f"{GENERAL_FLOOR:g} of the largest |lnpost|)")
    if not err <= GENERAL_RTOL:
        raise AssertionError(f"{label}: lnpost disagrees with the CPU's float64 "
                             f"{ref_lnpost} path")


def graphed_against_eager(post, spec, label, burn, sample, moves="stretch",
                          thin=1, track_moments=False, strand=False, routes=False):
    """One segment from one state as graph replays and through the
    sampler's private eager loop: every buffer, the chain and the
    generator's state bit-identical, the launch counts equal.  With
    ``strand``, a walker is stranded between two burn segments (moved
    outside its prior) and ``rejuvenate_stuck`` must move it back in both
    runs.  Returns the launches (by wrapper, and with ``routes`` by
    ``<wrapper>:<route>`` too) of one run."""
    import torch

    from psfmc_tpu_torch.flagship import prior_draws
    from psfmc_tpu_torch.sampler import EnsembleSampler
    from psfmc_tpu_torch.sampler.ensemble import _eager

    p0 = prior_draws(spec, NWALKERS, seed=SEED + 1)
    counted = counted_kernels()
    runs = {}
    for mode in ("graphed", "eager"):
        sm = EnsembleSampler(NWALKERS, spec.num_params, post, seed=SEED, moves=moves,
                             thin=thin, track_moments=track_moments)
        torch.cuda.synchronize()
        reset_counts(counted)
        with _eager(sm) if mode == "eager" else contextlib.nullcontext():
            sm.init_state(p0)
            sm.run_burn(burn)
            if strand:
                mag = next(s.offset for s in spec.slots
                           if s.name.endswith("_Sersic_mag"))
                pos = sm.state.positions.cpu().numpy()
                pos[7, mag] = 99.0  # outside its prior: lnp -inf
                sm._reseat(pos)
                moved = sm.rejuvenate_stuck(random_state=SEED)
                if moved != 1 or not bool(torch.isfinite(sm.state.log_prob).all()):
                    raise AssertionError(f"{label}: rejuvenate_stuck moved {moved} "
                                         "walkers, want the 1 stranded")
                sm.run_burn(burn)
            sm.reset()
            sm.run_sampling(sample)
        torch.cuda.synchronize()
        by_wrapper, by_route = read_counts(counted)
        runs[mode] = sm, (dict(by_wrapper, **by_route) if routes else by_wrapper)
    (g, g_counts), (e, e_counts) = runs["graphed"], runs["eager"]
    differ = differing_state(g, e)
    if differ:
        raise AssertionError(f"{label}: the graphed phase differs from the eager "
                             f"loop in {differ}")
    if g_counts != e_counts:
        raise AssertionError(f"{label}: launches {g_counts} graphed, {e_counts} eager")
    steps = burn * (2 if strand else 1) + sample
    replays = steps if post.device.type == "cuda" else 0
    if (g.graph_replays, e.graph_replays) != (replays, 0):
        raise AssertionError(f"{label}: replays {g.graph_replays} / {e.graph_replays}")
    extras = [f"thin {thin}"] + (["moments"] if track_moments else []) + (
        ["a walker stranded and rejuvenated between burn segments"] if strand else [])
    log(f"{label}: {NWALKERS} walkers, {steps} steps ({', '.join(extras)}): graph "
        f"replays and the eager loop bit-identical (positions, lnprob, chain, "
        f"accept counts, image accumulators and count, moments, generator "
        f"state); launches {g_counts} both; mean acceptance "
        f"{float(np.mean(g.acceptance_fraction)):.4f}")
    return g_counts


def general_phase(shape=(128, 128), psf_shape=(64, 64), device=None):
    """The general likelihood path at full width: the general flagship (two
    PSF stars and a sampled PSF_Index, a sky gradient, a NoiseScale) as
    files and a model file with a ``psf_files`` list, through
    ``model_galaxy_mcmc`` with ``PSFMC_LNPOST`` unset; then graphed against
    eager (and once with a walker rejuvenated), the steady steps, and the
    variants at small depth (the arguments shrink it for a rehearsal on
    the CPU).  Returns the render wrappers' launches of the fit's sampling
    and of the variants, and the general path's sampler."""
    from psfmc_tpu_torch.database import filter_lowp_walkers, load_database
    from psfmc_tpu_torch.flagship import general_components, write_general_files
    from psfmc_tpu_torch.io import fits
    from psfmc_tpu_torch.models import build_model_spec, build_posterior
    from psfmc_tpu_torch.ops.kernels.sersic_render import (
        render_sersics,
        render_sersics_plain,
    )
    from psfmc_tpu_torch.sampler import EnsembleSampler

    steps = BURN + SAMPLE
    env = {k: os.environ.pop(k) for k in ("PSFMC_LNPOST", "PSFMC_RENDER",
                                          "PSFMC_KAPPA") if k in os.environ}
    with tempfile.TemporaryDirectory() as tmp:
        model_file = write_general_files(tmp, shape, psf_shape)
        out = os.path.join(tmp, "out")
        db, sm, (sampling, _), (launches, _), moved, wall = counted_fit(
            model_file, out, device)
        mc_post = sm.fns
        spec = mc_post.spec
        timings = dict(db.phase_seconds)
        log(f"general: model_galaxy_mcmc on the general flagship ({spec.num_psfs} "
            f"PSFs, sky gradient, NoiseScale; {spec.num_params} parameters), "
            f"{NWALKERS} walkers, burn {BURN} + sampling {SAMPLE} in segments of "
            f"{CHECKPOINT}: {wall:.3f} s wall; phases " + ", ".join(
                f"{k} {v:.3f} s" for k, v in timings.items()))
        if mc_post.lnpost != "general":
            raise AssertionError(f"the general flagship took lnpost="
                                 f"{mc_post.lnpost!r} with PSFMC_LNPOST unset")
        # init: one full-ensemble render; every step: one per half-ensemble;
        # every retained step: one for the image means; every rejuvenation
        # that moved walkers: one full-ensemble render
        want = {"render_sersics": 1 + 2 * steps + SAMPLE + sum(n > 0 for n in moved),
                "render_sersics_tiled": 0, "batched_conv_lnl": 0, "fused_lnl": 0}
        # the image writer: the MAP sample, the MCPPCP draws (one batch
        # each) and, where the stuck-walker filter dropped rows, the
        # replayed means in chunks of 2048 rows
        kept = len(filter_lowp_walkers(db, percentile=10))
        replay = 0 if kept == NWALKERS * SAMPLE else -(-kept // 2048)
        images = {k: launches[k] - sampling[k] for k in launches}
        want_images = dict(want, render_sersics=2 + replay)
        log(f"general: launches of the sampling {sampling}, of the image writer "
            f"{images}; walkers moved by each rejuvenation {moved}")
        if sampling != want or images != want_images:
            raise AssertionError(f"general launches {sampling} / {images}: want "
                                 f"{want} / {want_images}")
        if device != "cpu" and sm.graph_replays != steps:
            raise AssertionError(f"general: {sm.graph_replays} of {steps} steps "
                                 "were graph replays")
        lnp = sm.lnprobability
        acc = float(np.mean(sm.acceptance_fraction))
        if lnp.shape != (NWALKERS, SAMPLE) or not np.all(np.isfinite(lnp)) \
                or not np.all(np.isfinite(sm.chain)):
            raise AssertionError("general: non-finite or misshapen chain")
        if not 0.02 < acc < 0.9:
            raise AssertionError(f"general: mean acceptance {acc} outside (0.02, 0.9)")
        table = load_database(out + "_db.fits")
        if "PSF_Index" not in table.colnames or table["PSF_Index"].dtype != np.float64:
            raise AssertionError(f"general: no float64 PSF_Index column in "
                                 f"{table.colnames}")
        best = int(np.argmax(table["lnprobability"]))
        map_psf = f"psf{int(np.rint(table['PSF_Index'][best]))}.fits"
        used = np.bincount(np.clip(np.rint(table["PSF_Index"]).astype(int), 0, 1),
                           minlength=2)
        for ftype in IMAGE_TYPES:
            img = fits.getdata(f"{out}_{ftype}.fits")
            hdr = fits.getheader(f"{out}_{ftype}.fits")
            if img.shape != tuple(shape) or not np.all(np.isfinite(img)):
                raise AssertionError(f"general: image {ftype}: {img.shape}")
            if hdr.get("PSFIMG") != map_psf or "MCCHI2NU" not in hdr:
                raise AssertionError(f"general: image {ftype} names PSF "
                                     f"{hdr.get('PSFIMG')}, the MAP sample's is "
                                     f"{map_psf}")
        log(f"general: every one of the {steps} steps was a CUDA graph replay; "
            f"mean acceptance {acc:.4f}; PSF_Index column, samples on PSF 0 / 1: "
            f"{used.tolist()}; five images finite, PSFIMG {map_psf} (the MAP "
            f"sample's), MCCHI2NU {hdr['MCCHI2NU']}, MCPPCP {hdr.get('MCPPCP')}")
        general_lnpost_check(mc_post, spec, sm.state.positions[:16], "general")
    for k, v in env.items():
        os.environ[k] = v

    graphed_against_eager(mc_post, spec, "general graph", GRAPH_BURN, GRAPH_SAMPLE)
    graphed_against_eager(mc_post, spec, "general rejuvenation", GRAPH_BURN // 2,
                          GRAPH_SAMPLE // 2, strand=True)
    fresh = EnsembleSampler(NWALKERS, spec.num_params, mc_post, seed=SEED)
    fresh.init_state(sm.state.positions)
    steady_phase(fresh, "general path (lnpost='general')")

    variant_launches = {}
    for label, kw, variant_env in GENERAL_VARIANTS:
        os.environ.update(variant_env)
        try:
            vspec = build_model_spec(general_components(shape, psf_shape, **kw))
            vpost = build_posterior(vspec, device=device, lnpost="general")
            th = prior_draws_general(vspec, 16)
            general_lnpost_check(vpost, vspec, th, f"general variant {label}")
            if vpost.pad:  # the render kernel on the padded grid
                params, sky = vpost.render_inputs(th)
                got = render_sersics(params.contiguous(), sky.contiguous(),
                                     vpost.render_shape)
                _, rel, _ = compare(got, render_sersics_plain(
                    params.contiguous(), sky.contiguous(), vpost.render_shape))
                log(f"general variant {label}: render kernel on the padded "
                    f"{vpost.render_shape[0]}x{vpost.render_shape[1]} grid vs "
                    f"plain: max rel err {rel:.3e} (tol {RENDER_TOL:g})")
                if not rel <= RENDER_TOL:
                    raise AssertionError("the padded-grid render disagrees")
            got = graphed_against_eager(vpost, vspec, f"general variant {label}",
                                        GENERAL_VARIANT_STEPS, GENERAL_VARIANT_STEPS)
        finally:
            for k in variant_env:
                del os.environ[k]
        tiled = "PSFMC_RENDER" in variant_env
        name = "render_sersics_tiled" if tiled else "render_sersics"
        want = {"render_sersics": 0, "render_sersics_tiled": 0,
                "batched_conv_lnl": 0, "fused_lnl": 0}
        want[name] = 1 + 2 * 2 * GENERAL_VARIANT_STEPS + GENERAL_VARIANT_STEPS
        if got != want:
            raise AssertionError(f"general variant {label}: launches {got}, want {want}")
        for k, v in got.items():
            variant_launches[k] = variant_launches.get(k, 0) + v
    return sampling, variant_launches, fresh


# the environment each family variant runs under: the fused kernel for the
# elliptical bulge + disk, the tiled render on the general path
FAMILY_ENV = {"fused": {"PSFMC_LNPOST": "pallas"},
              "general": {"PSFMC_RENDER": "pallas_tiled"}}
# the family flagship's trace columns in the JAX package's layout: the
# bulge and the disk are centred on the point source, so neither has an
# xy column
FAMILY_COLUMNS = [
    "0_Sky_adu", "1_PointSource_mag", "1_PointSource_xy", "2_DeVaucouleurs_angle",
    "2_DeVaucouleurs_mag", "2_DeVaucouleurs_reff", "2_DeVaucouleurs_reff_b",
    "3_ExpDisk_angle", "3_ExpDisk_c0", "3_ExpDisk_mag", "3_ExpDisk_reff",
    "3_ExpDisk_reff_b", "3_ExpDisk_rsoft", "3_ExpDisk_rtrunc"]


def family_launches(lnpost, burn, sample, moved=0, tiled=False):
    """The launches of ``init_state`` + ``burn`` + ``sample`` steps on a
    path: init one full-ensemble evaluation, every step one per
    half-ensemble, every retained step one render for the image means,
    every rejuvenation that moved walkers one full-ensemble evaluation."""
    evals = 1 + 2 * (burn + sample) + moved
    want = {"render_sersics": 0, "render_sersics_tiled": 0, "batched_conv_lnl": 0,
            "fused_lnl": 0}
    render = "render_sersics_tiled" if tiled else "render_sersics"
    if lnpost == "fused":
        want.update(fused_lnl=evals, render_sersics=sample)
    else:
        want[render] = evals + sample
        if lnpost == "batched":
            want["batched_conv_lnl"] = evals
    return want


def family_phase(shape=(128, 128), psf_shape=(64, 64), device=None):
    """The render family at full width: the family flagship (Sky +
    PointSource + a de Vaucouleurs bulge and a boxy, truncated exponential
    disk, both tied to the point source) written as FITS files and a model
    file that imports ``DeVaucouleurs``, ``ExpDisk`` and ``Tied``, through
    ``model_galaxy_mcmc`` with ``PSFMC_LNPOST`` unset (the batched path:
    the bulge a row of the render kernel, the disk plain PyTorch inside
    the step's graph, the likelihood on conv_lnl); then graphed against
    eager, the steady steps, and each variant of
    ``psfmc_tpu_torch.flagship.FAMILY_VARIANTS`` at 2 + 2 steps (the
    arguments shrink it for a rehearsal on the CPU).  Returns the
    launches of the fit's sampling and of the variants, and a sampler on
    the family path."""
    from psfmc_tpu_torch.database import load_database
    from psfmc_tpu_torch.flagship import (
        FAMILY_VARIANTS,
        family_components,
        family_lnpost,
        write_family_files,
    )
    from psfmc_tpu_torch.io import fits
    from psfmc_tpu_torch.models import build_model_spec, build_posterior
    from psfmc_tpu_torch.ops.kernels.conv_lnl import conv_route
    from psfmc_tpu_torch.sampler import EnsembleSampler

    t_phase = time.perf_counter()
    steps = BURN + SAMPLE
    env = {k: os.environ.pop(k) for k in ("PSFMC_LNPOST", "PSFMC_RENDER",
                                          "PSFMC_KAPPA") if k in os.environ}
    with tempfile.TemporaryDirectory() as tmp:
        model_file = write_family_files(tmp, shape, psf_shape)
        out = os.path.join(tmp, "out")
        db, sm, (sampling, by_route), _, moved, wall = counted_fit(model_file, out,
                                                                  device)
        mc_post = sm.fns
        spec = mc_post.spec
        timings = dict(db.phase_seconds)
        log(f"family: model_galaxy_mcmc on the family flagship (bulge + boxy "
            f"truncated disk + AGN, {spec.num_params} parameters), {NWALKERS} "
            f"walkers, burn {BURN} + sampling {SAMPLE} in segments of "
            f"{CHECKPOINT}: {wall:.3f} s wall; phases " + ", ".join(
                f"{k} {v:.3f} s" for k, v in timings.items()))
        if mc_post.lnpost != "batched":
            raise AssertionError(f"the family flagship took lnpost="
                                 f"{mc_post.lnpost!r} with PSFMC_LNPOST unset")
        want = family_launches("batched", BURN, SAMPLE, sum(n > 0 for n in moved))
        log(f"family: launches of the sampling {sampling}, by route {by_route}; "
            f"walkers moved by each rejuvenation {moved}")
        route = conv_route(shape)
        other = "dft" if route == "fft" else "fft"
        if sampling != want or by_route[f"batched_conv_lnl:{route}"] != want[
                "batched_conv_lnl"] or by_route[f"batched_conv_lnl:{other}"] != 0:
            raise AssertionError(f"family launches {sampling}, by route {by_route}: "
                                 f"want {want}, every conv_lnl on the {route} route")
        if device != "cpu" and sm.graph_replays != steps:
            raise AssertionError(f"family: {sm.graph_replays} of {steps} steps "
                                 "were graph replays")
        lnp = sm.lnprobability
        acc = float(np.mean(sm.acceptance_fraction))
        if lnp.shape != (NWALKERS, SAMPLE) or not np.all(np.isfinite(lnp)) \
                or not np.all(np.isfinite(sm.chain)):
            raise AssertionError("family: non-finite or misshapen chain")
        if not 0.02 < acc < 0.9:
            raise AssertionError(f"family: mean acceptance {acc} outside (0.02, 0.9)")
        table = load_database(out + "_db.fits")
        if table.colnames != FAMILY_COLUMNS + ["lnprobability", "walker", "sample"] \
                or spec.param_names != FAMILY_COLUMNS:
            raise AssertionError(f"family: database columns {table.colnames}, want "
                                 f"the JAX layout {FAMILY_COLUMNS}")
        for ftype in IMAGE_TYPES:
            img = fits.getdata(f"{out}_{ftype}.fits")
            if img.shape != tuple(shape) or not np.all(np.isfinite(img)):
                raise AssertionError(f"family: image {ftype}: {img.shape}")
        log(f"family: every one of the {steps} steps was a CUDA graph replay; mean "
            f"acceptance {acc:.4f}; database columns the JAX layout (no column for "
            f"the tied xy of the bulge and the disk); five images "
            f"{shape[0]}x{shape[1]} finite")
        general_lnpost_check(mc_post, spec, sm.state.positions[:16], "family",
                             ref_lnpost="batched")
    for k, v in env.items():
        os.environ[k] = v

    graphed_against_eager(mc_post, spec, "family graph", GRAPH_BURN, GRAPH_SAMPLE)
    fresh = EnsembleSampler(NWALKERS, spec.num_params, mc_post, seed=SEED)
    fresh.init_state(sm.state.positions)
    steady_phase(fresh, "family path (lnpost='batched')")

    variant_launches = {}
    for variant in FAMILY_VARIANTS[1:]:
        lnpost = family_lnpost(variant)
        variant_env = FAMILY_ENV.get(variant, {})
        os.environ.update(variant_env)
        try:
            vspec = build_model_spec(family_components(shape, psf_shape, variant))
            vpost = build_posterior(vspec, device=device)
            if vpost.lnpost != lnpost:
                raise AssertionError(f"family variant {variant} took lnpost="
                                     f"{vpost.lnpost!r}, want {lnpost!r}")
            th = prior_draws_general(vspec, 16)
            general_lnpost_check(vpost, vspec, th, f"family variant {variant} "
                                 f"(lnpost={lnpost!r})", ref_lnpost=lnpost)
            got = graphed_against_eager(vpost, vspec, f"family variant {variant}",
                                        GENERAL_VARIANT_STEPS, GENERAL_VARIANT_STEPS)
        finally:
            for k in variant_env:
                del os.environ[k]
        want = family_launches(lnpost, GENERAL_VARIANT_STEPS, GENERAL_VARIANT_STEPS,
                               tiled="PSFMC_RENDER" in variant_env)
        if got != want:
            raise AssertionError(f"family variant {variant}: launches {got}, want {want}")
        for k, v in got.items():
            variant_launches[k] = variant_launches.get(k, 0) + v
    log(f"family: the phase took {time.perf_counter() - t_phase:.1f} s")
    sampling.update(by_route)
    return sampling, variant_launches, fresh


# every prior family of the port at the JAX package's test grids
# (``tests/test_distributions.py``'s cases, in its order: alias, scipy
# keyword arguments, grid as ("linspace", a, b, n), ("arange", a, b, step)
# or the points), then the aliases those cases lack
PRIOR_CASES = [
    ("Uniform", dict(loc=2.0, scale=3.0), ("linspace", 1.5, 5.5, 31)),
    ("Normal", dict(loc=0.0, scale=0.01), ("linspace", -0.05, 0.05, 21)),
    ("WeibullMinimum", dict(c=1.5, scale=4), ("linspace", 0.01, 15.0, 31)),
    ("WeibullMaximum", dict(c=2.0, scale=3.0), ("linspace", -10.0, 1.0, 23)),
    ("DiscreteUniform", dict(low=0, high=3), (-1.0, 0.0, 1.0, 2.0, 2.4, 3.0,)),
    ("Gamma", dict(a=2.5, scale=1.3), ("linspace", 0.01, 9.0, 17)),
    ("Beta", dict(a=2.0, b=3.0), ("linspace", 0.01, 0.99, 17)),
    ("LogNormal", dict(s=0.8, scale=2.0), ("linspace", 0.05, 9.0, 17)),
    ("TruncatedNormal", dict(a=-1.0, b=2.0, loc=0.5, scale=2.0), ("linspace", -2.0, 5.0, 23)),
    ("Cauchy", dict(loc=1.0, scale=2.0), ("arange", -5.0, 6.0, 1.0)),
    ("T", dict(df=4.0), ("arange", -5.0, 6.0, 1.0)),
    ("Poisson", dict(mu=3.0), ("arange", 0.0, 10.0, 1.0)),
    ("GumbelRight", dict(loc=1.0, scale=2.0), ("arange", -4.0, 9.0, 1.0)),
    ("GumbelLeft", dict(loc=1.0, scale=2.0), ("arange", -8.0, 5.0, 1.0)),
    ("Logistic", dict(loc=0.0, scale=1.5), ("arange", -6.0, 7.0, 1.0)),
    ("VonMises", dict(kappa=2.0), ("linspace", -3.0, 3.0, 13)),
    ("Triangular", dict(c=0.3, loc=1.0, scale=4.0), ("linspace", 0.5, 5.5, 17)),
    ("HalfNormal", dict(scale=2.0), ("linspace", -1.0, 5.0, 13)),
    ("Exponential", dict(scale=3.0), ("arange", -1.0, 10.0, 1.0)),
    ("Laplace", dict(loc=1.0, scale=0.5), ("linspace", -3.0, 5.0, 13)),
    ("ChiSquared", dict(df=3.0), ("linspace", 0.1, 9.0, 11)),
    ("InverseGamma", dict(a=3.0, scale=2.0), ("linspace", 0.1, 5.0, 11)),
    ("Rayleigh", dict(scale=2.0), ("linspace", -1.0, 8.0, 11)),
    ("Pareto", dict(b=2.5), ("linspace", 0.5, 6.0, 11)),
    ("PowerLaw", dict(a=1.7), ("linspace", -0.2, 1.2, 11)),
    ("Maxwell", dict(scale=1.5), ("linspace", -1.0, 6.0, 11)),
    ("Wald", dict(), ("linspace", 0.05, 5.0, 11)),
    ("Binomial", dict(n=10, p=0.3), ("arange", 0.0, 11.0, 1.0)),
    ("Geometric", dict(p=0.4), ("arange", 0.0, 8.0, 1.0)),
    ("Bernoulli", dict(p=0.7), ("arange", -1.0, 3.0, 1.0)),
    ("Arcsine", dict(), ("linspace", -0.2, 1.2, 13)),
    ("TruncatedExponential", dict(b=2.0, scale=1.5), ("linspace", -1.0, 4.0, 13)),
    ("Alpha", dict(a=2.0), ("linspace", 0.05, 3.0, 17)),
    ("Anglit", dict(loc=0.5, scale=2.0), ("linspace", -1.5, 2.5, 17)),
    ("Bradford", dict(c=1.7), ("linspace", -0.2, 1.2, 17)),
    ("Burr3", dict(c=2.0, d=1.5), ("linspace", 0.05, 4.0, 17)),
    ("Burr12", dict(c=2.0, d=1.5), ("linspace", 0.05, 4.0, 17)),
    ("Chi", dict(df=3.0), ("linspace", 0.05, 4.0, 17)),
    ("Cosine", dict(), ("linspace", -4.0, 4.0, 17)),
    ("DoubleGamma", dict(a=1.7), ("linspace", -4.0, 4.0, 17)),
    ("DoubleGamma", dict(a=0.7), ("linspace", -4.0, 4.0, 16)),
    ("DoubleWeibull", dict(c=2.0), ("linspace", -3.0, 3.0, 17)),
    ("ExponentialNormal", dict(K=1.5), ("linspace", -4.0, 8.0, 17)),
    ("ExponentialWeibull", dict(a=2.0, c=1.5), ("linspace", 0.05, 4.0, 17)),
    ("ExponentialPower", dict(b=1.8), ("linspace", -0.2, 2.0, 17)),
    ("F", dict(dfn=5.0, dfd=7.0), ("linspace", 0.05, 5.0, 17)),
    ("FatigueLife", dict(c=0.8), ("linspace", 0.05, 5.0, 17)),
    ("Fisk", dict(c=2.2), ("linspace", 0.05, 5.0, 17)),
    ("FoldedCauchy", dict(c=1.5), ("linspace", -0.5, 6.0, 17)),
    ("FoldedNormal", dict(c=1.5), ("linspace", -0.5, 6.0, 17)),
    ("GeneralLogistic", dict(c=2.0), ("linspace", -5.0, 5.0, 17)),
    ("GeneralNormal", dict(beta=1.5), ("linspace", -4.0, 4.0, 17)),
    ("HalfGeneralNormal", dict(beta=1.5), ("linspace", -0.5, 4.0, 17)),
    ("GeneralPareto", dict(c=0.5), ("linspace", -0.5, 5.0, 17)),
    ("GeneralPareto", dict(c=-0.5), ("linspace", -0.5, 2.5, 17)),
    ("GeneralPareto", dict(c=0.0), ("linspace", -0.5, 5.0, 17)),
    ("GeneralExtreme", dict(c=0.3), ("linspace", -4.0, 3.0, 17)),
    ("GeneralExtreme", dict(c=-0.3), ("linspace", -3.0, 6.0, 17)),
    ("GeneralExtreme", dict(c=0.0), ("linspace", -3.0, 6.0, 17)),
    ("GeneralExponential", dict(a=1.5, b=2.0, c=1.0), ("linspace", -0.5, 4.0, 17)),
    ("GeneralGamma", dict(a=2.0, c=1.5), ("linspace", 0.05, 4.0, 17)),
    ("GeneralGamma", dict(a=2.0, c=-1.5), ("linspace", 0.05, 4.0, 17)),
    ("GeneralHalfLogistic", dict(c=0.7), ("linspace", -0.2, 1.6, 17)),
    ("Gilbrat", dict(), ("linspace", 0.05, 6.0, 17)),
    ("Gompertz", dict(c=1.2), ("linspace", -0.5, 3.0, 17)),
    ("HalfLogistic", dict(), ("linspace", -0.5, 5.0, 17)),
    ("HyperbolicSecant", dict(), ("linspace", -5.0, 5.0, 17)),
    ("InverseGaussian", dict(mu=1.3), ("linspace", 0.05, 5.0, 17)),
    ("InverseWeibull", dict(c=2.0), ("linspace", 0.05, 5.0, 17)),
    ("JohnsonSB", dict(a=1.0, b=2.0), ("linspace", -0.2, 1.2, 17)),
    ("JohnsonSU", dict(a=1.0, b=2.0), ("linspace", -5.0, 5.0, 17)),
    ("Kappa3", dict(a=1.5), ("linspace", 0.05, 5.0, 17)),
    ("Levy", dict(), ("linspace", 0.05, 8.0, 17)),
    ("LevyLeft", dict(), ("linspace", -8.0, -0.05, 17)),
    ("LogGamma", dict(c=1.5), ("linspace", -5.0, 2.0, 17)),
    ("LogLaplace", dict(c=1.8), ("linspace", 0.05, 4.0, 17)),
    ("Lomax", dict(c=2.0), ("linspace", -0.5, 5.0, 17)),
    ("Mielke", dict(k=2.0, s=1.5), ("linspace", 0.05, 5.0, 17)),
    ("Nakagami", dict(nu=1.5), ("linspace", 0.05, 3.0, 17)),
    ("PearsonType3", dict(skew=0.8), ("linspace", -3.0, 5.0, 17)),
    ("PearsonType3", dict(skew=-0.8), ("linspace", -5.0, 3.0, 17)),
    ("PearsonType3", dict(skew=0.0), ("linspace", -4.0, 4.0, 17)),
    ("PowerLogNormal", dict(c=2.0, s=0.8), ("linspace", 0.05, 4.0, 17)),
    ("PowerNormal", dict(c=2.0), ("linspace", -4.0, 4.0, 17)),
    ("RDistributed", dict(c=3.0), ("linspace", -1.2, 1.2, 17)),
    ("ReciprocalInverseGaussian", dict(mu=1.3), ("linspace", 0.05, 5.0, 17)),
    ("Rice", dict(b=2.0), ("linspace", -0.5, 6.0, 17)),
    ("Semicircular", dict(), ("linspace", -1.3, 1.3, 17)),
    ("SkewNormal", dict(a=3.0), ("linspace", -4.0, 4.0, 17)),
    ("Trapezoidal", dict(c=0.2, d=0.7), ("linspace", -0.2, 1.2, 17)),
    ("WrappedCauchy", dict(c=0.4), ("linspace", -1.0, 7.0, 17)),
    ("GaussHypergeometric", dict(a=1.5, b=2.0, c=1.0, z=0.5), ("linspace", -0.2, 1.2, 17)),
    ("NonCentralChiSquared", dict(df=3.0, nc=2.0), ("linspace", 0.05, 20.0, 23)),
    ("NonCentralChiSquared", dict(df=7.0, nc=40.0), ("arange", 1.0, 146.3181818181818, 6.318181818181818)),
    ("NonCentralF", dict(dfn=5.0, dfd=7.0, nc=2.0), ("linspace", 0.05, 8.0, 23)),
    ("NonCentralF", dict(dfn=2.0, dfd=30.0, nc=15.0), ("arange", 0.05, 31.361363636363635, 1.3613636363636363)),
    ("NonCentralT", dict(df=4.0, nc=1.5), ("linspace", -6.0, 10.0, 23)),
    ("NonCentralT", dict(df=2.0, nc=-3.0), ("linspace", -12.0, 6.0, 23)),
    ("Kappa4", dict(h=0.5, k=0.3), ("linspace", -3.0, 3.5, 23)),
    ("Kappa4", dict(h=-0.5, k=-0.3), ("linspace", -3.0, 6.0, 23)),
    ("Kappa4", dict(h=0.0, k=0.0), ("linspace", -3.0, 6.0, 23)),
    ("Skellam", dict(mu1=3.0, mu2=2.0), ("arange", -12.0, 16.0, 1.0)),
    ("Skellam", dict(mu1=40.0, mu2=10.0), ("arange", -10.0, 92.0, 3.0)),
    ("Boltzmann", dict(lambda_=0.7, N=10), ("arange", -1.0, 12.0, 1.0)),
    ("DiscreteLaplace", dict(a=0.8), ("arange", -6.0, 7.0, 1.0)),
    ("Hypergeometric", dict(M=20, n=7, N=12), ("arange", -1.0, 14.0, 1.0)),
    ("LogSeries", dict(p=0.6), ("arange", 0.0, 10.0, 1.0)),
    ("Planck", dict(lambda_=0.5), ("arange", -1.0, 10.0, 1.0)),
    ("Zipf", dict(a=2.5), ("arange", 0.0, 10.0, 1.0)),

    ("BetaPrime", dict(a=2.0, b=3.0), ("linspace", -0.5, 8.0, 17)),
    ("Erlang", dict(a=3, scale=1.5), ("linspace", -0.5, 9.0, 17)),
    ("HalfCauchy", dict(scale=2.0), ("linspace", -1.0, 8.0, 17)),
    ("KSOneSided", dict(n=20), ("linspace", -0.1, 1.1, 25)),
    ("KSTwoSided", dict(), ("linspace", -0.2, 3.0, 17)),
    ("LevyStable", dict(alpha=1.5, beta=0.3), ("linspace", -10.0, 10.0, 21)),
    ("NegativeBinomial", dict(n=3, p=0.4), ("arange", -1.0, 12.0, 1.0)),
    ("Reciprocal", dict(a=2.0, b=12.0), ("linspace", 1.0, 13.0, 17)),
    ("TukeyLambda", dict(lam=0.5), ("linspace", -3.0, 3.0, 23)),
    ("TukeyLambda", dict(lam=-0.5), ("linspace", -3.0, 3.0, 23)),
    ("TukeyLambda", dict(lam=0.14), ("linspace", -3.0, 3.0, 23)),
    ("TukeyLambda", dict(lam=0.0), ("linspace", -3.0, 3.0, 23)),
    ("TukeyLambda", dict(lam=-2.0), ("linspace", -3.0, 3.0, 23)),
    ("VonMisesLine", dict(kappa=2.0), ("linspace", -4.0, 4.0, 17)),
]
# vector hyperparameters: (alias, keyword arguments, rows of points); the
# first two are per-element tables, the third a closed form that
# broadcasts them
PRIOR_VECTOR_CASES = [
    ("KSOneSided", dict(n=np.array([20, 30])),
     ((0.2, 0.3), (0.05, 0.11), (-0.1, 1.2))),
    ("NonCentralChiSquared", dict(df=np.array([4.0, 6.0]), nc=np.array([2.0, 1.0])),
     ((3.0, 5.0), (0.5, 12.0), (-1.0, 40.0))),
    ("TruncatedNormal", dict(a=np.array([-1.0, -2.0]), b=np.array([2.0, 1.5]),
                             loc=np.array([64.5, 60.0]), scale=4.0),
     ((64.5, 60.0), (60.0, 52.0), (80.0, 65.0))),
]
PRIOR_F32_TOL = 1e-4  # |card float32 - CPU float64| / max(1, |CPU float64|)


def prior_grid(grid):
    """The points of a :data:`PRIOR_CASES` grid."""
    if grid and grid[0] == "linspace":
        return np.linspace(*grid[1:])
    if grid and grid[0] == "arange":
        return np.arange(*grid[1:])
    return np.asarray(grid, dtype=np.float64)


def prior_points(dist, grid):
    """A grid's points, the support's finite edges and points just and
    well outside them."""
    a, b = (float(v) for v in dist.rv_frozen.support())
    edges = [v for v in (a, b, a - 1e-9, b + 1e-9, a - 1.0, b + 1.0)
             if np.isfinite(v)]
    return np.concatenate([prior_grid(grid), edges])


def prior_family_phase(device=None):
    """Every prior family on the card: each :data:`PRIOR_CASES` entry (and
    the vector cases) evaluated in float64 and float32 on the card against
    the CPU (float64: rtol and atol 1e-8, the same infinite entries;
    float32: the CPU's float32 infinite entries and :data:`PRIOR_F32_TOL`
    of the CPU's float64); then one CUDA graph that evaluates all of them
    in float32, replayed and held bit for bit to the eager call; and a
    discrete family with vector hyperparameters refused by
    ``build_posterior`` on the card."""
    import torch

    from psfmc_tpu_torch import distributions as D

    device = torch.device(device or "cuda")
    t0 = time.perf_counter()
    cases, grids = [], []  # float32 runs on the grid: an edge point is
    # ill-conditioned there (cos(2z) near 0 for Anglit, ...)
    for alias, kw, grid in PRIOR_CASES:
        dist = D.from_name(alias, **kw)
        cases.append((f"{alias}{kw}", dist, prior_points(dist, grid)))
        grids.append(len(prior_grid(grid)))
    for alias, kw, rows in PRIOR_VECTOR_CASES:
        cases.append((f"{alias}{kw}", D.from_name(alias, **kw), np.asarray(rows)))
        grids.append(len(rows))
    covered = {type(d).__name__ for _, d, _ in cases}
    if covered != set(D.SCIPY_DIST_NAMES):
        raise AssertionError(f"prior families not evaluated: "
                             f"{sorted(set(D.SCIPY_DIST_NAMES) - covered)}")
    worst64 = worst32 = 0.0
    inputs = []
    for (label, dist, x_all), n_grid in zip(cases, grids):
        for dtype in (torch.float64, torch.float32):
            x = x_all if dtype == torch.float64 else x_all[:n_grid]
            ref = dist.torch_logp(torch.as_tensor(x, dtype=torch.float64)).numpy()
            ref32 = dist.torch_logp(torch.as_tensor(x, dtype=torch.float32)).numpy()
            xt = torch.as_tensor(x, dtype=dtype, device=device)
            params = dist.torch_params(dtype, device)
            got = dist.torch_logp(xt, params).double().cpu().numpy()
            if dtype == torch.float64:
                fin = np.isfinite(ref)
                same = np.array_equal(got[~fin], ref[~fin]) and np.all(np.isfinite(got[fin]))
                err = float(np.max(np.abs(got[fin] - ref[fin])
                                   / (1e-8 + 1e-8 * np.abs(ref[fin])), initial=0.0))
                worst64 = max(worst64, err)
                ok = same and err <= 1.0
            else:
                # the infinite entries are the CPU's float32 ones, the values
                # are held where both precisions are finite
                fin = np.isfinite(ref32)
                same = np.array_equal(got[~fin], ref32[~fin]) and np.all(np.isfinite(got[fin]))
                both = fin & np.isfinite(ref)
                err = float(np.max(np.abs(got[both] - ref[both])
                                   / np.maximum(1.0, np.abs(ref[both])), initial=0.0))
                worst32 = max(worst32, err)
                ok = same and err <= PRIOR_F32_TOL
                inputs.append((xt, params))
            if not ok:
                raise AssertionError(f"prior {label} on the card ({dtype}) differs "
                                     f"from the CPU: {got} vs {ref}")
    log(f"priors: {len(cases)} cases ({len(covered)} families, every alias) on the "
        f"card against the CPU: float64 (grids, support edges and beyond) worst "
        f"|diff| / (1e-8 + 1e-8 |ref|) {worst64:.3e} (<= 1), infinite entries "
        f"identical; float32 (grids) worst |diff| / max(1, |float64 ref|) "
        f"{worst32:.3e} (tol {PRIOR_F32_TOL:g}), infinite entries the CPU's float32")

    # one graph for every family: capture, replay, hold to the eager call
    def evaluate():
        return [dist.torch_logp(xt, params)
                for (_, dist, _), (xt, params) in zip(cases, inputs)]

    if device.type != "cuda":  # a rehearsal on the CPU: no graph
        log(f"priors: the family phase took {time.perf_counter() - t0:.1f} s")
        return
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        eager = evaluate()  # the warm-up outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = evaluate()
    for o in outs:
        o.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    differ = [label for (label, _, _), a, b in zip(cases, outs, eager)
              if not same_bits(a, b)]
    if differ:
        raise AssertionError(f"the replayed graph differs from the eager call for "
                             f"{differ}")
    replay_ms = time_ms(graph.replay, reps=5, inner=5)
    eager_ms = time_ms(evaluate, reps=3, inner=2)
    log(f"priors: one CUDA graph evaluates all {len(cases)} cases in float32; its "
        f"replay is bit-identical to the eager call; {replay_ms:.3f} ms a replay, "
        f"{eager_ms:.3f} ms eager")

    from psfmc_tpu_torch.flagship import priors_components
    from psfmc_tpu_torch.models import build_model_spec, build_posterior

    comps = priors_components((32, 32), (16, 16))
    comps[2].xy = D.Skellam(mu1=np.array([16.0, 16.0]), mu2=np.array([1.0, 2.0]))
    spec = build_model_spec(comps)
    try:
        build_posterior(spec, device=device)
    except NotImplementedError as err:
        log(f"priors: a discrete family with vector hyperparameters is refused on "
            f"the card at build_posterior: {err}")
    else:
        raise AssertionError("build_posterior took a host-callback prior on the card")
    log(f"priors: the family phase took {time.perf_counter() - t0:.1f} s")


# the priors flagship's trace columns in the JAX package's layout (the xy
# columns two wide)
PRIORS_COLUMNS = [
    "0_Sky_adu", "1_PointSource_mag", "1_PointSource_xy", "2_Sersic_angle",
    "2_Sersic_index", "2_Sersic_mag", "2_Sersic_reff", "2_Sersic_reff_b",
    "2_Sersic_xy", "3_Sersic_angle", "3_Sersic_index", "3_Sersic_mag",
    "3_Sersic_reff", "3_Sersic_reff_b", "3_Sersic_xy"]
# the priors phase's variants: (label, priors_components variant,
# environment, likelihood path)
PRIORS_VARIANTS = (
    ("stress", "stress", {}, "batched"),
    ("fused", "flagship", {"PSFMC_LNPOST": "pallas"}, "fused"),
    ("general", "general", {}, "general"),
)


def counted_fit(model_file, out, device):
    """``model_galaxy_mcmc`` on a model file with the kernels counted:
    returns the database, the sampler, the launches (by wrapper, by route)
    of the sampling (up to the image writer) and of the whole run, the
    walkers moved by each rejuvenation and the wall time."""
    import torch

    from psfmc_tpu_torch import fitting

    counted = counted_kernels()
    moved, samplers, at_images = [], [], []
    rejuvenate_stuck = fitting.EnsembleSampler.rejuvenate_stuck
    sampler_init = fitting.EnsembleSampler.__init__
    save_images = fitting.save_posterior_images
    save_joint_images = fitting._save_joint_images

    def counting_rejuvenate(self, *a, **k):
        moved.append(rejuvenate_stuck(self, *a, **k))
        return moved[-1]

    def kept_init(self, *a, **k):
        sampler_init(self, *a, **k)
        samplers.append(self)

    def counting_writer(writer):
        def images(*a, **k):  # the launches of sampling end here
            torch.cuda.synchronize()
            at_images.append(read_counts(counted))
            return writer(*a, **k)
        return images

    fitting.EnsembleSampler.rejuvenate_stuck = counting_rejuvenate
    fitting.EnsembleSampler.__init__ = kept_init
    fitting.save_posterior_images = counting_writer(save_images)
    fitting._save_joint_images = counting_writer(save_joint_images)
    try:
        torch.cuda.synchronize()
        reset_counts(counted)
        t0 = time.perf_counter()
        db = fitting.model_galaxy_mcmc(
            model_file, output_name=out, chains=NWALKERS, burn=BURN,
            iterations=SAMPLE, seed=SEED, device=device,
            checkpoint_interval=CHECKPOINT)
        wall = time.perf_counter() - t0
        total = read_counts(counted)
    finally:
        fitting.EnsembleSampler.rejuvenate_stuck = rejuvenate_stuck
        fitting.EnsembleSampler.__init__ = sampler_init
        fitting.save_posterior_images = save_images
        fitting._save_joint_images = save_joint_images
    (sm,) = samplers
    return db, sm, at_images[0], total, moved, wall


def priors_phase(shape=(128, 128), psf_shape=(64, 64), device=None):
    """The priors flagship at full width: written as FITS files and a model
    file that imports its priors from ``psfMC.distributions``, through
    ``model_galaxy_mcmc`` with ``PSFMC_LNPOST`` unset (the batched path,
    the priors plain PyTorch inside the step's graph); the API phase on
    its model file and database; graphed against eager, the steady steps;
    then the variants (the stress priors, the fused kernel, the general
    path) at 2 + 2 steps.  Returns the launches of the fit's sampling, of
    the API phase and of the variants, the priors sampler and a stress
    sampler."""
    from psfmc_tpu_torch.database import load_database
    from psfmc_tpu_torch.flagship import priors_components, write_priors_files
    from psfmc_tpu_torch.io import fits
    from psfmc_tpu_torch.models import build_model_spec, build_posterior
    from psfmc_tpu_torch.ops.kernels.conv_lnl import conv_route
    from psfmc_tpu_torch.sampler import EnsembleSampler

    t_phase = time.perf_counter()
    steps = BURN + SAMPLE
    env = {k: os.environ.pop(k) for k in ("PSFMC_LNPOST", "PSFMC_RENDER",
                                          "PSFMC_KAPPA") if k in os.environ}
    with tempfile.TemporaryDirectory() as tmp:
        model_file = write_priors_files(tmp, shape, psf_shape)
        out = os.path.join(tmp, "out")
        db, sm, (sampling, by_route), _, moved, wall = counted_fit(model_file, out,
                                                                  device)
        mc_post = sm.fns
        spec = mc_post.spec
        log(f"priors: model_galaxy_mcmc on the priors flagship (TruncatedNormal "
            f"positions with a vector loc, Reciprocal sizes, Gamma and "
            f"TruncatedNormal indices, Triangular and SkewNormal magnitudes; "
            f"{spec.num_params} parameters), {NWALKERS} walkers, burn {BURN} + "
            f"sampling {SAMPLE} in segments of {CHECKPOINT}: {wall:.3f} s wall; "
            "phases " + ", ".join(f"{k} {v:.3f} s" for k, v in db.phase_seconds.items()))
        if mc_post.lnpost != "batched":
            raise AssertionError(f"the priors flagship took lnpost={mc_post.lnpost!r} "
                                 "with PSFMC_LNPOST unset")
        want = family_launches("batched", BURN, SAMPLE, sum(n > 0 for n in moved))
        log(f"priors: launches of the sampling {sampling}, by route {by_route}; "
            f"walkers moved by each rejuvenation {moved}")
        route = conv_route(shape)
        other = "dft" if route == "fft" else "fft"
        if sampling != want or by_route[f"batched_conv_lnl:{route}"] != want[
                "batched_conv_lnl"] or by_route[f"batched_conv_lnl:{other}"] != 0:
            raise AssertionError(f"priors launches {sampling}, by route {by_route}: "
                                 f"want {want}, every conv_lnl on the {route} route")
        if device != "cpu" and sm.graph_replays != steps:
            raise AssertionError(f"priors: {sm.graph_replays} of {steps} steps "
                                 "were graph replays")
        lnp = sm.lnprobability
        acc = float(np.mean(sm.acceptance_fraction))
        if lnp.shape != (NWALKERS, SAMPLE) or not np.all(np.isfinite(lnp)) \
                or not np.all(np.isfinite(sm.chain)):
            raise AssertionError("priors: non-finite or misshapen chain")
        if not 0.02 < acc < 0.9:
            raise AssertionError(f"priors: mean acceptance {acc} outside (0.02, 0.9)")
        table = load_database(out + "_db.fits")
        widths = [np.asarray(table[c]).reshape(len(table), -1).shape[1]
                  for c in PRIORS_COLUMNS]
        if table.colnames != PRIORS_COLUMNS + ["lnprobability", "walker", "sample"] \
                or spec.param_names != PRIORS_COLUMNS or widths != spec.param_lens:
            raise AssertionError(f"priors: database columns {table.colnames} "
                                 f"(widths {widths}), want the JAX layout "
                                 f"{PRIORS_COLUMNS} (widths {spec.param_lens})")
        for ftype in IMAGE_TYPES:
            img = fits.getdata(f"{out}_{ftype}.fits")
            if img.shape != tuple(shape) or not np.all(np.isfinite(img)):
                raise AssertionError(f"priors: image {ftype}: {img.shape}")
        log(f"priors: every one of the {steps} steps was a CUDA graph replay; mean "
            f"acceptance {acc:.4f}; database columns the JAX layout (the xy columns "
            f"two wide); five images {shape[0]}x{shape[1]} finite")
        general_lnpost_check(mc_post, spec, sm.state.positions[:16], "priors",
                             ref_lnpost="batched")
        api_launches = api_phase(model_file, table, sm, device)
    for k, v in env.items():
        os.environ[k] = v

    graphed_against_eager(mc_post, spec, "priors graph", GRAPH_BURN, GRAPH_SAMPLE)
    fresh = EnsembleSampler(NWALKERS, spec.num_params, mc_post, seed=SEED)
    fresh.init_state(sm.state.positions)
    steady_phase(fresh, "priors path (lnpost='batched')")

    variant_launches, stress = {}, None
    for label, variant, variant_env, lnpost in PRIORS_VARIANTS:
        os.environ.update(variant_env)
        try:
            vspec = build_model_spec(priors_components(shape, psf_shape, variant))
            vpost = build_posterior(vspec, device=device)
            if vpost.lnpost != lnpost:
                raise AssertionError(f"priors variant {label} took lnpost="
                                     f"{vpost.lnpost!r}, want {lnpost!r}")
            th = prior_draws_general(vspec, 16)
            general_lnpost_check(vpost, vspec, th, f"priors variant {label} "
                                 f"(lnpost={lnpost!r})", ref_lnpost=lnpost)
            got = graphed_against_eager(vpost, vspec, f"priors variant {label}",
                                        GENERAL_VARIANT_STEPS, GENERAL_VARIANT_STEPS)
        finally:
            for k in variant_env:
                del os.environ[k]
        want = family_launches(lnpost, GENERAL_VARIANT_STEPS, GENERAL_VARIANT_STEPS)
        if got != want:
            raise AssertionError(f"priors variant {label}: launches {got}, want {want}")
        for k, v in got.items():
            variant_launches[k] = variant_launches.get(k, 0) + v
        if variant == "stress":
            stress = EnsembleSampler(NWALKERS, vspec.num_params, vpost, seed=SEED)
            stress.init_state(prior_draws_general(vspec, NWALKERS))
    log(f"priors: the phase took {time.perf_counter() - t_phase:.1f} s")
    sampling.update(by_route)
    return sampling, api_launches, variant_launches, fresh, stress


API_PRIOR_TOL = 1e-4  # |card float32 log-prior - host scipy| / max(1, |host|)


def api_phase(model_file, table, sm, device):
    """The reference's model API on the card: ``MultiComponentModel`` from
    the model file, ``param_values`` set to a prior draw, the host's scipy
    ``log_priors`` against ``log_prior_batch`` on the card,
    ``log_posterior`` against the CPU's float64 model, the five image
    methods (finite, and equal to ``render_images_batch``'s row),
    ``simulate``, and ``get_sampler_state`` of the fit's database against
    the sampler's last positions and lnprob.  Returns its launches."""
    import torch

    from psfmc_tpu_torch.database import get_sampler_state
    from psfmc_tpu_torch.models import MultiComponentModel

    counted = counted_kernels()
    torch.cuda.synchronize()
    reset_counts(counted)
    mc = MultiComponentModel(model_file, device=device)
    theta = mc.init_params_from_priors(1, random_state=SEED + 5)[0]
    mc.param_values = theta
    split = np.concatenate([np.ravel(v) for v in mc.param_values.values()])
    if not np.array_equal(split, theta) or any(
            not np.array_equal(np.ravel(c_.value), np.ravel(v)) for c_, v in (
                (mc.get_distribution(n), v) for n, v in mc.param_values.items())):
        raise AssertionError("api: param_values does not round-trip")
    host = mc.log_priors()
    card = float(mc.posterior_fns.log_prior_batch(theta[None])[0])
    if not abs(card - host) <= API_PRIOR_TOL * max(1.0, abs(host)):
        raise AssertionError(f"api: log_priors {host} on the host, {card} on the card")
    lnp, imgs = mc.log_posterior(theta)
    ref = MultiComponentModel(model_file, device="cpu", dtype=torch.float64)
    lnp_ref, _ = ref.log_posterior(theta)
    rel = abs(lnp - lnp_ref) / abs(lnp_ref)
    if not rel <= GENERAL_RTOL:
        raise AssertionError(f"api: log_posterior {lnp} on the card, {lnp_ref} on "
                             "the CPU in float64")
    row = {k: v[0] for k, v in mc.render_images_batch(theta[None]).items()}
    for name in IMAGE_TYPES:
        img = getattr(mc, name)()
        if not (np.all(np.isfinite(img)) and np.array_equal(img, row[name])
                and np.array_equal(imgs[name], row[name])):
            raise AssertionError(f"api: {name}() is not render_images_batch's row")
    mock, th = mc.simulate(theta, random_state=SEED)
    clean, _ = mc.simulate(theta, add_noise=False)
    if not (np.all(np.isfinite(mock)) and np.array_equal(th, theta)
            and np.array_equal(clean, row["convolved_model"])):
        raise AssertionError("api: simulate")
    pos, lnprob = get_sampler_state(table)
    if not (np.array_equal(pos, sm.chain[:, -1]) and
            np.array_equal(lnprob, sm.lnprobability[:, -1])):
        raise AssertionError("api: get_sampler_state is not the sampler's last state")
    thetas = mc.thetas_from_database(table)
    if thetas.shape != (len(table), mc.num_params):
        raise AssertionError(f"api: thetas_from_database {thetas.shape}")
    torch.cuda.synchronize()
    launches = read_counts(counted)[0]
    log(f"api: MultiComponentModel(model file) on the card: param_values "
        f"round-trips; log_priors {host:.6f} (host scipy) vs {card:.6f} "
        f"(log_prior_batch on the card, tol {API_PRIOR_TOL:g} relative); "
        f"log_posterior {lnp:.6f} vs {lnp_ref:.6f} on the CPU in float64 (rel "
        f"{rel:.3e}, tol {GENERAL_RTOL:g}); the five image methods finite and "
        f"render_images_batch's row; simulate finite, noiseless = the convolved "
        f"model; get_sampler_state = the sampler's last positions and lnprob; "
        f"thetas_from_database {thetas.shape}; launches {launches}")
    return launches


JOINT_ENV = {"tiled": {"PSFMC_RENDER": "pallas_tiled"}}
# the joint flagship's trace columns in the JAX package's layout: band 0's
# flagship, then band 1's sky, point-source magnitude and the Sersics' free
# angles and magnitudes (positions sky-tied, sizes and index pixel-tied)
JOINT_COLUMNS = [
    "0_Sky_adu", "1_PointSource_mag", "1_PointSource_xy", "2_Sersic_angle",
    "2_Sersic_index", "2_Sersic_mag", "2_Sersic_reff", "2_Sersic_reff_b",
    "2_Sersic_xy", "3_Sersic_angle", "3_Sersic_index", "3_Sersic_mag",
    "3_Sersic_reff", "3_Sersic_reff_b", "3_Sersic_xy", "5_Sky_adu",
    "6_PointSource_mag", "7_Sersic_angle", "7_Sersic_mag", "8_Sersic_angle",
    "8_Sersic_mag"]


def joint_launches(paths, burn, sample, moved=0, tiled=False):
    """The launches of ``init_state`` + ``burn`` + ``sample`` steps on a
    joint model whose bands take ``paths``: :func:`family_launches` of
    each band, summed."""
    want = {}
    for path in paths:
        band = family_launches(path, burn, sample, moved,
                               tiled=tiled and path == "general")
        want = {k: want.get(k, 0) + v for k, v in band.items()}
    return want


def joint_phase(shapes=None, psf_shape=(64, 64), device=None, radix7_band=None):
    """Joint multi-band fits at full width: the joint flagship (band 0 the
    flagship at 128x128 with a TAN WCS, band 1 a 96x96 observation with
    its own PSF star and a WCS rotated by 20 degrees, its sources sky-tied
    to band 0's; 24 parameters) written as FITS files and a model file with
    two Configurations, through ``model_galaxy_mcmc`` with ``PSFMC_LNPOST``
    unset: both bands on the batched path and on conv_lnl's FFT route,
    band 0's on the radix-2 geometry and band 1's on the mixed-radix one,
    in one captured step.  Then a second call that skips sampling and
    writes the products from the checkpoint, graphed against eager, the
    steady steps with the device's busy time, and each variant of
    ``psfmc_tpu_torch.flagship.JOINT_VARIANTS`` at 2 + 2 steps, the
    ``offset`` variant with band 1 at ``radix7_band`` (98x98 = 7^2 x 2), so
    that conv_lnl's FFT route with radix-7 stages runs inside a captured
    step (the arguments shrink it for a rehearsal on the CPU).  Returns the launches
    of the fit's sampling and of the variants (by wrapper and route), band
    1's conv_lnl timed on the fit's walkers, and a sampler on the joint
    path."""
    import zlib

    import torch

    from psfmc_tpu_torch import fitting
    from psfmc_tpu_torch.database import load_database
    from psfmc_tpu_torch.flagship import (
        JOINT_SHAPES,
        JOINT_VARIANTS,
        joint_components,
        write_joint_files,
    )
    from psfmc_tpu_torch.io import fits
    from psfmc_tpu_torch.models import JointModel
    from psfmc_tpu_torch.ops.kernels.conv_lnl import (
        batched_conv_lnl,
        batched_conv_lnl_plain,
        conv_route,
    )
    from psfmc_tpu_torch.sampler import EnsembleSampler

    shapes = JOINT_SHAPES if shapes is None else shapes
    radix7_band = RADIX7_SHAPE if radix7_band is None else radix7_band
    t_phase = time.perf_counter()
    steps = BURN + SAMPLE
    geometries = [fft_geometry(shape) for shape in (*shapes, radix7_band)]
    if geometries != ["radix2", "mixed", "radix7"]:
        raise AssertionError(f"joint bands {shapes} and the offset variant's band 1 "
                             f"{radix7_band} take conv_lnl's {geometries}, want the "
                             "FFT route's radix2, mixed and radix7 geometries")
    env = {k: os.environ.pop(k) for k in ("PSFMC_LNPOST", "PSFMC_RENDER",
                                          "PSFMC_KAPPA") if k in os.environ}
    with tempfile.TemporaryDirectory() as tmp:
        model_file = write_joint_files(tmp, shapes, psf_shape)
        out = os.path.join(tmp, "out")
        db, sm, (sampling, by_route), _, moved, wall = counted_fit(model_file, out,
                                                                  device)
        mc_post = sm.fns
        spec = mc_post.spec
        log(f"joint: model_galaxy_mcmc on the joint flagship (two bands, "
            f"{shapes[0][0]}x{shapes[0][1]} and {shapes[1][0]}x{shapes[1][1]}, "
            f"sky-tied sources; {spec.num_params} parameters), {NWALKERS} "
            f"walkers, burn {BURN} + sampling {SAMPLE} in segments of "
            f"{CHECKPOINT}: {wall:.3f} s wall; phases " + ", ".join(
                f"{k} {v:.3f} s" for k, v in db.phase_seconds.items()))
        if mc_post.lnpost != ("batched", "batched"):
            raise AssertionError(f"the joint flagship's bands took {mc_post.lnpost} "
                                 "with PSFMC_LNPOST unset")
        evals = 1 + 2 * steps + sum(n > 0 for n in moved)
        want = joint_launches(("batched", "batched"), BURN, SAMPLE,
                              sum(n > 0 for n in moved))
        log(f"joint: launches of the sampling {sampling}, by route {by_route}; "
            f"walkers moved by each rejuvenation {moved}")
        if sampling != want or by_route["batched_conv_lnl:fft"] != 2 * evals \
                or by_route["batched_conv_lnl:mixed"] != evals \
                or by_route["batched_conv_lnl:dft"] != 0:
            raise AssertionError(f"joint launches {sampling}, by route {by_route}: "
                                 f"want {want}, {2 * evals} conv_lnl launches on "
                                 f"the FFT route, {evals} of them band 1's on the "
                                 "mixed-radix geometry")
        if device != "cpu" and sm.graph_replays != steps:
            raise AssertionError(f"joint: {sm.graph_replays} of {steps} steps "
                                 "were graph replays")
        lnp = sm.lnprobability
        acc = float(np.mean(sm.acceptance_fraction))
        if lnp.shape != (NWALKERS, SAMPLE) or not np.all(np.isfinite(lnp)) \
                or not np.all(np.isfinite(sm.chain)):
            raise AssertionError("joint: non-finite or misshapen chain")
        if not 0.02 < acc < 0.9:
            raise AssertionError(f"joint: mean acceptance {acc} outside (0.02, 0.9)")
        table = load_database(out + "_db.fits")
        if table.colnames != JOINT_COLUMNS + ["lnprobability", "walker", "sample"] \
                or spec.param_names != JOINT_COLUMNS or spec.num_params != 24:
            raise AssertionError(f"joint: database columns {table.colnames}, want "
                                 f"the JAX layout {JOINT_COLUMNS} (24 values)")
        products = {}
        for band, shape in enumerate(shapes):
            for ftype in IMAGE_TYPES:
                name = f"{out}_b{band}_{ftype}.fits"
                products[name] = fits.getdata(name)
                if products[name].shape != tuple(shape) \
                        or not np.all(np.isfinite(products[name])):
                    raise AssertionError(f"joint: image {name}: "
                                         f"{products[name].shape}")
        datsum, first = 0, None
        for bs in spec.band_specs:
            for arr in (bs.obs_data, bs.obs_var):
                datsum = zlib.crc32(np.ascontiguousarray(arr).tobytes(), datsum)
            first = datsum if first is None else first
        if int(table.meta["MCDATSUM"]) != datsum or datsum == first:
            raise AssertionError(f"joint: MCDATSUM {table.meta['MCDATSUM']} is not "
                                 f"the crc32 of both bands' data ({datsum})")
        log(f"joint: every one of the {steps} steps was a CUDA graph replay; mean "
            f"acceptance {acc:.4f}; database columns the JAX layout; MCDATSUM "
            f"covers both bands; five images per band "
            f"({shapes[0][0]}x{shapes[0][1]}, {shapes[1][0]}x{shapes[1][1]}) finite")
        general_lnpost_check(mc_post, spec, sm.state.positions[:16], "joint",
                             ref_lnpost=None)

        # a second call: the database is complete, sampling is skipped and
        # the products come from the checkpoint's mixed-shape accumulators
        for name in products:
            os.remove(name)
        counted = counted_kernels()
        reset_counts(counted)
        again = fitting.model_galaxy_mcmc(
            model_file, output_name=out, chains=NWALKERS, burn=BURN,
            iterations=SAMPLE, seed=SEED, device=device,
            checkpoint_interval=CHECKPOINT)
        launched = read_counts(counted)[0]
        if len(again) != len(table) or any(launched.values()):
            raise AssertionError(f"joint: the second call ran {launched}")
        for name, data in products.items():
            if not np.array_equal(fits.getdata(name), data):
                raise AssertionError(f"joint: {name} from the checkpoint differs")
        log("joint: a second call skipped sampling (no launch) and wrote the ten "
            "products from the checkpoint's mixed-shape accumulators, equal to "
            "the first call's")
    for k, v in env.items():
        os.environ[k] = v

    # band 1's conv_lnl on the mixed-radix FFT route at the fit's walkers
    band = mc_post.band_fns[1]
    raws = band.raw_and_ps(sm.state.positions[:B_HALF])[0].contiguous()
    _, rel, frac = compare(batched_conv_lnl(raws, band.consts),
                           batched_conv_lnl_plain(raws, band.consts))
    if not rel <= CONV_LNL_TOL or frac < 0.5:
        raise AssertionError(f"joint: band 1's conv_lnl disagrees with its plain "
                             f"version ({rel:.3e}, finite share {frac})")
    on_path = {"joint_ms": time_ms(lambda: batched_conv_lnl(raws, band.consts)),
               "joint_plain_ms": time_ms(
                   lambda: batched_conv_lnl_plain(raws, band.consts)),
               "joint_max_rel_err": rel}
    log(f"joint: band 1's conv_lnl ({shapes[1][0]}x{shapes[1][1]}, mixed-radix "
        f"FFT route, {B_HALF} of the fit's walkers): {on_path['joint_ms']:.4f} ms, "
        f"plain {on_path['joint_plain_ms']:.4f} ms, max rel err {rel:.3e}")

    graphed_against_eager(mc_post, spec, "joint graph", GRAPH_BURN, GRAPH_SAMPLE)
    fresh = EnsembleSampler(NWALKERS, spec.num_params, mc_post, seed=SEED)
    fresh.init_state(sm.state.positions)
    steady_phase(fresh, "joint path (bands 'batched', 'batched')")
    if device != "cpu":
        for mode in ("graphed", "eager"):
            got = profile_steps(fresh, STEADY, eager=mode == "eager")
            log(f"joint: retained step, {mode}: {got['wall_ms']:.3f} ms wall, "
                f"device busy {got['busy_ms']:.3f} ms, {got['kernels']:.0f} kernels, "
                f"idle share {got['idle_share']:.3f}")

    variant_launches = {}
    for variant in JOINT_VARIANTS[1:]:
        variant_env = JOINT_ENV.get(variant, {})
        paths = (("general", "general") if variant in ("general", "tiled")
                 else ("batched", "batched"))
        vshapes = (shapes[0], radix7_band) if variant == "offset" else shapes
        os.environ.update(variant_env)
        try:
            vmodel = JointModel(joint_components(vshapes, psf_shape, variant),
                                device=device)
            vpost, vspec = vmodel.posterior_fns, vmodel.spec
            if vpost.lnpost != paths:
                raise AssertionError(f"joint variant {variant}: bands took "
                                     f"{vpost.lnpost}, want {paths}")
            th = prior_draws_general(vspec, 16)
            general_lnpost_check(vpost, vspec, th, f"joint variant {variant} "
                                 f"(bands {paths})", ref_lnpost=None)
            got = graphed_against_eager(vpost, vspec, f"joint variant {variant}",
                                        GENERAL_VARIANT_STEPS, GENERAL_VARIANT_STEPS,
                                        routes=True)
        finally:
            for k in variant_env:
                del os.environ[k]
        want = joint_launches(paths, GENERAL_VARIANT_STEPS, GENERAL_VARIANT_STEPS,
                              tiled="PSFMC_RENDER" in variant_env)
        by_wrapper = {k: v for k, v in got.items() if ":" not in k}
        # the offset variant: both bands on the FFT route, band 1 with
        # radix-7 stages
        per_band = (1 + 4 * GENERAL_VARIANT_STEPS) * (paths[0] == "batched")
        if by_wrapper != want or got["batched_conv_lnl:fft"] != 2 * per_band \
                or got["batched_conv_lnl:fft:radix7"] != per_band \
                or got["batched_conv_lnl:dft"] != 0 \
                or got["batched_conv_lnl:mixed"] != 0:
            raise AssertionError(f"joint variant {variant} ({vshapes}): launches "
                                 f"{got}, want {want} and {per_band} a band on the "
                                 "FFT route, band 1's with radix-7 stages")
        for k, v in got.items():
            variant_launches[k] = variant_launches.get(k, 0) + v
    log(f"joint: the phase took {time.perf_counter() - t_phase:.1f} s")
    sampling.update(by_route)
    return sampling, variant_launches, on_path, fresh


# -- phase 14: the gradient path -------------------------------------------

MAP_STARTS, MAP_STEPS = 64, 500  # fit_map's defaults, the MAP path's depth
MAP_SHORT_STEPS = 50  # the joint MAPs with band 1 at 98x98, 74x74 and 94x94
MAP_EQUAL_STEPS = 5  # graphed against eager
GRAD_POINTS = 64
GRAD_RTOL = 1e-3  # ||g_card - g_cpu|| / ||g_cpu|| per point, the CPU in float64
MAP_LNP_RTOL = 1e-4  # lnpost at the MAP: the card's float32 against the CPU's float64
MAP_FIT_ATOL = 0.5  # the card's best lnpost against the CPU's float64 fit from its start
MAP_PS_XY_TOL = 0.1  # px: the point source's position against the truth
MAP_HOST_XY_TOL = 0.5  # px: the host's, which shares the point source's centre
LAPLACE_RTOL = 0.05  # the card's Laplace std against the CPU's float64, per parameter
RENDER_BWD_TOL = 1e-4  # per walker and packed scalar, of its largest gradient,
RENDER_BWD_PLAIN = 4  # ... or this many times the float32 plain version's error
CONV_BWD_TOL = 1e-3  # per walker, of its largest pixel gradient
CONV_RES_TOL = 1e-6  # the residual forward's weights, per walker and part, of the
CONV_RES_PLAIN = 4  # largest weight, or this many times the float32 plain scheme's
# One pixel of one Sersic in the render's backward (csrc/
# sersic_render_backward.cu): the forward's 31 operations again and 44 of
# the vector-Jacobian product, each expf, logf and reciprocal counted as
# one, and ten accumulations; 4 special-function results (the two ex2 of
# the expf and the two reciprocals; logf is a polynomial of FMAs).
RENDER_BWD_OPS_PER_PIXEL = 31 + 44 + 10
RENDER_BWD_SFU_PER_PIXEL = 4
# The residual forward's weights a and c per pixel (csrc/fft_conv.cuh,
# RESID): a multiply for a, four multiplies and a subtraction for c.
RES_OPS_PER_PIXEL = 6
# The FFT-route backward's combine per pixel: the two scales, 2 raw gc + ga
# and the walker's gradient.
BWD_COMBINE_OPS_PER_PIXEL = 5


def grad_kernels():
    """The wrappers the gradient path launches: the render and conv_lnl,
    each with its backward kernel."""
    from psfmc_tpu_torch.ops.kernels.conv_lnl import (
        batched_conv_lnl,
        batched_conv_lnl_backward,
    )
    from psfmc_tpu_torch.ops.kernels.sersic_render import (
        render_sersics,
        render_sersics_backward,
    )

    return (render_sersics, render_sersics_backward, batched_conv_lnl,
            batched_conv_lnl_backward)


def normalized_err(got, want, dims):
    """max |got - want| over ``dims`` over max |want| there, the largest
    over the rest (``want`` in float64)."""
    num = (got.double() - want).abs().amax(dim=dims)
    return (num / want.abs().amax(dim=dims).clamp(min=1e-300)).max().item()


def render_backward_err(got, plain, want):
    """(largest normalized error, largest error over its bound): per
    walker and packed scalar, the largest error over the Sersics over the
    largest gradient there; the bound is the larger of
    :data:`RENDER_BWD_TOL` and :data:`RENDER_BWD_PLAIN` times the float32
    plain version's own normalized error (``want`` in float64)."""
    scale = want.abs().amax(dim=1).clamp(min=1e-300)
    err = (got.double() - want).abs().amax(dim=1) / scale
    plain_err = (plain.double() - want).abs().amax(dim=1) / scale
    bound_ = (plain_err * RENDER_BWD_PLAIN).clamp(min=RENDER_BWD_TOL)
    return err.max().item(), (err / bound_).max().item()


def same_nonfinite(got, want):
    import torch

    if not (torch.equal(torch.isfinite(got), torch.isfinite(want))
            and torch.equal(torch.isnan(got), torch.isnan(want))):
        raise AssertionError("a backward kernel and its plain version differ "
                             "in non-finite entries")


def render_backward_check(params, sky, shape, grad, label):
    """The render's backward kernel at ``params``' batch (its cluster
    layout, ``backward_strips``) against its plain version: the same
    non-finite entries; per walker and packed scalar within its bound of
    the float64 scheme (:func:`render_backward_err`), the sky's within
    :data:`RENDER_BWD_TOL`; at least half the walkers compared (a float32
    profile may overflow where float64's does not); the same bits on two
    launches.  Returns the kernel's output, the float32 plain version's
    and the errors."""
    import torch

    from psfmc_tpu_torch.ops.kernels import sersic_render as SR

    b = params.shape[0]
    got = SR.render_sersics_backward(params, sky, shape, grad)
    plain = SR.render_sersics_backward_plain(params, sky, shape, grad)
    for g, w in zip(got, plain):
        same_nonfinite(g, w)
    p64, s64 = SR.render_sersics_backward_plain(params.double(), sky.double(), shape,
                                                grad.double())
    keep = torch.isfinite(p64).all(dim=(1, 2)) & torch.isfinite(got[0]).all(dim=(1, 2))
    abs_err = (got[0][keep].double() - p64[keep]).abs().max().item()
    err, excess = render_backward_err(got[0][keep], plain[0][keep], p64[keep])
    sky_err = normalized_err(got[1][keep][:, None], s64[keep][:, None], dims=(1,))
    strips = SR.backward_strips(b, shape)
    log(f"{label}: {b} walkers, strips x pixels per strip {strips}: max normalized err "
        f"{err:.3e}, at most {excess:.3f} of its bound (max({RENDER_BWD_TOL:g}, "
        f"{RENDER_BWD_PLAIN}x the float32 plain version's)), sky {sky_err:.3e}, "
        f"walkers compared {int(keep.sum())}")
    if not (excess <= 1.0 and sky_err <= RENDER_BWD_TOL and keep.sum().item() >= b // 2):
        raise AssertionError(f"{label}: the render's backward kernel disagrees with "
                             "its plain version")
    again = SR.render_sersics_backward(params, sky, shape, grad)
    if not all(same_bits(x, y) for x, y in zip(again, got)):
        raise AssertionError(f"{label}: the render's backward: two launches differ")
    return got, plain, dict(max_abs_err=abs_err, max_normalized_err=err,
                            bound_share=excess, sky_normalized_err=sky_err,
                            strips=list(strips))


def grad_batch_check(post, thetas, label, seed, norm_scale=False, f64=False):
    """The gradient path's kernels at the batch ``thetas`` gives them (a
    NUTS leaf's: 8 chains, or 16 rows of the marginalized potential), each
    against its plain version: the forwards (:func:`batch_kernel_check`;
    the render alone off the batched path); on the batched path conv_lnl's
    residual forward (:func:`residual_check`) and its backward from those
    residuals at the leaf's upstream gradient (dU/dlnL = -1), within
    :data:`CONV_BWD_TOL` of the float64 scheme; the render's backward
    (:func:`render_backward_check`) in this batch's cluster layout, at the
    conv_lnl backward's image gradient (the leaf's), else at a normal one."""
    import torch

    from psfmc_tpu_torch.models import build_posterior
    from psfmc_tpu_torch.ops.kernels import conv_lnl as CL

    b = thetas.shape[0]
    shape = post.render_shape
    params, sky = (t.contiguous() for t in post.render_inputs(thetas))
    c64 = (build_posterior(post.spec, device="cpu", dtype=torch.float64,
                           lnpost="batched").consts
           if post.grad_mode == "batched" else None)
    out = batch_kernel_check(post, thetas, label, norm_scale=norm_scale,
                             c64=c64 if f64 else None)
    if post.grad_mode == "batched":
        raws = post.raw_and_ps(thetas)[0].contiguous()
        consts = post.consts
        lnl = CL.batched_conv_lnl(raws, consts)
        residuals, keep, out["conv_lnl_res"] = residual_check(
            raws, consts, c64, lnl, f"{label}: conv_lnl's residual forward at B = {b}")
        up = torch.full((b,), -1.0, dtype=torch.float32, device=raws.device)
        got = CL.batched_conv_lnl_backward(raws, consts, lnl, up, residuals)
        same_nonfinite(got, CL.batched_conv_lnl_backward_plain(raws, consts, lnl, up))
        want = CL.batched_conv_lnl_backward_plain(
            raws.double().cpu(), c64, lnl.double().cpu(), up.double().cpu()).to(raws.device)
        err = normalized_err(got[keep], want[keep], dims=(1, 2))
        log(f"{label}: conv_lnl's backward at B = {b}: max normalized err {err:.3e} "
            f"(tol {CONV_BWD_TOL:g}), walkers compared {int(keep.sum())}")
        if not err <= CONV_BWD_TOL:
            raise AssertionError(f"{label}: conv_lnl's backward disagrees with its "
                                 f"plain version at B = {b}")
        out["conv_lnl_backward"] = dict(
            max_abs_err=(got[keep].double() - want[keep]).abs().max().item(),
            max_normalized_err=err)
        grad = got.contiguous()
    else:
        grad = torch.as_tensor(np.random.RandomState(seed).randn(b, *shape),
                               dtype=torch.float32, device=params.device)
    out["render_backward"] = render_backward_check(
        params, sky, shape, grad, f"{label}: render backward at B = {b}")[2]
    return out


def backward_rows(post, spec):
    """Rows (a)-(c): each backward kernel against its plain version on the
    card at 125 walkers, with its times and bound: the render's at the
    flagship's 128x128 and at 45x37, conv_lnl's on the FFT route at
    128x128 (radix 2), 96x96 (mixed radix) and 98x98 (the same with
    radix-7 stages), on the padded route at 74x74 (the matmul-DFT route
    timed on the same inputs at all three), each after the row of the
    forward's residual instantiation that it reads (:func:`residual_row`)
    and with the pair's time, and on the matmul-DFT route at 94x94."""
    import torch

    from psfmc_tpu_torch.flagship import flagship_components, prior_draws
    from psfmc_tpu_torch.models import build_model_spec, build_posterior
    from psfmc_tpu_torch.ops.kernels import _build
    from psfmc_tpu_torch.ops.kernels import sersic_render as SR

    rows = []
    rng = np.random.RandomState(SEED + 5)

    def inputs(s):
        p = build_posterior(s, device=post.device, lnpost="batched")
        th = torch.as_tensor(prior_draws(s, B_HALF, seed=SEED + 6),
                             dtype=torch.float32, device=post.device)
        return p, th

    # (a) the render's backward
    ragged_spec = build_model_spec(flagship_components(RAGGED_SHAPE, RAGGED_PSF_SHAPE))
    timed = {}
    for s_, label in ((spec, "main"), (ragged_spec, "ragged")):
        p, th = inputs(s_)
        params, sky = (t.contiguous() for t in p.render_inputs(th))
        grad = torch.as_tensor(rng.randn(B_HALF, *s_.shape), dtype=torch.float32,
                               device=post.device)
        errs = render_backward_check(params, sky, s_.shape, grad,
                                     f"render backward, {s_.shape[0]}x{s_.shape[1]}")[2]
        timed[label] = (errs["max_normalized_err"], errs["max_abs_err"],
                        time_ms(lambda: SR.render_sersics_backward(
                            params, sky, s_.shape, grad)),
                        time_ms(lambda: SR.render_sersics_backward_plain(
                            params, sky, s_.shape, grad)), (params, sky, grad))
    err, abs_err, ms, plain_ms, (params, sky, grad) = timed["main"]
    b, s, _ = params.shape
    h, w = spec.shape
    starts = MAP_STARTS  # the Adam step's batch, checked and timed
    at_starts = render_backward_check(params[:starts], sky[:starts], spec.shape,
                                      grad[:starts], "render backward at the MAP starts")[2]
    ms_starts = time_ms(lambda: SR.render_sersics_backward(
        params[:starts], sky[:starts], spec.shape, grad[:starts]))
    log(f"render backward: strips x pixels per strip {SR.backward_strips(b, spec.shape)} "
        f"at {b} walkers, {SR.backward_strips(starts, spec.shape)} at {starts} "
        f"({ms_starts:.4f} ms)")
    bms, by, term = bound(4 * (params.numel() + sky.numel() + grad.numel()
                               + params.numel() + b),
                          b * h * w * (s * RENDER_BWD_OPS_PER_PIXEL + 1),
                          b * h * w * s * RENDER_BWD_SFU_PER_PIXEL)
    rows.append(dict(
        name="sersic_render_backward", route="cuda",
        source=_build.source_path("sersic_render_backward"),
        replaces="psfmc_tpu/ops/pallas/sersic_pallas.py:102 (its gradient)",
        launches=0, max_abs_err=abs_err, max_normalized_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bms, bound_by=by, bound_term=term,
        library_ms=None, ragged_ms=timed["ragged"][2], map_starts_ms=ms_starts,
        map_starts_normalized_err=at_starts["max_normalized_err"],
        ragged_normalized_err=timed["ragged"][0]))

    # (b), (c) conv_lnl's backward on every route; off the matmul-DFT route
    # it reads what the forward's residual instantiation wrote (rows
    # conv_lnl_res*)
    mixed_spec = build_model_spec(flagship_components(MIXED_SHAPE, MIXED_PSF_SHAPE))
    radix7_spec = build_model_spec(flagship_components(RADIX7_SHAPE, RADIX7_PSF_SHAPE))
    padded_spec = build_model_spec(flagship_components(PADDED_SHAPE, PADDED_PSF_SHAPE))
    cluster_spec = build_model_spec(flagship_components(CLUSTER_SHAPE, CLUSTER_PSF_SHAPE))
    for s_, route, name in ((spec, "fft", "conv_lnl_backward"),
                            (mixed_spec, "fft", "conv_lnl_backward_mixed"),
                            (radix7_spec, "fft", "conv_lnl_backward_radix7"),
                            (padded_spec, "padded", "conv_lnl_backward_padded"),
                            (cluster_spec, "cluster", "conv_lnl_backward_cluster")):
        rows += conv_backward_rows(s_, route, name, post.device, rng)
    for r in rows:
        log(f"{r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.5f} ms by {r['bound_by']} ({r['bound_term']}), "
            f"{r['ms'] / r['bound_ms']:.1f}x the bound; library {r['library_ms']}, "
            f"matmul-DFT route on the same inputs {r.get('dft_route_ms')}"
            + (f"; the padded transform's own bound {r['transform_bound_ms']:.5f} ms"
               if "transform_bound_ms" in r else "")
            + (f"; forward + backward (Adam pair) {r['pair_ms']:.4f} ms, bound "
               f"{r['pair_bound_ms']:.5f} ms ({r['pair_bound_term']})"
               if "pair_ms" in r else "")
            + (f"; the forward without residuals {r['forward_ms']:.4f} ms"
               if "forward_ms" in r else "") + ")")
    return rows


def conv_backward_rows(spec, route, name, device, rng, f64_device="cpu"):
    """conv_lnl's backward at ``spec``'s shape on ``route`` at
    :data:`B_HALF` walkers (the flagship at prior draws), against its
    plain version (within :data:`CONV_BWD_TOL` of the float64 one, the same
    non-finite entries, the same bits on a second launch), with its times
    and bound and, off the matmul-DFT route, the matmul-DFT route's time on
    the same inputs and the Adam step's pair; preceded there by the row of
    the forward's residual instantiation that it reads
    (:func:`residual_row`).  The float64 plain versions run on
    ``f64_device`` (the CPU; the card at the global route's sizes).
    Returns those rows."""
    import torch

    from psfmc_tpu_torch.flagship import prior_draws
    from psfmc_tpu_torch.models import build_posterior
    from psfmc_tpu_torch.ops import convolve, gaussian_lnlike
    from psfmc_tpu_torch.ops.kernels import _build
    from psfmc_tpu_torch.ops.kernels import conv_lnl as CL

    rows = []
    p = build_posterior(spec, device=device, lnpost="batched")
    th = torch.as_tensor(prior_draws(spec, B_HALF, seed=SEED + 6), dtype=torch.float32,
                         device=device)
    raws = p.raw_and_ps(th)[0].contiguous()
    consts = p.consts
    lnl = CL.batched_conv_lnl(raws, consts)
    grad = torch.as_tensor(rng.uniform(0.5, 2.0, B_HALF), dtype=torch.float32,
                           device=device)
    if CL.conv_route(spec.shape) != route:
        raise AssertionError(f"{spec.shape} does not take the {route} route")
    c64 = build_posterior(spec, device="cpu", dtype=torch.float64,
                          lnpost="batched").consts
    if f64_device != "cpu":  # the card's posterior is float32: move its constants
        c64 = CL.ConvLnlConsts(**{f.name: getattr(c64, f.name).to(f64_device)
                                  for f in dataclasses.fields(c64)})
    hh, ww = spec.shape
    n = B_HALF * hh * ww
    spectra_bytes = 4 * sum(t.numel() for t in (
        consts.psf_r, consts.psf_i, consts.var_r, consts.var_i))
    data_bytes = spectra_bytes + 4 * sum(t.numel() for t in (
        consts.obs, consts.obs_var, consts.good_f))
    f_psf = torch.as_tensor(spec.f_psf_stack[0], device=device).to(torch.complex64)
    f_var = torch.as_tensor(spec.f_var_stack[0], device=device).to(torch.complex64)
    residuals = None
    if route != "dft":
        geometry = fft_geometry(spec.shape)
        res_row, residuals = residual_row(
            "conv_lnl_res" + ("" if geometry == "radix2" else f"_{geometry}"),
            raws, consts, c64, lnl, f_psf, f_var, data_bytes)
        rows.append(res_row)
    routes = dict(CL.batched_conv_lnl_backward.route_launches)
    got = CL.batched_conv_lnl_backward(raws, consts, lnl, grad, residuals)
    routes[route] += 1
    if CL.batched_conv_lnl_backward.route_launches != routes:
        raise AssertionError(f"{name} did not launch on the {route} route")
    plain = CL.batched_conv_lnl_backward_plain(raws, consts, lnl, grad)
    same_nonfinite(got, plain)
    want = CL.batched_conv_lnl_backward_plain(
        raws.double().to(f64_device), c64, lnl.double().to(f64_device),
        grad.double().to(f64_device)).to(device)
    keep = torch.isfinite(lnl)
    abs_err = (got[keep].double() - want[keep]).abs().max().item()
    err = normalized_err(got[keep], want[keep], dims=(1, 2))
    plain_err = normalized_err(plain[keep], want[keep], dims=(1, 2))
    log(f"{name}: max normalized err {err:.3e} (tol {CONV_BWD_TOL:g}; float32 "
        f"plain {plain_err:.3e}), walkers compared {int(keep.sum())}")
    if not (err <= CONV_BWD_TOL and keep.sum().item() >= B_HALF // 2):
        raise AssertionError(f"{name} disagrees with its plain version")
    if not same_bits(got, CL.batched_conv_lnl_backward(raws, consts, lnl, grad,
                                                       residuals)):
        raise AssertionError(f"{name}: two launches differ")

    def library():  # autograd through the torch.fft formulation, a yardstick
        x = raws.detach().requires_grad_(True)
        with torch.enable_grad():
            out = gaussian_lnlike(consts.obs - convolve(x, f_psf),
                                  1.0 / (convolve(x * x, f_var) + consts.obs_var),
                                  consts.good)
            return torch.autograd.grad(out, x, grad)[0]

    if route != "dft":  # one pair: the weights, the raw image,
        # the gradient (the function's bound at the image's size)
        bms, by, term = bound(16 * n + spectra_bytes + 12 * B_HALF,
                              B_HALF * 2 * fft_conv_ops(hh, ww)
                              + BWD_COMBINE_OPS_PER_PIXEL * n)
    else:  # the forward pair again, the adjoint pair, the weights, the combine
        bms, by, term = bound(8 * raws.numel() + data_bytes + 8 * B_HALF,
                              2 * conv_lnl_ops(B_HALF, hh, ww) + 12 * n)
    rows.append(dict(
        name=name, route="cuda", source=_build.source_path("conv_lnl_backward"),
        replaces="psfmc_tpu/ops/pallas/lnpost_batched.py:191 (its gradient)",
        launches=0, max_abs_err=abs_err, max_normalized_err=err,
        ms=time_ms(lambda: CL.batched_conv_lnl_backward(raws, consts, lnl, grad,
                                                        residuals)),
        plain_ms=time_ms(lambda: CL.batched_conv_lnl_backward_plain(
            raws, consts, lnl, grad)),
        bound_ms=bms, bound_by=by, bound_term=term, library_ms=time_ms(library),
        library="torch.autograd through torch.fft convolutions of the forward",
        conv_route=route))
    if route in ("padded", "cluster", "global"):  # the transform's own pair
        mh, mw = consts.padded_shape
        rows[-1].update(transform_shape=[mh, mw], transform_bound_ms=bound(
            0, B_HALF * 2 * fft_conv_ops(mh, mw))[0])
    if route == "global":  # the route's own traffic through its scratch
        rows[-1].update(global_route_plan(B_HALF, (hh, ww), "backward", spectra_bytes))
        rows[0].update(global_route_plan(B_HALF, (hh, ww), "residuals", data_bytes))
        # what the MAP's step ran at this shape before: the matmul-DFT forward
        rows[0]["dft_route_ms"] = time_ms(lambda: CL._launch(raws, consts, "dft"))
        rows[0]["dft_route_what"] = "conv_lnl's matmul-DFT forward (no residuals)"
    if route != "dft":  # the Adam step's pair: the residual forward, the backward
        def pair():
            l_, *r_ = CL.batched_conv_lnl_residuals(raws, consts)
            return CL.batched_conv_lnl_backward(raws, consts, l_, grad, r_)

        if not same_bits(pair(), got):
            raise AssertionError(f"{name}: the pair differs from the backward")
        rows[-1]["pair_ms"] = time_ms(pair)
        rows[-1]["pair_bound_ms"], _, rows[-1]["pair_bound_term"] = bound(
            8 * n + data_bytes + 8 * B_HALF,
            conv_lnl_ops(B_HALF, hh, ww) + RES_OPS_PER_PIXEL * n
            + B_HALF * 2 * fft_conv_ops(hh, ww) + BWD_COMBINE_OPS_PER_PIXEL * n)
        # the matmul-DFT route on the same inputs
        dft = CL._launch_backward(raws, consts, lnl, grad, "dft")
        dft_err = normalized_err(dft[keep], want[keep], dims=(1, 2))
        if not dft_err <= CONV_BWD_TOL:
            raise AssertionError(f"{name}: the matmul-DFT route disagrees "
                                 f"({dft_err:.3e})")
        rows[-1]["dft_route_ms"] = time_ms(
            lambda: CL._launch_backward(raws, consts, lnl, grad, "dft"))
    return rows


def global_route_plan(b, shape, kind, data_bytes):
    """The global route's plan at ``b`` walkers of ``shape`` (its transform
    and tiles) and the least time of its own traffic (``route_bound_ms``):
    the bytes it moves through device memory, each input read and each
    output written as its launches do, over the memory rate.  Its scratch
    S of ``(B, H, M_w)`` float2 (the transform's rows) exceeds the L2 at
    the route's sizes: the row passes write it, the column passes read and
    write it, the last row passes read it (4 sweeps).  ``kind``:
    ``"forward"`` (the raw images read twice: the peaks and the row
    passes), ``"residuals"`` (also the weights written, 8 bytes a pixel),
    ``"fused"`` (the render pass writes the raw images, the row passes
    read them), ``"backward"`` (the weights and the raw images read, the
    gradient written)."""
    from psfmc_tpu_torch.ops.kernels import conv_lnl as CL

    h, w = shape
    mh, mw = CL.padded_shape(shape)
    rows, cols = CL.global_tiles(shape)
    px = b * h * w
    sweeps = 4 * 8 * b * h * mw
    nbytes = sweeps + data_bytes + {"forward": 8 * px + 4 * b,
                                    "residuals": 16 * px + 8 * b,
                                    "fused": 8 * px + 4 * b,
                                    "backward": 16 * px + 12 * b}[kind]
    return dict(transform_shape=[mh, mw], global_tiles=[rows, cols],
                scratch_bytes=8 * b * h * mw, route_bytes=nbytes,
                route_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)


def residual_check(raws, consts, c64, lnl, name):
    """The residual instantiation of conv_lnl's forward at ``raws`` (FFT or
    padded route) against its plain scheme: the same lnL bits as the
    forward kernel's ``lnl``; its weights against the float64 plain scheme
    within the larger of :data:`CONV_RES_TOL` of each walker's largest
    weight and :data:`CONV_RES_PLAIN` times the float32 plain scheme's own
    error; each walker's scale exponent within one of the float64
    scheme's; the same bits on two launches.  Returns ``(weights,
    scale_exp)``, the walkers compared and their errors."""
    import torch

    from psfmc_tpu_torch.ops.kernels import conv_lnl as CL

    b, h, w = raws.shape
    plain = (CL.packed_fft_conv_residuals_plain if CL.conv_route((h, w)) == "fft"
             else CL.padded_fft_conv_residuals_plain)
    got, weights, scale_exp = CL.batched_conv_lnl_residuals(raws, consts)
    again = CL.batched_conv_lnl_residuals(raws, consts)
    # on the card one kernel's two instantiations; on the CPU (a rehearsal)
    # two plain schemes of different form
    same_lnl = (same_bits(got, lnl) if raws.is_cuda
                else compare(got, lnl)[1] <= CONV_LNL_TOL)
    if not (same_lnl and all(
            same_bits(x, y) for x, y in zip(again, (got, weights, scale_exp)))):
        raise AssertionError(f"{name}: the lnL bits differ from conv_lnl's launch, "
                             "or two launches differ")
    _, w64, e64 = plain(raws.double().to(c64.obs.device), c64)
    _, w32, _ = plain(raws, consts)
    keep = torch.isfinite(lnl)
    want = w64.to(raws.device)[keep]
    e64 = e64.cpu()
    scale = want.abs().amax(dim=(1, 2)).clamp(min=1e-300)
    err = (weights[keep].double() - want).abs().amax(dim=(1, 2)) / scale
    plain_err = (w32[keep].double() - want).abs().amax(dim=(1, 2)) / scale
    excess = (err / (CONV_RES_PLAIN * plain_err).clamp(min=CONV_RES_TOL)).max().item()
    exp_diff = (scale_exp[keep].cpu() - e64[keep.cpu()]).abs().max().item()
    log(f"{name}: lnL " + ("bits equal to" if raws.is_cuda else f"within {CONV_LNL_TOL:g} of")
        + f" conv_lnl's launch; weights max normalized err "
        f"{err.max().item():.3e}, at most {excess:.3f} of its bound (max("
        f"{CONV_RES_TOL:g}, {CONV_RES_PLAIN}x the float32 plain scheme's, at most "
        f"{plain_err.max().item():.3e})); scale exponents within {exp_diff} of the "
        f"float64 scheme's; walkers compared {int(keep.sum())}")
    if not (excess <= 1.0 and exp_diff <= 1 and keep.sum().item() >= b // 2):
        raise AssertionError(f"{name} disagrees with its plain scheme")
    return (weights, scale_exp), keep, dict(
        max_abs_err=(weights[keep].double() - want).abs().max().item(),
        max_normalized_err=err.max().item(), bound_share=excess)


def residual_row(name, raws, consts, c64, lnl, f_psf, f_var, data_bytes):
    """The residual instantiation of conv_lnl's forward at ``raws``' shape
    (FFT or padded route), checked by :func:`residual_check` on its
    route's launches, with its times.  Returns the row and the
    residuals."""
    import torch

    from psfmc_tpu_torch.ops import convolve, gaussian_lnlike
    from psfmc_tpu_torch.ops.kernels import _build
    from psfmc_tpu_torch.ops.kernels import conv_lnl as CL

    b, h, w = raws.shape
    route = CL.conv_route((h, w))
    plain = (CL.packed_fft_conv_residuals_plain if route == "fft"
             else CL.padded_fft_conv_residuals_plain)
    routes = dict(CL.batched_conv_lnl.route_launches)
    residuals, _, errs = residual_check(raws, consts, c64, lnl, name)
    routes[route + "_res"] += 2
    if CL.batched_conv_lnl.route_launches != routes:
        raise AssertionError(f"{name} did not launch on the route {route}_res")

    def library():  # the torch.fft formulation of the lnL and the weights
        conv = convolve(raws, f_psf)
        ivm = 1.0 / (convolve(raws * raws, f_var) + consts.obs_var)
        r = consts.obs - conv
        zero = torch.zeros_like(r)
        return (gaussian_lnlike(r, ivm, consts.good),
                torch.where(consts.good, r * ivm, zero),
                torch.where(consts.good, 0.5 * (r * r * ivm * ivm - ivm), zero))

    n = raws.numel()
    bms, by, term = bound(12 * n + data_bytes + 8 * b,
                          conv_lnl_ops(b, h, w) + RES_OPS_PER_PIXEL * n)
    row = dict(
        name=name, route="cuda", source=_build.source_path("conv_lnl"),
        replaces="psfmc_tpu/ops/pallas/lnpost_batched.py:191 (its gradient's "
                 "residuals)", launches=0, max_abs_err=errs["max_abs_err"],
        max_normalized_err=errs["max_normalized_err"],
        ms=time_ms(lambda: CL.batched_conv_lnl_residuals(raws, consts)),
        plain_ms=time_ms(lambda: plain(raws, consts)),
        bound_ms=bms, bound_by=by, bound_term=term, library_ms=time_ms(library),
        library="torch.fft convolutions, the lnL and the weights",
        forward_ms=time_ms(lambda: CL.batched_conv_lnl(raws, consts)),
        conv_route=route)
    return row, residuals


def grad_against_cpu(post, spec, thetas, label):
    """The card's ``log_posterior_and_grad`` against the CPU's float64
    autograd at the same points: per point ``||g - g_cpu|| / ||g_cpu||``
    within :data:`GRAD_RTOL`, lnpost within :data:`MAP_LNP_RTOL`."""
    import torch

    from psfmc_tpu_torch.models import build_posterior

    lnp, g = post.log_posterior_and_grad(thetas)
    lnp, g = lnp.cpu(), g.cpu()
    ref = build_posterior(spec, device="cpu", dtype=torch.float64)
    lnp64, g64 = ref.log_posterior_and_grad(thetas)
    # a float32 profile may overflow where float64's does not: the card's
    # non-finite entries are the CPU's float32 ones
    lnp32 = build_posterior(spec, device="cpu").log_posterior_batch(thetas)
    if not torch.equal(torch.isfinite(lnp32), torch.isfinite(lnp)):
        raise AssertionError(f"gradient, {label}: non-finite lnpost differ from "
                             "the CPU's float32")
    fin = torch.isfinite(lnp64) & torch.isfinite(lnp)
    rel = ((g.double() - g64).norm(dim=1) / g64.norm(dim=1))[fin]
    lnp_rel = ((lnp.double() - lnp64).abs() / lnp64.abs())[fin]
    log(f"gradient, {label} ({post.grad_mode} path): {int(fin.sum())} of "
        f"{len(fin)} points finite; max ||g - g_cpu|| / ||g_cpu|| "
        f"{rel.max().item():.3e} (tol {GRAD_RTOL:g}), median "
        f"{rel.median().item():.3e}; lnpost max rel err {lnp_rel.max().item():.3e}")
    if fin.sum().item() < len(fin) // 4 or not rel.max().item() <= GRAD_RTOL \
            or not lnp_rel.max().item() <= MAP_LNP_RTOL:
        raise AssertionError(f"gradient, {label}: the card disagrees with the CPU")
    return rel.max().item()


def map_program(fns):
    """The captured Adam program of the last ``fit_map`` on ``fns``."""
    programs = list(fns.__dict__.get("_map_programs", {}).values())
    if not programs:
        raise AssertionError("fit_map left no Adam program on the posterior")
    return programs[-1]


def check_step_tally(program, want, label):
    """Every Adam step a replay whose tally is exactly ``want`` (a dict of
    ``(wrapper name, route)`` -> launches)."""
    got = {}
    for fn, route, _ in program.launches or []:
        got[fn.__name__, route] = got.get((fn.__name__, route), 0) + 1
    if got != want:
        raise AssertionError(f"{label}: one Adam step launches {got}, want {want}")


def map_phase(shape=(128, 128), psf_shape=(64, 64), joint_shapes=None, device=None,
              radix7_band=None, cluster_band=None, padded_band=None):
    """The gradient path at full width (the arguments shrink it for a
    rehearsal on the CPU): the MAP flagship through ``model_galaxy_map``
    (64 starts x 500 Adam steps, Laplace), ``model_galaxy_mcmc(init=
    "map")`` on the same files, gradients against the CPU, five Adam steps
    graphed against eager, and the joint MAP (band 1 at 96x96 on the FFT
    route's mixed-radix geometry; then 50 steps with band 1 at
    ``radix7_band``, on the same geometry with radix-7 stages, 50 with
    band 1 at ``padded_band``, on the padded route, and 50 with band 1 at
    ``cluster_band``, on the cluster route).  Returns the backward rows'
    launches and the timings."""
    import torch

    from psfmc_tpu_torch import fitting, optimize
    from psfmc_tpu_torch.flagship import (
        JOINT_SHAPES,
        family_components,
        general_components,
        joint_map_components,
        prior_draws,
        write_map_files,
    )
    from psfmc_tpu_torch.io import fits
    from psfmc_tpu_torch.models import (
        JointModel,
        MultiComponentModel,
        build_model_spec,
        build_posterior,
    )
    from psfmc_tpu_torch.ops.kernels import conv_lnl as CL

    joint_shapes = joint_shapes or JOINT_SHAPES
    radix7_band = radix7_band or RADIX7_SHAPE
    cluster_band = cluster_band or CLUSTER_SHAPE
    padded_band = padded_band or PADDED_SHAPE
    counted = grad_kernels()
    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path, truth = write_map_files(tmp, shape, psf_shape, seed=SEED)
        models = []
        as_model = fitting.as_model

        def kept(*a, **k):
            models.append(as_model(*a, **k))
            return models[-1]

        fitting.as_model = kept
        try:
            torch.cuda.synchronize()
            reset_counts(counted)
            t0 = time.perf_counter()
            res = fitting.model_galaxy_map(path, output_name=os.path.join(tmp, "map"),
                                           n_starts=MAP_STARTS, steps=MAP_STEPS,
                                           seed=SEED, laplace=True, device=device)
            wall = time.perf_counter() - t0
            launches, by_route = read_counts(counted)
        finally:
            fitting.as_model = as_model
        (model,) = models
        fns = model.posterior_fns
        log(f"map: model_galaxy_map {MAP_STARTS} starts x {MAP_STEPS} steps in "
            f"{wall:.2f} s, phases "
            + ", ".join(f"{k} {v:.3f} s" for k, v in res.phase_seconds.items())
            + f"; lnpost {res.lnpost:.3f}; launches {launches}, by route {by_route}")
        # the pool's evaluation, the steps and the final iterate, Laplace's two
        # gradient calls, the images' render
        # (conv_lnl's forward under autograd writes its residuals: the pool's
        # evaluation is the one launch without them)
        evals = MAP_STEPS + 1
        want = {"render_sersics": 1 + evals + 2 + 1, "render_sersics_backward": evals + 2,
                "batched_conv_lnl": 1 + evals + 2, "batched_conv_lnl_backward": evals + 2}
        if launches != want or by_route["batched_conv_lnl_backward:dft"] \
                or by_route["batched_conv_lnl:dft"] or by_route["batched_conv_lnl:fft"] != 1 \
                or by_route["batched_conv_lnl:fft_res"] != evals + 2:
            raise AssertionError(f"map: launches {launches} {by_route}, want {want} "
                                 "all on the FFT route, all but the pool's with residuals")
        program = map_program(fns)
        graphed = fns.device.type == "cuda"  # a CPU rehearsal has no graphs
        if graphed and program.replays != MAP_STEPS:
            raise AssertionError(f"map: {program.replays} replays for {MAP_STEPS} steps")
        if graphed:
            check_step_tally(program, {("render_sersics", None): 1,
                                       ("render_sersics_backward", None): 1,
                                       ("batched_conv_lnl", "fft_res"): 1,
                                       ("batched_conv_lnl_backward", "fft"): 1}, "map")
        out["map"] = dict(launches, **by_route)
        # the MAP beats every pool draw (the JAX package's own bar)
        pool = model.init_params_from_priors(max(4 * MAP_STARTS, 128),
                                             random_state=np.random.RandomState(SEED))
        with torch.no_grad():
            lnp_pool = fns.log_posterior_batch(pool).double().cpu().numpy()
        best_pool = np.nanmax(np.where(np.isfinite(lnp_pool), lnp_pool, -np.inf))
        if not res.lnpost > best_pool:
            raise AssertionError(f"map: lnpost {res.lnpost} does not beat the pool's "
                                 f"best {best_pool}")
        # the five products and their cards
        hdr = None
        for ftype in IMAGE_TYPES:
            fname = os.path.join(tmp, f"map_{ftype}.fits")
            data = fits.getdata(fname)
            if data.shape != tuple(shape) or not np.all(np.isfinite(data)):
                raise AssertionError(f"map: {ftype} is not a finite {shape} image")
            hdr = fits.getheader(fname)
        if not math.isclose(hdr["MAPLNP"], res.lnpost, rel_tol=1e-6):
            raise AssertionError("map: MAPLNP is not the fit's lnpost")
        for abbr in model.param_fits_abbrs:
            if "+/-" not in str(hdr[abbr]):
                raise AssertionError(f"map: card {abbr} = {hdr[abbr]!r} has no error")
        # against the CPU in float64: lnpost at the MAP, the fit from the card's
        # best start, the Laplace std, the positions against the truth
        cpu = MultiComponentModel(path, device="cpu", dtype=torch.float64)
        cpu_fns = cpu.posterior_fns
        lnp64 = float(cpu_fns.log_posterior_batch(res.theta[None])[0])
        lnp_rel = abs(res.lnpost - lnp64) / abs(lnp64)
        order = np.argsort(np.where(np.isfinite(lnp_pool), lnp_pool, -np.inf))[::-1]
        i_best = int(np.nanargmax(res.all_lnpost))
        start = pool[order[:MAP_STARTS]][i_best]
        t0 = time.perf_counter()
        cpu_res = optimize.fit_map(cpu_fns, n_starts=1, steps=MAP_STEPS, p0=start[None],
                                   seed=SEED)
        cpu_fit_s = time.perf_counter() - t0
        _, cpu_std = optimize.laplace_covariance(cpu_fns, res.theta)
        std_rel = np.abs(res.theta_std / cpu_std - 1.0)
        names = model.param_names
        off = dict(zip(names, np.cumsum([0] + model.param_lens)))
        ps = slice(off["1_PointSource_xy"], off["1_PointSource_xy"] + 2)
        host = slice(off["2_Sersic_xy"], off["2_Sersic_xy"] + 2)
        ps_err = np.abs(res.theta[ps] - truth[ps]).max()
        host_err = np.abs(res.theta[host] - truth[host]).max()
        log(f"map: lnpost {res.lnpost:.4f} on the card, {lnp64:.4f} on the CPU in "
            f"float64 at the same theta (rel {lnp_rel:.2e}, tol {MAP_LNP_RTOL:g}); the "
            f"CPU's float64 fit from the card's best start {cpu_res.lnpost:.4f} "
            f"({cpu_fit_s:.1f} s; |diff| {abs(res.lnpost - cpu_res.lnpost):.4f}, tol "
            f"{MAP_FIT_ATOL:g}); truth {float(cpu_fns.log_posterior_batch(truth[None])[0]):.4f}; "
            f"pool's best {best_pool:.4f}")
        log(f"map: point source {res.theta[ps]} (truth {truth[ps]}, err {ps_err:.4f} px, "
            f"tol {MAP_PS_XY_TOL:g}); host {res.theta[host]} (truth {truth[host]}, err "
            f"{host_err:.4f} px, tol {MAP_HOST_XY_TOL:g})")
        log(f"map: Laplace std on the card {np.array2string(res.theta_std, precision=4)}; "
            f"|std / std_cpu - 1| {np.array2string(std_rel, precision=4)}, max "
            f"{np.nanmax(std_rel):.3e} (tol {LAPLACE_RTOL:g})")
        if not (lnp_rel <= MAP_LNP_RTOL and abs(res.lnpost - cpu_res.lnpost) <= MAP_FIT_ATOL
                and ps_err <= MAP_PS_XY_TOL and host_err <= MAP_HOST_XY_TOL
                and np.all(np.isfinite(res.theta_std)) and np.all(std_rel <= LAPLACE_RTOL)):
            raise AssertionError("map: the fit misses one of its bars")
        out["map_phase_seconds"] = dict(res.phase_seconds, wall=wall)

        # the Adam step, replayed and eager (not counted: timing only)
        z0 = program.z.clone()
        for replay in (True, False):
            program.reset(z0)
            step = (program.graph.replay if replay and program.graph is not None
                    else program.step)
            step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(STEADY):
                step()
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3 / STEADY
            out["adam_step_ms_" + ("graphed" if replay else "eager")] = step_ms
            log(f"map: Adam step ({MAP_STARTS} starts), "
                f"{'graphed' if replay else 'eager'}: {step_ms:.3f} ms")

        # graphed against eager, bit for bit, with equal launches
        runs = []
        for eager in (False, True):
            reset_counts(counted)
            with optimize._eager(fns) if eager else contextlib.nullcontext():
                r = optimize.fit_map(fns, n_starts=MAP_STARTS, steps=MAP_EQUAL_STEPS,
                                     p0=pool, seed=SEED)
            torch.cuda.synchronize()
            runs.append((r, read_counts(counted)))
        (g, g_n), (e, e_n) = runs
        if not (same_bits(g.all_theta, e.all_theta)
                and same_bits(g.all_lnpost, e.all_lnpost)):
            raise AssertionError("map: graphed and eager Adam steps differ")
        if g_n != e_n:
            raise AssertionError(f"map: launches {g_n} graphed, {e_n} eager")
        log(f"map: {MAP_EQUAL_STEPS} Adam steps graphed = eager bit for bit, "
            f"launches {g_n[0]} both")

        # gradients against the CPU: the batched, the general and a family path
        grad_against_cpu(fns, model.spec, prior_draws(model.spec, GRAD_POINTS,
                                                      seed=SEED + 7), "MAP flagship")
        gspec = build_model_spec(general_components(shape, psf_shape))
        grad_against_cpu(build_posterior(gspec, device=device), gspec,
                         prior_draws_general(gspec, GRAD_POINTS), "general flagship")
        fspec = build_model_spec(family_components(shape, psf_shape, "flagship"))
        grad_against_cpu(build_posterior(fspec, device=device), fspec,
                         prior_draws(fspec, GRAD_POINTS, seed=SEED + 8),
                         "family flagship")

        # model_galaxy_mcmc(init="map") on the same files
        starts = []
        init_state = fitting.EnsembleSampler.init_state
        sampler_init = fitting.EnsembleSampler.__init__
        samplers = []

        def kept_start(self, p0, *a, **k):
            starts.append(np.array(p0, np.float64))
            return init_state(self, p0, *a, **k)

        def kept_sampler(self, *a, **k):
            sampler_init(self, *a, **k)
            samplers.append(self)

        fitting.EnsembleSampler.init_state = kept_start
        fitting.EnsembleSampler.__init__ = kept_sampler
        try:
            reset_counts(counted)
            t0 = time.perf_counter()
            db = fitting.model_galaxy_mcmc(path, output_name=os.path.join(tmp, "mapinit"),
                                           chains=NWALKERS, burn=BURN, iterations=SAMPLE,
                                           seed=SEED, init="map", device=device)
            init_wall = time.perf_counter() - t0
            init_launches, init_routes = read_counts(counted)
        finally:
            fitting.EnsembleSampler.init_state = init_state
            fitting.EnsembleSampler.__init__ = sampler_init
        (sm,) = samplers
        lnp0 = fns.log_posterior_batch(starts[0]).cpu().numpy()
        chain_lnp = np.asarray(db["lnprobability"], np.float64)
        log(f"map: init='map' fit {init_wall:.2f} s, {len(db)} rows, start lnpost "
            f"{lnp0.min():.3f}..{lnp0.max():.3f}, {sm.graph_replays} replays, "
            f"launches {init_launches} {init_routes}")
        checks = {"every start in support": bool(np.all(np.isfinite(lnp0))),
                  "a finite chain": bool(np.all(np.isfinite(chain_lnp))),
                  "the rows": len(db) == NWALKERS * SAMPLE,
                  "every step a replay": sm.graph_replays == (BURN + SAMPLE) * graphed}
        if not all(checks.values()):
            raise AssertionError(f"map: init='map' failed {checks}; chain lnpost "
                                 f"{chain_lnp.min()}..{chain_lnp.max()}, {len(db)} rows, "
                                 f"{sm.graph_replays} replays")
        out["init"] = dict(init_launches, **init_routes)

        # the joint MAP: band 1's conv_lnl and backward on the FFT route's
        # mixed-radix geometry; then shorter ones with band 1 on that
        # geometry's radix-7 stages, on the padded route and on the
        # cluster route, so that each of their kernels runs inside a
        # captured step
        for key, jshapes, steps in (
                ("joint", joint_shapes, MAP_STEPS),
                ("joint_radix7", (joint_shapes[0], radix7_band), MAP_SHORT_STEPS),
                ("joint_padded", (joint_shapes[0], padded_band), MAP_SHORT_STEPS),
                ("joint_cluster", (joint_shapes[0], cluster_band), MAP_SHORT_STEPS)):
            band1 = fft_geometry(jshapes[1]) or "dft"
            if band1 != {"joint": "mixed", "joint_radix7": "radix7",
                         "joint_padded": "padded", "joint_cluster": "cluster"}[key]:
                raise AssertionError(f"map: the {key} MAP's band 1 {jshapes[1]} "
                                     f"takes conv_lnl's {band1}")
            bands, jtruth = joint_map_components(jshapes, psf_shape, seed=SEED)
            jm = JointModel(bands, device=device)
            reset_counts(counted)
            t0 = time.perf_counter()
            jres = optimize.fit_map(jm.posterior_fns, n_starts=MAP_STARTS,
                                    steps=steps, seed=SEED)
            torch.cuda.synchronize()
            joint_wall = time.perf_counter() - t0
            j_launches, j_routes = read_counts(counted)
            jprog = map_program(jm.posterior_fns)
            # band 0 on the FFT route, band 1 on its own; a forward under
            # autograd off the matmul-DFT route writes its residuals, and no
            # launch takes the matmul-DFT route
            tally = {("render_sersics", None): 2, ("render_sersics_backward", None): 2}
            jwant = dict.fromkeys(("batched_conv_lnl:fft_res", "batched_conv_lnl:padded_res",
                                   "batched_conv_lnl:cluster_res", "batched_conv_lnl:dft",
                                   "batched_conv_lnl_backward:fft",
                                   "batched_conv_lnl_backward:padded",
                                   "batched_conv_lnl_backward:cluster",
                                   "batched_conv_lnl_backward:dft"), 0)
            for route in ("fft", CL.conv_route(jshapes[1])):
                forward = route if route == "dft" else f"{route}_res"
                for k in (("batched_conv_lnl", forward), ("batched_conv_lnl_backward", route)):
                    tally[k] = tally.get(k, 0) + 1
                jwant[f"batched_conv_lnl_backward:{route}"] += steps + 1
                if route != "dft":
                    jwant[f"batched_conv_lnl:{forward}"] += steps + 1
            if graphed:
                check_step_tally(jprog, tally, f"{key} map")
            for geo in MIXED_GEOMETRIES:  # band 1's, at its geometry
                n = (steps + 1) * (band1 == geo)
                jwant.update({f"batched_conv_lnl:fft_res:{geo}": n,
                              f"batched_conv_lnl_backward:fft:{geo}": n})
            jlnp_truth = float(jm.posterior_fns.log_posterior_batch(jtruth[None])[0])
            log(f"map: joint MAP, band 1 {jshapes[1][0]}x{jshapes[1][1]} "
                f"({band1}), {MAP_STARTS} starts x {steps} steps in "
                f"{joint_wall:.2f} s, lnpost {jres.lnpost:.3f} (truth "
                f"{jlnp_truth:.3f}), {jprog.replays} replays, launches "
                f"{j_launches} {j_routes}")
            if not (np.isfinite(jres.lnpost) and jprog.replays == steps * graphed
                    and all(j_routes[k] == v for k, v in jwant.items())):
                raise AssertionError(f"map: the {key} MAP missed its launches or "
                                     "replays")
            out[key] = dict(j_launches, **j_routes)
            out[f"{key}_wall"] = joint_wall
    if "--profile" in sys.argv[1:]:
        profile_adam(program, z0)
    log(f"map: the phase took {time.perf_counter() - t_phase:.1f} s")
    return out


NUTS_CHAINS = 8  # the fitting driver's default: independent chains, one batch
NUTS_DEPTH = 8
NUTS_BURN = 100  # warmup steps (15% step size only, one mass window, 10% step size)
NUTS_SAMPLE = 40
NUTS_CHECKPOINT = 20
NUTS_RESUMED = 60  # the second call: iterations, resuming after NUTS_SAMPLE
NUTS_EQUAL = 3  # graphed against eager: warmup and retained steps
NUTS_EQUAL_DEPTH = 5  # ... at this depth (an eager leaf is some 700 launches)
NUTS_MARGINAL = (10, 5, 4)  # the general flagship: warmup, retained steps, depth
NUTS_PROFILED = 5  # retained steps timed for the idle share
NUTS_PROFILED_LEAVES = 100  # leaf replays under the profiler, and a turn of the flag's
NUTS_FLAG_TURNS = 3  # ... cost: replays with and without the read, in turns
NUTS_LNP_RTOL = 1e-4  # the chain's lnpost (f32, GPU) against the CPU's float64,
NUTS_LNP_FLOOR = 1e-5  # ... with this share of the chain's largest |lnpost| as a floor


def nuts_leaf_tally(sampler):
    """The leaf's captured launches: one each of the render, its backward,
    conv_lnl's residual forward and its backward (the FFT route)."""
    check_step_tally(sampler._graphs["leaf"], {("render_sersics", None): 1,
                                               ("render_sersics_backward", None): 1,
                                               ("batched_conv_lnl", "fft_res"): 1,
                                               ("batched_conv_lnl_backward", "fft"): 1},
                     "nuts leaf")


def nuts_state_differs(a, b):
    """What differs between two NUTS samplers' states, chains and generators."""
    from dataclasses import fields

    diff = []
    for f in fields(a.state):
        x, y = getattr(a.state, f.name), getattr(b.state, f.name)
        pairs = ([(f"accum.{k}", v, y[k]) for k, v in x.items()]
                 if f.name == "accum" else [(f.name, x, y)])
        diff += [name for name, u, v in pairs if not same_bits(u, v)]
    for name, x, y in (("generator", a.generator.get_state(), b.generator.get_state()),
                       ("chain", a.chain, b.chain),
                       ("lnprobability", a.lnprobability, b.lnprobability)):
        if not same_bits(x, y):
            diff.append(name)
    return diff


def nuts_phase(shape=(128, 128), psf_shape=(64, 64), device=None):
    """NUTS at full width (the arguments shrink it for a rehearsal on the
    CPU): the MAP flagship's files through ``model_galaxy_mcmc(sampler=
    "nuts", chains=8, max_depth=8, burn=100, iterations=40,
    checkpoint_interval=20)`` and a second call with 60 iterations that
    resumes; 3 + 3 steps graphed against eager bit for bit; the general
    flagship (two PSFs, a sampled index) at 10 + 5 steps of depth 4; the
    leaf's time, the leaves per step, the host flag's idle share and the
    kernels' share of a leaf.  Returns the launches of the runs on the
    main path and the numbers."""
    import torch

    from psfmc_tpu_torch import fitting
    from psfmc_tpu_torch.analysis.statistics import ess_bulk, rhat_rank
    from psfmc_tpu_torch.database import load_checkpoint
    from psfmc_tpu_torch.flagship import general_components, prior_draws, write_map_files
    from psfmc_tpu_torch.io import fits
    from psfmc_tpu_torch.io.table import Table
    from psfmc_tpu_torch.models import MultiComponentModel, build_model_spec, build_posterior
    from psfmc_tpu_torch.optimize import psf_fan_out
    from psfmc_tpu_torch.sampler import nuts as N

    counted = grad_kernels()
    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path, _ = write_map_files(tmp, shape, psf_shape, seed=SEED)
        samplers, at_images = [], []
        sampler_init = fitting.NUTSSampler.__init__
        save_images = fitting.save_posterior_images

        def kept(self, *a, **k):
            sampler_init(self, *a, **k)
            samplers.append(self)

        def counting_writer(*a, **k):  # the launches of sampling end here
            torch.cuda.synchronize()
            at_images.append(read_counts(counted))
            return save_images(*a, **k)

        fitting.NUTSSampler.__init__ = kept
        fitting.save_posterior_images = counting_writer
        runs = []
        try:
            for iterations in (NUTS_SAMPLE, NUTS_RESUMED):
                torch.cuda.synchronize()
                reset_counts(counted)
                text = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(text):
                    db = fitting.model_galaxy_mcmc(
                        path, output_name=os.path.join(tmp, "nuts"), sampler="nuts",
                        chains=NUTS_CHAINS, max_depth=NUTS_DEPTH, burn=NUTS_BURN,
                        iterations=iterations, checkpoint_interval=NUTS_CHECKPOINT,
                        seed=SEED, device=device)
                wall = time.perf_counter() - t0
                runs.append(dict(db=db, wall=wall, total=read_counts(counted),
                                 sampling=at_images[-1], text=text.getvalue(),
                                 ckpt=load_checkpoint(os.path.join(tmp, "nuts_db.fits")),
                                 cards=Table.read(os.path.join(tmp, "nuts_db.fits"),
                                                  format="fits", extname="CHECKPOINT").meta))
        finally:
            fitting.NUTSSampler.__init__ = sampler_init
            fitting.save_posterior_images = save_images
        sm, sm2 = samplers
        graphed = sm._graphed  # a CPU rehearsal has no graphs
        first, second = runs
        db = first["db"]
        pieces = set(N.WARMUP_PIECES) | set(N.SAMPLE_PIECES)

        # the main run: every piece a replay, captured before the first step
        leaves, steps = sm.leaves_run, sm.steps_run
        log(f"nuts: model_galaxy_mcmc(sampler='nuts') {NUTS_CHAINS} chains, depth "
            f"{NUTS_DEPTH}, warmup {NUTS_BURN} + {NUTS_SAMPLE} retained in segments of "
            f"{NUTS_CHECKPOINT}: {first['wall']:.2f} s wall, phases "
            + ", ".join(f"{k} {v:.3f} s" for k, v in db.phase_seconds.items())
            + f"; {steps} steps, {leaves} leaves ({leaves / steps:.2f} a step), pieces "
            f"{sm.piece_counts}, {sm.graph_replays} replays, {sm.captures} captures; "
            f"divergences {sm.n_divergent}")
        if steps != NUTS_BURN + NUTS_SAMPLE:
            raise AssertionError(f"nuts: {steps} steps, want {NUTS_BURN + NUTS_SAMPLE}")
        if graphed:
            if sm.graph_replays != sum(sm.piece_counts.values()) or sm.captures != len(pieces):
                raise AssertionError(f"nuts: {sm.graph_replays} replays of "
                                     f"{sum(sm.piece_counts.values())} pieces, "
                                     f"{sm.captures} captures (want {len(pieces)})")
            nuts_leaf_tally(sm)
        # the launches of the sampling: the pool's lnpost, the start's
        # gradient, one of each kernel per leaf, and per retained step the
        # record's lnpost and the image means' render
        for label, run, s, pool in (("fit", first, sm, 1), ("resume", second, sm2, 0)):
            n_leaf, n_keep = s.leaves_run, s.piece_counts.get("sample_end", 0)
            want = {"render_sersics": pool + 1 + n_leaf + 2 * n_keep,
                    "render_sersics_backward": 1 + n_leaf,
                    "batched_conv_lnl": pool + 1 + n_leaf + n_keep,
                    "batched_conv_lnl_backward": 1 + n_leaf}
            launches, routes = run["sampling"]
            want_routes = {"batched_conv_lnl:fft_res": 1 + n_leaf,
                           "batched_conv_lnl:fft": pool + n_keep,
                           "batched_conv_lnl_backward:fft": 1 + n_leaf}
            log(f"nuts: {label}: launches of the sampling {launches}, by route "
                f"{ {k: routes[k] for k in want_routes} }; of the image writer "
                f"{ {k: run['total'][0][k] - launches[k] for k in launches} }")
            if launches != want or any(routes[k] != v for k, v in want_routes.items()):
                raise AssertionError(f"nuts: {label}: launches {launches} {routes}, want "
                                     f"{want} {want_routes}")
            out[f"nuts_{label}"] = dict(run["total"][0], **run["total"][1])

        # the adaptation, the accept statistic, the cards
        ck, cards = first["ckpt"], first["cards"]
        eps, inv_mass = ck["nuts_eps"], np.asarray(ck["nuts_inv_mass"])
        accept = float(db.meta["MCACCEPT"])
        log(f"nuts: adapted eps {eps:.5g}, inv_mass {np.array2string(inv_mass, precision=3)}; "
            f"accept statistic {accept:.4f}; cards CKPTSMPL {cards['CKPTSMPL']!r}, CKPTEPS "
            f"{cards['CKPTEPS']:.6g}, CKPTACCS {cards['CKPTACCS']:.6g}, CKPTNUTS "
            f"{inv_mass.shape}")
        checks = {"finite eps": math.isfinite(eps) and eps > 0,
                  "finite metric": bool(np.all(np.isfinite(inv_mass) & (inv_mass > 0))),
                  "the metric's length": inv_mass.shape == (sm.zdim,),
                  "accept in (0, 1]": 0.0 < accept <= 1.0,
                  "CKPTSMPL": cards["CKPTSMPL"] == "nuts",
                  "CKPTEPS": cards["CKPTEPS"] == eps,
                  "CKPTACCS": math.isclose(cards["CKPTACCS"], accept * NUTS_SAMPLE,
                                           rel_tol=1e-6),
                  "the rows": len(db) == NUTS_CHAINS * NUTS_SAMPLE}
        for ftype in IMAGE_TYPES:
            data = fits.getdata(os.path.join(tmp, f"nuts_{ftype}.fits"))
            checks[ftype] = data.shape == tuple(shape) and bool(np.all(np.isfinite(data)))
        if not all(checks.values()):
            raise AssertionError(f"nuts: failed {[k for k, v in checks.items() if not v]}")

        # the chain's lnpost against the CPU's float64
        cpu = MultiComponentModel(path, device="cpu", dtype=torch.float64)
        thetas = cpu.thetas_from_database(db)
        lnp64 = cpu.posterior_fns.log_posterior_batch(thetas).numpy()
        lnp = np.asarray(db["lnprobability"], np.float64)
        # the chain's lnpost crosses zero: an error relative to the larger
        # of |lnpost| and the floor's share of the chain's largest
        scale = np.maximum(np.abs(lnp64),
                           NUTS_LNP_FLOOR / NUTS_LNP_RTOL * np.abs(lnp64).max())
        rel = float(np.max(np.abs(lnp - lnp64) / scale))
        log(f"nuts: the chain's lnpost {lnp.min():.3f}..{lnp.max():.3f} against the CPU's "
            f"float64 at its {len(lnp)} samples: max rel diff with the floor {rel:.3e} "
            f"(rtol {NUTS_LNP_RTOL:g}, floor {NUTS_LNP_FLOOR:g} of the largest |lnpost|); "
            f"without the floor {float(np.max(np.abs(lnp - lnp64) / np.abs(lnp64))):.3e}")
        if not (np.all(np.isfinite(lnp)) and rel <= NUTS_LNP_RTOL):
            raise AssertionError("nuts: the chain's lnpost disagrees with the CPU")
        out["nuts_lnp_rel_err"] = rel

        # the multi-chain diagnostics of the retained chains
        order = np.lexsort((np.asarray(db["sample"]), np.asarray(db["walker"])))
        chains = thetas[order].reshape(NUTS_CHAINS, NUTS_SAMPLE, -1)
        rhat = [rhat_rank(chains[:, :, j]) for j in range(chains.shape[2])]
        ess = [ess_bulk(chains[:, :, j]) for j in range(chains.shape[2])]
        log(f"nuts: rank-normalized split R-hat by parameter "
            f"{np.array2string(np.asarray(rhat), precision=3)}, bulk ESS "
            f"{np.array2string(np.asarray(ess), precision=1)}")
        out["nuts_rhat_max"], out["nuts_ess_bulk_min"] = float(np.nanmax(rhat)), float(
            np.nanmin(ess))

        # the gradient path's kernels at the leaf's batch (one row a chain),
        # at each chain's last retained position, against their plain versions
        last = torch.as_tensor(np.asarray(chains[:, -1]), dtype=torch.float32,
                               device=sm.fns.device)
        checks = [grad_batch_check(sm.fns, last, "nuts", SEED + 7)]

        # the second call resumes from the checkpoint: no warmup, the first
        # samples kept, the adaptation carried
        db2 = second["db"]
        resumed = (f"Resuming from checkpoint: {NUTS_BURN}/{NUTS_BURN} burn-in + "
                   f"{NUTS_SAMPLE} retained iterations done")
        kept_rows = all(np.array_equal(
            np.asarray(db2[c]).reshape(NUTS_CHAINS, NUTS_RESUMED, -1)[:, :NUTS_SAMPLE],
            np.asarray(db[c]).reshape(NUTS_CHAINS, NUTS_SAMPLE, -1)) for c in db.colnames)
        log(f"nuts: the second call ({NUTS_RESUMED} iterations) {second['wall']:.2f} s, "
            f"{sm2.steps_run} steps, {sm2.captures} captures, {len(db2)} rows, eps "
            f"{second['ckpt']['nuts_eps']:.5g}")
        if not (resumed in second["text"] and len(db2) == NUTS_CHAINS * NUTS_RESUMED
                and kept_rows and sm2.steps_run == NUTS_RESUMED - NUTS_SAMPLE
                and second["ckpt"]["nuts_eps"] == eps
                and (not graphed or sm2.captures == len(N.SAMPLE_PIECES))):
            raise AssertionError("nuts: the second call did not resume the first")

        # the times, on the resumed sampler: a retained segment timed on the
        # host clock, every piece replayed back to back (CUDA events), the
        # host flag's idle share, the kernels' share of a leaf
        if graphed:
            t_part = time.perf_counter()
            out.update(nuts_times(sm2))
            log(f"nuts: the times took {time.perf_counter() - t_part:.1f} s")
        out["nuts_fit_wall_s"] = first["wall"]
        out["nuts_leaves_per_step"] = leaves / steps
        out["nuts_divergent"] = sm.n_divergent
        fns = sm.fns

    # graphed against eager, bit for bit: from the fit's checkpoint (its
    # positions, step size, metric and generator), a warmup of 3 steps
    # (its window switch after the third) and 3 retained steps
    t_part = time.perf_counter()
    pair = []
    for eager in (False, True):
        s = N.NUTSSampler(NUTS_CHAINS, fns.spec.num_params, fns, seed=SEED + 1,
                          max_depth=NUTS_EQUAL_DEPTH)
        reset_counts(counted)
        with N._eager(s) if eager else contextlib.nullcontext():
            s.restore_state(ck)
            s.run_burn(NUTS_EQUAL)
            s.reset()
            s.run_sampling(NUTS_EQUAL)
        torch.cuda.synchronize()
        pair.append((s, read_counts(counted)))
    (g, g_n), (e, e_n) = pair
    differs = nuts_state_differs(g, e)
    log(f"nuts: {NUTS_EQUAL} + {NUTS_EQUAL} steps graphed ({g.graph_replays} replays, "
        f"{g.leaves_run} leaves, pieces {g.piece_counts}) against eager ({e.graph_replays} replays): "
        f"{'bit for bit' if not differs else 'differ in ' + str(differs)}; launches "
        f"{g_n[0]} and {e_n[0]}; {time.perf_counter() - t_part:.1f} s")
    if differs or g_n != e_n or g.piece_counts != e.piece_counts or e.graph_replays:
        raise AssertionError("nuts: graphed and eager steps differ")

    # the marginalization on the card: two PSFs, the index sampled
    t_part = time.perf_counter()
    burn, keep, depth = NUTS_MARGINAL
    gspec = build_model_spec(general_components(shape, psf_shape))
    gpost = build_posterior(gspec, device=device)
    s = N.NUTSSampler(NUTS_CHAINS, gspec.num_params, gpost, seed=SEED + 2, max_depth=depth)
    reset_counts(counted)
    s.init_state(prior_draws(gspec, max(32 * NUTS_CHAINS, 256), seed=SEED + 6))
    s.run_burn(burn)
    s.reset()
    s.run_sampling(keep)
    torch.cuda.synchronize()
    m_launches, m_routes = read_counts(counted)
    off = int(s.transform.discrete_offsets[0])
    flat, lnp = s.flatchain, s.lnprobability.reshape(-1)
    log(f"nuts: the general flagship ({gspec.num_psfs} PSFs, grad_mode "
        f"{gpost.grad_mode!r}), {burn} + {keep} steps of depth {depth}: {s.leaves_run} "
        f"leaves, {s.graph_replays} replays; PSF index drawn {np.bincount(flat[:, off].astype(int), minlength=2)}; "
        f"launches {m_launches}")
    want = {"render_sersics": 2 + s.leaves_run + 2 * keep,
            "render_sersics_backward": 1 + s.leaves_run,
            "batched_conv_lnl": 0, "batched_conv_lnl_backward": 0}
    if not (set(np.unique(flat[:, off])) <= {0.0, 1.0} and np.all(np.isfinite(lnp))
            and m_launches == want
            and (not graphed or s.graph_replays == sum(s.piece_counts.values()))):
        raise AssertionError(f"nuts: the marginalized run failed (launches want {want})")
    cpu_post = build_posterior(gspec, device="cpu", dtype=torch.float64)
    want_lnp = cpu_post.log_posterior_batch(torch.as_tensor(flat)).numpy()
    scale = np.maximum(np.abs(want_lnp), GENERAL_FLOOR / GENERAL_RTOL * np.abs(want_lnp).max())
    err = float(np.max(np.abs(lnp - want_lnp) / scale))
    log(f"nuts: the marginalized chain's lnpost against the CPU's float64: max rel "
        f"diff with the floor {err:.3e} (rtol {GENERAL_RTOL:g}); "
        f"{time.perf_counter() - t_part:.1f} s")
    if not err <= GENERAL_RTOL:
        raise AssertionError("nuts: the marginalized chain's lnpost disagrees with the CPU")
    # the render and its backward at the marginalized leaf's batch: each
    # chain's last position once per PSF
    last = torch.as_tensor(s.chain[:, -1], dtype=torch.float32, device=gpost.device)
    checks.append(grad_batch_check(gpost, psf_fan_out(last, off, gspec.num_psfs),
                                   "nuts, marginalized", SEED + 8))
    out["nuts_kernel_checks"] = checks
    out["nuts_marginal"] = dict(m_launches, **m_routes)
    out["nuts_wall_s"] = time.perf_counter() - t_phase
    log(f"nuts: the phase took {out['nuts_wall_s']:.1f} s ({CARD})")
    return out


def nuts_times(sampler, steps=NUTS_PROFILED):
    """A retained segment of ``steps`` steps on the host clock, every piece
    replayed back to back (CUDA events, :func:`time_ms`; the retained
    step's end with the record's slot rewound before each replay, one
    small kernel more), the step's idle share (1 - the pieces' busy time
    over the wall time), the host flag's own (leaf replays with the
    sampler's read of the flag after each against the same replays back
    to back, in turns), the potential alone, and under torch.profiler the
    kernels' share of a leaf."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from psfmc_tpu_torch.sampler.ensemble import capture_step

    before = dict(sampler.piece_counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sampler.run_sampling(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ran = {k: v - before.get(k, 0) for k, v in sampler.piece_counts.items()}
    slot = sampler._record[2]

    def replay(name):  # the record's slot rewound: the chain buffer holds a segment
        graph = sampler._graphs[name].graph
        if name != "sample_end":
            return graph.replay
        return lambda: (slot.zero_(), graph.replay())

    piece_ms = {k: time_ms(replay(k)) for k in ran}
    busy = sum(ran[k] * piece_ms[k] for k in ran) * 1e-3
    # the potential and its gradient alone, captured apart (uncounted): the
    # leaf less it is the tree's bookkeeping
    z = sampler.state.z.clone()
    potential = capture_step(lambda zz: sampler._u_vg(zz), (z,), (z.clone(),),
                             sampler.generator, torch.cuda.Stream(),
                             torch.cuda.graph_pool_handle())
    potential_ms = time_ms(potential.graph.replay)
    # the host flag alone, in turns: leaf replays back to back, and each
    # followed by the sampler's read of the flag (the host waits, then
    # queues the next)
    graph = sampler._graphs["leaf"].graph

    def after():
        graph.replay()
        sampler._flag()

    modes = {"back to back": graph.replay, "read after": after}
    turns = {mode: [] for mode in modes}
    for _ in range(NUTS_FLAG_TURNS):
        for mode, fn in modes.items():
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(NUTS_PROFILED_LEAVES):
                fn()
            torch.cuda.synchronize()
            turns[mode].append(time.perf_counter() - t1)
    flag_idle = [1.0 - b / w for w, b in zip(turns["read after"], turns["back to back"])]
    flag_us = [(w - b) * 1e6 / NUTS_PROFILED_LEAVES
               for w, b in zip(turns["read after"], turns["back to back"])]
    leaves = min(ran["leaf"], NUTS_PROFILED_LEAVES)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(leaves):
            sampler._graphs["leaf"].graph.replay()
        torch.cuda.synchronize()
    kernel_us, all_us, launched = 0.0, 0.0, 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        all_us += us
        launched += e.count if us else 0
        if any(name in e.key for name in ("sersic_render_kernel", "render_backward_kernel",
                                          "conv_lnl_")):
            kernel_us += us
    kernel_ms = kernel_us * 1e-3 / leaves if all_us else None
    out = {"nuts_leaf_ms": piece_ms["leaf"], "nuts_piece_ms": piece_ms,
           "nuts_potential_ms": potential_ms,
           "nuts_bookkeeping_ms": piece_ms["leaf"] - potential_ms,
           "nuts_segment_ms_per_step": wall * 1e3 / steps,
           "nuts_segment_leaves_per_step": ran["leaf"] / steps,
           "nuts_idle_share": 1.0 - busy / wall,
           "nuts_flag_idle_share": flag_idle,
           "nuts_flag_us_per_leaf": flag_us,
           "nuts_leaf_kernels_ms": kernel_ms,
           "nuts_leaf_device_ms": all_us * 1e-3 / leaves if all_us else None,
           "nuts_leaf_launches": launched / leaves if all_us else None,
           "nuts_leaf_kernel_share": (kernel_ms / piece_ms["leaf"]
                                      if kernel_ms is not None else None)}
    log(f"nuts: {steps} retained steps at {sampler.nwalkers} chains: {wall * 1e3:.3f} ms wall "
        f"({wall * 1e3 / steps:.3f} ms a step, {ran['leaf'] / steps:.2f} leaves a step); "
        f"the potential and its gradient alone {potential_ms:.4f} ms, the leaf's "
        f"bookkeeping {piece_ms['leaf'] - potential_ms:.4f} ms; pieces "
        f"replayed back to back (ms) "
        + ", ".join(f"{k} {v:.4f}" for k, v in piece_ms.items())
        + f"; busy {busy * 1e3:.3f} ms, idle share {out['nuts_idle_share']:.3f}; "
        f"{NUTS_PROFILED_LEAVES} leaf replays each followed by the flag's read "
        f"against back to back, {NUTS_FLAG_TURNS} turns: the flag's idle share "
        + ", ".join(f"{v:.4f}" for v in flag_idle) + " ("
        + ", ".join(f"{v:.1f}" for v in flag_us) + f" us a leaf) ({CARD})")
    if kernel_ms is None:
        log("nuts: the profiler recorded no device time: the kernels' share of a leaf "
            "is not measured")
    else:
        log(f"nuts: a leaf's device time {out['nuts_leaf_device_ms']:.4f} ms in "
            f"{out['nuts_leaf_launches']:.0f} kernels, of it the "
            f"render, conv_lnl and their backward kernels {kernel_ms:.4f} ms: "
            f"{out['nuts_leaf_kernel_share']:.3f} of the leaf's replay "
            f"({piece_ms['leaf']:.4f} ms; {sampler.nwalkers} chains)")
        for e in sorted(prof.key_averages(), key=lambda e: -getattr(
                e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)))[:12]:
            us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
            log(f"nuts:   {us / leaves * 1e-3:9.4f} ms/leaf  {e.count // leaves:4d} "
                f"launches/leaf  {e.key[:90]}")
    return out


CRIT_JOINT_BURN, CRIT_JOINT_SAMPLE = 10, 10  # the short joint fit
# The card's pointwise maps against the CPU's float64, entry by entry.  A
# pixel's term is -z^2 / 2 + ln(ivm / 2 pi) / 2 with z = (obs - conv)
# sqrt(ivm); on the card conv carries the render kernel's float32 error
# (RENDER_TOL, 5e-6 of a pixel) and that of the convolution's DFT products
# in float32 (about 2 sqrt(N) eps32 a pass, two passes at N = 128: 3e-6),
# both of the draw's largest |raw| or |conv|: CRIT_CONV_ETA.  So a term may
# move by |z| sqrt(ivm) d_conv, and by its own rounding, CRIT_TERM_EPS of
# (|term| + 1) (16 eps32); the predictive CDF Phi(z) by phi(z) sqrt(ivm)
# d_conv + CRIT_TERM_EPS.
CRIT_CONV_ETA = 1e-5
CRIT_TERM_EPS = 1e-6
# A pixel's Pareto k may move this many times its largest term tolerance
# (k is a smooth function of the log weights, which move by at most twice
# it); a count card may differ by the CPU's pixels (or parameters) that
# close to its threshold.  A prior power-scaling index may move by
# CRIT_FLAG_BAND (the card's float32 log prior of the same draws).
CRIT_K_BAND = 40
CRIT_FLAG_BAND = 1e-3
CRIT_PLAIN = 4  # ... or this many times the float32 plain version's own error
CRIT_HALF_UNIT = {"MCLOOELP": 0.005, "MCLOOSE": 0.005, "MCLOOPEF": 0.005,
                  "MCPITKS": 5e-5, "MCPITP": 5e-5}  # half the cards' rounding
CRIT_CARDS = ("MCLOOELP", "MCLOOSE", "MCLOOPEF", "MCLOOKBD", "MCPITKS", "MCPITP",
              "MCPSFLAG")


def criticism_reference(model, thetas, chunk):
    """The pointwise (loglike, cdf) maps of ``thetas`` on ``model`` (the
    CPU's float64), good pixels of every band concatenated, and each
    entry's tolerance on the card (see :data:`CRIT_CONV_ETA`)."""
    import torch

    from psfmc_tpu_torch.analysis.model_comparison import _band_fns

    bands = []
    for f in _band_fns(model):
        good = f.good.reshape(-1)
        parts = ([], [], [], [])
        for lo in range(0, len(thetas), chunk):
            with torch.no_grad():
                imgs = f._images(f.as_thetas(thetas[lo:lo + chunk]), with_ps=False)
                resid, ivm = f.obs - imgs["conv"], 1.0 / imgs["var"]
                ll = f._lnlike_pointwise(resid, ivm, f.good, imgs["conv"])
                cdf = f._cdf_pointwise(resid, ivm, f.good, imgs["conv"])
                scale = torch.maximum(imgs["raw"].abs().amax(dim=(1, 2)),
                                      imgs["conv"].abs().amax(dim=(1, 2)))
                d_conv = CRIT_CONV_ETA * scale[:, None, None]
                root = ivm.sqrt()
                z = resid * root
                t_ll = z.abs() * root * d_conv + CRIT_TERM_EPS * (ll.abs() + 1.0)
                t_cdf = (torch.exp(-0.5 * z * z) / math.sqrt(2 * math.pi) * root * d_conv
                         + CRIT_TERM_EPS)
            for dst, m in zip(parts, (ll, cdf, t_ll, t_cdf)):
                dst.append(m.reshape(m.shape[0], -1)[:, good].numpy())
        bands.append([np.concatenate(p, axis=0) for p in parts])
    return [np.concatenate(b, axis=1) for b in zip(*bands)]


def criticism_fit(model_file, out, burn, sample, device):
    """``model_galaxy_mcmc(criticism=True)`` with the kernels counted over
    the whole call and over the criticism block alone, the block's pieces
    timed on the host clock (each from a synchronize) and its pointwise
    matrices and draws kept.  Returns the database and what was kept."""
    import torch

    from psfmc_tpu_torch import fitting
    from psfmc_tpu_torch.analysis import model_comparison as MC
    from psfmc_tpu_torch.analysis import sensitivity as SE

    counted = counted_kernels()
    kept = {"s": {}}
    originals = {(MC, "criticism_values"): MC.criticism_values,
                 (MC, "_pointwise_matrix_pair"): MC._pointwise_matrix_pair,
                 (MC, "psis_loo"): MC.psis_loo, (MC, "loo_pit"): MC.loo_pit,
                 (SE, "_replay_scalar"): SE._replay_scalar,
                 (SE, "power_scale_from_logs"): SE.power_scale_from_logs}

    def timed(key, fn):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **k)
            torch.cuda.synchronize()
            kept["s"][key] = kept["s"].get(key, 0.0) + time.perf_counter() - t0
            return res
        return wrapped

    def block(*a, **k):  # the criticism block's own launches
        torch.cuda.synchronize()
        before = read_counts(counted)
        res = timed("block", originals[(MC, "criticism_values")])(*a, **k)
        kept["before"], kept["after"] = before, read_counts(counted)
        return res

    def pair(model, thetas, chunk):
        res = timed("replay", originals[(MC, "_pointwise_matrix_pair")])(model, thetas, chunk)
        kept.update(thetas=thetas, ll=res[0], cdf=res[1], chunk=chunk)
        return res

    patches = {(MC, "criticism_values"): block, (MC, "_pointwise_matrix_pair"): pair,
               (MC, "psis_loo"): timed("psis_loo", MC.psis_loo),
               (MC, "loo_pit"): timed("loo_pit", MC.loo_pit),
               (SE, "_replay_scalar"): timed("sensitivity_replay", SE._replay_scalar),
               (SE, "power_scale_from_logs"): timed("sensitivity_host",
                                                    SE.power_scale_from_logs)}
    for (mod, name), fn in patches.items():
        setattr(mod, name, fn)
    try:
        torch.cuda.synchronize()
        reset_counts(counted)
        t0 = time.perf_counter()
        db = fitting.model_galaxy_mcmc(
            model_file, output_name=out, chains=NWALKERS, burn=burn, iterations=sample,
            seed=SEED, device=device, checkpoint_interval=CHECKPOINT, criticism=True)
        kept["wall"] = time.perf_counter() - t0
        kept["total"] = read_counts(counted)
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)
    if "after" not in kept:
        raise AssertionError("the criticism block did not run")
    (b0, r0), (b1, r1) = kept["before"], kept["after"]
    kept["launches"] = {k: b1[k] - b0[k] for k in b1}
    kept["routes"] = {k: r1[k] - r0[k] for k in r1}
    return db, kept


def criticism_kernel_checks(model, thetas, chunk, label):
    """Every kernel of the criticism path against its plain version at the
    batch it launches there: the render at each chunk of the pointwise
    replay (``chunk`` draws and the remainder), for every band; at the
    power-scaling replay's batch (every draw in one launch), the fused
    kernel on the fused path, else the render and conv_lnl."""
    import torch

    from psfmc_tpu_torch.analysis.model_comparison import _band_fns
    from psfmc_tpu_torch.ops.kernels.fused_lnl import fused_lnl, fused_lnl_plain
    from psfmc_tpu_torch.ops.kernels.sersic_render import (
        render_sersics,
        render_sersics_plain,
    )

    checks = []
    for band, f in enumerate(_band_fns(model)):
        th = f.as_thetas(thetas)
        name = f"{label}, band {band}" if hasattr(model.posterior_fns, "band_fns") else label
        for lo in range(0, len(th), chunk):
            params, sky = (t.contiguous() for t in f.render_inputs(th[lo:lo + chunk]))
            _, rel, _ = compare(render_sersics(params, sky, f.render_shape),
                                render_sersics_plain(params, sky, f.render_shape))
            log(f"{name}: render at the pointwise replay's B = {params.shape[0]}: max rel "
                f"err {rel:.3e} (tol {RENDER_TOL:g})")
            if not rel <= RENDER_TOL:
                raise AssertionError(f"{name}: the render disagrees with its plain version")
            checks.append({"band": band, "kernel": "render", "batch": params.shape[0],
                           "max_rel_err": rel})
        if f.lnpost == "fused":
            params, sky = (t.contiguous() for t in f.render_inputs(th))
            fky, kx = (t.contiguous() for t in f.pointsource_inputs(th))
            args = (params, sky, fky, kx, f.consts)
            _, rel, frac = compare(fused_lnl(*args), fused_lnl_plain(*args))
            log(f"{name}: fused_lnl at the power-scaling replay's B = {len(th)}: max rel "
                f"err {rel:.3e} (tol {FUSED_TOL:g}), finite share {frac:.4f}")
            if not rel <= FUSED_TOL:
                raise AssertionError(f"{name}: fused_lnl disagrees with its plain version")
            checks.append({"band": band, "kernel": "fused_lnl", "batch": len(th),
                           "max_rel_err": rel})
        else:
            out = batch_kernel_check(f, th, f"{name}, power-scaling replay")
            checks.append({"band": band, "kernel": "render+conv_lnl", **out})
    torch.cuda.synchronize()
    return checks


def criticism_values_check(label, headers, kept, cpu_models, db):
    """The card's criticism cards (in every product's header) and its
    pointwise matrices against the CPU's float64 on the same draws.

    Each entry of the matrices within the larger of its tolerance from
    :data:`CRIT_CONV_ETA` and :data:`CRIT_PLAIN` times the float32 plain
    version's own distance from float64 (the same model on the CPU in
    float32: a draw whose float32 evaluation is ill-conditioned, a Sersic
    of extreme index or size in an unconverged chain, is as far from
    float64 on the CPU as on the card).  Each card likewise: its
    tolerance propagated from the entries' (ELPD, SE, p_eff, the PIT
    values and so the KS statistic and p-value, the pixels or parameters
    that close to a count's threshold) or :data:`CRIT_PLAIN` times the
    float32 CPU's distance from float64, plus half the card's rounding.
    ``cpu_models`` is the model on the CPU in (float64, float32)."""
    from scipy.stats import kstwo

    from psfmc_tpu_torch.analysis import model_comparison as MC
    from psfmc_tpu_torch.fitting import CRITICISM_DRAWS

    for hdr in headers:
        missing = [k for k in CRIT_CARDS if k not in hdr]
        if missing:
            raise AssertionError(f"{label}: criticism cards missing: {missing}")
        if any(hdr[k] != headers[0][k] for k in CRIT_CARDS):
            raise AssertionError(f"{label}: the products' criticism cards differ")
    cards = {k: headers[0][k] for k in CRIT_CARDS}
    cpu64, cpu32 = cpu_models
    thetas = kept["thetas"]
    t0 = time.perf_counter()
    if not np.array_equal(MC._resolve_thetas(cpu64, db, None, CRITICISM_DRAWS), thetas):
        raise AssertionError(f"{label}: the CPU resolves other draws than the card")
    ll, cdf, eta_ll, eta_cdf = criticism_reference(cpu64, thetas, kept["chunk"])
    ll32, cdf32 = MC._pointwise_matrix_pair(cpu32, thetas, kept["chunk"])
    tol_ll = np.maximum(eta_ll, CRIT_PLAIN * np.abs(ll32 - ll))
    tol_cdf = np.maximum(eta_cdf, CRIT_PLAIN * np.abs(cdf32 - cdf))
    err_ll, err_cdf = np.abs(kept["ll"] - ll), np.abs(kept["cdf"] - cdf)
    ratio_ll = float(np.max(err_ll / tol_ll))
    ratio_cdf = float(np.max(err_cdf / tol_cdf))
    plain_draws = int(np.sum(np.any(CRIT_PLAIN * np.abs(ll32 - ll) > eta_ll, axis=1)))
    log(f"{label}: pointwise matrices {kept['ll'].shape} on the card against the CPU's "
        f"float64, entry by entry: loglike max |err| {float(err_ll.max()):.3e}, "
        f"{ratio_ll:.3f} of its tolerance; cdf max |err| {float(err_cdf.max()):.3e}, "
        f"{ratio_cdf:.3f} of its tolerance; the float32 CPU's own max |err| "
        f"{float(np.max(np.abs(ll32 - ll))):.3e} and {float(np.max(np.abs(cdf32 - cdf))):.3e}"
        f"; draws where {CRIT_PLAIN:g}x the float32 CPU's error sets a tolerance: "
        f"{plain_draws} of {len(thetas)}")
    if not (ratio_ll <= 1.0 and ratio_cdf <= 1.0):
        raise AssertionError(f"{label}: the card's pointwise maps disagree with the CPU")

    def values(model):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            loo, pit, sens = MC.criticism_values(model, db, draws=CRITICISM_DRAWS)
        return {"MCLOOELP": loo.elpd, "MCLOOSE": loo.se, "MCLOOPEF": loo.p_eff,
                "MCLOOKBD": int(np.sum(loo.pareto_k > 0.7)), "MCPITKS": pit.ks_stat,
                "MCPITP": pit.ks_pvalue, "MCPSFLAG": len(sens.flagged())}, loo, pit, sens

    want, loo, pit, sens = values(cpu64)
    plain = values(cpu32)[0]
    cpu_s = time.perf_counter() - t0
    m = np.max(eta_ll, axis=0)  # each pixel's largest term tolerance
    d_pit = np.max(eta_cdf, axis=0) + 4.0 * m
    tols = {"MCLOOELP": 2.0 * m.sum(), "MCLOOSE": 2.0 * float(np.sqrt(np.sum(m * m))),
            "MCLOOPEF": 3.0 * m.sum(), "MCPITKS": float(d_pit.max()),
            "MCLOOKBD": int(np.sum(np.abs(loo.pareto_k - 0.7) <= CRIT_K_BAND * m)),
            "MCPSFLAG": int(np.sum(np.abs(sens.prior - sens.threshold) <= CRIT_FLAG_BAND))}
    n = pit.pit.size
    tols["MCPITP"] = max(want["MCPITP"] - float(kstwo.sf(want["MCPITKS"] + tols["MCPITKS"], n)),
                         float(kstwo.sf(max(want["MCPITKS"] - tols["MCPITKS"], 0.0), n))
                         - want["MCPITP"])
    for key in CRIT_CARDS:  # or the float32 plain version's own distance
        tols[key] = max(tols[key], CRIT_PLAIN * abs(plain[key] - want[key]))
    bad = [key for key in CRIT_CARDS
           if not abs(cards[key] - want[key]) <= tols[key] + CRIT_HALF_UNIT.get(key, 0)]
    log(f"{label}: criticism cards on the card {cards}; the CPU's float64 before "
        f"rounding {want}, its float32 {plain}; tolerances {tols} (plus half the "
        f"rounding); the CPU's recomputation {cpu_s:.1f} s")
    if bad:
        raise AssertionError(f"{label}: criticism cards {bad} disagree with the CPU")
    return {"cards": cards, "cpu": want, "cpu_float32": plain, "tolerances": tols,
            "ll_err_share_of_tol": ratio_ll, "cdf_err_share_of_tol": ratio_cdf,
            "ll_max_abs_err": float(err_ll.max()), "plain_tolerance_draws": plain_draws}


def criticism_phase(shape=(128, 128), psf_shape=(64, 64), joint_shapes=None,
                    device=None):
    """Model criticism on the card (the arguments shrink it for a rehearsal
    on the CPU): the driver phase's flagship fit (``PSFMC_LNPOST=pallas``,
    the fused kernel; 250 walkers, 20 + 20 steps) with ``criticism=True``,
    then a short joint flagship fit (band 1 at 96x96, the mixed-radix
    geometry; 10 + 10 steps) through ``JointModel.save_posterior_images``:
    the seven cards in every product; the card's cards and pointwise
    matrices against the CPU's float64 on the same draws
    (:func:`criticism_values_check`); the block's launches exact (the
    render once a replay chunk and band, the fused kernel or the render
    and conv_lnl once a band for the power-scaling replay); every kernel
    of the block against its plain version at its batch; the block's wall
    time split into the pointwise replay, PSIS-LOO, LOO-PIT (its PSIS and
    the KS test) and the power-scaling replay and host part.  Returns the
    launches of both fits (whole calls) and the numbers."""
    import torch

    from psfmc_tpu_torch.analysis.model_comparison import REPLAY_CHUNK
    from psfmc_tpu_torch.database import filter_lowp_walkers
    from psfmc_tpu_torch.flagship import JOINT_SHAPES, write_flagship_files, write_joint_files
    from psfmc_tpu_torch.io import fits
    from psfmc_tpu_torch.models import as_model
    from psfmc_tpu_torch.ops.kernels.conv_lnl import conv_route

    joint_shapes = JOINT_SHAPES if joint_shapes is None else joint_shapes
    t_phase = time.perf_counter()
    out = {}
    env = {k: os.environ.pop(k) for k in ("PSFMC_LNPOST", "PSFMC_RENDER", "PSFMC_KAPPA")
           if k in os.environ}
    runs = (("single", shape, BURN, SAMPLE), ("joint", joint_shapes, CRIT_JOINT_BURN,
                                              CRIT_JOINT_SAMPLE))
    try:
        for kind, shapes, burn, sample in runs:
            label = f"criticism, {kind}"
            with tempfile.TemporaryDirectory() as tmp:
                if kind == "single":
                    model_file = write_flagship_files(tmp, shape, psf_shape)
                    os.environ["PSFMC_LNPOST"] = "pallas"
                    bases = [os.path.join(tmp, "out")]
                else:
                    model_file = write_joint_files(tmp, shapes, psf_shape)
                    os.environ.pop("PSFMC_LNPOST", None)
                    bases = [os.path.join(tmp, f"out_b{b}") for b in range(len(shapes))]
                db, kept = criticism_fit(model_file, os.path.join(tmp, "out"), burn,
                                         sample, device)
                headers = [fits.getheader(f"{base}_{ftype}.fits") for base in bases
                           for ftype in IMAGE_TYPES]
                model = as_model(model_file, device=device)
                cpu = [as_model(model_file, device="cpu", dtype=dt,
                                lnpost="fused" if kind == "single" else None)
                       for dt in (torch.float64, torch.float32)]
                # the writer's stuck-walker filter (the block applies its own)
                filtered = db if kind == "joint" else filter_lowp_walkers(db, 10)
                res = criticism_values_check(label, headers, kept, cpu, filtered)
                ndraws = len(kept["thetas"])
                chunks = -(-ndraws // kept["chunk"])
                if kind == "single":
                    want = {"render_sersics": chunks, "fused_lnl": 1,
                            "batched_conv_lnl": 0, "render_sersics_tiled": 0}
                else:
                    nb = len(shapes)
                    want = {"render_sersics": nb * (chunks + 1), "fused_lnl": 0,
                            "batched_conv_lnl": nb, "render_sersics_tiled": 0}
                    routes = [conv_route(s) for s in shapes]
                    geos = [fft_geometry(s) for s in shapes]
                    if routes != ["fft", "fft"] or geos[1] != "mixed":
                        raise AssertionError(f"{label}: bands {shapes} take {routes} {geos}")
                    if (kept["routes"]["batched_conv_lnl:fft"] != nb
                            or kept["routes"]["batched_conv_lnl:fft:mixed"] != 1):
                        raise AssertionError(f"{label}: conv_lnl's routes {kept['routes']}")
                log(f"{label}: model_galaxy_mcmc(criticism=True), {NWALKERS} walkers, "
                    f"{burn} + {sample} steps: {kept['wall']:.2f} s; the block "
                    f"({ndraws} draws, chunks of {kept['chunk']}) launched {kept['launches']}"
                    f" (want {want}), routes {kept['routes']}; the call launched "
                    f"{kept['total'][0]}")
                if kept["launches"] != want:
                    raise AssertionError(f"{label}: the block's launches {kept['launches']}, "
                                         f"want {want}")
                checks = criticism_kernel_checks(model, kept["thetas"], kept["chunk"], label)
                secs = kept["s"]
                res.update(
                    draws=ndraws, pixels=int(kept["ll"].shape[1]),
                    launches=kept["launches"], routes=kept["routes"],
                    call_launches=dict(kept["total"][0], **kept["total"][1]),
                    fit_wall_s=kept["wall"], block_s=secs["block"],
                    replay_s=secs["replay"], psis_loo_s=secs["psis_loo"],
                    loo_pit_s=secs["loo_pit"],
                    sensitivity_replay_s=secs["sensitivity_replay"],
                    sensitivity_host_s=secs["sensitivity_host"], kernel_checks=checks)
                # the replay's device time alone: every band's chunks, events
                fns = [f for f in getattr(model.posterior_fns, "band_fns",
                                          [model.posterior_fns])]
                th = [f.as_thetas(kept["thetas"]) for f in fns]

                def replay():
                    with torch.no_grad():
                        for f, t in zip(fns, th):
                            for lo in range(0, ndraws, kept["chunk"]):
                                f.pointwise_lnl_and_cdf(t[lo:lo + kept["chunk"]])

                res["replay_device_ms"] = time_ms(replay, reps=3, inner=1)
                log(f"{label}: the block {secs['block']:.3f} s: pointwise replay "
                    f"{secs['replay']:.3f} s (device {res['replay_device_ms']:.2f} ms; "
                    f"{2 * 8 * ndraws * res['pixels'] / 1e6:.1f} MB to the host), PSIS-LOO "
                    f"{secs['psis_loo']:.3f} s, LOO-PIT (PSIS + KS) {secs['loo_pit']:.3f} s, "
                    f"power-scaling replay {secs['sensitivity_replay']:.3f} s and host "
                    f"{secs['sensitivity_host']:.3f} s ({CARD})")
                out[kind] = res
    finally:
        os.environ.pop("PSFMC_LNPOST", None)
        os.environ.update(env)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"criticism: the phase took {out['wall_s']:.1f} s ({CARD})")
    return out


def profile_adam(program, z0, steps=STEADY):
    """Device time by kernel over ten replays of the captured Adam step
    (torch.profiler): busy time, kernels per step and idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def replays():  # the captured step only, uncounted: timing
        program.reset(z0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            program.graph.replay()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    replays()
    unprofiled = replays()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = replays()
    rows = []
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        rows.append((dev_us, e.count, e.key))
    busy = sum(r[0] for r in rows) * 1e-6
    log(f"profile: {steps} replayed Adam steps ({program.z.shape[0]} starts), "
        f"{wall * 1e3:.3f} ms wall, device busy {busy * 1e3:.3f} ms in "
        f"{sum(r[1] for r in rows) / steps:.0f} kernels a step, idle share "
        f"{1.0 - busy / wall:.3f}; unprofiled {unprofiled * 1e3:.3f} ms wall, idle "
        f"share {1.0 - busy / unprofiled:.3f}")
    for dev_us, count, key in sorted(rows, reverse=True)[:15]:
        log(f"profile:   {dev_us / steps / 1e3:9.4f} ms/step  {count // steps:4d} "
            f"launches/step  {key[:90]}")


def prior_draws_general(spec, n):
    """Prior draws with the PSF index on and beside its .5 points."""
    from psfmc_tpu_torch.flagship import prior_draws

    th = prior_draws(spec, n, seed=SEED + 3)
    if "PSF_Index" in spec.param_names:
        off = next(s.offset for s in spec.slots if s.name == "PSF_Index")
        th[:, off] = np.resize([0.5, 1.5, 0.49, 1.0, 0.0, 0.51], n)
    return th


def graph_phase(post, spec):
    """The graphed phase against the sampler's private eager loop, for
    each move, on ``post``'s path at full width: 4 burn + 6 retained
    steps from one state with ``thin=2`` and ``track_moments``."""
    from psfmc_tpu_torch.sampler.ensemble import MOVES

    for moves in MOVES:
        graphed_against_eager(post, spec, f"graph, moves={moves}", GRAPH_BURN,
                              GRAPH_SAMPLE, moves=moves, thin=2, track_moments=True)


def same_bits(x, y):
    """Equal bit for bit (NaN where the other has NaN)."""
    import torch

    x, y = torch.as_tensor(x).cpu(), torch.as_tensor(y).cpu()
    if x.is_floating_point():
        if not torch.equal(torch.isnan(x), torch.isnan(y)):
            return False
        x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
        y = torch.where(torch.isnan(y), torch.zeros_like(y), y)
    return x.dtype == y.dtype and torch.equal(x, y)


def differing_state(a, b):
    """What differs between two samplers' states, chains and generators."""
    sa, sb = a.state, b.state
    pairs = {"positions": (sa.positions, sb.positions),
             "log_prob": (sa.log_prob, sb.log_prob),
             "naccept": (sa.naccept, sb.naccept),
             "accum_count": (sa.accum_count, sb.accum_count),
             "generator": (a.generator.get_state(), b.generator.get_state()),
             "chain": (a.chain, b.chain),
             "lnprobability": (a.lnprobability, b.lnprobability)}
    pairs.update({f"accum.{k}": (v, sb.accum[k]) for k, v in sa.accum.items()})
    pairs.update({f"moments.{k}": (v, sb.moments[k])
                  for k, v in (sa.moments or {}).items()})
    return [k for k, (x, y) in pairs.items() if not same_bits(x, y)]


def profile_phase(sampler, label, steps=STEADY):
    """Device time by kernel over a segment of retained steps
    (torch.profiler), as graph replays and eagerly, with the device's
    busy time and idle share."""
    for mode in ("graphed", "eager"):
        log(f"profile: {label}, {mode}")
        profile_steps(sampler, steps, eager=mode == "eager")


def profile_steps(sampler, steps, eager):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from psfmc_tpu_torch.sampler.ensemble import _eager

    walls = []
    for _ in range(2):  # the first captures what the window replays
        with _eager(sampler) if eager else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sampler.run_sampling(steps)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    with _eager(sampler) if eager else contextlib.nullcontext(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
        f"busy {busy * 1e3:.3f} ms in {sum(r[1] for r in rows) / steps:.0f} "
        f"kernels a step, idle share {1.0 - busy / wall:.3f}; the "
        f"same steps unprofiled just before: {walls[1] * 1e3:.3f} ms wall, "
        f"idle share {1.0 - busy / walls[1]:.3f}")
    for dev_us, count, key in sorted(rows, reverse=True)[:15]:
        log(f"profile:   {dev_us / steps / 1e3:9.4f} ms/step  {count // steps:4d} "
            f"launches/step  {key[:90]}")
    if not rows:
        log("profile: the profiler recorded no device time")
    return {"wall_ms": walls[1] * 1e3 / steps, "busy_ms": busy * 1e3 / steps,
            "kernels": sum(r[1] for r in rows) / steps,
            "idle_share": 1.0 - busy / walls[1]}


def render_geometry_phase(post, spec):
    """The render kernel at the main path's shape under other launch
    geometries than ``launch_geometry`` picks (blocks that walk several
    strips, larger blocks, a block's walkers one at a time), and with no
    Sersic at all: the image's write alone."""
    import torch

    from psfmc_tpu_torch.flagship import prior_draws
    from psfmc_tpu_torch.ops.kernels import sersic_render as SR

    thetas = torch.as_tensor(prior_draws(spec, B_HALF, seed=1),
                             dtype=torch.float32, device=post.device)
    params, sky = (t.contiguous() for t in post.render_inputs(thetas))
    shape = spec.shape
    h = shape[0]
    tile = SR.pick_tile(B_HALF)
    for walkers, geometries in (
            (1, [(32, 4, 1, h // 8), (32, 4, 1, h // 16), (32, 4, 1, h // 32),
                 (32, 4, 1, 1), (32, 8, 1, h // 8), (32, 2, 1, h // 2)]),
            (tile, [(32, 4, 1, h // 4), (32, 1, 8, h), (32, 2, 2, h // 2)])):
        picked = SR.launch_geometry(shape, walkers)
        want = SR._launch(params, sky, shape, walkers)
        for g in [picked] + geometries:
            got = SR._launch(params, sky, shape, walkers, g)
            if not torch.equal(got.nan_to_num(nan=0.0), want.nan_to_num(nan=0.0)):
                raise AssertionError(f"render geometry {g} changes the image")
            ms = time_ms(lambda: SR._launch(params, sky, shape, walkers, g))
            log(f"render: {walkers} walkers a block, block {g[:3]}, {g[3]} "
                f"strips a walker block{' (picked)' if g is picked else ''}: "
                f"{ms:.4f} ms")
    none = params[:, :0].contiguous()
    log(f"render: no Sersic (the sky written to {B_HALF} images): "
        f"{time_ms(lambda: SR.render_sersics(none, sky, shape)):.4f} ms")
    by_count = {}
    for n in (1, 2, 3):
        rows = torch.cat([params, params], 1)[:, :n].contiguous()
        by_count[n] = time_ms(lambda: SR.render_sersics(rows, sky, shape))
    slots = ((by_count[3] - by_count[1]) / 2 * 1e-3 * sfu_results_per_s()
             / SFU_RESULTS_PER_CLOCK_PER_SM * 4 / (B_HALF * shape[0] * shape[1] / 32))
    log("render: by Sersic count " + ", ".join(
        f"{n}: {ms:.4f} ms" for n, ms in by_count.items())
        + f"; one more Sersic costs {slots:.1f} scheduler slots per warp and "
        f"evaluation (4 schedulers per SM, one instruction a clock each)")
    render_sass_count(params.shape[1])


def render_sass_count(num_sersic):
    """Instructions per profile evaluation in the render kernel's inner
    loop, read from the built library with ``cuobjdump -sass``: the loop
    is the shortest backward branch around an ``ex2``, and every
    evaluation has two of them (one per ``expf``)."""
    import re

    from psfmc_tpu_torch.ops.kernels import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        log("render: no cuobjdump beside nvcc; instructions not counted")
        return
    sass = subprocess.run([tool, "-sass", _build._target("sersic_render")[1]],
                          capture_output=True, text=True, check=True).stdout
    for body in sass.split("Function : ")[1:]:
        if f"sersic_render_kernelILi{num_sersic}E" not in body.split("\n", 1)[0]:
            continue
        code = [(int(m.group(1), 16), m.group(2)) for m in re.finditer(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]+);", body)]
        loops = []
        for addr, text in code:
            m = re.search(r"\bBRA\b.*\b0x([0-9a-f]+)", text)
            if m and int(m.group(1), 16) < addr:
                inside = [t for a, t in code if int(m.group(1), 16) <= a <= addr]
                ex2 = sum("MUFU.EX2" in t for t in inside)
                if ex2:
                    loops.append((len(inside), ex2, sum("MUFU" in t for t in inside)))
        n, ex2, mufu = min(loops)
        log(f"render: the {num_sersic}-Sersic kernel's inner loop is {n} "
            f"instructions for {ex2 // 2} evaluations ({mufu} of them on the "
            f"special-function units): {2 * n / ex2:.1f} instructions per "
            f"evaluation")
        return
    raise AssertionError("the render kernel was not found in the SASS listing")


STEP_TIMES_STEPS = 5  # Adam steps that capture the joint MAP's step before it is timed


def step_times_phase(psf_shape=(64, 64), bands=None):
    """For each band 1 shape of ``bands`` (74x74, the padded route, 98x98,
    the radix-7 geometry, and 94x94, the cluster route (the matmul-DFT
    route on a tree without it), unless given): the two captured steps
    that run conv_lnl at that shape inside the joint flagship, each
    replayed back to back and timed
    by CUDA events (:func:`time_ms`): the offset variant's retained sampler
    step at 250 walkers (band 1's conv_lnl twice a step, once per half
    ensemble) and the joint MAP's Adam step at 64 starts; then a digest of
    each built kernel's SASS (:func:`sass_digests`).  It calls only what the
    port has had since its gradient path, so that it times an earlier tree
    of the port too: copy this file to the root of that tree and run
    ``python3 chip_smoke.py --step-times`` there.  Two trees compare only
    within one call to the card, in turns (a, b, b, a).  Returns
    ``{"<H>x<W>": times}``."""
    from psfmc_tpu_torch import optimize
    from psfmc_tpu_torch.flagship import (
        JOINT_SHAPES,
        joint_components,
        joint_map_components,
        prior_draws,
    )
    from psfmc_tpu_torch.models import JointModel
    from psfmc_tpu_torch.ops.kernels.conv_lnl import conv_route
    from psfmc_tpu_torch.sampler import EnsembleSampler

    result = {}
    for band in bands or (PADDED_SHAPE, RADIX7_SHAPE, CLUSTER_SHAPE):
        shapes = (JOINT_SHAPES[0], tuple(band))
        out = {"band": list(shapes[1]), "route": conv_route(shapes[1])}
        model = JointModel(joint_components(shapes, psf_shape, "offset"))
        spec = model.spec
        sm = EnsembleSampler(NWALKERS, spec.num_params, model.posterior_fns, seed=SEED)
        sm.init_state(prior_draws(spec, NWALKERS, seed=SEED + 1))
        sm.run_burn(2)
        sm.reset()
        sm.run_sampling(2)  # captures the retained step's graph
        out["offset_retained_step_ms"] = time_ms(lambda: sm._step("retain"))
        map_bands, _ = joint_map_components(shapes, psf_shape, seed=SEED)
        jm = JointModel(map_bands)
        optimize.fit_map(jm.posterior_fns, n_starts=MAP_STARTS, steps=STEP_TIMES_STEPS,
                         seed=SEED)
        program = map_program(jm.posterior_fns)
        out["joint_map_adam_step_ms"] = time_ms(program.graph.replay)
        log(f"step times, band 1 at {shapes[1][0]}x{shapes[1][1]} (conv_lnl's "
            f"{out['route']} route): the offset variant's retained step "
            f"{out['offset_retained_step_ms']:.4f} ms replayed ({NWALKERS} walkers), "
            f"the joint MAP's Adam step {out['joint_map_adam_step_ms']:.4f} ms "
            f"replayed ({MAP_STARTS} starts)")
        result[f"{band[0]}x{band[1]}"] = out
    return result


def sass_digests():
    """``{source: {kernel: digest}}``: the first 12 hex digits of the SHA-1
    of each kernel's SASS in each built library (``cuobjdump -sass``), so
    that two trees' runs show which kernels' binary code differs.  A
    kernel's name drops its anonymous namespace's hash, which nvcc derives
    from the source's path."""
    import hashlib
    import re

    from psfmc_tpu_torch.ops.kernels import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = {}
    for name in _build.SOURCES:
        sass = subprocess.run([tool, "-sass", _build._target(name)[1]],
                              capture_output=True, text=True, check=True).stdout
        out[name] = {}
        for body in sass.split("Function : ")[1:]:
            head, code = body.split("\n", 1)
            kernel = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", head.strip())
            out[name][kernel] = hashlib.sha1(code.encode()).hexdigest()[:12]
    return out


PHASES = ("load or render", "pack", "forward rows", "forward columns",
          "pointwise step", "inverse columns", "inverse rows", "lnL readout",
          "final reduction")


def phase_clocks_phase(post, spec):
    """Cycles per phase of block 0 of both FFT-route kernels, on the
    kernel phase's inputs, and of conv_lnl's mixed-radix geometry at
    96x96 and, with radix-7 stages, at 98x98, and of its padded route at
    74x74 (a 150x150 transform).  The two sources are built once more here with
    ``-DPSFMC_FFT_STAMPS`` (``csrc/fft_conv.cuh``) into a temporary
    directory and called through ctypes; the port never loads that build.
    The fused kernel's first phase is its render; it is also built with
    two and four pixels of a row side by side in a thread
    (``-DPSFMC_FUSED_RUN``), to show what the choice of one costs or saves."""
    import ctypes

    import torch

    from psfmc_tpu_torch.flagship import flagship_components, prior_draws
    from psfmc_tpu_torch.models import build_model_spec, build_posterior
    from psfmc_tpu_torch.ops.kernels import _build
    from psfmc_tpu_torch.ops.kernels import conv_lnl as CL
    from psfmc_tpu_torch.ops.kernels import fused_lnl as FL

    void, integer = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def conv_call(p, s):
        th = torch.as_tensor(prior_draws(s, B_HALF, seed=1), dtype=torch.float32,
                             device=p.device)
        raws = p.raw_and_ps(th)[0].contiguous()
        b, h, w = raws.shape
        out = torch.empty((b,), dtype=torch.float32, device=p.device)
        if CL.conv_route((h, w)) == "padded":  # one target: 1 walker a target, strides 0
            symbol, names = "conv_lnl_padded_launch", CL.PADDED_CONST_ARGS
            ints = [b, h, w, *p.consts.padded_shape, 1, 0, 0]
        else:
            symbol, names = "conv_lnl_fft_launch", CL.CONV_FFT_CONST_ARGS
            ints = [b, h, w, 1, 0, 0]
        ptrs = [getattr(p.consts, n).data_ptr() for n in names]
        # the posterior and raws stay referenced: the launch reads them by address
        return (symbol, [void] + [integer] * len(ints),
                [raws.data_ptr()] + ints + ptrs + [out.data_ptr(), stream],
                out, CL.batched_conv_lnl(raws, p.consts), (p, raws))

    thetas = torch.as_tensor(prior_draws(spec, B_HALF, seed=1),
                             dtype=torch.float32, device=post.device)
    scalars = [t.contiguous() for t in (*post.render_inputs(thetas),
                                        *post.pointsource_inputs(thetas))]
    consts = post.consts
    h, w = spec.shape
    b = scalars[0].shape[0]
    out = torch.empty((b,), dtype=torch.float32, device=post.device)
    fused_ptrs = [getattr(consts, n).data_ptr() for n in CL.CONV_FFT_CONST_ARGS]
    calls = {"conv_lnl": conv_call(post, spec)}
    for key, shape, psf_shape in (("conv_lnl_mixed", MIXED_SHAPE, MIXED_PSF_SHAPE),
                                  ("conv_lnl_radix7", RADIX7_SHAPE, RADIX7_PSF_SHAPE),
                                  ("conv_lnl_padded", PADDED_SHAPE, PADDED_PSF_SHAPE)):
        other = build_model_spec(flagship_components(shape, psf_shape))
        calls[key] = conv_call(build_posterior(other, device=post.device,
                                               lnpost="batched"), other)
    calls.update({
        "fused_lnl": ("fused_lnl_fft_launch", [void] * 4 + [integer] * 5,
                      [t.data_ptr() for t in scalars]
                      + [b, scalars[0].shape[1], scalars[2].shape[1], h, w]
                      + fused_ptrs + [out.data_ptr(), stream],
                      out, FL.fused_lnl(*scalars, consts), scalars),
    })
    # (label, source, call, extra flags): the two kernels as the port
    # builds them, conv_lnl at 96x96, 98x98 and 74x74, then the fused kernel with more pixels
    # of a row side by side in a thread than csrc/fused_lnl.cu's kFixedRun
    variants = [("conv_lnl", "conv_lnl", "conv_lnl", ()),
                (f"conv_lnl {MIXED_SHAPE[0]}x{MIXED_SHAPE[1]} (mixed radix)",
                 "conv_lnl", "conv_lnl_mixed", ()),
                (f"conv_lnl {RADIX7_SHAPE[0]}x{RADIX7_SHAPE[1]} (radix 7)",
                 "conv_lnl", "conv_lnl_radix7", ()),
                (f"conv_lnl {PADDED_SHAPE[0]}x{PADDED_SHAPE[1]} (padded route)",
                 "conv_lnl", "conv_lnl_padded", ()),
                ("fused_lnl", "fused_lnl", "fused_lnl", ())]
    variants += [(f"fused_lnl, {n} pixels a thread", "fused_lnl", "fused_lnl",
                  (f"-DPSFMC_FUSED_RUN={n}",)) for n in (2, 4)]
    with tempfile.TemporaryDirectory() as tmp:
        sources = list(dict.fromkeys((name, flags) for _, name, _, flags in variants))
        builds = [subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-DPSFMC_FFT_STAMPS", *flags,
             "-o", os.path.join(tmp, f"{i}.so"),
             os.path.join(_build._CSRC, name + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for i, (name, flags) in enumerate(sources)]
        for i, build in enumerate(builds):
            nvcc_log, _ = build.communicate()
            if build.returncode != 0:
                raise RuntimeError(f"nvcc failed for the stamped {sources[i]}:\n"
                                   + nvcc_log)
        for label, name, call, flags in variants:
            symbol, argtypes, args, out, want, _ = calls[call]
            lib = ctypes.CDLL(os.path.join(tmp, f"{sources.index((name, flags))}.so"))
            launch = getattr(lib, symbol)
            launch.argtypes = argtypes + [void] * (len(args) - len(argtypes))
            launch.restype = integer
            lib.fft_phase_clocks.argtypes = [void]
            lib.fft_phase_clocks.restype = integer
            for _ in range(3):  # warm: the last launch is the one read
                if launch(*args) != 0:
                    raise RuntimeError(f"the stamped {label} did not launch")
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"{label}: the stamped build disagrees")
            stamps = (ctypes.c_longlong * (len(PHASES) + 1))()
            if lib.fft_phase_clocks(ctypes.addressof(stamps)) != 0:
                raise RuntimeError(f"{label}: the phase clocks were not read")
            clocks = [stamps[j + 1] - stamps[j] for j in range(len(PHASES))]
            total = sum(clocks)
            log(f"phases: {label} FFT route, block 0, {total} SM cycles: "
                + ", ".join(f"{k} {v} ({v / total:.3f})"
                            for k, v in zip(PHASES, clocks)))


# the batch phase (17): K independent fits as one graphed ensemble
BATCH_TARGETS = 32  # the flagship batch: 32 mocks, 2 dim + 2 = 38 walkers each
BATCH_BURN, BATCH_SAMPLE, BATCH_RECORD = 20, 20, 5
BATCH_CHECK = (4, 3)  # targets x walkers of the lnpost check against the CPU's float64
BATCH_CHUNK_TARGETS, BATCH_CHUNK, BATCH_CHUNK_STEPS = 10, 4, 4  # 3 chunks, the last padded
BATCH_SURVEY_TARGETS, BATCH_SURVEY_STEPS = 8, 5  # survey mode: a PSF star per target
BATCH_STAR_SIGMAS = (1.6, 2.4)  # px, the survey targets' Gaussian PSF stars
BATCH_JOINT_TARGETS, BATCH_JOINT_STEPS = 4, 10  # the joint flagship's batch
BATCH_ROUTE_STEPS = 2  # joint batches with band 1 on the padded and cluster routes
SBC_SIMS, SBC_BURN, SBC_SAMPLE, SBC_RECORD = 16, 10, 20, 5


def psf_stars(n, psf_shape, seed):
    """``n`` Gaussian PSF stars of widths in :data:`BATCH_STAR_SIGMAS` and
    their IVMs."""
    rng = np.random.RandomState(seed)
    ph, pw = psf_shape
    yy, xx = np.mgrid[0:ph, 0:pw].astype(float)
    stars = []
    for s in rng.uniform(*BATCH_STAR_SIGMAS, n):
        p = np.exp(-((xx - pw / 2) ** 2 + (yy - ph / 2) ** 2) / (2 * s * s))
        stars.append(p / p.sum())
    return stars, [np.full(psf_shape, 1e8)] * n


def target_row(name, post, spec, stack, raws, library_spectra):
    """conv_lnl with a stacked consts (``stack``: each target's planes and,
    in survey mode, spectra) on ``raws``, walker-major by target: held to
    the plain version on the same inputs (:data:`CONV_LNL_TOL` per walker,
    the same non-finite entries), timed beside the shared-constants launch
    on the same walkers (``shared_ms``), the plain version and a
    ``torch.fft`` composite (``library_spectra``: the complex half spectra
    it convolves with, shared or ``(K, 1, H, W//2+1)``), with its bound."""
    import torch

    from psfmc_tpu_torch.ops import convolve, gaussian_lnlike
    from psfmc_tpu_torch.ops.kernels import _build
    from psfmc_tpu_torch.ops.kernels import conv_lnl as CL

    b, h, w = raws.shape
    nt = stack.targets
    route = CL.conv_route((h, w))
    got = CL.batched_conv_lnl(raws, stack)
    want = CL.batched_conv_lnl_plain(raws, stack)
    abs_err, rel, frac = compare(got, want)
    log(f"{name}: {nt} targets x {b // nt} walkers at {h}x{w} ({route} route"
        f"{', per-target spectra' if stack.target_spectra else ''}): max rel err "
        f"{rel:.3e} (tol {CONV_LNL_TOL:g}), max abs err {abs_err:.3e}, finite share "
        f"{frac:.4f}")
    if frac < 0.5 or not rel <= CONV_LNL_TOL:
        raise AssertionError(f"{name} disagrees with its plain version")
    f_psf, f_var = library_spectra

    def library():  # the torch.fft formulation, a yardstick only
        x = raws.reshape(nt, b // nt, h, w)
        conv = convolve(x, f_psf)
        mvar = convolve(x * x, f_var)
        return gaussian_lnlike(stack.obs[:, None] - conv,
                               1.0 / (mvar + stack.obs_var[:, None]),
                               stack.good[:, None]).reshape(b)

    lib = library()
    if route != "global":
        _, lib_rel, _ = compare(lib, want)
    else:  # a yardstick (likelihood_rows)
        both = torch.isfinite(lib) & torch.isfinite(want)
        lib_rel = ((lib - want).abs()[both] / want[both].abs()).max().item()
    data_bytes = 4 * sum(t.numel() for t in (
        stack.psf_r, stack.psf_i, stack.var_r, stack.var_i, stack.obs, stack.obs_var,
        stack.good_f))
    bms, by, term = bound(4 * raws.numel() + data_bytes + 4 * b, conv_lnl_ops(b, h, w))
    shared = post.consts
    row = dict(
        name=name, route="cuda", source=_build.source_path("conv_lnl"),
        replaces="psfmc_tpu/ops/pallas/lnpost_batched.py:191", launches=0,
        max_abs_err=abs_err, max_rel_err=rel,
        ms=time_ms(lambda: CL.batched_conv_lnl(raws, stack)),
        plain_ms=time_ms(lambda: CL.batched_conv_lnl_plain(raws, stack)),
        bound_ms=bms, bound_by=by, bound_term=term, library_ms=time_ms(library),
        shared_ms=time_ms(lambda: CL.batched_conv_lnl(raws, shared)),
        conv_route=route, geometry=fft_geometry((h, w)), targets=nt, walkers=b,
        target_spectra=stack.target_spectra, library_rel_diff=lib_rel)
    if route == "cluster" and not stack.target_spectra:  # the former route, same inputs
        _, dft_rel, _ = compare(CL._launch(raws, stack, "dft"), want)
        if not dft_rel <= CONV_LNL_TOL:
            raise AssertionError(f"{name}: the matmul-DFT route disagrees ({dft_rel:.3e})")
        row["dft_route_ms"] = time_ms(lambda: CL._launch(raws, stack, "dft"))
    log(f"{name}: {row['ms']:.4f} ms (shared constants {row['shared_ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, torch.fft {row['library_ms']:.4f} ms), bound "
        f"{bms:.5f} ms by {by} ({term}), {row['ms'] / bms:.1f}x the bound ({CARD})")
    return row


def target_rows(nt, per, psf_shape, device):
    """The per-target rows at ``nt`` targets x ``per`` walkers (the flagship
    batch's half-step launch): conv_lnl with per-target planes on the
    radix-2 FFT route (the flagship's shape), the mixed-radix geometry,
    the padded and the cluster route, and with per-target spectra on the
    FFT and the cluster route (:func:`target_row`)."""
    import torch

    from psfmc_tpu_torch.batchfit import prepare_psf_stack
    from psfmc_tpu_torch.flagship import flagship_components, prior_draws
    from psfmc_tpu_torch.models import build_model_spec, build_posterior
    from psfmc_tpu_torch.ops.kernels import conv_lnl as CL

    rows = []
    cases = (("conv_lnl_targets", FLAGSHIP_SHAPE, psf_shape, "fft", False),
             ("conv_lnl_targets_spectra", FLAGSHIP_SHAPE, psf_shape, "fft", True),
             ("conv_lnl_targets_mixed", MIXED_SHAPE, MIXED_PSF_SHAPE, "fft", False),
             ("conv_lnl_targets_padded", PADDED_SHAPE, PADDED_PSF_SHAPE, "padded", False),
             ("conv_lnl_targets_cluster", CLUSTER_SHAPE, CLUSTER_PSF_SHAPE, "cluster", False),
             ("conv_lnl_targets_cluster_spectra", CLUSTER_SHAPE, CLUSTER_PSF_SHAPE, "cluster",
              True))
    for i, (name, shape, pshape, route, spectra) in enumerate(cases):
        if CL.conv_route(shape) != route:
            raise AssertionError(f"{name}: {shape} takes {CL.conv_route(shape)}, not {route}")
        spec = build_model_spec(flagship_components(shape, pshape))
        post = build_posterior(spec, device=device, lnpost="batched")
        thetas = torch.as_tensor(prior_draws(spec, nt * per, seed=1), dtype=torch.float32,
                                 device=post.device)
        raws = post.raw_and_ps(thetas)[0].contiguous()
        rng = np.random.RandomState(SEED + 40 + i)
        obs = np.asarray(spec.obs_data)[None] + rng.randn(nt, *shape) * 0.005
        var = np.asarray(spec.obs_var)[None] * rng.uniform(0.5, 2.0, (nt, 1, 1))
        good = rng.rand(nt, *shape) > 0.02
        if spectra:
            stars, ivms = psf_stars(nt, pshape, SEED + 41)
            f = prepare_psf_stack(spec, stars, ivms, dtype=np.float64)
            f_psf = (f["psf_f_re"] + 1j * f["psf_f_im"])[:, 0]
            f_var = (f["var_f_re"] + 1j * f["var_f_im"])[:, 0]
        else:
            f_psf, f_var = spec.f_psf_stack[0], spec.f_var_stack[0]
        stack = CL.make_conv_lnl_consts_stack(f_psf, f_var, obs, var, good, post.device)
        lib = tuple(torch.as_tensor(np.asarray(f)[:, None] if spectra else f,
                                    dtype=torch.complex64, device=post.device)
                    for f in (f_psf, f_var))
        rows.append(target_row(name, post, spec, stack, raws, lib))
    return rows


def batch_fit_checks(label, res, nt, dim, record):
    """Per-target finite means and stds, acceptance in (0, 1), finite pulls
    (against ``record``'s injected truth) and, with chains, finite PSRFs."""
    injected = record.get("injected")
    ok = (res.mean.shape == (nt, dim) and np.isfinite(res.mean).all()
          and np.isfinite(res.std).all() and (res.std > 0).all()
          and np.all((res.acceptance > 0) & (res.acceptance < 1)))
    if injected is not None:
        ok = ok and np.isfinite(res.pulls(injected)).all()
    if res.chains is not None:
        ok = ok and np.isfinite(res.psrf()).all()
    if not ok:
        raise AssertionError(f"{label}: a target's result is not finite or its "
                             f"acceptance {res.acceptance} is outside (0, 1)")


def batch_phase(shape=None, psf_shape=(64, 64), joint_shapes=None, device=None):
    """Batch fits on the card (the arguments shrink it for a rehearsal on the
    CPU).  The flagship model file; :func:`~psfmc_tpu_torch.batchfit.
    simulate_stack` of :data:`BATCH_TARGETS` mocks; ``fit_batch`` at 38
    walkers a target (608 a half-step launch), 20 + 20 steps, every fifth
    recorded: every step a graph replay, the render and conv_lnl's
    per-target launches exact, each target's results finite, the lnpost at
    :data:`BATCH_CHECK` against the CPU's float64, the call's wall time,
    the replayed step's device time and one single fit's beside it.  Then
    chunking (10 targets in chunks of 4: one capture a step variant reused
    by every chunk, the graphed fit equal to the eager one bit for bit,
    and swapping two targets of different chunks changing exactly their
    rows), conv_lnl with per-target planes (and spectra) on every route at
    608 walkers (:func:`target_rows`), survey mode (a PSF star per target;
    again at 94x94, where the per-target spectra take the cluster route),
    the joint flagship's batch (and two short ones with band 1 on the
    padded and the cluster route), and ``run_sbc``.  After each fit the
    render and conv_lnl are held against their plain versions at its
    half-step batch, each band on its own shape and stack (608 walkers on
    the flagship batch).  Returns the rows, each row's launches on these
    paths, the render's, the numbers and those checks."""
    import torch

    from psfmc_tpu_torch import batchfit as BF
    from psfmc_tpu_torch.analysis.sbc import run_sbc
    from psfmc_tpu_torch.flagship import (
        JOINT_SHAPES,
        joint_components,
        prior_draws,
        write_flagship_files,
    )
    from psfmc_tpu_torch.models import JointModel, as_model
    from psfmc_tpu_torch.ops.kernels.conv_lnl import conv_route
    from psfmc_tpu_torch.sampler import EnsembleSampler

    shape = FLAGSHIP_SHAPE if shape is None else shape
    joint_shapes = JOINT_SHAPES if joint_shapes is None else joint_shapes
    counted = counted_kernels()
    t_phase = time.perf_counter()
    out = {}
    env = {k: os.environ.pop(k) for k in ("PSFMC_LNPOST", "PSFMC_RENDER", "PSFMC_KAPPA")
           if k in os.environ}

    def sync(dev):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def counted_fit(label, model, *args, **kwargs):
        """``fit_batch`` with the counts set to 0 just before and read just
        after; its wall time ending in a synchronize."""
        sync(model.posterior_fns.device)
        reset_counts(counted)
        t0 = time.perf_counter()
        res = BF.fit_batch(model, *args, **kwargs)
        sync(model.posterior_fns.device)
        wall = time.perf_counter() - t0
        launches, routes = read_counts(counted)
        log(f"{label}: {wall:.3f} s, launched {launches}, conv_lnl's routes "
            f"{ {k: v for k, v in routes.items() if k.startswith('batched') and v} }")
        return res, wall, launches, routes

    checks = []  # the kernels against their plain versions at each fit's batch

    def check_batch(label, fit_fns):
        """The render and conv_lnl at the cached program's half-step batch
        (the first half of each target's walkers where the fit ended), each
        band on its own render shape and stack, against their plain
        versions (:func:`batch_kernel_check`)."""
        _, prog = fit_fns.__dict__["_batch_program"]
        k, w, d = prog.state.positions.shape
        thetas = prog.state.positions[:, : w // 2].reshape(k * (w // 2), d).contiguous()
        bands = getattr(fit_fns, "band_fns", None) or [fit_fns]
        for i, (f, stack) in enumerate(zip(bands, prog.stacks)):
            out = batch_kernel_check(f, thetas, f"{label}, band {i}", stack)
            out.update(fit=label, band=i, render_shape=list(f.render_shape),
                       target_spectra=stack.consts is not None and stack.consts.target_spectra)
            checks.append(out)

    def want_launches(label, launches, routes, bands, steps, keys, mocks=0):
        evals = 1 + 2 * steps  # the start, then two half-steps a step
        # (and the mocks' render of ``simulate_stack``, once a band)
        want = {"render_sersics": bands * (evals + mocks), "render_sersics_tiled": 0,
                "batched_conv_lnl": bands * evals, "fused_lnl": 0}
        want_routes = {f"batched_conv_lnl:{k}": n * evals for k, n in keys.items()}
        got_routes = {k: routes[k] for k in want_routes}
        if launches != want or got_routes != want_routes:
            raise AssertionError(f"{label}: launched {launches} on {got_routes}, want "
                                 f"{want} on {want_routes}")

    try:
        with tempfile.TemporaryDirectory() as tmp:
            model = as_model(write_flagship_files(tmp, shape, psf_shape), device=device)
            cpu = as_model(os.path.join(tmp, "model.py"), device="cpu", dtype=torch.float64)
        fns = model.posterior_fns
        dev = fns.device
        graphed = dev.type == "cuda"
        dim = model.num_params
        nw = 2 * dim + 2
        route = conv_route(shape)
        obs, ivm, injected = BF.simulate_stack(model, BATCH_TARGETS, seed=1)

        # conv_lnl with per-target planes (and spectra) on every route at the
        # flagship batch's half-step launch, against its plain version
        rows = target_rows(BATCH_TARGETS, nw // 2, psf_shape, device=dev)

        # the flagship batch: the main path
        fns.__dict__.pop("_batch_program", None)
        steps = BATCH_BURN + BATCH_SAMPLE
        res, wall, launches, routes = counted_fit(
            f"batch, {BATCH_TARGETS} flagship targets x {nw} walkers", model, obs, ivm,
            burn=BATCH_BURN, iterations=BATCH_SAMPLE, record_every=BATCH_RECORD)
        want_launches("batch", launches, routes, 1, steps, {f"{route}_targets": 1})
        _, program = fns.__dict__["_batch_program"]
        if graphed and (program.replays != steps or program.captures != 3):
            raise AssertionError(f"batch: {program.replays} replays and "
                                 f"{program.captures} captures for {steps} steps")
        check_batch("batch", fns)
        batch_fit_checks("batch", res, BATCH_TARGETS, dim, {"injected": injected})
        if res.chains.shape != (BATCH_TARGETS, BATCH_SAMPLE // BATCH_RECORD, nw, dim):
            raise AssertionError(f"batch: chains {res.chains.shape}")
        out["fit"] = {"targets": BATCH_TARGETS, "walkers": nw,
                      "half_step_walkers": BATCH_TARGETS * nw // 2, "burn": BATCH_BURN,
                      "sample": BATCH_SAMPLE, "wall_s": wall,
                      "fits_per_s": BATCH_TARGETS / wall, "launches": launches,
                      "replays": program.replays, "captures": program.captures,
                      "acceptance": [float(res.acceptance.min()),
                                     float(res.acceptance.max())],
                      "psrf_max": float(res.psrf().max())}
        for variant in ("retain", "burn"):  # a step's graph replayed back to back
            step = ((lambda: program.graphs[variant].graph.replay()) if graphed
                    else (lambda: program._step(variant)))
            out["fit"][f"{variant}_step_ms"] = time_ms(step)
        render_launches = launches["render_sersics"]
        row_launches = {"conv_lnl_targets": routes[f"batched_conv_lnl:{route}_targets"]}
        # the same call again, its graphs captured: the host's part and the steps
        again, warm, launches, routes = counted_fit(
            "batch, again (captured)", model, obs, ivm, burn=BATCH_BURN,
            iterations=BATCH_SAMPLE, record_every=BATCH_RECORD)
        want_launches("batch, again", launches, routes, 1, steps, {f"{route}_targets": 1})
        if (not np.array_equal(again.mean, res.mean) or fns.__dict__["_batch_program"][1]
                is not program or (graphed and program.captures != 3)):
            raise AssertionError("batch: the second call differs or captured again")
        out["fit"]["warm_wall_s"] = warm
        render_launches += launches["render_sersics"]
        row_launches["conv_lnl_targets"] += routes[f"batched_conv_lnl:{route}_targets"]

        # the lnpost of a few targets' walkers against the CPU's float64
        nt, nwk = BATCH_CHECK
        stack = BF.prepare_obs_stack(model.spec, obs[:nt], ivm[:nt])
        stack64 = BF.prepare_obs_stack(cpu.spec, obs[:nt], ivm[:nt], np.float64)
        th = prior_draws(model.spec, nt * nwk, seed=SEED + 42)
        got = fns.log_posterior_obs(th, stack).double().cpu()
        want = cpu.posterior_fns.log_posterior_obs(th, stack64)
        _, rel, frac = compare(got, want)
        log(f"batch: lnpost at {nt} targets x {nwk} walkers, card float32 against the "
            f"CPU's float64: max rel err {rel:.3e} (tol {SLICE_RTOL:g}), finite share "
            f"{frac:.3f}")
        if not (rel <= SLICE_RTOL and frac > 0):
            raise AssertionError("batch: the card's lnpost disagrees with the CPU's")
        out["fit"]["lnpost_rel_err"] = rel

        # one single fit of the same model and depth beside it: the
        # sampler's graphed steps at one target's 38 walkers
        single = EnsembleSampler(nw, dim, fns, seed=SEED, device=dev)
        p0 = model.init_params_from_priors(nw, random_state=np.random.RandomState(5))
        walls = []
        for _ in range(2):  # the first captures its graphs
            sync(dev)
            t0 = time.perf_counter()
            single.init_state(p0)
            single.run_burn(BATCH_BURN)
            single.run_sampling(BATCH_SAMPLE)
            sync(dev)
            walls.append(time.perf_counter() - t0)
        # its burn step (a retained step there records, thin 1)
        single_step = ((lambda: single._graphs["burn"].graph.replay()) if graphed
                       else (lambda: single._step("burn")))
        out["single"] = {"walkers": nw, "wall_s": walls,
                         "burn_step_ms": time_ms(single_step),
                         "serial_wall_s": BATCH_TARGETS * walls[1]}
        log(f"batch: {BATCH_TARGETS} targets in {wall:.3f} s ({BATCH_TARGETS / wall:.1f} "
            f"fits/s; again, captured, {warm:.3f} s; {steps} steps, a replayed retained step "
            f"{out['fit']['retain_step_ms']:.3f} ms, burn step "
            f"{out['fit']['burn_step_ms']:.3f} ms); one single fit {walls[0]:.3f} s "
            f"(capturing) then {walls[1]:.3f} s (a replayed burn step "
            f"{out['single']['burn_step_ms']:.3f} ms): {BATCH_TARGETS} single fits in "
            f"series {BATCH_TARGETS * walls[1]:.3f} s ({CARD})")

        # chunking: one capture a step variant, reused; each chunk its own data
        fns.__dict__.pop("_batch_program", None)
        cobs, civm, _ = BF.simulate_stack(model, BATCH_CHUNK_TARGETS, seed=2)
        kw = dict(burn=BATCH_CHUNK_STEPS, iterations=BATCH_CHUNK_STEPS, record_every=2,
                  chunk=BATCH_CHUNK, seed=3)
        first, *_ = counted_fit("batch, chunked", model, cobs, civm, **kw)
        _, chunked = fns.__dict__["_batch_program"]
        nchunks = -(-BATCH_CHUNK_TARGETS // BATCH_CHUNK)
        if graphed and (chunked.captures != 3
                        or chunked.replays != nchunks * 2 * BATCH_CHUNK_STEPS):
            raise AssertionError(f"batch, chunked: {chunked.captures} captures, "
                                 f"{chunked.replays} replays for {nchunks} chunks")
        if first.mean.shape != (BATCH_CHUNK_TARGETS, dim):
            raise AssertionError(f"batch, chunked: {first.mean.shape} rows")
        check_batch("batch, chunked", fns)
        with BF._eager():
            eager = BF.fit_batch(model, cobs, civm, **kw)
        same = [same_bits(torch.as_tensor(getattr(first, k)), torch.as_tensor(getattr(eager, k)))
                for k in ("mean", "std", "map_theta", "map_lnp", "acceptance", "chains")]
        swapped = cobs.copy()
        last = BATCH_CHUNK_TARGETS - 1
        swapped[[0, last]] = swapped[[last, 0]]
        other = BF.fit_batch(model, swapped, civm, **kw)
        changed = [not np.array_equal(other.mean[i], first.mean[i])
                   for i in range(BATCH_CHUNK_TARGETS)]
        log(f"batch, chunked: {BATCH_CHUNK_TARGETS} targets in {nchunks} chunks of "
            f"{BATCH_CHUNK}: {chunked.captures} captures, {chunked.replays} replays; "
            f"graphed equal to eager bit for bit {same}; swapping targets 0 and {last} "
            f"changed rows {[i for i, c in enumerate(changed) if c]}")
        if not all(same):
            raise AssertionError("batch, chunked: the graphed fit differs from the eager one")
        if changed != [i in (0, last) for i in range(BATCH_CHUNK_TARGETS)]:
            raise AssertionError("batch, chunked: the swap changed other rows than its own")
        out["chunked"] = {"captures": chunked.captures, "replays": chunked.replays,
                          "chunks": nchunks}

        # survey mode: each target's own PSF star, per-target spectra
        stars, star_ivms = psf_stars(BATCH_SURVEY_TARGETS, psf_shape, SEED + 43)
        sres, swall, slaunch, sroutes = counted_fit(
            "batch, survey", model, obs[:BATCH_SURVEY_TARGETS], ivm[:BATCH_SURVEY_TARGETS],
            burn=BATCH_SURVEY_STEPS, iterations=BATCH_SURVEY_STEPS, psf_stack=stars,
            psfivm_stack=star_ivms)
        want_launches("batch, survey", slaunch, sroutes, 1, 2 * BATCH_SURVEY_STEPS,
                      {f"{route}_targets": 1})
        batch_fit_checks("batch, survey", sres, BATCH_SURVEY_TARGETS, dim, {})
        survey_consts = fns.__dict__["_batch_program"][1].stacks[0].consts
        if survey_consts is None or not survey_consts.target_spectra:
            raise AssertionError("batch, survey: the program has no per-target spectra")
        check_batch("batch, survey", fns)
        render_launches += slaunch["render_sersics"]
        row_launches["conv_lnl_targets_spectra"] = sroutes[
            f"batched_conv_lnl:{route}_targets"]
        out["survey"] = {"targets": BATCH_SURVEY_TARGETS, "wall_s": swall}

        # survey mode at 94x94: the per-target spectra on the cluster route,
        # the kernel path (before the cluster route, the general path)
        with tempfile.TemporaryDirectory() as tmp:
            cmodel = as_model(write_flagship_files(tmp, CLUSTER_SHAPE, CLUSTER_PSF_SHAPE),
                              device=device)
        croute = conv_route(CLUSTER_SHAPE)
        cobs, civm, _ = BF.simulate_stack(cmodel, BATCH_SURVEY_TARGETS, seed=6)
        cstars, cstar_ivms = psf_stars(BATCH_SURVEY_TARGETS, CLUSTER_PSF_SHAPE, SEED + 44)
        cres, cwall, claunch, croutes = counted_fit(
            "batch, survey at 94x94", cmodel, cobs, civm, burn=BATCH_SURVEY_STEPS,
            iterations=BATCH_SURVEY_STEPS, psf_stack=cstars, psfivm_stack=cstar_ivms)
        want_launches("batch, survey at 94x94", claunch, croutes, 1,
                      2 * BATCH_SURVEY_STEPS, {f"{croute}_targets": 1, "dft_targets": 0})
        batch_fit_checks("batch, survey at 94x94", cres, BATCH_SURVEY_TARGETS,
                         cmodel.num_params, {})
        cstack = cmodel.posterior_fns.__dict__["_batch_program"][1].stacks[0]
        if cstack.mode != "batched" or not cstack.consts.target_spectra:
            raise AssertionError("batch, survey at 94x94: not on the kernel path with "
                                 f"per-target spectra ({cstack.mode})")
        check_batch("batch, survey at 94x94", cmodel.posterior_fns)
        render_launches += claunch["render_sersics"]
        row_launches["conv_lnl_targets_cluster_spectra"] = croutes[
            f"batched_conv_lnl:{croute}_targets"]
        out["survey_cluster"] = {"targets": BATCH_SURVEY_TARGETS, "wall_s": cwall,
                                 "shape": list(CLUSTER_SHAPE), "route": croute}

        # the joint flagship's batch, then band 1 on the padded and cluster routes
        for label, shapes, steps_j, row in (
                ("joint", joint_shapes, BATCH_JOINT_STEPS, "conv_lnl_targets_mixed"),
                ("joint, padded band", (joint_shapes[0], PADDED_SHAPE), BATCH_ROUTE_STEPS,
                 "conv_lnl_targets_padded"),
                ("joint, cluster band", (joint_shapes[0], CLUSTER_SHAPE),
                 BATCH_ROUTE_STEPS, "conv_lnl_targets_cluster")):
            joint = JointModel(joint_components(shapes, psf_shape), device=dev)
            jobs, jivm, _ = BF.simulate_stack(joint, BATCH_JOINT_TARGETS, seed=4)
            jres, jwall, jl, jr = counted_fit(
                f"batch, {label}", joint, jobs, jivm, burn=steps_j, iterations=steps_j)
            band_routes = [conv_route(s) for s in shapes]
            keys = {}
            for r in band_routes:
                keys[f"{r}_targets"] = keys.get(f"{r}_targets", 0) + 1
            want_launches(f"batch, {label}", jl, jr, len(shapes), 2 * steps_j, keys)
            batch_fit_checks(f"batch, {label}", jres, BATCH_JOINT_TARGETS, joint.num_params,
                             {})
            check_batch(f"batch, {label}", joint.posterior_fns)
            render_launches += jl["render_sersics"]
            band1 = f"batched_conv_lnl:{band_routes[1]}_targets"
            geo = fft_geometry(shapes[1])
            if geo in MIXED_GEOMETRIES:  # band 1 on the mixed-radix geometry
                band1_launches = jr[f"{band1}:{geo}"]
            else:
                band1_launches = jr[band1]
            row_launches[row] = band1_launches
            row_launches["conv_lnl_targets"] += jr[f"batched_conv_lnl:{band_routes[0]}_targets"] \
                - (band1_launches if band_routes[0] == band_routes[1] else 0)
            out[label] = {"shapes": [list(s) for s in shapes], "wall_s": jwall,
                          "routes": band_routes}

        # simulation-based calibration on the flagship
        sync(dev)
        reset_counts(counted)
        t0 = time.perf_counter()
        sbc = run_sbc(model, n_sims=SBC_SIMS, burn=SBC_BURN, iterations=SBC_SAMPLE,
                      record_every=SBC_RECORD)
        sync(dev)
        sbc_wall = time.perf_counter() - t0
        sl, sr = read_counts(counted)
        pvals = sbc.uniformity_pvalues()
        log(f"batch, sbc: {SBC_SIMS} simulations, {sbc.n_posterior} posterior draws "
            f"each, {sbc_wall:.3f} s; ranks in [{sbc.ranks.min()}, {sbc.ranks.max()}], "
            f"p-values in [{pvals.min():.3g}, {pvals.max():.3g}] ({CARD})")
        if not (np.all((sbc.ranks >= 0) & (sbc.ranks <= sbc.n_posterior))
                and np.isfinite(pvals).all() and sbc.ranks.shape == (SBC_SIMS, dim)):
            raise AssertionError("batch, sbc: ranks or p-values out of range")
        want_launches("batch, sbc", sl, sr, 1, SBC_BURN + SBC_SAMPLE, {f"{route}_targets": 1},
                      mocks=1)
        check_batch("batch, sbc", fns)
        render_launches += sl["render_sersics"]
        row_launches["conv_lnl_targets"] += sr[f"batched_conv_lnl:{route}_targets"]
        out["sbc"] = {"sims": SBC_SIMS, "n_posterior": sbc.n_posterior, "wall_s": sbc_wall,
                      "pvalue_min": float(pvals.min())}
    finally:
        os.environ.update(env)
    for r in rows:
        r["launches"] = row_launches[r["name"]]
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"batch: the phase took {out['wall_s']:.1f} s ({CARD})")
    return {"rows": rows, "render_launches": render_launches, "out": out,
            "kernel_checks": checks}


# the hierarchy phase (18): hierarchical fits over NUTS on the card
HIER_TARGETS = 16  # the flagship catalog: 16 mocks, 18 parameters each
HIER_POP = "2_Sersic_index"
HIER_CHAINS, HIER_POOL, HIER_DEPTH = 4, 16, 8
HIER_BURN, HIER_SAMPLE = 20, 20
HIER_SURVEY_TARGETS, HIER_SURVEY_STEPS, HIER_SURVEY_DEPTH = 8, 10, 6
HIER_JOINT_TARGETS, HIER_JOINT_STEPS, HIER_JOINT_DEPTH = 4, 5, 4
HIER_JOINT_BAND1 = (MIXED_SHAPE, PADDED_SHAPE, CLUSTER_SHAPE)  # band 1 on each route
HIER_ENSEMBLE_TARGETS, HIER_ENSEMBLE_STEPS = 4, 4
HIER_EQUAL, HIER_EQUAL_DEPTH = 2, 3  # graphed against eager: warmup and retained steps
HIER_CPU_ROWS = 8  # chain rows whose lnpost the CPU's float64 replays
HIER_ROW_WALKERS = 608  # the rows' second batch: the batch fit's half-step launch
HIER_GRAD_PLAIN = 4  # the gradient's bound at a fit's end: or 4x the CPU float32's error


def hier_population(noncentered=False):
    """``NormalPopulation`` on the first Sersic's index: mu ~ Uniform(0.5,
    5.5), sigma ~ Uniform(0.05, 3.05)."""
    from psfmc_tpu_torch.distributions import Uniform
    from psfmc_tpu_torch.hierarchy import NormalPopulation

    return {HIER_POP: NormalPopulation(mu=Uniform(loc=0.5, scale=5.0),
                                       sigma=Uniform(loc=0.05, scale=3.0))}


def hier_kernel_check(setup, big, label):
    """The kernels at a hierarchical batch (``big``: ``(C, K*d + h)`` rows,
    as the likelihood reads them: target-major, reconstructed under the
    non-centred form), each band on its own
    stack, against their plain versions: the render and conv_lnl with the
    stack's constants (:func:`batch_kernel_check`), and where the band is
    on the kernel path conv_lnl's residual forward (FFT and padded routes,
    :func:`residual_check`), its backward at the leaf's upstream
    gradient, within :data:`CONV_BWD_TOL` of the float64 scheme, and the
    render's backward at that image gradient (:func:`render_backward_check`)."""
    import torch

    from psfmc_tpu_torch.ops.kernels import conv_lnl as CL

    hier = setup.hier
    rows = hier.likelihood_rows(big).contiguous()
    out = []
    for i, band in enumerate(hier._bands):
        f, stack = band["fns"], band["obs"]
        check = batch_kernel_check(f, rows, f"{label}, band {i}", stack)
        check.update(band=i, shape=list(f.shape), route=CL.conv_route(f.shape),
                     target_spectra=stack.consts is not None and stack.consts.target_spectra)
        if stack.mode == "batched":
            consts = stack.consts
            c64 = hier_consts64(consts)
            raws = f.raw_and_ps(rows)[0].contiguous()
            lnl = CL.batched_conv_lnl(raws, consts)
            residuals, keep = None, torch.isfinite(lnl)
            if CL.conv_route(f.shape) != "dft":
                residuals, keep, check["conv_lnl_res"] = residual_check(
                    raws, consts, c64, lnl,
                    f"{label}, band {i}: conv_lnl's residual forward at B = {len(rows)}")
            up = torch.full((len(rows),), -1.0, dtype=torch.float32, device=raws.device)
            got = CL.batched_conv_lnl_backward(raws, consts, lnl, up, residuals)
            same_nonfinite(got, CL.batched_conv_lnl_backward_plain(raws, consts, lnl, up))
            want = CL.batched_conv_lnl_backward_plain(
                raws.double().cpu(), c64, lnl.double().cpu(), up.double().cpu()
            ).to(raws.device)
            err = normalized_err(got[keep], want[keep], dims=(1, 2))
            log(f"{label}, band {i}: conv_lnl's backward with {stack.targets} targets at "
                f"B = {len(rows)}: max normalized err {err:.3e} (tol {CONV_BWD_TOL:g}), "
                f"walkers compared {int(keep.sum())}")
            if not (err <= CONV_BWD_TOL and keep.sum().item() >= len(rows) // 2):
                raise AssertionError(f"{label}: conv_lnl's backward with targets disagrees "
                                     "with its plain version")
            check["conv_lnl_backward"] = dict(
                max_abs_err=(got[keep].double() - want[keep]).abs().max().item(),
                max_normalized_err=err)
            params, sky = (t.contiguous() for t in f.render_inputs(rows))
            check["render_backward"] = render_backward_check(
                params, sky, f.render_shape, got.contiguous(),
                f"{label}, band {i}: render backward at B = {len(rows)}")[2]
        out.append(check)
    return out


def hier_consts64(consts):
    """A stacked consts' float64 CPU twin, from its own float32 values
    (the plain schemes the kernels are held to in float64)."""
    import torch

    from psfmc_tpu_torch.ops.kernels import conv_lnl as CL

    def host(name):
        return getattr(consts, name).double().cpu().numpy()

    f_psf = host("psf_r") + 1j * host("psf_i")
    f_var = host("var_r") + 1j * host("var_i")
    return CL.make_conv_lnl_consts_stack(f_psf, f_var, host("obs"), host("obs_var"),
                                         consts.good.cpu().numpy(), "cpu", torch.float64)


def hier_grad_check(setup, cpu_setups, z, label, strict):
    """The NUTS potential ``U(z)`` and its gradient on the card against the
    CPU's float64 (``cpu_setups``: the float64 and the float32 CPU
    bundles) at the same unconstrained points: per point ``||g - g_cpu||
    / ||g_cpu||`` within :data:`GRAD_RTOL` (``strict``: at prior draws),
    else within the larger of it and :data:`HIER_GRAD_PLAIN` times the
    CPU's float32 gradient's largest error over the same points (where a
    fit's model meets its data, float32 residuals cancel: the CPU's float32
    gradient itself reads 1e-3 to 4e-3 from float64 there); U within
    :data:`MAP_LNP_RTOL`."""
    import torch

    from psfmc_tpu_torch.models.posterior import value_and_grad

    def potential(s, tr):
        def u(zz):
            th, ld = tr.to_constrained(zz)
            return -(s.hier.differentiable_log_posterior(th) + ld)
        return u

    cpu64, cpu32 = cpu_setups
    z = torch.as_tensor(np.asarray(z, np.float64))
    u, g = value_and_grad(potential(setup, setup.transform()),
                          z.to(setup.hier.device, torch.float32))
    u64, g64 = value_and_grad(potential(cpu64, cpu64.transform()), z)
    u32, g32 = value_and_grad(potential(cpu32, cpu32.transform()), z.float())
    u, g = u.double().cpu(), g.double().cpu()
    fin = torch.isfinite(u64) & torch.isfinite(u)
    rel = ((g - g64).norm(dim=1) / g64.norm(dim=1))[fin]
    plain = ((g32.double() - g64).norm(dim=1) / g64.norm(dim=1))[fin]
    tol = GRAD_RTOL if strict else max(GRAD_RTOL, HIER_GRAD_PLAIN * plain.max().item())
    u_rel = ((u - u64).abs() / u64.abs())[fin]
    log(f"{label}: the potential's gradient at {len(z)} points ({int(fin.sum())} finite), "
        f"card float32 against the CPU's float64: max ||g - g_cpu|| / ||g_cpu|| "
        f"{rel.max().item():.3e} (tol {tol:.3e}" + ("" if strict else
        f": max({GRAD_RTOL:g}, {HIER_GRAD_PLAIN}x the CPU's float32 error")
        + f"; the CPU's float32 at most {plain.max().item():.3e}), U max rel err "
        f"{u_rel.max().item():.3e} (tol {MAP_LNP_RTOL:g})")
    if fin.sum().item() < 1 or not (rel.max().item() <= tol
                                    and u_rel.max().item() <= MAP_LNP_RTOL):
        raise AssertionError(f"{label}: the card's gradient disagrees with the CPU's")
    return {"grad_rel_err": rel.max().item(), "grad_plain_rel_err": plain.max().item(),
            "u_rel_err": u_rel.max().item()}


def hier_res_equals_backward(label):
    """Since the counts were set to 0: conv_lnl's residual forwards equal
    its backwards by route and shape on the ``*_targets`` keys of the FFT
    and padded routes.  Returns them by route and shape."""
    from psfmc_tpu_torch.ops.kernels import conv_lnl as CL

    fwd = {(r.replace("_res", ""), s): n
           for (r, s), n in CL.batched_conv_lnl.shape_launches.items()
           if r in ("fft_res_targets", "padded_res_targets")}
    bwd = {(r, s): n for (r, s), n in CL.batched_conv_lnl_backward.shape_launches.items()
           if r in ("fft_targets", "padded_targets")}
    if fwd != bwd or not fwd:
        raise AssertionError(f"{label}: residual forwards {fwd} and backwards {bwd} "
                             "differ by route and shape")
    return {f"{r}:{s[0]}x{s[1]}": n for (r, s), n in fwd.items()}


def hier_fit(label, model, obs, ivm, counted, cpu_model=None, **kw):
    """``fit_hierarchical`` with the counts set to 0 just before and read just
    after, its NUTS or ensemble sampler kept (its replays, pieces, leaves);
    the result's hyper chain and lnp finite; with ``cpu_model`` the chain's
    lnpost at :data:`HIER_CPU_ROWS` rows against the CPU's float64 (with the
    floor of the NUTS phase)."""
    import torch

    from psfmc_tpu_torch import hierarchy as H
    from psfmc_tpu_torch.sampler import ensemble as E
    from psfmc_tpu_torch.sampler import nuts as N

    kept = []
    inits = {cls: cls.__init__ for cls in (N.NUTSSampler, E.EnsembleSampler)}

    def keeping(cls):
        def init(self, *a, **k):
            inits[cls](self, *a, **k)
            kept.append(self)
        return init

    for cls in inits:
        cls.__init__ = keeping(cls)
    try:
        torch.cuda.synchronize()
        reset_counts(counted)
        t0 = time.perf_counter()
        res = H.fit_hierarchical(model, obs, ivm, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for cls, init in inits.items():
            cls.__init__ = init
    launches, routes = read_counts(counted)
    (sm,) = kept
    graphed = sm._graphed
    replays = sm.graph_replays
    pieces = sum(getattr(sm, "piece_counts", {}).values()) or None
    log(f"{label}: fit_hierarchical {wall:.2f} s wall; " + (
        f"{sm.steps_run} steps, {sm.leaves_run} leaves ({sm.leaves_run / sm.steps_run:.1f} a "
        f"step), {replays} replays of {pieces} pieces, {sm.captures} captures, "
        f"divergences {sm.n_divergent}" if pieces else f"{replays} replayed steps")
        + f"; launched {launches}, conv_lnl's routes "
        f"{ {k: v for k, v in routes.items() if k.startswith('batched') and v} }; "
        f"hyper mean {np.array2string(res.hyper_mean, precision=4)}, std "
        f"{np.array2string(res.hyper_std, precision=4)}")
    if graphed and pieces is not None and (replays != pieces or sm.captures != len(
            set(N.WARMUP_PIECES) | set(N.SAMPLE_PIECES))):
        raise AssertionError(f"{label}: {replays} replays of {pieces} pieces, "
                             f"{sm.captures} captures")
    if not (np.all(np.isfinite(res.hyper_chain)) and np.all(np.isfinite(res.lnp))
            and np.all(np.isfinite(res.target_mean))):
        raise AssertionError(f"{label}: the result is not finite")
    out = {"wall_s": wall, "launches": launches, "routes": {
        k: v for k, v in routes.items() if v}, "hyper_mean": res.hyper_mean.tolist(),
        "hyper_std": res.hyper_std.tolist(), "diagnostics": res.diagnostics}
    if pieces is not None:
        out.update(steps=sm.steps_run, leaves=sm.leaves_run, replays=replays,
                   captures=sm.captures, leaves_per_step=sm.leaves_run / sm.steps_run)
    if cpu_model is not None:
        flat, lnp = sm.flatchain, sm.lnprobability.reshape(-1)
        pick = np.linspace(0, len(flat) - 1, HIER_CPU_ROWS).astype(int)
        cpu_setup = H._setup(cpu_model, obs, ivm, kw["population"],
                             parametrization=kw.get("parametrization", "centered"),
                             psf_stack=kw.get("psf_stack"),
                             psfivm_stack=kw.get("psfivm_stack"))
        lnp64 = cpu_setup.hier.log_posterior_batch(torch.as_tensor(flat[pick])).numpy()
        scale = np.maximum(np.abs(lnp64),
                           NUTS_LNP_FLOOR / NUTS_LNP_RTOL * np.abs(lnp64).max())
        rel = float(np.max(np.abs(lnp[pick] - lnp64) / scale))
        log(f"{label}: the chain's lnpost at {HIER_CPU_ROWS} rows against the CPU's "
            f"float64: max rel diff with the floor {rel:.3e} (rtol {NUTS_LNP_RTOL:g})")
        if not rel <= NUTS_LNP_RTOL:
            raise AssertionError(f"{label}: the chain's lnpost disagrees with the CPU's")
        out["lnpost_rel_err"] = rel
    return res, sm, out


def hier_want_launches(label, sm, launches, routes, bands_routes, pool=True):
    """A NUTS fit's exact launches (``routes``: its launches by route): the
    pool's lnpost, the start's gradient, one of each kernel and backward
    kernel per leaf and band, the record's lnpost per retained step; each
    band's conv_lnl on its route's ``_targets`` keys (residual forwards on
    the FFT and padded routes)."""
    n_leaf, n_keep = sm.leaves_run, sm.piece_counts.get("sample_end", 0)
    nb = len(bands_routes)
    grad_evals, plain_evals = 1 + n_leaf, int(pool) + n_keep
    want = {"render_sersics": nb * (grad_evals + plain_evals),
            "render_sersics_backward": nb * grad_evals,
            "batched_conv_lnl": nb * (grad_evals + plain_evals),
            "batched_conv_lnl_backward": nb * grad_evals}
    want_routes = {}
    for r in bands_routes:
        fwd = f"batched_conv_lnl:{r}_targets"
        if r == "dft":
            want_routes[fwd] = want_routes.get(fwd, 0) + grad_evals + plain_evals
        else:
            want_routes[fwd] = want_routes.get(fwd, 0) + plain_evals
            res = f"batched_conv_lnl:{r}_res_targets"
            want_routes[res] = want_routes.get(res, 0) + grad_evals
        bwd = f"batched_conv_lnl_backward:{r}_targets"
        want_routes[bwd] = want_routes.get(bwd, 0) + grad_evals
    got = {k: routes.get(k, 0) for k in want_routes}
    if launches != want or got != want_routes:
        raise AssertionError(f"{label}: launched {launches} on {got}, want {want} on "
                             f"{want_routes}")
    return dict(launches, **got)


def hier_graphed_vs_eager(setup, big, counted, label):
    """:data:`HIER_EQUAL` warmup and retained NUTS steps of depth
    :data:`HIER_EQUAL_DEPTH` from the chains at ``big``, as graph replays
    and eagerly: the states, chains and generators bit for bit, the same
    launches and pieces."""
    import torch

    from psfmc_tpu_torch.sampler import nuts as N

    pair = []
    for eager in (False, True):
        s = N.NUTSSampler(HIER_CHAINS, setup.hier.spec.num_params, setup.hier,
                          seed=SEED + 11, max_depth=HIER_EQUAL_DEPTH,
                          transform=setup.transform(), device=setup.hier.device)
        reset_counts(counted)
        with N._eager(s) if eager else contextlib.nullcontext():
            s.init_state(big)
            s.run_burn(HIER_EQUAL)
            s.reset()
            s.run_sampling(HIER_EQUAL)
        torch.cuda.synchronize()
        pair.append((s, read_counts(counted)))
    (g, g_n), (e, e_n) = pair
    differs = nuts_state_differs(g, e)
    log(f"{label}: {HIER_EQUAL} + {HIER_EQUAL} steps graphed ({g.graph_replays} replays, "
        f"{g.leaves_run} leaves) against eager ({e.graph_replays} replays): "
        f"{'bit for bit' if not differs else 'differ in ' + str(differs)}; launches "
        f"{g_n[0]} and {e_n[0]}")
    if differs or g_n != e_n or g.piece_counts != e.piece_counts or e.graph_replays:
        raise AssertionError(f"{label}: graphed and eager steps differ")
    return {"leaves": g.leaves_run, "replays": g.graph_replays, "bit_for_bit": True}


def target_grad_rows(nt, per, psf_shape, device, launches):
    """The residual forward and the backward with the target axis at the
    hierarchical leaf's batch (``nt`` targets x ``per`` chains) and at
    :data:`HIER_ROW_WALKERS`: per-target planes on the radix-2 FFT route
    (the flagship's shape), with per-target spectra there, on the
    mixed-radix geometry, the padded route and the cluster route (94x94,
    the matmul-DFT route's times on the same inputs beside it).  Each
    against its plain version (float64 scheme), with its times at both
    batches, the plain version's, the ``torch.fft`` composite's (its lnL
    and weights; for the backward autograd through it) and its bound at
    the leaf's batch; ``launches`` by row name."""
    import torch

    from psfmc_tpu_torch.batchfit import prepare_psf_stack
    from psfmc_tpu_torch.flagship import flagship_components, prior_draws
    from psfmc_tpu_torch.models import build_model_spec, build_posterior
    from psfmc_tpu_torch.ops import convolve, gaussian_lnlike
    from psfmc_tpu_torch.ops.kernels import _build
    from psfmc_tpu_torch.ops.kernels import conv_lnl as CL

    rows = []
    cases = (("targets", FLAGSHIP_SHAPE, psf_shape, False),
             ("targets_spectra", FLAGSHIP_SHAPE, psf_shape, True),
             ("targets_mixed", MIXED_SHAPE, MIXED_PSF_SHAPE, False),
             ("targets_padded", PADDED_SHAPE, PADDED_PSF_SHAPE, False),
             ("targets_cluster", CLUSTER_SHAPE, CLUSTER_PSF_SHAPE, False))
    for i, (suffix, shape, pshape, spectra) in enumerate(cases):
        route = CL.conv_route(shape)
        spec = build_model_spec(flagship_components(shape, pshape))
        post = build_posterior(spec, device=device, lnpost="batched")
        big_n = max(HIER_ROW_WALKERS // nt, per) * nt
        thetas = torch.as_tensor(prior_draws(spec, big_n, seed=3), dtype=torch.float32,
                                 device=post.device)
        raws_big = post.raw_and_ps(thetas)[0].contiguous()
        rng = np.random.RandomState(SEED + 60 + i)
        obs = np.asarray(spec.obs_data)[None] + rng.randn(nt, *shape) * 0.005
        var = np.asarray(spec.obs_var)[None] * rng.uniform(0.5, 2.0, (nt, 1, 1))
        good = rng.rand(nt, *shape) > 0.02
        if spectra:
            stars, ivms = psf_stars(nt, pshape, SEED + 61)
            f = prepare_psf_stack(spec, stars, ivms, dtype=np.float64)
            f_psf = (f["psf_f_re"] + 1j * f["psf_f_im"])[:, 0]
            f_var = (f["var_f_re"] + 1j * f["var_f_im"])[:, 0]
        else:
            f_psf, f_var = spec.f_psf_stack[0], spec.f_var_stack[0]
        stack = CL.make_conv_lnl_consts_stack(f_psf, f_var, obs, var, good, post.device)
        c64 = CL.make_conv_lnl_consts_stack(f_psf, f_var, obs, var, good, "cpu",
                                            torch.float64)
        lib = tuple(torch.as_tensor(np.asarray(f)[:, None] if spectra else f,
                                    dtype=torch.complex64, device=post.device)
                    for f in (f_psf, f_var))
        # the leaf's batch: each target's first ``per`` walkers of the big batch
        leaf_idx = (torch.arange(nt)[:, None] * (big_n // nt) + torch.arange(per)).reshape(-1)
        batches = {"leaf": raws_big[leaf_idx.to(post.device)].contiguous(), "big": raws_big}
        b = nt * per
        h, w = shape
        n = b * h * w
        spectra_bytes = 4 * sum(t.numel() for t in (stack.psf_r, stack.psf_i, stack.var_r,
                                                     stack.var_i))
        data_bytes = spectra_bytes + 4 * sum(t.numel() for t in (stack.obs, stack.obs_var,
                                                                  stack.good_f))
        raws = batches["leaf"]
        lnl = CL.batched_conv_lnl(raws, stack)
        grad = torch.as_tensor(rng.uniform(0.5, 2.0, b), dtype=torch.float32,
                               device=post.device)

        def library_fwd(x):  # the torch.fft formulation of the lnL and the weights
            xs = x.reshape(nt, -1, h, w)
            conv = convolve(xs, lib[0])
            ivm = 1.0 / (convolve(xs * xs, lib[1]) + stack.obs_var[:, None])
            r = stack.obs[:, None] - conv
            zero = torch.zeros_like(r)
            good_ = stack.good[:, None]
            return (gaussian_lnlike(r, ivm, good_),
                    torch.where(good_, r * ivm, zero),
                    torch.where(good_, 0.5 * (r * r * ivm * ivm - ivm), zero))

        residuals = {}
        if route != "dft":
            name = f"conv_lnl_res_{suffix}"
            res, keep, errs = residual_check(raws, stack, c64, lnl,
                                             f"{name}: at the leaf's B = {b}")
            residuals["leaf"] = res
            residuals["big"] = tuple(CL.batched_conv_lnl_residuals(raws_big, stack)[1:])
            plain = (CL.packed_fft_conv_residuals_plain if route == "fft"
                     else CL.padded_fft_conv_residuals_plain)
            bms, by, term = bound(12 * n + data_bytes + 8 * b,
                                  conv_lnl_ops(b, h, w) + RES_OPS_PER_PIXEL * n)
            rows.append(dict(
                name=name, route="cuda", source=_build.source_path("conv_lnl"),
                replaces="psfmc_tpu/ops/pallas/lnpost_batched.py:191 (its gradient's "
                         "residuals)", launches=launches.get(name, 0),
                max_abs_err=errs["max_abs_err"],
                max_normalized_err=errs["max_normalized_err"],
                ms=time_ms(lambda: CL.batched_conv_lnl_residuals(raws, stack)),
                plain_ms=time_ms(lambda: plain(raws, stack)),
                bound_ms=bms, bound_by=by, bound_term=term,
                library_ms=time_ms(lambda: library_fwd(raws)),
                library="torch.fft convolutions, the lnL and the weights",
                walkers=b, targets=nt, target_spectra=spectra, conv_route=route,
                geometry=fft_geometry(shape),
                ms_608=time_ms(lambda: CL.batched_conv_lnl_residuals(raws_big, stack)),
                walkers_608=big_n))
        name = f"conv_lnl_backward_{suffix}"
        got = CL.batched_conv_lnl_backward(raws, stack, lnl, grad, residuals.get("leaf"))
        same_nonfinite(got, CL.batched_conv_lnl_backward_plain(raws, stack, lnl, grad))
        want = CL.batched_conv_lnl_backward_plain(
            raws.double().cpu(), c64, lnl.double().cpu(), grad.double().cpu()
        ).to(post.device)
        keep = torch.isfinite(lnl)
        err = normalized_err(got[keep], want[keep], dims=(1, 2))
        log(f"{name}: {nt} targets x {per} at {h}x{w} ({route} route"
            f"{', per-target spectra' if spectra else ''}): max normalized err {err:.3e} "
            f"(tol {CONV_BWD_TOL:g}), walkers compared {int(keep.sum())}")
        if not (err <= CONV_BWD_TOL and keep.sum().item() >= b // 2):
            raise AssertionError(f"{name} disagrees with its plain version")
        lnl_big = CL.batched_conv_lnl(raws_big, stack)
        grad_big = torch.ones_like(lnl_big)

        def library_bwd():  # autograd through the torch.fft formulation
            x = raws.detach().requires_grad_(True)
            with torch.enable_grad():
                return torch.autograd.grad(library_fwd(x)[0].reshape(b), x, grad)[0]

        if route != "dft":
            bms, by, term = bound(16 * n + spectra_bytes + 12 * b,
                                  b * 2 * fft_conv_ops(h, w) + BWD_COMBINE_OPS_PER_PIXEL * n)
        else:
            bms, by, term = bound(8 * raws.numel() + data_bytes + 8 * b,
                                  2 * conv_lnl_ops(b, h, w) + 12 * n)
        rows.append(dict(
            name=name, route="cuda", source=_build.source_path("conv_lnl_backward"),
            replaces="psfmc_tpu/ops/pallas/lnpost_batched.py:191 (its gradient)",
            launches=launches.get(name, 0),
            max_abs_err=(got[keep].double() - want[keep]).abs().max().item(),
            max_normalized_err=err,
            ms=time_ms(lambda: CL.batched_conv_lnl_backward(raws, stack, lnl, grad,
                                                            residuals.get("leaf"))),
            plain_ms=time_ms(lambda: CL.batched_conv_lnl_backward_plain(raws, stack, lnl,
                                                                        grad)),
            bound_ms=bms, bound_by=by, bound_term=term, library_ms=time_ms(library_bwd),
            library="torch.autograd through torch.fft convolutions of the forward",
            walkers=b, targets=nt, target_spectra=spectra, conv_route=route,
            geometry=fft_geometry(shape),
            ms_608=time_ms(lambda: CL.batched_conv_lnl_backward(
                raws_big, stack, lnl_big, grad_big, residuals.get("big"))),
            walkers_608=big_n))
        if route == "cluster":  # the former matmul-DFT route on the same inputs
            dft = CL._launch_backward(raws, stack, lnl, grad, "dft")
            dft_err = normalized_err(dft[keep], want[keep], dims=(1, 2))
            if not dft_err <= CONV_BWD_TOL:
                raise AssertionError(f"{name}: the matmul-DFT route disagrees ({dft_err:.3e})")
            rows[-1]["dft_route_ms"] = time_ms(
                lambda: CL._launch_backward(raws, stack, lnl, grad, "dft"))
    for r in rows:
        log(f"{r['name']}: {r['ms']:.4f} ms at {r['walkers']} walkers ({r['ms_608']:.4f} ms "
            f"at {r['walkers_608']}), plain {r['plain_ms']:.4f} ms, {r['library']} "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms by {r['bound_by']} "
            f"({r['bound_term']}), {r['ms'] / r['bound_ms']:.1f}x the bound ({CARD})")
    return rows


def hierarchy_phase(shape=None, psf_shape=(64, 64), device=None):
    """Hierarchical fits on the card (the arguments shrink it for a
    rehearsal on the CPU).  (a) ``fit_hierarchical`` on
    :data:`HIER_TARGETS` flagship mocks (``simulate_stack``, seed 1) with a
    ``NormalPopulation`` on the first Sersic's index, NUTS with
    :data:`HIER_CHAINS` chains, a pool of :data:`HIER_POOL` a chain, depth
    :data:`HIER_DEPTH`, 20 + 20 steps, centred and then non-centred; (b)
    survey mode, :data:`HIER_SURVEY_TARGETS` targets each with its own
    Gaussian PSF star; (c) the joint flagship at
    :data:`HIER_JOINT_TARGETS` targets with band 1 at 96x96, 74x74 and
    94x94 (the mixed-radix, padded and cluster routes); (d) the
    ensemble path at :data:`HIER_ENSEMBLE_TARGETS` targets, graphed
    against eager; (e) ``loo_targets`` on (a).  For the NUTS fits: every
    piece a replay, the launches exact (residual forwards equal backwards
    by route and shape on the ``_targets`` keys), the result finite, the
    chain's lnpost against the CPU's float64, the kernels against their
    plain versions at the leaf's batch, the potential's gradient against
    the CPU's float64; (a) also graphed against eager over a few leaves.
    Then the rows of the residual forward and the backward with the target
    axis (:func:`target_grad_rows`).  Returns the rows, the render's
    launches, the numbers and the checks."""
    import torch

    from psfmc_tpu_torch import batchfit as BF
    from psfmc_tpu_torch import hierarchy as H
    from psfmc_tpu_torch.flagship import joint_components, write_flagship_files
    from psfmc_tpu_torch.models import JointModel, as_model
    from psfmc_tpu_torch.ops.kernels.conv_lnl import conv_route

    shape = FLAGSHIP_SHAPE if shape is None else shape
    counted = grad_kernels()
    t_phase = time.perf_counter()
    out, checks = {}, {}
    row_launches = {}
    render_launches = {"render_sersics": 0, "render_sersics_backward": 0}
    env = {k: os.environ.pop(k) for k in ("PSFMC_LNPOST", "PSFMC_RENDER", "PSFMC_KAPPA")
           if k in os.environ}

    def add_launches(fit_out, suffix_by_key):
        for k in render_launches:
            render_launches[k] += fit_out["launches"][k]
        for key, row in suffix_by_key.items():
            row_launches[row] = row_launches.get(row, 0) + fit_out["routes"].get(key, 0)

    def nuts_checks(label, setup, cpu_setups, sm):
        last = torch.as_tensor(sm.chain[:, -1])  # each chain's last retained row
        drawn = setup.transform().to_unconstrained(
            setup.draw(HIER_CHAINS, np.random.RandomState(SEED + 70)))
        checks[label] = {
            "kernels": hier_kernel_check(setup, last, label),
            "at_prior_draws": hier_grad_check(setup, cpu_setups, drawn,
                                              f"{label}, at prior draws", True),
            "at_the_end": hier_grad_check(setup, cpu_setups, sm.state.z.double().cpu(),
                                          f"{label}, where the fit ended", False)}

    try:
        with tempfile.TemporaryDirectory() as tmp:
            model = as_model(write_flagship_files(tmp, shape, psf_shape), device=device)
            cpu = as_model(os.path.join(tmp, "model.py"), device="cpu", dtype=torch.float64)
            cpu32 = as_model(os.path.join(tmp, "model.py"), device="cpu")
        dev = model.posterior_fns.device
        graphed = dev.type == "cuda"
        obs, ivm, _ = BF.simulate_stack(model, HIER_TARGETS, seed=1)

        # (a) the flagship catalog, centred then non-centred: the main path
        fits = {}
        for par in ("centered", "noncentered"):
            label = f"hierarchy, {HIER_TARGETS} flagship targets, {par}"
            kw = dict(population=hier_population(), sampler="nuts", chains=HIER_CHAINS,
                      init_pool=HIER_POOL, max_depth=HIER_DEPTH, burn=HIER_BURN,
                      iterations=HIER_SAMPLE, seed=SEED, parametrization=par)
            res, sm, fit_out = hier_fit(label, model, obs, ivm, counted, cpu, **kw)
            fit_out["launches_by_route"] = hier_want_launches(
                label, sm, fit_out["launches"], fit_out["routes"], ["fft"])
            fit_out["res_equals_backward"] = hier_res_equals_backward(label)
            add_launches(fit_out, {"batched_conv_lnl:fft_res_targets": "conv_lnl_res_targets",
                                   "batched_conv_lnl_backward:fft_targets":
                                       "conv_lnl_backward_targets"})
            setup = H._setup(model, obs, ivm, kw["population"], parametrization=par)
            cpu_setups = [H._setup(m, obs, ivm, kw["population"], parametrization=par)
                          for m in (cpu, cpu32)]
            nuts_checks(label, setup, cpu_setups, sm)
            if par == "centered":
                checks[label]["graphed_vs_eager"] = hier_graphed_vs_eager(
                    setup, sm.chain[:, -1], counted, label)
                fits[par] = (res, sm)
                if graphed:  # the leaf, the pieces, the idle share (CUDA events, profiler)
                    log(f"{label}: the times below at {HIER_CHAINS} chains x {HIER_TARGETS} "
                        f"targets = {HIER_CHAINS * HIER_TARGETS} walkers a leaf")
                    fit_out.update(nuts_times(sm))
            out[par] = fit_out

        # (e) leave-one-target-out on (a)'s centred fit
        res_a = fits["centered"][0]
        reset_counts(counted)
        t0 = time.perf_counter()
        loo = H.loo_targets(model, obs, ivm, res_a)
        ll = H.target_loglike(model, obs, ivm, res_a)
        torch.cuda.synchronize()
        loo_wall = time.perf_counter() - t0
        launches, routes = read_counts(counted)
        want = {"render_sersics": 2, "render_sersics_backward": 0, "batched_conv_lnl": 2,
                "batched_conv_lnl_backward": 0}
        if launches != want or routes["batched_conv_lnl:fft_targets"] != 2:
            raise AssertionError(f"hierarchy, loo: launched {launches} {routes}")
        cpu_ll = H.target_loglike(cpu, obs, ivm, res_a.flatchain[:2])
        _, ll_rel, _ = compare(torch.as_tensor(ll[:2]), torch.as_tensor(cpu_ll))
        log(f"hierarchy, loo_targets on (a): elpd {loo.elpd:.3f} +/- {loo.se:.3f}, p_eff "
            f"{loo.p_eff:.3f}, Pareto k max {np.max(loo.pareto_k):.3f}; the replay "
            f"{ll.shape} in {loo_wall:.2f} s (two calls), two draws against the CPU's "
            f"float64: max rel err {ll_rel:.3e} (tol {SLICE_RTOL:g})")
        if not (np.isfinite(loo.elpd) and loo.n_points == HIER_TARGETS
                and ll_rel <= SLICE_RTOL and np.all(np.isfinite(ll))):
            raise AssertionError("hierarchy, loo: not finite or disagrees with the CPU")
        setup = H._setup(model, obs, ivm, hier_population())
        per = res_a.flatchain[:, : setup.k * setup.d].reshape(-1, setup.k, setup.d)
        rows_ll = H._target_major(per, torch.float32, dev)  # the replay's one batch
        band = setup.hier._bands[0]
        checks["loo"] = batch_kernel_check(band["fns"], rows_ll, "hierarchy, loo replay",
                                           band["obs"])
        out["loo"] = {"elpd": loo.elpd, "se": loo.se, "p_eff": loo.p_eff,
                      "pareto_k_max": float(np.max(loo.pareto_k)), "wall_s": loo_wall}
        render_launches["render_sersics"] += launches["render_sersics"]

        # (b) survey mode: a Gaussian PSF star per target
        stars, star_ivms = psf_stars(HIER_SURVEY_TARGETS, psf_shape, SEED + 43)
        sobs, sivm = obs[:HIER_SURVEY_TARGETS], ivm[:HIER_SURVEY_TARGETS]
        label = f"hierarchy, survey, {HIER_SURVEY_TARGETS} targets"
        kw = dict(population=hier_population(), chains=HIER_CHAINS, init_pool=4,
                  max_depth=HIER_SURVEY_DEPTH, burn=HIER_SURVEY_STEPS,
                  iterations=HIER_SURVEY_STEPS, seed=SEED + 1, psf_stack=stars,
                  psfivm_stack=star_ivms)
        _, sm, fit_out = hier_fit(label, model, sobs, sivm, counted, cpu, **kw)
        hier_want_launches(label, sm, fit_out["launches"], fit_out["routes"], ["fft"])
        fit_out["res_equals_backward"] = hier_res_equals_backward(label)
        add_launches(fit_out, {"batched_conv_lnl:fft_res_targets":
                               "conv_lnl_res_targets_spectra",
                               "batched_conv_lnl_backward:fft_targets":
                                   "conv_lnl_backward_targets_spectra"})
        setup = H._setup(model, sobs, sivm, kw["population"], psf_stack=stars,
                         psfivm_stack=star_ivms)
        if not setup.hier._bands[0]["obs"].consts.target_spectra:
            raise AssertionError(f"{label}: the stack has no per-target spectra")
        cpu_setups = [H._setup(m, sobs, sivm, kw["population"], psf_stack=stars,
                               psfivm_stack=star_ivms) for m in (cpu, cpu32)]
        nuts_checks(label, setup, cpu_setups, sm)
        out["survey"] = fit_out

        # (c) the joint flagship, band 1 on each route
        for band1 in HIER_JOINT_BAND1:
            shapes = (shape, band1)
            joint = JointModel(joint_components(shapes, psf_shape), device=dev)
            cpu_joint = JointModel(joint_components(shapes, psf_shape), device="cpu",
                                   dtype=torch.float64)
            cpu_joint32 = JointModel(joint_components(shapes, psf_shape), device="cpu")
            jobs, jivm, _ = BF.simulate_stack(joint, HIER_JOINT_TARGETS, seed=4)
            label = f"hierarchy, joint, band 1 at {band1[0]}x{band1[1]}"
            kw = dict(population=hier_population(), chains=HIER_CHAINS, init_pool=4,
                      max_depth=HIER_JOINT_DEPTH, burn=HIER_JOINT_STEPS,
                      iterations=HIER_JOINT_STEPS, seed=SEED + 2)
            _, sm, fit_out = hier_fit(label, joint, jobs, jivm, counted, cpu_joint, **kw)
            band_routes = [conv_route(s) for s in shapes]
            hier_want_launches(label, sm, fit_out["launches"], fit_out["routes"], band_routes)
            fit_out["res_equals_backward"] = hier_res_equals_backward(label)
            geo = fft_geometry(band1)
            suffix = "mixed" if geo == "mixed" else band_routes[1]
            r1 = band_routes[1]
            key_geo = f":{geo}" if geo in MIXED_GEOMETRIES else ""
            if r1 != "dft":
                row_launches[f"conv_lnl_res_targets_{suffix}"] = row_launches.get(
                    f"conv_lnl_res_targets_{suffix}", 0) + fit_out["routes"].get(
                    f"batched_conv_lnl:{r1}_res_targets{key_geo}", 0)
            row_launches[f"conv_lnl_backward_targets_{suffix}"] = row_launches.get(
                f"conv_lnl_backward_targets_{suffix}", 0) + fit_out["routes"].get(
                f"batched_conv_lnl_backward:{r1}_targets{key_geo}", 0)
            # band 0 (the flagship's 128x128) on the radix-2 rows
            for row, key in (("conv_lnl_res_targets", "batched_conv_lnl:fft_res_targets"),
                             ("conv_lnl_backward_targets",
                              "batched_conv_lnl_backward:fft_targets")):
                n = fit_out["routes"].get(key, 0)
                if r1 == "fft":
                    n -= fit_out["routes"].get(f"{key}{key_geo}", 0)
                row_launches[row] = row_launches.get(row, 0) + n
            for k in render_launches:
                render_launches[k] += fit_out["launches"][k]
            setup = H._setup(joint, jobs, jivm, kw["population"])
            cpu_setups = [H._setup(m, jobs, jivm, kw["population"])
                          for m in (cpu_joint, cpu_joint32)]
            nuts_checks(label, setup, cpu_setups, sm)
            if band_routes[1] == "cluster":  # the cluster route inside the graphs
                checks[label]["graphed_vs_eager"] = hier_graphed_vs_eager(
                    setup, sm.chain[:, -1], counted, label)
            out[f"joint_{band1[0]}"] = fit_out

        # (d) the ensemble path, graphed against eager
        from psfmc_tpu_torch.sampler import ensemble as E

        eobs, eivm = obs[:HIER_ENSEMBLE_TARGETS], ivm[:HIER_ENSEMBLE_TARGETS]
        kw = dict(population=hier_population(), sampler="ensemble",
                  burn=HIER_ENSEMBLE_STEPS, iterations=HIER_ENSEMBLE_STEPS, seed=SEED + 3)
        ens = []
        for eager in (False, True):
            init = E.EnsembleSampler.__init__

            def eager_init(self, *a, **k):
                init(self, *a, **k)
                self._graphed = False

            if eager:
                E.EnsembleSampler.__init__ = eager_init
            try:
                ens.append(hier_fit(f"hierarchy, ensemble, {HIER_ENSEMBLE_TARGETS} targets"
                                    + (", eager" if eager else ""), model, eobs, eivm,
                                    counted, **kw))
            finally:
                E.EnsembleSampler.__init__ = init
        (res_g, sm_g, fit_g), (res_e, sm_e, fit_e) = ens
        same = [same_bits(torch.as_tensor(getattr(res_g, f)), torch.as_tensor(getattr(res_e, f)))
                for f in ("flatchain", "lnp")]
        nw = sm_g.nwalkers
        evals = 1 + 2 * 2 * HIER_ENSEMBLE_STEPS
        want = {"render_sersics": evals, "render_sersics_backward": 0,
                "batched_conv_lnl": evals, "batched_conv_lnl_backward": 0}
        log(f"hierarchy, ensemble: {nw} walkers ({nw // 2 * HIER_ENSEMBLE_TARGETS} a "
            f"half-step launch), graphed against eager bit for bit {same}; launches "
            f"{fit_g['launches']} and {fit_e['launches']}")
        if not all(same) or fit_g["launches"] != want or fit_e["launches"] != want or (
                graphed and sm_g.graph_replays != 2 * HIER_ENSEMBLE_STEPS):
            raise AssertionError("hierarchy, ensemble: graphed and eager fits differ, or "
                                 f"the launches are not {want}")
        esetup = H._setup(model, eobs, eivm, kw["population"])
        checks["ensemble"] = hier_kernel_check(
            esetup, torch.as_tensor(sm_g.chain[: nw // 2, -1]), "hierarchy, ensemble")
        render_launches["render_sersics"] += fit_g["launches"]["render_sersics"]
        out["ensemble"] = dict(fit_g, eager_wall_s=fit_e["wall_s"])

        # the rows: the residual forward and the backward with the target axis
        rows = target_grad_rows(HIER_TARGETS, HIER_CHAINS, psf_shape, dev, row_launches)
    finally:
        os.environ.update(env)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"hierarchy: the phase took {out['wall_s']:.1f} s ({CARD})")
    return {"rows": rows, "render_launches": render_launches, "out": out,
            "kernel_checks": checks, "row_launches": row_launches}



def route_map_check(shape, psf_shape, device, route):
    """``model_galaxy_map`` on the MAP flagship at ``shape`` (on conv_lnl's
    ``route``: the cluster or the global route): :data:`MAP_STARTS`
    starts x :data:`MAP_SHORT_STEPS` Adam steps and Laplace, the launches
    exact, every forward under autograd the route's residual
    instantiation with its backward there, no launch on the matmul-DFT
    route, every step a replay of one captured step, the lnpost at the MAP
    within :data:`MAP_LNP_RTOL` of the CPU's float64, the replayed step's
    time.  Returns ``map`` (launches by wrapper and route),
    ``map_lnpost_rel_err`` and ``adam_step_ms``."""
    import torch

    from psfmc_tpu_torch import fitting
    from psfmc_tpu_torch.flagship import write_map_files
    from psfmc_tpu_torch.models import MultiComponentModel

    out = {}
    counted = grad_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        path, _ = write_map_files(tmp, shape, psf_shape, seed=SEED)
        models = []
        as_model = fitting.as_model

        def kept(*a, **k):
            models.append(as_model(*a, **k))
            return models[-1]

        fitting.as_model = kept
        try:
            torch.cuda.synchronize()
            reset_counts(counted)
            t0 = time.perf_counter()
            res = fitting.model_galaxy_map(path, output_name=os.path.join(tmp, "map"),
                                           n_starts=MAP_STARTS, steps=MAP_SHORT_STEPS,
                                           seed=SEED, laplace=True, device=device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, by_route = read_counts(counted)
        finally:
            fitting.as_model = as_model
        (model,) = models
        cpu = MultiComponentModel(path, device="cpu", dtype=torch.float64)
    fns = model.posterior_fns
    # the pool's evaluation, the steps and the final iterate, Laplace's two
    # gradient calls, the images' render; every forward under autograd with
    # residuals
    evals = MAP_SHORT_STEPS + 1
    want = {"render_sersics": 1 + evals + 2 + 1, "render_sersics_backward": evals + 2,
            "batched_conv_lnl": 1 + evals + 2, "batched_conv_lnl_backward": evals + 2}
    want_routes = {f"batched_conv_lnl:{route}": 1, f"batched_conv_lnl:{route}_res": evals + 2,
                   f"batched_conv_lnl_backward:{route}": evals + 2,
                   "batched_conv_lnl:dft": 0, "batched_conv_lnl_backward:dft": 0}
    got_routes = {k: by_route[k] for k in want_routes}
    program = map_program(fns)
    graphed = fns.device.type == "cuda"  # a CPU rehearsal has no graphs
    lnp64 = float(cpu.posterior_fns.log_posterior_batch(res.theta[None])[0])
    lnp_rel = abs(res.lnpost - lnp64) / abs(lnp64)
    log(f"{route}: model_galaxy_map at {shape[0]}x{shape[1]}, {MAP_STARTS} starts x "
        f"{MAP_SHORT_STEPS} steps in {wall:.2f} s; lnpost {res.lnpost:.4f} on the card, "
        f"{lnp64:.4f} on the CPU in float64 (rel {lnp_rel:.2e}, tol {MAP_LNP_RTOL:g}); "
        f"{program.replays} replays; launches {launches}, {got_routes}")
    if launches != want or got_routes != want_routes:
        raise AssertionError(f"{route}: the MAP launched {launches} {got_routes}, want "
                             f"{want} {want_routes}")
    if graphed and program.replays != MAP_SHORT_STEPS:
        raise AssertionError(f"{route}: {program.replays} replays for {MAP_SHORT_STEPS} "
                             "steps")
    if graphed:
        check_step_tally(program, {("render_sersics", None): 1,
                                   ("render_sersics_backward", None): 1,
                                   ("batched_conv_lnl", f"{route}_res"): 1,
                                   ("batched_conv_lnl_backward", route): 1}, f"{route} map")
        out["adam_step_ms"] = time_ms(program.graph.replay, reps=5, inner=5)
        log(f"{route}: the MAP's Adam step ({MAP_STARTS} starts) replayed "
            f"{out['adam_step_ms']:.3f} ms ({CARD})")
    if not (np.isfinite(res.lnpost) and lnp_rel <= MAP_LNP_RTOL):
        raise AssertionError(f"{route}: the MAP's lnpost disagrees with the CPU's float64")
    out["map"] = dict(launches, **by_route)
    out["map_lnpost_rel_err"] = lnp_rel
    out["map_wall_s"] = wall
    return out


def cluster_phase(shape=None, psf_shape=(64, 64), device=None):
    """conv_lnl's cluster route on its own paths at full width (the
    arguments shrink it for a rehearsal on the CPU): the flagship at a
    256x256 observation (its transform over 4 blocks) through the driver
    on the default batched path (:func:`driver_phase` with ``lnpost=None``:
    250 walkers, 20 + 20 steps in segments, every step a graph replay, the
    launches exact on the cluster route, the lnpost against the CPU's
    float64, the resumed fit bit for bit) and the MAP flagship at that
    observation through ``model_galaxy_map`` (:data:`MAP_STARTS` starts x
    :data:`MAP_SHORT_STEPS` Adam steps and Laplace: the launches exact, no
    launch on the matmul-DFT route, every step a replay of one captured
    step, the lnpost at the MAP within :data:`MAP_LNP_RTOL` of the CPU's
    float64, the replayed step's time); then the three kernels of the
    route at :data:`CLUSTER_TIMED`, each row as the kernel and backward
    rows make it at 94x94 (:func:`likelihood_rows`,
    :func:`conv_backward_rows`).  Returns the two fits' launches and the
    rows by shape."""
    import torch

    from psfmc_tpu_torch.flagship import flagship_components, prior_draws
    from psfmc_tpu_torch.models import build_model_spec, build_posterior
    from psfmc_tpu_torch.ops.kernels import conv_lnl as CL

    shape = CLUSTER_FIT_SHAPE if shape is None else shape
    if CL.conv_route(shape) != "cluster":
        raise AssertionError(f"{shape} takes the {CL.conv_route(shape)} route")
    t_phase = time.perf_counter()
    out = {}
    out["driver"], _, _ = driver_phase(shape, psf_shape, device, lnpost=None)

    out.update(route_map_check(shape, psf_shape, device, "cluster"))
    out["times"] = {}
    rng = np.random.RandomState(SEED + 13)
    for timed, timed_psf in CLUSTER_TIMED:
        spec = build_model_spec(flagship_components(timed, timed_psf))
        post = build_posterior(spec, device=device, lnpost="batched")
        thetas = torch.as_tensor(prior_draws(spec, B_HALF, seed=1), dtype=torch.float32,
                                 device=post.device)
        (forward,) = likelihood_rows(post, spec, thetas, ("conv_lnl_cluster", "cluster"),
                                     None)
        residual, backward = conv_backward_rows(spec, "cluster", "conv_lnl_backward_cluster",
                                                post.device, rng)
        out["times"][f"{timed[0]}x{timed[1]}"] = {
            "forward": forward, "residual": residual, "backward": backward}
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"cluster: the phase took {out['wall_s']:.1f} s ({CARD})")
    return out


def fused_routes_phase(fits=FUSED_FITS, device=None):
    """The fused kernel off the radix-2 geometry on fitted paths at full
    width (``fits`` shrinks it for a rehearsal on the CPU): for each
    ``(shape, psf_shape)`` of :data:`FUSED_FITS`, the flagship through the
    driver on the fused path (:func:`driver_phase` with
    ``lnpost="pallas"``: 250 walkers, 20 + 20 steps in segments, every step
    a graph replay, every fused launch on the route the shape takes, the
    lnpost against the CPU's float64, the resumed fit bit for bit, the
    replayed retained step's time), and none of its launches on the
    matmul-DFT route nor on conv_lnl.  Returns each fit's launches by
    shape."""
    from psfmc_tpu_torch.ops.kernels.fused_lnl import fused_route

    t_phase = time.perf_counter()
    out = {}
    for shape, psf_shape in fits:
        route = fused_route(shape)
        if route == "dft":
            raise AssertionError(f"{shape} takes the fused kernel's matmul-DFT route")
        launches, _, _ = driver_phase(shape, psf_shape, device, lnpost="pallas")
        if launches["fused_lnl:dft"] or launches["batched_conv_lnl"] \
                or launches[f"fused_lnl:{route}"] != launches["fused_lnl"]:
            raise AssertionError(f"fused routes: the {shape} fit launched {launches}")
        key = f"{shape[0]}x{shape[1]}"
        out[key] = launches
        log(f"fused routes: {key} fit, {launches['fused_lnl']} fused launches on the "
            f"{route} route, none on its matmul-DFT route nor on conv_lnl; lnpost rel "
            f"err {launches['lnpost_rel_err']:.2e}; replayed retained step "
            f"{launches.get('retain_step_ms', float('nan')):.3f} ms ({CARD})")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"fused routes: the phase took {out['wall_s']:.1f} s ({CARD})")
    return out


# the global route (the transforms no block and no cluster of 8 holds),
# each shape with its PSF: 235x235 and 251x251 (padded to 480x480 and
# 504x504), 512x512 and 640x640 (unpadded); its fits at 512x512 and its
# survey batch at 251x251
GLOBAL_TIMED = (((235, 235), (64, 64)), ((251, 251), (64, 64)), ((512, 512), (64, 64)),
                ((640, 640), (64, 64)))
GLOBAL_FIT_SHAPE, GLOBAL_FIT_PSF_SHAPE = (512, 512), (64, 64)
GLOBAL_SURVEY_SHAPE = (251, 251)


def global_phase(shape=None, psf_shape=GLOBAL_FIT_PSF_SHAPE, timed=GLOBAL_TIMED,
                 survey_shape=None, device=None):
    """conv_lnl's global route and the fused kernel's on their own paths at
    full width (the arguments shrink it for a rehearsal on the CPU).
    First the four kernels of the route at each shape of
    :data:`GLOBAL_TIMED` at :data:`B_HALF` walkers of the flagship: the
    render (:data:`RENDER_TOL` a pixel), conv_lnl and the fused kernel
    (:data:`CONV_LNL_TOL` a walker of max(|lnL|, |normalization|)), the
    residual forward and the backward (:data:`CONV_BWD_TOL` of each
    walker's largest gradient of the float64 plain backward), each against
    its plain version with the same non-finite entries, each timed beside
    the matmul-DFT route on the same inputs and the torch.fft composite
    (:func:`likelihood_rows`, :func:`conv_backward_rows`); conv_lnl with
    per-target spectra at the survey batch's half-step launch
    (:func:`target_row`).  Then the flagship at :data:`GLOBAL_FIT_SHAPE`
    through the driver on the batched and on the fused path
    (:func:`driver_phase`: 250 walkers, 20 + 20 steps graphed, every launch
    on the global route, none on the matmul-DFT route, the lnpost against
    the CPU's float64, the resume bit for bit, the replayed retained step's
    time), ``model_galaxy_map`` there (:func:`route_map_check`: the
    residual forward and the backward), and a survey batch at
    :data:`GLOBAL_SURVEY_SHAPE` (a PSF star a target: per-target spectra,
    every evaluation on conv_lnl's global route, none on the general
    path).  Returns the rows (those at the fit's shape, with the other
    shapes' numbers ``by_shape``) with their launches on these paths, and
    the numbers."""
    import torch

    from psfmc_tpu_torch import batchfit as BF
    from psfmc_tpu_torch.batchfit import prepare_psf_stack
    from psfmc_tpu_torch.flagship import flagship_components, prior_draws, write_flagship_files
    from psfmc_tpu_torch.models import as_model, build_model_spec, build_posterior
    from psfmc_tpu_torch.ops.kernels import conv_lnl as CL
    from psfmc_tpu_torch.ops.kernels.sersic_render import render_sersics, render_sersics_plain

    shape = GLOBAL_FIT_SHAPE if shape is None else shape
    survey_shape = GLOBAL_SURVEY_SHAPE if survey_shape is None else survey_shape
    for s in [shape, survey_shape] + [t for t, _ in timed]:
        if CL.conv_route(s) != "global":
            raise AssertionError(f"{s} takes the {CL.conv_route(s)} route, not the global")
    t_phase = time.perf_counter()
    out = {"times": {}}
    env = {k: os.environ.pop(k) for k in ("PSFMC_LNPOST", "PSFMC_RENDER", "PSFMC_KAPPA")
           if k in os.environ}
    try:
        rng = np.random.RandomState(SEED + 14)
        for timed_shape, timed_psf in timed:
            key = f"{timed_shape[0]}x{timed_shape[1]}"
            spec = build_model_spec(flagship_components(timed_shape, timed_psf))
            post = build_posterior(spec, device=device, lnpost="batched")
            thetas = torch.as_tensor(prior_draws(spec, B_HALF, seed=1), dtype=torch.float32,
                                     device=post.device)
            params, sky = post.render_inputs(thetas)
            params, sky = params.contiguous(), sky.contiguous()
            _, render_rel, _ = compare(render_sersics(params, sky, timed_shape),
                                       render_sersics_plain(params, sky, timed_shape))
            log(f"global: {key}, render at B = {B_HALF}: max rel err {render_rel:.3e} "
                f"(tol {RENDER_TOL:g})")
            if not render_rel <= RENDER_TOL:
                raise AssertionError(f"global: the render disagrees at {key}")
            forward, fused = likelihood_rows(post, spec, thetas, ("conv_lnl_global", "global"),
                                             ("fused_lnl_global", "global"), norm_scale=True)
            residual, backward = conv_backward_rows(spec, "global", "conv_lnl_backward_global",
                                                    post.device, rng, f64_device=post.device)
            out["times"][key] = {"forward": forward, "residual": residual,
                                 "backward": backward, "fused": fused,
                                 "render_max_rel_err": render_rel}
            for r in (forward, residual, backward, fused):
                log(f"global: {key} {r['name']}: {r['ms']:.4f} ms (matmul-DFT route "
                    f"{r.get('dft_route_ms', float('nan')):.4f} ms, torch.fft "
                    f"{r.get('library_ms') or r.get('torch_fft_ms', float('nan')):.4f} ms, "
                    f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms by "
                    f"{r['bound_by']}, the route's own traffic "
                    f"{r.get('route_bound_ms', float('nan')):.5f} ms) ({CARD})")

        # conv_lnl with per-target spectra at the survey batch's half-step launch
        sspec = build_model_spec(flagship_components(survey_shape, psf_shape))
        spost = build_posterior(sspec, device=device, lnpost="batched")
        nt, per = BATCH_SURVEY_TARGETS, sspec.num_params + 1
        sthetas = torch.as_tensor(prior_draws(sspec, nt * per, seed=1), dtype=torch.float32,
                                  device=spost.device)
        sraws = spost.raw_and_ps(sthetas)[0].contiguous()
        obs = np.asarray(sspec.obs_data)[None] + rng.randn(nt, *survey_shape) * 0.005
        var = np.asarray(sspec.obs_var)[None] * rng.uniform(0.5, 2.0, (nt, 1, 1))
        good = rng.rand(nt, *survey_shape) > 0.02
        stars, ivms = psf_stars(nt, psf_shape, SEED + 46)
        f = prepare_psf_stack(sspec, stars, ivms, dtype=np.float64)
        f_psf = (f["psf_f_re"] + 1j * f["psf_f_im"])[:, 0]
        f_var = (f["var_f_re"] + 1j * f["var_f_im"])[:, 0]
        stack = CL.make_conv_lnl_consts_stack(f_psf, f_var, obs, var, good, spost.device)
        lib = tuple(torch.as_tensor(np.asarray(x)[:, None], dtype=torch.complex64,
                                    device=spost.device) for x in (f_psf, f_var))
        target = target_row("conv_lnl_targets_global_spectra", spost, sspec, stack, sraws,
                            lib)
        target.update(global_route_plan(nt * per, survey_shape, "forward", 4 * sum(
            t.numel() for t in (stack.pad_psf_r, stack.pad_psf_i, stack.pad_var_r,
                                stack.pad_var_i, stack.obs, stack.obs_var, stack.good_f))))

        # the fits at the fit's shape: the batched and the fused driver, the MAP
        out["driver"], _, _ = driver_phase(shape, psf_shape, device, lnpost=None)
        out["fused_driver"], _, _ = driver_phase(shape, psf_shape, device, lnpost="pallas")
        for label, launches, kernel in (("batched", out["driver"], "batched_conv_lnl"),
                                        ("fused", out["fused_driver"], "fused_lnl")):
            if launches[f"{kernel}:dft"] or not launches[f"{kernel}:global"]:
                raise AssertionError(f"global: the {label} fit launched {launches}")
        out.update(route_map_check(shape, psf_shape, device, "global"))

        # the survey batch: a PSF star a target, on conv_lnl's global route
        counted = counted_kernels()
        with tempfile.TemporaryDirectory() as tmp:
            smodel = as_model(write_flagship_files(tmp, survey_shape, psf_shape),
                              device=device)
        fns = smodel.posterior_fns
        sobs, sivm, _ = BF.simulate_stack(smodel, nt, seed=7)
        stars, star_ivms = psf_stars(nt, psf_shape, SEED + 47)
        if fns.device.type == "cuda":
            torch.cuda.synchronize()
        reset_counts(counted)
        t0 = time.perf_counter()
        res = BF.fit_batch(smodel, sobs, sivm, burn=BATCH_SURVEY_STEPS,
                           iterations=BATCH_SURVEY_STEPS, psf_stack=stars,
                           psfivm_stack=star_ivms)
        if fns.device.type == "cuda":
            torch.cuda.synchronize()
        swall = time.perf_counter() - t0
        slaunch, sroutes = read_counts(counted)
        evals = 1 + 2 * 2 * BATCH_SURVEY_STEPS
        want = {"render_sersics": evals, "render_sersics_tiled": 0,
                "batched_conv_lnl": evals, "fused_lnl": 0}
        want_routes = {"batched_conv_lnl:global_targets": evals,
                       "batched_conv_lnl:dft_targets": 0}
        got_routes = {k: sroutes[k] for k in want_routes}
        log(f"global: survey batch at {survey_shape[0]}x{survey_shape[1]}, {nt} targets, "
            f"{BATCH_SURVEY_STEPS} + {BATCH_SURVEY_STEPS} steps in {swall:.3f} s; launched "
            f"{slaunch} on {got_routes}")
        if slaunch != want or got_routes != want_routes:
            raise AssertionError(f"global: the survey batch launched {slaunch} on "
                                 f"{got_routes}, want {want} on {want_routes}")
        batch_fit_checks("global: survey batch", res, nt, smodel.num_params, {})
        _, prog = fns.__dict__["_batch_program"]
        sstack = prog.stacks[0]
        if sstack.mode != "batched" or not sstack.consts.target_spectra:
            raise AssertionError("global: the survey batch is not on the kernel path with "
                                 f"per-target spectra ({sstack.mode})")
        k, w, d = prog.state.positions.shape
        half = prog.state.positions[:, : w // 2].reshape(k * (w // 2), d).contiguous()
        out["survey_check"] = batch_kernel_check(fns, half, "global: survey batch", sstack)
        out["survey"] = {"targets": nt, "wall_s": swall, "shape": list(survey_shape),
                         "launches": slaunch, "routes": got_routes}
    finally:
        os.environ.update(env)

    key = f"{shape[0]}x{shape[1]}"
    rows = [dict(out["times"][key][kind]) for kind in ("forward", "residual", "backward",
                                                     "fused")]
    for r, kind in zip(rows, ("forward", "residual", "backward", "fused")):
        r["by_shape"] = {k: {f: x for f, x in v[kind].items()
                             if f not in ("name", "route", "source", "replaces", "launches")}
                         for k, v in out["times"].items()}
    m, d, fd = out["map"], out["driver"], out["fused_driver"]
    launches = {"conv_lnl_global": d["batched_conv_lnl:global"] + m["batched_conv_lnl:global"],
                "conv_lnl_res_global": m["batched_conv_lnl:global_res"],
                "conv_lnl_backward_global": m["batched_conv_lnl_backward:global"],
                "fused_lnl_global": fd["fused_lnl:global"],
                "conv_lnl_targets_global_spectra":
                    out["survey"]["routes"]["batched_conv_lnl:global_targets"]}
    rows.append(target)
    for r in rows:
        r["launches"] = launches[r["name"]]
    out["rows"] = rows
    out["render_launches"] = (d["render_sersics"] + m["render_sersics"]
                              + out["survey"]["launches"]["render_sersics"])
    out["render_backward_launches"] = m["render_sersics_backward"]
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"global: the phase took {out['wall_s']:.1f} s ({CARD})")
    return out


# the exported feedme prints 4 decimals: half a unit of the last, and the
# parse's float64 representation error far below 1e-9
GALFIT_ROUNDTRIP_TOL = 5e-5 + 1e-9
GALFIT_CPU_ROWS = 16  # walkers of the fit's last draws whose lnpost the CPU replays
LAPLACE_MARK = "+/-"  # a parameter card's value +/- its Laplace standard error


def captured(fn, *args):
    """``fn(*args)``'s return value and what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


def galfit_products(base, model, shape, label):
    """The five MAP products of ``base``: finite ``shape`` images, ``MAPLNP``
    and each of ``model``'s parameters' cards with its Laplace error.
    Returns ``MAPLNP``."""
    from psfmc_tpu_torch.io import fits

    hdr = None
    for ftype in IMAGE_TYPES:
        data = fits.getdata(f"{base}_{ftype}.fits")
        if data.shape != shape or not np.all(np.isfinite(data)):
            raise AssertionError(f"{label}: {ftype} is not a finite {shape} image")
        hdr = fits.getheader(f"{base}_{ftype}.fits")
    for abbr in model.param_fits_abbrs:
        if LAPLACE_MARK not in str(hdr[abbr]):
            raise AssertionError(f"{label}: card {abbr} = {hdr[abbr]!r} has no Laplace error")
    return float(hdr["MAPLNP"])


def galfit_roundtrip(text, db):
    """The largest distance of the exported feedme's values from the
    posterior means through the exact inverse conversions (positions + 1,
    position angle = angle - 90, ``q = reff_b / reff`` of the means; the
    tied host at its owner's position)."""
    from psfmc_tpu_torch.analysis import summary
    from psfmc_tpu_torch.io.galfit import parse_feedme

    means = {k: v["mean"] for k, v in summary(db).items()}
    objects = parse_feedme(text).objects
    if [o.kind for o in objects] != ["sky", "psf", "sersic", "sersic"]:
        raise AssertionError(f"galfit: exported objects {[o.kind for o in objects]}")
    ps_xy = [means[f"1_PointSource_xy_{i}"] + 1.0 for i in (0, 1)]
    want = [{"1": [means["0_Sky_adu"]]},
            {"1": ps_xy, "3": [means["1_PointSource_mag"]]}]
    for n, xy in ((2, ps_xy), (3, [means[f"3_Sersic_xy_{i}"] + 1.0 for i in (0, 1)])):
        want.append({"1": xy, "3": [means[f"{n}_Sersic_mag"]], "4": [means[f"{n}_Sersic_reff"]],
                     "5": [means[f"{n}_Sersic_index"]],
                     "9": [means[f"{n}_Sersic_reff_b"] / means[f"{n}_Sersic_reff"]],
                     "10": [means[f"{n}_Sersic_angle"] - 90.0]})
    err = 0.0
    for obj, w in zip(objects, want):
        for key, values in w.items():
            got = obj.params[key][0]
            if obj.params[key][1] != [1] * len(values):
                raise AssertionError(f"galfit: {obj.kind} {key}) toggles {obj.params[key][1]}")
            err = max(err, max(abs(g - v) for g, v in zip(got, values)))
    return err


def galfit_phase(shape=(128, 128), psf_shape=(64, 64), device=None):
    """A GALFIT user's path on the card (the arguments shrink it for a
    rehearsal on the CPU): the GALFIT flagship (a feedme of the MAP
    flagship with a ``G)`` constraint file tying the host's position to
    the point source's, beside the MAP flagship's FITS files) through
    ``import_galfit_main`` and the ``Configuration`` block appended
    (the batched path, the ``Tied`` host); ``quick_fit_main`` at
    :data:`MAP_STARTS` x :data:`MAP_STEPS` (the launches exact by wrapper
    and route, none on the matmul-DFT route, every Adam step one replay,
    the lnpost at the MAP within :data:`MAP_LNP_RTOL` of the CPU's
    float64, the five products with their Laplace cards) and once more
    as ``python -m psfmc_tpu_torch.cli quick_fit`` in a subprocess;
    ``model_galaxy_mcmc`` on the imported model (:data:`NWALKERS`
    walkers, :data:`BURN` + :data:`SAMPLE` steps; the launches exact,
    every step a replay, the last draws' lnpost against the CPU's
    float64); ``summary_main`` on its database, plain and with
    ``--criticism`` (the replays' launches exact); ``results_to_feedme``
    and its parse, equal to the posterior means through the inverse
    conversions.  The kernels against their plain versions at the
    phase's batches: the MAP's starts (the four gradient-path kernels),
    a half-ensemble of the fit, each replay chunk.  Returns the launches,
    the checks and each step's wall seconds."""
    import torch

    from psfmc_tpu_torch import cli, fitting
    from psfmc_tpu_torch.analysis import sensitivity
    from psfmc_tpu_torch.analysis.model_comparison import REPLAY_CHUNK, _resolve_thetas
    from psfmc_tpu_torch.database import load_database
    from psfmc_tpu_torch.flagship import MAG_ZP, write_galfit_files
    from psfmc_tpu_torch.io.galfit import results_to_feedme
    from psfmc_tpu_torch.models import MultiComponentModel, Tied
    from psfmc_tpu_torch.ops.kernels import conv_lnl as CL

    route = CL.conv_route(shape)
    seconds = {}
    out = {"seconds": seconds}
    t_phase = time.perf_counter()
    env = {k: os.environ.pop(k) for k in ("PSFMC_LNPOST", "PSFMC_RENDER", "PSFMC_KAPPA",
                                          "PSFMC_PLATFORM") if k in os.environ}
    if device == "cpu":
        os.environ["PSFMC_PLATFORM"] = "cpu"
    models, results = [], []
    as_model, model_galaxy_map = fitting.as_model, fitting.model_galaxy_map

    def kept_model(*a, **k):
        models.append(as_model(*a, **k))
        return models[-1]

    def kept_result(*a, **k):
        results.append(model_galaxy_map(*a, **k))
        return results[-1]

    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            feedme = write_galfit_files(tmp, shape, psf_shape, seed=SEED)
            seconds["inputs"] = time.perf_counter() - t0

            # import: the feedme (its G) file autoloaded) -> a model file
            t0 = time.perf_counter()
            model_file = os.path.join(tmp, "model.py")
            rc, printed = captured(cli.import_galfit_main, ["import_galfit", feedme, model_file])
            if rc != 0 or "wrote" not in printed:
                raise AssertionError(f"galfit: import_galfit returned {rc}: {printed}")
            with open(model_file, "a") as fh:
                fh.write('Configuration(obs_file="sci.fits", obsivm_file="ivm.fits", '
                         'psf_files="psf.fits", psfivm_files="psf_ivm.fits", '
                         f'mask_file="mask.reg", mag_zeropoint={MAG_ZP!r})\n')
            model = fitting.as_model(model_file, device=device)
            fns = model.posterior_fns
            host = model.components[2]
            tie = host._constants.get("xy")
            tied = isinstance(tie, Tied) and tie.component is model.components[1]
            out["import"] = {"lnpost": fns.lnpost, "grad_mode": fns.grad_mode,
                             "params": model.num_params, "tied": tied}
            seconds["import"] = time.perf_counter() - t0
            log(f"galfit: imported {os.path.basename(feedme)} -> {model.num_params} "
                f"parameters {model.param_names}; path {fns.lnpost}, gradient "
                f"{fns.grad_mode}; the host's position tied to the point source: {tied}")
            if fns.lnpost != "batched" or fns.grad_mode != "batched" or not tied:
                raise AssertionError(f"galfit: the imported model {out['import']}")
            cpu = MultiComponentModel(model_file, device="cpu", dtype=torch.float64)
            c64 = cpu.posterior_fns.consts

            # the MAP fit through the command
            counted = grad_kernels()
            fitting.as_model, fitting.model_galaxy_map = kept_model, kept_result
            try:
                torch.cuda.synchronize()
                reset_counts(counted)
                t0 = time.perf_counter()
                rc, printed = captured(cli.quick_fit_main, [
                    "quick_fit", model_file, os.path.join(tmp, "map"),
                    f"n_starts={MAP_STARTS}", f"steps={MAP_STEPS}"])
                torch.cuda.synchronize()
                seconds["quick_fit"] = time.perf_counter() - t0
                launches, by_route = read_counts(counted)
            finally:
                fitting.as_model, fitting.model_galaxy_map = as_model, model_galaxy_map
            (res,), (map_model,) = results, models[-1:]
            if rc != 0 or f"lnpost = {res.lnpost:.3f}" not in printed:
                raise AssertionError(f"galfit: quick_fit returned {rc}: {printed}")
            evals = MAP_STEPS + 1
            want = {"render_sersics": 1 + evals + 2 + 1, "render_sersics_backward": evals + 2,
                    "batched_conv_lnl": 1 + evals + 2, "batched_conv_lnl_backward": evals + 2}
            want_routes = {f"batched_conv_lnl:{route}": 1,
                           f"batched_conv_lnl:{route}_res": evals + 2,
                           f"batched_conv_lnl_backward:{route}": evals + 2,
                           "batched_conv_lnl:dft": 0, "batched_conv_lnl_backward:dft": 0}
            got_routes = {k: by_route[k] for k in want_routes}
            if launches != want or got_routes != want_routes:
                raise AssertionError(f"galfit: quick_fit launched {launches} {got_routes}, "
                                     f"want {want} {want_routes}")
            program = map_program(map_model.posterior_fns)
            if map_model.posterior_fns.device.type == "cuda":  # the CPU runs no graph
                if program.replays != MAP_STEPS:
                    raise AssertionError(f"galfit: {program.replays} replays for "
                                         f"{MAP_STEPS} Adam steps")
                check_step_tally(program, {("render_sersics", None): 1,
                                           ("render_sersics_backward", None): 1,
                                           ("batched_conv_lnl", f"{route}_res"): 1,
                                           ("batched_conv_lnl_backward", route): 1},
                                 "galfit quick_fit")
            maplnp = galfit_products(os.path.join(tmp, "map"), map_model, shape,
                                     "galfit quick_fit")
            lnp64 = float(cpu.posterior_fns.log_posterior_batch(res.theta[None])[0])
            map_rel = abs(res.lnpost - lnp64) / abs(lnp64)
            out["map"] = dict(launches, **by_route)
            out["map_lnpost"], out["map_lnpost_rel_err"] = res.lnpost, map_rel
            log(f"galfit: quick_fit {MAP_STARTS} starts x {MAP_STEPS} steps in "
                f"{seconds['quick_fit']:.2f} s; lnpost {res.lnpost:.4f} on the card, "
                f"{lnp64:.4f} on the CPU in float64 (rel {map_rel:.2e}, tol "
                f"{MAP_LNP_RTOL:g}); launches {launches}, {got_routes}; products with "
                f"MAPLNP {maplnp:.4f} and Laplace cards ({CARD})")
            if not (map_rel <= MAP_LNP_RTOL and math.isclose(maplnp, res.lnpost,
                                                             rel_tol=1e-6)):
                raise AssertionError("galfit: the MAP's lnpost disagrees with the CPU's "
                                     "float64 or with MAPLNP")
            # the Adam steps' batch: the MAP's starts, the best of its pool (at
            # the optima the sky's gradient sums to about 0, where its relative
            # error means nothing); far from the data (lnL down to -1e7)
            pool = map_model.init_params_from_priors(max(4 * MAP_STARTS, 128),
                                                     random_state=np.random.RandomState(SEED))
            with torch.no_grad():
                lnp_pool = fns.log_posterior_batch(pool).double().cpu().numpy()
            order = np.argsort(np.where(np.isfinite(lnp_pool), lnp_pool, -np.inf))[::-1]
            starts = torch.as_tensor(pool[order[:MAP_STARTS]], dtype=torch.float32,
                                     device=fns.device)
            checks = {"map": [grad_batch_check(map_model.posterior_fns, starts,
                                               "galfit, the MAP's starts", SEED + 22,
                                               norm_scale=True, f64=True)]}

            # the same command as a user runs it, in its own process
            t0 = time.perf_counter()
            sub_env = dict(os.environ, PYTHONPATH=os.pathsep.join(
                [os.path.dirname(os.path.abspath(__file__))]
                + [p for p in [os.environ.get("PYTHONPATH")] if p]))
            proc = subprocess.run(
                [sys.executable, "-m", "psfmc_tpu_torch.cli", "quick_fit", model_file,
                 os.path.join(tmp, "sub"), f"n_starts={MAP_STARTS}", f"steps={MAP_STEPS}"],
                cwd=tmp, env=sub_env, capture_output=True, text=True, timeout=600)
            seconds["quick_fit_subprocess"] = time.perf_counter() - t0
            out["subprocess_rc"] = proc.returncode
            if proc.returncode != 0:
                raise AssertionError(f"galfit: python -m psfmc_tpu_torch.cli quick_fit "
                                     f"returned {proc.returncode}:\n{proc.stdout}\n"
                                     f"{proc.stderr[-4000:]}")
            sub_lnp = galfit_products(os.path.join(tmp, "sub"), map_model, shape,
                                      "galfit quick_fit subprocess")
            log(f"galfit: python -m psfmc_tpu_torch.cli quick_fit: rc 0 in "
                f"{seconds['quick_fit_subprocess']:.2f} s (the process's start "
                f"included), {proc.stdout.strip()!r}, MAPLNP {sub_lnp:.4f}, five products "
                f"with Laplace cards ({CARD})")

            # the MCMC fit of the imported model
            t0 = time.perf_counter()
            db, sm, at_images, total, moved, wall = counted_fit(
                model_file, os.path.join(tmp, "fit"), device)
            seconds["mcmc"] = time.perf_counter() - t0
            want = family_launches("batched", BURN, SAMPLE, moved=sum(n > 0 for n in moved))
            got, got_r = at_images
            if got != want or got_r[f"batched_conv_lnl:{route}"] != want["batched_conv_lnl"] \
                    or got_r["batched_conv_lnl:dft"] or total[1]["batched_conv_lnl:dft"]:
                raise AssertionError(f"galfit: the fit launched {got} {got_r}, want {want} "
                                     f"on the {route} route")
            if fns.device.type == "cuda" and sm.graph_replays != BURN + SAMPLE:
                raise AssertionError(f"galfit: {sm.graph_replays} replays for "
                                     f"{BURN + SAMPLE} steps")
            names = model.param_names
            last = np.stack([np.concatenate([np.atleast_1d(np.asarray(v, float)) for v in row])
                             for row in db[names][SAMPLE - 1::SAMPLE]])
            with torch.no_grad():
                got_lnp = fns.log_posterior_batch(last[:GALFIT_CPU_ROWS]).double().cpu().numpy()
            want_lnp = cpu.posterior_fns.log_posterior_batch(last[:GALFIT_CPU_ROWS]).numpy()
            fit_rel = float(np.max(np.abs(got_lnp - want_lnp) / np.abs(want_lnp)))
            acc = float(db.meta["MCACCEPT"])
            out["mcmc"] = dict(total[0], **total[1])
            out["mcmc_lnpost_rel_err"], out["mcmc_acceptance"] = fit_rel, acc
            log(f"galfit: model_galaxy_mcmc {NWALKERS} walkers, {BURN} + {SAMPLE} steps in "
                f"{wall:.2f} s; acceptance {acc:.4f}; sampling launched {got}; the last "
                f"draws' lnpost against the CPU's float64, {GALFIT_CPU_ROWS} walkers: max rel "
                f"{fit_rel:.2e} (tol {SLICE_RTOL:g}) ({CARD})")
            if not (np.all(np.isfinite(got_lnp)) and fit_rel <= SLICE_RTOL and 0 < acc < 1):
                raise AssertionError("galfit: the fit's lnpost disagrees with the CPU's "
                                     "float64, or it accepted nothing")
            half = torch.as_tensor(last[:B_HALF], dtype=torch.float32, device=fns.device)
            checks["mcmc"] = [batch_kernel_check(fns, half, "galfit, a half-ensemble",
                                                 norm_scale=True, c64=c64)]

            # the summary, plain and with the criticism replays
            db_file = os.path.join(tmp, "fit_db.fits")
            t0 = time.perf_counter()
            rc, printed = captured(cli.summary_main, ["summary", db_file])
            seconds["summary"] = time.perf_counter() - t0
            lines = printed.splitlines()
            dashes = next(i for i, line in enumerate(lines) if line and set(line) == {"-"})
            rows = [line.split()[0] for line in lines[dashes + 1:]]
            want_rows = [f"{n}_{i}" if ln > 1 else n for n, ln in zip(names, model.param_lens)
                         for i in range(ln)] + ["lnprobability"]
            if rc not in (0, 1) or rows != want_rows:
                raise AssertionError(f"galfit: summary returned {rc}, rows {rows}")
            counted = counted_kernels()
            torch.cuda.synchronize()
            reset_counts(counted)
            t0 = time.perf_counter()
            rc_crit, crit = captured(cli.summary_main,
                                     ["summary", "--criticism", model_file, db_file])
            torch.cuda.synchronize()
            seconds["summary_criticism"] = time.perf_counter() - t0
            launches, by_route = read_counts(counted)
            fit_db = load_database(db_file)
            pointwise = _resolve_thetas(model, fit_db, None, 1000)
            scaling = _resolve_thetas(model, fit_db, None, 4000)
            sizes = ((pointwise, REPLAY_CHUNK), (scaling, sensitivity.REPLAY_CHUNK))
            chunks = [-(-len(t) // size) for t, size in sizes]
            want = {"render_sersics": 2 * chunks[0] + chunks[1], "render_sersics_tiled": 0,
                    "batched_conv_lnl": chunks[1], "fused_lnl": 0}
            out["summary"] = dict(launches, **by_route)
            log(f"galfit: summary {seconds['summary']:.2f} s (rc {rc}); summary --criticism "
                f"{seconds['summary_criticism']:.2f} s (rc {rc_crit}): {len(pointwise)} "
                f"pointwise draws in chunks of {REPLAY_CHUNK} and {len(scaling)} "
                f"power-scaling draws in chunks of {sensitivity.REPLAY_CHUNK}; launched "
                f"{launches} (want {want}) ({CARD})")
            if rc_crit not in (0, 1) or "unavailable" in crit or not all(
                    s in crit for s in ("PSIS-LOO", "LOO-PIT", "power-scaling sensitivity")):
                raise AssertionError(f"galfit: summary --criticism returned {rc_crit}:\n{crit}")
            if launches != want or by_route[f"batched_conv_lnl:{route}"] != chunks[1]:
                raise AssertionError(f"galfit: summary --criticism launched {launches} "
                                     f"{by_route}, want {want}")
            batches = sorted({min(size, len(t) - lo) for t, size in sizes
                              for lo in range(0, len(t), size)}, reverse=True)
            checks["summary"] = [batch_kernel_check(
                fns, torch.as_tensor(scaling[:b], dtype=torch.float32, device=fns.device),
                "galfit, summary replay chunk", norm_scale=True, c64=c64) for b in batches]

            # the export and its round trip
            t0 = time.perf_counter()
            text = results_to_feedme(model, database=db_file)
            err = galfit_roundtrip(text, fit_db)
            seconds["export"] = time.perf_counter() - t0
            out["roundtrip_max_err"] = err
            log(f"galfit: results_to_feedme -> parse_feedme: the values within {err:.2e} of "
                f"the posterior means through the inverse conversions (tol "
                f"{GALFIT_ROUNDTRIP_TOL:g})")
            if not err <= GALFIT_ROUNDTRIP_TOL:
                raise AssertionError("galfit: the exported feedme misses the posterior means")
            out["kernel_checks"] = checks
    finally:
        fitting.as_model, fitting.model_galaxy_map = as_model, model_galaxy_map
        os.environ.pop("PSFMC_PLATFORM", None)
        os.environ.update(env)
    seconds["phase"] = time.perf_counter() - t_phase
    log("galfit: wall seconds " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
        + f" ({CARD})")
    return out


# -- the mesh phase: multi-device fits (psfmc_tpu_torch.parallel) ----------------------
MESH_RANK_TIMEOUT = 420  # s: a rank's subprocess
MESH_COLLECTIVE_TIMEOUT = 240  # s: every collective of a rank's process group
MESH_IMAGE_RTOL = 1e-6  # the world-1 mesh fit's images against the unsharded fit's
MESH_LNZ_RTOL = 1e-6  # the sharded anneal's lnZ against the one-process anneal's
MESH_NUTS = {"chains": 8, "burn": 6, "sample": 4, "depth": 4}
MESH_AIS = {"nwalkers": 256, "nsteps": 30, "sweeps": 1, "moves": "mixed"}
MESH_AIS_GROUPS = 8  # 7 must raise over 2 ranks
MESH_BATCH_TARGETS, MESH_BATCH_STEPS = 32, 3  # flagship mocks, burn and retained steps
MESH_HIER = {"targets": 4, "chains": 2, "steps": 3, "depth": 3, "pool": 4}
MESH_STEP_REPS = (5, 5)  # time_ms's reps and inner calls for a replayed (an eager) step
MESH_RANK_COMMAND = None  # a rank's command before its arguments (None: this script)


def mesh_kernels():
    """The wrappers the mesh phase counts: every kernel of its paths."""
    return counted_kernels() + grad_kernels()[1::2]


def mesh_driver_fit(model_file, out, mesh, counted, lnpost, device, iterations=SAMPLE):
    """``model_galaxy_mcmc`` on the flagship at full width (250 walkers,
    20 burn + ``iterations`` retained steps in segments of 10), on
    ``mesh`` (None: unsharded), the counts set to 0 just before and read
    just after; returns the database as arrays, the sampler, the launches
    and the wall seconds."""
    import torch

    from psfmc_tpu_torch import fitting

    samplers = []
    init = fitting.EnsembleSampler.__init__

    def kept(self, *a, **k):
        init(self, *a, **k)
        samplers.append(self)

    os.makedirs(os.path.dirname(out), exist_ok=True)
    os.environ.pop("PSFMC_LNPOST", None)
    if lnpost:
        os.environ["PSFMC_LNPOST"] = lnpost
    fitting.EnsembleSampler.__init__ = kept
    try:
        torch.cuda.synchronize()
        reset_counts(counted)
        t0 = time.perf_counter()
        db = fitting.model_galaxy_mcmc(model_file, output_name=out, chains=NWALKERS,
                                       burn=BURN, iterations=iterations, seed=SEED,
                                       checkpoint_interval=CHECKPOINT, mesh=mesh,
                                       device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, routes = read_counts(counted)
    finally:
        fitting.EnsembleSampler.__init__ = init
        os.environ.pop("PSFMC_LNPOST", None)
    (sm,) = samplers
    launches.update(routes)
    arrays = {name: np.asarray(db[name]) for name in db.colnames}
    arrays["phases"] = np.array(sorted(db.phase_seconds))
    return arrays, sm, launches, wall


def mesh_more_fits(model, mesh, counted):
    """The other sharded entry points at small depth on the flagship
    (``mesh`` None: the one-process references): NUTS with 8 chains,
    ``ais_evidence`` with 8 groups (and, over 2 ranks, 7, which must
    raise), ``fit_batch`` with 32 mocks and ``fit_hierarchical`` with
    ``shard="targets"`` and ``"chains"``.  Returns the results as arrays
    and each entry point's launches."""
    import torch

    from psfmc_tpu_torch import batchfit as BF
    from psfmc_tpu_torch import hierarchy as H
    from psfmc_tpu_torch.flagship import prior_draws
    from psfmc_tpu_torch.parallel import walker_sharding
    from psfmc_tpu_torch.sampler import NUTSSampler, ais_evidence

    fns = model.posterior_fns
    sharding = None if mesh is None else walker_sharding(mesh)
    res, launches = {}, {}

    def counted_run(name, fn):
        torch.cuda.synchronize()
        reset_counts(counted)
        out = fn()
        torch.cuda.synchronize()
        c, r = read_counts(counted)
        c.update(r)
        launches[name] = c
        return out

    n = MESH_NUTS

    def nuts():
        sm = NUTSSampler(n["chains"], model.num_params, fns, seed=SEED, max_depth=n["depth"],
                         sharding=sharding)
        sm.init_state(prior_draws(model.spec, 32 * n["chains"], seed=SEED + 80))
        sm.run_burn(n["burn"])
        sm.reset()
        sm.run_sampling(n["sample"])
        return sm

    sm = counted_run("nuts", nuts)
    res.update(nuts_chain=sm.chain, nuts_lnp=sm.lnprobability)
    ais = counted_run("ais", lambda: ais_evidence(fns, groups=MESH_AIS_GROUPS, seed=SEED,
                                                  mesh=mesh, **MESH_AIS))
    res.update(ais_groups=ais.lnz_groups, ais_lnz=np.float64(ais.lnz))
    if mesh is not None:
        try:
            ais_evidence(fns, groups=MESH_AIS_GROUPS - 1, seed=SEED, mesh=mesh, **MESH_AIS)
        except ValueError as err:
            res["ais_refusal"] = np.array(str(err))
    obs, ivm, _ = BF.simulate_stack(model, MESH_BATCH_TARGETS, seed=1)
    b = counted_run("batch", lambda: BF.fit_batch(model, obs, ivm, burn=MESH_BATCH_STEPS,
                                                  iterations=MESH_BATCH_STEPS, seed=SEED,
                                                  mesh=mesh))
    res.update({f"batch_{f}": getattr(b, f) for f in ("mean", "std", "map_lnp",
                                                      "acceptance")})
    h = MESH_HIER
    for shard in ("targets", "chains"):
        fit = counted_run(f"hier_{shard}", lambda: H.fit_hierarchical(
            model, obs[:h["targets"]], ivm[:h["targets"]], hier_population(),
            sampler="nuts", chains=h["chains"], init_pool=h["pool"], max_depth=h["depth"],
            burn=h["steps"], iterations=h["steps"], seed=SEED, mesh=mesh, shard=shard))
        res.update({f"hier_{shard}_chain": fit.flatchain, f"hier_{shard}_lnp": fit.lnp})
    return res, launches


def mesh_rank(mode, rank, world, store, work, device="cuda:0"):
    """One rank of the mesh phase, in its own process (``python3
    chip_smoke.py --mesh-rank <mode> <rank> <world> <store> <work>
    <device>``):
    ``a``, one rank on NCCL (graphed steps), the flagship fit unsharded and
    on the mesh and the one-process references of (b); ``b``, a rank of two
    on the one card, gloo (eager steps), every sharded entry point.  Writes
    its arrays to ``<work>/<mode><rank>.npz`` and its numbers to
    ``<work>/<mode><rank>.json``."""
    import datetime

    import torch

    import psfmc_tpu_torch.models.posterior as P
    from psfmc_tpu_torch.io import fits
    from psfmc_tpu_torch.models import as_model
    from psfmc_tpu_torch.ops.kernels.fused_lnl import fused_lnl, fused_lnl_plain
    from psfmc_tpu_torch.parallel import initialize, walker_mesh

    global CARD
    CARD = card_identity()
    # NCCL refuses two ranks on one device ("Duplicate GPU detected"): two
    # ranks on the one card run gloo, whose collectives go through the host
    backend = "nccl" if mode == "a" and device.startswith("cuda") else "gloo"
    initialize(backend, init_method=f"file://{store}", world_size=world, rank=rank,
               timeout=datetime.timedelta(seconds=MESH_COLLECTIVE_TIMEOUT))
    mesh = walker_mesh(device)
    counted = mesh_kernels()
    model_file = os.path.join(work, "inputs", "model.py")
    res, info = {}, {"backend": mesh.backend, "graphed": mesh.graphed, "size": mesh.size,
                     "rank": mesh.rank}
    model = as_model(model_file, device=mesh.device, lnpost="batched")

    def save(prefix, arrays):
        res.update({f"{prefix}:{k}": v for k, v in arrays.items()})

    if mode == "a":
        plain, sm0, l0, w0 = mesh_driver_fit(model_file, os.path.join(work, "a_plain", "out"),
                                             None, counted, None, mesh.device)
        on_mesh, sm1, l1, w1 = mesh_driver_fit(model_file, os.path.join(work, "a_mesh", "out"),
                                               mesh, counted, None, mesh.device)
        differ = [k for k in plain if not np.array_equal(plain[k], on_mesh[k])]
        img_err = 0.0
        for ftype in IMAGE_TYPES:
            a = fits.getdata(os.path.join(work, "a_plain", f"out_{ftype}.fits"))
            b = fits.getdata(os.path.join(work, "a_mesh", f"out_{ftype}.fits"))
            img_err = max(img_err, float(np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-30)))
        replays = [sm0.graph_replays, sm1.graph_replays]  # before the timed replays
        t = [time_ms(lambda s=s: s._step("retain"), *MESH_STEP_REPS)
             for s in (sm0, sm1, sm1, sm0)]
        info.update(plain_launches=l0, mesh_launches=l1, plain_wall_s=w0, mesh_wall_s=w1,
                    differ=differ, image_rel_err=img_err, replays=replays,
                    steps=BURN + SAMPLE, plain_step_ms=[t[0], t[3]],
                    mesh_step_ms=[t[1], t[2]])
        save("batched", plain)
        fused, smf, lf, wf = mesh_driver_fit(model_file, os.path.join(work, "a_fused", "out"),
                                             None, counted, "pallas", mesh.device)
        save("fused", fused)
        info.update(fused_launches=lf)
    else:
        sizes = {}
        originals = {name: getattr(P, name) for name in ("batched_conv_lnl", "fused_lnl")}

        def recording(name):
            def rec(*a, **k):  # each evaluation's batch, as the kernel receives it
                sizes.setdefault(name, []).append(int(a[0].shape[0]))
                return originals[name](*a, **k)
            return rec

        for name in originals:
            setattr(P, name, recording(name))
        try:
            mine = os.path.join(work, f"b{rank}")
            batched, sm, lb, wb = mesh_driver_fit(model_file, os.path.join(mine, "out"), mesh,
                                                  counted, None, mesh.device)
            shared = os.path.join(work, "b_shared", "out_fused")
            fused, smf, lf, wf = mesh_driver_fit(model_file, shared, mesh, counted, "pallas",
                                                mesh.device)
            resumed, smr, lr, wr = mesh_driver_fit(model_file, shared, mesh, counted, "pallas",
                                                   mesh.device, iterations=2 * SAMPLE)
        finally:
            for name, fn in originals.items():
                setattr(P, name, fn)
        step_ms = time_ms(lambda: sm._step("retain"), *MESH_STEP_REPS)
        save("batched", batched)
        save("fused", fused)
        save("resumed", resumed)
        info.update(batched_launches=lb, fused_launches=lf, resumed_launches=lr,
                    batched_wall_s=wb, fused_wall_s=wf, resumed_wall_s=wr, sizes=sizes,
                    eager_step_ms=step_ms, files=sorted(os.listdir(mine)) if os.path.isdir(mine) else [])
        # the kernels at this rank's own batch of the last half-step, against
        # their plain versions (launches made to compare do not count)
        half = NWALKERS // 2
        lo, hi = mesh.rows(half)
        thetas = sm.state.positions[half:][lo:hi].contiguous()
        info["kernel_checks"] = {"batched": batch_kernel_check(
            model.posterior_fns, thetas, f"mesh rank {rank}, the batched fit's half-step")}
        fpost = smf.fns.base
        ft = smf.state.positions[half:][lo:hi].contiguous()
        params, sky = fpost.render_inputs(ft)
        fky, kx = fpost.pointsource_inputs(ft)
        args = [x.contiguous() for x in (params, sky, fky, kx)]
        _, rel, _ = compare(fused_lnl(*args, fpost.consts), fused_lnl_plain(*args, fpost.consts))
        log(f"mesh rank {rank}: fused_lnl at B = {hi - lo}: max rel err {rel:.3e} "
            f"(tol {FUSED_TOL:g})")
        if not rel <= FUSED_TOL:
            raise AssertionError(f"mesh rank {rank}: fused_lnl disagrees with its plain "
                                 "version")
        info["kernel_checks"]["fused"] = {"batch": hi - lo, "fused_lnl_max_rel_err": rel}
    more, more_launches = mesh_more_fits(model, mesh if mode == "b" else None, counted)
    res.update(more)
    info["more_launches"] = more_launches
    np.savez(os.path.join(work, f"{mode}{rank}.npz"), **res)
    with open(os.path.join(work, f"{mode}{rank}.json"), "w") as fh:
        json.dump(info, fh, default=float)
    torch.distributed.destroy_process_group()


def mesh_launch(mode, world, work, device):
    """Start ``world`` rank processes of ``mode``, each with a timeout,
    and wait for them; their output goes to ``<work>/<mode><rank>.log``
    and is printed after.  Returns each rank's (arrays, numbers)."""
    store = os.path.join(work, f"store_{mode}")
    procs, logs = [], []
    for r in range(world):
        logs.append(open(os.path.join(work, f"{mode}{r}.log"), "w"))
        command = MESH_RANK_COMMAND or [sys.executable, os.path.abspath(__file__)]
        procs.append(subprocess.Popen(
            command + ["--mesh-rank", mode, str(r), str(world), store, work, device],
            stdout=logs[-1], stderr=subprocess.STDOUT))
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, MESH_RANK_TIMEOUT - (time.perf_counter() - t0)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for fh in logs:
            fh.close()
    for r, p in enumerate(procs):
        with open(os.path.join(work, f"{mode}{r}.log")) as fh:
            for line in fh.read().splitlines():
                log(f"  [mesh {mode}{r}] {line}")
        if p.returncode != 0:
            raise AssertionError(f"mesh: rank {r} of ({mode}) exited with {p.returncode}")
    out = []
    for r in range(world):
        with open(os.path.join(work, f"{mode}{r}.json")) as fh:
            out.append((dict(np.load(os.path.join(work, f"{mode}{r}.npz"))), json.load(fh)))
    return out


def mesh_phase(shape=None, psf_shape=(64, 64), device="cuda:0"):
    """Multi-device fits (:mod:`psfmc_tpu_torch.parallel`) on the one card,
    each rank a process of its own (the arguments shrink the flagship).

    (a) One rank on NCCL: the flagship at full width (128x128, 64x64 PSF,
    250 walkers, 20 + 20 steps in segments of 10, the batched path)
    through ``model_galaxy_mcmc(mesh=walker_mesh())`` and without a mesh:
    chains and lnprob equal bit for bit, the five images within
    :data:`MESH_IMAGE_RTOL`, the launches equal, every step a replay (its
    all-gather captured inside), the replayed retained step's time beside
    the unsharded one's.  (b) Two ranks on cuda:0 (gloo: NCCL refuses two
    ranks on one device; eager steps): the same fit on the batched path
    and on the fused kernel, each rank's chain equal bit for bit to (a)'s
    unsharded fit and to the other rank's, files in rank 0's directory
    only, a second call with 40 iterations in a shared directory resuming
    on both ranks (no burn-in left), each rank's kernel launches on its own
    62 or 63 walkers a half-step, counted exactly; the render, conv_lnl and
    fused_lnl at that batch against their plain versions; then NUTS with 8
    chains, ``ais_evidence`` with 8 groups (7 must raise), ``fit_batch``
    with 32 flagship mocks and ``fit_hierarchical`` with ``shard="targets"``
    and ``"chains"``, each held to its one-process run in (a): bit for bit,
    lnZ within :data:`MESH_LNZ_RTOL`.  Returns the launches (summed over
    every rank and run), the numbers and the checks."""
    import shutil

    import torch

    from psfmc_tpu_torch.flagship import write_flagship_files

    shape = FLAGSHIP_SHAPE if shape is None else shape
    cuda = device.startswith("cuda")
    if cuda:
        torch.cuda.empty_cache()  # the ranks share the card with this process
    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="psfmc_mesh_")
    try:
        os.makedirs(os.path.join(work, "inputs"))
        write_flagship_files(os.path.join(work, "inputs"), shape, psf_shape)
        (a_res, a), = mesh_launch("a", 1, work, device)
        b = mesh_launch("b", 2, work, device)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # (a): the world-1 mesh fit against the unsharded fit, in one process;
    # every check's failure is collected, then all of them raised at once
    problems = []

    def check(ok, msg):
        if not ok:
            problems.append(msg)
            log(f"mesh: FAILED: {msg}")

    def nonzero(launches):
        return {k: v for k, v in launches.items() if v}

    check(a["backend"] == ("nccl" if cuda else "gloo") and a["graphed"] == cuda,
          f"(a) backend {a['backend']}, graphed {a['graphed']}")
    check(not a["differ"], f"(a) the mesh fit differs from the unsharded fit in {a['differ']}")
    check(a["image_rel_err"] <= MESH_IMAGE_RTOL, f"(a) images differ by {a['image_rel_err']:.3e}")
    check(a["replays"] == [a["steps"] if cuda else 0] * 2, f"(a) replays {a['replays']}")
    check(a["plain_launches"] == a["mesh_launches"],
          f"(a) launches {nonzero(a['plain_launches'])} unsharded, "
          f"{nonzero(a['mesh_launches'])} on the mesh")
    log(f"mesh (a): one rank on {a['backend']}: the flagship fit on the mesh against the "
        f"unsharded fit ({NWALKERS} walkers, {a['steps']} steps, replays {a['replays']}, the "
        f"mesh's all-gathers captured in its steps): columns that differ {a['differ']}; images "
        f"within {a['image_rel_err']:.3e}; launches {nonzero(a['mesh_launches'])} on the mesh; "
        f"a replayed retained step {a['mesh_step_ms'][0]:.4f}, {a['mesh_step_ms'][1]:.4f} ms "
        f"on the mesh, {a['plain_step_ms'][0]:.4f}, {a['plain_step_ms'][1]:.4f} ms unsharded "
        f"({CARD})")

    # (b): two ranks on one card against each other and against (a)
    (r0, b0), (r1, b1) = b
    differ = [k for k in r0 if k != "ais_refusal" and not np.array_equal(r0[k], r1[k])]
    check(not differ, f"(b) the two ranks differ in {differ}")
    for key in ("batched", "fused"):
        cols = [k for k in r0 if k.startswith(f"{key}:") and not k.endswith(":phases")]
        differ = [k for k in cols if not np.array_equal(r0[k], a_res[k])]
        check(cols and not differ, f"(b) the {key} fit differs from the unsharded fit in "
                                   f"{differ}")
    exact = ["nuts_chain", "nuts_lnp", "batch_mean", "batch_std", "batch_map_lnp",
             "batch_acceptance", "hier_chains_chain", "hier_chains_lnp", "hier_targets_chain",
             "hier_targets_lnp"]
    differ = [k for k in exact if not np.array_equal(r0[k], a_res[k])]
    check(not differ, f"(b) differs from the one-process runs in {differ}")
    lnz_err = float(np.max(np.abs(r0["ais_groups"] - a_res["ais_groups"])
                           / np.maximum(np.abs(a_res["ais_groups"]), 1.0)))
    check(lnz_err <= MESH_LNZ_RTOL, f"(b) lnZ by group differs by {lnz_err:.3e}")
    refusal = str(r0.get("ais_refusal", ""))
    check("must be a multiple of the mesh size (2)" in refusal,
          f"(b) groups={MESH_AIS_GROUPS - 1} did not raise: {refusal!r}")
    check(b0["backend"] == "gloo" and not b0["graphed"] and b0["files"] and not b1["files"],
          f"(b) backend {b0['backend']}, graphed {b0['graphed']}, files {b0['files']} / "
          f"{b1['files']}")
    phases = [str(p) for p in r0["resumed:phases"]]
    check("burn" not in phases and len(r0["resumed:lnprobability"]) == NWALKERS * 2 * SAMPLE,
          f"(b) the second call did not resume ({phases})")
    half = NWALKERS // 2
    steps = BURN + SAMPLE
    for r, info in enumerate((b0, b1)):
        # every half-step on the rank's own rows of the 125; the start and
        # each rejuvenation that moved walkers on its half of the 250
        own = (r + 1) * half // 2 - r * half // 2
        sizes_b = info["sizes"]["batched_conv_lnl"]
        check(sizes_b.count(own) == 2 * steps and set(sizes_b) == {own, half}
              and info["batched_launches"]["batched_conv_lnl"] == len(sizes_b)
              and info["batched_launches"]["batched_conv_lnl:fft"] == len(sizes_b),
              f"(b) rank {r}: conv_lnl batches {sizes_b}, launches "
              f"{nonzero(info['batched_launches'])}")
        sizes_f = info["sizes"]["fused_lnl"]
        nf = info["fused_launches"]["fused_lnl"] + info["resumed_launches"]["fused_lnl"]
        check(sizes_f.count(own) == 2 * (steps + SAMPLE) and set(sizes_f) == {own, half}
              and nf == len(sizes_f), f"(b) rank {r}: fused_lnl batches {sizes_f}, launches "
                                      f"{nf}")
    log(f"mesh (b): two ranks on {device}, {b0['backend']} (NCCL refuses two ranks on one "
        f"device), steps graphed {b0['graphed']}: the batched and the fused fit against the "
        f"unsharded fits on both ranks; files from rank 0 ({len(b0['files'])}) and rank 1 "
        f"({len(b1['files'])}); the second call's phases {phases}; each rank's conv_lnl on "
        f"its own {half // 2} / {half - half // 2} walkers a half-step "
        f"({b0['sizes']['batched_conv_lnl'].count(half // 2)} and "
        f"{b1['sizes']['batched_conv_lnl'].count(half - half // 2)} launches); an eager "
        f"retained step {b0['eager_step_ms']:.3f} / {b1['eager_step_ms']:.3f} ms ({CARD}); "
        f"NUTS, fit_batch and both hierarchical fits against the one-process runs, lnZ "
        f"within {lnz_err:.1e}; groups={MESH_AIS_GROUPS - 1}: {refusal!r}")
    if problems:
        raise AssertionError("mesh: " + "; ".join(problems))

    # every launch of the phase's runs, summed over ranks and runs
    total = {}
    runs = [a["plain_launches"], a["mesh_launches"], a["fused_launches"]]
    runs += list(a["more_launches"].values())
    for info in (b0, b1):
        runs += [info["batched_launches"], info["fused_launches"], info["resumed_launches"]]
        runs += list(info["more_launches"].values())
    for run in runs:
        for k, v in run.items():
            total[k] = total.get(k, 0) + v
    wall = time.perf_counter() - t_phase
    out = {"a_step_ms": {"mesh": a["mesh_step_ms"], "unsharded": a["plain_step_ms"]},
           "b_eager_step_ms": [b0["eager_step_ms"], b1["eager_step_ms"]],
           "a_wall_s": {"mesh": a["mesh_wall_s"], "unsharded": a["plain_wall_s"]},
           "b_wall_s": [b0["batched_wall_s"], b1["batched_wall_s"]],
           "image_rel_err": a["image_rel_err"], "lnz_rel_err": lnz_err,
           "ais_lnz": float(r0["ais_lnz"]), "wall_s": wall}
    log(f"mesh: phase {wall:.1f} s")
    return {"launches": total, "out": out,
            "kernel_checks": [b0["kernel_checks"], b1["kernel_checks"]]}


def run_phase(name, fn, *args, **kwargs):
    """Run one phase, then synchronize the card, so that an asynchronous
    CUDA error raised by the phase's launches names this phase before it
    propagates (a failed phase fails the run)."""
    import torch

    t0 = time.perf_counter()
    try:
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
    except BaseException as err:
        log(f"phase {name}: FAILED after {time.perf_counter() - t0:.1f} s: "
            f"{type(err).__name__}: {err}")
        raise
    log(f"phase {name}: done in {time.perf_counter() - t0:.1f} s, the card "
        "synchronized without a CUDA error")
    return out


def nuts_kernel_phase(shape=(128, 128), psf_shape=(64, 64), device=None):
    """The gradient path's four kernels at NUTS's batches alone, each against
    its plain version (:func:`grad_batch_check`): 8 chains of the flagship
    and the 16 rows of the general flagship's marginalized leaf (8 chains
    x 2 PSFs), at prior draws.  A short target for ``compute-sanitizer``:
    ``compute-sanitizer --tool memcheck python3 chip_smoke.py --only
    nuts-kernels``."""
    import torch

    from psfmc_tpu_torch.flagship import flagship_components, general_components, prior_draws
    from psfmc_tpu_torch.models import build_model_spec, build_posterior
    from psfmc_tpu_torch.optimize import psf_fan_out

    spec = build_model_spec(flagship_components(shape, psf_shape))
    post = build_posterior(spec, device=device, lnpost="batched")
    thetas = torch.as_tensor(prior_draws(spec, NUTS_CHAINS, seed=SEED + 9),
                             dtype=torch.float32, device=post.device)
    checks = [grad_batch_check(post, thetas, "nuts kernels", SEED + 7)]
    gspec = build_model_spec(general_components(shape, psf_shape))
    gpost = build_posterior(gspec, device=device)
    off = int(np.cumsum([0] + gspec.param_lens)[gspec.param_names.index("PSF_Index")])
    gthetas = torch.as_tensor(prior_draws(gspec, NUTS_CHAINS, seed=SEED + 10),
                              dtype=torch.float32, device=gpost.device)
    checks.append(grad_batch_check(gpost, psf_fan_out(gthetas, off, gspec.num_psfs),
                                   "nuts kernels, marginalized", SEED + 8))
    return {"nuts_kernel_checks": checks}


# the phases ``--only`` runs (after the build), each by its name
ONLY_PHASES = {"nuts": lambda: nuts_phase(), "criticism": lambda: criticism_phase(),
               "nuts-kernels": lambda: nuts_kernel_phase(),
               "batch": lambda: batch_phase(), "hierarchy": lambda: hierarchy_phase(),
               "cluster": lambda: cluster_phase(), "galfit": lambda: galfit_phase(),
               "fused_routes": lambda: fused_routes_phase(), "mesh": lambda: mesh_phase(),
               "global": lambda: global_phase()}


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

    if "--mesh-rank" in sys.argv[1:]:  # one rank of the mesh phase (mesh_launch)
        i = sys.argv.index("--mesh-rank")
        mode, rank, world, store, work, device = sys.argv[i + 1:i + 7]
        mesh_rank(mode, int(rank), int(world), store, work, device)
        return 0

    global CARD
    identity = CARD = card_identity()
    log(identity)  # name, power limit: exactly as nvidia-smi prints them
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    log(f"timing: each timed batch starts behind a spin of {SPIN_CYCLES} "
        f"cycles, {spin_ms():.3f} ms on this card")
    sfu_results_per_s()

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {len(_build.SOURCES)} kernels in {time.perf_counter() - t0:.2f} s")
    for name in _build.SOURCES:  # ptxas: each kernel, its registers and spills
        for line in _build.build_log(name).splitlines():
            if "Compiling entry function" in line or "registers" in line \
                    or "spill" in line:
                log(f"  {name}: {line.strip()}")

    if "--step-times" in sys.argv[1:]:
        times = step_times_phase()
        log(json.dumps({"step_times": times, "sass": sass_digests(),
                        "card": identity}))
        return 0
    if "--only" in sys.argv[1:]:  # e.g. --only nuts,nuts,nuts,criticism
        names = sys.argv[sys.argv.index("--only") + 1].split(",")
        unknown = set(names) - set(ONLY_PHASES)
        if unknown:
            raise SystemExit(f"chip_smoke: unknown phases {sorted(unknown)}; "
                             f"choose from {sorted(ONLY_PHASES)}")
        for i, name in enumerate(names):
            out = run_phase(f"{name} ({i + 1} of {len(names)})", ONLY_PHASES[name])
            log(json.dumps({"phase": name, "out": out, "card": identity}, default=str))
        return 0

    spec = build_model_spec(flagship_components())
    post = build_posterior(spec, lnpost="batched")
    rows = run_phase("kernel", kernel_phase, post, spec)
    launches, sampler = run_phase("slice", slice_phase, post, spec)
    driver_launches, mc, last = run_phase("driver", driver_phase)
    run_phase("graph", graph_phase, post, spec)
    pt_launches, pt_routes, tempered, pt_out = run_phase("tempered", tempered_phase,
                                                         post, spec)
    evid_out = run_phase("evidence", evidence_phase)
    general_launches, variant_launches, general = run_phase("general", general_phase)
    family_launches_, family_variant_launches, family = run_phase("family", family_phase)
    run_phase("prior family", prior_family_phase)
    priors_launches, api_launches, priors_variant_launches, priors, stress = \
        run_phase("priors", priors_phase)
    joint_launches_, joint_variant_launches, joint_on_path, joint = run_phase(
        "joint", joint_phase)
    grad = run_phase("map", map_phase)
    nuts = run_phase("nuts", nuts_phase)
    crit = run_phase("criticism", criticism_phase)
    batch = run_phase("batch", batch_phase)
    hier = run_phase("hierarchy", hierarchy_phase)
    cluster = run_phase("cluster", cluster_phase)
    galfit = run_phase("galfit", galfit_phase)
    fused_fits = run_phase("fused routes", fused_routes_phase)
    mesh = run_phase("mesh", mesh_phase)
    glob = run_phase("global", global_phase)
    rows += run_phase("backward rows", backward_rows, post, spec)
    rows += batch["rows"]
    rows += hier["rows"]
    from psfmc_tpu_torch.sampler import EnsembleSampler

    fused = EnsembleSampler(NWALKERS, spec.num_params, mc.posterior_fns,
                            seed=SEED)
    fused.init_state(last)
    fused.run_burn(3)
    steady_phase(fused, "driver path (lnpost='fused')")
    if "--profile" in sys.argv[1:]:
        profile_phase(sampler, "slice path (lnpost='batched')")
        profile_phase(tempered, f"tempered path ({PT_NTEMPS} rungs, lnpost='batched')")
        profile_phase(fused, "driver path (lnpost='fused')")
        profile_phase(general, "general path (lnpost='general')")
        profile_phase(family, "family path (lnpost='batched')")
        profile_phase(priors, "priors path (lnpost='batched')")
        profile_phase(stress, "priors stress variant (lnpost='batched')")
        profile_phase(joint, "joint path (bands 'batched', 'batched')")
        phase_clocks_phase(post, spec)
        render_geometry_phase(post, spec)
    # each kernel's launches on its own paths: the render on the slice path,
    # the general fit's sampling and the family fit's and variants', the
    # tiled render on the general and family variants that select it,
    # conv_lnl on the slice path and the family fit and variants, the fused
    # kernel on the driver path and the family's fused variant (128x128:
    # the FFT route; the matmul-DFT route is off the main path)
    # the priors fit's sampling, the API phase and the priors variants: the
    # render on all of them, conv_lnl on the fit and the stress variant, the
    # fused kernel on its variant; the joint fit's sampling and its variants:
    # the render on all of them (tiled on the tiled variant's general bands),
    # conv_lnl on the fit and the offset variant, band 0 on the FFT route's
    # radix-2 geometry, band 1 on its mixed-radix geometry (the fit's 96x96)
    # or on that geometry's radix-7 stages (the offset variant's 98x98)
    fam, fam_var = family_launches_, family_variant_launches
    pri, pri_var = priors_launches, priors_variant_launches
    jnt, jnt_var = joint_launches_, joint_variant_launches
    by_name = {"sersic_render": launches["render_sersics"]
               + general_launches["render_sersics"] + fam["render_sersics"]
               + fam_var["render_sersics"] + pri["render_sersics"]
               + api_launches["render_sersics"] + pri_var["render_sersics"],
               "sersic_render_tiled": launches["render_sersics_tiled"]
               + variant_launches["render_sersics_tiled"]
               + fam_var["render_sersics_tiled"],
               "conv_lnl": launches["batched_conv_lnl:fft"]
               + fam["batched_conv_lnl:fft"] + fam_var["batched_conv_lnl"]
               + pri["batched_conv_lnl:fft"] + pri_var["batched_conv_lnl"],
               "conv_lnl_mixed": jnt["batched_conv_lnl:fft:mixed"]
               + jnt_var["batched_conv_lnl:fft:mixed"],
               "conv_lnl_radix7": jnt["batched_conv_lnl:fft:radix7"]
               + jnt_var["batched_conv_lnl:fft:radix7"],
               "conv_lnl_cluster": launches["batched_conv_lnl:cluster"]
               + jnt["batched_conv_lnl:cluster"] + jnt_var["batched_conv_lnl:cluster"],
               "fused_lnl": driver_launches["fused_lnl:fft"] + fam_var["fused_lnl"],
               "fused_lnl_dft": driver_launches["fused_lnl:dft"]}
    by_name["fused_lnl"] += pri_var["fused_lnl"]
    # the tempered phase's fit (4 rungs: 500 walkers a launch) and the
    # evidence phase: the driver's tempered fit on the fused kernel, the two
    # anneals on the render and conv_lnl (256 walkers a launch)
    ais = evid_out["ais"].values()
    by_name["sersic_render"] += pt_launches["render_sersics"] + sum(
        a["launches"]["render_sersics"] for a in ais)
    by_name["conv_lnl"] += pt_routes["batched_conv_lnl:fft"] + sum(
        a["launches"]["batched_conv_lnl:fft"] for a in ais)
    by_name["fused_lnl"] += evid_out["fit_launches"]["fused_lnl:fft"]
    by_name["sersic_render"] += jnt["render_sersics"] + jnt_var["render_sersics"]
    by_name["sersic_render_tiled"] += jnt_var["render_sersics_tiled"]
    by_name["conv_lnl"] += (jnt["batched_conv_lnl:fft"] + jnt_var["batched_conv_lnl:fft"]
                            - by_name["conv_lnl_mixed"] - by_name["conv_lnl_radix7"])
    # the gradient path (phase 14): model_galaxy_map, the init="map" fit and
    # the three joint MAPs, each kernel and backward kernel on its route
    # and, on the FFT routes, its geometry (a route's launches less those
    # it counted at mixed-radix shapes, with or without radix-7 stages).
    # Every forward under autograd on the FFT route is the residual
    # instantiation and has its backward there, at its shape
    grads = [grad[k] for k in ("map", "init", "joint", "joint_radix7", "joint_padded",
                               "joint_cluster")]
    # the NUTS phase (15): the fitting driver's fit and its resumed call, every leaf
    # on the render, conv_lnl's residual forward and both backward kernels;
    # the general flagship's marginalized run on the render and its backward
    grads += [nuts[k] for k in ("nuts_fit", "nuts_resume", "nuts_marginal")]
    # the cluster phase (19): the 256x256 MAP on the cluster route
    grads.append(cluster["map"])
    for g in grads:
        for geo in ("",) + tuple(f":{m}" for m in MIXED_GEOMETRIES):
            if g[f"batched_conv_lnl:fft_res{geo}"] != g[f"batched_conv_lnl_backward:fft{geo}"]:
                raise AssertionError(f"residual forwards and FFT-route backwards differ: {g}")
        for route in ("padded", "cluster"):
            if g[f"batched_conv_lnl:{route}_res"] != g[f"batched_conv_lnl_backward:{route}"]:
                raise AssertionError(f"residual forwards and {route}-route backwards "
                                     f"differ: {g}")
    by_name["sersic_render"] += sum(g["render_sersics"] for g in grads)
    by_name["sersic_render_backward"] = sum(g["render_sersics_backward"] for g in grads)
    for fn, route, row in (("batched_conv_lnl", "fft_res", "conv_lnl_res"),
                           ("batched_conv_lnl", "fft", "conv_lnl"),
                           ("batched_conv_lnl_backward", "fft", "conv_lnl_backward")):
        by_name[row] = by_name.get(row, 0) + sum(g[f"{fn}:{route}"] for g in grads)
        for geo in MIXED_GEOMETRIES:
            n = sum(g[f"{fn}:{route}:{geo}"] for g in grads)
            by_name[row] -= n
            by_name[f"{row}_{geo}"] = by_name.get(f"{row}_{geo}", 0) + n
    # the padded and the cluster route: the 74x74 and 94x94 joint MAPs' and
    # the 256x256 MAP's pools (the forward without residuals), their steps'
    # residual forwards and backwards
    for fn, route, row in (("batched_conv_lnl", "padded", "conv_lnl_padded"),
                           ("batched_conv_lnl", "padded_res", "conv_lnl_res_padded"),
                           ("batched_conv_lnl_backward", "padded",
                            "conv_lnl_backward_padded"),
                           ("batched_conv_lnl", "cluster", "conv_lnl_cluster"),
                           ("batched_conv_lnl", "cluster_res", "conv_lnl_res_cluster"),
                           ("batched_conv_lnl_backward", "cluster",
                            "conv_lnl_backward_cluster")):
        by_name[row] = by_name.get(row, 0) + sum(g[f"{fn}:{route}"] for g in grads)
    # the cluster phase's 256x256 driver fit: the render and conv_lnl
    by_name["sersic_render"] += cluster["driver"]["render_sersics"]
    by_name["conv_lnl_cluster"] += cluster["driver"]["batched_conv_lnl:cluster"]
    # the fused routes phase (21): the fused kernel's 256x256 fit on its
    # cluster route (4 blocks) and its 96x96 fit on the mixed-radix geometry
    big, mixed = (f"{a}x{b}" for (a, b), _ in FUSED_FITS)
    by_name["fused_lnl_cluster4"] = fused_fits[big]["fused_lnl:cluster"]
    by_name["fused_lnl_mixed"] = fused_fits[mixed]["fused_lnl:fft"]
    for row in ("fused_lnl_radix7", "fused_lnl_padded", "fused_lnl_cluster"):
        by_name[row] = 0  # on no fitted path
    # the criticism phase (16): the fused flagship fit and the joint fit with
    # criticism=True, whole calls (sampling, image writer, criticism block)
    for kind in ("single", "joint"):
        c = crit[kind]["call_launches"]
        geo = {g: c[f"batched_conv_lnl:fft:{g}"] for g in MIXED_GEOMETRIES}
        by_name["sersic_render"] += c["render_sersics"]
        by_name["sersic_render_tiled"] += c["render_sersics_tiled"]
        by_name["fused_lnl"] += c["fused_lnl:fft"]
        by_name["fused_lnl_dft"] += c["fused_lnl:dft"]
        by_name["conv_lnl"] += c["batched_conv_lnl:fft"] - sum(geo.values())
        by_name["conv_lnl_mixed"] += geo["mixed"]
        by_name["conv_lnl_radix7"] += geo["radix7"]
        by_name["conv_lnl_cluster"] += c["batched_conv_lnl:cluster"]
    crit_checks = {k: crit[k]["kernel_checks"] for k in ("single", "joint")}
    # the batch phase (17): the render on every batch fit, conv_lnl with
    # per-target planes on each route and with per-target spectra (the
    # phase counts each row's launches on its own fits)
    by_name["sersic_render"] += batch["render_launches"]
    by_name.update({r["name"]: r["launches"] for r in batch["rows"]})
    # the hierarchy phase (18): the render and its backward on every
    # hierarchical fit and replay, conv_lnl's residual forward and backward
    # with the target axis on each route (each row's launches on its fits)
    by_name["sersic_render"] += hier["render_launches"]["render_sersics"]
    by_name["sersic_render_backward"] += hier["render_launches"]["render_sersics_backward"]
    by_name.update({r["name"]: r["launches"] for r in hier["rows"]})
    # the GALFIT phase (20): quick_fit's MAP (the gradient path), the MCMC fit
    # of the imported model (whole call) and summary --criticism's replays,
    # every conv_lnl launch on the FFT route's radix-2 geometry at 128x128
    g_map, g_fit, g_sum = galfit["map"], galfit["mcmc"], galfit["summary"]
    by_name["sersic_render"] += (g_map["render_sersics"] + g_fit["render_sersics"]
                                 + g_sum["render_sersics"])
    by_name["sersic_render_backward"] += g_map["render_sersics_backward"]
    by_name["conv_lnl"] += (g_map["batched_conv_lnl:fft"] + g_fit["batched_conv_lnl:fft"]
                            + g_sum["batched_conv_lnl:fft"])
    by_name["conv_lnl_res"] += g_map["batched_conv_lnl:fft_res"]
    by_name["conv_lnl_backward"] += g_map["batched_conv_lnl_backward:fft"]
    # the mesh phase (23): every rank's runs, the flagship at 128x128 (the FFT
    # route's radix-2 geometry): the driver fits (batched and fused), NUTS, the
    # anneal, the batch fit and the hierarchical fits (per-target planes)
    m = mesh["launches"]
    for row, key in (("sersic_render", "render_sersics"),
                     ("sersic_render_backward", "render_sersics_backward"),
                     ("conv_lnl", "batched_conv_lnl:fft"),
                     ("conv_lnl_res", "batched_conv_lnl:fft_res"),
                     ("conv_lnl_backward", "batched_conv_lnl_backward:fft"),
                     ("fused_lnl", "fused_lnl:fft"),
                     ("conv_lnl_targets", "batched_conv_lnl:fft_targets"),
                     ("conv_lnl_res_targets", "batched_conv_lnl:fft_res_targets"),
                     ("conv_lnl_backward_targets", "batched_conv_lnl_backward:fft_targets")):
        by_name[row] = by_name.get(row, 0) + m.get(key, 0)
    # the global phase (24): the 512x512 fits (batched, fused) and MAP and the
    # 251x251 survey batch, every conv_lnl and fused launch on the global route
    by_name["sersic_render"] += glob["render_launches"]
    by_name["sersic_render_backward"] += glob["render_backward_launches"]
    rows += glob["rows"]
    by_name.update({r["name"]: r["launches"] for r in glob["rows"]})
    for r in rows:
        r["launches"] = by_name[r["name"]]
        if r["name"] in ("sersic_render", "conv_lnl", "fused_lnl"):  # at the ranks' batches
            r["mesh_checks"] = mesh["kernel_checks"]
        if r["name"] in ("sersic_render", "fused_lnl", "conv_lnl", "conv_lnl_mixed"):
            r["criticism_checks"] = crit_checks  # at the criticism's batches
        if r["name"] == "conv_lnl_mixed":  # timed on the joint fit's band 1 too
            r.update(joint_on_path)
        if r["name"] in ("sersic_render", "conv_lnl"):  # at the tempered batches
            r["tempered_checks"] = pt_out["kernel_checks"]
        if r["name"] in ("sersic_render", "sersic_render_backward", "conv_lnl",
                         "conv_lnl_res", "conv_lnl_backward"):  # at NUTS's batches
            r["nuts_checks"] = nuts["nuts_kernel_checks"]
        if r["name"] == "sersic_render" or r["name"].startswith("conv_lnl_targets"):
            r["batch_checks"] = batch["kernel_checks"]  # at the batch fits' batches
        if r["name"] in ("sersic_render", "sersic_render_backward", "conv_lnl",
                         "conv_lnl_res", "conv_lnl_backward"):  # at the GALFIT path's
            r["galfit_checks"] = galfit["kernel_checks"]
        kind = {"conv_lnl_cluster": "forward", "conv_lnl_res_cluster": "residual",
                "conv_lnl_backward_cluster": "backward"}.get(r["name"])
        if kind:  # the route's other shapes (cluster_phase)
            r["by_shape"] = {k: {f: x for f, x in v[kind].items()
                                 if f not in ("name", "route", "source", "replaces",
                                              "launches")}
                             for k, v in cluster["times"].items()}
    for r in rows:
        if (r["name"].startswith("conv_lnl") or r["name"] in (
                "fused_lnl", "fused_lnl_mixed", "fused_lnl_cluster4",
                "fused_lnl_global")) and not r["launches"]:
            raise AssertionError(f"{r['name']} was never launched on the main path")
    for r in rows:
        for k, v in r.items():
            if isinstance(v, float) and not math.isfinite(v):
                raise AssertionError(f"{r['name']}.{k} is not finite")
    log(json.dumps({"tempered": {k: pt_out[k] for k in ("step_ms", "step8_ms",
                                                        "swap_acceptance", "ladder",
                                                        "evidence_8")},
                    "evidence": {k: evid_out[k] for k in ("fit", "ln_bayes")},
                    "ais": {k: {f: v[f] for f in ("lnz", "err", "wall_s")}
                            for k, v in evid_out["ais"].items()},
                    "card": identity}))
    log(json.dumps({"nuts": {k: v for k, v in nuts.items()
                             if k not in ("nuts_fit", "nuts_resume", "nuts_marginal",
                                          "nuts_kernel_checks")},
                    "card": identity}))
    log(json.dumps({"criticism": {k: {f: v for f, v in crit[k].items()
                                      if f != "kernel_checks"}
                                  for k in ("single", "joint")},
                    "card": identity}, default=float))
    log(json.dumps({"batch": batch["out"], "card": identity}, default=float))
    log(json.dumps({"hierarchy": hier["out"], "checks": hier["kernel_checks"],
                    "card": identity}, default=float))
    log(json.dumps({"cluster": {k: cluster[k] for k in ("driver", "adam_step_ms",
                                                        "map_lnpost_rel_err", "wall_s")},
                    "card": identity}, default=float))
    log(json.dumps({"galfit": {k: galfit[k] for k in (
        "import", "seconds", "map_lnpost", "map_lnpost_rel_err", "mcmc_lnpost_rel_err",
        "mcmc_acceptance", "roundtrip_max_err", "subprocess_rc")}, "card": identity},
        default=float))
    log(json.dumps({"fused_routes": {
        "fits": {k: {f: v[f] for f in ("fused_lnl", "fused_lnl:cluster", "fused_lnl:fft",
                                       "fused_lnl:dft", "lnpost_rel_err", "retain_step_ms")}
                 for k, v in fused_fits.items() if k != "wall_s"},
        "batched_256_retain_step_ms": cluster["driver"]["retain_step_ms"],
        "wall_s": fused_fits["wall_s"]}, "card": identity}, default=float))
    log(f"fused routes: the 256x256 flagship's replayed retained step "
        f"{fused_fits[big]['retain_step_ms']:.3f} ms on the fused path, "
        f"{cluster['driver']['retain_step_ms']:.3f} ms on the batched path ({CARD})")
    log(json.dumps({"mesh": mesh["out"], "card": identity}, default=float))
    log(json.dumps({"global": {
        "fits": {k: {f: v[f] for f in v if f.startswith(("batched_conv_lnl", "fused_lnl",
                                                         "lnpost", "retain"))}
                 for k, v in (("batched", glob["driver"]), ("fused", glob["fused_driver"]))},
        "map": {k: glob[k] for k in ("adam_step_ms", "map_lnpost_rel_err", "map_wall_s")
                if k in glob},
        "survey": glob["survey"], "survey_check": glob["survey_check"],
        "wall_s": glob["wall_s"]}, "card": identity}, default=float))
    log(f"global: the 512x512 flagship's replayed retained step "
        f"{glob['driver']['retain_step_ms']:.3f} ms on the batched path, "
        f"{glob['fused_driver']['retain_step_ms']:.3f} ms on the fused path ({CARD})")
    log(json.dumps({"kernels": rows, "card": identity}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
