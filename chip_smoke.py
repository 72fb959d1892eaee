"""Drive the PyTorch/CUDA port (nfmc_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
  1. facts: torch/CUDA versions, the card and its power limit, nvcc, triton;
  2. build the kernels from nfmc_torch/csrc/ with nvcc (the RealNVP coupling
     forward and backward, the spline coupling forward and backward, and
     graph_cond.cu, the CUDA graph conditional nodes), one process per
     source, all at once;
  2b. the conditional nodes (core/graphs.py's when and loop: IF and WHILE
     nodes) in one captured iteration replayed with predicates that change
     between replays, nested, with counted launches and an autograd pass
     inside, against the same body run eagerly: counters, state and launch
     counts exactly; the capture's wall and memory, 64 leapfrogs unrolled
     against a loop of them;
  3. forward kernel vs its plain PyTorch version, both directions, at the
     sampler's shapes (d=100, H=128, L=4 at B=100 and B=218,400; IMH's
     hoisted chunks B=100, 400, ..., 102,400 and, at the chunk cap,
     B=313,500;
     variational_fit's B=128 and AdaptiveIMH's refit batch B=64; jump_hmc's
     and DLMC's B=1024, DLMC's refit validation B=308 and TESS's B=30;
     jump_hmc's hoisted B=51,200 and the misfit's B=12,800), the
     flow fit's (B=256 training batches, B=3000 validation, and B=512) and a
     ragged odd shape (d=7, B=37): max |diff| <= 1e-4, with timings (CUDA
     events around the wrapper, and the kernel's own device time from
     torch.profiler);
  3b. backward kernel vs its plain version, both directions, at B=512, 256,
     128 (variational_fit's batch, in the inverse direction), 100 (NeuTra's
     input gradient), 64 (AdaptiveIMH's refit batch), 1024 (DLMC's drift),
     the ragged shape and B=1001 (many blocks, a partial last one):
     max |diff| <= 1e-4 * max(1, max |ref|); two launches bit-identical; at
     B=256 forward and B=100 inverse the device time of its two kernels
     (rows, weight gradients) and the weight-gradient kernel's share;
  3c. RealNVP at d=3000 and 3500, H=128 (the kernels' ring of 2 stages):
     forward, inverse and VJP against the plain version;
  4. the same three outer iterations with the same injected draws through
     the sampler's chunk runner on the card and on the CPU: they agree;
  4b. the same Flow.fit on the card and on the CPU: per-epoch validation
     losses and final weights agree to 1e-4;
  5. the main path through the front door: jump_mala, RealNVP (4 layers,
     hidden 128), 100 chains on a 100-d standard Gaussian, 2184 outer
     iterations of 5 MALA steps, with the kernel launch counts it made and
     its ESS/s (mean ESS over the dims of the 13,104 stored draws, on the
     card, max_window 16384, over the wall);
  5b. the same with warmup=True and 500 outer iterations: MALA tuning, the
     flow's MLE fit (every Adam step through the backward kernel), the
     reshuffle of warmup draws into x0; jump acceptance in [0.010, 0.035],
     MALA acceptance in [0.55, 0.72], the counter and launch laws; ms per
     Adam step (the fit's wall over its steps);
  5c. fit_nf=True at 10 outer iterations, on the fixed-effort route (each
     outer iteration a replay of one captured graph, its refit an IF node)
     and on the host route: the interleaving law, the counters, a trained
     flow;
  6. the misfit target N(0.12 * 1, I): jump acceptance in [0.30, 0.50];
  7. the spline forward kernel (RQS and LRS, both directions) vs its plain
     version at d=100, H=128, L=4, K=8 with B=100, 256, 3000 and 50,000, and
     a ragged (d=7, H=16, L=3, K=4, B=37), inputs 3 N(0, 1) so that the
     tails are hit: max |diff| <= 1e-4 * max(1, max |ref|), with timings;
  7b. the spline backward kernel vs the autograd VJP of the plain version,
     both kinds and directions, at B=256, 100, 1001, 3000 and the ragged
     shape: within SPLINE_BWD_TOL * max(1, max |ref|), two launches
     bit-identical. Where the VJP misses the gate, the rows with an element
     within float32 drift of a branch point of its spline (where the VJP
     jumps, so float32 may take the other bin) are left out by zeroing
     their cotangents in a rerun, and every row off the gate must be one
     of them (ops.spline.compare_spline_vjp); each is printed with its
     witness;
  7c. Flow.fit of each spline flow on the card and on the CPU (as 4b);
  7d. both spline kinds at d=784 (B=300) and d=1024 (B=40), H=128, L=4,
     K=8: forward, inverse and VJP against the plain version (the VJP's in
     float64, under 7b's rule), then a stack above the width limit refused
     with its bytes;
  8. the slice's path through the front door, per spline kind: jump_mala
     with c-rqnsf / c-lrsnsf (4 layers, hidden 128, 8 bins), warmup=True,
     500 outer iterations: the counter and launch laws, moments, MALA
     acceptance, the fitted flow's training NLL below the identity's (it is
     above it on the validation rows: the fit overfits), jump acceptance
     <= 0.01;
  8b. a frozen identity-init spline flow against N(0.12 * 1, I), 250
     outer iterations: jump acceptance in [0.30, 0.50], one forward launch
     per jump;
  8c. self-target: a frozen perturbed spline flow is the proposal and the
     target (U = -log q): jump acceptance >= 0.99, MALA acceptance in
     SELF_MALA_ACC, backward launches = the sampler's gradient passes;
  9. the repaired faults: a strided input (a column slice) gives the
     contiguous rows' log_prob; a flow with 3 hidden layers a conditioner
     runs with no kernel launch, one with 2 launches; MCMCStatistics folds
     CUDA draws through its data_transform;
  10. IMH, the default strategy, through the front door: 100 chains on a
     100-d standard Gaussian, 8000 iterations, the RealNVP frozen at its
     identity init: acceptance >= 0.999, moments as phase 5, the counters
     (2 C target calls an iteration, no gradient call), one forward launch
     and one inverse launch a chunk; its ESS/s (max_window 4096) and its
     device busy share over 1000 iterations (torch.profiler);
  10a. the same frozen flow against N(0.12 * 1, I): acceptance in [0.30,
     0.50] (analytic 2 Phi(-|mu| / sqrt 2) = 0.396);
  10b. IMH with warmup=True on DiagonalGaussian1(100): the reverse-KL fit
     (one backward launch, in the inverse direction, an epoch), then 4000
     iterations: acceptance in IMH_WARM_ACC and above the identity flow's,
     the moments within IMH_WARM_MOMENTS (medians over the dims, and the
     extremes of the variance ratio, so that a collapsed dim fails), the
     inverse and backward launches at B=128 one an epoch;
  10c. adaptive_imh through the front door on the same target (100
     iterations, the reference's quirk; its fused chunk replays one
     captured graph): the gradient-call counter quirk, the draws, backward
     launches at B=64 = the refits' Adam steps; the same call in the eager
     loop draws the same numbers and records its refits' inputs; its
     first and last refits replayed on the card and run on the CPU from the
     same weights and rows: the gradient agrees to 1e-4 max|g|, and every
     weight more than 1e-4 apart has a gradient within float32 error of 0,
     apart by what Adam's first step makes of it (check_refit); then 5
     fused iterations with
     the same injected draws, schedule and refit shuffles on the card and
     on the CPU (d=6, as 4b): states, flow log-probs and refit weights
     agree to 1e-4;
  10d. self-target IMH: a frozen perturbed flow (RealNVP, c-rqnsf,
     c-lrsnsf) is the proposal and the target (U = -log q): acceptance
     >= 0.99;
  10e. variational_fit on the card and on the CPU, 20 epochs with the same
     injected base draws and weights (d=6, as 4b): per-epoch losses and the
     final weights agree to 1e-4.
  11. neutra_hmc through the front door (bench.py's north-star cell): 100
     chains on a 100-d standard Gaussian, the identity-init RealNVP frozen,
     HMC step 0.1 with 20 leapfrog steps, 250 iterations: acceptance and
     data-space moments in bands from the JAX package's CPU runs
     (scripts/flow_samplers_reference_cpu.py), the counters (2 L B
     gradient calls), the launch law (an iteration: 21 gradient passes, each
     one inverse and one inverse-direction VJP at B=100, and the data
     transform's inverse); its ESS/s (max_window 4096, of the data-space
     draws), it/s and device busy share;
  11a. neutra_mh on Funnel(100) with warmup=True (the reverse-KL fit capped
     at NEUTRA_MH_FIT_EPOCHS), the random walk's scale 2.38 / sqrt(d), 1000
     iterations: acceptance in a JAX band, finite data-space moments, the
     counters and the launch law;
  11b. self-target neutra_hmc: a frozen perturbed RealNVP, c-rqnsf and
     c-lrsnsf, each its own target (U = -log q, so U~ is N(0, I) in the
     latent space): acceptance >= 0.99, the latent medians over the dims of
     |mean| and |var - 1| within bounds from the JAX package's CPU runs, the
     launch law (both directions of the kernel and of its VJP at B=100);
  11c. tess (bench.py:641-643): 100 chains, the identity-init flow, 1000
     iterations: acceptance exactly 1 (the flow's base is the target), the
     counters ((5 + 1) B target calls), moments, the launch law, ESS/s; then
     20 warmup iterations with fixed-effort refits (10 epochs), each a
     replay of one captured iteration: counters, launches, finite refit
     weights that moved;
  11d. jump_hmc (bench.py:682-722): 1024 chains, 5 inner HMC iterations,
     50 outer iterations: the interleaving law, counters, moments, one
     hoisted chunk of 51,200 proposals and one forward at B=1024 a jump;
     leapfrog gradients/s and outer it/s;
  11e. dlmc (bench.py:726-743): 1024 chains, DLMC_ITERS iterations with
     fixed-effort refits (10 epochs of 11 Adam steps at B=64), each
     iteration a replay of one captured graph (the epochs a WHILE node): the
     counter contract, the moment error in a JAX band, the launch law; it/s;
  11f. card against CPU with the same injected draws and weights: one
     NeuTraHMC iteration at d=100 through a perturbed flow (the gradient of
     U~ within 1e-4 max|g|, the end states within 1e-4), one tess_step,
     DLMC's first refit (its first Adam step by check_adam_step's witness
     rule, the whole refit replayed on the card) and one drift + accept from
     its weights (masks apart only within 1e-3 of their threshold).
  12. nuts through the front door (bench.py's nuts_1024): 1024 chains on a
     100-d standard Gaussian, max_tree_depth 10, warmup=True (85 dual-
     averaging iterations), 100 iterations: acceptance, the tuned step size
     and the moment error in bands from the JAX package's CPU runs
     (scripts/mcmc_reference_cpu.py), the counter law (the statistics'
     calls = gradient calls = what the steps reported: the sum of their
     leapfrogs and one evaluation a chain each), the mean and maximum tree
     depth, it/s, gradients/s, ESS/s and the device busy share; NUTS, ChEES
     and their jump and NeuTra forms (12-12d) replay graphs whose
     trajectories are conditional nodes, each front-door call capturing
     anew;
  12a. chees_hmc (bench.py:891-936): 1024 chains on DiagonalGaussian1(100),
     341 warmup and 1000 iterations, store_samples=False: the tuned
     trajectory length and step size, leapfrogs an iteration, acceptance and
     max |mean| / sigma in JAX bands; 2 L C + 2 C calls and 2 L C gradients
     against the steps' reports;
  12b. ess (bench.py:1686-1691's target: sigma linspace(0.4, 0.9, 5), the
     residual likelihood) at 100 chains with warmup=True: the moments in JAX
     bands, (5 + 1) C calls an iteration, and the warmup's corrected
     likelihood on the card against float64 (and a dense ellipse at d=100);
  12c. jump_ess, jump_nuts and jump_chees (100 chains, d=100, the identity
     RealNVP frozen, 5 inner iterations, 64 outer, target N(0.12 * 1, I)):
     the interleaving law, the counters (static plus dynamic) against the
     inner steps' reports, jump acceptance in JAX bands, one prior redraw an
     outer iteration for jump_ess, one hoisted inverse and a forward a jump;
  12d. neutra_chees (as phase 11): ChEES's warmup (the reverse-KL fit at 0
     epochs keeps the flow at its identity init) and 1000 iterations:
     acceptance in a JAX band, the moments, the launch law from the run's
     leapfrog counts L_i (an inverse and an inverse VJP at B=100 a gradient
     pass, L_i + 1 an iteration, and the data transform's inverse), ESS/s;
  12e. card against CPU with the same injected draws: a NUTS step at
     1024 x 100 (float64: every leapfrog count, mask and state equal; float32:
     the chains that agree to 1e-5, at most 1% parted by rounding), a ChEES
     tuning and sampling step (L equal, states to 1e-4), an ESS step with a
     dense ellipse (to 1e-5, masks equal) and NeuTra-ChEES's gradient of U~
     (to 1e-4 max |g|);
  12f. ESS's two-sample test (chain permutation, alpha 0.01) of 32 chains x
     600 iterations on the card against the JAX package's draws
     (ESS_DRAWS);
  13. dense_metric (bench.py:1310-1437, its near-isotropic runs cut): hmc,
     dense_hmc, mala and dense_mala on the condition-1e3 correlated target,
     dense_hmc and dense_mala on N(0, I); d=100, 100 chains, 341 warmup and
     250 iterations (the bench's 1000 cut): the mean and worst
     eigen-direction ESS (and per
     second), max |mean| / sigma and the final scalar-mode flag in JAX
     bands, the wall-free worst-direction ratios dense / diagonal > 2;
  13a. pt_multimodal (bench.py:1231-1307): pt_mala, pt_mh, pt_hmc and mala
     on two modes at +-2 in 10-d, 64 chains started in mode 0, 500
     iterations (the bench's 2000 cut), 8 rungs to beta 0.02: the bench's
     criterion (pt_mala's
     balance error < 0.15, mala's > 0.4), balance errors, swap rates and
     acceptances in JAX bands, the counter laws, it/s, ESS/s, and the
     device busy share of 20 pt_mala iterations;
  13b. aies at 1024 walkers on 13's correlated target (341 + 1000 it): the
     tuned stretch scale, acceptance and moment errors in JAX bands;
  13c. jump_aies in 12c's setting: jump and inner acceptance in JAX bands,
     the interleaving and counter laws, one hoisted inverse at B=6400 and a
     forward at B=100 a jump;
  13d. card against CPU with the same injected draws: a DenseHMC and a
     DenseMALA step at 100 x 100 (to 1e-5, masks equal), the dense refresh
     from fixed halves, dense and scalar (chol and chol_inv to 1e-4 of
     max |ref|, the mode equal), two tuning ladder steps of PT-MALA, PT-MH
     (to 1e-5) and PT-HMC (to 1e-4) with equal swaps, and an AIES step at
     1024 x 100 (to 1e-5, masks equal).
  14. the flows without a kernel (phase 14 owns its launch counts: each
     of the four kernels must launch 0 times for these flows), at d=100 and
     each flow's default widths, weights moved ZOO_PERTURB N(0, 1) from
     the init (zoo_weights): 14a each of the 22 canonical names (nice,
     maf, iaf, the masked splines, the nine NAF flows, the six residual
     flows), forward and inverse at B=100 on the card against the CPU (run
     in worker processes beside the card) within the stated tolerances,
     the round trip, each direction's ms once the workers have ended,
     after a discarded first call (a masked NAF flow's sequential direction
     on its first call); 14b self-target IMH (the frozen
     flow as proposal and target, 100 chains, 21 iterations; the masked
     NAF flows 1, at 1 layer): acceptance >= 1 - max(0.01, 1.5 times the JAX package's
     highest rejection rate); 14c IMH with warmup=True through IAF on
     DiagonalGaussian1(100), 1000 iterations: acceptance above the
     identity IAF's and in a JAX band, the moments in JAX bands, ESS/s,
     it/s and ms an Adam step; 14d jump_mala with the identity-init NICE
     frozen on N(0.12 * 1, I): jump acceptance in [0.30, 0.50]; 14e the
     repaired faults on the card (sample() with mesh / checkpoint_* None,
     fused_unroll_outer=4, sample_continue, Flow.sample(3, True)).
  15. the continuous, multiscale / Glow and convolutional flows (phase 15
     owns its launch counts: the four kernels must launch 0 times for these
     23 flows), at each flow's default widths, weights moved LAST_PERTURB
     N(0, 1) from the init (last_weights): 15a each case of LAST_CASES (the
     four continuous flows at d=100 on Hutchinson's trace, FFJORD at d=32
     on the exact path, the 19 image flows on (8, 8), conv-FFJORD on
     (16, 16) on Hutchinson's), forward and inverse at B=100 on the card
     against the CPU (worker processes beside the card) with the same
     probes (FixedProbes), within each case's limit from its float32 drift
     (LAST_DRIFT), under torch's default backend flags (cuDNN TF32 on: the
     port's convolutions are shifted views and a matmul, full float32), the
     production probes equal on both devices and the production path
     finite; 15b examples/06_applied_targets.py's phi^4 run with
     glow-realnvp through jump_hmc (32 chains, 50 outer iterations,
     warmup, its fit 25 epochs): mean |m| and jump acceptance in JAX bands;
     15c IMH with RNODE's reverse-KL warmup (the kinetic term in, 50 epochs)
     on DiagonalGaussian1(100), 1000 iterations: acceptance and moments in
     JAX bands, the kinetic term nonzero; 15d one IMH iteration through
     sample() for each of the registry's 48 names ((8, 8) images, d=100
     vectors, the masked NAF flows 1 layer): finite draws of the right shape.
  16. the headline (jump_mala, RealNVP 4 x 128, the coupling kernels) with
     checkpoint_path, 100 outer iterations in 5 segments of 20: a run that
     dies after 2 segments and resumes equals the uninterrupted segmented
     run bit for bit (stored draws, counters, moments, kernel state, flow
     weights), and no file is left after success; the same for
     adaptive_imh (its refits through the backward kernel, its schedule in
     the extra-state hook).
  17. the transport layer and FAB (nfmc_torch.transport, flow_training) on
     bench.py's transport_logz easy target (d=16, N(0, I) prior, target
     N(2 * 1, 0.25 I), RealNVP L=2 H=32): 17a each step on the card against
     the CPU with the same weights and injected draws (the MALA sweep, an
     8-level AIS chain, one AFT level with its 60-epoch fit, one CRAFT
     training level, PMC's train scan and a pCN sweep, one FAB iteration's
     AIS round and 20 replay steps, SNF's loss and its gradient through the
     HMC layers), to TOL * max(1, max|ref|), rows that rounding parted at an
     accept or resample boundary at most 1%, fitted weights apart only with
     an RMS gradient within float32 error of 0; 17b run_transport_logz's easy
     suite at bench.py's sizes (AIS 4096 x 128 levels, AFT, CRAFT, PMC at
     2048 particles, FAB 300 iterations then its 4096-draw estimate): each
     |log Z error| < 1 nat and in a JAX band, FAB's 2-SE band covering the
     truth, walls, launches by shape and weight repacks, the busy share of
     one AFT level and one FAB iteration; 17c snf() at its defaults and ns()
     at d=3 (64 live points, 400 iterations) in JAX bands; then every
     RealNVP shape the phase launched (d, H, L, B) against the plain version.
  18. profiling and the mesh (nfmc_torch.profiling, nfmc_torch.parallel),
     run right after the build (2), before phase 3:
     18a the headline for 20 outer iterations under profiling.trace, inside
     annotate("jump"): the written *.pt.trace.json holds the coupling
     kernel's forward and inverse launches as device events and the span,
     and the ten device ops that took most time, with their shares; 18b
     chain_mesh() over the card (a one-rank NCCL group on a FileStore): the
     headline for 100 outer iterations through sample(..., mesh=mesh) is
     bit-identical to the run without the mesh (draws, counters, moments,
     launch counts), and Flow.fit(mesh=mesh) (4096 rows, 3 epochs) ends at
     the same weights as Flow.fit; the group is destroyed after.
  19. chains and particles sharded over several ranks: 19a each strategy
     declared for several ranks after phase 18 (ula, uhmc, mh, nuts, ess,
     adaptive_imh, neutra_mh, neutra_chees and the eight other jump_*)
     through sample(..., mesh=chain_mesh()) on a one-rank NCCL group and
     without it, at full width (nuts and jump_hmc at 1024 chains) with
     warmup=True and the depth cut, bit for bit (draws, moments, counters,
     adapted state, launch counts); AFT and PMC at phase 17's sizes (depth
     cut) with their particles drawn sharded on that mesh, bit for bit;
     19b two processes on the one card (spawned before phase 17, they set
     themselves up beside phases 17-19a and wait for a go), each a rank of
     a gloo group whose collectives run on the host
     (chain_mesh(device_type="cpu")): nuts (each
     rank breaks its own trees), adaptive_imh (each refit through the VJP
     kernel on every rank's chains, gathered), jump_hmc with fit_nf=True
     (its refits likewise) and AFT (resampling across the ranks), held
     against the same runs unsharded on
     the card: draws and means to 1e-5 with equal counters, AFT's log Z to
     1e-3 with its fits off and within 0.75 with them on; each rank's wall,
     collective time and launches by shape; a rank that fails or hangs
     fails the script; then every RealNVP shape the phase launched that
     phases 3, 3b and 17 did not hold, against the plain version.
  20. chunks as CUDA graph replays (nfmc_torch.core.graphs): each captured
     path through the front door from one seed with graphs and under
     disable_graphs() in this process (the headline 64 outer iterations
     pipelined, under a time limit that never stops it, and on a one-rank
     NCCL chain_mesh(); MALA, HMC and MH 50 tuning and 250 sampling
     iterations on DiagonalGaussian1(100); IMH 1000 iterations with
     RealNVP and 200 with c-rqnsf; TESS 200; NeuTra-HMC 50), bit for bit:
     stored draws, counters, moments, the kernel's final state and each
     wrapper's launch count; each path's wall both ways, and, in a
     torch.profiler window of each, its kernel and graph launches an
     iteration (the host's runtime calls) and the device's busy share, and
     the graph cache's memory after the run. Every earlier phase runs its
     declared paths with graphs (the launch laws count a replay's launches).
     Also NUTS (phase 12's width and depth, 50 tuning iterations
     from the JAX-tuned step and 100), ChEES and NeuTra-ChEES (12a's and
     12d's, 50 + 250), jump_chees (12c's, 64 outer) and jump_nuts (16
     outer), with each capture's wall and pool memory. And the refitting
     chunks, each refit inside its iteration's graph (an IF node where a
     gate row decides it, its epochs a WHILE node): DLMC (11e's 1024
     chains, GRAPH_DLMC_ITERS iterations), adaptive_imh (10c's), TESS's
     fused warmup (11c's) and jump_mala with fixed-effort fit_nf (5c's),
     with RealNVP and with c-rqnsf.
  21. the flow fits as CUDA graph replays (nfmc_torch.flows.train): the
     headline's warmup fit on phase 5b's own data (4096 rows at batch 256,
     3000 validation rows, early stopping), IMH's reverse-KL warmup fit at
     phase 10b's size, FIT21_IMH_REFITS of AdaptiveIMH's refits through its
     make_scan_fit closure (10c's size), three of DLMC's through one at 11e's
     size and a 20-epoch fit of each coupling spline flow, each with graphs and
     under disable_graphs() from one seed, bit for bit: the weights, the
     carried tensors each fit ends with (weights, Adam's moments and count,
     the best weights and loss), the losses the host read, the steps and
     epochs counted (flows.train.COUNTS, which Instrument reads in every
     earlier phase), the launches and launches by shape; ms per Adam step
     both ways; in torch.profiler windows of the headline, IMH and DLMC
     fits, the device's busy share and the kernel and graph launches both
     ways; the weight buffer's cache holds none of a fit graph's buffers.
Each path's launch counts are set to 0 just before it and read just after;
every shape the IMH path (10-10c) and the paths of phases 11-13, 16, 18b and 21 launched
must be one phase 3, 3b, 7 or 7b held against the plain version, and phase
17's and 19's ones they hold themselves; each has its own row in the kernels' line.
Prints the kernels' JSON line (each kernel's "ms" is the median of CUDA events
around its wrapper's call at the main path's shape, host included, as in every
earlier run; "device_ms" its kernels' device time a launch from torch.profiler,
over the launches the profiler recorded; where it recorded none, that of
back-to-back calls between CUDA events for a call over 1 ms, else null), then
as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Needs no JAX, no network, and exits non-zero without a CUDA device.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import gc
import io
import json
import multiprocessing
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# published peaks of one H100 SXM (NVIDIA data sheet): FP32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
TOL = 1e-4
D, H, L, C, INNER_N, OUTER = 100, 128, 4, 100, 5, 2184
# weights are perturbed away from the zero-init identity by this much
# N(0, 1) noise: log-scales reach about +-1.5, outputs stay O(10), where a
# float32 difference of 1e-4 is a few ulps of the largest outputs
PERTURB = 0.05
# MALA acceptance after the warmup depends on where 100 dual-averaging
# steps leave the step size: over seeds 0-15 both packages' tuned steps
# span 0.22-0.29, and the MALA acceptance 0.56-0.71 (JAX) and 0.60-0.72
# (port) on this target (scripts/warmup_reference_cpu.py), so the band is
# that spread. The jump acceptance, set by the fitted flow, is tight.
WARM_MALA_ACC = (0.55, 0.72)
WARM_JUMP_ACC = (0.010, 0.035)
# the spline flows of the slice: 8 bins on [-5, 5]
N_BINS, TAIL = 8, 5.0
SPLINE_FLOWS = {"rqs": "c-rqnsf", "lrs": "c-lrsnsf"}
REPLACES = {"fwd": "nfmc_tpu/ops/experimental_spline_pallas.py:308",
            "bwd": "nfmc_tpu/ops/experimental_spline_pallas.py:323"}
# The spline backward kernel against the autograd VJP of the plain version,
# relative to max(1, max|ref|) at PERTURB: the steep splines amplify
# rounding (the JAX package measured two exact paths 3e-5 apart at 0.05,
# tests/test_pallas.py:175-180); on an H100 this kernel measured at most
# 3.14e-5 (PERF.md).
SPLINE_BWD_TOL = 2e-4
# 8b's misfit runs, in outer iterations (500 until phase 19 joined the
# script: the gate is analytic)
SPLINE_MISFIT_OUTER = 250
# Self-target (phase 8c): weights perturbed SELF_PERTURB from the identity,
# and the MALA acceptance band around the JAX package's on the same numpy
# weights (scripts/warmup_reference_cpu.py --self-target).
SELF_PERTURB, SELF_SEED = 0.01, 11
SELF_MALA_ACC = (0.03, 0.30)
# IMH (phase 10): bench.py's north-star length, and the largest hoisted
# chunk of that run (the pipelined loop's 1024) and of any run (the
# footprint cap: 2^27 elements over C * (3 d + H) a draw = 3135 iterations)
IMH_ITERS, IMH_CHUNK, IMH_CAP = 8000, 1024, (1 << 27) // (C * (3 * D + H))
# the rows of FixedIMH's hoisted chunks up to IMH_CHUNK iterations
# (core.driver.chunk_schedule: 1, 4, 16, ... iterations)
IMH_CHUNK_ROWS = [4 ** i * C for i in range(6)]
# IMH with the reverse-KL warmup on DiagonalGaussian1(100), 4000 iterations
# (phase 10b). scripts/warmup_reference_cpu.py --imh over seeds 0-7 on the
# CPU: the JAX package's acceptance spans 0.0454-0.1176 (mean 0.0875), the
# port's 0.0478-0.1495 (mean 0.0723); the identity flow's stays under
# 0.0037. The band is the JAX span from half its low to 1.5 times its high.
# The moments over the 100 dims, in either package over those seeds: the
# median of |var / sigma^2 - 1| reaches 0.0531 and of |mean| / sigma
# 0.0448, and the gate is 1.5 times those; the variance ratio spans
# 0.2979-1.1650 (the extremes of poorly mixing chains in the widest
# dims), and the gate is half the lowest and 1.5 times the highest excess,
# so that a dim whose variance collapses fails.
IMH_WARM_ITERS = 4000
# AdaptiveIMH's refit: make_scan_fit over the C = 100 rows of a history row,
# one Adam step on the adaptive batch of 64 (phase 10c)
REFIT_B = 64
IMH_WARM_ACC_JAX = "0.0454-0.1176"
IMH_WARM_ACC = (0.0227, 0.1764)
IMH_WARM_MOMENTS = {"median|var/sigma^2 - 1|": (0.0, 0.080), "median|mean|/sigma": (0.0, 0.067),
                    "min var/sigma^2": (0.149, float("inf")),
                    "max var/sigma^2": (0.0, 1.248)}
# The flow-reparameterised samplers (phases 11-11f), at bench.py's sizes.
# 11: neutra_hmc, 100 chains, the identity-init RealNVP frozen, HMC step
# 0.1 and 20 leapfrog steps (bench.py:508, 600-604), cut from 1000 to
# NEUTRA_ITERS iterations (500 until the script's wall with phase 17)
NEUTRA_ITERS, NEUTRA_STEP = 250, 0.1
# Its bands, from scripts/flow_samplers_reference_cpu.py --neutra-hmc (the
# JAX package on the CPU, seeds 0-7, at NEUTRA_ITERS): acceptance
# 0.989960-0.991640, so a rejection rate of 0.008360-0.010040, and the band
# is that rate from half its low to 1.5 times its high (as phase 10b widens
# its acceptance); max|mean| 0.009857-0.015473 and max|E[x^2] - 1|
# 0.024565-0.038894 over the dims, and the gates are 1.5 times the highest
NEUTRA_ACC_JAX, NEUTRA_ACC = "0.989960-0.991640", (0.984940, 0.995820)
NEUTRA_MOMENTS = (0.023210, 0.058341)
# 11a: neutra_mh on Funnel(100) with warmup=True: the reverse-KL fit capped
# at NEUTRA_MH_FIT_EPOCHS epochs (the default's 50,000 with early stopping
# after 5000 is a depth the script's time limit cannot hold), the random
# walk's scale 2.38 / sqrt(d) (the optimal scale for a Gaussian latent)
NEUTRA_MH_ITERS, NEUTRA_MH_FIT_EPOCHS = 1000, 500
NEUTRA_MH_SCALE = 2.38 / D ** 0.5
# --neutra-mh over seeds 0-7: acceptance 0.220540-0.233640, the band from
# half the low to 1.5 times the high
NEUTRA_MH_ACC_JAX, NEUTRA_MH_ACC = "0.220540-0.233640", (0.110270, 0.350460)
NEUTRA_MH_FIT_KWARGS = {"early_stopping": True, "early_stopping_threshold": 5000,
                        "keep_best_weights": True, "n_samples": 128,
                        "n_epochs": NEUTRA_MH_FIT_EPOCHS, "lr": 0.005}
# 11b: neutra_hmc with each self-target flow, NEUTRA_SELF_ITERS iterations
# at half phase 11's step: U~ is N(0, I) in 100-d, where a step of 0.1
# rejects ~0.9% of the trajectories for their integration error alone (the
# JAX package's 100-iteration runs read 0.9896-0.9897 at seed 0), and 0.05
# puts the acceptance well above the gate of 0.99 whatever the flow, while
# a wrong input gradient still wrecks the energy (100 iterations until the
# script's wall with phase 17)
NEUTRA_SELF_ITERS, NEUTRA_SELF_STEP = 50, 0.05
# --self-target over seeds 0-7, all three flows: acceptance 0.9972-0.9990;
# over the dims of the latent draws the median of |mean| 0.013958-0.020125
# and of |var - 1| 0.014772-0.022049; the bounds are 1.5 times the highest
NEUTRA_SELF_MOMENTS = (0.030188, 0.033074)
# 11c: tess at bench.py:641-643, TESS_ITERS iterations (2000 until phase 19
# joined the script: its gates are analytic), then 20 warmup iterations with
# fixed-effort refits
TESS_ITERS, TESS_FIT_KWARGS = 1000, {"n_epochs": 10, "lr": 5e-3}
# 11d: jump_hmc at bench.py:682-722: 1024 chains, 5 inner HMC iterations;
# JUMP_HMC_OUTER outer iterations (100 until phase 19 joined the script: its
# gates are analytic, and its hoisted inverse at B = 51,200 a shape phase 3
# holds)
JUMP_HMC_C, JUMP_HMC_OUTER, JUMP_HMC_INNER = 1024, 50, 5
# 11e: dlmc at bench.py:726-743, 1024 chains, cut from 200 iterations to
# DLMC_ITERS (100, then 50 until the script's wall with phase 17): each
# iteration refits the flow with 110
# Adam steps (10 epochs of 11 batches of 64), host-bound at ~2-5 ms a step
DLMC_C, DLMC_ITERS, DLMC_FIT_KWARGS = 1024, 25, {"n_epochs": 10, "lr": 5e-3}
# Its bands, from scripts/flow_samplers_reference_cpu.py --dlmc (the JAX
# package on the CPU at the same depth, seeds 0-7): the moment error
# max|mean| 0.047696-0.076703 and the acceptance 0.115937-0.124375, each
# band from half the low to 1.5 times the high
DLMC_ERR_JAX, DLMC_ERR = "0.047696-0.076703", (0.023848, 0.1150545)
DLMC_ACC_JAX, DLMC_ACC = "0.115937-0.124375", (0.0579685, 0.1865625)
# The adaptive-trajectory and slice samplers (phases 12-12f), at bench.py's
# sizes. 12: nuts at bench.py's nuts_1024 (bench.py:1053-1058, 1099-1119):
# 1024 chains on a 100-d standard Gaussian, max_tree_depth 10, 85 warmup
# and 100 sampling iterations
NUTS_C, NUTS_WARM, NUTS_ITERS, NUTS_DEPTH = 1024, 85, 100, 10
# 12a: chees_hmc at bench.py:891-936: 1024 chains on DiagonalGaussian1(100),
# 341 warmup and 1000 sampling iterations, store_samples=False
CHEES_C, CHEES_WARM, CHEES_ITERS = 1024, 341, 1000
# 12b: ess with bench.py:1686-1691's target (sigma linspace(0.4, 0.9, 5), the
# "residual" likelihood of tools/run_reference.py) at 100 chains, with the
# warmup's ellipse adaptation; 12f: its matched run, 32 chains x 600
# iterations, against the JAX package's draws (scripts/mcmc_reference_cpu.py
# --ess-draws wrote them to ESS_DRAWS)
ESS_SIG = np.linspace(0.4, 0.9, 5).astype(np.float32)
ESS_C, ESS_WARM, ESS_ITERS = 100, 100, 600
ESS_AB_C, ESS_AB_ITERS, ESS_AB_SEED = 32, 600, 2
ESS_DRAWS = "scripts/ess_reference_draws.npz"
# 12c: jump_ess / jump_nuts / jump_chees in the headline setting (100
# chains, d=100, the identity-init RealNVP frozen, 5 inner iterations) on
# the misfit target N(0.12 * 1, I); 64 outer iterations make one hoisted
# chunk of 6400 proposals (a shape phase 3 holds); NUTS's inner step 0.5
# keeps its trees short (the default 0.1 builds ~64 leaves a step)
JUMP12_OUTER, JUMP12_INNER, JUMP12_MU, JUMP12_NUTS_STEP = 64, 5, 0.12, 0.5
# 12d: neutra_chees as phase 11 (bench.py:508, 600-604): 100 chains, the
# identity-init RealNVP frozen (the warmup's reverse-KL fit set to 0
# epochs), ChEES's 100 warmup iterations, then 1000
NEUTRA_CHEES_WARM, NEUTRA_CHEES_ITERS = 100, 1000
# Their bands, from scripts/mcmc_reference_cpu.py (the JAX package on the
# CPU at the same configurations, seeds 0-7), each from half the lowest to
# 1.5 times the highest; an acceptance near 1 as phase 11's: its rejection
# rate from half the lowest to 1.5 times the highest
NUTS_ACC_JAX, NUTS_ACC = "0.994746-0.995518", (0.992119, 0.997759)
NUTS_STEP_JAX, NUTS_STEP = "0.670154-0.682954", (0.335077, 1.024431)
# the JAX package's tuned step, for runs without a warmup (the warm call and
# the profiled window)
NUTS_STEP_JAX_MID = 0.67
NUTS_ERR_JAX, NUTS_ERR = "0.004365-0.006084", (0.002182, 0.009126)
CHEES_TRAJ_JAX, CHEES_TRAJ = "3.538053-3.724400", (1.769026, 5.586600)
CHEES_STEP_JAX, CHEES_STEP = "0.961527-0.983227", (0.480764, 1.474840)
CHEES_LF_JAX, CHEES_LF = "2.356000-2.425000", (1.178000, 3.637500)
CHEES_ACC_JAX, CHEES_ACC = "0.658170-0.672854", (0.329085, 1.009282)
CHEES_ERR_JAX, CHEES_ERR = "0.003162-0.004700", (0.001581, 0.007051)
ESS_MEAN_JAX, ESS_MEAN = "0.002935-0.010142", (0.001468, 0.015214)
ESS_VAR_JAX, ESS_VAR = "0.007359-0.014495", (0.003680, 0.021742)
JUMP12_ACC = {"ess": ((0.227109, 0.715547), "0.454219-0.477031"),
              "nuts": ((0.194375, 0.620156), "0.388750-0.413438"),
              "chees": ((0.200000, 0.646875), "0.400000-0.431250")}
NEUTRA_CHEES_ACC_JAX, NEUTRA_CHEES_ACC = "0.568170-0.652490", (0.284085, 0.978735)
# max|mean| 0.013367-0.021676 and max|E[x^2] - 1| 0.016915-0.028236 over the
# dims; the gates are 1.5 times the highest
NEUTRA_CHEES_MOMENTS = (0.032515, 0.042355)
# 12e: NUTS's step size for the card-against-CPU step (the untuned default,
# whose trees reach depth 5-6 on this target)
NUTS_STEP_12E = 0.1

# Phase 13: the last strategies at bench.py's sizes, cut in depth so that
# the script stays well inside its time limit on a slow host (it took 857 s
# there with the cuts below undone but the first). 13: dense_metric
# (bench.py:1310-1437): d = 100, 100 chains, 341 warmup iterations and 250
# (the bench's 1000 cut to 500, then to 250 to hold the script's wall with
# phase 17); a condition-1e3 correlated Gaussian (the QR basis
# of a seed-0 normal matrix, variances geomspace(1, 1e-3)) and the isotropic
# N(0, I); ESS over the true eigenbasis, max_window 1024. The bench's
# near-isotropic runs (hmc and dense_hmc, sigma linspace(0.9, 1.1)) are cut
# first
DENSE_WARM, DENSE_ITERS, DENSE_WINDOW = 341, 250, 1024
DENSE_RUNS = (("corr", "hmc"), ("corr", "dense_hmc"), ("corr", "mala"), ("corr", "dense_mala"),
              ("iso", "dense_hmc"), ("iso", "dense_mala"))
# 13a: pt_multimodal (bench.py:1231-1307): modes at -2 and 2 in 10-d, 64
# chains all started in mode 0, 500 iterations (the bench's 2000 cut to
# 1000, then to 500 with phase 17) without warmup, 8 rungs down to beta 0.02
PT_D, PT_C, PT_ITERS, PT_MODE, PT_TEMPS, PT_BETA_MIN = 10, 64, 500, 2.0, 8, 0.02
PT_RUNS = ("pt_mala", "pt_mh", "pt_hmc", "mala")
# 13b: aies at the headline's d = 100 with 1024 walkers on 13's correlated
# target, 341 warmup and 1000 iterations
AIES_C, AIES_WARM, AIES_ITERS = 1024, 341, 1000
# 13c: jump_aies in 12c's setting (100 chains, the identity-init RealNVP
# frozen, 5 inner iterations, 64 outer, target N(0.12 * 1, I))


def dense_metric_targets():
    """bench.py:1335-1343's correlated target in numpy: the eigenbasis q, the
    variances and the Cholesky factor of the covariance."""
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.standard_normal((D, D)))
    eigs = np.geomspace(1.0, 1e-3, D)
    chol = np.linalg.cholesky((q * eigs) @ q.T + 1e-9 * np.eye(D))
    return q, eigs, chol


def dense_x0(kind: str, seed: int, n: int = C) -> np.ndarray:
    """``n`` exact draws from phase 13's ``kind`` target ("corr" or "iso"),
    the start of both the warmup and the run (as bench.py's x0_corr /
    x0_iso)."""
    z = np.random.default_rng(3000 + seed).standard_normal((n, D))
    x = z @ dense_metric_targets()[2].T if kind == "corr" else z
    return x.astype(np.float32)


def pt_x0(seed: int) -> np.ndarray:
    """Every chain in mode 0 (bench.py:1260): its mean plus 0.5 N(0, I)."""
    z = np.random.default_rng(5000 + seed).standard_normal((PT_C, PT_D))
    return (-PT_MODE + 0.5 * z).astype(np.float32)


def pt_mode_metrics(draws: np.ndarray):
    """bench.py:1263-1269: over the second half of the draws, the share in
    mode 1 (across the hyperplane between the modes) off 0.5, and the rate
    at which a chain switches modes."""
    half = draws[draws.shape[0] // 2:]
    in_mode1 = half.sum(-1) > 0.0
    balance_err = abs(float(in_mode1.mean()) - 0.5)
    switches = float(np.abs(np.diff(in_mode1.astype(np.int8), axis=0)).mean())
    return balance_err, switches


# Phase 13's bands: the JAX package's range over seeds 0-7 on the CPU, from
#   JAX_PLATFORMS=cpu python scripts/mcmc_reference_cpu.py \
#       --seeds 0 1 2 3 4 5 6 7 --dense --pt --aies --jump-aies
# and gated by jax_band
DENSE_JAX = {
    ("corr", "hmc"): {"ESS mean": (11757.715820, 13978.272461),
                      "worst-direction ESS": (533.027588, 616.844727),
                      "max|mean|/sigma": (0.039907, 0.395158)},
    ("corr", "dense_hmc"): {"ESS mean": (9283.613281, 11403.738281),
                            "worst-direction ESS": (7864.323242, 10562.819336),
                            "max|mean|/sigma": (0.022189, 0.035223)},
    ("corr", "mala"): {"ESS mean": (1572.002075, 1615.638428),
                       "worst-direction ESS": (506.134277, 529.874207),
                       "max|mean|/sigma": (0.154894, 0.294433)},
    ("corr", "dense_mala"): {"ESS mean": (2495.409180, 2628.416260),
                             "worst-direction ESS": (1463.229004, 1685.601685),
                             "max|mean|/sigma": (0.049729, 0.073185)},
    # HMC without jitter on the exact scalar metric: the tuned step lands
    # on or off a leapfrog resonance (ESS 2,874 to nearly all 25,000 draws)
    ("iso", "dense_hmc"): {"ESS mean": (2873.768799, 24999.498047),
                           "worst-direction ESS": (2639.956299, 24967.757812),
                           "max|mean|/sigma": (0.009533, 0.062979)},
    ("iso", "dense_mala"): {"ESS mean": (2887.734375, 3028.069336),
                            "worst-direction ESS": (2594.420166, 2804.453613),
                            "max|mean|/sigma": (0.040688, 0.065449)},
}
# the final scalar-mode flag, the JAX package's at every seed
DENSE_SCALAR = {"corr": False, "iso": True}
# the worst-direction ESS ratios dense / diagonal on the correlated target
DENSE_RATIO_JAX = {"hmc": (12.974175, 19.469824), "mala": (2.842528, 3.236046)}
PT_JAX = {
    "pt_mala": {"cold acc": (0.727281, 0.733125), "balance error": (0.027875, 0.097250),
                "swap acc": (0.394607, 0.403509)},
    "pt_mh": {"cold acc": (0.472938, 0.479625), "balance error": (0.222125, 0.336625),
              "swap acc": (0.402670, 0.407857)},
    "pt_hmc": {"cold acc": (0.928250, 0.934469), "balance error": (0.004250, 0.034750),
               "swap acc": (0.394071, 0.399500)},
    "mala": {"cold acc": (0.724969, 0.729875), "balance error": (0.5, 0.5)},
}
AIES_JAX = {"acc": (0.292517, 0.299679), "a": (1.358011, 1.368737),
            "max|mean|/sigma": (0.058456, 0.086164), "max|var/sigma^2-1|": (0.077381, 0.108321)}
JUMP_AIES_JAX = {"jump acc": (0.406719, 0.445000), "inner acc": (0.130375, 0.133125)}


# Phase 14: the flows without a kernel (NICE, the masked, NAF and residual
# flows), at d = D and each flow's default widths (MAF / IAF and the masked
# splines 2 layers of a 2 x 128 MADE; NICE and c-naf-* 2 coupling layers of
# hidden 128; NAF 8 (deep) or 4 (dense) components; the residual blocks 4
# layers of hidden 64, so the exact log-det; planar and radial 8 layers,
# Sylvester 4 with m = 8). Weights: the port's CPU init at ZOO_SEED plus
# ZOO_PERTURB N(0, 1) numpy noise from ZOO_SEED (zoo_weights), as
# tests/test_flow_zoo.py perturbs the JAX zoo's.
ZOO_NAMES = ("nice", "maf", "iaf", "ma-rqnsf", "ia-rqnsf", "ma-lrsnsf", "ia-lrsnsf",
             "c-naf-deep", "c-naf-dense", "c-naf-deep-dense", "ma-naf-deep", "ma-naf-dense",
             "ma-naf-deep-dense", "ia-naf-deep", "ia-naf-dense", "ia-naf-deep-dense",
             "i-resnet", "resflow", "proximal-resflow", "planar", "radial", "sylvester")
ZOO_PERTURB, ZOO_SEED, ZOO_B = 0.1, 13, 100
# 14a: card against CPU. The closed-form directions to TOL * max(1,
# max|ref|). The iterative ones (NAF bisection, the residual fixed point,
# planar / radial bisection, Sylvester's Newton solve) to ZOO_ITER_TOL: each
# stops at a root that rounding moves by a few float32 ulps of the
# conditioner's output, and a masked flow's d = 100 sequential dims feed
# each dim's rounding into the next dim's conditioner. The round trip
# x -> z -> x on the card to ZOO_ROUND_TRIP. The CPU's own float32 run of
# every direction of every flow lies within 3.7e-6 of max(1, max|ref|)
# from float64 and every round trip within 1.3e-4 (the masked NAF flows at
# phase 14's 1 layer within 2.2e-6 and 9.6e-6; scripts/
# flow_zoo_reference_cpu.py --drift; at 2 layers ia-naf-deep-dense's
# forward saturates its mixtures near the clamp 1 - 1e-6 and drifts 5.5e-4,
# round trip 1.8e-3).
ZOO_ITER_TOL, ZOO_ROUND_TRIP = 1e-3, 1e-3
# the CPU side of 14a runs in these worker processes, beside the card
ZOO_CPU_WORKERS = 3
# 14b: self-target IMH, ZOO_SELF_ITERS iterations (FixedIMH's hoisted chunks
# of 1, 4 and 16 iterations) at 100 chains; 14c: IMH with the reverse-KL
# warmup through IAF on DiagonalGaussian1(100), 1000 iterations; 14d:
# jump_mala with the identity-init NICE frozen, ZOO_NICE_OUTER outer
# iterations (500 until the script's wall with phase 17, 200 until phase 19's:
# its gate is analytic), on N(0.12 * 1, I)
ZOO_SELF_ITERS, ZOO_IAF_ITERS, ZOO_NICE_OUTER = 21, 1000, 100
# the masked NAF flows' slow direction (ma-naf-* inverse, ia-naf-* forward)
# is d sequential bisections of 66 steps, 1.5e5-3.1e5 eager operations a
# call at d = 100 and 2 layers (scripts/flow_zoo_reference_cpu.py --ops):
# phase 14 cuts them from their default 2 layers to 1 (zoo_flow, as 15d:
# a cut of depth, not of widths; at 2 layers they took 2-12 s a flow in
# 14b and ~20 s of 14a's card calls, until the script's wall with phase
# 17), and their 14b runs one iteration, one hoisted chunk
ZOO_SELF_ITERS_NAF = 1
# 14b's gate: acceptance >= 1 - max(0.01, 1.5 times the JAX package's
# highest rejection rate over seeds 0-7 at the same configuration)
# (scripts/flow_zoo_reference_cpu.py --self-target); 1.0 where it never
# rejected
ZOO_SELF_REJECT_JAX = {name: 0.0 for name in ZOO_NAMES}
ZOO_SELF_REJECT_JAX.update({"ia-rqnsf": 0.000476, "ia-lrsnsf": 0.000476})
ZOO_SELF_ACC = {name: 1.0 - max(0.01, 1.5 * r) for name, r in ZOO_SELF_REJECT_JAX.items()}
# 14c's bands, from scripts/flow_zoo_reference_cpu.py --iaf (the JAX package
# on the CPU at the same configuration, seeds 0-7): acceptance 0.2623-0.4727
# (the identity IAF's at most 0.010550), the band from half the low to 1.5
# times the high; the medians over the dims of |var / sigma^2 - 1| reach
# 0.0185 and of |mean| / sigma 0.0120, gated at 1.5 times those; the
# variance ratio spans 0.9378-1.0852, gated from half the lowest to 1.5
# times the highest excess (as phase 10b)
ZOO_IAF_ACC_JAX = "0.2623-0.4727"
ZOO_IAF_ACC = (0.1312, 0.7091)
ZOO_IAF_MOMENTS = {"median|var/sigma^2 - 1|": (0.0, 0.0278), "median|mean|/sigma": (0.0, 0.0180),
                   "min var/sigma^2": (0.4689, float("inf")), "max var/sigma^2": (0.0, 1.1278)}


def zoo_masked_naf(name: str) -> bool:
    """Whether phase 14's flow ``name`` is a masked NAF flow."""
    return name[:3] in ("ma-", "ia-") and "naf" in name


def zoo_self_iters(name: str) -> int:
    """Phase 14b's iterations for flow ``name``."""
    return ZOO_SELF_ITERS_NAF if zoo_masked_naf(name) else ZOO_SELF_ITERS


def zoo_flow(name: str) -> str:
    """Phase 14's flow spec for ``name``: its default widths, a masked NAF
    flow at 1 layer."""
    return f'{name}%{{"n_layers": 1}}' if zoo_masked_naf(name) else name


def zoo_iterative(name: str, inverse: bool) -> bool:
    """Whether phase 14's flow ``name`` solves for the direction."""
    if "naf" in name:
        return inverse != name.startswith("ia-")
    return inverse and name in ("i-resnet", "resflow", "proximal-resflow", "planar", "radial",
                                "sylvester")


def zoo_tol(name: str, inverse: bool) -> float:
    """Phase 14a's card-against-CPU tolerance, relative to max(1, max|ref|)."""
    return ZOO_ITER_TOL if zoo_iterative(name, inverse) else TOL


def zoo_inputs():
    """Phase 14a's rows: x for the forward, z for the inverse, N(0, I)."""
    rng = np.random.default_rng(ZOO_SEED)
    return tuple(rng.standard_normal((ZOO_B, D)).astype(np.float32) for _ in range(2))


def zoo_cpu_reference(name: str) -> dict:
    """Phase 14a's CPU side for flow ``name`` (run in a worker process):
    ``{"forward": (y, ld), "inverse": (x, ld)}`` as numpy."""
    from nfmc_torch.api.registry import create_flow_object
    from nfmc_torch.flows import from_jax_params

    torch.set_num_threads(2)
    flow = create_flow_object(zoo_flow(name), (D,), seed=0)
    flow.params = from_jax_params(zoo_weights(zoo_flow(name)))
    x, z = (torch.from_numpy(v) for v in zoo_inputs())
    with torch.no_grad():
        return {"forward": tuple(t.numpy() for t in flow.bijection.forward_fn(flow.params, x)),
                "inverse": tuple(t.numpy() for t in flow.bijection.inverse_fn(flow.params, z))}


def zoo_weights(name: str, seed: int = ZOO_SEED, pert: float = ZOO_PERTURB):
    """Phase 14's weights of flow ``name`` as a tree of float32 numpy arrays
    (the layout both packages share): the port's init on the CPU at
    ``seed``, every array moved by ``pert`` N(0, 1) numpy noise from
    ``seed``. ``scripts/flow_zoo_reference_cpu.py`` loads the same arrays
    into the JAX package."""
    from nfmc_torch.api.registry import create_flow_object
    from nfmc_torch.utils import tree_leaves, tree_unflatten

    params = create_flow_object(name, (D,), seed=seed).params
    rng = np.random.default_rng(seed)
    return tree_unflatten(params, [
        (t.numpy() + pert * rng.standard_normal(tuple(t.shape))).astype(np.float32)
        for t in tree_leaves(params)])


# Phase 15: the continuous, multiscale / Glow and convolutional flows (no
# kernel: each of the four kernels must launch 0 times for them), at each
# flow's default widths (the continuous MLPs 2 x 64 and 12 steps, DDB 20
# Euler steps; multiscale / Glow 2 levels of 2 steps, hidden_channels 32;
# the conv residual flows 4 layers of 16 channels; the conv CNFs 16
# channels and 6 steps, DDB 12). 15a: card against CPU at B = LAST_B rows,
# weights the port's CPU init at LAST_SEED plus LAST_PERTURB N(0, 1)
# (last_weights). The vector flows at d = D take the Hutchinson trace
# (d > 32), FFJORD at d = 32 the exact path; the image flows on (8, 8),
# the conv CNFs there on the exact trace (d = 64 <= 64), conv-FFJORD on
# (16, 16) on Hutchinson's.
LAST_VECTOR = ("ffjord", "rnode", "ot-flow", "ddb")
LAST_IMAGE = ("ms-realnvp", "ms-nice", "ms-rqnsf", "ms-lrsnsf", "ms-naf-deep", "ms-naf-dense",
              "ms-naf-deep-dense", "glow-realnvp", "glow-nice", "glow-rqnsf", "glow-lrsnsf",
              "glow-naf-deep", "glow-naf-dense", "glow-naf-deep-dense", "conv-i-resnet",
              "conv-resflow", "conv-ffjord", "conv-rnode", "conv-ddb")
LAST_CASES = ([(n, (D,)) for n in LAST_VECTOR] + [("ffjord", (32,))]
              + [(n, (8, 8)) for n in LAST_IMAGE] + [("conv-ffjord", (16, 16))])
LAST_PERTURB, LAST_SEED, LAST_B = 0.1, 17, 100
LAST_CPU_WORKERS = 4
# 15a's card-against-CPU limits, relative to max(1, max|ref|), per case and
# direction: max(TOL, 4 times the port's float32 drift from float64 on the
# CPU at the same weights and rows; two float32 runs may part by twice the
# drift, and the card sums in another order)
# (scripts/last_flows_reference_cpu.py --drift).
LAST_DRIFT = {
    ("ffjord", (100,), "forward"): 2.236e-07, ("ffjord", (100,), "inverse"): 3.524e-07,
    ("rnode", (100,), "forward"): 2.236e-07, ("rnode", (100,), "inverse"): 3.524e-07,
    ("ot-flow", (100,), "forward"): 1.333e-07, ("ot-flow", (100,), "inverse"): 2.776e-07,
    ("ddb", (100,), "forward"): 2.672e-07, ("ddb", (100,), "inverse"): 3.141e-07,
    ("ffjord", (32,), "forward"): 9.735e-07, ("ffjord", (32,), "inverse"): 1.060e-06,
    ("ms-realnvp", (8, 8), "forward"): 5.484e-07, ("ms-realnvp", (8, 8), "inverse"): 3.096e-07,
    ("ms-nice", (8, 8), "forward"): 3.745e-07, ("ms-nice", (8, 8), "inverse"): 4.932e-07,
    ("ms-rqnsf", (8, 8), "forward"): 3.398e-06, ("ms-rqnsf", (8, 8), "inverse"): 1.595e-03,
    ("ms-lrsnsf", (8, 8), "forward"): 2.069e-06, ("ms-lrsnsf", (8, 8), "inverse"): 1.806e-03,
    ("ms-naf-deep", (8, 8), "forward"): 1.255e-06, ("ms-naf-deep", (8, 8), "inverse"): 8.842e-07,
    ("ms-naf-dense", (8, 8), "forward"): 5.365e-07, ("ms-naf-dense", (8, 8), "inverse"): 1.351e-06,
    ("ms-naf-deep-dense", (8, 8), "forward"): 2.187e-06, ("ms-naf-deep-dense", (8, 8), "inverse"): 1.202e-06,
    ("glow-realnvp", (8, 8), "forward"): 1.369e-06, ("glow-realnvp", (8, 8), "inverse"): 2.422e-06,
    ("glow-nice", (8, 8), "forward"): 2.236e-07, ("glow-nice", (8, 8), "inverse"): 2.990e-07,
    ("glow-rqnsf", (8, 8), "forward"): 3.304e-06, ("glow-rqnsf", (8, 8), "inverse"): 9.527e-04,
    ("glow-lrsnsf", (8, 8), "forward"): 2.922e-06, ("glow-lrsnsf", (8, 8), "inverse"): 1.022e-02,
    ("glow-naf-deep", (8, 8), "forward"): 4.609e-07, ("glow-naf-deep", (8, 8), "inverse"): 1.201e-06,
    ("glow-naf-dense", (8, 8), "forward"): 8.393e-06, ("glow-naf-dense", (8, 8), "inverse"): 5.567e-04,
    ("glow-naf-deep-dense", (8, 8), "forward"): 6.208e-05, ("glow-naf-deep-dense", (8, 8), "inverse"): 2.447e-05,
    ("conv-i-resnet", (8, 8), "forward"): 1.165e-07, ("conv-i-resnet", (8, 8), "inverse"): 1.105e-07,
    ("conv-resflow", (8, 8), "forward"): 8.488e-08, ("conv-resflow", (8, 8), "inverse"): 1.001e-07,
    ("conv-ffjord", (8, 8), "forward"): 8.938e-08, ("conv-ffjord", (8, 8), "inverse"): 1.010e-07,
    ("conv-rnode", (8, 8), "forward"): 8.938e-08, ("conv-rnode", (8, 8), "inverse"): 1.010e-07,
    ("conv-ddb", (8, 8), "forward"): 2.071e-07, ("conv-ddb", (8, 8), "inverse"): 1.064e-07,
    ("conv-ffjord", (16, 16), "forward"): 1.454e-07, ("conv-ffjord", (16, 16), "inverse"): 1.453e-07,
}
# 15b: examples/06_applied_targets.py's phi^4 run with the flow swapped for
# Glow: Phi4Lattice(L=8, kappa=0.25, lam=0.022), jump_hmc, glow-realnvp,
# 32 chains, PHI4_ITERS outer iterations (100 until the script's wall with
# phase 17), warmup=True. Bands: the JAX package's range over seeds 0-7 on
# the CPU at these depths (scripts/last_flows_reference_cpu.py --phi4),
# from half the low to 1.5 times the high.
PHI4_KW, PHI4_C, PHI4_ITERS = {"L": 8, "kappa": 0.25, "lam": 0.022}, 32, 50
# the warmup's fit cut to 25 epochs of the default 500 (50 until phase 17;
# with early stopping the port ran 200, 1800 Adam steps, 68 s on a slow
# host), its other settings the jump sampler's default
PHI4_FIT_KWARGS = {"early_stopping": True, "early_stopping_threshold": 50,
                   "batch_size": "adaptive", "show_progress": False, "n_epochs": 25}
PHI4_ABS_M_JAX, PHI4_ABS_M = "0.3075-0.3418", (0.15375, 0.5127)
PHI4_JUMP_JAX, PHI4_JUMP = "0.0963-0.1444", (0.04815, 0.2166)
# 15c: IMH with the reverse-KL warmup (kinetic regularizer weighted in)
# through RNODE on DiagonalGaussian1(100), RNODE_ITERS iterations; bands as
# 14c's from scripts/last_flows_reference_cpu.py --rnode. The warmup's fit
# is cut to 50 epochs of the default 500, its other settings the default
# (a cut of depth):
# an epoch at d = 100 is ~1e4 eager operations (12 RK4 steps, 4 stages, a
# probe VJP each, and their backward), and the port's CPU took 500 epochs,
# 215 s, at the default
RNODE_ITERS = 1000
RNODE_FIT_KWARGS = {"early_stopping": True, "early_stopping_threshold": 50,
                    "keep_best_weights": True, "n_samples": 128, "n_epochs": 50, "lr": 0.005,
                    "check_for_divergences": True}
# The JAX package over seeds 0-7 (50 epochs): acceptance 0.0101-0.0113; the
# medians over the dims of |var / sigma^2 - 1| 0.8806-0.8925 and of
# |mean| / sigma 0.0130-0.0184; the variance ratio 0.0291-1.1612 (the flow
# still shrinks the wide dims); the kinetic term 83.8-93.4. Gated from half
# the low to 1.5 times the high (the |mean| median and the largest ratio
# from 0, the smallest ratio to infinity), as 14c. At 100 epochs the port's
# CPU runs of the same seeds lay inside the JAX package's range
# (acceptance 0.0103-0.0110 against 0.0095-0.0115).
RNODE_ACC_JAX, RNODE_ACC = "0.0101-0.0113", (0.00505, 0.01695)
RNODE_MOMENTS = {"median|var/sigma^2 - 1|": (0.4403, 1.33875),
                 "median|mean|/sigma": (0.0, 0.0276),
                 "min var/sigma^2": (0.01455, float("inf")), "max var/sigma^2": (0.0, 1.7418)}
# 16: the headline (jump_mala, RealNVP 4 x 128, 100 chains, d = 100, 5 inner
# MALA steps, the flow frozen) with checkpoint_path, CKPT_OUTER outer
# iterations in segments of CKPT_SEG (a cut of the headline's 2184), and
# adaptive_imh (its 100 iterations) in segments of CKPT_SEG
CKPT_OUTER, CKPT_SEG = 100, 20
# the headline's untimed warm run (phase 5), in outer iterations; phase 6's
# misfit run (500 until the script's wall reached its limit on a slow host
# with phase 17, 256 until phase 19's: its gate is analytic, and its hoisted
# inverse at B = 12,800 a shape phase 3 holds); phase 10a's IMH misfit run
# (2000 until phase 19's: its gate is analytic)
HEADLINE_WARM, MISFIT_OUTER, IMH_MISFIT_ITERS = 64, 128, 1000
# Phase 17: the transport layer and FAB at bench.py's transport_logz sizes
# (bench.py:1724-1848, the easy target): prior N(0, I) in TR_D dims, target
# N(2 * 1, 0.25 I), log Z = TR_D log 0.5 relative to the prior; RealNVP
# with 2 layers of hidden width 32
TR_D = 16
TR_FLOW = 'realnvp%{"n_layers": 2, "hidden_size": 32}'
TR_TRUE_LOG_Z = TR_D * float(np.log(0.5))
TR_AIS = {"n": 4096, "n_steps": 128, "n_mcmc_steps": 2, "step_size": 0.1}
TR_AFT = {"n_particles": 2048, "n_iterations": 16, "n_train_epochs": 60,
          "n_train_particles": 1024, "n_val_particles": 512}
TR_CRAFT = {"n_particles": 2048, "n_iterations": 25, "n_annealing_steps": 12}
TR_PMC = {"n_particles": 2048, "n_train_epochs": 20, "n_mcmc_steps": 10}
TR_FAB = {"n_iterations": 300, "n_flow_training_steps": 20, "n_ais_particles": 512}
# FAB's importance-sampling estimate: TR_FAB_DRAWS flow draws (seed 7 + the
# run's seed) in TR_FAB_BLOCKS blocks for the two-standard-error band; its
# truth is the absolute evidence TR_TRUE_LOG_Z + (TR_D / 2) log(2 pi)
TR_FAB_DRAWS, TR_FAB_BLOCKS = 4096, 8
TR_METHODS = ("ais", "aft", "craft", "pmc", "fab")
# 17c: snf() at its defaults on the easy target (100 particles, 10 epochs,
# HMC + RealNVP(L=2) layers); ns() at tests/test_transport.py:211-218's
# configuration: d = 3, 64 live points, 400 iterations, log Z -7.214
TR_SNF = {"n_particles": 100, "n_epochs": 10}
TR_NS_D, TR_NS = 3, {"n_particles": 64, "n_iterations": 400}
TR_NS_TRUE_LOG_Z = TR_NS_D * float(np.log(0.5) - 0.5 * np.log(1.25) - 1.6)
# Phase 17's bands: the JAX package's range over seeds 0-7 on the CPU at the
# same sizes, from
#   JAX_PLATFORMS=cpu python scripts/transport_reference_cpu.py \
#       --seeds 0 1 2 3 4 5 6 7 --suite --snf --ns
# and gated by jax_band: each method's |log Z error| (FAB's against the
# absolute evidence), FAB's IS ESS fraction (its 2-SE band covered the
# truth at every seed), |mean - 2| of SNF's particles, NS's |log Z error|
# AIS's error is heavy-tailed (an IS ESS of ~2-50 of its 4096 particles):
# seeds 0-7 put it in 0.056745-0.352150, but the JAX package's own seed 22
# reads 0.653428, so its band is over seeds 0-31 (--ais --seeds 0 ... 31)
TR_ERR_JAX = {"ais": (0.003464, 0.653428), "aft": (0.016055, 0.248691),
              "craft": (0.039697, 0.424234), "pmc": (0.004612, 0.068087),
              "fab": (0.000035, 0.006293)}
TR_FAB_ESS_JAX = (0.189730, 0.980954)
TR_SNF_ERR_JAX = (0.000545, 0.027249)
TR_NS_ERR_JAX = (0.120189, 0.433047)
# 17a: card against CPU with the same weights (TR_PERTURB N(0, 1) from the
# init) and the same injected draws; sampler steps row by row, where float32
# rounding may flip an accept decision or a resample boundary in at most
# TR_PARTED of the rows (as phase 12e); the pCN sweep at TR_PCN_B rows (its
# step size adapts to the mean acceptance, so one flipped decision moves
# every later proposal)
TR_PERTURB, TR_SEED, TR_PARTED, TR_PCN_B = 0.05, 17, 0.01, 256


def last_weights(name: str, shape, seed: int = LAST_SEED, pert: float = LAST_PERTURB):
    """Phase 15's weights of flow ``name`` on ``shape`` as a tree of float32
    numpy arrays: the port's CPU init at ``seed`` plus ``pert`` N(0, 1)
    numpy noise from ``seed``."""
    from nfmc_torch.api.registry import create_flow_object
    from nfmc_torch.utils import tree_leaves, tree_unflatten

    params = create_flow_object(name, shape, seed=seed).params
    rng = np.random.default_rng(seed)
    return tree_unflatten(params, [
        (t.numpy() + pert * rng.standard_normal(tuple(t.shape))).astype(np.float32)
        for t in tree_leaves(params)])


class FixedProbes:
    """For the duration of a ``with`` block, the continuous and conv flows'
    Hutchinson probes depend on the row's size alone (numpy, seeded), the
    same on the card and on the CPU. Their own probes are a hash of each
    row's float32 bits (``flows.base.hutchinson_probes``), and rounding
    that differs between the devices in an integrator's stage changes every
    probe of that row."""

    def __enter__(self):
        import nfmc_torch.flows.continuous as cont
        import nfmc_torch.flows.multiscale as ms

        def probes(v, n, key=None):
            d = v.shape[-1]
            e = np.random.default_rng(100 * d + n).choice([-1.0, 1.0], size=(n, d))
            return torch.as_tensor(e, dtype=v.dtype, device=v.device).expand(*v.shape[:-1], n, d)

        self._orig = [(mod, mod.hutchinson_probes) for mod in (cont, ms)]
        for mod, _ in self._orig:
            mod.hutchinson_probes = probes
        return self

    def __exit__(self, *exc):
        for mod, fn in self._orig:
            mod.hutchinson_probes = fn


def last_flow(name: str, shape, device="cpu", dtype=torch.float32):
    """Phase 15's flow ``name`` on ``shape`` holding ``last_weights``."""
    from nfmc_torch.api.registry import create_flow_object
    from nfmc_torch.flows import from_jax_params
    from nfmc_torch.utils import tree_map

    flow = create_flow_object(name, shape, seed=0)
    flow.params = tree_map(lambda t: t.to(dtype), from_jax_params(last_weights(name, shape),
                                                                  device=device))
    return flow


def last_inputs(case, device="cpu"):
    """Phase 15a's rows for ``case = (name, shape)``: x, N(0, I), for the
    forward; for the inverse z, the float64 forward (on ``device``, with
    FixedProbes) of other N(0, I) rows, in float32. A NAF layer's logit is
    bounded (|y| < 13.8), so an N(0, I) latent can leave a NAF flow's
    image, where the inverse has no point to find and its bisection stops
    at the bracket's edge; the forward's images have preimages."""
    name, shape = case
    rng = np.random.default_rng(LAST_SEED)
    x, x2 = (rng.standard_normal((LAST_B, *shape)).astype(np.float32) for _ in range(2))
    flow = last_flow(name, shape, device=device, dtype=torch.float64)
    with torch.no_grad(), FixedProbes():
        z = flow.bijection.forward_fn(flow.params, torch.from_numpy(x2).double().to(device))[0]
    return x, z.float().cpu().numpy()


def last_cpu_reference(case, inputs=None, dtype=torch.float32) -> dict:
    """Phase 15a's CPU side for ``case = (name, shape)`` (a worker process),
    with FixedProbes, at ``inputs`` (default ``last_inputs(case)``):
    ``{"forward": (y, ld), "inverse": (x, ld)}`` as numpy, in ``dtype``."""
    torch.set_num_threads(2)
    flow = last_flow(*case, dtype=dtype)
    x, z = (torch.from_numpy(v).to(dtype) for v in (inputs or last_inputs(case)))
    with torch.no_grad(), FixedProbes():
        return {"forward": tuple(t.numpy() for t in flow.bijection.forward_fn(flow.params, x)),
                "inverse": tuple(t.numpy() for t in flow.bijection.inverse_fn(flow.params, z))}


def last_tol(name: str, shape, direction: str) -> float:
    """Phase 15a's limit for a case's direction (LAST_DRIFT)."""
    return max(TOL, 4.0 * LAST_DRIFT.get((name, tuple(shape), direction), 0.0))


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def median_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def device_us(fn, calls: int = 20) -> dict:
    """Device time per launch of each CUDA kernel ``fn`` launches, in us,
    from torch.profiler after a warm call: the kernel's recorded time over
    the launches it recorded. The profiler does not always record every
    launch of these kernels (scripts/coupling_kernels_ab.py --family spline
    counted 0.3-1.0 records a call in one call, all in another), so a total
    over the calls undercounts, and a window that recorded none is tried
    again, up to six windows. Empty if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    def name(key):  # "void (anonymous namespace)::kernel<8>(float const*, ...)" -> "kernel"
        m = re.search(r"(\w+)(?:<[^<>]*>)?\(", key)
        return m.group(1) if m else key

    fn()
    torch.cuda.synchronize()
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        seen = {name(a.key): a.self_device_time_total / a.count
                for a in prof.key_averages() if a.self_device_time_total > 0 and a.count > 0}
        if seen:
            return seen
    return {}


def back_to_back_ms(fn, reps: int) -> float:
    """ms a call of ``reps`` calls enqueued back to back between two CUDA
    events: the device's time a call where a launch's kernel outlasts its
    host enqueue."""
    fn()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def kernel_ms(fn, reps: int) -> tuple:
    """(the wrapper's ms a call: the median of CUDA events around the call,
    the host's Python included; the device ms a call of the kernels ``fn``
    launches, from torch.profiler; text giving both). Where the profiler
    records no launch and a call takes over 1 ms (so that its host enqueue,
    ~0.05 ms, is a small part), the device ms is that of back-to-back calls
    between CUDA events; below that it is None."""
    wrapper = median_ms(fn, reps)
    dev = device_us(fn, reps)
    if not dev:
        if wrapper < 1.0:
            return wrapper, None, f"{wrapper:.4f} ms (device time not measured)"
        ms = back_to_back_ms(fn, reps)
        return wrapper, ms, (f"{wrapper:.4f} ms (device {ms:.4f} ms, back-to-back CUDA events: "
                             "the profiler recorded no launch)")
    ms = sum(dev.values()) / 1e3
    return wrapper, ms, f"{wrapper:.4f} ms (device {ms:.4f} ms)"


def perturbed_params(d, hidden, n_layers, seed, device):
    from nfmc_torch.flows import Flow, RealNVP

    flow = Flow(RealNVP((d,), n_layers=n_layers, hidden_size=hidden), seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    params = [{k: [t + PERTURB * torch.randn(t.shape, generator=g) for t in v]
               for k, v in p.items()} for p in flow.params]
    return [{k: [t.to(device) for t in v] for k, v in p.items()} for p in params]


def spline_params(kind, d, hidden, n_layers, n_bins, seed, device):
    """A spline flow's weights, PERTURB N(0, 1) away from its identity init."""
    from nfmc_torch.flows import CouplingLRS, CouplingRQNSF, Flow

    cls = CouplingRQNSF if kind == "rqs" else CouplingLRS
    flow = Flow(cls((d,), n_layers=n_layers, hidden_size=hidden, n_bins=n_bins), seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    return [{k: [(t + PERTURB * torch.randn(t.shape, generator=g)).to(device) for t in v]
             for k, v in p.items()} for p in flow.params]


def self_target_params(kind, d=D, hidden=H, n_layers=L, n_bins=N_BINS, seed=SELF_SEED,
                       pert=SELF_PERTURB):
    """The self-target flow's weights from a numpy seed alone, as float32
    arrays in the canonical layout (per layer ``{"w": [w1, w2, w3], "b":
    [b1, b2, b3]}``, ``w`` (in, out)): He-initialised hidden layers and a
    zero output layer (the identity), then every array moved by pert N(0,
    1). ``kind`` is "rqs", "lrs" or "realnvp" (a shift and a log-scale a
    transformed dim). ``scripts/warmup_reference_cpu.py --self-target`` and
    ``scripts/flow_samplers_reference_cpu.py`` load the same arrays into
    both packages."""
    from nfmc_torch.flows.spline import n_params_per_dim

    rng = np.random.default_rng(seed)
    n_par = 2 if kind == "realnvp" else n_params_per_dim(kind, n_bins)
    params = []
    for l in range(n_layers):
        da = (d + 1) // 2 if l % 2 == 0 else d // 2
        sizes = [da, hidden, hidden, n_par * (d - da)]
        ws = [rng.standard_normal(sizes[i:i + 2]) * np.sqrt(2.0 / sizes[i]) if i < 2
              else np.zeros(sizes[i:i + 2]) for i in range(3)]
        bs = [np.zeros(sizes[i + 1]) for i in range(3)]
        params.append({k: [(a + pert * rng.standard_normal(a.shape)).astype(np.float32)
                           for a in v] for k, v in (("w", ws), ("b", bs))})
    return params


def stack_cost(d, hidden, n_layers, rows, backward=False, n_par=2):
    """(FLOPs of the conditioner products, bytes of input and output), with
    n_par conditioner outputs per transformed dim (2 for the affine
    coupling, 3K - 1 or 4K - 1 for the splines). The splines' elementwise
    work (tens of FLOP per element and K exponentials, against the
    conditioner's 2 H P FLOP) is left out.

    Forward: x read, y and log-det written, the weights read. Backward: the
    forward recomputed, then per row the three products with the transposed
    weights and the three weight-gradient products, 3x the forward's FLOPs;
    x, gy and gld read, gx written, the weights read and their gradients
    written."""
    flops, n_weights = 0, 0
    for l in range(n_layers):
        da = (d + 1) // 2 if l % 2 == 0 else d // 2
        db = d - da
        flops += 2 * (da * hidden + hidden * hidden + hidden * n_par * db)
        n_weights += (da * hidden + hidden + hidden * hidden + hidden + hidden * n_par * db
                      + n_par * db)
    if backward:
        return 3 * rows * flops, 4 * (3 * rows * d + rows + 2 * n_weights)
    return rows * flops, 4 * (2 * rows * d + rows + n_weights)


def bound(flops, nbytes):
    """(least ms on the card, what bounds it) at the published peaks."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def flat_params(params):
    return torch.cat([t.detach().reshape(-1).cpu() for p in params for v in p.values() for t in v])


def packed_flat(params):
    """The weights flat on the CPU in the kernels' packed order, the order
    of a training step's flat gradient."""
    from nfmc_torch.utils import tree_leaves

    return torch.cat([t.detach().reshape(-1).cpu() for t in tree_leaves(params)])


class RecordingNumpy:
    """numpy, except that ``isfinite`` records the 1-d arrays it is given:
    ``Flow.fit`` tests each block's per-epoch validation losses with it."""

    def __init__(self):
        self.seen = []

    def __getattr__(self, name):
        return getattr(np, name)

    def isfinite(self, a):
        if np.ndim(a) == 1:
            self.seen.append(np.array(a))
        return np.isfinite(a)


class Instrument:
    """For the duration of a ``with`` block: wall time (ending in a
    synchronise) of the inner sampler's warmup, of ``Flow.fit`` and of
    ``Flow.variational_fit``, the epochs and optimizer steps of flow
    training (a variational epoch is one step), and the inner sampler. The
    steps and epochs are ``flows.train.COUNTS``'s, which a replayed fit
    advances by what its capture recorded: a replay runs no Python."""

    def __enter__(self):
        from nfmc_torch.flows import base as flow_base
        from nfmc_torch.flows import train as train_mod
        from nfmc_torch.samplers.mcmc.base import MCMCSampler

        self.inner_s = self.fit_s = self.vfit_s = 0.0
        self.inner = None
        self._counts, self._start, self._end = train_mod.COUNTS, dict(train_mod.COUNTS), None
        self._orig = [(MCMCSampler, "warmup", MCMCSampler.warmup),
                      (flow_base.Flow, "fit", flow_base.Flow.fit),
                      (flow_base.Flow, "variational_fit", flow_base.Flow.variational_fit)]
        rec = self

        self.x_train = self.x_val = None

        def timed(fn, attr):
            def wrapper(*a, **k):
                if attr == "inner_s":
                    rec.inner = a[0]
                if attr == "fit_s":
                    rec.x_train, rec.x_val = a[1], k.get("x_val")
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    torch.cuda.synchronize()
                    setattr(rec, attr, getattr(rec, attr) + time.perf_counter() - t0)
            return wrapper

        MCMCSampler.warmup = timed(MCMCSampler.warmup, "inner_s")
        flow_base.Flow.fit = timed(flow_base.Flow.fit, "fit_s")
        flow_base.Flow.variational_fit = timed(flow_base.Flow.variational_fit, "vfit_s")
        return self

    def _count(self, name):
        return (self._end or self._counts)[name] - self._start[name]

    @property
    def epochs(self):
        return self._count("epochs")

    @property
    def steps(self):
        return self._count("steps")

    @property
    def vfit_epochs(self):
        return self._count("variational_steps")

    def __exit__(self, *exc):
        self._end = dict(self._counts)
        for owner, name, fn in self._orig:
            setattr(owner, name, fn)


class ShapeLaunches:
    """For the duration of a ``with`` block: the kernels' launches by
    (kernel, direction, rows), e.g. ``("vjp", "inverse", 128)``, with the
    kernel "stack" or "vjp" for RealNVP and "rqs", "lrs", "rqs vjp" or "lrs
    vjp" for the spline flows (a listener of ``build.count_launch``, so a
    graph's replays count as the launches they make); the wrappers' own
    counts go on as before."""

    def __enter__(self):
        from nfmc_torch.ops import build

        self.n = collections.Counter()

        def listen(_wrapper, key, n):
            kernel, direction, _d, _hid, _nl, rows = key
            self.n[kernel, direction, rows] += n

        self._listener = listen
        build.LISTENERS.append(listen)
        return self

    def __exit__(self, *exc):
        from nfmc_torch.ops import build

        build.LISTENERS.remove(self._listener)


class RefitRecorder:
    """For the duration of a ``with`` block, the fits that ``module``'s
    ``make_scan_fit`` makes record their first and their last call made
    from the host (a call under a capture is a graph's, whose replays run
    no Python): the weights, the data and the rows (the permutations) each
    was given, and the fitted weights (``packed_flat``)."""

    def __init__(self, module):
        self.module, self.first, self.last, self.n = module, None, None, 0

    def __enter__(self):
        self._orig = make = self.module.make_scan_fit

        def factory(*a, **k):
            fit = make(*a, **k)

            def recording(params, data, generator=None, rows=None):
                if torch.cuda.is_current_stream_capturing():
                    return fit(params, data, generator, rows)
                if rows is None:
                    rows = fit.draw(generator)
                inputs = ([{k_: [t.detach().clone() for t in v] for k_, v in p.items()}
                           for p in params], data.clone(), [r.clone() for r in rows])
                out = fit(params, data, rows=rows)
                self.last = (*inputs, packed_flat(out))
                self.first = self.first or self.last
                self.n += 1
                return out

            for attr in ("draw", "draws", "row_elems", "config"):
                setattr(recording, attr, getattr(fit, attr))
            return recording

        self.module.make_scan_fit = factory
        return self

    def __exit__(self, *exc):
        self.module.make_scan_fit = self._orig


def cpu_shuffled(scan_fit, seed: int):
    """A ``make_scan_fit(..., shuffle=False)`` fit whose data is shuffled by
    permutations drawn on the CPU from ``seed``, whatever the data's device:
    the same refits on the card and on the CPU (eagerly: the permutation is
    drawn at the call)."""
    g = torch.Generator().manual_seed(seed)

    def fit(params, data, generator=None, rows=None):
        return scan_fit(params, data[torch.randperm(data.shape[0], generator=g).to(data.device)],
                        rows=rows)

    fit.draw, fit.draws = scan_fit.draw, scan_fit.draws
    return fit


def flat_grad(flow, params, x, dtype=torch.float32) -> torch.Tensor:
    """The MLE loss's gradient in the flat weights (the refit's Adam step's
    gradient), in ``dtype``, on ``x``'s device."""
    from nfmc_torch.flows import train as train_mod
    from nfmc_torch.ops.coupling import unpack_like
    from nfmc_torch.utils import tree_leaves

    th = torch.cat([t.detach().reshape(-1) for t in tree_leaves(params)]).to(dtype)
    th.requires_grad_(True)
    loss = train_mod._nll(flow, unpack_like(th, params), x.to(dtype))
    return torch.autograd.grad(loss, th)[0].detach()


def device_busy_us(events) -> float:
    """The time, in us, in which the device ran at least one of the kernels,
    copies or sets of a torch.profiler trace's raw events
    (``trace_events``): the union of their intervals."""
    from torch.autograd import DeviceType

    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.start_ns(), e.end_ns()) for e in events
                       if e.device_type() == DeviceType.CUDA):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e3


def trace_events(prof) -> list:
    """A torch.profiler trace's raw (kineto) events. torch builds its
    ``events()`` / ``key_averages()`` tree from these lazily, in Python, at
    0.5-1 ms an event (seconds for a window of 10^4 launches); read raw they
    cost well under a second."""
    return list(prof.profiler.kineto_results.events())


def profile_window(run, what: str) -> None:
    """Device busy share of ``run()`` (a short run of a path through the
    front door, profiled after a warm call with torch.profiler): the union
    of the device's kernel intervals over the host's wall time, the kernel
    launches, and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = trace_events(prof)
    device_s = device_busy_us(events) / 1e6
    if device_s == 0:
        print(f"profile ({what}): wall {wall:.3f} s, device time not measured")
        return
    per_kernel = collections.defaultdict(lambda: [0, 0])
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            per_kernel[e.name()][0] += e.duration_ns()
            per_kernel[e.name()][1] += 1
    launches = sum(e.name() in HOST_LAUNCHES for e in events)
    replays = sum(e.name() in GRAPH_LAUNCHES for e in events)
    print(f"profile ({what}): wall {wall:.3f} s, device busy {device_s:.3f} s "
          f"({100 * device_s / wall:.1f}%; the kernels' device times summed "
          f"{sum(v[0] for v in per_kernel.values()) / 1e9:.3f} s), {launches} kernel launches, "
          f"{replays} graph launches")
    for key, (ns, n) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"  {key[:60]:60s} device {ns / 1e6:9.2f} ms  calls {n}")


def ess_per_second(out, wall: float, max_window: int, what: str, transform=None) -> float:
    """The mean over the dims of the ESS (summed over chains) of ``out``'s
    stored draws, computed where they are stored, on the card (``dim_slab``
    25, as bench.py), over ``wall``; printed with the window's extrapolation
    factor. ``transform`` maps the stored draws first (NeuTra's latent draws
    to the data space, its ``data_transform``)."""
    from nfmc_torch.diagnostics import effective_sample_size

    draws = out.samples
    dev = draws.device
    check(dev.type == "cuda", f"{what}: the draws are not on the card")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if transform is not None:
        draws = transform(draws.reshape(-1, *draws.shape[2:])).reshape(draws.shape)
    ess = effective_sample_size(draws.reshape(*draws.shape[:2], -1), max_window=max_window,
                                dim_slab=25)
    factor = draws.shape[0] / min(max_window, draws.shape[0])
    ess_mean = float(ess.mean())
    check(ess.device == dev and bool(torch.isfinite(ess).all()) and ess_mean > 0,
          f"{what}: bad ESS")
    print(f"{what}: ESS mean {ess_mean:.1f} min {float(ess.min()):.1f} over "
          f"{out.samples.shape[0]} x {out.samples.shape[1]} draws (window {max_window}, "
          f"extrapolation factor {factor:.4f}), {ess_mean / wall:.1f} ESS/s over the "
          f"{wall:.3f} s wall (the ESS itself took {time.perf_counter() - t0:.3f} s)")
    return ess_mean / wall


def run_spline_phases(dev, g) -> dict:
    """Phases 7-8c: the spline kernels against their plain versions, the
    card-vs-CPU fit, and the slice's paths through the front door. Returns
    the kernels' errors, timings and the main path's launch counts."""
    import nfmc_torch
    from nfmc_torch.flows import CouplingLRS, CouplingRQNSF, Flow
    from nfmc_torch.flows import train as train_mod
    from nfmc_torch.flows.spline import n_params_per_dim
    from nfmc_torch.ops import build
    from nfmc_torch.ops import coupling as cops
    from nfmc_torch.ops import spline as sops
    from nfmc_torch.potentials import CallablePotential, DiagonalGaussian, StandardGaussian

    classes = {"rqs": CouplingRQNSF, "lrs": CouplingLRS}
    out = {"fwd_err": {}, "fwd_timing": {}, "bwd_err": {}, "bwd_timing": {}, "launches": {}}

    # ---- 7. spline forward kernel vs plain ------------------------------------
    for kind in SPLINE_FLOWS:
        out["fwd_err"][kind] = 0.0
        for d, hid, nl, nb, rows in [(D, H, L, N_BINS, C), (D, H, L, N_BINS, 256),
                                     (D, H, L, N_BINS, 3000), (D, H, L, N_BINS, 500 * C),
                                     (7, 16, 3, 4, 37)]:
            params = spline_params(kind, d, hid, nl, nb, seed=d + rows, device=dev)
            packed = cops.pack_weights(params)
            x = 3 * torch.randn((rows, d), generator=g, device=dev)
            for inverse in (False, True):
                wrapper = getattr(sops, f"fused_{kind}_{'inverse' if inverse else 'forward'}")
                y, ld = wrapper(params, x, nb, TAIL, packed=packed)
                torch.cuda.synchronize()
                y_ref, ld_ref = sops.spline_stack_plain(params, x, kind, nb, TAIL, inverse)
                check(bool(torch.isfinite(y).all() and torch.isfinite(ld).all()),
                      "non-finite spline kernel output")
                e = max((y - y_ref).abs().max().item(), (ld - ld_ref).abs().max().item())
                scale = max(1.0, y_ref.abs().max().item(), ld_ref.abs().max().item())
                out["fwd_err"][kind] = max(out["fwd_err"][kind], e)
                reps = 20 if rows <= 3000 else 5
                k_ms, k_dev, k_txt = kernel_ms(lambda: wrapper(params, x, nb, TAIL, packed=packed), reps)
                p_ms = median_ms(lambda: sops.spline_stack_plain(params, x, kind, nb, TAIL,
                                                                 inverse), reps)
                bound_ms, bound_by = bound(*stack_cost(d, hid, nl, rows,
                                                       n_par=n_params_per_dim(kind, nb)))
                out["fwd_timing"][(kind, rows, inverse)] = (k_ms, k_dev, p_ms, bound_ms, bound_by, e)
                print(f"spline {kind} {'inverse' if inverse else 'forward'} d={d} H={hid} L={nl} "
                      f"K={nb} B={rows}: max|diff| {e:.3e} (scale {scale:.2f}), kernel {k_txt}, "
                      f"plain {p_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
                check(e <= TOL * scale, f"spline kernel disagrees with the plain version: "
                                        f"{e} > {TOL} * {scale}")

    # ---- 7b. spline backward kernel vs plain -------------------------------------
    for kind in SPLINE_FLOWS:
        out["bwd_err"][kind] = 0.0
        for d, hid, nl, nb, rows in [(D, H, L, N_BINS, 256), (D, H, L, N_BINS, C),
                                     (D, H, L, N_BINS, 1001), (D, H, L, N_BINS, 3000),
                                     (7, 16, 3, 4, 37)]:
            params = spline_params(kind, d, hid, nl, nb, seed=d + rows + 1, device=dev)
            packed = cops.pack_weights(params)
            x = 3 * torch.randn((rows, d), generator=g, device=dev)
            gy = torch.randn((rows, d), generator=g, device=dev)
            gld = torch.randn((rows,), generator=g, device=dev)
            for inverse in (False, True):
                def vjp(keep=None, inverse=inverse, params=params, packed=packed, x=x, gy=gy,
                        gld=gld, kind=kind, nb=nb):
                    return sops.fused_spline_vjp(params, x, *masked(gy, gld, keep), kind, nb, TAIL,
                                                 inverse, packed=packed)

                def plain(keep=None, inverse=inverse, params=params, x=x, gy=gy, gld=gld,
                          kind=kind, nb=nb):
                    return sops.spline_stack_vjp_plain(params, x, *masked(gy, gld, keep), kind, nb,
                                                       TAIL, inverse)

                what = (f"spline vjp {kind} {'inverse' if inverse else 'forward'} d={d} H={hid} "
                        f"L={nl} K={nb} B={rows}")
                rel, scale = check_vjp(what, vjp, plain(), SPLINE_BWD_TOL,
                                       (lambda keep, vjp=vjp, plain=plain: (vjp(keep), plain(keep)),
                                        params, x, kind, nb, inverse))
                out["bwd_err"][kind] = max(out["bwd_err"][kind], rel * scale)
                # timed: the fit's batch of 256, and B=100 in both directions
                # (NeuTra-HMC's gradient passes through a spline flow, 11b)
                if d == D and (rows == 256 and not inverse or rows == C):
                    k_ms, k_dev, k_txt = kernel_ms(vjp, 30)
                    p_ms = median_ms(plain, 10)
                    bound_ms, bound_by = bound(*stack_cost(
                        d, hid, nl, rows, backward=True, n_par=n_params_per_dim(kind, nb)))
                    out["bwd_timing"][(kind, rows, inverse)] = (k_ms, k_dev, p_ms, bound_ms,
                                                                bound_by, rel * scale)
                    print(f"{what}: kernel {k_txt}, plain {p_ms:.4f} ms, bound {bound_ms:.5f} ms "
                          f"({bound_by})")

    # ---- 7c. Flow.fit of each spline flow, card vs CPU -----------------------------
    rng = np.random.default_rng(7)
    x_fit = (1.3 * rng.standard_normal((70, 6)) + 0.5).astype(np.float32)
    x_fit_val = (1.3 * rng.standard_normal((30, 6)) + 0.5).astype(np.float32)
    orig_np = train_mod.np
    for kind, cls in classes.items():
        fits = {}
        try:
            for device in ("cpu", "cuda"):
                flow = Flow(cls((6,), n_layers=2, hidden_size=16), seed=0)
                flow.params = spline_params(kind, 6, 16, 2, N_BINS, seed=9, device=device)
                train_mod.np = rec = RecordingNumpy()
                flow.fit(x_fit, x_val=x_fit_val, shuffle=False, early_stopping=False, n_epochs=5,
                         batch_size=16, seed=0)
                fits[device] = (flat_params(flow.params), np.concatenate(rec.seen))
        finally:
            train_mod.np = orig_np
        e_w = (fits["cpu"][0] - fits["cuda"][0]).abs().max().item()
        e_vl = float(np.max(np.abs(fits["cpu"][1] - fits["cuda"][1])))
        print(f"{SPLINE_FLOWS[kind]} Flow.fit card vs CPU (d=6, 70 rows at batch 16, 5 epochs): "
              f"weights max|diff| {e_w:.3e}, per-epoch val loss max|diff| {e_vl:.3e} "
              f"(val losses {np.round(fits['cuda'][1], 5).tolist()})")
        check(len(fits["cuda"][1]) == 5 and e_w <= TOL and e_vl <= TOL,
              f"{SPLINE_FLOWS[kind]}: Flow.fit on the card disagrees with the CPU fit")

    def dsl(kind):
        return f'{SPLINE_FLOWS[kind]}%{{"n_layers": {L}, "hidden_size": {H}, "n_bins": {N_BINS}}}'

    # ---- 8. the slice's path: warmup=True through the front door ------------------
    warm_outer = 500
    for kind, cls in classes.items():
        fwd, inv = f"fused_{kind}_forward", f"fused_{kind}_inverse"
        build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with Instrument() as ins:
            wout = nfmc_torch.sample(
                StandardGaussian((D,)), strategy="jump_mala", flow=dsl(kind), n_chains=C,
                n_iterations=warm_outer, inner_param_kwargs={"n_iterations": INNER_N},
                warmup=True, seed=0, show_progress=False)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        nl_ = {w.__name__: w.launches for w in build.WRAPPERS}
        out["launches"][kind] = nl_
        wst = wout.statistics
        flow = wout.kernel.flow
        check(type(flow.bijection) is cls, f"{dsl(kind)} built {type(flow.bijection).__name__}")
        identity = Flow(cls((D,), n_layers=L, hidden_size=H, n_bins=N_BINS), seed=0).to(dev)
        nll = {}
        for part, rows in (("train", ins.x_train), ("validation", ins.x_val)):
            rows = torch.as_tensor(np.asarray(rows), device=dev)
            nll[part] = (-flow.log_prob(rows).mean().item(), -identity.log_prob(rows).mean().item(),
                         len(rows))
        jacc_w, macc_w = wst.jump_acceptance_rate, wst.acceptance_rate
        print(f"{SPLINE_FLOWS[kind]} with warmup ({warm_outer} outer it): wall {wall:.3f} s, of "
              f"which inner tuning {ins.inner_s:.3f} s and flow fit {ins.fit_s:.3f} s; fit "
              f"{ins.epochs} epochs, {ins.steps} optimizer steps; launches {nl_}; NLL fitted vs "
              f"identity: " + ", ".join(f"{k} ({v[2]} rows) {v[0]:.4f} vs {v[1]:.4f}"
                                        for k, v in nll.items()))
        print(f"{SPLINE_FLOWS[kind]} with warmup: jump acc {jacc_w:.4f} (JAX package, CPU: "
              f"0.0000-0.0002), MALA acc {macc_w:.4f}, max|mean| {np.abs(wout.mean).max():.4f}, "
              f"max|E[x^2]-1| {np.abs(wout.second_moment - 1).max():.4f}")
        check(ins.steps > 0 and nl_["fused_spline_vjp"] == ins.steps,
              "spline backward launches != optimizer steps")
        check(nl_[fwd] == ins.steps + ins.epochs + warm_outer,
              "spline forward launches != training steps + validation epochs + jumps")
        check(nl_[inv] == 1, "spline proposals not in one inverse launch")
        check(all(v == 0 for k, v in nl_.items() if k not in (fwd, inv, "fused_spline_vjp")),
              f"another kernel ran on the {SPLINE_FLOWS[kind]} path: {nl_}")
        check(tuple(wout.samples.shape) == (warm_outer * (INNER_N + 1), C, D), "bad sample shape")
        check(bool(torch.isfinite(wout.samples).all()), "non-finite samples")
        check(wst.n_target_calls == warm_outer * (INNER_N * 2 * C + 2 * C), "target-call counter law")
        check(wst.n_target_gradient_calls == warm_outer * INNER_N * 2 * C, "gradient counter law")
        check(wst.n_attempted_jumps == warm_outer * C, "attempted-jump counter law")
        check(np.abs(wout.mean).max() < 0.05 and np.abs(wout.second_moment - 1).max() < 0.1,
              "moments after warmup are off N(0, I)")
        check(WARM_MALA_ACC[0] <= macc_w <= WARM_MALA_ACC[1],
              f"warmup MALA acceptance {macc_w} outside {WARM_MALA_ACC}")
        # the fit learned its training rows; on the validation rows it is
        # worse than the identity in both packages (it overfits: PERF.md),
        # which is why the jump acceptance is ~0
        check(nll["train"][0] < nll["train"][1],
              "the fitted spline flow's training NLL is not below the identity's")
        check(jacc_w <= 0.01, f"jump acceptance {jacc_w} after the spline fit above 0.01")

    # ---- 8b. misfit with a frozen identity-init spline flow --------------------------
    mu = 0.12
    for kind, cls in classes.items():
        build.reset_launch_counts()
        t0 = time.perf_counter()
        mis = nfmc_torch.sample(
            DiagonalGaussian(np.full(D, mu, np.float32), np.float32(1.0)), strategy="jump_mala",
            flow=Flow(cls((D,), n_layers=L, hidden_size=H, n_bins=N_BINS), seed=0),
            n_chains=C, n_iterations=SPLINE_MISFIT_OUTER,
            inner_param_kwargs={"n_iterations": INNER_N},
            param_kwargs={"store_samples_on_device": True}, seed=0, show_progress=False)
        nl_ = {w.__name__: w.launches for w in build.WRAPPERS}
        jacc = mis.statistics.jump_acceptance_rate
        print(f"{SPLINE_FLOWS[kind]} misfit N({mu}*1, I): jump acc {jacc:.4f} (JAX package, CPU: "
              f"0.3929), MALA acc {mis.statistics.acceptance_rate:.4f}, launches {nl_}, wall "
              f"{time.perf_counter() - t0:.3f} s")
        check(0.30 <= jacc <= 0.50, f"spline misfit jump acceptance {jacc} outside [0.30, 0.50]")
        check(nl_[f"fused_{kind}_forward"] == SPLINE_MISFIT_OUTER,
              "spline misfit: one forward launch per jump")
        check(nl_[f"fused_{kind}_inverse"] == 1, "spline misfit: proposals not in one launch")

    # ---- 8c. self-target: the flow is the proposal and the target ---------------------
    from nfmc_torch.flows import from_jax_params

    self_outer = 100
    for kind, cls in classes.items():
        flow = Flow(cls((D,), n_layers=L, hidden_size=H, n_bins=N_BINS))
        flow.params = from_jax_params(self_target_params(kind), device=dev)
        frozen = flow.params  # the sampler leaves a flow it does not fit as it is
        # counted on the device, so that a graph's replays count their passes
        grad_passes = torch.zeros((), dtype=torch.int64, device=dev)

        def u(x, flow=flow, frozen=frozen, passes=grad_passes):
            if x.requires_grad and torch.is_grad_enabled():
                passes.add_(1)
            return -flow.log_prob_fn(frozen, x)

        build.reset_launch_counts()
        t0 = time.perf_counter()
        sout = nfmc_torch.sample(
            CallablePotential(u, (D,)), strategy="jump_mala", flow=flow, n_chains=C,
            n_iterations=self_outer, inner_param_kwargs={"n_iterations": INNER_N},
            param_kwargs={"store_samples_on_device": True}, seed=0, show_progress=False)
        torch.cuda.synchronize()
        nl_ = {w.__name__: w.launches for w in build.WRAPPERS}
        sst = sout.statistics
        print(f"{SPLINE_FLOWS[kind]} self-target (perturbation {SELF_PERTURB}, {self_outer} outer "
              f"it): jump acc {sst.jump_acceptance_rate:.4f}, MALA acc {sst.acceptance_rate:.4f} "
              f"(JAX package, CPU: RQS 0.132, LRS 0.0955), gradient passes {int(grad_passes)}, "
              f"launches {nl_}, wall {time.perf_counter() - t0:.3f} s")
        check(bool(torch.isfinite(sout.samples).all()), "self-target: non-finite samples")
        check(sst.jump_acceptance_rate >= 0.99,
              f"self-target jump acceptance {sst.jump_acceptance_rate} < 0.99: the kernels' "
              "forward, inverse and log-det disagree")
        check(SELF_MALA_ACC[0] <= sst.acceptance_rate <= SELF_MALA_ACC[1],
              f"self-target MALA acceptance {sst.acceptance_rate} outside {SELF_MALA_ACC}")
        check(int(grad_passes) > 0 and nl_["fused_spline_vjp"] == int(grad_passes),
              "self-target: backward launches != the sampler's gradient passes")
    return out


def masked(gy, gld, keep):
    """The cotangents with the rows where ``keep`` is False set to zero."""
    return (gy, gld) if keep is None else (gy * keep[:, None], gld * keep)


def check_vjp(what, vjp, ref, tol, spline=None) -> tuple:
    """Run ``vjp()`` twice, hold it to ``ref`` (gx, grads) within tol *
    max(1, max|ref|) and the rerun to bit-identity; returns the relative
    error and its scale. A spline VJP passes ``spline = (rerun, params, x,
    kind, n_bins, inverse)`` and is held to the spline rule
    (``ops.spline.compare_spline_vjp``): where it misses the gate, the rows
    with an element within float32 drift of a branch point of its spline
    are left out, ``rerun(keep)`` giving (the kernel's VJP, the reference's)
    with their cotangents zero; every row off the gate must be one of them."""
    from nfmc_torch.ops import coupling as cops
    from nfmc_torch.ops import spline as sops
    from nfmc_torch.utils import tree_leaves

    got, again = vjp(), vjp()
    torch.cuda.synchronize()
    same = torch.equal(got[0], again[0]) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(got[1]), tree_leaves(again[1])))
    if spline is None:
        rel, scale, rows = cops.vjp_error(got, ref)
        text = (f"max|diff| {rel * scale:.3e} (scale max(1, max|ref|) = {scale:.2f}, relative "
                f"{rel:.2e}), rows of gx off the gate {int((rows > tol * scale).sum())}")
    else:
        rerun, params, x, kind, n_bins, inverse = spline
        rel, scale, text = sops.compare_spline_vjp(got, ref, rerun, params, x, kind, n_bins,
                                                   TAIL, inverse, tol)
    print(f"{what}: {text}, bit-identical rerun {same}")
    check(rel <= tol, f"{what} disagrees with the plain version (or is not finite): relative "
                      f"{rel} > {tol}")
    check(same, f"{what}: two launches gave different gradients")
    return rel, scale


def run_wide_realnvp(dev, g) -> None:
    """Phase 3c: RealNVP at d=3000 and 3500, H=128 (a ring of 2 stages),
    both directions and the VJP, against the plain version."""
    from nfmc_torch.ops import coupling as ops

    for d, rows in ((3000, 300), (3500, 100)):
        params = perturbed_params(d, H, 2, seed=d, device=dev)
        x, gy = (torch.randn((rows, d), generator=g, device=dev) for _ in range(2))
        gld = torch.randn((rows,), generator=g, device=dev)
        for inverse in (False, True):
            wrapper = ops.fused_realnvp_inverse if inverse else ops.fused_realnvp_forward
            y, ld = wrapper(params, x, 3.0)
            y_ref, ld_ref = ops.realnvp_stack_plain(params, x, 3.0, inverse)
            torch.cuda.synchronize()
            e = max((y - y_ref).abs().max().item(), (ld - ld_ref).abs().max().item())
            scale = max(1.0, ld_ref.abs().max().item())
            print(f"wide coupling {'inverse' if inverse else 'forward'} d={d} H={H} L=2 B={rows}: "
                  f"max|diff| {e:.3e} (max|ld| {ld_ref.abs().max().item():.2f})")
            check(e <= TOL * scale, f"wide coupling kernel disagrees: {e} > {TOL} * {scale}")
            check_vjp(f"wide coupling vjp {'inverse' if inverse else 'forward'} d={d} B={rows}",
                      lambda: ops.fused_realnvp_vjp(params, x, gy, gld, 3.0, inverse),
                      ops.realnvp_stack_vjp_plain(params, x, gy, gld, 3.0, inverse), TOL)


def run_wide_spline(dev, g) -> None:
    """Phase 7d: c-rqnsf and c-lrsnsf at d=784 (a 28 x 28 image target) and
    1024, H=128, L=4, K=8: forward, inverse and VJP against the plain
    version; then a stack above the kernels' width limit, refused before
    the launch with its bytes."""
    from nfmc_torch.flows import CouplingRQNSF, Flow
    from nfmc_torch.ops import build
    from nfmc_torch.ops import coupling as cops
    from nfmc_torch.ops import spline as sops

    for kind in SPLINE_FLOWS:
        for d, rows in ((784, 300), (1024, 40)):
            params = spline_params(kind, d, H, L, N_BINS, seed=d, device=dev)
            x = 3 * torch.randn((rows, d), generator=g, device=dev)
            gy = torch.randn((rows, d), generator=g, device=dev)
            gld = torch.randn((rows,), generator=g, device=dev)
            for inverse in (False, True):
                wrapper = getattr(sops, f"fused_{kind}_{'inverse' if inverse else 'forward'}")
                y, ld = wrapper(params, x, N_BINS, TAIL)
                y_ref, ld_ref = sops.spline_stack_plain(params, x, kind, N_BINS, TAIL, inverse)
                torch.cuda.synchronize()
                e = max((y - y_ref).abs().max().item(), (ld - ld_ref).abs().max().item())
                scale = max(1.0, y_ref.abs().max().item(), ld_ref.abs().max().item())
                print(f"wide spline {kind} {'inverse' if inverse else 'forward'} d={d} H={H} L={L} "
                      f"K={N_BINS} B={rows}: max|diff| {e:.3e} (scale {scale:.2f})")
                check(e <= TOL * scale, f"wide spline kernel disagrees: {e} > {TOL} * {scale}")
                # the plain VJP in float64: its float32 run differs from it by
                # more than the gate at d=784 (printed below; PERF.md)
                p64 = [{k: [t.double() for t in v] for k, v in p.items()} for p in params]

                def vjp(keep=None, inverse=inverse, params=params, x=x, gy=gy, gld=gld):
                    return sops.fused_spline_vjp(params, x, *masked(gy, gld, keep), kind, N_BINS,
                                                 TAIL, inverse)

                def plain64(keep=None, inverse=inverse, p64=p64, x=x, gy=gy, gld=gld):
                    return sops.spline_stack_vjp_plain(p64, x.double(), *masked(gy.double(),
                                                                               gld.double(), keep),
                                                       kind, N_BINS, TAIL, inverse)

                ref = plain64()
                f32 = sops.spline_stack_vjp_plain(params, x, gy, gld, kind, N_BINS, TAIL, inverse)
                e32, scale, rows32 = cops.vjp_error(f32, ref)
                n_off = int((rows32 > SPLINE_BWD_TOL * scale).sum())
                print(f"wide spline plain vjp {kind} {'inverse' if inverse else 'forward'} d={d} "
                      f"B={rows}: float32 against float64 max|diff| {e32 * scale:.3e} (relative "
                      f"{e32:.2e}, rows of gx off the gate {n_off})")
                check_vjp(f"wide spline vjp {kind} {'inverse' if inverse else 'forward'} d={d} "
                          f"B={rows} (against the float64 plain version)", vjp, ref,
                          SPLINE_BWD_TOL, (lambda keep, vjp=vjp, plain64=plain64: (vjp(keep),
                                                                                 plain64(keep)),
                                           params, x, kind, N_BINS, inverse))
    d = 2800  # above the smallest tile's limit at H=128 (d = 2713)
    flow = Flow(CouplingRQNSF((d,), n_layers=1, hidden_size=H, n_bins=N_BINS), seed=0).to(dev)
    build.reset_launch_counts()
    try:
        flow.bijection.forward(torch.randn((2, d), device=dev))
        fail(f"a spline stack at d={d} was not refused")
    except ValueError as e:
        print(f"wide spline d={d}: refused: {e}")
        check(bool(re.search(r"needs \d+ bytes of shared memory", str(e))),
              "the refusal does not name the bytes")
    check(all(w.launches == 0 for w in build.WRAPPERS), "the refused stack counted a launch")


def run_fault_checks(dev) -> None:
    """Phase 9: the port's repaired faults on the card. Strided rows reach
    the kernels as contiguous rows; a flow whose conditioners have 3 hidden
    layers runs the plain stack (no kernel launch) while a depth-2 flow
    launches; the statistics fold CUDA draws in as the JAX package does."""
    from nfmc_torch.core.statistics import MCMCStatistics
    from nfmc_torch.flows import CouplingRQNSF, Flow, RealNVP
    from nfmc_torch.ops import build

    big = torch.randn((C, D + 30), device=dev, generator=torch.Generator(dev).manual_seed(5))
    view = big[:, :D]
    for cls in (RealNVP, CouplingRQNSF):
        flow = Flow(cls((D,), n_layers=L, hidden_size=H), seed=0).to(dev)
        flow.params = [{k: [t + 0.01 for t in v] for k, v in p.items()} for p in flow.params]
        same = torch.equal(flow.log_prob(view), flow.log_prob(view.contiguous()))
        print(f"{cls.__name__}: log_prob of a column slice (strided) equals the contiguous rows': "
              f"{same}")
        check(same, f"{cls.__name__}: a strided input gave another log_prob")
        for depth, want_launches in ((3, False), (2, True)):
            f = Flow(cls((D,), n_layers=L, hidden_size=H, n_hidden_layers=depth), seed=0).to(dev)
            build.reset_launch_counts()
            lp = f.log_prob(view)
            z = f.sample(C, seed=0)
            torch.cuda.synchronize()
            n = sum(w.launches for w in build.WRAPPERS)
            print(f"{cls.__name__} with {depth} hidden layers on the card: {n} kernel launches, "
                  f"finite {bool(torch.isfinite(lp).all() and torch.isfinite(z).all())}")
            check(bool(torch.isfinite(lp).all() and torch.isfinite(z).all()),
                  f"{cls.__name__} depth {depth}: non-finite output")
            check((n > 0) == want_launches, f"{cls.__name__} depth {depth}: {n} kernel launches")
    draws = torch.randn((3, C, D), device=dev, generator=torch.Generator(dev).manual_seed(6))
    st = MCMCStatistics((D,), data_transform=lambda v: 2 * v)
    st.expectations.update(draws)
    want = (2 * draws.double()).mean((0, 1)).cpu().numpy()
    e = float(np.abs(st.running_first_moment - want).max())
    print(f"MCMCStatistics.expectations.update on CUDA draws (data_transform 2x): max|diff| {e:.2e}")
    check(e <= 1e-12, "the statistics' update disagrees with the mean of the draws")


def check_refit(call, what: str, dev) -> None:
    """Phase 10c's witness at full width: one of AdaptiveIMH's refits
    (``call`` as ``RefitRecorder`` records it), one Adam step on the REFIT_B
    rows of its recorded permutation, held by ``check_adam_step``."""
    p0, data, (perms,), w_card = call
    check_adam_step(p0, data[perms[0][:REFIT_B]], w_card, f"AdaptiveIMH {what}", dev)


def check_adam_step(p0, rows_, w_run, what: str, dev) -> None:
    """One Adam step of a refit (REFIT_B rows, a fresh Adam, lr 0.005)
    replayed on the card and run on the CPU from the same weights and rows;
    ``w_run``, where given, is the run's own refit (a one-step refit), which
    the replay must reproduce. The gradient (one VJP) agrees to TOL *
    max|g|. Adam's first step moves each weight by lr g / (|g| + eps), +-lr
    whatever the gradient's size, so where float32 rounding flips a gradient
    element's sign the weights come out 2 lr apart, and where |g| is near eps
    they come out apart by a fraction of lr: every weight more than TOL apart
    must be one whose float64 gradient lies within the float32 error
    measured here (scripts/refit_gradient_floor.py measures it the same
    way), apart by what Adam's step makes of the card's and the CPU's
    gradients (to TOL)."""
    from nfmc_torch.flows import Flow, RealNVP
    from nfmc_torch.flows import train as train_mod

    flow = Flow(RealNVP((D,), n_layers=L, hidden_size=H), seed=0)
    replay = train_mod.make_scan_fit(flow, REFIT_B, n_epochs=1, shuffle=False)
    w_replay = packed_flat(replay(p0, rows_, None))
    w_card = w_replay if w_run is None else w_run
    p0_cpu = [{k: [t.cpu() for t in v] for k, v in p.items()} for p in p0]
    w_cpu = packed_flat(replay(p0_cpu, rows_.cpu(), None))
    g_card = flat_grad(flow, p0, rows_).cpu().double()
    g_cpu = flat_grad(flow, p0_cpu, rows_.cpu()).double()
    g64 = flat_grad(flow, p0_cpu, rows_.cpu(), torch.float64)
    e_g, g_max = (g_card - g_cpu).abs().max().item(), g64.abs().max().item()
    e32 = max((g_card - g64).abs().max().item(), (g_cpu - g64).abs().max().item())
    dw = (w_card.double() - w_cpu.double()).abs()
    off = dw > TOL
    lr = 0.005  # make_scan_fit's default, as AdaptiveIMH calls it, and DLMC's

    def step(g):
        return lr * g / (g.abs() + train_mod._Adam.eps)

    flipped = torch.sign(g_card) != torch.sign(g_cpu)
    witnessed = (g64.abs() <= e32) & ((dw - (step(g_card) - step(g_cpu)).abs()).abs() <= TOL)
    print(f"{what} refit card vs CPU (d={D}, H={H}, L={L}, {REFIT_B} rows): gradient "
          f"max|diff| {e_g:.3e} (max|g| {g_max:.4g}, float32 error against float64 {e32:.3e}, "
          f"{int((g64.abs() <= e32).sum())} of {g64.numel()} elements within it, "
          f"{int(flipped.sum())} signs flipped); weights max|diff| {dw.max().item():.3e}, "
          f"{int(off.sum())} more than {TOL} apart, each witnessed: "
          f"{bool(witnessed[off].all())}; the card's replay against its own refit "
          f"{(w_replay - w_card).abs().max().item():.3e}")
    for i in off.nonzero().flatten().tolist():
        print(f"  weight {i}: card {w_card[i].item():.6f} cpu {w_cpu[i].item():.6f}, gradient "
              f"card {g_card[i].item():.3e} cpu {g_cpu[i].item():.3e} float64 {g64[i].item():.3e}, "
              f"Adam's steps apart {(step(g_card[i]) - step(g_cpu[i])).abs().item():.3e}")
    check(bool(torch.isfinite(g_card).all()) and e_g <= TOL * g_max,
          f"the {what} refit's gradient on the card disagrees with the CPU's")
    check((w_replay - w_card).abs().max().item() <= 1e-6,
          f"the {what} refit replayed differs from the run's own: wrong rows")
    check(bool(witnessed[off].all()), f"{what} refit: weights apart on the card and the CPU "
                                      "that no gradient within float32 error of 0 explains")


def run_imh_phases(dev) -> dict:
    """Phases 10-10e: IMH through the front door (frozen, misfit, with the
    reverse-KL warmup, adaptive), the fused adaptive chunk and
    variational_fit on the card against the CPU, and the self-target.
    Returns the launch counts and numbers the kernels' line needs."""
    import nfmc_torch
    from nfmc_torch.core.driver import chunk_schedule
    from nfmc_torch.flows import CouplingLRS, CouplingRQNSF, Flow, RealNVP, from_jax_params
    from nfmc_torch.flows import train as train_mod
    from nfmc_torch.ops import build
    from nfmc_torch.potentials import (CallablePotential, DiagonalGaussian, DiagonalGaussian1,
                                       StandardGaussian)
    from nfmc_torch.samplers.nfmc import AdaptiveIMH, IMHKernel, IMHParameters
    from nfmc_torch.samplers.nfmc import imh as imh_mod

    res = {}

    def counts():
        return {w.__name__: w.launches for w in build.WRAPPERS}

    def frozen_imh(target, n_iterations):
        return nfmc_torch.sample(target, flow=Flow(RealNVP((D,), n_layers=L, hidden_size=H), seed=0),
                                 n_chains=C, n_iterations=n_iterations,
                                 param_kwargs={"store_samples_on_device": True}, seed=0,
                                 show_progress=False)

    # ---- 10. FixedIMH through the front door, the flow frozen at identity -------
    # warm run: every hoisted chunk size up to IMH_CHUNK and a remainder
    # (the whole IMH_ITERS until the script's wall with phase 17)
    frozen_imh(StandardGaussian((D,)), 2 * IMH_CHUNK)
    build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ShapeLaunches() as shapes:
        out = frozen_imh(StandardGaussian((D,)), IMH_ITERS)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    nl = counts()
    st = out.statistics
    n_chunks = len(list(chunk_schedule(IMH_ITERS, max_chunk=IMH_CHUNK)))
    print(f"IMH (default strategy, identity flow, {IMH_ITERS} it): wall {wall:.3f} s, "
          f"{IMH_ITERS / wall:.1f} it/s, launches {nl} ({n_chunks} chunks; by shape "
          f"{dict(shapes.n)}), acc "
          f"{st.acceptance_rate:.6f}, max|mean| {np.abs(out.mean).max():.4f}, max|E[x^2]-1| "
          f"{np.abs(out.second_moment - 1).max():.4f}")
    res["imh_ess_per_s"] = ess_per_second(out, wall, max_window=4096, what="IMH")
    profile_window(lambda: frozen_imh(StandardGaussian((D,)), 1000), "IMH, 1000 it")
    res["imh_shapes"] = shapes.n
    check(type(out.kernel) is IMHKernel, "the default strategy did not run IMH")
    check(tuple(out.samples.shape) == (IMH_ITERS, C, D), "IMH sample shape")
    check(bool(torch.isfinite(out.samples).all()), "IMH: non-finite samples")
    check(st.acceptance_rate >= 0.999, f"IMH acceptance {st.acceptance_rate} < 0.999 with the "
                                       "proposal equal to the target")
    check(np.abs(out.mean).max() < 0.05 and np.abs(out.second_moment - 1).max() < 0.1,
          "IMH moments are off N(0, I)")
    check(st.n_target_calls == 2 * C * IMH_ITERS and st.n_target_gradient_calls == 0,
          "IMH counter contract")
    check(nl["fused_realnvp_forward"] == 1, "IMH: the current state's log q is one forward launch")
    check(nl["fused_realnvp_inverse"] == n_chunks, f"IMH: one inverse launch a chunk ({n_chunks})")
    check(all(v == 0 for k, v in nl.items()
              if k not in ("fused_realnvp_forward", "fused_realnvp_inverse")),
          f"IMH: another kernel ran: {nl}")

    # ---- 10a. misfit ----------------------------------------------------------------
    mu = 0.12
    t0 = time.perf_counter()
    mis = frozen_imh(DiagonalGaussian(np.full(D, mu, np.float32), np.float32(1.0)),
                     IMH_MISFIT_ITERS)
    acc = mis.statistics.acceptance_rate
    print(f"IMH misfit N({mu}*1, I), {IMH_MISFIT_ITERS} it: acc {acc:.4f} (analytic 2 Phi(-|mu|/sqrt 2) = "
          f"0.396), max|mean - mu| {np.abs(mis.mean - mu).max():.4f}, wall "
          f"{time.perf_counter() - t0:.3f} s")
    check(0.30 <= acc <= 0.50, f"IMH misfit acceptance {acc} outside [0.30, 0.50]")

    # ---- 10b. IMH with the reverse-KL warmup -------------------------------------------
    target = DiagonalGaussian1(D)
    sigma = target.sigma.astype(np.float64)
    build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Instrument() as ins, ShapeLaunches() as shapes:
        wout = nfmc_torch.sample(target, flow=Flow(RealNVP((D,), n_layers=L, hidden_size=H),
                                                   seed=0),
                                 n_chains=C, n_iterations=IMH_WARM_ITERS, warmup=True,
                                 param_kwargs={"store_samples_on_device": True}, seed=0,
                                 show_progress=False)
        torch.cuda.synchronize()
    wall_w = time.perf_counter() - t0
    nl = counts()
    res["vfit_shapes"] = shapes.n
    acc_w = wout.statistics.acceptance_rate
    ratio = wout.variance / sigma ** 2
    z = np.abs(wout.mean) / sigma
    moments = {"median|var/sigma^2 - 1|": float(np.median(np.abs(ratio - 1))),
               "min var/sigma^2": float(ratio.min()), "max var/sigma^2": float(ratio.max()),
               "median|mean|/sigma": float(np.median(z)),
               "max|var/sigma^2 - 1|": float(np.max(np.abs(ratio - 1))),
               "max|mean|/sigma": float(z.max())}
    ident = frozen_imh(target, IMH_WARM_ITERS).statistics.acceptance_rate
    print(f"IMH with warmup on DiagonalGaussian1({D}), {IMH_WARM_ITERS} it: wall {wall_w:.3f} s, "
          f"of which variational fit {ins.vfit_s:.3f} s, {ins.vfit_epochs} epochs, "
          f"{1e3 * ins.vfit_s / max(ins.vfit_epochs, 1):.3f} ms per Adam step (fit wall / "
          f"steps); launches {nl}, by shape {dict(shapes.n)}; acc {acc_w:.4f} (JAX package, CPU, "
          f"seeds 0-7: {IMH_WARM_ACC_JAX}), identity flow {ident:.6f}; "
          + ", ".join(f"{k} {v:.4f}" for k, v in moments.items()))
    check(ins.vfit_epochs > 0 and nl["fused_realnvp_vjp"] == ins.vfit_epochs
          and shapes.n["vjp", "inverse", 128] == ins.vfit_epochs
          and shapes.n["stack", "inverse", 128] == ins.vfit_epochs,
          "variational fit: inverse and backward launches at B=128 != epochs")
    check(IMH_WARM_ACC[0] <= acc_w <= IMH_WARM_ACC[1],
          f"IMH acceptance after warmup {acc_w} outside {IMH_WARM_ACC}")
    check(acc_w > ident, f"IMH acceptance after warmup {acc_w} not above the identity's {ident}")
    for k, (lo, hi) in IMH_WARM_MOMENTS.items():
        check(lo <= moments[k] <= hi, f"IMH after warmup: {k} {moments[k]} outside [{lo}, {hi}]")

    # ---- 10c. AdaptiveIMH through the front door --------------------------------------
    def adaptive_imh():
        return nfmc_torch.sample(target, strategy="adaptive_imh",
                                 flow=Flow(RealNVP((D,), n_layers=L, hidden_size=H), seed=0),
                                 n_chains=C, n_iterations=IMH_WARM_ITERS, seed=0,
                                 show_progress=False)

    build.reset_launch_counts()
    t0 = time.perf_counter()
    with Instrument() as ins, ShapeLaunches() as shapes, NewCaptures() as new:
        aout = adaptive_imh()
        torch.cuda.synchronize()
    nl = counts()
    res["refit_shapes"] = shapes.n
    ast = aout.statistics
    print(f"adaptive_imh ({aout.samples.shape[0]} it, the reference ignores n_iterations): wall "
          f"{time.perf_counter() - t0:.3f} s, refit Adam steps {ins.steps}, launches {nl}, by "
          f"shape {dict(shapes.n)}, acc {ast.acceptance_rate:.4f}, gradient calls "
          f"{ast.n_target_gradient_calls}, target calls {ast.n_target_calls}; captures "
          f"(wall s, pool MiB) {new.describe()}")
    check(tuple(aout.samples.shape) == (100, C, D) and bool(torch.isfinite(aout.samples).all()),
          "adaptive_imh draws")
    check(ast.n_target_gradient_calls == 2 * C * 100 and ast.n_target_calls == 0,
          "adaptive_imh counter quirk")
    check(ins.steps > 0 and nl["fused_realnvp_vjp"] == ins.steps
          and shapes.n["vjp", "forward", REFIT_B] == ins.steps,
          f"adaptive_imh: backward launches at B={REFIT_B} != the refits' Adam steps")
    check(len(new.graphs) == 1, "adaptive_imh's fused chunk did not replay one captured graph")
    check(train_mod._adaptive_batch_size(C) == REFIT_B, "the refit batch is not REFIT_B")

    # the refits' inputs, from the same call in the eager loop (a replay
    # runs no Python), which must draw what the replays drew
    from nfmc_torch.core import graphs

    with graphs.disable_graphs(), RefitRecorder(imh_mod) as refit:
        eout = adaptive_imh()
    check(refit.first is not None, "adaptive_imh did not take the fused path")
    check(torch.equal(eout.samples, aout.samples) and torch.equal(
        flat_params(eout.kernel.flow.params), flat_params(aout.kernel.flow.params)),
          "adaptive_imh: the eager loop drew other numbers than the replays")

    # the first refit starts from the identity init, where the gradient of
    # every weight but the conditioners' output layers is exactly 0; the
    # last from weights the earlier refits moved
    print(f"adaptive_imh: {refit.n} refits")
    check_refit(refit.first, "first", dev)
    check_refit(refit.last, "last", dev)

    # the fused chunk on the card and on the CPU, same draws, schedule and
    # refit shuffles, at 4b's size, where no refit gradient lies within
    # float32 error of 0 and every weight agrees to TOL
    d6, c8 = 6, 8
    target6 = DiagonalGaussian1(d6)
    params_np = [{k: [t.numpy() for t in v] for k, v in p.items()}
                 for p in perturbed_params(d6, 16, 2, seed=21, device="cpu")]
    draws = AdaptiveIMH((d6,), target6, kernel=IMHKernel((d6,), flow=Flow(RealNVP((d6,)), seed=0)),
                        device="cpu").make_draws(torch.Generator().manual_seed(22), (5,), c8)
    x0 = torch.randn((c8, d6), generator=torch.Generator().manual_seed(23)) * torch.from_numpy(
        target6.sigma)
    do_fit, k_idx = np.array([True, False, True, True, False]), np.array([0, 0, 1, 0, 2])
    fused = {}
    for device in ("cpu", dev):
        flow = Flow(RealNVP((d6,), n_layers=2, hidden_size=16), seed=0)
        flow.params = from_jax_params(params_np, device=device)
        s = AdaptiveIMH((d6,), target6, kernel=IMHKernel((d6,), flow=flow),
                        params=IMHParameters(n_iterations=5), device=device)
        build.reset_launch_counts()
        stt = s.run_fused_chunk(s.make_fused_state(x0.to(device), 5), 0,
                                tuple(d.to(device) for d in draws), do_fit, k_idx,
                                cpu_shuffled(train_mod.make_scan_fit(flow, c8, n_epochs=1,
                                                                     shuffle=False), 24),
                                None)
        fused[device] = [stt["x"], stt["flp"], stt["u"], flat_params(stt["params"])]
    check(counts()["fused_realnvp_vjp"] == 3, "the fused chunk's 3 refits did not run on the card")
    errs = [(a - b.cpu()).abs().max().item() for a, b in zip(fused["cpu"], fused[dev])]
    print(f"AdaptiveIMH fused chunk card vs CPU (5 it, 3 refits, d={d6}, H=16, L=2, C={c8}): "
          f"max|diff| states {errs[0]:.3e}, log q {errs[1]:.3e}, U {errs[2]:.3e}, refit weights "
          f"{errs[3]:.3e}")
    check(max(errs) <= TOL, "the fused adaptive chunk on the card disagrees with the CPU run")

    # ---- 10d. self-target IMH ------------------------------------------------------------
    flows_ = {"realnvp": Flow(RealNVP((D,), n_layers=L, hidden_size=H))}
    flows_["realnvp"].params = perturbed_params(D, H, L, seed=31, device=dev)
    for kind, cls in (("rqs", CouplingRQNSF), ("lrs", CouplingLRS)):
        flows_[SPLINE_FLOWS[kind]] = Flow(cls((D,), n_layers=L, hidden_size=H, n_bins=N_BINS))
        flows_[SPLINE_FLOWS[kind]].params = from_jax_params(
            self_target_params(kind, d=D, hidden=H), device=dev)
    for name_, flow in flows_.items():
        frozen = flow.params
        build.reset_launch_counts()
        t0 = time.perf_counter()
        sout = nfmc_torch.sample(
            CallablePotential(lambda x, flow=flow, frozen=frozen: -flow.log_prob_fn(frozen, x),
                              (D,)),
            flow=flow, n_chains=C, n_iterations=200, seed=0, show_progress=False,
            param_kwargs={"store_samples_on_device": True})
        torch.cuda.synchronize()
        sacc = sout.statistics.acceptance_rate
        print(f"{name_} self-target IMH (200 it): acc {sacc:.4f}, launches {counts()}, wall "
              f"{time.perf_counter() - t0:.3f} s")
        check(bool(torch.isfinite(sout.samples).all()), f"{name_} self-target IMH: non-finite")
        check(sacc >= 0.99, f"{name_} self-target IMH acceptance {sacc} < 0.99: the kernels' "
                            "forward, inverse and log-det disagree")

    # ---- 10e. variational_fit, card vs CPU ------------------------------------------------
    vt = DiagonalGaussian(np.full(6, 0.3, np.float32), np.float32(1.2))
    zs = torch.randn((20, 32, 6), generator=torch.Generator().manual_seed(41))
    fits = {}
    orig_np = train_mod.np
    try:
        for device in ("cpu", dev):
            flow = Flow(RealNVP((6,), n_layers=2, hidden_size=16), seed=0)
            flow.params = perturbed_params(6, 16, 2, seed=9, device=device)
            it = iter(zs.to(device))
            train_mod.np = rec = RecordingNumpy()
            flow.variational_fit(lambda x: -vt(x), n_samples=32, n_epochs=20, lr=0.01, seed=0,
                                 keep_best_weights=False, base_draws=lambda g, n, it=it: next(it))
            fits[device] = (flat_params(flow.params), np.concatenate(rec.seen))
    finally:
        train_mod.np = orig_np
    e_w = (fits["cpu"][0] - fits[dev][0]).abs().max().item()
    e_l = float(np.max(np.abs(fits["cpu"][1] - fits[dev][1])))
    print(f"variational_fit card vs CPU (d=6, 20 epochs of 32 injected draws): weights max|diff| "
          f"{e_w:.3e}, per-epoch loss max|diff| {e_l:.3e} (losses "
          f"{np.round(fits[dev][1], 4).tolist()})")
    check(len(fits[dev][1]) == 20 and e_w <= TOL and e_l <= TOL,
          "variational_fit on the card disagrees with the CPU fit")
    return res


def run_flow_sampler_phases(dev) -> dict:
    """Phases 11-11f: the flow-reparameterised samplers (neutra_hmc,
    neutra_mh, tess, dlmc) and jump_hmc through the front door at bench.py's
    sizes, then one step of each on the card against the CPU. Returns the
    launches by shape of each path and the numbers the summary prints."""
    import nfmc_torch
    from nfmc_torch.flows import CouplingLRS, CouplingRQNSF, Flow, RealNVP, from_jax_params
    from nfmc_torch.flows import train as train_mod
    from nfmc_torch.ops import build
    from nfmc_torch.ops.coupling import unpack_like
    from nfmc_torch.potentials import CallablePotential, DiagonalGaussian, Funnel, StandardGaussian
    from nfmc_torch.samplers.mcmc import HMCKernel
    from nfmc_torch.samplers.nfmc import (DLMC, DLMCKernel, NeuTraHMC, NeuTraKernel,
                                          make_tess_step)
    from nfmc_torch.samplers.nfmc import dlmc as dlmc_mod

    res = {"shapes": {}}
    target = StandardGaussian((D,))
    t_last = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        print(f"[{what}: {now - t_last[0]:.1f} s]")
        t_last[0] = now

    def identity_flow():
        return Flow(RealNVP((D,), n_layers=L, hidden_size=H), seed=0)

    def timed(what, run):
        """``run()`` with the launch counts set to 0 just before it and read
        just after, its launches by shape and its wall (ending in a
        synchronise)."""
        build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with Instrument() as ins, ShapeLaunches() as shapes:
            out = run()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res["shapes"][what] = shapes.n
        return out, wall, {w.__name__: w.launches for w in build.WRAPPERS}, shapes.n, ins

    # ---- 11. neutra_hmc, the identity-init flow frozen ---------------------------------
    def neutra(n_iterations, seed=0):
        return nfmc_torch.sample(target, strategy="neutra_hmc", flow=identity_flow(), n_chains=C,
                                 n_iterations=n_iterations,
                                 inner_kernel_kwargs={"step_size": NEUTRA_STEP},
                                 param_kwargs={"store_samples_on_device": True}, seed=seed,
                                 show_progress=False)

    neutra(5)  # warm: autograd through the kernels' Functions
    out, wall, nl, sh, _ = timed("neutra_hmc", lambda: neutra(NEUTRA_ITERS))
    st = out.statistics
    acc = st.acceptance_rate
    m1, m2 = float(np.abs(out.mean).max()), float(np.abs(out.second_moment - 1).max())
    print(f"neutra_hmc (identity flow, step {NEUTRA_STEP}, 20 leapfrogs, {NEUTRA_ITERS} it): wall "
          f"{wall:.3f} s, {NEUTRA_ITERS / wall:.1f} it/s, {st.n_target_gradient_calls / wall:.0f} "
          f"gradient calls/s (2LB counted), launches {nl}, by shape {dict(sh)}, acc {acc:.6f} "
          f"(JAX package, CPU, seeds 0-7: {NEUTRA_ACC_JAX}), max|mean| {m1:.4f}, max|E[x^2]-1| "
          f"{m2:.4f}")
    flow = out.kernel.flow
    res["neutra_ess_per_s"] = ess_per_second(
        out, wall, max_window=4096, what="neutra_hmc (data space)",
        transform=lambda z: flow.bijection.inverse_fn(flow.params, z)[0])
    res["neutra_it_per_s"] = NEUTRA_ITERS / wall
    profile_window(lambda: neutra(20, seed=1), "neutra_hmc, 20 it")
    check(tuple(out.samples.shape) == (NEUTRA_ITERS, C, D), "neutra_hmc sample shape")
    check(bool(torch.isfinite(out.samples).all()), "neutra_hmc: non-finite draws")
    check(NEUTRA_ACC[0] <= acc <= NEUTRA_ACC[1], f"neutra_hmc acceptance {acc} outside {NEUTRA_ACC}")
    check(m1 <= NEUTRA_MOMENTS[0] and m2 <= NEUTRA_MOMENTS[1],
          f"neutra_hmc data-space moments {m1}, {m2} above {NEUTRA_MOMENTS}")
    check(st.n_target_gradient_calls == 2 * 20 * C * NEUTRA_ITERS
          and st.n_target_calls == (2 * 20 + 2) * C * NEUTRA_ITERS, "neutra_hmc counter contract")
    # a gradient pass a position (21 an iteration, each an inverse and an
    # inverse VJP), and the data transform's inverse for the moments
    check(sh == {("stack", "inverse", C): 22 * NEUTRA_ITERS, ("vjp", "inverse", C): 21 * NEUTRA_ITERS},
          f"neutra_hmc launch law: {dict(sh)}")

    lap("phase 11")

    # ---- 11a. neutra_mh on the funnel, with warmup ---------------------------------------
    def neutra_mh():
        return nfmc_torch.sample(
            Funnel(D), strategy="neutra_mh", flow=identity_flow(), n_chains=C,
            n_iterations=NEUTRA_MH_ITERS, warmup=True,
            inner_kernel_kwargs={"inv_mass_diag": np.full(D, NEUTRA_MH_SCALE, np.float32)},
            param_kwargs={"warmup_fit_kwargs": dict(NEUTRA_MH_FIT_KWARGS),
                          "store_samples_on_device": True}, seed=0, show_progress=False)

    out, wall, nl, sh, ins = timed("neutra_mh", neutra_mh)
    st = out.statistics
    acc = st.acceptance_rate
    var = out.variance
    n_warm = 100  # the front door's n_warmup_iterations
    print(f"neutra_mh on Funnel({D}) with warmup ({NEUTRA_MH_FIT_EPOCHS} reverse-KL epochs at most, "
          f"{NEUTRA_MH_ITERS} it): wall {wall:.3f} s, of which variational fit {ins.vfit_s:.3f} s "
          f"({ins.vfit_epochs} epochs), launches {nl}, by shape {dict(sh)}, acc {acc:.6f} (JAX "
          f"package, CPU, seeds 0-7: {NEUTRA_MH_ACC_JAX}), var x_0 {var[0]:.4f} (exact 9), "
          f"median var x_1.. {np.median(var[1:]):.4f}, max|mean| {np.abs(out.mean).max():.4f}")
    check(bool(torch.isfinite(out.samples).all()) and np.isfinite(out.mean).all()
          and np.isfinite(var).all(), "neutra_mh: non-finite draws or moments")
    check(NEUTRA_MH_ACC[0] <= acc <= NEUTRA_MH_ACC[1],
          f"neutra_mh acceptance {acc} outside {NEUTRA_MH_ACC}")
    check(st.n_target_calls == 2 * C * NEUTRA_MH_ITERS and st.n_target_gradient_calls == 0,
          "neutra_mh counter contract")
    check(0 < ins.vfit_epochs <= NEUTRA_MH_FIT_EPOCHS
          and sh["vjp", "inverse", 128] == sh["stack", "inverse", 128] == ins.vfit_epochs,
          "neutra_mh: the variational fit's launches at B=128 != its epochs")
    # U~ at the start of the warmup and of the run, then a proposal and the
    # data transform an iteration
    check(sh["stack", "inverse", C] == 2 + 2 * (n_warm + NEUTRA_MH_ITERS),
          f"neutra_mh launch law at B={C}: {dict(sh)}")

    lap("phase 11a")

    # ---- 11b. self-target neutra_hmc: U~ is N(0, I) whatever the flow ------------------
    res["self"] = {}
    for name_, cls, kind in (("realnvp", RealNVP, "realnvp"), ("c-rqnsf", CouplingRQNSF, "rqs"),
                             ("c-lrsnsf", CouplingLRS, "lrs")):
        kw = {} if cls is RealNVP else {"n_bins": N_BINS}
        sflow = Flow(cls((D,), n_layers=L, hidden_size=H, **kw))
        sflow.params = from_jax_params(self_target_params(kind, d=D, hidden=H, n_layers=L),
                                       device=dev)
        frozen = sflow.params

        def run(sflow=sflow, frozen=frozen):
            return nfmc_torch.sample(
                CallablePotential(lambda x: -sflow.log_prob_fn(frozen, x), (D,)),
                strategy="neutra_hmc", flow=sflow, n_chains=C, n_iterations=NEUTRA_SELF_ITERS,
                inner_kernel_kwargs={"step_size": NEUTRA_SELF_STEP},
                param_kwargs={"store_samples_on_device": True}, seed=0, show_progress=False)

        out, wall, nl, sh, _ = timed(f"self {name_}", run)
        z = out.samples.reshape(-1, D).double()
        sacc = out.statistics.acceptance_rate
        med_mean = float(z.mean(0).abs().median())
        med_var = float((z.var(0) - 1).abs().median())
        print(f"{name_} self-target neutra_hmc ({NEUTRA_SELF_ITERS} it, step {NEUTRA_SELF_STEP}): "
              f"acc {sacc:.6f}, latent "
              f"median|mean| {med_mean:.4f}, median|var - 1| {med_var:.4f} (bounds "
              f"{NEUTRA_SELF_MOMENTS}), wall {wall:.3f} s, launches by shape {dict(sh)}")
        k_stack, k_vjp = ("stack", "vjp") if kind == "realnvp" else (kind, f"{kind} vjp")
        n = NEUTRA_SELF_ITERS
        check(bool(torch.isfinite(z).all()), f"{name_} self-target neutra_hmc: non-finite")
        check(sacc >= 0.99, f"{name_} self-target neutra_hmc acceptance {sacc} < 0.99: the "
                            "input gradient through the flow's inverse is wrong")
        check(med_mean <= NEUTRA_SELF_MOMENTS[0] and med_var <= NEUTRA_SELF_MOMENTS[1],
              f"{name_} self-target neutra_hmc: latent moments off N(0, I)")
        # a gradient pass: the inverse, the target's forward (log q), and
        # both VJPs; the data transform's inverse
        check(sh == {(k_stack, "inverse", C): 22 * n, (k_stack, "forward", C): 21 * n,
                     (k_vjp, "inverse", C): 21 * n, (k_vjp, "forward", C): 21 * n},
              f"{name_} self-target neutra_hmc launch law: {dict(sh)}")
        res["self"][name_] = sacc

    lap("phase 11b")

    # ---- 11c. tess, the identity-init flow, then its warmup --------------------------------
    def tess(n_iterations, seed=0):
        return nfmc_torch.sample(target, strategy="tess", negative_log_likelihood=target,
                                 flow=identity_flow(), n_chains=C, n_iterations=n_iterations,
                                 param_kwargs={"store_samples_on_device": True}, seed=seed,
                                 show_progress=False)

    tess(5)  # warm
    out, wall, nl, sh, _ = timed("tess", lambda: tess(TESS_ITERS))
    st = out.statistics
    m1, m2 = float(np.abs(out.mean).max()), float(np.abs(out.second_moment - 1).max())
    print(f"tess (identity flow, {TESS_ITERS} it): wall {wall:.3f} s, {TESS_ITERS / wall:.1f} it/s, "
          f"launches {nl}, by shape {dict(sh)}, acc {st.acceptance_rate:.6f} "
          f"({st.n_attempted_trajectories - st.n_accepted_trajectories} of "
          f"{st.n_attempted_trajectories} rejected), max|mean| {m1:.4f}, max|E[x^2]-1| {m2:.4f}")
    res["tess_ess_per_s"] = ess_per_second(out, wall, max_window=4096, what="tess")
    res["tess_it_per_s"] = TESS_ITERS / wall
    profile_window(lambda: tess(50, seed=1), "tess, 50 it")
    check(tuple(out.samples.shape) == (TESS_ITERS, C, D) and bool(torch.isfinite(out.samples).all()),
          "tess draws")
    # the flow's base is the target, so the first point of every ellipse
    # passes in exact arithmetic: a rotation keeps |u|^2 + |v|^2, and the
    # point's log pi^ + log phi equals the threshold's before its log w < 0.
    # In float32 both sums carry rounding of ~1e-5 (values ~ -142 over 100
    # dims), so a point fails only where log w lies within that rounding of
    # 0, a chance of that size a draw
    n_rej = st.n_attempted_trajectories - st.n_accepted_trajectories
    check(n_rej <= 1e-4 * st.n_attempted_trajectories,
          f"tess: {n_rej} of {st.n_attempted_trajectories} first ellipse points rejected, more "
          "than float32 rounding of the threshold explains")
    check(m1 < 0.05 and m2 < 0.1, "tess moments are off N(0, I)")
    check(st.n_target_calls == 6 * C * TESS_ITERS and st.n_target_gradient_calls == 0,
          "tess counter contract")
    check(sh == {("stack", "inverse", C): 1 + 5 * TESS_ITERS}, f"tess launch law: {dict(sh)}")

    n_warm = 20

    def tess_warmup():
        s = nfmc_torch.create_sampler(target, strategy="tess", negative_log_likelihood=target,
                                      flow=identity_flow(), device=dev,
                                      param_kwargs={"n_warmup_iterations": n_warm,
                                                    "flow_fit_kwargs": dict(TESS_FIT_KWARGS)})
        return s, s.warmup(torch.zeros(C, D, device=dev), show_progress=False, seed=0)

    before = flat_params(identity_flow().params)
    (s, wout), wall, nl, sh, ins = timed("tess warmup", tess_warmup)
    after = flat_params(s.kernel.flow.params)
    n_val, bs = C - int(0.7 * C), train_mod._adaptive_batch_size(int(0.7 * C))
    print(f"tess warmup ({n_warm} it, fixed-effort refits {TESS_FIT_KWARGS}): wall {wall:.3f} s, "
          f"{ins.steps} Adam steps, launches {nl}, by shape {dict(sh)}, acc "
          f"{wout.statistics.acceptance_rate:.4f}, max|weight change| "
          f"{(after - before).abs().max().item():.4f}")
    check(tuple(wout.samples.shape) == (n_warm, C, D) and bool(torch.isfinite(wout.samples).all()),
          "tess warmup draws")
    check(wout.statistics.n_target_calls == 6 * C * n_warm, "tess warmup counter contract")
    check(bool(torch.isfinite(after).all()) and (after - before).abs().max().item() > 0,
          "tess warmup: the refit weights are not finite or did not move")
    # each iteration: the start's and 5 bracket inverses, 10 epochs of one
    # Adam step on 64 of the 70 training rows, the validation rows each
    # epoch and at the end
    check(ins.steps == n_warm * 10 and sh["vjp", "forward", bs] == ins.steps
          and sh["stack", "forward", bs] == ins.steps
          and sh["stack", "forward", n_val] == n_warm * 11
          and sh["stack", "inverse", C] == n_warm * 6, f"tess warmup launch law: {dict(sh)}")

    lap("phase 11c")

    # ---- 11d. jump_hmc at 1024 chains ---------------------------------------------------
    def jump_hmc(n_outer, seed=0):
        return nfmc_torch.sample(target, strategy="jump_hmc", flow=identity_flow(),
                                 n_chains=JUMP_HMC_C, n_iterations=n_outer,
                                 param_kwargs={"store_samples_on_device": True}, seed=seed,
                                 show_progress=False)

    jump_hmc(2)  # warm
    out, wall, nl, sh, _ = timed("jump_hmc", lambda: jump_hmc(JUMP_HMC_OUTER))
    st = out.statistics
    m1, m2 = float(np.abs(out.mean).max()), float(np.abs(out.second_moment - 1).max())
    res["jump_hmc_it_per_s"] = JUMP_HMC_OUTER / wall
    res["jump_hmc_grads_per_s"] = st.n_target_gradient_calls / wall
    print(f"jump_hmc ({JUMP_HMC_C} chains, {JUMP_HMC_INNER} inner HMC it, {JUMP_HMC_OUTER} outer it): "
          f"wall {wall:.3f} s, {res['jump_hmc_it_per_s']:.2f} outer it/s, "
          f"{res['jump_hmc_grads_per_s']:.0f} leapfrog gradients/s (counted, 2LB), "
          f"{JUMP_HMC_OUTER * JUMP_HMC_INNER * 20 * JUMP_HMC_C / wall:.0f} chain leapfrogs/s, "
          f"launches {nl}, by shape {dict(sh)}, HMC acc {st.acceptance_rate:.4f}, jump acc "
          f"{st.jump_acceptance_rate:.4f}, max|mean| {m1:.4f}, max|E[x^2]-1| {m2:.4f}")
    profile_window(lambda: jump_hmc(5, seed=1), "jump_hmc, 5 outer it")
    per_outer = JUMP_HMC_INNER * (2 * 20 + 2) * JUMP_HMC_C + 2 * JUMP_HMC_C
    check(tuple(out.samples.shape) == (JUMP_HMC_OUTER * (JUMP_HMC_INNER + 1), JUMP_HMC_C, D)
          and bool(torch.isfinite(out.samples).all()), "jump_hmc: the interleaving law")
    check(st.n_target_calls == JUMP_HMC_OUTER * per_outer
          and st.n_target_gradient_calls == JUMP_HMC_OUTER * JUMP_HMC_INNER * 40 * JUMP_HMC_C
          and st.n_attempted_jumps == JUMP_HMC_OUTER * JUMP_HMC_C
          and st.n_attempted_trajectories == JUMP_HMC_OUTER * JUMP_HMC_INNER * JUMP_HMC_C,
          "jump_hmc counter contract")
    check(m1 < 0.05 and m2 < 0.1, "jump_hmc moments are off N(0, I)")
    # one hoisted chunk of proposals, one forward (the current state's
    # log q) a jump
    check(sh == {("stack", "inverse", JUMP_HMC_OUTER * JUMP_HMC_C): 1,
                 ("stack", "forward", JUMP_HMC_C): JUMP_HMC_OUTER},
          f"jump_hmc launch law: {dict(sh)}")

    lap("phase 11d")

    # ---- 11e. dlmc at 1024 chains ----------------------------------------------------------
    def dlmc(n_iterations, seed=0):
        return nfmc_torch.sample(target, strategy="dlmc", negative_log_likelihood=target,
                                 flow=identity_flow(), n_chains=DLMC_C, n_iterations=n_iterations,
                                 param_kwargs={"flow_fit_kwargs": dict(DLMC_FIT_KWARGS),
                                               "store_samples_on_device": True},
                                 seed=seed, show_progress=False)

    with RefitRecorder(dlmc_mod) as refit:
        dlmc(1)  # warm; its refit is the timed run's first (11f holds it)
    out, wall, nl, sh, ins = timed("dlmc", lambda: dlmc(DLMC_ITERS))
    st = out.statistics
    err = float(np.abs(out.mean).max())
    res["dlmc_it_per_s"] = DLMC_ITERS / wall
    n_train = int(0.7 * DLMC_C)
    bs = train_mod._adaptive_batch_size(n_train)
    n_batches, n_val = n_train // bs, DLMC_C - n_train
    print(f"dlmc ({DLMC_C} chains, {DLMC_ITERS} it, refits {DLMC_FIT_KWARGS}): wall {wall:.3f} s, "
          f"{res['dlmc_it_per_s']:.3f} it/s, {ins.steps} Adam steps "
          f"({1e3 * wall / max(ins.steps, 1):.3f} ms of wall a step), launches {nl}, by shape "
          f"{dict(sh)}, acc {st.acceptance_rate:.4f} (JAX package, CPU, seeds 0-7: "
          f"{DLMC_ACC_JAX}), moment err max|mean| {err:.4f} (JAX: {DLMC_ERR_JAX}), max|E[x^2]-1| "
          f"{np.abs(out.second_moment - 1).max():.4f}")
    profile_window(lambda: dlmc(2, seed=1), "dlmc, 2 it")
    check(tuple(out.samples.shape) == (DLMC_ITERS, DLMC_C, D) and bool(torch.isfinite(out.samples).all()),
          "dlmc draws")
    check(st.n_target_calls == DLMC_C + 3 * DLMC_C * DLMC_ITERS
          and st.n_target_gradient_calls == DLMC_C + DLMC_C * DLMC_ITERS, "dlmc counter contract")
    check(DLMC_ERR[0] <= err <= DLMC_ERR[1], f"dlmc moment error {err} outside {DLMC_ERR}")
    check(DLMC_ACC[0] <= st.acceptance_rate <= DLMC_ACC[1],
          f"dlmc acceptance {st.acceptance_rate} outside {DLMC_ACC}")
    steps = DLMC_ITERS * 10 * n_batches
    check(ins.steps == steps and sh["vjp", "forward", bs] == steps
          and sh["stack", "forward", bs] == steps
          and sh["stack", "forward", n_val] == DLMC_ITERS * 11
          and sh["vjp", "forward", DLMC_C] == DLMC_ITERS
          and sh["stack", "forward", DLMC_C] == 2 * DLMC_ITERS
          and sh["stack", "inverse", DLMC_C] == DLMC_ITERS, f"dlmc launch law: {dict(sh)}")

    lap("phase 11e")

    # ---- 11f. card against CPU, the same draws and weights ---------------------------------
    # NeuTra-HMC: U~'s gradient and one iteration through a perturbed flow
    pert = perturbed_params(D, H, L, seed=51, device="cpu")
    g11 = torch.Generator().manual_seed(52)
    z0 = torch.randn((C, D), generator=g11)
    draws = (torch.randn((C, D), generator=g11), torch.log(torch.rand(C, generator=g11)),
             torch.ones(C))
    got = {}
    for device in ("cpu", dev):
        f = Flow(RealNVP((D,), n_layers=L, hidden_size=H))
        f.params = [{k: [t.to(device) for t in v] for k, v in p.items()} for p in pert]
        s = NeuTraHMC((D,), target, inner_kernel=HMCKernel(event_size=D, step_size=NEUTRA_STEP),
                      kernel=NeuTraKernel((D,), flow=f), device=device)
        inner = s.inner_sampler
        z = z0.to(device).requires_grad_(True)
        (g_z,) = torch.autograd.grad(s.adjusted_target(z).sum(), z)
        with torch.no_grad():
            mstate = inner._augment_state(inner.kernel.make_state(device), z0.to(device))
            z1, _, info = inner._make_step_aux(False)(z0.to(device), mstate,
                                                      tuple(d.to(device) for d in draws))
        got[device] = (g_z.cpu(), z1.cpu(), int(info.n_accepted))
    e_g = (got["cpu"][0] - got[dev][0]).abs().max().item()
    g_max = got["cpu"][0].abs().max().item()
    e_z = (got["cpu"][1] - got[dev][1]).abs().max().item()
    print(f"neutra_hmc card vs CPU (d={D}, perturbed flow, 1 iteration of 20 leapfrogs): gradient "
          f"of U~ max|diff| {e_g:.3e} (max|g| {g_max:.4g}), end states max|diff| {e_z:.3e}, "
          f"accepted {got[dev][2]} / {got['cpu'][2]} of {C}")
    check(e_g <= TOL * g_max and e_z <= TOL and got[dev][2] == got["cpu"][2],
          "neutra_hmc on the card disagrees with the CPU")

    # one tess_step through a perturbed flow, on a target it does not fit
    g11 = torch.Generator().manual_seed(53)
    u0 = torch.randn((C, D), generator=g11)
    tdraws = (torch.randn((C, D), generator=g11), torch.rand(C, generator=g11),
              torch.randn((C, 1), generator=g11), torch.rand((5, C, 1), generator=g11))
    mis = DiagonalGaussian(np.full(D, 0.3, np.float32), np.float32(1.2))
    got = {}
    for device in ("cpu", dev):
        f = Flow(RealNVP((D,), n_layers=L, hidden_size=H))
        f.params = [{k: [t.to(device) for t in v] for k, v in p.items()} for p in pert]
        t_init, t_step, _ = make_tess_step(f, mis, (D,), 5)
        with torch.no_grad():
            lp, x = t_init(f.params, u0.to(device))
            got[device] = [t.cpu() for t in t_step(f.params, u0.to(device), lp, x,
                                                   tuple(d.to(device) for d in tdraws))]
    errs = [(a.double() - b.double()).abs().max().item() / max(1.0, b.abs().max().item())
            for a, b in zip(got[dev][:3], got["cpu"][:3])]
    same = torch.equal(got[dev][3], got["cpu"][3])
    print(f"tess_step card vs CPU (d={D}, perturbed flow, misfit target): x, u, log pi^ max|diff| / "
          f"max(1, max|ref|) {errs[0]:.3e}, {errs[1]:.3e}, {errs[2]:.3e}; accepted "
          f"{int(got[dev][3].sum())} / {int(got['cpu'][3].sum())} of {C}, masks equal {same}")
    check(max(errs) <= TOL and same, "tess_step on the card disagrees with the CPU")

    # DLMC: the run's first refit (identity init, the particles after the
    # start's gradient step) held by the witness rule on its first Adam step
    # and replayed whole on the card, then one drift and accept from its
    # weights with the same draws
    check(bs == REFIT_B, "DLMC's refit batch is not REFIT_B")
    p0, data, perms, w_first = refit.first
    split, epochs = perms
    xt = data[split[:n_batches * bs]]
    rows_ = xt[epochs[0][:bs]]
    check_adam_step(p0, rows_, None, "DLMC first (its first Adam step)", dev)
    flow = identity_flow().to(dev)
    replay = dlmc_mod.make_scan_fit(flow, DLMC_C, n_epochs=10, lr=5e-3, train_pct=0.7,
                                    keep_best_weights=True)
    w_replay = packed_flat(replay(p0, data, rows=perms))
    check((w_replay - w_first).abs().max().item() <= 1e-6,
          "DLMC's first refit replayed differs from the run's own")
    fitted = unpack_like(w_first, p0)  # the refit's weights, on the CPU
    g11 = torch.Generator().manual_seed(54)
    ddraws = (torch.randn((DLMC_C, D), generator=g11), torch.log(torch.rand(DLMC_C, generator=g11)))
    x_cpu = data.cpu()
    got = {}
    for device in ("cpu", dev):
        f = Flow(RealNVP((D,), n_layers=L, hidden_size=H))
        f.params = [{k: [t.to(device) for t in v] for k, v in p.items()} for p in fitted]
        s = DLMC((D,), target, target, kernel=DLMCKernel((D,), flow=f), device=device)
        drift, accept = s._make_drift_accept()
        with torch.no_grad():
            xd = drift(f.params, x_cpu.to(device))
            x1, mask, _ = accept(f.params, xd, tuple(d.to(device) for d in ddraws))
            z_tilde = ddraws[0].to(device)
            xp, flp_p = f.push_base_fn(f.params, z_tilde)
            log_alpha = (-target(xp) + target(xd)) + f.log_prob_fn(f.params, xd) - flp_p
        got[device] = (xd.cpu(), x1.cpu(), mask.cpu(), log_alpha.cpu())
    e_d = (got[dev][0] - got["cpu"][0]).abs().max().item()
    diff = got[dev][2] != got["cpu"][2]
    margin = (got["cpu"][3] - ddraws[1]).abs()
    witnessed = bool((margin[diff] <= 1e-3).all())
    agree = ~diff
    e_x = (got[dev][1][agree] - got["cpu"][1][agree]).abs().max().item()
    print(f"dlmc drift + accept card vs CPU ({DLMC_C} chains, d={D}, the first refit's weights): "
          f"drift max|diff| {e_d:.3e}, accepted {int(got[dev][2].sum())} / "
          f"{int(got['cpu'][2].sum())}, {int(diff.sum())} masks apart (each within 1e-3 of its "
          f"threshold: {witnessed}), states max|diff| {e_x:.3e} where the masks agree")
    check(e_d <= TOL and e_x <= TOL and witnessed, "dlmc drift + accept on the card disagrees "
                                                   "with the CPU")
    lap("phase 11f")
    return res


class StepReports:
    """For the duration of a ``with`` block, what ``cls``'s steps report
    (their StepInfo's dynamic call and gradient counts, and the steps
    taken), by tuning flag: the run's own account of its work, apart from
    the statistics' accumulators. A replay runs no Python, so the steps are
    counted with ``build.tally`` (a replayed graph counts the steps its
    capture recorded) and the counts are added in place to a device
    tensor made at the flag's first step (eager: a graph's first iteration
    runs eagerly), which a replay adds to as the capture found it."""

    def __init__(self, cls):
        self.cls = cls

    def __enter__(self):
        from nfmc_torch.ops import build

        cls, rec = self.cls, self
        self.sums, self.steps = {}, collections.Counter()
        self._orig = {name: cls.__dict__.get(name) for name in
                      ("_make_step_aux", "_make_step_precomputed")}

        def wrap(make):
            def factory(sampler, tuning):
                step = make(sampler, tuning)
                if step is None:
                    return None

                def wrapped(*a):
                    out = step(*a)
                    if tuning not in rec.sums:
                        rec.sums[tuning] = torch.zeros(2, dtype=torch.int64,
                                                       device=out[0].device)
                    s = rec.sums[tuning]
                    s[0].add_(out[2].n_calls)
                    s[1].add_(out[2].n_grads)
                    build.tally(rec.steps, tuning)
                    return out
                return wrapped
            return factory

        for name in self._orig:
            setattr(cls, name, wrap(getattr(cls, name)))
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            if fn is None:
                delattr(self.cls, name)
            else:
                setattr(self.cls, name, fn)

    def totals(self, tuning):
        """(calls, grads, steps) the steps of that flag reported."""
        calls, grads = self.sums[tuning].tolist() if tuning in self.sums else (0, 0)
        return int(calls), int(grads), self.steps[tuning]


class NewCaptures:
    """For the duration of a ``with`` block, the graphs
    (``core.graphs.IterationGraph``) captured in it, in order: the cached
    ones and those a run keeps for itself (a refitting chunk's)."""

    def __enter__(self):
        from nfmc_torch.core import graphs

        self._cls, self._orig = graphs.IterationGraph, graphs.IterationGraph.run
        self.graphs = []
        orig, made = self._orig, self.graphs

        def run(graph, n):
            fresh = not graph.captured
            orig(graph, n)
            if fresh and graph.captured:
                made.append(graph)

        graphs.IterationGraph.run = run
        return self

    def __exit__(self, *exc):
        self._cls.run = self._orig

    def describe(self) -> list:
        """Each capture's (wall s, pool MiB)."""
        return [(round(g.capture_seconds, 3), round(g.backend.pool_bytes / 2 ** 20, 1))
                for g in self.graphs]


class CaptureSampler:
    """For the duration of a ``with`` block, the samplers the front door
    builds (``nfmc_torch.api.sample.create_sampler``), in order."""

    @staticmethod
    def _module():
        # the package exports the function ``sample`` under the module's name
        import importlib

        return importlib.import_module("nfmc_torch.api.sample")

    def __enter__(self):
        api = self._module()
        self._orig = make = api.create_sampler
        self.samplers = []

        def recording(*a, **k):
            s = make(*a, **k)
            self.samplers.append(s)
            return s

        api.create_sampler = recording
        return self

    def __exit__(self, *exc):
        self._module().create_sampler = self._orig


def in_band(what, value, band, jax_range):
    """Print ``value`` beside the JAX package's range and gate it on
    ``band``."""
    print(f"  {what} {value:.6f} (JAX package, CPU, seeds 0-7: {jax_range}; band {band})")
    check(band[0] <= value <= band[1], f"{what} {value} outside {band}")


def device_copies(t: torch.Tensor):
    """``on(device)``: ``t`` on ``device``, copied there on first use, as
    the package's potentials hold their constants (a captured step may not
    copy from the host)."""
    copies = {}

    def on(device):
        if device not in copies:
            copies[device] = t.to(device)
        return copies[device]

    return on


def residual_nll(sig):
    """The likelihood that turns ESS's N(0, I) prior into N(0, diag(sig^2))
    (tools/run_reference.py's "residual")."""
    s = device_copies(torch.as_tensor(sig))
    return lambda x: 0.5 * ((x / s(x.device)) ** 2 - x ** 2).sum(-1)


def run_mcmc_phases(dev) -> dict:
    """Phases 12-12f: nuts, chees_hmc and ess at bench.py's sizes, their jump
    variants and neutra_chees through the front door, then one step of each
    on the card against the CPU and ESS's two-sample test against the JAX
    package's draws. Returns the launches by shape of each path and the
    numbers the summary prints."""
    import nfmc_torch
    from nfmc_torch.flows import Flow, RealNVP
    from nfmc_torch.ops import build
    from nfmc_torch.potentials import CallablePotential, DiagonalGaussian, DiagonalGaussian1
    from nfmc_torch.potentials import StandardGaussian
    from nfmc_torch.samplers.mcmc import ESS, NUTS, CheesHMC
    from nfmc_torch.validation import mcmc_two_sample_report

    res = {"shapes": {}}
    target = StandardGaussian((D,))
    t_last = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        print(f"[{what}: {now - t_last[0]:.1f} s]")
        t_last[0] = now

    def identity_flow():
        return Flow(RealNVP((D,), n_layers=L, hidden_size=H), seed=0)

    def timed(what, run, cls):
        """``run()`` with the launch counts set to 0 just before it and read
        just after; its launches by shape, its wall (ending in a
        synchronise), the inner warmup's wall, ``cls``'s step reports and the
        samplers the front door built."""
        build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with Instrument() as ins, ShapeLaunches() as shapes, StepReports(cls) as rep, \
                CaptureSampler() as cap:
            out = run()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res["shapes"][what] = shapes.n
        return out, wall, shapes.n, ins, rep, cap.samplers

    # ---- 12. nuts at 1024 chains -----------------------------------------------------
    def nuts(n_warm, n_iter, seed=0, step=None):
        """A run with ``n_warm`` dual-averaging iterations first, or, with
        ``step``, none (a few dual-averaging steps leave the step size far
        off, and a tiny one builds trees of depth 10)."""
        kernel = {"max_tree_depth": NUTS_DEPTH, **({"step_size": step} if step else {})}
        return nfmc_torch.sample(target, strategy="nuts", flow=None, n_chains=NUTS_C,
                                 n_warmup_iterations=n_warm, n_iterations=n_iter,
                                 warmup=step is None, kernel_kwargs=kernel,
                                 param_kwargs={"store_samples_on_device": True}, seed=seed,
                                 show_progress=False)

    nuts(0, 2, step=NUTS_STEP_JAX_MID)  # warm
    out, wall, sh, ins, rep, (s,) = timed("nuts", lambda: nuts(NUTS_WARM, NUTS_ITERS), NUTS)
    st = out.statistics
    wall_s = wall - ins.inner_s
    mean_depth, max_depth = s.tree_depths()
    calls, grads, steps = rep.totals(False)
    lf = st.n_target_gradient_calls / (NUTS_ITERS * NUTS_C) - 1
    m1, m2 = float(np.abs(out.mean).max()), float(np.abs(out.second_moment - 1).max())
    res["nuts_it_per_s"] = NUTS_ITERS / wall_s
    res["nuts_grads_per_s"] = st.n_target_gradient_calls / wall_s
    print(f"nuts ({NUTS_C} chains, d={D}, depth {NUTS_DEPTH}, {NUTS_WARM} warmup + {NUTS_ITERS} it): "
          f"wall {wall:.3f} s, of which warmup {ins.inner_s:.3f} s; sampling {wall_s:.3f} s, "
          f"{res['nuts_it_per_s']:.2f} it/s, {res['nuts_grads_per_s']:.0f} gradient calls/s "
          f"(counted), tuned step {out.kernel.step_size:.6f}, tree depth mean {mean_depth:.3f} max "
          f"{max_depth} (warmup and sampling), {lf:.4f} leapfrogs a chain-iteration, acc "
          f"{st.acceptance_rate:.6f}, max|mean| {m1:.4f}, max|E[x^2]-1| {m2:.4f}, "
          f"divergences {st.n_divergences}, launches by shape {dict(sh)}")
    res["nuts_ess_per_s"] = ess_per_second(out, wall_s, max_window=4096, what="nuts")
    profile_window(lambda: nuts(0, 20, seed=1, step=NUTS_STEP_JAX_MID),
                   f"nuts, 20 it at the step {NUTS_STEP_JAX_MID}")
    check(tuple(out.samples.shape) == (NUTS_ITERS, NUTS_C, D)
          and bool(torch.isfinite(out.samples).all()), "nuts draws")
    in_band("nuts acceptance (chains moved)", st.acceptance_rate, NUTS_ACC, NUTS_ACC_JAX)
    in_band("nuts tuned step", out.kernel.step_size, NUTS_STEP, NUTS_STEP_JAX)
    in_band("nuts max|mean|", m1, NUTS_ERR, NUTS_ERR_JAX)
    # the counters against what the sampling run's steps reported: the sum
    # of their leapfrogs plus one evaluation a chain at each start
    check(steps == NUTS_ITERS and st.n_target_gradient_calls == grads == calls
          == st.n_target_calls and grads > NUTS_C * NUTS_ITERS,
          f"nuts counter law: stats {st.n_target_calls} / {st.n_target_gradient_calls}, the steps "
          f"reported {calls} / {grads} over {steps} steps")
    check(not sh, f"nuts launched a coupling kernel: {dict(sh)}")
    lap("phase 12")

    # ---- 12a. chees_hmc at 1024 chains -------------------------------------------------
    def chees(n_warm, n_iter, seed=0):
        return nfmc_torch.sample(DiagonalGaussian1(n_dim=D), strategy="chees_hmc", flow=None,
                                 n_chains=CHEES_C, n_warmup_iterations=n_warm,
                                 n_iterations=n_iter, warmup=True,
                                 param_kwargs={"store_samples": False}, seed=seed,
                                 show_progress=False)

    chees(2, 2)  # warm
    out, wall, sh, ins, rep, (s,) = timed("chees_hmc", lambda: chees(CHEES_WARM, CHEES_ITERS),
                                          CheesHMC)
    st, k = out.statistics, out.kernel
    wall_s = wall - ins.inner_s
    sigma = np.tile(np.arange(1, 11), D // 10)[:D].astype(np.float64)
    err = float(np.max(np.abs(out.mean) / sigma))
    lf = st.n_target_gradient_calls / (2 * CHEES_ITERS * CHEES_C)
    calls, grads, steps = rep.totals(False)
    res["chees_it_per_s"] = CHEES_ITERS / wall_s
    res["chees_grads_per_s"] = st.n_target_gradient_calls / wall_s
    print(f"chees_hmc ({CHEES_C} chains, DiagonalGaussian1({D}), {CHEES_WARM} warmup + "
          f"{CHEES_ITERS} it): wall {wall:.3f} s, of which warmup {ins.inner_s:.3f} s "
          f"(captured: its leapfrogs in scopes, no host read); sampling {wall_s:.3f} s, "
          f"{res['chees_it_per_s']:.2f} it/s, {res['chees_grads_per_s']:.0f} gradient calls/s "
          f"(counted, 2LC), trajectory {k.trajectory_length:.4f}, step {k.step_size:.6f}, "
          f"{lf:.4f} leapfrogs an iteration, acc {st.acceptance_rate:.6f}, max|mean|/sigma "
          f"{err:.4f}, divergences {st.n_divergences}")
    profile_window(lambda: chees(2, 50, seed=1), "chees_hmc, 2 warmup + 50 it")
    check(out.samples is None and np.isfinite(out.mean).all(), "chees_hmc: store_samples=False")
    in_band("chees_hmc trajectory", k.trajectory_length, CHEES_TRAJ, CHEES_TRAJ_JAX)
    in_band("chees_hmc step", k.step_size, CHEES_STEP, CHEES_STEP_JAX)
    in_band("chees_hmc leapfrogs an iteration", lf, CHEES_LF, CHEES_LF_JAX)
    in_band("chees_hmc acceptance", st.acceptance_rate, CHEES_ACC, CHEES_ACC_JAX)
    in_band("chees_hmc max|mean|/sigma", err, CHEES_ERR, CHEES_ERR_JAX)
    check(steps == CHEES_ITERS and grads == st.n_target_gradient_calls
          and calls == st.n_target_calls == grads + 2 * CHEES_C * CHEES_ITERS,
          f"chees_hmc counter law: stats {st.n_target_calls} / {st.n_target_gradient_calls}, the "
          f"steps reported {calls} / {grads} over {steps} steps")
    lap("phase 12a")

    # ---- 12b. ess, with the warmup's ellipse adaptation --------------------------------
    n_ess = len(ESS_SIG)
    ess_target = DiagonalGaussian(np.zeros(n_ess, np.float32), ESS_SIG)

    def ess(n_warm, n_iter, seed=0):
        return nfmc_torch.sample(ess_target, strategy="ess", flow=None,
                                 negative_log_likelihood=residual_nll(ESS_SIG), n_chains=ESS_C,
                                 n_warmup_iterations=n_warm, n_iterations=n_iter, warmup=True,
                                 param_kwargs={"store_samples_on_device": True}, seed=seed,
                                 show_progress=False)

    ess(2, 2)  # warm
    out, wall, sh, ins, rep, (s,) = timed("ess", lambda: ess(ESS_WARM, ESS_ITERS), ESS)
    st = out.statistics
    wall_s = wall - ins.inner_s
    sig64 = ESS_SIG.astype(np.float64)
    m1 = float(np.max(np.abs(out.mean) / sig64))
    m2 = float(np.max(np.abs(out.variance / sig64 ** 2 - 1)))
    res["ess_it_per_s"] = ESS_ITERS / wall_s
    print(f"ess ({ESS_C} chains, sigma {np.round(ESS_SIG, 3).tolist()}, {ESS_WARM} warmup + "
          f"{ESS_ITERS} it): wall {wall:.3f} s, sampling {wall_s:.3f} s, "
          f"{res['ess_it_per_s']:.1f} it/s, acc {st.acceptance_rate:.6f}, max|mean|/sigma "
          f"{m1:.4f}, max|var/sigma^2 - 1| {m2:.4f}, adapted ellipse variances "
          f"{np.round(np.diag(s.kernel.cov), 4).tolist()}")
    res["ess_ess_per_s"] = ess_per_second(out, wall_s, max_window=4096, what="ess")
    check(tuple(out.samples.shape) == (ESS_ITERS, ESS_C, n_ess)
          and bool(torch.isfinite(out.samples).all()), "ess draws")
    in_band("ess max|mean|/sigma", m1, ESS_MEAN, ESS_MEAN_JAX)
    in_band("ess max|var/sigma^2 - 1|", m2, ESS_VAR, ESS_VAR_JAX)
    check(st.n_target_calls == (5 + 1) * ESS_C * ESS_ITERS and st.n_target_gradient_calls == 0
          and st.acceptance_rate == 1.0, "ess counter contract ((max_iter + 1) B calls, mask = ones)")
    # the corrected likelihood on the card against float64 on the host, at
    # the run's adapted ellipse and at a dense one in d=100 (where a TF32
    # product would miss by ~1e-3 relative)
    g12 = torch.Generator().manual_seed(12)
    cases = [(s, s._adapted_cov64, residual_nll(ESS_SIG.astype(np.float64)), n_ess)]
    a = torch.randn((D, D), generator=g12, dtype=torch.float64)
    dense = (a @ a.T / D + 0.5 * torch.eye(D, dtype=torch.float64)).numpy()
    s100 = ESS((D,), target, target, device=dev)
    s100._apply_ellipse_adaptation(dense)
    cases.append((s100, dense, lambda x: 0.5 * (x * x).sum(-1), D))
    for sampler, cov64, base64, d in cases:
        x = 2 * torch.randn((1000, d), generator=g12)
        got = sampler.negative_log_likelihood(x.to(dev)).double().cpu()
        S = np.diag(np.maximum(cov64, 1e-6)) if cov64.ndim == 1 else 0.5 * (cov64 + cov64.T)
        chol = np.linalg.cholesky(S)
        x64 = x.double().numpy()
        y = np.linalg.solve(chol, x64.T).T
        lp_new = -0.5 * (y * y).sum(-1) - np.log(np.diag(chol)).sum()
        want = base64(x.double()).numpy() + lp_new + 0.5 * (x64 * x64).sum(-1)
        e = float(np.max(np.abs(got.numpy() - want)) / max(1.0, np.abs(want).max()))
        print(f"ess corrected nll on the card against float64 (d={d}, "
              f"{'diagonal' if cov64.ndim == 1 else 'dense'} ellipse, 1000 points): max|diff| / "
              f"max(1, max|ref|) {e:.3e}")
        check(e <= 1e-5, f"ess: the corrected nll at d={d} is off float64 by {e}")
    lap("phase 12b")

    # ---- 12c. jump_ess, jump_nuts, jump_chees in the headline setting ----------------------
    mu = np.full(D, JUMP12_MU, np.float32)
    misfit = DiagonalGaussian(mu, np.float32(1.0))
    res["jump"] = {}
    for kind, cls in (("ess", ESS), ("nuts", NUTS), ("chees", CheesHMC)):
        kw = {}
        if kind == "ess":
            m = device_copies(torch.as_tensor(mu))
            kw["negative_log_likelihood"] = CallablePotential(
                lambda x, m=m: (0.5 * m(x.device) ** 2 - m(x.device) * x).sum(-1), (D,))
        if kind == "nuts":
            kw["inner_kernel_kwargs"] = {"step_size": JUMP12_NUTS_STEP}

        def run(kw=kw, kind=kind, n_outer=JUMP12_OUTER, seed=0):
            return nfmc_torch.sample(misfit, strategy=f"jump_{kind}", flow=identity_flow(),
                                     n_chains=C, n_iterations=n_outer,
                                     inner_param_kwargs={"n_iterations": JUMP12_INNER},
                                     param_kwargs={"store_samples_on_device": True}, seed=seed,
                                     show_progress=False, **kw)

        run(n_outer=2)  # warm
        # counted as StepReports counts steps: a replay counts its capture's
        redraws = collections.Counter()
        orig_resample = ESS.resample_x0_fn

        def counted(self, *a):
            build.tally(redraws, 0)
            return orig_resample(self, *a)

        ESS.resample_x0_fn = counted
        try:
            out, wall, sh, _, rep, (s,) = timed(f"jump_{kind}", run, cls)
        finally:
            ESS.resample_x0_fn = orig_resample
        st = out.statistics
        calls, grads, steps = rep.totals(False)
        n_steps = JUMP12_OUTER * JUMP12_INNER
        static = n_steps * s.inner_sampler.calls_per_iter(C) + JUMP12_OUTER * 2 * C
        res["jump"][kind] = (JUMP12_OUTER / wall, st.jump_acceptance_rate)
        print(f"jump_{kind} ({C} chains, {JUMP12_INNER} inner it, {JUMP12_OUTER} outer it, target "
              f"N({JUMP12_MU} * 1, I)): wall {wall:.3f} s, {JUMP12_OUTER / wall:.2f} outer it/s, "
              f"{st.n_target_gradient_calls / wall:.0f} gradient calls/s, jump acc "
              f"{st.jump_acceptance_rate:.6f}, inner acc {st.acceptance_rate:.6f}, counters "
              f"{st.n_target_calls} / {st.n_target_gradient_calls} (the inner steps reported "
              f"{calls} / {grads} dynamic over {steps} steps), prior redraws {redraws[0]}, "
              f"launches by shape {dict(sh)}")
        res[f"jump_{kind}_ess_per_s"] = ess_per_second(out, wall, max_window=4096,
                                                       what=f"jump_{kind}")
        check(tuple(out.samples.shape) == (JUMP12_OUTER * (JUMP12_INNER + 1), C, D)
              and bool(torch.isfinite(out.samples).all()), f"jump_{kind}: the interleaving law")
        check(steps == n_steps and st.n_target_calls == static + calls
              and st.n_target_gradient_calls == n_steps * s.inner_sampler.grads_per_iter(C) + grads
              and st.n_attempted_jumps == JUMP12_OUTER * C
              and st.n_attempted_trajectories == n_steps * C,
              f"jump_{kind}: the counters (static + dynamic) disagree with the steps' reports")
        band, jax_range = JUMP12_ACC[kind]
        in_band(f"jump_{kind} jump acceptance", st.jump_acceptance_rate, band, jax_range)
        check(redraws[0] == (JUMP12_OUTER if kind == "ess" else 0),
              f"jump_{kind}: {redraws[0]} prior redraws for {JUMP12_OUTER} outer iterations")
        # one hoisted chunk of proposals, one forward (log q of the current
        # state) a jump
        check(sh == {("stack", "inverse", JUMP12_OUTER * C): 1,
                     ("stack", "forward", C): JUMP12_OUTER}, f"jump_{kind} launch law: {dict(sh)}")
    lap("phase 12c")

    # ---- 12d. neutra_chees, the identity-init flow frozen ---------------------------------------
    def neutra_chees(n_warm, n_iter, seed=0):
        return nfmc_torch.sample(target, strategy="neutra_chees", flow=identity_flow(),
                                 n_chains=C, n_warmup_iterations=n_warm, n_iterations=n_iter,
                                 warmup=True,
                                 param_kwargs={"warmup_fit_kwargs": {"n_epochs": 0},
                                               "store_samples_on_device": True},
                                 seed=seed, show_progress=False)

    neutra_chees(2, 5)  # warm
    out, wall, sh, ins, rep, (s,) = timed(
        "neutra_chees", lambda: neutra_chees(NEUTRA_CHEES_WARM, NEUTRA_CHEES_ITERS), CheesHMC)
    st, k = out.statistics, out.kernel
    inner = s.inner_sampler
    n_all = NEUTRA_CHEES_WARM + NEUTRA_CHEES_ITERS
    lf_sample = st.n_target_gradient_calls // (2 * C)
    lf_all = inner.leapfrog_total
    wall_s = wall - ins.inner_s - ins.vfit_s
    m1, m2 = float(np.abs(out.mean).max()), float(np.abs(out.second_moment - 1).max())
    res["neutra_chees_it_per_s"] = NEUTRA_CHEES_ITERS / wall_s
    print(f"neutra_chees (identity flow, {NEUTRA_CHEES_WARM} warmup + {NEUTRA_CHEES_ITERS} it): "
          f"wall {wall:.3f} s, sampling {wall_s:.3f} s, {res['neutra_chees_it_per_s']:.1f} it/s, "
          f"{st.n_target_gradient_calls / wall_s:.0f} gradient calls/s, step {k.step_size:.6f}, "
          f"trajectory {k.trajectory_length:.4f}, leapfrogs {lf_all} in all ({lf_sample} sampling, "
          f"{lf_sample / NEUTRA_CHEES_ITERS:.3f} an iteration), acc {st.acceptance_rate:.6f}, "
          f"max|mean| {m1:.4f}, max|E[x^2]-1| {m2:.4f}, launches by shape {dict(sh)}")
    flow = out.kernel.flow
    res["neutra_chees_ess_per_s"] = ess_per_second(
        out, wall_s, max_window=4096, what="neutra_chees (data space)",
        transform=lambda z: flow.bijection.inverse_fn(flow.params, z)[0])
    profile_window(lambda: neutra_chees(2, 20, seed=1), "neutra_chees, 2 warmup + 20 it")
    check(tuple(out.samples.shape) == (NEUTRA_CHEES_ITERS, C, D)
          and bool(torch.isfinite(out.samples).all()), "neutra_chees draws")
    in_band("neutra_chees acceptance", st.acceptance_rate, NEUTRA_CHEES_ACC, NEUTRA_CHEES_ACC_JAX)
    check(m1 <= NEUTRA_CHEES_MOMENTS[0] and m2 <= NEUTRA_CHEES_MOMENTS[1],
          f"neutra_chees moments {m1}, {m2} above {NEUTRA_CHEES_MOMENTS}")
    check(st.n_target_calls == st.n_target_gradient_calls + 2 * C * NEUTRA_CHEES_ITERS
          and rep.totals(False)[1] == st.n_target_gradient_calls, "neutra_chees counter law")
    # each iteration's L_i + 1 gradient passes (an inverse and an inverse
    # VJP each) and the data transform's inverse, over the warmup and the run
    check(sh == {("stack", "inverse", C): lf_all + 2 * n_all,
                 ("vjp", "inverse", C): lf_all + n_all},
          f"neutra_chees launch law from the run's sum L_i = {lf_all}: {dict(sh)}")
    lap("phase 12d")

    run_mcmc_card_vs_cpu(dev)
    lap("phase 12e")

    # ---- 12f. ESS against the JAX package's draws ----------------------------------------------
    ref = np.load(Path(__file__).resolve().parent / ESS_DRAWS)["draws"]

    def ess_ab():
        return nfmc_torch.sample(ess_target, strategy="ess", flow=None,
                                 negative_log_likelihood=residual_nll(ESS_SIG), n_chains=ESS_AB_C,
                                 n_iterations=ESS_AB_ITERS, seed=ESS_AB_SEED, show_progress=False,
                                 param_kwargs={"store_samples_on_device": True})

    out = ess_ab()
    check(out.samples.device.type == "cuda", "ess two-sample run: the draws are not on the card")
    report = mcmc_two_sample_report(ref, out.samples.cpu().numpy(), alpha=0.01,
                                    rng=np.random.default_rng(0))
    print(f"ess two-sample test against the JAX package's draws ({ESS_DRAWS}, {ref.shape}): "
          f"ks_max {report['ks_max']}, p {report['ks_p_value']}; energy "
          f"{report['energy_distance']}, p {report['energy_p_value']}; ok {report['ok']}")
    check(report["ok"], "ess: the card's draws fail the two-sample test against the JAX package's")
    lap("phase 12f")
    return res


def run_mcmc_card_vs_cpu(dev) -> None:
    """Phase 12e: one step of each sampler with the same injected draws on
    the card and on the CPU."""
    from nfmc_torch.flows import Flow, RealNVP
    from nfmc_torch.potentials import DiagonalGaussian1, StandardGaussian
    from nfmc_torch.samplers.mcmc import ESS, NUTS, CheesHMC, CheesHMCKernel, NUTSKernel
    from nfmc_torch.samplers.mcmc.ess import elliptical_slice_sampling_step
    from nfmc_torch.samplers.mcmc.nuts_impl import make_nuts_step
    from nfmc_torch.samplers.nfmc import NeuTraChEES, NeuTraKernel

    target = StandardGaussian((D,))
    # NUTS at 1024 x 100: in float64 the step's decisions (U-turns, the
    # multinomial picks) cannot part by rounding, so every chain's leapfrog
    # count, mask and end state must agree; in float32 a decision within
    # rounding of its threshold may part, and the chains that agree must
    # agree to 1e-5
    s = NUTS((D,), target, NUTSKernel(event_size=D, max_tree_depth=NUTS_DEPTH), device="cpu")
    draws = s.make_draws()(torch.Generator().manual_seed(120), (), NUTS_C)
    x0 = torch.randn((NUTS_C, D), generator=torch.Generator().manual_seed(121))
    step = make_nuts_step(target, (D,), max_tree_depth=NUTS_DEPTH)
    for dtype in (torch.float64, torch.float32):
        got = {}
        for device in ("cpu", dev):
            d_ = tuple(t.to(device) if t.dtype == torch.bool else t.to(device, dtype)
                       for t in draws)
            with torch.no_grad():
                got[device] = [t.cpu() for t in step(
                    x0.to(device, dtype), torch.tensor(NUTS_STEP_12E, dtype=dtype, device=device),
                    torch.ones(D, dtype=dtype, device=device), d_)]
        (zc, mc, dc, ac, nc, depc), (zg, mg, dg, ag, ng, depg) = got["cpu"], got[dev]
        same = (nc == ng) & (mc == mg) & (dc == dg)
        e = ((zg - zc).abs() / torch.clamp(zc.abs(), min=1.0)).max(-1).values
        e_same = float(e[same].max()) if bool(same.any()) else 0.0
        print(f"nuts step card vs CPU ({dtype}, {NUTS_C} x {D}, step {NUTS_STEP_12E}): leapfrogs "
              f"{int(nc.sum())} / {int(ng.sum())}, tree depth max {int(depc.max())}, chains whose "
              f"leapfrog count, mask and divergence agree {int(same.sum())} of {NUTS_C}, "
              f"their end states max|diff| / max(1, |x|) {e_same:.3e}, acceptance statistics "
              f"max|diff| {float((ag - ac)[same].abs().max()):.3e}")
        if dtype == torch.float64:
            check(bool(same.all()) and e_same <= 1e-12, "nuts step (float64): card and CPU part")
        else:
            check(e_same <= 1e-5 and int((~same).sum()) <= NUTS_C // 100,
                  "nuts step (float32): card and CPU part beyond rounding")

    # ChEES: a tuning step and a sampling step on DiagonalGaussian1(100)
    for tuning in (True, False):
        got = {}
        g = torch.Generator().manual_seed(122 + tuning)
        x0 = torch.randn((CHEES_C, D), generator=g) * 3
        kern = dict(event_size=D, step_size=0.4, trajectory_length=6.0)
        for device in ("cpu", dev):
            cs_ = CheesHMC((D,), DiagonalGaussian1(n_dim=D), CheesHMCKernel(**kern), device=device)
            d_ = tuple(t.to(device) for t in cs_.make_draws()(torch.Generator().manual_seed(124),
                                                            (), CHEES_C))
            with torch.no_grad():
                x1, st1, info = cs_._make_step_aux(tuning)(x0.to(device),
                                                           cs_.kernel.make_state(device), d_)
            got[device] = (x1.cpu(), float(st1.step_size), float(st1.log_t), int(info.n_grads),
                           int(info.n_accepted))
        e = (got[dev][0] - got["cpu"][0]).abs().max().item()
        print(f"chees {'tuning' if tuning else 'sampling'} step card vs CPU ({CHEES_C} x {D}): L "
              f"{got[dev][3] // (2 * CHEES_C)} / {got['cpu'][3] // (2 * CHEES_C)}, states max|diff| "
              f"{e:.3e}, accepted {got[dev][4]} / {got['cpu'][4]}, step {got[dev][1]:.6f} / "
              f"{got['cpu'][1]:.6f}, log T {got[dev][2]:.6f} / {got['cpu'][2]:.6f}")
        check(got[dev][3] == got["cpu"][3] and e <= TOL and got[dev][4] == got["cpu"][4]
              and abs(got[dev][1] - got["cpu"][1]) <= TOL and abs(got[dev][2] - got["cpu"][2]) <= TOL,
              "chees step on the card disagrees with the CPU")

    # ESS: one step with a Cholesky ellipse
    g = torch.Generator().manual_seed(125)
    a = torch.randn((D, D), generator=g)
    cov = (a @ a.T / D + 0.5 * torch.eye(D)).numpy()
    x0 = torch.randn((C, D), generator=g)
    got = {}
    for device in ("cpu", dev):
        es = ESS((D,), target, target, device=device)
        es.kernel.cov = cov
        d_ = tuple(t.to(device) for t in es.make_draws()(torch.Generator().manual_seed(126), (), C))
        with torch.no_grad():
            xd = x0.to(device)
            f1, nll1, acc1 = elliptical_slice_sampling_step(xd, target, (D,), d_,
                                                            chol=es.kernel.make_state(device).chol)
        got[device] = (f1.cpu(), nll1.cpu(), acc1.cpu())
    e = max((got[dev][i] - got["cpu"][i]).abs().max().item()
            / max(1.0, got["cpu"][i].abs().max().item()) for i in (0, 1))
    print(f"ess step card vs CPU ({C} x {D}, a dense ellipse): states and nll max|diff| / max(1, "
          f"max|ref|) {e:.3e}, accepted {int(got[dev][2].sum())} / {int(got['cpu'][2].sum())}, "
          f"masks equal {torch.equal(got[dev][2], got['cpu'][2])}")
    check(e <= 1e-5 and torch.equal(got[dev][2], got["cpu"][2]), "ess step on the card disagrees")

    # NeuTra-ChEES: the gradient of U~ through a perturbed flow
    pert = perturbed_params(D, H, L, seed=127, device="cpu")
    z0 = torch.randn((C, D), generator=torch.Generator().manual_seed(128))
    got = {}
    for device in ("cpu", dev):
        f = Flow(RealNVP((D,), n_layers=L, hidden_size=H))
        f.params = [{k: [t.to(device) for t in v] for k, v in p.items()} for p in pert]
        nc_ = NeuTraChEES((D,), target, kernel=NeuTraKernel((D,), flow=f), device=device)
        z = z0.to(device).requires_grad_(True)
        (g_z,) = torch.autograd.grad(nc_.adjusted_target(z).sum(), z)
        got[device] = g_z.cpu()
    e_g, g_max = (got["cpu"] - got[dev]).abs().max().item(), got["cpu"].abs().max().item()
    print(f"neutra_chees card vs CPU (d={D}, perturbed flow): gradient of U~ max|diff| {e_g:.3e} "
          f"(max|g| {g_max:.4g})")
    check(e_g <= TOL * g_max, "neutra_chees: the gradient of U~ on the card disagrees")


def jax_band(lo_hi, errors=False):
    """The gate around the JAX package's range over seeds 0-7: from half the
    low (0 for an error, where less is never a fault) to 1.5 times the
    high; with the range printed beside it."""
    lo, hi = lo_hi
    return (0.0 if errors else 0.5 * lo, 1.5 * hi), f"{lo:.6f}-{hi:.6f}"


def run_last_strategy_phases(dev) -> dict:
    """Phases 13-13d: dense_hmc / dense_mala beside hmc / mala at bench.py's
    dense_metric sizes, pt_mala / pt_mh / pt_hmc beside mala at its
    pt_multimodal sizes, aies at 1024 walkers and jump_aies in the jump
    setting, through the front door; then one step of each on the card
    against the CPU. Returns the launches by shape of jump_aies and the
    numbers the summary prints."""
    import nfmc_torch
    from nfmc_torch.diagnostics import effective_sample_size
    from nfmc_torch.flows import Flow, RealNVP
    from nfmc_torch.ops import build
    from nfmc_torch.potentials import DiagonalGaussian, FullRankGaussian, GaussianMixture
    from nfmc_torch.potentials import StandardGaussian

    res = {"shapes": {}}
    t_last = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        print(f"[{what}: {now - t_last[0]:.1f} s]")
        t_last[0] = now

    def timed(run):
        """``run()``'s result and wall (ending in a synchronise), with its
        coupling launches by shape; the launch counts set to 0 just before."""
        build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ShapeLaunches() as shapes:
            out = run()
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0, shapes.n

    # ---- 13. dense metric at bench.py's dense_metric sizes ------------------------------
    q, eigs, chol = dense_metric_targets()
    targets = {"corr": (FullRankGaussian(np.zeros(D, np.float32), chol), q, np.sqrt(eigs)),
               "iso": (StandardGaussian((D,)), None, np.ones(D))}
    q_dev = torch.as_tensor(q, dtype=torch.float32, device=dev)
    min_ess, res["dense"] = {}, {}
    for kind, strategy in DENSE_RUNS:
        target, qk, scale = targets[kind]
        s = nfmc_torch.create_sampler(target, event_shape=(D,), strategy=strategy,
                                      param_kwargs={"n_iterations": DENSE_ITERS,
                                                    "n_warmup_iterations": DENSE_WARM,
                                                    "store_samples_on_device": True})
        x0 = torch.as_tensor(dense_x0(kind, 0), device=dev)
        _, warm_wall, sh_w = timed(lambda: s.warmup(x0, show_progress=False, seed=1))
        out, wall, sh = timed(lambda: s.sample(x0, show_progress=False, seed=2))
        draws = out.samples
        check(draws.device.type == "cuda" and tuple(draws.shape) == (DENSE_ITERS, C, D)
              and bool(torch.isfinite(draws).all()), f"{kind} {strategy}: the draws")
        check(not sh and not sh_w, f"{kind} {strategy} launched a coupling kernel")
        if qk is not None:
            draws = draws @ q_dev  # into the true eigenbasis
        ess = effective_sample_size(draws, max_window=DENSE_WINDOW, dim_slab=25)
        ess_mean, ess_min = float(ess.mean()), float(ess.min())
        err = float(np.max(draws.reshape(-1, D).double().mean(0).abs().cpu().numpy() / scale))
        scalar = bool(getattr(s.kernel, "_resume_scalar_mode", False))
        min_ess[(kind, strategy)] = ess_min
        res["dense"][f"{kind} {strategy}"] = (ess_mean / wall, ess_min / wall, DENSE_ITERS / wall)
        print(f"dense_metric {kind} {strategy} (d={D}, {C} chains, {DENSE_WARM} warmup + "
              f"{DENSE_ITERS} it): warmup {warm_wall:.3f} s, sampling {wall:.3f} s "
              f"({DENSE_ITERS / wall:.1f} it/s), ESS mean {ess_mean:.1f} ({ess_mean / wall:.1f} "
              f"ESS/s), worst eigen-direction {ess_min:.1f} ({ess_min / wall:.1f} ESS/s), "
              f"max|mean|/sigma {err:.4f}, scalar mode {scalar}, acc "
              f"{out.statistics.acceptance_rate:.4f}, step {s.kernel.step_size:.5f}")
        bands = DENSE_JAX[(kind, strategy)]
        for what, v, errors in (("ESS mean", ess_mean, False), ("worst-direction ESS", ess_min, False),
                                ("max|mean|/sigma", err, True)):
            in_band(f"{kind} {strategy} {what}", v, *jax_band(bands[what], errors))
        if strategy.startswith("dense"):
            check(scalar == DENSE_SCALAR[kind],
                  f"{kind} {strategy}: scalar mode {scalar}, the JAX package's {DENSE_SCALAR[kind]} "
                  "at every seed")
        calls = {"hmc": 42, "dense_hmc": 42, "mala": 2, "dense_mala": 2}[strategy]
        check(out.statistics.n_target_calls == DENSE_ITERS * calls * C,
              f"{kind} {strategy}: counters")
    ratios = {k: min_ess[("corr", f"dense_{k}")] / min_ess[("corr", k)] for k in ("hmc", "mala")}
    res["dense_ratios"] = ratios
    for k, v in ratios.items():
        in_band(f"worst-direction ESS ratio dense_{k} / {k} (correlated, wall-free)", v,
                *jax_band(DENSE_RATIO_JAX[k]))
    # bench.py:1434-1436's own criterion
    check(ratios["hmc"] > 2.0 and ratios["mala"] > 2.0,
          f"dense does not win on the correlated target: {ratios}")
    lap("phase 13")

    # ---- 13a. parallel tempering at bench.py's pt_multimodal sizes ---------------------
    means = np.stack([np.full(PT_D, -PT_MODE), np.full(PT_D, PT_MODE)]).astype(np.float32)
    gm = GaussianMixture(means, sigma=1.0)
    x0_pt = torch.as_tensor(pt_x0(0), device=dev)
    res["pt"] = {}
    for strategy in PT_RUNS:
        kw = ({"kernel_kwargs": {"n_temps": PT_TEMPS, "beta_min": PT_BETA_MIN}}
              if strategy.startswith("pt_") else {})

        def run(n=PT_ITERS, seed=0, kw=kw, strategy=strategy):
            return nfmc_torch.sample(gm, strategy=strategy, n_chains=PT_C, n_iterations=n,
                                     x0=x0_pt, warmup=False, seed=seed, show_progress=False,
                                     param_kwargs={"store_samples_on_device": True}, **kw)

        run(n=2)  # warm
        out, wall, sh = timed(run)
        st = out.statistics
        check(tuple(out.samples.shape) == (PT_ITERS, PT_C, PT_D)
              and bool(torch.isfinite(out.samples).all()) and not sh, f"{strategy}: the draws")
        bal, sw = pt_mode_metrics(out.samples.cpu().numpy())
        swap = getattr(st, "swap_acceptance_rate", float("nan"))
        rates = getattr(out.kernel, "swap_acceptance_rates", None)
        res["pt"][strategy] = (PT_ITERS / wall, bal, swap)
        print(f"pt_multimodal {strategy} ({PT_C} chains, {PT_ITERS} it, modes +-{PT_MODE} in "
              f"{PT_D}-d, all started in mode 0): wall {wall:.3f} s, {PT_ITERS / wall:.1f} it/s, "
              f"balance error {bal:.4f}, switch rate {sw:.5f}, cold acc {st.acceptance_rate:.6f}, "
              f"swap acc {swap:.6f}, edge swap-rate EMAs "
              f"{None if rates is None else np.round(rates, 3).tolist()}")
        res["pt"][strategy] += (ess_per_second(out, wall, max_window=4096, what=strategy),)
        bands = PT_JAX[strategy]
        in_band(f"{strategy} cold acceptance", st.acceptance_rate, *jax_band(bands["cold acc"]))
        in_band(f"{strategy} balance error", bal, *jax_band(bands["balance error"], True))
        if strategy.startswith("pt_"):
            in_band(f"{strategy} swap acceptance", swap, *jax_band(bands["swap acc"]))
            n_temps_c = PT_TEMPS * PT_C
            law = {"pt_mala": (2, 2), "pt_mh": (2, 0), "pt_hmc": (22, 20)}[strategy]
            # edges 0, 2, 4, 6 on even iterations, 1, 3, 5 on odd ones
            check(st.n_target_calls == PT_ITERS * law[0] * n_temps_c
                  and st.n_target_gradient_calls == PT_ITERS * law[1] * n_temps_c
                  and st.n_attempted_swaps == PT_ITERS // 2 * (4 + 3) * PT_C,
                  f"{strategy}: the counter laws")
    # bench.py:1303-1306's criterion: PT finds mode 1, MALA stays in mode 0
    check(res["pt"]["pt_mala"][1] < 0.15 and res["pt"]["mala"][1] > 0.4,
          f"pt_mala balance {res['pt']['pt_mala'][1]}, mala {res['pt']['mala'][1]}")
    profile_window(lambda: nfmc_torch.sample(
        gm, strategy="pt_mala", n_chains=PT_C, n_iterations=20, x0=x0_pt, seed=1,
        kernel_kwargs={"n_temps": PT_TEMPS, "beta_min": PT_BETA_MIN}, show_progress=False),
        "pt_mala, 20 it")
    lap("phase 13a")

    # ---- 13b. aies at 1024 walkers ---------------------------------------------------
    sig = np.sqrt(np.diag(chol @ chol.T))
    s = nfmc_torch.create_sampler(targets["corr"][0], event_shape=(D,), strategy="aies",
                                  param_kwargs={"n_iterations": AIES_ITERS,
                                                "n_warmup_iterations": AIES_WARM,
                                                "store_samples_on_device": True})
    x0 = torch.as_tensor(dense_x0("corr", 0, n=AIES_C), device=dev)
    _, warm_wall, sh_w = timed(lambda: s.warmup(x0, show_progress=False, seed=1))
    out, wall, sh = timed(lambda: s.sample(x0, show_progress=False, seed=2))
    st = out.statistics
    mean = np.asarray(out.mean, dtype=np.float64)
    err = float(np.max(np.abs(mean @ q) / np.sqrt(eigs)))
    var_err = float(np.max(np.abs(np.asarray(out.variance) / sig ** 2 - 1)))
    res["aies_it_per_s"] = AIES_ITERS / wall
    print(f"aies ({AIES_C} walkers, the correlated target, {AIES_WARM} warmup + {AIES_ITERS} it): "
          f"warmup {warm_wall:.3f} s, sampling {wall:.3f} s ({AIES_ITERS / wall:.1f} it/s), a "
          f"{s.kernel.a:.5f}, acc {st.acceptance_rate:.6f}, max|mean|/sigma (eigenbasis) "
          f"{err:.4f}, max|var/sigma^2 - 1| {var_err:.4f}")
    res["aies_ess_per_s"] = ess_per_second(out, wall, max_window=DENSE_WINDOW, what="aies")
    check(tuple(out.samples.shape) == (AIES_ITERS, AIES_C, D)
          and bool(torch.isfinite(out.samples).all()) and not sh and not sh_w, "aies: the draws")
    in_band("aies tuned a", s.kernel.a, *jax_band(AIES_JAX["a"]))
    in_band("aies acceptance", st.acceptance_rate, *jax_band(AIES_JAX["acc"]))
    in_band("aies max|mean|/sigma", err, *jax_band(AIES_JAX["max|mean|/sigma"], True))
    in_band("aies max|var/sigma^2 - 1|", var_err, *jax_band(AIES_JAX["max|var/sigma^2-1|"], True))
    check(st.n_target_calls == 2 * AIES_C * AIES_ITERS and st.n_target_gradient_calls == 0,
          "aies: the counter law (2 C calls, no gradients)")
    del out
    lap("phase 13b")

    # ---- 13c. jump_aies in the jump setting ------------------------------------------
    mu = np.full(D, JUMP12_MU, np.float32)
    misfit = DiagonalGaussian(mu, np.float32(1.0))

    def jump(n_outer=JUMP12_OUTER, seed=0):
        return nfmc_torch.sample(misfit, strategy="jump_aies",
                                 flow=Flow(RealNVP((D,), n_layers=L, hidden_size=H), seed=0),
                                 n_chains=C, n_iterations=n_outer,
                                 inner_param_kwargs={"n_iterations": JUMP12_INNER},
                                 param_kwargs={"store_samples_on_device": True}, seed=seed,
                                 show_progress=False)

    jump(n_outer=2)  # warm
    out, wall, sh = timed(jump)
    res["shapes"]["jump_aies"] = sh
    st = out.statistics
    n_steps = JUMP12_OUTER * JUMP12_INNER
    res["jump_aies"] = (JUMP12_OUTER / wall, st.jump_acceptance_rate)
    print(f"jump_aies ({C} chains, {JUMP12_INNER} inner it, {JUMP12_OUTER} outer it, target "
          f"N({JUMP12_MU} * 1, I)): wall {wall:.3f} s, {JUMP12_OUTER / wall:.2f} outer it/s, jump "
          f"acc {st.jump_acceptance_rate:.6f}, inner acc {st.acceptance_rate:.6f}, counters "
          f"{st.n_target_calls} / {st.n_target_gradient_calls}, launches by shape {dict(sh)}")
    res["jump_aies_ess_per_s"] = ess_per_second(out, wall, max_window=4096, what="jump_aies")
    check(tuple(out.samples.shape) == (JUMP12_OUTER * (JUMP12_INNER + 1), C, D)
          and bool(torch.isfinite(out.samples).all()), "jump_aies: the interleaving law")
    check(st.n_target_calls == n_steps * 2 * C + JUMP12_OUTER * 2 * C
          and st.n_target_gradient_calls == 0 and st.n_attempted_jumps == JUMP12_OUTER * C
          and st.n_attempted_trajectories == n_steps * C, "jump_aies: the counters")
    in_band("jump_aies jump acceptance", st.jump_acceptance_rate,
            *jax_band(JUMP_AIES_JAX["jump acc"]))
    in_band("jump_aies inner acceptance", st.acceptance_rate, *jax_band(JUMP_AIES_JAX["inner acc"]))
    # one hoisted chunk of proposals, one forward (log q of the current
    # state) a jump
    check(sh == {("stack", "inverse", JUMP12_OUTER * C): 1, ("stack", "forward", C): JUMP12_OUTER},
          f"jump_aies launch law: {dict(sh)}")
    lap("phase 13c")

    run_last_card_vs_cpu(dev)
    lap("phase 13d")
    return res


def run_last_card_vs_cpu(dev) -> None:
    """Phase 13d: one step of each of phase 13's samplers on the card and on
    the CPU with the same injected draws and kernel state."""
    from nfmc_torch.potentials import FullRankGaussian, GaussianMixture
    from nfmc_torch.samplers.mcmc import (AIES, PTHMC, PTMALA, PTRWMH, DenseHMC, DenseHMCKernel,
                                          DenseHMCParameters, DenseLangevinKernel,
                                          DenseLangevinParameters, DenseMALA, PTKernel,
                                          PTParameters)

    q, eigs, chol = dense_metric_targets()
    target = FullRankGaussian(np.zeros(D, np.float32), chol)
    cov = ((q * eigs) @ q.T).astype(np.float32)

    def on_both(make, draws_of, x0, steps=1, tuning=False, state_fix=None):
        """``steps`` steps of ``make(device)``'s sampler from x0 with the
        same draws on each device: the positions, the carried state's
        tensors and the accept counts, per device."""
        got = {}
        g = torch.Generator().manual_seed(130)
        draws = [draws_of(make("cpu"), g) for _ in range(steps)]
        for device in ("cpu", dev):
            s = make(device)
            state = s.kernel.make_state(device)
            if state_fix is not None:
                state_fix(state)
            x = x0.to(device)
            state = s._augment_state(state, x)
            step = s._make_step_aux(tuning)
            accepted = []
            with torch.no_grad():
                for d in draws:
                    x, state, info = step(x, state, tuple(t.to(device) for t in d))
                    accepted.append(int(info.n_accepted))
            got[device] = (x.cpu(), state, accepted)
        return got["cpu"], got[dev]

    def rel(a, b):
        return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))

    # DenseHMC and DenseMALA: the correlated target's covariance as the
    # metric, the jitter gate open
    def jitter_on(state):
        state.jitter_frac = torch.ones_like(state.jitter_frac)

    x0 = torch.as_tensor(dense_x0("corr", 1))
    for name, make, step in (
            ("dense_hmc", lambda device: DenseHMC(
                (D,), target, DenseHMCKernel(event_size=D, step_size=0.3, mass_cov=cov),
                DenseHMCParameters(), device=device), 0.3),
            ("dense_mala", lambda device: DenseMALA(
                (D,), target, DenseLangevinKernel(event_size=D, step_size=0.6, mass_cov=cov),
                DenseLangevinParameters(), device=device), 0.6)):
        (xc, _, ac), (xg, _, ag) = on_both(
            make, lambda s, g: s.make_draws()(g, (), C), x0, state_fix=jitter_on)
        e = rel(xg, xc)
        print(f"{name} step card vs CPU ({C} x {D}, the correlated target's covariance as the "
              f"metric, step {step}): states max|diff| / max(1, max|x|) {e:.3e}, accepted "
              f"{ag} / {ac}, masks equal {torch.equal(xg != x0, xc != x0)}")
        check(e <= 1e-5 and ag == ac and torch.equal(xg != x0, xc != x0),
              f"{name} step on the card disagrees with the CPU")

    # the refresh from fixed EMA halves (an EMA weight of 0 keeps them): two
    # sample covariances of the correlated target (dense factors, eigh), and
    # at the patience two of N(0, I) with unit diagonals (mu = 1, r_diag = 0
    # and r ~ 0.01: scalar factors)
    rng = np.random.default_rng(131)
    z = rng.standard_normal((2, 400, D))
    iso = [np.cov(zi.T) for zi in z]
    for h in iso:
        np.fill_diagonal(h, 1.0)
    for label, halves, streak, want in (
            ("correlated", [np.cov((zi @ chol.T).T).astype(np.float32) for zi in z], 0, False),
            ("isotropic noise", [h.astype(np.float32) for h in iso], 1, True)):
        got = {}
        for device in ("cpu", dev):
            s = DenseHMC((D,), target, params=DenseHMCParameters(
                metric_adjustment=0.0, tune_step_size=False), device=device)
            st = s.kernel.make_state(device)
            st.cov_a, st.cov_b = (torch.as_tensor(h, device=device) for h in halves)
            st.t = s.params.metric_refresh_every - 1
            st.r_low_streak = torch.tensor(streak, dtype=torch.int32, device=device)
            new = s.make_update_kernel()(st, torch.zeros(C, D, device=device),
                                         torch.ones(C, dtype=torch.bool, device=device))
            got[device] = (new.chol.cpu(), new.chol_inv.cpu(), bool(new.scalar_mode))
        e_a, e_ai = rel(got[dev][0], got["cpu"][0]), rel(got[dev][1], got["cpu"][1])
        print(f"dense refresh card vs CPU ({label} halves, d={D}): chol max|diff| / max|ref| "
              f"{e_a:.3e}, chol_inv {e_ai:.3e}, scalar mode {got[dev][2]} / {got['cpu'][2]}")
        check(e_a <= 1e-4 and e_ai <= 1e-4 and got[dev][2] == got["cpu"][2] == want,
              f"dense refresh ({label}) on the card disagrees with the CPU")

    # a PT ladder step of each move, both parities, tuning (the ladder moves)
    means = np.stack([np.full(PT_D, -PT_MODE), np.full(PT_D, PT_MODE)]).astype(np.float32)
    gm = GaussianMixture(means, sigma=1.0)
    x0 = torch.as_tensor(pt_x0(1))
    for cls in (PTMALA, PTRWMH, PTHMC):
        def make(device, cls=cls):
            return cls((PT_D,), gm, PTKernel(event_size=PT_D, n_temps=PT_TEMPS,
                                             beta_min=PT_BETA_MIN), PTParameters(),
                       device=device)

        (xc, sc, ac), (xg, sg, ag) = on_both(make, lambda s, g: s.make_draws()(g, (), PT_C), x0,
                                             steps=2, tuning=True)
        e = max(rel(xg, xc), rel(sg[1].cpu(), sc[1]), rel(sg[0].betas.cpu(), sc[0].betas))
        same = (torch.equal(sg[0].swap_accepts.cpu(), sc[0].swap_accepts)
                and torch.equal(sg[0].swap_attempts.cpu(), sc[0].swap_attempts))
        # PT-HMC's hottest rung takes 10 leapfrogs of d^(-1/3) / sqrt(0.02) =
        # 3.3, which grow float32 rounding to ~1e-4: it is held at TOL, as
        # phase 12e's ChEES and the CPU tests' HMC after their leapfrogs
        tol = TOL if cls is PTHMC else 1e-5
        print(f"{cls.__name__} ladder steps card vs CPU (T={PT_TEMPS}, {PT_C} x {PT_D}, both "
              f"parities, tuning): states, hot rungs and betas max|diff| / max(1, max|ref|) "
              f"{e:.3e} (gate {tol:g}), cold accepted {ag} / {ac}, swaps an edge "
              f"{sg[0].swap_accepts.tolist()} / {sc[0].swap_accepts.tolist()}")
        check(e <= tol and ag == ac and same, f"{cls.__name__} on the card disagrees")

    # an AIES step (both halves) at 1024 walkers
    x0 = torch.as_tensor(dense_x0("corr", 1, n=AIES_C))
    (xc, sc, ac), (xg, sg, ag) = on_both(
        lambda device: AIES((D,), target, device=device),
        lambda s, g: s.make_draws()(g, (), AIES_C), x0)
    e = max(rel(xg, xc), rel(sg[1].cpu(), sc[1]))
    print(f"aies step card vs CPU ({AIES_C} x {D}): states and U max|diff| / max(1, max|ref|) "
          f"{e:.3e}, accepted {ag} / {ac}, masks equal {torch.equal(xg != x0, xc != x0)}")
    check(e <= 1e-5 and ag == ac and torch.equal(xg != x0, xc != x0),
          "aies step on the card disagrees with the CPU")


def run_flow_zoo_phases(dev) -> dict:
    """Phases 14-14e: the flows without a kernel (NICE, the masked, NAF and
    residual flows) on the card against the CPU, as self-target IMH
    proposals, IAF's reverse-KL warmup through the front door, jump_mala
    with NICE, and the repaired front-door faults. None of these flows may
    launch one of the four kernels."""
    import nfmc_torch
    from nfmc_torch.api.registry import create_flow_object
    from nfmc_torch.flows import from_jax_params
    from nfmc_torch.ops import build
    from nfmc_torch.potentials import CallablePotential, DiagonalGaussian, DiagonalGaussian1

    def counts():
        return {w.__name__: w.launches for w in build.WRAPPERS}

    def no_kernel(what):
        check(all(n == 0 for n in counts().values()),
              f"{what}: a RealNVP or spline kernel launched for a flow without one: {counts()}")

    res = {"ms": {}}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    t_phase = time.perf_counter()
    build.reset_launch_counts()

    # ---- 14a. each flow, card against CPU at the same weights ----------------------
    # The CPU side runs in worker processes while the card makes a first call
    # of each direction, discarded; once the workers have ended, each
    # direction's call is timed. A masked NAF flow's sequential direction
    # (ma-naf-* inverse, ia-naf-* forward: 1.6-3.8 s of host dispatch a call)
    # is called once, timed: by then its flow's other direction has run its
    # conditioner and masks, and the coupling NAF flows' inverses the same
    # bisection.
    x_np, z_np = zoo_inputs()
    inputs = {"forward": x_np, "inverse": z_np}
    order = sorted(ZOO_NAMES, key=lambda n: "naf" not in n or n.startswith("c-"))
    ctx = multiprocessing.get_context("spawn")

    def call(flow, direction):
        bij = flow.bijection
        fn = bij.inverse_fn if direction == "inverse" else bij.forward_fn
        return fn(flow.params, torch.from_numpy(inputs[direction]).to(dev))

    def once(name, direction):
        return zoo_masked_naf(name) and zoo_iterative(name, direction == "inverse")

    flows, outs = {}, {}
    with torch.no_grad():
        with concurrent.futures.ProcessPoolExecutor(ZOO_CPU_WORKERS, mp_context=ctx) as pool:
            futures = {name: pool.submit(zoo_cpu_reference, name) for name in order}
            for name in ZOO_NAMES:
                flow = flows[name] = create_flow_object(zoo_flow(name), (D,), seed=0)
                flow.params = from_jax_params(zoo_weights(zoo_flow(name)), device=dev)
                for direction in ("forward", "inverse"):
                    if not once(name, direction):
                        outs[name, direction] = call(flow, direction)
            refs = {name: f.result() for name, f in futures.items()}
        for name in ZOO_NAMES:
            for direction in ("forward", "inverse"):
                torch.cuda.synchronize()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = call(flows[name], direction)
                e1.record()
                e1.synchronize()
                res["ms"][name, direction] = e0.elapsed_time(e1)
                outs.setdefault((name, direction), out)
        no_kernel("14a")
        for name in ZOO_NAMES:
            line = []
            for direction in ("forward", "inverse"):
                y, ld = outs[name, direction]
                check(y.device.type == "cuda" and ld.device.type == "cuda",
                      f"{name}: the flow left the card")
                check(bool(torch.isfinite(y).all() and torch.isfinite(ld).all()),
                      f"{name} {direction}: non-finite output")
                (y, ld), (y_ref, ld_ref) = (y.cpu().numpy(), ld.cpu().numpy()), refs[name][direction]
                e = max(float(np.abs(y - y_ref).max()), float(np.abs(ld - ld_ref).max()))
                scale = max(1.0, float(np.abs(y_ref).max()), float(np.abs(ld_ref).max()))
                tol = zoo_tol(name, direction == "inverse")
                line.append(f"{direction} {res['ms'][name, direction]:.3f} ms"
                            f"{' (its first call)' if once(name, direction) else ''}, card vs CPU "
                            f"{e:.3e} (scale {scale:.1f}, tol {tol:g})")
                check(e <= tol * scale, f"{name} {direction}: card and CPU differ by {e} > "
                                        f"{tol} * {scale}")
            # the round trip through the cheap direction second
            bij, params = flows[name].bijection, flows[name].params
            if name.startswith("ia-"):
                back = bij.inverse_fn(params, outs[name, "forward"][0])[0]
                rt = (back.cpu() - torch.from_numpy(x_np)).abs().max().item()
            else:
                back = bij.forward_fn(params, outs[name, "inverse"][0])[0]
                rt = (back.cpu() - torch.from_numpy(z_np)).abs().max().item()
            rt_tol = ZOO_ROUND_TRIP
            print(f"14a {zoo_flow(name)} (d={D}, B={ZOO_B}, 0 kernel launches a call): "
                  + "; ".join(line)
                  + f"; round trip {rt:.3e} (tol {rt_tol:g})")
            check(rt <= rt_tol, f"{name}: the round trip ends {rt} from its start (> {rt_tol})")
    no_kernel("14a's round trips")
    print(f"14a: kernel launches {counts()}, {time.perf_counter() - t_phase:.1f} s ({smi})")

    # ---- 14b. self-target IMH: a frozen perturbed flow is proposal and target ---------
    for name in ZOO_NAMES:
        flow = create_flow_object(zoo_flow(name), (D,), seed=0)
        flow.params = from_jax_params(zoo_weights(zoo_flow(name)), device=dev)
        frozen = flow.params
        t0 = time.perf_counter()
        n_it = zoo_self_iters(name)
        sout = nfmc_torch.sample(
            CallablePotential(lambda x, flow=flow, frozen=frozen: -flow.log_prob_fn(frozen, x),
                              (D,)),
            flow=flow, n_chains=C, n_iterations=n_it, seed=0, show_progress=False,
            param_kwargs={"store_samples_on_device": True})
        torch.cuda.synchronize()
        sacc = sout.statistics.acceptance_rate
        lo = ZOO_SELF_ACC[name]
        print(f"14b {zoo_flow(name)} self-target IMH ({n_it} it, {C} chains): acc {sacc:.6f} "
              f"(gate >= {lo:.4f}), wall {time.perf_counter() - t0:.3f} s")
        check(sout.samples.device.type == "cuda" and bool(torch.isfinite(sout.samples).all()),
              f"{name} self-target IMH: non-finite draws or draws off the card")
        check(sacc >= lo, f"{name} self-target IMH acceptance {sacc} < {lo}: the flow's "
                          "forward, inverse and log-det disagree")
        no_kernel(f"{name} self-target IMH")

    # ---- 14c. IMH with the reverse-KL warmup through IAF ----------------------------
    target = DiagonalGaussian1(D)
    sigma = target.sigma.astype(np.float64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Instrument() as ins:
        wout = nfmc_torch.sample(target, flow="iaf", n_chains=C, n_iterations=ZOO_IAF_ITERS,
                                 warmup=True, param_kwargs={"store_samples_on_device": True},
                                 seed=0, show_progress=False)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sample_s = wall - ins.vfit_s
    acc = wout.statistics.acceptance_rate
    ratio = wout.variance / sigma ** 2
    z = np.abs(wout.mean) / sigma
    moments = {"median|var/sigma^2 - 1|": float(np.median(np.abs(ratio - 1))),
               "min var/sigma^2": float(ratio.min()), "max var/sigma^2": float(ratio.max()),
               "median|mean|/sigma": float(np.median(z))}
    ident = nfmc_torch.sample(target, flow="iaf", n_chains=C, n_iterations=ZOO_IAF_ITERS,
                              seed=0, show_progress=False).statistics.acceptance_rate
    ess_s = ess_per_second(wout, sample_s, max_window=4096, what="14c IAF IMH")
    print(f"14c IAF IMH with warmup on DiagonalGaussian1({D}), {ZOO_IAF_ITERS} it: wall "
          f"{wall:.3f} s, of which variational fit {ins.vfit_s:.3f} s over {ins.vfit_epochs} "
          f"Adam steps ({1e3 * ins.vfit_s / max(ins.vfit_epochs, 1):.3f} ms a step), sampling "
          f"{ZOO_IAF_ITERS / sample_s:.1f} it/s; acc {acc:.4f} (JAX package, CPU: "
          f"{ZOO_IAF_ACC_JAX}), identity IAF {ident:.6f}; "
          + ", ".join(f"{k} {v:.4f}" for k, v in moments.items()) + f" ({smi})")
    check(wout.samples.device.type == "cuda", "14c: the draws left the card")
    check(acc > ident, f"IAF IMH acceptance after warmup {acc} not above the identity's {ident}")
    check(ZOO_IAF_ACC[0] <= acc <= ZOO_IAF_ACC[1],
          f"IAF IMH acceptance after warmup {acc} outside {ZOO_IAF_ACC}")
    for k, (lo, hi) in ZOO_IAF_MOMENTS.items():
        check(lo <= moments[k] <= hi, f"IAF IMH after warmup: {k} {moments[k]} outside "
                                      f"[{lo}, {hi}]")
    no_kernel("14c IAF IMH")
    res["iaf"] = (ZOO_IAF_ITERS / sample_s, ess_s, 1e3 * ins.vfit_s / max(ins.vfit_epochs, 1))

    # ---- 14d. jump_mala with the identity-init NICE frozen, the misfit target ---------
    t0 = time.perf_counter()
    nout = nfmc_torch.sample(
        DiagonalGaussian(np.full(D, 0.12, np.float32), np.float32(1.0)), strategy="jump_mala",
        flow="nice", n_chains=C, n_iterations=ZOO_NICE_OUTER,
        inner_param_kwargs={"n_iterations": INNER_N}, seed=0, show_progress=False)
    torch.cuda.synchronize()
    jacc = nout.statistics.jump_acceptance_rate
    print(f"14d jump_mala with NICE (identity init, frozen) on N(0.12*1, I), {ZOO_NICE_OUTER} "
          f"outer it: jump acc {jacc:.4f}, MALA acc {nout.statistics.acceptance_rate:.4f}, "
          f"wall {time.perf_counter() - t0:.3f} s")
    check(0.30 <= jacc <= 0.50, f"NICE misfit jump acceptance {jacc} outside [0.30, 0.50]")
    no_kernel("14d jump_mala with NICE")

    # ---- 14e. the repaired faults on the card ---------------------------------------
    from nfmc_torch.potentials import StandardGaussian

    out = nfmc_torch.sample(StandardGaussian((D,)), n_chains=C, n_iterations=5, mesh=None,
                            checkpoint_path=None, checkpoint_segment_iterations=None,
                            checkpoint_save_samples=None, seed=0, show_progress=False)
    check(out.samples.shape == (5, C, D), "14e: sample() with the JAX keywords")
    sampler = nfmc_torch.create_sampler(StandardGaussian((D,)), strategy="jump_mala",
                                        param_kwargs={"n_iterations": 4, "fused_unroll_outer": 4,
                                                      "fused_unroll_inner": 2},
                                        inner_param_kwargs={"n_iterations": INNER_N})
    first = sampler.sample(torch.randn((C, D), device=dev), show_progress=False, seed=1)
    again = sampler.sample_continue(first.running_samples.last_sample, show_progress=False,
                                    seed=2)
    check(again.samples.shape == (4 * (INNER_N + 1), C, D) and bool(
        torch.isfinite(again.samples).all()), "14e: sample_continue on the card")
    check(sampler.kernel.flow.sample(3, True).shape == (3, D), "14e: Flow.sample(3, True)")
    print(f"14e: sample() with mesh / checkpoint_* None, jump_mala with fused_unroll_outer=4 and "
          f"sample_continue on the card ran")
    res["wall"] = time.perf_counter() - t_phase
    print(f"phase 14: {res['wall']:.1f} s ({smi})")
    return res


def run_last_flow_phases(dev) -> dict:
    """Phases 15-15d: the continuous, multiscale / Glow and convolutional
    flows on the card against the CPU under torch's default backend flags,
    Glow on phi^4 through jump_hmc, RNODE's reverse-KL warmup through IMH,
    and one short sample() for each of the registry's 48 names. None of the
    23 new flows may launch one of the four kernels."""
    import nfmc_torch
    from nfmc_torch.api.registry import PORTED_FLOWS
    from nfmc_torch.flows.base import hutchinson_probes
    from nfmc_torch.ops import build
    from nfmc_torch.potentials import DiagonalGaussian1, Phi4Lattice, StandardGaussian

    def counts():
        return {w.__name__: w.launches for w in build.WRAPPERS}

    def no_kernel(what):
        check(all(n == 0 for n in counts().values()),
              f"{what}: a RealNVP or spline kernel launched for a flow without one: {counts()}")

    res = {"ms": {}}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    t_phase = time.perf_counter()

    # ---- 15a. each case, card against CPU, under torch's default flags --------------
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's defaults
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("highest")
    try:
        print(f"15a runs under matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
              f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, float32 matmul precision "
              f"{torch.get_float32_matmul_precision()!r} (torch's defaults)")
        build.reset_launch_counts()
        # the production probes hash each row's bits: the same on both devices
        v = torch.from_numpy(np.random.default_rng(LAST_SEED).standard_normal(
            (LAST_B, D)).astype(np.float32))
        check(torch.equal(hutchinson_probes(v.to(dev), 4, 3).cpu(), hutchinson_probes(v, 4, 3)),
              "15a: hutchinson_probes differ between the card and the CPU")
        inputs, flows, outs = {}, {}, {}
        for case in LAST_CASES:
            flows[case] = last_flow(*case, device=dev)
            inputs[case] = last_inputs(case, device=dev)
        ctx = multiprocessing.get_context("spawn")
        order = sorted(LAST_CASES, key=lambda c: not c[0].startswith("conv-"))
        with torch.no_grad():
            with concurrent.futures.ProcessPoolExecutor(LAST_CPU_WORKERS, mp_context=ctx) as pool:
                futures = {case: pool.submit(last_cpu_reference, case, inputs[case])
                           for case in order}
                with FixedProbes():
                    for case in LAST_CASES:
                        bij, params = flows[case].bijection, flows[case].params
                        for direction, v in zip(("forward", "inverse"), inputs[case]):
                            fn = bij.inverse_fn if direction == "inverse" else bij.forward_fn
                            outs[case, direction] = fn(params, torch.from_numpy(v).to(dev))
                refs = {case: f.result() for case, f in futures.items()}
            for case in LAST_CASES:
                bij, params = flows[case].bijection, flows[case].params
                line = []
                for direction, v in zip(("forward", "inverse"), inputs[case]):
                    fn = bij.inverse_fn if direction == "inverse" else bij.forward_fn
                    with FixedProbes():
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        fn(params, torch.from_numpy(v).to(dev))
                        torch.cuda.synchronize()
                    res["ms"][case, direction] = 1e3 * (time.perf_counter() - t0)
                    y, ld = outs[case, direction]
                    check(y.device.type == "cuda" and bool(torch.isfinite(y).all()
                                                           and torch.isfinite(ld).all()),
                          f"15a {case} {direction}: non-finite output or off the card")
                    y, ld, (y_ref, ld_ref) = y.cpu().numpy(), ld.cpu().numpy(), refs[case][direction]
                    e = max(float(np.abs(y - y_ref).max()), float(np.abs(ld - ld_ref).max()))
                    scale = max(1.0, float(np.abs(y_ref).max()), float(np.abs(ld_ref).max()))
                    tol = last_tol(*case, direction)
                    line.append(f"{direction} {res['ms'][case, direction]:.2f} ms, card vs CPU "
                                f"{e:.3e} (scale {scale:.1f}, limit {tol:.3g})")
                    check(e <= tol * scale, f"15a {case} {direction}: card and CPU differ by "
                                            f"{e} > {tol} * {scale}")
                # with the flow's own probes (the production path): finite
                y, ld = bij.forward_fn(params, torch.from_numpy(inputs[case][0]).to(dev))
                check(bool(torch.isfinite(y).all() and torch.isfinite(ld).all()),
                      f"15a {case}: non-finite output with the flow's own probes")
                print(f"15a {case[0]} {case[1]} (B={LAST_B}, 0 kernel launches a call): "
                      + "; ".join(line))
        no_kernel("15a")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])
    print(f"15a: kernel launches {counts()}, {time.perf_counter() - t_phase:.1f} s; the script's "
          f"flags restored: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} ({smi})")

    # ---- 15b. phi^4 through jump_hmc with Glow ----------------------------------------
    build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Instrument() as ins:
        pout = nfmc_torch.sample(Phi4Lattice(**PHI4_KW), strategy="jump_hmc", flow="glow-realnvp",
                                 n_chains=PHI4_C, n_iterations=PHI4_ITERS, warmup=True, seed=0,
                                 param_kwargs={"flow_fit_kwargs": PHI4_FIT_KWARGS},
                                 show_progress=False)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    no_kernel("15b phi^4 with Glow")
    phi = pout.samples
    check(phi.shape == (PHI4_ITERS * 6, PHI4_C, 8, 8) and bool(torch.isfinite(phi).all()),
          f"15b: draws of shape {tuple(phi.shape)} or non-finite")
    abs_m = float(phi.double().mean(dim=(-1, -2)).abs().mean())
    jacc = pout.statistics.jump_acceptance_rate
    sample_s = wall - ins.inner_s - ins.fit_s
    res["phi4"] = (wall, PHI4_ITERS / sample_s, ins.fit_s, ins.steps)
    print(f"15b phi^4 (L=8, kappa=0.25, lam=0.022) jump_hmc with glow-realnvp, {PHI4_C} chains, "
          f"{PHI4_ITERS} outer it, warmup: wall {wall:.3f} s (inner warmup {ins.inner_s:.3f} s, "
          f"flow fit {ins.fit_s:.3f} s over {ins.steps} Adam steps, sampling "
          f"{PHI4_ITERS / sample_s:.2f} outer it/s) ({smi})")
    in_band("15b mean |m|", abs_m, PHI4_ABS_M, PHI4_ABS_M_JAX)
    in_band("15b jump acceptance", jacc, PHI4_JUMP, PHI4_JUMP_JAX)

    # ---- 15c. IMH with RNODE's reverse-KL warmup, the kinetic term in ----------------
    build.reset_launch_counts()
    target = DiagonalGaussian1(D)
    sigma = target.sigma.astype(np.float64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Instrument() as ins:
        rout = nfmc_torch.sample(target, flow="rnode", n_chains=C, n_iterations=RNODE_ITERS,
                                 warmup=True, param_kwargs={"store_samples_on_device": True,
                                                            "warmup_fit_kwargs": RNODE_FIT_KWARGS},
                                 seed=0, show_progress=False)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    no_kernel("15c RNODE IMH")
    sample_s = wall - ins.vfit_s
    flow = rout.kernel.flow
    with torch.no_grad():
        kinetic = float(flow.bijection.regularization(flow.params, rout.samples[-1]).mean())
    ratio = rout.variance / sigma ** 2
    moments = {"median|var/sigma^2 - 1|": float(np.median(np.abs(ratio - 1))),
               "min var/sigma^2": float(ratio.min()), "max var/sigma^2": float(ratio.max()),
               "median|mean|/sigma": float(np.median(np.abs(rout.mean) / sigma))}
    res["rnode"] = (wall, RNODE_ITERS / sample_s, 1e3 * ins.vfit_s / max(ins.vfit_epochs, 1))
    print(f"15c RNODE IMH with warmup on DiagonalGaussian1({D}), {RNODE_ITERS} it: wall "
          f"{wall:.3f} s, of which variational fit {ins.vfit_s:.3f} s over {ins.vfit_epochs} "
          f"Adam steps ({res['rnode'][2]:.3f} ms a step), sampling {res['rnode'][1]:.1f} it/s; "
          f"kinetic term at the draws {kinetic:.4e} (weight "
          f"{flow.bijection.regularization_weight}); "
          + ", ".join(f"{k} {v:.4f}" for k, v in moments.items()) + f" ({smi})")
    check(rout.samples.device.type == "cuda" and bool(torch.isfinite(rout.samples).all()),
          "15c: draws non-finite or off the card")
    check(np.isfinite(kinetic) and kinetic > 0, f"15c: the kinetic term is {kinetic}")
    in_band("15c acceptance", rout.statistics.acceptance_rate, RNODE_ACC, RNODE_ACC_JAX)
    for k, (lo, hi) in RNODE_MOMENTS.items():
        check(lo <= moments[k] <= hi, f"15c: {k} {moments[k]} outside [{lo}, {hi}]")

    # ---- 15d. every registry name through sample() ------------------------------------
    t0 = time.perf_counter()
    slow = []
    for name in PORTED_FLOWS:
        image = name.startswith(("ms-", "glow-", "conv-"))
        shape = (8, 8) if image else (D,)
        # the masked NAF flows' slow direction is d bisections a layer
        # (4-6 s a call on a slow host): one layer, not 2
        flow = f'{name}%{{"n_layers": 1}}' if zoo_masked_naf(name) else name
        build.reset_launch_counts()
        t1 = time.perf_counter()
        out = nfmc_torch.sample(StandardGaussian(shape), flow=flow, n_chains=C, n_iterations=1,
                                seed=0, show_progress=False)
        torch.cuda.synchronize()
        slow.append((time.perf_counter() - t1, name))
        check(out.samples.shape == (1, C, *shape) and out.samples.device.type == "cpu"
              and bool(torch.isfinite(out.samples).all()), f"15d {name}: bad draws")
        if name in [n for n, _ in LAST_CASES]:
            no_kernel(f"15d {name}")
    slow.sort(reverse=True)
    res["15d"] = time.perf_counter() - t0
    print(f"15d: all {len(PORTED_FLOWS)} registry names through sample() (IMH, 1 iteration, "
          f"{C} chains; (8, 8) images, d={D} vectors; the masked NAF flows 1 layer): finite "
          f"draws, {res['15d']:.1f} s; slowest "
          + ", ".join(f"{n} {s:.2f} s" for s, n in slow[:4]))
    res["wall"] = time.perf_counter() - t_phase
    print(f"phase 15: {res['wall']:.1f} s ({smi})")
    return res


def run_checkpoint_phases(dev) -> dict:
    """Phase 16: the headline with checkpoint_path, cut in CKPT_SEG-outer-
    iteration segments: an uninterrupted run, one that dies after 2
    segments, its resume (bit for bit the first, the file gone); the same
    for adaptive_imh, whose schedule lives in the extra-state hook."""
    import shutil

    import nfmc_torch
    from nfmc_torch.ops import build
    from nfmc_torch.potentials import StandardGaussian
    from nfmc_torch.samplers.nfmc import AdaptiveIMH, JumpMALA
    from nfmc_torch.utils import tree_leaves

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    root = Path(__file__).resolve().parent / "_scratch" / "ckpt16"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    res = {"shapes": {}}
    t_phase = time.perf_counter()

    def run(label, cls, kw):
        """(uninterrupted, resumed) outputs and samplers of one configuration."""
        path = str(root / label)
        got = {}
        for attempt in ("uninterrupted", "crash", "resume"):
            calls = {"n": 0}
            orig = cls.sample_continue

            def crashing(self, *a, **k):
                calls["n"] += 1
                if calls["n"] == 2:  # the third segment's entry: 2 are done
                    raise RuntimeError("simulated preemption")
                return orig(self, *a, **k)

            if attempt == "crash":
                cls.sample_continue = crashing
            p = path + ("-a" if attempt == "uninterrupted" else "-b")
            build.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                with CaptureSampler() as cap, ShapeLaunches() as shapes:
                    out = nfmc_torch.sample(**kw, checkpoint_path=p, seed=0, show_progress=False,
                                            checkpoint_save_samples=True)
                    torch.cuda.synchronize()
            except RuntimeError as e:
                check(attempt == "crash" and "preemption" in str(e), f"16 {label}: {e}")
                check(Path(p + ".npz").exists() and len(list(root.glob(f"{label}-b.npz.seg*.npy")))
                      == 2, f"16 {label}: the crash left no checkpoint with 2 segments")
                print(f"16 {label}: died at the third segment, {time.perf_counter() - t0:.3f} s; "
                      "the checkpoint holds 2 segments")
                continue
            finally:
                cls.sample_continue = orig
            wall = time.perf_counter() - t0
            check(not list(root.glob(f"{label}-*")), f"16 {label}: files left after success: "
                                                     f"{list(root.glob(f'{label}-*'))}")
            got[attempt] = (out, cap.samplers[-1], dict(counts_of(build)), wall)
            res["shapes"][f"{label} {attempt}"] = shapes.n
        return got["uninterrupted"], got["resume"]

    def counts_of(b):
        return {w.__name__: w.launches for w in b.WRAPPERS}

    common = dict(target=StandardGaussian((D,)), n_chains=C, checkpoint_segment_iterations=CKPT_SEG,
                  flow=f'realnvp%{{"n_layers": {L}, "hidden_size": {H}}}')
    cases = {
        "jump_mala": (JumpMALA, dict(common, strategy="jump_mala", n_iterations=CKPT_OUTER,
                                     inner_param_kwargs={"n_iterations": INNER_N})),
        "adaptive_imh": (AdaptiveIMH, dict(common, strategy="adaptive_imh")),
    }
    for label, (cls, kw) in cases.items():
        (a, sa, la, wa), (c, sc, lc, wc) = run(label, cls, kw)
        check(a.samples.shape == c.samples.shape and torch.equal(a.samples, c.samples),
              f"16 {label}: the resumed run's draws differ from the uninterrupted run's")
        for k, v in vars(a.statistics).items():
            if isinstance(v, int):
                check(getattr(c.statistics, k) == v, f"16 {label}: {k} {getattr(c.statistics, k)} "
                                                     f"!= {v}")
        check(np.array_equal(a.statistics.running_first_moment, c.statistics.running_first_moment)
              and np.array_equal(a.statistics.running_second_moment,
                                 c.statistics.running_second_moment), f"16 {label}: moments differ")
        for x, y in ((sa, sc), *([(sa.inner_sampler, sc.inner_sampler)]
                                 if hasattr(sa, "inner_sampler") else [])):
            if hasattr(x.kernel, "make_state"):
                from nfmc_torch.checkpoint import _flatten

                sx, sy = (_flatten(s.kernel.make_state(dev)) for s in (x, y))
                check(all(torch.equal(torch.as_tensor(p), torch.as_tensor(q))
                          for (_, p), (_, q) in zip(sx, sy)), f"16 {label}: kernel state differs")
        check(all(torch.equal(p, q) for p, q in zip(tree_leaves(sa.kernel.flow.params),
                                                    tree_leaves(sc.kernel.flow.params))),
              f"16 {label}: flow weights differ")
        check(la.get("fused_realnvp_inverse", 0) > 0 and la.get("fused_realnvp_forward", 0) > 0,
              f"16 {label}: the coupling kernels did not run: {la}")
        n_draws = a.samples.shape[0]
        res[label] = (wa, wc, la)
        print(f"16 {label} with checkpoint_path, {n_draws} stored draws in 5 segments of "
              f"{CKPT_SEG}: uninterrupted {wa:.3f} s, resumed after 2 segments {wc:.3f} s; draws, "
              f"counters, moments, kernel state and flow weights bit-identical; launches "
              f"{la}; checkpoint files gone after success ({smi})")
    shutil.rmtree(root, ignore_errors=True)
    res["wall"] = time.perf_counter() - t_phase
    print(f"phase 16: {res['wall']:.1f} s ({smi})")
    return res


class RealNVPLaunches:
    """For the duration of a ``with`` block: the RealNVP kernels' launches
    by (kernel, direction, d, H, L, rows), with the kernel "stack" or "vjp"
    (a listener of ``build.count_launch``), and the weight repacks
    (``ops.coupling.pack_weights`` calls); the wrappers' own counts go on as
    before."""

    def __enter__(self):
        from nfmc_torch.ops import build
        from nfmc_torch.ops import coupling as ops

        self.n, self.repacks = collections.Counter(), 0
        self._orig = pack = ops.pack_weights

        def listen(_wrapper, key, n):
            if key[0] in ("stack", "vjp"):
                self.n[key] += n

        def repack(params):
            self.repacks += 1
            return pack(params)

        self._listener = listen
        build.LISTENERS.append(listen)
        ops.pack_weights = repack
        return self

    def __exit__(self, *exc):
        from nfmc_torch.ops import build
        from nfmc_torch.ops import coupling as ops

        build.LISTENERS.remove(self._listener)
        ops.pack_weights = self._orig


def transport_targets(d: int):
    """bench.py's easy transport target in the port: N(0, I) prior, target
    N(2 * 1, 0.25 I)."""
    from nfmc_torch.potentials import DiagonalGaussian, StandardGaussian

    return (StandardGaussian((d,)),
            DiagonalGaussian(np.full(d, 2.0, np.float32), np.full(d, 0.5, np.float32)))


def fab_estimate(log_w, true_abs: float) -> dict:
    """bench.py's FAB figures (bench.py:1790-1808) from the importance
    log-weights of TR_FAB_DRAWS flow draws, in float64 on the host: the
    estimate, its error, the IS ESS fraction and whether the
    TR_FAB_BLOCKS-block two-standard-error band covers the truth."""
    lw = torch.as_tensor(np.asarray(log_w), dtype=torch.float64)
    n = lw.shape[0]
    est = float(torch.logsumexp(lw, 0) - np.log(n))
    blocks = lw.reshape(TR_FAB_BLOCKS, -1)
    block_est = (torch.logsumexp(blocks, 1) - np.log(blocks.shape[1])).numpy()
    two_se = float(2.0 * block_est.std(ddof=1) / np.sqrt(TR_FAB_BLOCKS))
    ess = float(torch.exp(2 * torch.logsumexp(lw, 0) - torch.logsumexp(2 * lw, 0)) / n)
    return {"log_z": est, "err": abs(est - true_abs), "is_ess_frac": ess, "two_se": two_se,
            "covers": bool(abs(block_est.mean() - true_abs) <= two_se)}


def transport_suite(seed: int, device, timed=None) -> dict:
    """17b: bench.py's run_transport_logz easy suite (bench.py:1757-1810)
    through the port's entry points on ``device``, every seed 0 there
    replaced by ``seed`` (FAB's estimate drawn with seed 7 + seed).
    ``timed(name, run)`` wraps each method's run (default: the wall, ending
    in a synchronise). Returns {method: (log Z, wall[, FAB's figures])}."""
    import nfmc_torch
    from nfmc_torch.transport.ais import ais_base

    dev = torch.device(device)
    prior, target = transport_targets(TR_D)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def wall(name, run):
        t0 = time.perf_counter()
        out = run()
        sync()
        return out, time.perf_counter() - t0

    timed = timed or wall
    res = {}
    a = TR_AIS

    def ais():
        # one stream for the start and the chain: a second generator seeded
        # alike would replay x0 as the first sweep's noise
        g = torch.Generator(device=dev).manual_seed(seed)
        x0 = prior.sample((a["n"],), generator=g)
        _, log_w = ais_base(x0, prior, target, n_steps=a["n_steps"],
                            n_mcmc_steps=a["n_mcmc_steps"], step_size=a["step_size"],
                            generator=g, device=dev)
        return float(torch.logsumexp(log_w, 0) - np.log(a["n"]))

    tr = nfmc_torch.transport
    runs = {
        "ais": ais,
        "aft": lambda: tr.aft(prior, target, TR_FLOW, seed=seed, device=dev, **TR_AFT)["log_Z"],
        "craft": lambda: tr.craft(prior, target, TR_FLOW, seed=seed, device=dev,
                                  **TR_CRAFT)["log_Z"],
        "pmc": lambda: tr.pmc(prior, target, TR_FLOW, seed=seed, device=dev, **TR_PMC)["log_Z"],
    }
    for name, run in runs.items():
        res[name] = timed(name, run)

    def fab():
        trained = nfmc_torch.flow_training.fab(target, TR_FLOW, seed=seed, device=dev, **TR_FAB)
        xq, log_q = trained.sample(TR_FAB_DRAWS, seed=7 + seed, return_log_prob=True)
        return fab_estimate((-target(xq) - log_q).cpu(),
                            TR_TRUE_LOG_Z + TR_D / 2 * np.log(2 * np.pi))

    fig, w = timed("fab", fab)
    res["fab"] = (fig["log_z"], w, fig)
    return res


def rows_close(what, got, want, max_parted=TR_PARTED):
    """``got`` (card) against ``want`` (CPU) row by row, to TOL * max(1,
    max|want|) (equal infinities agree): rows apart where float32 rounding
    flipped an accept decision or a resample boundary, at most
    ``max_parted`` of them. Returns the parted rows' mask."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    finite = want[torch.isfinite(want)]
    scale = max(1.0, float(finite.abs().max())) if finite.numel() else 1.0
    diff = torch.where(got == want, 0.0, (got - want).abs()).reshape(got.shape[0], -1)
    parted = (diff > TOL * scale).any(-1) | torch.isnan(diff).any(-1)
    e = float(diff[~parted].max()) if (~parted).any() else 0.0
    print(f"  {what}: max|diff| {e:.3e} over the agreeing rows (scale {scale:.2f}), "
          f"{int(parted.sum())} of {got.shape[0]} rows parted by rounding")
    check(int(parted.sum()) <= max_parted * got.shape[0],
          f"17a {what}: {int(parted.sum())} rows apart, more than {max_parted:.0%}")
    return parted


def all_close(what, got, want):
    """``got`` against ``want`` to TOL * max(1, max|want|), every element."""
    return rows_close(what, got.reshape(1, -1), want.reshape(1, -1), max_parted=0.0)


def witnessed_weights(what, theta, want, adam):
    """Weights of a multi-step fit on the card against the CPU's: Adam turns
    a gradient element within float32 error of 0 into a step of +-lr whose
    sign is rounding's, so a weight may part from the CPU's by more than TOL
    only where its RMS gradient over the fit (``adam``'s second moment) is
    below 1e-5 of the largest (chip_smoke.check_refit's witness)."""
    theta, want = theta.cpu().double(), want.cpu().double()
    rms = (adam.nu / (1.0 - adam.b2 ** adam.count)).sqrt().cpu().double()
    scale = max(1.0, float(want.abs().max()))
    parted = (theta - want).abs() > TOL * scale
    ok = bool((rms[parted] <= 1e-5 * rms.max()).all())
    e = float((theta - want).abs()[~parted].max()) if (~parted).any() else 0.0
    print(f"  {what}: weights max|diff| {e:.3e} (scale {scale:.2f}); {int(parted.sum())} of "
          f"{theta.numel()} apart, each with an RMS gradient below 1e-5 of the largest: {ok}")
    check(ok, f"17a {what}: weights apart that no gradient within float32 error of 0 explains")


def transport_card_vs_cpu(dev) -> None:
    """17a: each step of the slice on the card and on the CPU with the same
    weights and the same injected draws (made on the CPU)."""
    import importlib

    from nfmc_torch import create_flow_object
    from nfmc_torch.flow_training import FAB
    from nfmc_torch.flows import RealNVP
    from nfmc_torch.flows.train import _AdamW, _flatten
    from nfmc_torch.transport import CRAFT, AnnealedFlowTransport, PreconditionedMonteCarlo
    from nfmc_torch.transport.ais import make_ais
    from nfmc_torch.transport.common import flat_value_and_grad, make_mala_sweep, tempered
    from nfmc_torch.utils import tree_map

    snf_mod = importlib.import_module("nfmc_torch.transport.snf")
    cpu = torch.device("cpu")
    d = TR_D
    prior, target = transport_targets(d)
    g = torch.Generator().manual_seed(TR_SEED)
    w0 = perturbed_params(d, 32, 2, seed=TR_SEED, device=cpu)

    def on(device, obj):
        """``obj`` (tensors, tuples and lists of them) on ``device``."""
        if isinstance(obj, torch.Tensor):
            return obj.to(device)
        if isinstance(obj, (list, tuple)):
            return type(obj)(on(device, o) for o in obj)
        if isinstance(obj, dict):
            return {k: on(device, v) for k, v in obj.items()}
        return obj

    def both(fn, *args):
        """fn(device, *args on that device) on the card and the CPU."""
        return fn(dev, *on(dev, args)), fn(cpu, *args)

    def flow_on(device):
        f = create_flow_object(TR_FLOW, (d,), seed=0)
        f.params = on(device, w0)
        return f

    x2048 = torch.randn((2048, d), generator=g)
    t0 = time.perf_counter()
    print(f"17a card against CPU (d={d}, RealNVP L=2 H=32, weights {PERTURB} N(0, 1) from the "
          f"init; the same draws):")
    # the MALA sweep and an 8-level AIS chain on the easy target
    u = tempered(prior, target)
    sweep = make_mala_sweep(u, n_steps=5, step_size=0.05)
    draws = sweep.draws(g, x2048.shape)
    card, ref = both(lambda _, x, dr: sweep(x, 0.5, dr), x2048, draws)
    rows_close("MALA sweep (5 steps, 2048 particles, lam 1/2)", card, ref)
    chain = make_ais(prior, target, n_steps=8, n_mcmc_steps=2, step_size=0.1)
    draws = list(chain.draws(g, x2048.shape))
    card, ref = both(lambda _, x, dr: chain(x, dr), x2048, draws)
    parted = rows_close("AIS chain x (8 levels x 2 MALA steps)", card[0], ref[0])
    rows_close("AIS chain log_w", card[1][~parted.to(card[1].device)], ref[1][~parted])

    # one AFT level: the 60-epoch fit, the selection, the base group's transport
    lam = 1.0 / (TR_AFT["n_iterations"] - 1)
    xt, xv = torch.randn((1024, d), generator=g), torch.randn((512, d), generator=g)
    wt, wv = torch.full((1024,), 1 / 1024), torch.full((512,), 1 / 512)

    def aft_level(device, xt, wt, xv, wv, xb):
        alg = AnnealedFlowTransport(prior, target, flow_on(device), n_steps=16,
                                    n_train_epochs=TR_AFT["n_train_epochs"])
        p, best = alg._fit_level(alg.flow.params, xt, wt, xv, wv, lam)
        use, xv2, lwv = alg._select_transport(p, xv, torch.log(wv), 0.0, lam)
        xb2, lwb, dlz, ess = alg._transport(p, xb, torch.full((2048,), -np.log(2048),
                                                              device=device), 0.0, lam, use)
        return _flatten(p), best, use, xv2, lwv, xb2, lwb, dlz, ess

    card, ref = both(aft_level, xt, wt, xv, wv, x2048)
    all_close("AFT level: the fitted weights (60 epochs, 1024 train / 512 val rows)",
              card[0], ref[0])
    for what, i in (("best val loss", 1), ("val group x", 3), ("val log W", 4),
                    ("base x", 5), ("base log W", 6), ("delta log Z", 7), ("log ESS", 8)):
        all_close(f"AFT level: {what}", card[i], ref[i])
    check(bool(card[2]) == bool(ref[2]), "17a AFT: the selection differs")

    # one CRAFT training level (level 0 of TR_CRAFT's 12)
    lw0 = torch.full((2048,), -np.log(2048))

    def craft_level(device, x, lw, dr):
        bijs = [flow_on(device).bijection for _ in range(TR_CRAFT["n_annealing_steps"])]
        alg = CRAFT(prior, target, bijs)
        theta = _flatten(bijs[0].params)
        opt = _AdamW(theta, alg.lr)
        return (*alg._level(0, theta, opt, x, lw, dr), opt)

    craft_alg = CRAFT(prior, target, [flow_on(cpu).bijection])
    draws = craft_alg.level_draws(g, x2048.shape)
    card, ref = both(craft_level, x2048, lw0, draws)
    witnessed_weights("CRAFT level 0: the AdamW step", card[0], ref[0], card[4])
    parted = rows_close("CRAFT level 0: x after the resample and the sweep", card[1], ref[1])
    rows_close("CRAFT level 0: log W", card[2][~parted.to(card[2].device)], ref[2][~parted])
    all_close("CRAFT level 0: delta log Z", card[3], ref[3])

    # PMC's train scan (20 epochs on 2048 weighted rows) and one pCN sweep
    pmc_lw = 0.3 * torch.randn((2048,), generator=g)
    pmc_lw = pmc_lw - torch.logsumexp(pmc_lw, 0)
    perm = torch.randperm(2048, generator=g)
    xp = x2048[:TR_PCN_B] * 0.5 + 1.0
    pmc_cpu = PreconditionedMonteCarlo(prior, target, flow_on(cpu),
                                       n_train_epochs=TR_PMC["n_train_epochs"],
                                       n_mcmc_steps=TR_PMC["n_mcmc_steps"])
    sweep_draws = pmc_cpu.sweep_draws(g, xp.shape)

    def pmc_steps(device, x, lw, perm, xp, dr):
        alg = PreconditionedMonteCarlo(prior, target, flow_on(device),
                                       n_train_epochs=TR_PMC["n_train_epochs"],
                                       n_mcmc_steps=TR_PMC["n_mcmc_steps"])
        p, losses = alg._train(alg.flow.params, x, lw, perm)
        rho = torch.tensor(0.0, device=device)
        return (_flatten(p), losses, *alg._sweep(p, xp, 0.3, rho, dr))

    card, ref = both(pmc_steps, x2048, pmc_lw, perm, xp, sweep_draws)
    all_close("PMC train scan: the best weights (20 epochs)", card[0], ref[0])
    all_close("PMC train scan: the losses", card[1], ref[1])
    rows_close(f"PMC pCN sweep (10 steps, {TR_PCN_B} rows, beta 0.3): x", card[2], ref[2])
    all_close("PMC pCN sweep: rho_logit", card[3], ref[3])
    all_close("PMC pCN sweep: acceptance", card[4], ref[4])

    # one FAB iteration: the AIS round into the buffer, then 20 replay steps
    # from the CPU's buffer on both devices
    f = TR_FAB
    fab_cpu = FAB(target, flow_on(cpu))
    ais_draws, noise = fab_cpu.iteration_draws(g, f["n_flow_training_steps"],
                                               f["n_ais_particles"], 50)

    def fab_fill(device, dr):
        alg = FAB(target, flow_on(device))
        return alg._fill(alg.flow.params, alg._init_buffer(device), dr)

    card, ref = both(fab_fill, ais_draws)
    n = f["n_ais_particles"]
    parted = rows_close(f"FAB AIS round ({n} particles, 8 levels x 3 MALA steps): x",
                        card[0][:n], ref[0][:n])
    for what, i in (("log w", 1), ("log q", 2)):
        rows_close(f"FAB AIS round: {what}", card[i][:n][~parted.to(card[i].device)],
                   ref[i][:n][~parted])

    def fab_replay(device, buf, nz):
        alg = FAB(target, flow_on(device))
        like = alg.flow.params
        theta = _flatten(like)
        opt = _AdamW(theta, alg.lr)
        buf = (*[b.clone() for b in buf[:3]], *buf[3:])
        theta, buf, loss = alg._replay(theta, opt, like, buf, nz)
        return theta, buf[1], buf[2], loss, opt

    card, ref = both(fab_replay, ref, noise)
    witnessed_weights(f"FAB replay ({f['n_flow_training_steps']} AdamW steps of 50 rows)",
                      card[0], ref[0], card[4])
    for what, i in (("buffered log w", 1), ("buffered log q", 2), ("reported loss", 3)):
        all_close(f"FAB replay: {what}", card[i], ref[i])

    # SNF's loss and its gradient in the flow weights (snf()'s layers)
    def snf_model(device):
        layers = [snf_mod.HMCLayer((d,)), snf_mod.FlowLayer(RealNVP((d,), n_layers=2)),
                  snf_mod.HMCLayer((d,)), snf_mod.FlowLayer(RealNVP((d,), n_layers=2)),
                  snf_mod.HMCLayer((d,))]
        return snf_mod.SNF(layers, target, prior, seed=0, device=device)

    model = snf_model(cpu)
    z = torch.randn((TR_SNF["n_particles"], d), generator=g)
    snf_draws = model.draws(g, z.shape)
    pert = torch.Generator().manual_seed(TR_SEED + 1)
    snf_w = tree_map(lambda t: t + PERTURB * torch.randn(t.shape, generator=pert), model.params)

    def snf_grad(device, z, dr, w):
        m = snf_model(device)
        m.params = w
        theta = _flatten(w)
        return flat_value_and_grad(lambda p: m._loss(p, z, dr), theta, w)

    card, ref = both(snf_grad, z, snf_draws, snf_w)
    all_close(f"SNF loss ({TR_SNF['n_particles']} particles, HMC + RealNVP(L=2, H=64) x 2 + HMC)",
              card[0], ref[0])
    all_close("SNF loss gradient in the flow weights (through the HMC layers, second order in "
              "U)", card[1], ref[1])
    print(f"17a: {time.perf_counter() - t0:.1f} s")


def check_transport_shapes(dev, shapes, label="phase 17") -> dict:
    """Each RealNVP shape ``label`` launched, the forward kernel and the VJP
    against their plain versions (to TOL * max(1, max|ref|); the VJP twice,
    bit-identical), with timings and bounds: {shape key: (ms, device ms,
    plain ms, bound ms, bound by, error)}."""
    from nfmc_torch.ops import coupling as ops
    from nfmc_torch.utils import tree_leaves

    g = torch.Generator(device=dev).manual_seed(TR_SEED)
    out = {}
    for key in sorted(shapes):
        kernel, direction, d, hid, nl, rows = key
        inverse = direction == "inverse"
        params = perturbed_params(d, hid, nl, seed=d + hid + rows, device=dev)
        packed = ops.pack_weights(params)
        x = torch.randn((rows, d), generator=g, device=dev)
        what = f"{kernel} {direction} d={d} H={hid} L={nl} B={rows}"
        if kernel == "stack":
            wrapper = ops.fused_realnvp_inverse if inverse else ops.fused_realnvp_forward
            y, ld = wrapper(params, x, 3.0, packed=packed)
            y_ref, ld_ref = ops.realnvp_stack_plain(params, x, 3.0, inverse)
            scale = max(1.0, y_ref.abs().max().item(), ld_ref.abs().max().item())
            e = max((y - y_ref).abs().max().item(), (ld - ld_ref).abs().max().item()) / scale
            check(bool(torch.isfinite(y).all() and torch.isfinite(ld).all()),
                  f"{what}: non-finite kernel output")
            fn = lambda: wrapper(params, x, 3.0, packed=packed)
            plain = lambda: ops.realnvp_stack_plain(params, x, 3.0, inverse)
            same = True
        else:
            gy = torch.randn((rows, d), generator=g, device=dev)
            gld = torch.randn((rows,), generator=g, device=dev)
            fn = lambda: ops.fused_realnvp_vjp(params, x, gy, gld, 3.0, inverse, packed)
            plain = lambda: ops.realnvp_stack_vjp_plain(params, x, gy, gld, 3.0, inverse)
            got, again = fn(), fn()
            torch.cuda.synchronize()
            e, scale, _ = ops.vjp_error(got, plain())
            same = torch.equal(got[0], again[0]) and all(
                torch.equal(a, b) for a, b in zip(tree_leaves(got[1]), tree_leaves(again[1])))
        k_ms, k_dev, k_txt = kernel_ms(fn, 20)
        p_ms = median_ms(plain, 20)
        bound_ms, bound_by = bound(*stack_cost(d, hid, nl, rows, backward=kernel == "vjp"))
        out[key] = (k_ms, k_dev, p_ms, bound_ms, bound_by, e * scale)
        print(f"  {what}: relative max|diff| {e:.3e} (scale {scale:.2f})"
              + ("" if kernel == "stack" else f", bit-identical rerun {same}")
              + f", kernel {k_txt}, plain {p_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
        check(e <= TOL, f"{label} {what}: the kernel disagrees with its plain version")
        check(same, f"{label} {what}: two launches gave different gradients")
    return out


def run_transport_phases(dev) -> dict:
    """Phases 17-17c: the transport layer and FAB. 17a each step on the card
    against the CPU; 17b run_transport_logz's easy suite at bench.py's
    sizes (AIS, AFT, CRAFT, PMC, FAB) with the busy share of one AFT level
    and one FAB iteration; 17c snf() and ns(); then every RealNVP shape the
    phase launched against the plain version. Returns the launches by shape
    and the numbers the kernels' line and the summary need."""
    import nfmc_torch
    from nfmc_torch.flow_training import FAB
    from nfmc_torch.ops import build
    from nfmc_torch.transport import AnnealedFlowTransport

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    t_phase = time.perf_counter()
    res = {"shapes": {}, "walls": {}}
    all_shapes = collections.Counter()

    with RealNVPLaunches() as launched:
        transport_card_vs_cpu(dev)
    all_shapes.update(launched.n)

    # ---- 17b. the easy suite at bench.py's sizes ------------------------------------
    def timed(name, run):
        build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with RealNVPLaunches() as rec:
            out = run()
            torch.cuda.synchronize()
        w = time.perf_counter() - t0
        counts = {k: v for k, v in ((w_.__name__, w_.launches) for w_ in build.WRAPPERS) if v}
        res["shapes"][name] = rec.n
        res["walls"][name] = w
        all_shapes.update(rec.n)
        check(all(k.startswith("fused_realnvp") for k in counts),
              f"17 {name}: a spline kernel launched: {counts}")
        check(name == "ais" or counts.get("fused_realnvp_vjp", 0) > 0,
              f"17 {name}: the flow was never trained through the VJP kernel: {counts}")
        print(f"{'17c' if name in ('snf', 'ns') else '17b'} {name}: wall {w:.3f} s, launches "
              f"{counts}, weight repacks {rec.repacks}; by "
              f"shape " + ", ".join(f"{k[0]} {k[1][:3]} d={k[2]} H={k[3]} B={k[5]}: {v}"
                                    for k, v in sorted(rec.n.items())))
        return out, w

    suite = transport_suite(0, dev, timed)
    for m in TR_METHODS:
        truth = (TR_TRUE_LOG_Z + TR_D / 2 * np.log(2 * np.pi) if m == "fab" else TR_TRUE_LOG_Z)
        err = abs(suite[m][0] - truth)
        print(f"17b {m}: log Z {suite[m][0]:.6f} (truth {truth:.6f}), |error| {err:.6f} nats, "
              f"wall {suite[m][1]:.3f} s ({smi})")
        check(err < 1.0, f"17b {m}: |log Z error| {err} >= 1 nat (bench.py's all_ok)")
        band, seen = jax_band(TR_ERR_JAX[m], errors=True)
        in_band(f"17b {m} |log Z error|", err, band,
                f"{seen} over seeds 0-31, not 0-7" if m == "ais" else seen)
    fab = suite["fab"][2]
    print(f"17b fab: IS ESS fraction {fab['is_ess_frac']:.6f}, 2 SE {fab['two_se']:.6f}, the "
          f"{TR_FAB_BLOCKS}-block band covers the truth: {fab['covers']}")
    check(fab["covers"], "17b fab: the two-standard-error band misses the truth")
    in_band("17b fab IS ESS fraction", fab["is_ess_frac"], *jax_band(TR_FAB_ESS_JAX))
    res["suite"] = suite

    prior, target = transport_targets(TR_D)
    a = TR_AFT
    aft_alg = AnnealedFlowTransport(prior, target,
                                    nfmc_torch.create_flow_object(TR_FLOW, (TR_D,), seed=0).to(dev),
                                    n_steps=2, n_train_epochs=a["n_train_epochs"])
    profile_window(lambda: aft_alg.run(
        lambda b, generator=None: prior.sample(b, generator=generator),
        n_particles=a["n_particles"], n_train_particles=a["n_train_particles"],
        n_val_particles=a["n_val_particles"], seed=0), "17b one AFT level")
    fab_alg = FAB(target, nfmc_torch.create_flow_object(TR_FLOW, (TR_D,), seed=0).to(dev))
    profile_window(lambda: fab_alg.run(n_iterations=1,
                                       n_flow_training_steps=TR_FAB["n_flow_training_steps"],
                                       n_ais_particles=TR_FAB["n_ais_particles"], seed=0),
                   "17b one FAB iteration")

    # ---- 17c. snf() and ns() ----------------------------------------------------------
    def snf_run():
        return nfmc_torch.transport.snf(prior, target, seed=0, device=dev, **TR_SNF)

    out, w = timed("snf", snf_run)
    p = out["particles"]
    check(bool(np.isfinite(p).all()), "17c snf: non-finite particles")
    print(f"17c snf: {TR_SNF}, wall {w:.3f} s, particle mean {p.mean():.6f}")
    in_band("17c snf |mean - 2|", abs(float(p.mean()) - 2.0), *jax_band(TR_SNF_ERR_JAX,
                                                                        errors=True))
    ns_prior, ns_target = transport_targets(TR_NS_D)
    out, w = timed("ns", lambda: nfmc_torch.transport.ns(ns_prior, ns_target, TR_FLOW, seed=0,
                                                         device=dev, **TR_NS))
    err = abs(out["log_Z"] - TR_NS_TRUE_LOG_Z)
    print(f"17c ns (d={TR_NS_D}, {TR_NS}): wall {w:.3f} s, log Z {out['log_Z']:.6f} (truth "
          f"{TR_NS_TRUE_LOG_Z:.6f}), |error| {err:.6f}")
    check(err < 1.0, f"17c ns: |log Z error| {err} >= 1 nat")
    in_band("17c ns |log Z error|", err, *jax_band(TR_NS_ERR_JAX, errors=True))

    # ---- every RealNVP shape the phase launched, against the plain version --------------
    print(f"phase 17 kernels at the {len(all_shapes)} shapes it launched:")
    res["timing"] = check_transport_shapes(dev, all_shapes)
    res["wall"] = time.perf_counter() - t_phase
    print(f"phase 17: {res['wall']:.1f} s ({smi})")
    return res


# phase 18: the headline under nfmc_torch.profiling.trace for TRACE_OUTER
# outer iterations; under sample(mesh=...) on a one-rank NCCL mesh for
# MESH_OUTER (one chunk: its proposals' inverse at MESH_OUTER * C rows, a
# shape phase 3 holds); Flow.fit(mesh=...) on MESH_FIT_ROWS rows at the
# adaptive batch of 256, its validation at 512 rows
TRACE_OUTER, MESH_OUTER, MESH_FIT_ROWS, MESH_FIT_EPOCHS = 20, 100, 4096, 3


def run_parallel_phases(dev) -> dict:
    """Phase 18: 18a the headline under ``nfmc_torch.profiling.trace`` inside
    ``annotate("jump")``: the trace file holds the coupling kernel's
    forward and inverse launches as device events and the span, and the ten
    device ops that took most time; 18b ``chain_mesh()`` (a one-rank NCCL
    group over the card): the headline through ``sample(..., mesh=mesh)``
    bit for bit as without it, draws, counters and launch counts, and
    ``Flow.fit(mesh=mesh)`` to the same weights as ``Flow.fit``; the group
    is destroyed at the end."""
    import shutil

    import torch.distributed as dist

    import nfmc_torch
    from nfmc_torch import profiling
    from nfmc_torch.flows import Flow, RealNVP
    from nfmc_torch.ops import build
    from nfmc_torch.parallel import chain_mesh
    from nfmc_torch.potentials import StandardGaussian
    from nfmc_torch.utils import tree_leaves

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    t_phase = time.perf_counter()
    res = {"shapes": {}}

    def headline(n_outer, **kw):
        return nfmc_torch.sample(
            StandardGaussian((D,)), strategy="jump_mala",
            flow=Flow(RealNVP((D,), n_layers=L, hidden_size=H), seed=0), n_chains=C,
            n_iterations=n_outer, inner_param_kwargs={"n_iterations": INNER_N},
            param_kwargs={"store_samples_on_device": True}, seed=0, show_progress=False, **kw)

    def counts():
        return {w.__name__: w.launches for w in build.WRAPPERS}

    # ---- 18a. the headline under profiling.trace -------------------------------------
    root = Path(__file__).resolve().parent / "_scratch" / "trace18a"
    shutil.rmtree(root, ignore_errors=True)
    build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profiling.trace(root) as log_dir:
        with profiling.annotate("jump"):
            headline(TRACE_OUTER)
            torch.cuda.synchronize()
    traced = counts()
    t_traced = time.perf_counter() - t0
    files = sorted(log_dir.glob("*.pt.trace.json"))
    check(len(files) == 1, f"18a: trace() wrote {[f.name for f in files]}, not one *.pt.trace.json")
    events = json.loads(files[0].read_text()).get("traceEvents", [])
    shutil.rmtree(root, ignore_errors=True)
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    stack = [e for e in device if e.get("cat") == "kernel" and "coupling_stack_kernel" in e["name"]]
    grids = collections.Counter(tuple(e.get("args", {}).get("grid", ())) for e in stack)
    n_stack = traced["fused_realnvp_forward"] + traced["fused_realnvp_inverse"]
    spans = [e for e in events if e.get("name") == "jump"
             and e.get("cat") in ("user_annotation", "gpu_user_annotation")]
    print(f"18a trace: {len(events)} events, {len(device)} device ops in {t_traced:.2f} s; "
          f"coupling_stack_kernel events {len(stack)} (launches: forward "
          f"{traced['fused_realnvp_forward']}, inverse {traced['fused_realnvp_inverse']}) at "
          f"grids {dict(grids)}; 'jump' spans {[e['cat'] for e in spans]}")
    check(traced["fused_realnvp_forward"] == TRACE_OUTER and traced["fused_realnvp_inverse"] >= 1,
          f"18a: the traced headline's launches {traced}")
    check(len(stack) == n_stack and len(grids) >= 2,
          "18a: the trace does not hold the coupling kernel's forward (B=C) and inverse (B=chunk C) "
          "launches as device events")
    check(any(e["cat"] == "user_annotation" for e in spans), "18a: no 'jump' span in the trace")
    per_op = collections.defaultdict(lambda: [0.0, 0])
    for e in device:
        per_op[e["name"]][0] += float(e.get("dur", 0.0))
        per_op[e["name"]][1] += 1
    total_us = sum(v[0] for v in per_op.values())
    check(total_us > 0, "18a: the trace holds no device time")
    top = sorted(per_op.items(), key=lambda kv: -kv[1][0])[:10]
    res["top"] = [(k, v[0], v[1], v[0] / total_us) for k, v in top]
    print(f"18a top device ops of the headline ({TRACE_OUTER} outer it, device time "
          f"{total_us / 1e3:.3f} ms; {smi}):")
    for k, us, n, share in res["top"]:
        print(f"  {100 * share:5.1f}%  {us / 1e3:9.3f} ms  calls {n:6d}  {k[:90]}")

    # ---- 18b. a one-rank NCCL mesh ---------------------------------------------------
    check(not dist.is_initialized(), "18b: a process group is already running")
    t0 = time.perf_counter()
    mesh = chain_mesh()
    try:
        # NCCL sets its communicator up at the first collective: do that
        # here, so that the timed runs below compare warm paths
        dist.all_reduce(torch.zeros(1, device=dev), group=mesh.get_group(0))
        torch.cuda.synchronize()
        t_mesh = time.perf_counter() - t0
        check(mesh.size() == 1 and dist.get_backend() == "nccl",
              f"18b: chain_mesh() gave {mesh} on {dist.get_backend()}")
        runs = {}
        for label, kw in (("plain", {}), ("mesh", {"mesh": mesh})):
            build.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with ShapeLaunches() as shapes:
                out = headline(MESH_OUTER, **kw)
                torch.cuda.synchronize()
            runs[label] = (out, counts(), time.perf_counter() - t0)
            res["shapes"][f"headline {label}"] = shapes.n
        (a, la, wa), (b, lb, wb) = runs["plain"], runs["mesh"]
        sa, sb = a.statistics, b.statistics
        same_counters = all(getattr(sa, k) == getattr(sb, k) for k, v in vars(sa).items()
                            if isinstance(v, int))
        same_moments = (np.array_equal(sa.running_first_moment, sb.running_first_moment)
                        and np.array_equal(sa.running_second_moment, sb.running_second_moment))
        print(f"18b headline, {MESH_OUTER} outer it: without a mesh {wa:.3f} s, with the one-rank "
              f"NCCL mesh {wb:.3f} s (chain_mesh() and NCCL's first all_reduce {t_mesh:.2f} s); draws bit-identical "
              f"{torch.equal(a.samples, b.samples)}, counters {same_counters}, moments "
              f"{same_moments}; launches {lb} ({smi})")
        check(a.samples.shape == b.samples.shape and torch.equal(a.samples, b.samples),
              "18b: the mesh run's draws differ from the run without a mesh")
        check(same_counters and same_moments, "18b: the mesh run's counters or moments differ")
        check(la == lb and lb["fused_realnvp_forward"] == MESH_OUTER
              and lb["fused_realnvp_inverse"] >= 1, f"18b: launch counts {la} vs {lb}")
        rng = np.random.default_rng(18)
        x_fit = rng.standard_normal((MESH_FIT_ROWS, D)).astype(np.float32)
        x_val = rng.standard_normal((512, D)).astype(np.float32)
        fitted = {}
        for label, m in (("plain", None), ("mesh", mesh)):
            flow = Flow(RealNVP((D,), n_layers=L, hidden_size=H), seed=0)
            flow.params = perturbed_params(D, H, L, seed=18, device=dev)
            build.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with ShapeLaunches() as shapes:
                flow.fit(x_fit, x_val=x_val, n_epochs=MESH_FIT_EPOCHS, seed=1, mesh=m)
                torch.cuda.synchronize()
            fitted[label] = (tree_leaves(flow.params), counts(), time.perf_counter() - t0)
            res["shapes"][f"fit {label}"] = shapes.n
        same = all(torch.equal(p, q) for p, q in zip(fitted["plain"][0], fitted["mesh"][0]))
        print(f"18b Flow.fit, {MESH_FIT_ROWS} rows x {MESH_FIT_EPOCHS} epochs: without a mesh "
              f"{fitted['plain'][2]:.3f} s (the first fit of the phase), with it "
              f"{fitted['mesh'][2]:.3f} s; weights "
              f"bit-identical {same}; launches {fitted['mesh'][1]} ({smi})")
        check(same, "18b: Flow.fit(mesh=...) on one rank gave other weights than Flow.fit")
        check(fitted["mesh"][1]["fused_realnvp_vjp"] > 0, "18b: the fit skipped the backward kernel")
    finally:
        dist.destroy_process_group()
    res["wall"] = time.perf_counter() - t_phase
    print(f"phase 18: {res['wall']:.1f} s ({smi})")
    return res


# phase 19: the strategies declared for several ranks after phase 18's, each
# through the front door at full width (d = 100, 100 chains, NUTS and
# jump_hmc at 1024 as phases 11d-12, RealNVP 4 x 128) with its depth cut:
# warmup=True with SHARD_WARM tuning iterations (the jump samplers' inner
# ones, then the flow's MLE fit of SHARD_FIT_EPOCHS epochs; NeuTra's and
# adaptive_imh's reverse-KL fits SHARD_FIT_EPOCHS epochs), then SHARD_ITERS
# iterations (the jump samplers SHARD_OUTER outer iterations of SHARD_INNER
# inner steps; adaptive_imh its 100, the reference ignores n_iterations);
# AFT and PMC at phase 17's sizes cut to SHARD_AFT_STEPS annealing steps and
# SHARD_PMC_LEVELS levels; 19b's AdaptiveIMH SHARD_IMH_ITERS iterations
SHARD_WARM, SHARD_ITERS, SHARD_OUTER, SHARD_INNER, SHARD_FIT_EPOCHS = 5, 5, 3, 2, 2
SHARD_AFT_STEPS, SHARD_PMC_LEVELS, SHARD_IMH_ITERS = 3, 4, 20
SHARD_STRATEGIES = ("ula", "uhmc", "mh", "nuts", "ess", "adaptive_imh", "neutra_mh",
                    "neutra_chees", "jump_ula", "jump_hmc", "jump_uhmc", "jump_mh", "jump_ess",
                    "jump_nuts", "jump_chees", "jump_aies")
# the transport methods on a mesh, at phase 17's sizes (19a, and 19b on two
# ranks) with their depth cut: AFT and PMC as above; CRAFT at TR_CRAFT's
# particles and levels, trained SHARD_CRAFT_PASSES passes (not 25) before
# its sampling pass; AIS at TR_AIS; SNF at TR_SNF's particles, fitted
# SHARD_SNF_EPOCHS epochs (not 10); nested sampling at TR_NS_D / TR_NS; FAB
# at TR_FAB's AIS particles and replay steps for SHARD_FAB_ITERS iterations
# (not 300). Every gate on them is bit for bit or against the unsharded run
SHARD_CRAFT_PASSES, SHARD_SNF_EPOCHS, SHARD_FAB_ITERS = 2, 2, 3
SHARD_TRANSPORT = ("aft", "pmc", "craft", "ais", "snf", "ns", "fab")
# 19b: two gloo ranks, each its own process on the one card; the spawn's
# time limit, and a collective's
SHARD_RANKS, SHARD_TIMEOUT_S, SHARD_GLOO_TIMEOUT_S = 2, 300, 120
SHARD_TOL, SHARD_AFT_LOGZ_TOL, SHARD_AFT_FIT_LOGZ_TOL = 1e-5, 1e-3, 0.75
# 19b, trained CRAFT: its particle means (tests/test_sharding.py's AFT bound
# with fits on), its log Z, and the share of its weights that may part from
# the unsharded run's by more than SHARD_TOL. The ranks' gradients differ
# from one's by rounding (the VJP kernel sums 1024 rows, not 2048), and the
# SMC steps after a level (resample, accept) can carry such a difference
# on. A sound run on the H100 reads log Z 3.3e-3 apart and 9.0% of the
# weights beyond SHARD_TOL; with the loss's weights normalised on each rank
# alone, 2.9e-2 and 19.4%. No bound on one weight can tell them apart: an
# Adam step moves a weight by at most about lr, so any two runs part by at
# most 2 lr a pass (3.4e-3 and 4.0e-3 read; NVIDIA H100 80GB HBM3, 700.00 W)
SHARD_FIT_MEAN_TOL, SHARD_CRAFT_LOGZ_TOL, SHARD_CRAFT_PARTED = 0.15, 1e-2, 0.12


def shard_run(strategy: str, dev, mesh=None):
    """19a's (and 19b's jump_hmc's) front-door run of ``strategy`` on
    ``dev``, with ``mesh`` when given."""
    import nfmc_torch
    from nfmc_torch.flows import Flow, RealNVP
    from nfmc_torch.potentials import StandardGaussian

    target = StandardGaussian((D,))
    kw = dict(n_chains=NUTS_C if strategy in ("nuts", "jump_hmc") else C,
              n_iterations=SHARD_ITERS, n_warmup_iterations=SHARD_WARM, warmup=True, seed=19,
              device=dev, show_progress=False, mesh=mesh, param_kwargs={})
    if strategy in ("ess", "jump_ess"):
        kw["negative_log_likelihood"] = target
    inner = strategy.startswith(("jump_", "neutra_"))
    kernel_kw = kw["inner_kernel_kwargs" if inner else "kernel_kwargs"] = {}
    if strategy in ("mh", "jump_mh", "neutra_mh"):  # the scale is the inverse mass (11a)
        kernel_kw["inv_mass_diag"] = np.full(D, NEUTRA_MH_SCALE, np.float32)
    if strategy in ("nuts", "jump_nuts"):  # phase 12's tuned step: trees of depth ~3
        kernel_kw["step_size"] = NUTS_STEP_JAX_MID
    if strategy.startswith(("jump_", "neutra_")) or strategy == "adaptive_imh":
        kw["flow"] = Flow(RealNVP((D,), n_layers=L, hidden_size=H), seed=0)
    if strategy.startswith("jump_"):
        kw.update(n_iterations=SHARD_OUTER,
                  inner_param_kwargs={"n_iterations": SHARD_INNER,
                                      "n_warmup_iterations": SHARD_WARM})
        kw["param_kwargs"]["flow_fit_kwargs"] = {"n_epochs": SHARD_FIT_EPOCHS}
    elif inner or strategy == "adaptive_imh":
        kw["param_kwargs"]["warmup_fit_kwargs"] = {"n_epochs": SHARD_FIT_EPOCHS,
                                                   "n_samples": 128, "lr": 5e-3}
    return nfmc_torch.sample(target, strategy=strategy, **kw)


def kernel_state(kernel) -> dict:
    """What a run adapted, on the host: the kernel's tuned scalars and
    arrays, and its flow's weights."""
    state = {k: np.asarray(getattr(kernel, k)) for k in
             ("step_size", "inv_mass_diag", "a", "cov", "trajectory_length")
             if getattr(kernel, k, None) is not None}
    if getattr(kernel, "flow", None) is not None:
        state["flow"] = flat_leaves(kernel.flow.params)
    return state


def flat_leaves(params) -> np.ndarray:
    """Any flow's weights as one host vector."""
    from nfmc_torch.utils import tree_leaves

    return np.concatenate([t.detach().reshape(-1).cpu().numpy() for t in tree_leaves(params)])


def run_summary(out, **extra) -> dict:
    """A run's draws, moments, counters and adapted state, on the host."""
    st = out.statistics
    return {"samples": out.samples.cpu().numpy(), "mean": np.asarray(out.mean, np.float64),
            "second": np.asarray(out.second_moment, np.float64),
            "counters": {k: v for k, v in vars(st).items() if isinstance(v, int)},
            "state": kernel_state(out.kernel), **extra}


class ShardedPrior:
    """A prior whose draws come sharded over ``mesh`` where their count
    tiles its first axis (the transport runs' particle groups, nested
    sampling's live set and population draws), whole otherwise."""

    def __init__(self, prior, mesh):
        self.prior, self.mesh = prior, mesh

    def __call__(self, x):
        return self.prior(x)

    def sample(self, batch_shape, generator=None):
        from nfmc_torch.parallel import shard_chains

        x = self.prior.sample(batch_shape, generator=generator)
        if self.mesh is None or x.shape[0] % self.mesh.size(0):
            return x
        return shard_chains(x, self.mesh)


_PARAM_MESHES = {}


def param_mesh(mesh, dev):
    """The mesh a flow's parameters are replicated over for a run on
    ``dev``: ``mesh`` itself, or, where its device type is another (19b's
    gloo ranks carry their collectives on a CPU mesh), a mesh of ``dev``'s
    type over the same ranks, so that each rank's copy lies on the card. No
    collective runs on it; it is made once a mesh (a new process group:
    every rank makes it at the same point)."""
    if mesh is None or mesh.device_type == dev.type:
        return mesh
    if id(mesh) not in _PARAM_MESHES:
        from torch.distributed.device_mesh import DeviceMesh

        _PARAM_MESHES[id(mesh)] = DeviceMesh(dev.type, mesh.mesh.tolist(),
                                             mesh_dim_names=mesh.mesh_dim_names)
    return _PARAM_MESHES[id(mesh)]


def shard_transport(method: str, dev, mesh=None, passes=None) -> dict:
    """AFT, PMC, CRAFT, AIS, SNF, nested sampling or FAB at phase 17's sizes
    with the depth cut of the module constants (AFT's fit epochs, CRAFT's
    training passes or SNF's fit epochs ``passes`` where given), the
    particles drawn sharded over ``mesh`` when given (AFT's, PMC's,
    CRAFT's and nested sampling's prior draws, AIS's start, SNF's batches);
    nested sampling's and FAB's flow replicated over ``param_mesh(mesh,
    dev)``. Returns the run's results on the host."""
    import nfmc_torch
    from nfmc_torch.core.chains import local_params
    from nfmc_torch.parallel import replicate
    from nfmc_torch.transport import (CRAFT, AnnealedFlowTransport, NestedSampling,
                                      PreconditionedMonteCarlo)
    from nfmc_torch.transport.ais import ais_base
    from nfmc_torch.transport.snf import SNF, FlowLayer, HMCLayer

    prior, target = transport_targets(TR_D)
    sharded = ShardedPrior(prior, mesh)

    def flow_on_mesh(d=TR_D):
        flow = nfmc_torch.create_flow_object(TR_FLOW, (d,), seed=0).to(dev)
        if mesh is not None:
            flow.params = replicate(flow.params, param_mesh(mesh, dev))
        return flow

    def replicated(params):
        """The parameters' local copy, flat, and whether they came back
        replicated on the mesh (always without one)."""
        local, placed = local_params(params)
        return flat_leaves(local), placed == (None if mesh is None else param_mesh(mesh, dev))

    if method in ("aft", "pmc"):
        flow = nfmc_torch.create_flow_object(TR_FLOW, (TR_D,), seed=0).to(dev)
        if method == "aft":
            a = TR_AFT
            out = AnnealedFlowTransport(
                prior, target, flow, n_steps=SHARD_AFT_STEPS,
                n_train_epochs=a["n_train_epochs"] if passes is None else passes).run(
                sharded.sample, n_particles=a["n_particles"],
                n_train_particles=a["n_train_particles"], n_val_particles=a["n_val_particles"],
                full_output=True, seed=0)
        else:
            p = TR_PMC
            out = PreconditionedMonteCarlo(prior, target, flow, n_train_epochs=p["n_train_epochs"],
                                           n_mcmc_steps=p["n_mcmc_steps"],
                                           max_levels=SHARD_PMC_LEVELS).run(
                sharded.sample, n_particles=p["n_particles"], full_output=True, seed=0)
        return {"log_Z": float(out["log_Z"]), "particles": np.asarray(out["particles"]),
                "history": np.asarray(out["history"]), "flow": flat_leaves(flow.params)}
    if method == "craft":
        c = TR_CRAFT
        bijections = [nfmc_torch.create_flow_object(TR_FLOW, (TR_D,), seed=i).to(dev).bijection
                      for i in range(c["n_annealing_steps"])]
        algorithm = CRAFT(prior, target, bijections)
        passes = SHARD_CRAFT_PASSES if passes is None else passes
        algorithm.train(sharded.sample, n_particles=c["n_particles"], n_training_steps=passes,
                        seed=0)
        out = algorithm.sample(sharded.sample, n_particles=c["n_particles"], seed=1)
        return {"log_Z": float(out["log_Z"]), "particles": out["particles"],
                "log_weights": out["log_weights"], "history": out["history"],
                "flow": np.concatenate([flat_leaves(b.params) for b in bijections])}
    if method == "ais":
        a = TR_AIS
        g = torch.Generator(device=dev).manual_seed(0)
        x, log_w = ais_base(sharded.sample((a["n"],), generator=g), prior, target,
                            n_steps=a["n_steps"], n_mcmc_steps=a["n_mcmc_steps"],
                            step_size=a["step_size"], generator=g, device=dev)
        return {"particles": x.cpu().numpy(), "log_weights": log_w.cpu().numpy(),
                "log_Z": float(torch.logsumexp(log_w, 0) - np.log(a["n"])),
                "plain": type(x) is torch.Tensor and type(log_w) is torch.Tensor}
    if method == "snf":
        # snf()'s stack and its draws (seeds 0-4), the batches sharded
        from nfmc_torch.flows import RealNVP

        n = TR_SNF["n_particles"]
        model = SNF([HMCLayer((TR_D,)), FlowLayer(RealNVP((TR_D,), n_layers=2)),
                     HMCLayer((TR_D,)), FlowLayer(RealNVP((TR_D,), n_layers=2)),
                     HMCLayer((TR_D,))], target, prior, seed=0, device=dev)
        batch = lambda seed: sharded.sample(  # noqa: E731
            (n,), generator=torch.Generator(device=dev).manual_seed(seed))
        epochs = SHARD_SNF_EPOCHS if passes is None else passes
        fitted = {}
        if epochs:
            model.fit(batch(1), n_epochs=epochs, seed=2)
            fitted["loss"] = model.loss_trace.cpu().numpy()
        history, x, log_w = model.inverse(batch(4 if epochs else 1), seed=3)
        return {"history": history.cpu().numpy(), "particles": x.cpu().numpy(),
                "log_weights": log_w.cpu().numpy(),
                "log_Z": float(torch.logsumexp(log_w, 0) - np.log(n)),
                "flow": np.concatenate([flat_leaves(p) for p in model.params if p]), **fitted}
    if method == "ns":
        ns_prior, ns_target = transport_targets(TR_NS_D)
        flow = flow_on_mesh(TR_NS_D)
        out = NestedSampling(ShardedPrior(ns_prior, mesh), lambda x: -ns_target(x), flow,
                             n_live_points=TR_NS["n_particles"]).run(
            n_iterations=TR_NS["n_iterations"], seed=0)
        flat, placed = replicated(flow.params)
        return {"log_Z": out["log_Z"], "live": out["live_points"], "dead": out["dead_points"],
                "live_ll": out["live_log_likelihoods"], "flow": flat, "replicated": placed}
    from nfmc_torch.flow_training import FAB

    f = TR_FAB
    flow = flow_on_mesh()
    algorithm = FAB(target, flow)
    trained = algorithm.run(n_iterations=SHARD_FAB_ITERS,
                            n_flow_training_steps=f["n_flow_training_steps"],
                            n_ais_particles=f["n_ais_particles"], seed=0)
    flat, placed = replicated(trained.params)
    return {"flow": flat, "loss": algorithm.loss_trace.cpu().numpy(), "replicated": placed}


def b19_nuts(mesh, dev) -> dict:
    """19b: NUTS at 1024 chains and the JAX-tuned step, sampling: each rank
    builds its own chains' trees and breaks on them."""
    from nfmc_torch.parallel import sharded_sample
    from nfmc_torch.potentials import StandardGaussian
    from nfmc_torch.samplers.mcmc import NUTS
    from nfmc_torch.samplers.mcmc.nuts import NUTSKernel

    s = NUTS((D,), StandardGaussian((D,)), NUTSKernel(event_size=D, step_size=NUTS_STEP_JAX_MID),
             device=dev)
    s.params.n_iterations = SHARD_ITERS
    x0 = torch.randn((NUTS_C, D), generator=torch.Generator(device=dev).manual_seed(19),
                     device=dev)
    out = (s.sample(x0, seed=19, show_progress=False) if mesh is None
           else sharded_sample(s, x0, mesh=mesh, seed=19, show_progress=False))
    return run_summary(out, depths=np.asarray(s.tree_depths(), np.float64))


def b19_adaptive_imh(mesh, dev) -> dict:
    """19b: AdaptiveIMH on the misfit target, each refit through the
    coupling VJP kernel on the stored batch of every rank's chains,
    gathered."""
    from nfmc_torch.flows import Flow, RealNVP
    from nfmc_torch.parallel import sharded_sample
    from nfmc_torch.potentials import DiagonalGaussian
    from nfmc_torch.samplers.nfmc import AdaptiveIMH, IMHKernel

    s = AdaptiveIMH((D,), DiagonalGaussian(np.full(D, 0.12, np.float32), np.float32(1.0)),
                    IMHKernel((D,), flow=Flow(RealNVP((D,), n_layers=L, hidden_size=H), seed=0)),
                    device=dev)
    s.params.n_iterations = SHARD_IMH_ITERS
    x0 = torch.randn((C, D), generator=torch.Generator(device=dev).manual_seed(19), device=dev)
    out = (s.sample(x0, seed=19, show_progress=False) if mesh is None
           else sharded_sample(s, x0, mesh=mesh, seed=19, show_progress=False))
    return run_summary(out)


def b19_jump_hmc(mesh, dev):
    """19b: jump_hmc at 1024 chains through the front door with fit_nf=True:
    from the first jump on, each refits the flow (SHARD_FIT_EPOCHS epochs,
    fixed effort) on the inner draws of every rank's chains, gathered, each
    rank on all of them."""
    import nfmc_torch
    from nfmc_torch.flows import Flow, RealNVP
    from nfmc_torch.potentials import StandardGaussian

    return nfmc_torch.sample(
        StandardGaussian((D,)), strategy="jump_hmc",
        flow=Flow(RealNVP((D,), n_layers=L, hidden_size=H), seed=0), n_chains=JUMP_HMC_C,
        n_iterations=SHARD_OUTER, inner_param_kwargs={"n_iterations": SHARD_INNER},
        param_kwargs={"fit_nf": True, "n_jumps_before_training": 1,
                      "flow_fit_kwargs": {"n_epochs": SHARD_FIT_EPOCHS}},
        seed=19, device=dev, show_progress=False, mesh=mesh)


B19_SCENARIOS = {
    "nuts": b19_nuts,
    "adaptive_imh": b19_adaptive_imh,
    "jump_hmc": lambda mesh, dev: run_summary(b19_jump_hmc(mesh, dev)),
    "aft": lambda mesh, dev: shard_transport("aft", dev, mesh, passes=0),
    "aft_fit": lambda mesh, dev: shard_transport("aft", dev, mesh),
    "craft_sample": lambda mesh, dev: shard_transport("craft", dev, mesh, passes=0),
    "craft": lambda mesh, dev: shard_transport("craft", dev, mesh),
    "ais": lambda mesh, dev: shard_transport("ais", dev, mesh),
    "snf_inverse": lambda mesh, dev: shard_transport("snf", dev, mesh, passes=0),
    **{m: (lambda mesh, dev, m=m: shard_transport(m, dev, mesh)) for m in ("snf", "ns", "fab")},
}


# the 19b runs whose unsharded reference is a 19a run without a mesh (the
# same call, and so the same result): 19b takes it from there
B19_FROM_19A = {"aft_fit": "aft", "craft": "craft", "ais": "ais", "snf": "snf", "ns": "ns",
                "fab": "fab"}


def b19_transport_check(name: str, got: dict, want: dict) -> tuple:
    """19b's gate on a transport run of two ranks (``got``) against the
    unsharded one (``want``): ``(what was compared, whether it holds)``. AFT
    and CRAFT with their fits off, AIS and SNF's inverse: log Z to
    SHARD_AFT_LOGZ_TOL and the particles and log-weights (the history) to
    SHARD_TOL; AFT and CRAFT trained: both log Z finite and within
    SHARD_AFT_FIT_LOGZ_TOL (CRAFT's within SHARD_CRAFT_LOGZ_TOL, its
    particle means to SHARD_FIT_MEAN_TOL and at most SHARD_CRAFT_PARTED of
    its weights beyond SHARD_TOL); SNF fitted:
    each epoch's loss (relative), the weights, log Z on fresh draws and
    that inverse's output to SHARD_TOL; nested sampling and FAB bit for bit
    (their flows replicated on the mesh)."""
    def diff(k):
        return float(np.abs(np.asarray(got[k], np.float64) - np.asarray(want[k], np.float64)).max())

    dz = abs(got["log_Z"] - want["log_Z"]) if "log_Z" in want else None
    finite = dz is not None and np.isfinite(got["log_Z"]) and np.isfinite(want["log_Z"])
    if name in ("ns", "fab"):
        keys = sorted(want)
        ok = got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in keys)
        return f"bit-identical {ok} ({', '.join(keys)}; replicated {got['replicated']})", ok
    if name in ("aft_fit", "craft"):
        text = f"log Z {got['log_Z']:.6f} vs {want['log_Z']:.6f} unsharded, |diff| {dz:.3e}"
        ok = finite and dz < SHARD_AFT_FIT_LOGZ_TOL
        if name == "craft":
            dm = float(np.abs(got["particles"].mean(0) - want["particles"].mean(0)).max())
            dw = np.abs(got["flow"] - want["flow"])
            parted = float(np.mean(dw > SHARD_TOL))
            text += (f"; particle means max|diff| {dm:.3e}; weights max|diff| {dw.max():.3e}, "
                     f"rms {float(np.sqrt(np.mean(dw ** 2))):.3e}, {parted:.4%} of "
                     f"{dw.size} beyond {SHARD_TOL}")
            ok = (ok and dz < SHARD_CRAFT_LOGZ_TOL and dm < SHARD_FIT_MEAN_TOL
                  and parted <= SHARD_CRAFT_PARTED and bool(np.isfinite(got["flow"]).all()))
        return text, ok
    keys = [k for k in ("particles", "log_weights", "history", "flow") if k in want]
    errs = {k: diff(k) for k in keys}
    ok = finite and all(e <= SHARD_TOL for e in errs.values())
    if name == "snf":  # fitted: log Z and each epoch's loss too
        dl = np.abs(got["loss"] - want["loss"]) / np.maximum(1.0, np.abs(want["loss"]))
        errs["loss (relative)"] = float(dl.max())
        ok = ok and dz <= SHARD_TOL and errs["loss (relative)"] <= SHARD_TOL
    else:
        ok = ok and dz < SHARD_AFT_LOGZ_TOL
    if name == "ais":
        ok = ok and got["plain"]
    return (f"log Z {got['log_Z']:.6f} vs {want['log_Z']:.6f} unsharded, |diff| {dz:.3e}; "
            + ", ".join(f"{k} max|diff| {e:.3e}" for k, e in errs.items())), ok


# what each 19b rank adds to a scenario's result beside the run's own
RANK_KEYS = ("wall", "coll_s", "coll_n", "shapes")


def rank19b(rank: int, world: int, workdir: str) -> None:
    """19b: one of ``world`` ranks, a process of its own on the one card: it
    joins a gloo group (a FileStore in ``workdir``), runs each of
    B19_SCENARIOS on CUDA with ``chain_mesh(device_type="cpu")`` carrying
    the collectives on the host (and ``param_mesh``'s CUDA mesh holding the
    replicated flows), and writes ``rank<r>.pkl`` with each run's
    results, wall, RealNVP launches by shape and the time and number of its
    collectives (``ChainShard``'s sum, max, gather and seed broadcast and
    ``DTensor.full_tensor``, the copies to the host and back included). It
    sets itself up, writes ``ready<r>`` (when it entered this function and
    when it was set up), then waits for a file ``go`` in ``workdir`` before
    the first run. A failure raises: the process exits non-zero."""
    import os
    import pickle
    from datetime import timedelta

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from nfmc_torch.core.chains import ChainShard
    from nfmc_torch.ops import build
    from nfmc_torch.parallel import chain_mesh, shard_chains

    t_entry = time.time()
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    build.library("coupling")  # the libraries the parent built
    # CUDA's libraries start before the first timed run
    torch.linalg.cholesky(torch.eye(4, device=dev) @ torch.eye(4, device=dev))
    torch.randn(4, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    spent = [0.0, 0]

    def timed(fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            spent[0] += time.perf_counter() - t0
            spent[1] += 1
            return out
        return run

    for name in ("sum", "max", "gather", "agree_seed"):
        setattr(ChainShard, name, timed(getattr(ChainShard, name)))
    # nested sampling gathers its sharded draws through DTensor itself
    DTensor.full_tensor = timed(DTensor.full_tensor)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=SHARD_GLOO_TIMEOUT_S))
    try:
        mesh = chain_mesh(device_type="cpu")
        shard_chains(torch.zeros((world, 1), device=dev), mesh)  # DTensor's first use
        ChainShard(mesh).gather(torch.zeros(1, device=dev))
        param_mesh(mesh, dev)
        with open(os.path.join(workdir, f"ready{rank}"), "w") as f:
            f.write(f"{t_entry} {time.time()}")
        # the parent says go once its own runs are done, so the ranks' walls
        # are theirs alone
        go, deadline = os.path.join(workdir, "go"), time.time() + 3 * SHARD_TIMEOUT_S
        while not os.path.exists(go):
            if time.time() > deadline:
                raise TimeoutError(f"rank {rank}: no go within {SHARD_TIMEOUT_S} s")
            time.sleep(0.05)
        results = {}
        for name, fn in B19_SCENARIOS.items():
            dist.barrier()
            spent[:] = [0.0, 0]
            build.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with RealNVPLaunches() as rec:
                out = fn(mesh, dev)
                torch.cuda.synchronize()
            out.update(wall=time.perf_counter() - t0, coll_s=spent[0], coll_n=spent[1],
                       shapes=dict(rec.n),
                       launches={w.__name__: w.launches for w in build.WRAPPERS if w.launches})
            results[name] = out
        path = os.path.join(workdir, f"rank{rank}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(results, f)
        os.replace(path + ".tmp", path)
    finally:
        dist.destroy_process_group()


def start_ranks19b():
    """Spawn 19b's SHARD_RANKS ranks (``rank19b``) early, so that they set
    themselves up (imports, CUDA, the kernels' libraries, the gloo group)
    beside the phases before 19; daemons, so that they end with the script
    on any failure. Returns ``(processes, workdir, spawn time)``."""
    import atexit
    import shutil
    import tempfile

    workdir = tempfile.mkdtemp(prefix="nfmc-19b-")
    atexit.register(shutil.rmtree, workdir, True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank19b, args=(r, SHARD_RANKS, workdir), daemon=True)
             for r in range(SHARD_RANKS)]
    t_spawn = time.time()
    for p in procs:
        p.start()
    return procs, workdir, t_spawn


def run_sharded_phases(dev, known, ranks19b) -> dict:
    """Phase 19: 19a each strategy declared for several ranks after phase
    18's through ``sample(..., mesh=chain_mesh())`` (a one-rank NCCL group)
    and without it, bit for bit (draws, moments, counters, adapted state,
    launch counts), AFT, PMC, CRAFT, AIS and SNF with their particles drawn
    sharded on that mesh, nested sampling with its live set sharded and its
    flow replicated there, and FAB with its flow replicated there; 19b two
    gloo ranks, each a process on the one card, running B19_SCENARIOS
    against the same runs unsharded on the card in this process (draws and
    means to SHARD_TOL with equal counters; the transport runs by
    ``b19_transport_check``; the ranks are ``start_ranks19b()``'s); then
    every RealNVP shape the phase launched that ``known`` (a phase 3, 3b or
    17 shape: timing) lacks, against the plain version."""
    import os
    import pickle
    import shutil

    import torch.distributed as dist

    from nfmc_torch.core.chains import ChainShard
    from nfmc_torch.ops import build
    from nfmc_torch.parallel import chain_mesh

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    t_phase = time.perf_counter()
    res = {"shapes": {}, "walls": {}}

    def counts():
        return {w.__name__: w.launches for w in build.WRAPPERS if w.launches}

    def measured(label, run):
        """``run()``'s result, launches and wall; its launches by shape kept
        under ``label`` (None: not kept)."""
        build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with RealNVPLaunches() as rec:
            out = run()
            torch.cuda.synchronize()
        if label is not None:
            res["shapes"][label] = rec.n
        return out, counts(), time.perf_counter() - t0

    def same(a, b) -> bool:
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        return np.array_equal(np.asarray(a), np.asarray(b))

    procs, workdir, t_spawn = ranks19b
    plain19a = {}  # 19a's transport runs without a mesh, by method
    try:
        # ---- 19a. one rank: a one-rank NCCL mesh against no mesh ----------------------
        check(not dist.is_initialized(), "19a: a process group is already running")
        mesh = chain_mesh()
        try:
            # NCCL sets each collective up at its first call: do that here
            warm = ChainShard(mesh)
            warm.sum(torch.zeros(1, device=dev))
            warm.gather(torch.zeros(1, device=dev))
            warm.agree_seed(0)
            for strategy in SHARD_STRATEGIES:
                # the launches are kept once: the two runs' must be equal
                runs = {label: measured(m and f"19a {strategy}",
                                        lambda m=m: run_summary(shard_run(strategy, dev, m)))
                        for label, m in (("plain", None), ("mesh", mesh))}
                (a, la, wa), (b, lb, wb) = runs["plain"], runs["mesh"]
                res["walls"][strategy] = (wa, wb)
                ok = la == lb and all(same(a[k], b[k]) for k in a)
                print(f"19a {strategy}: without a mesh {wa:.3f} s, with the one-rank NCCL mesh "
                      f"{wb:.3f} s; draws {a['samples'].shape}, acc "
                      f"{a['counters']['n_accepted_trajectories']} of "
                      f"{a['counters']['n_attempted_trajectories']}, bit-identical {ok} (draws, "
                      f"moments, counters, adapted {sorted(a['state'])}); launches {lb}")
                check(ok, f"19a {strategy}: the one-rank mesh run differs from the run without it")
                check(np.isfinite(a["samples"]).all(), f"19a {strategy}: non-finite draws")
                check(strategy in ("ula", "uhmc", "mh", "nuts", "ess")
                      or la.get("fused_realnvp_vjp", 0) > 0,
                      f"19a {strategy}: the flow's fit never went through the VJP kernel: {la}")
            for method in SHARD_TRANSPORT:
                runs = {label: measured(m and f"19a {method}",
                                        lambda m=m: shard_transport(method, dev, m))
                        for label, m in (("plain", None), ("mesh", mesh))}
                (a, la, wa), (b, lb, wb) = runs["plain"], runs["mesh"]
                res["walls"][method] = (wa, wb)
                plain19a[method] = runs["plain"]
                ok = la == lb and a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
                print(f"19a {method}: without a mesh {wa:.3f} s, with it {wb:.3f} s"
                      + (f"; log Z {a['log_Z']:.6f}" if "log_Z" in a else "")
                      + f"; bit-identical {ok} ({', '.join(sorted(a))}); launches {lb}")
                check(ok, f"19a {method}: the run on the one-rank mesh differs from the run "
                          "without it")
                check(method == "ais" or la.get("fused_realnvp_vjp", 0) > 0,
                      f"19a {method}: the flow was never trained through the VJP kernel: {la}")
        finally:
            dist.destroy_process_group()
        lap_19a = time.perf_counter() - t_phase

        # ---- 19b. two gloo ranks on the one card --------------------------------------
        # the unsharded runs on the card first, then the ranks alone
        t0 = time.perf_counter()
        refs = {}
        for name, fn in B19_SCENARIOS.items():
            if B19_FROM_19A.get(name) in plain19a:  # the same call: its run without a mesh
                ref, la, wa = plain19a[B19_FROM_19A[name]]
            else:
                ref, la, wa = measured(f"19b {name} unsharded", lambda fn=fn: fn(None, dev))
            refs[name] = {**ref, "wall": wa, "launches": la}
        t_go, go_at = time.perf_counter(), time.time() - t_spawn
        open(os.path.join(workdir, "go"), "w").close()
        for p in procs:
            p.join(timeout=max(0.0, t_go + SHARD_TIMEOUT_S - time.perf_counter()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        check(not hung, f"19b: ranks {hung} did not finish within {SHARD_TIMEOUT_S} s")
        check(all(p.exitcode == 0 for p in procs),
              f"19b: the ranks exited with {[p.exitcode for p in procs]}")
        ranks, ready = [], []
        for r in range(SHARD_RANKS):
            with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
            with open(os.path.join(workdir, f"ready{r}")) as f:
                ready.append([float(v) - t_spawn for v in f.read().split()])
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(workdir, ignore_errors=True)
    wall_19b = time.perf_counter() - t0
    for name in B19_SCENARIOS:
        want, got = refs[name], ranks[0][name]
        check(all(same(got[k], rk[name][k]) for rk in ranks[1:] for k in got
                  if k not in RANK_KEYS + ("launches",)),
              f"19b {name}: the ranks' gathered results differ")
        for r, rk in enumerate(ranks):
            res["shapes"][f"19b {name} rank {r}"] = collections.Counter(rk[name]["shapes"])
            print(f"19b {name} rank {r}: wall {rk[name]['wall']:.3f} s, collectives "
                  f"{rk[name]['coll_n']} taking {rk[name]['coll_s']:.3f} s (gloo on the host, "
                  f"copies included); launches {rk[name]['launches']}; by shape "
                  + ", ".join(f"{k[0]} {k[1][:3]} d={k[2]} B={k[5]}: {v}"
                              for k, v in sorted(rk[name]["shapes"].items())))
        res["walls"][f"19b {name}"] = (want["wall"], max(rk[name]["wall"] for rk in ranks),
                                       max(rk[name]["coll_s"] for rk in ranks))
        if "samples" not in want:  # a transport run
            text, ok = b19_transport_check(
                name, *({k: v for k, v in r.items() if k not in RANK_KEYS + ("launches",)}
                        for r in (got, want)))
            print(f"19b {name} on {SHARD_RANKS} ranks: {text}; unsharded {want['wall']:.3f} s, "
                  f"launches {want['launches']}")
            check(ok, f"19b {name}: the {SHARD_RANKS} ranks' run is off the unsharded one: {text}")
            continue
        e_draws = float(np.abs(got["samples"] - want["samples"]).max())
        e_mean = float(np.abs(got["mean"] - want["mean"]).max())
        print(f"19b {name}: draws {got['samples'].shape} max|diff| {e_draws:.3e}, means "
              f"max|diff| {e_mean:.3e}, counters equal {got['counters'] == want['counters']}"
              + (f", tree depths {got['depths']} vs {want['depths']}" if "depths" in got else "")
              + f"; unsharded {want['wall']:.3f} s, launches {want['launches']}")
        check(got["samples"].shape == want["samples"].shape and e_draws <= SHARD_TOL
              and e_mean <= SHARD_TOL, f"19b {name}: the two ranks' draws differ from one's")
        check(got["counters"] == want["counters"], f"19b {name}: the counters differ")
        check("depths" not in got or same(got["depths"], want["depths"]),
              f"19b {name}: the tree depths differ")
    check(ranks[0]["adaptive_imh"]["launches"].get("fused_realnvp_vjp", 0) > 0,
          "19b adaptive_imh: the refits never went through the VJP kernel")
    print(f"19a: {lap_19a:.1f} s; 19b: {wall_19b:.1f} s, of which the unsharded runs "
          f"{t_go - t0:.1f} s and the ranks' {wall_19b - t_go + t0:.1f} s; the ranks set up "
          + ", ".join(f"rank {r} at {b:.1f} s after the spawn (its imports {a:.1f} s)"
                      for r, (a, b) in enumerate(ready))
          + f", the go at {go_at:.1f} s ({smi})")

    # ---- every RealNVP shape the phase launched, against the plain version --------------
    launched = collections.Counter()
    for shapes in res["shapes"].values():
        launched.update(shapes)
    new = {k: v for k, v in launched.items() if k not in known}
    print(f"phase 19 kernels at the {len(new)} shapes of its {len(launched)} that phases 3, 3b "
          "and 17 did not hold:")
    res["timing"] = {**{k: known[k] for k in launched if k in known},
                     **check_transport_shapes(dev, new, label="phase 19")}
    res["wall"] = time.perf_counter() - t_phase
    print(f"phase 19: {res['wall']:.1f} s ({smi})")
    return res


def run_conditional_probe(dev) -> dict:
    """Phase 2b: CUDA graph conditional nodes, which NUTS's and ChEES's
    captured trajectories stand on (``graphs.when``, an IF node, and
    ``graphs.loop``, a WHILE node). One captured iteration of counters
    advanced under a true and a false predicate, a scope nested in a
    scope, a loop whose length changes from one iteration to the next (and
    one nested in a scope), counted launches in the scopes and an autograd
    pass in a scope, replayed with predicates that change from one
    iteration to the next, against the same body run eagerly: the
    counters, the state and the launch count exactly. Then the capture's
    wall and memory with 64 leapfrogs of (1024, 100) unrolled against the
    same as a loop. Raises where CUDA refuses a conditional node."""
    from nfmc_torch.core import graphs
    from nfmc_torch.ops import build
    from nfmc_torch.utils import value_and_batched_grad

    t0 = time.perf_counter()
    n_it = 9
    flags = torch.tensor([[i % 2 == 0, i % 3 != 1, i % 4 < 2] for i in range(n_it)],
                         device=dev)
    reps = torch.tensor([1 + (3 * i) % 5 for i in range(n_it)], device=dev)
    u_grad = value_and_batched_grad(lambda x: 0.5 * (x * x).sum(-1) + (x ** 4).sum(-1) / 8)

    class Probe:
        launches = 0

    def body(state, rows):
        c, v = state
        f, r = rows

        def count():
            build.count_launch(Probe, ("probe",))

        graphs.when(f[0], lambda: c[0:1].add_(1))
        graphs.when(~f[0], lambda: c[3:4].add_(1))

        def outer():
            c[1:2].add_(1)
            graphs.when(f[2], lambda: (c[2:3].add_(1), count()))
            graphs.loop(4, lambda t: t < r - 1, lambda t: (c[5:6].add_(t), count()), dev)
        graphs.when(f[1], outer)
        graphs.loop(6, lambda t: t < r, lambda t: (c[4:5].add_(1), count()), dev)

        def leapfrog():
            _u, g = u_grad(v)
            v.copy_(v - 0.01 * g)
        graphs.when(f[0], leapfrog)
        w = v * 2.0 + c[0].to(v.dtype)  # made after the scopes, in the main capture
        return [c, v], [w.sum(-1)]

    v0 = torch.randn((1024, 100), generator=torch.Generator(device=dev).manual_seed(0),
                     device=dev)
    state0 = [torch.zeros(6, dtype=torch.int64, device=dev), v0]
    ref_state = [t.clone() for t in state0]
    ref_out = []
    with torch.no_grad():
        for i in range(n_it):
            ref_state, outs = body(ref_state, [flags[i], reps[i]])
            ref_out.append(outs[0])
    eager_launches = Probe.launches
    Probe.launches = 0
    graph = graphs.IterationGraph(body, state0, [((n_it, 3), torch.bool), ((n_it,), torch.int64)],
                                  [((n_it, 1024), torch.float32)], dev)
    graph.load(state0, [flags, reps])
    with torch.no_grad():
        graph.run(n_it)
    torch.cuda.synchronize()
    check(isinstance(graph.backend, graphs._CudaGraph) and graph.captured,
          "2b: the probe was not captured")
    got = graph.state[0].tolist()
    print(f"2b conditional IF and WHILE nodes (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}): counters {got}, the eager loop's {ref_state[0].tolist()}; "
          f"launches counted in the scopes {Probe.launches} (eager {eager_launches}); capture "
          f"{graph.capture_seconds:.3f} s, pool {graph.backend.pool_bytes} B")
    taken = int(flags[:, 0].sum())
    check(torch.equal(graph.state[0], ref_state[0]) and got[0] == taken
          and got[3] == n_it - taken and got[4] == int(reps.sum()),
          f"2b: the counters {got} differ from the eager loop's {ref_state[0].tolist()}")
    check(torch.equal(graph.state[1], ref_state[1])
          and torch.equal(graph.outputs[0], torch.stack(ref_out)),
          "2b: the state or the outputs differ from the eager loop's")
    check(Probe.launches == eager_launches > 0, f"2b: {Probe.launches} launches counted, the "
                                                f"eager loop {eager_launches}")

    # the capture's wall and memory: 64 leapfrogs unrolled against a loop of
    # 64 runs of one
    walls = {}
    for looped in (False, True):
        def many(state, rows, looped=looped):
            (v,) = state

            def step(_t=None):
                _u, g = u_grad(v)
                v.copy_(v - 0.001 * g)
            if looped:
                graphs.loop(64, lambda t: t < rows[0], step, dev)
            else:
                for _ in range(64):
                    step()
            return [v], []

        g2 = graphs.IterationGraph(many, [v0], [((2,), torch.int64)], [], dev)
        g2.load([v0], [torch.full((2,), 64, dtype=torch.int64, device=dev)])
        with torch.no_grad():
            g2.run(2)
        torch.cuda.synchronize()
        walls[looped] = (g2.capture_seconds, g2.backend.pool_bytes)
        del g2
    print(f"2b capture of 64 leapfrogs of (1024, 100): unrolled {walls[False][0]:.3f} s, pool "
          f"{walls[False][1] / 2 ** 20:.1f} MiB; a loop {walls[True][0]:.3f} s, pool "
          f"{walls[True][1] / 2 ** 20:.1f} MiB; phase 2b {time.perf_counter() - t0:.1f} s")
    return {"captures": walls}


# phase 20: each captured path at full width (d = 100, 100 chains, RealNVP 4 x
# 128), with its depth cut: the headline GRAPH_OUTER outer iterations,
# pipelined and under a time limit that never stops it (chunks 1, 4, 16 and
# the rest, so that several chunk lengths replay), MALA, HMC and MH
# GRAPH_MCMC_WARM tuning and GRAPH_MCMC_ITERS sampling iterations, IMH
# GRAPH_IMH_ITERS with RealNVP and GRAPH_SPLINE_ITERS with c-rqnsf, TESS
# GRAPH_TESS_ITERS and NeuTra-HMC GRAPH_NEUTRA_ITERS
GRAPH_OUTER, GRAPH_MCMC_WARM, GRAPH_MCMC_ITERS = 64, 50, 250
GRAPH_IMH_ITERS, GRAPH_SPLINE_ITERS, GRAPH_TESS_ITERS, GRAPH_NEUTRA_ITERS = 1000, 200, 200, 50
# the samplers captured since: PT at 13a's sizes, AIES at 13b's walkers and
# the dense metric at 13's on the correlated target, each GRAPH_MCMC_WARM
# tuning and GRAPH_MCMC_ITERS sampling iterations; ESS at 12b's target and
# chains, GRAPH_ESS_ITERS iterations; jump_ess and jump_aies in 12c's
# setting, GRAPH_OUTER outer iterations. Their eager runs are profiled at
# 1 / GRAPH_EAGER_PROFILE_CUT of the iterations: the eager loop's launches
# an iteration are steady, and the profiler's own cost grows with them
GRAPH_ESS_ITERS, GRAPH_EAGER_PROFILE_CUT = 250, 25
# NUTS (phase 12's 1024 chains, d = 100, depth 10) GRAPH_DYN_WARM tuning
# iterations from the JAX package's tuned step (from the default 0.1 the
# first trees reach depth 10: ~17k eager launches an iteration) and
# GRAPH_DYN_ITERS sampling iterations; ChEES (12a's 1024 chains on
# DiagonalGaussian1(100)) and NeuTra-ChEES (12d's) GRAPH_MCMC_WARM and
# GRAPH_MCMC_ITERS; jump_chees in 12c's setting, GRAPH_OUTER outer
# iterations, jump_nuts GRAPH_JUMP_NUTS_OUTER (its eager loop takes ~0.2 s
# an outer iteration)
GRAPH_DYN_WARM, GRAPH_DYN_ITERS, GRAPH_JUMP_NUTS_OUTER = 50, 100, 16
# the refitting chunks, each refit inside its iteration's graph: DLMC at
# 11e's 1024 chains and refits, GRAPH_DLMC_ITERS iterations; AdaptiveIMH at
# 10c's setting (its 100 iterations); TESS's fused warmup at 11c's (20
# iterations, 10-epoch refits); jump_mala's fixed-effort fit_nf at 5c's (10
# outer iterations, refits of 2 epochs from the third), with RealNVP and
# with c-rqnsf
GRAPH_DLMC_ITERS = 5
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")


def launch_profile(run) -> tuple:
    """``run()`` under torch.profiler: ``(wall s, device busy s, kernel
    launches, graph launches)``, the launches counted from the host's
    runtime calls. The CUDA activity alone records those calls and the
    device's work; the CPU activity would add every operator and autograd
    node, seconds of the profiler's own time for an eager HMC window, and
    no count."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = trace_events(prof)
    names = collections.Counter(e.name() for e in events)
    return (wall, device_busy_us(events) / 1e6, sum(names[n] for n in HOST_LAUNCHES),
            sum(names[n] for n in GRAPH_LAUNCHES))


def adapted_state(kernel) -> dict:
    """The adaptation a tempering ladder or a dense metric carries on the
    host after a run, beside :func:`kernel_state`'s."""
    state = {k: np.asarray(getattr(kernel, k)) for k in
             ("betas", "step_sizes", "swap_acceptance_rates", "n_accepted_swaps", "mass_cov",
              "_resume_i", "_resume_t", "_resume_scalar_mode", "_resume_mu")
             if getattr(kernel, k, None) is not None}
    factors = getattr(kernel, "_resume_factors", None)
    if factors is not None:
        state["chol"], state["chol_inv"] = (t.cpu().numpy() for t in factors)
    return state


def run_graph_phases(dev) -> dict:
    """Phase 20: every captured path run from one seed with graphs and under
    ``disable_graphs()`` in this process, bit for bit: the stored draws,
    the counters, the moments, the final kernel state and each wrapper's
    launch count; each path's wall both ways, its host launches an
    iteration (kernel launches and graph launches in a torch.profiler
    window) and device busy share, and the graph cache's memory. The
    headline also runs on a one-rank NCCL ``chain_mesh()`` both ways."""
    import torch.distributed as dist

    import nfmc_torch
    from nfmc_torch.core import graphs
    from nfmc_torch.flows import Flow, RealNVP
    from nfmc_torch.ops import build
    from nfmc_torch.parallel import chain_mesh
    from nfmc_torch.potentials import (CallablePotential, DiagonalGaussian, DiagonalGaussian1,
                                       FullRankGaussian, GaussianMixture, StandardGaussian)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    t_phase = time.perf_counter()
    res = {"paths": {}}
    target = DiagonalGaussian1(D)

    def flow(name="realnvp"):
        if name == "realnvp":
            return Flow(RealNVP((D,), n_layers=L, hidden_size=H), seed=0)
        return nfmc_torch.create_flow_object(
            f'{name}%{{"n_layers": {L}, "hidden_size": {H}, "n_bins": {N_BINS}}}', (D,), seed=0)

    def headline(**kw):
        return nfmc_torch.sample(
            StandardGaussian((D,)), strategy="jump_mala", flow=flow(), n_chains=C,
            n_iterations=GRAPH_OUTER, inner_param_kwargs={"n_iterations": INNER_N},
            param_kwargs={"store_samples_on_device": True}, seed=0, show_progress=False, **kw)

    def mcmc(strategy, **kw):
        return nfmc_torch.sample(
            target, strategy=strategy, n_chains=C, n_iterations=GRAPH_MCMC_ITERS, warmup=True,
            n_warmup_iterations=GRAPH_MCMC_WARM, param_kwargs={"store_samples_on_device": True},
            seed=0, show_progress=False, **kw)

    def frozen(strategy, n, name="realnvp", **kw):
        return nfmc_torch.sample(target, strategy=strategy, flow=flow(name), n_chains=C,
                                 n_iterations=n, seed=0, show_progress=False,
                                 param_kwargs={"store_samples_on_device": True}, **kw)

    paths = {
        "headline": (GRAPH_OUTER, headline),
        "headline, time limit": (GRAPH_OUTER,
                                 lambda: headline(sampling_time_limit_seconds=1e9)),
        "mala": (GRAPH_MCMC_WARM + GRAPH_MCMC_ITERS, lambda: mcmc("mala")),
        "hmc": (GRAPH_MCMC_WARM + GRAPH_MCMC_ITERS, lambda: mcmc("hmc")),
        "mh": (GRAPH_MCMC_WARM + GRAPH_MCMC_ITERS, lambda: mcmc(
            "mh", kernel_kwargs={"inv_mass_diag": np.full(D, NEUTRA_MH_SCALE, np.float32)})),
        "imh": (GRAPH_IMH_ITERS, lambda: frozen("imh", GRAPH_IMH_ITERS)),
        "imh c-rqnsf": (GRAPH_SPLINE_ITERS, lambda: frozen("imh", GRAPH_SPLINE_ITERS, "c-rqnsf")),
        "tess": (GRAPH_TESS_ITERS, lambda: frozen("tess", GRAPH_TESS_ITERS,
                                                  negative_log_likelihood=target)),
        "neutra_hmc": (GRAPH_NEUTRA_ITERS, lambda: frozen(
            "neutra_hmc", GRAPH_NEUTRA_ITERS, inner_kernel_kwargs={"step_size": NEUTRA_STEP})),
    }

    # the samplers captured since, each made by ``make(cut)`` with its
    # iterations divided by ``cut`` (the eager profile's shorter run)
    means = np.stack([np.full(PT_D, -PT_MODE), np.full(PT_D, PT_MODE)]).astype(np.float32)
    gm = GaussianMixture(means, sigma=1.0)
    x0_pt = torch.as_tensor(pt_x0(0), device=dev)
    corr = FullRankGaussian(np.zeros(D, np.float32), dense_metric_targets()[2])
    x0_dense = torch.as_tensor(dense_x0("corr", 0), device=dev)
    x0_aies = torch.as_tensor(dense_x0("corr", 0, n=AIES_C), device=dev)
    ess_target = DiagonalGaussian(np.zeros(len(ESS_SIG), np.float32), ESS_SIG)
    misfit = DiagonalGaussian(np.full(D, JUMP12_MU, np.float32), np.float32(1.0))
    mu12 = device_copies(torch.full((D,), JUMP12_MU))
    misfit_nll = CallablePotential(
        lambda x: (0.5 * mu12(x.device) ** 2 - mu12(x.device) * x).sum(-1), (D,))

    def tuned(strategy, target, n_chains, x0, **kw):
        def make(cut=1):
            return nfmc_torch.sample(
                target, strategy=strategy, flow=None, n_chains=n_chains, x0=x0, warmup=True,
                n_warmup_iterations=GRAPH_MCMC_WARM // cut, n_iterations=GRAPH_MCMC_ITERS // cut,
                param_kwargs={"store_samples_on_device": True}, seed=0, show_progress=False,
                **kw)
        return GRAPH_MCMC_WARM + GRAPH_MCMC_ITERS, make

    def jump12(strategy, n_outer=GRAPH_OUTER, **kw):
        def make(cut=1):
            return nfmc_torch.sample(
                misfit, strategy=strategy, flow=Flow(RealNVP((D,), n_layers=L, hidden_size=H),
                                                     seed=0),
                n_chains=C, n_iterations=max(1, n_outer // cut),
                inner_param_kwargs={"n_iterations": JUMP12_INNER},
                param_kwargs={"store_samples_on_device": True}, seed=0, show_progress=False,
                **kw)
        return n_outer, make

    def ess(cut=1):
        return nfmc_torch.sample(ess_target, strategy="ess", flow=None,
                                 negative_log_likelihood=residual_nll(ESS_SIG), n_chains=ESS_C,
                                 n_iterations=GRAPH_ESS_ITERS // cut, seed=0, show_progress=False,
                                 param_kwargs={"store_samples_on_device": True})

    pt_kw = {"kernel_kwargs": {"n_temps": PT_TEMPS, "beta_min": PT_BETA_MIN}}
    since = {
        **{s: tuned(s, gm, PT_C, x0_pt, **pt_kw) for s in ("pt_mala", "pt_mh", "pt_hmc")},
        "aies": tuned("aies", corr, AIES_C, x0_aies),
        "ess": (GRAPH_ESS_ITERS, ess),
        **{s: tuned(s, corr, C, x0_dense) for s in ("dense_hmc", "dense_mala")},
        "jump_ess": jump12("jump_ess", negative_log_likelihood=misfit_nll),
        "jump_aies": jump12("jump_aies"),
    }

    def measured(run, eager):
        """``run()``'s summary, launches and wall, with graphs or without,
        and the graph cache as the run left it (its samplers still alive):
        its description, and the wall and memory of each capture in it. The
        graphs of runs before it whose owners are gone are freed first: a
        graph's release synchronises, and must not fall in the wall."""
        gc.collect()
        build.reset_launch_counts()
        torch.cuda.synchronize()
        with CaptureSampler() as cap, NewCaptures() as new:
            t0 = time.perf_counter()
            with (graphs.disable_graphs() if eager else contextlib.nullcontext()):
                out = run()
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            cache = graphs.CACHE.describe()
            captures = [(g.capture_seconds, g.backend.pool_bytes, g.body.__name__)
                        for g in new.graphs]
            summary = run_summary(out)
            summary["state"].update(adapted_state(out.kernel))
            for sampler in cap.samplers:
                inner = getattr(sampler, "inner_sampler", sampler)
                if hasattr(inner, "tree_depths"):
                    summary["state"]["tree_depths"] = np.asarray(inner.tree_depths())
                if hasattr(inner, "leapfrog_total"):
                    summary["state"]["leapfrog_total"] = np.asarray(inner.leapfrog_total)
        del cap
        return summary, {w.__name__: w.launches for w in build.WRAPPERS}, wall, (cache, captures)

    def same(a, b) -> bool:
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        return np.array_equal(np.asarray(a), np.asarray(b))

    def compare(label, n_it, run, profiled=True, short=None):
        """``short = (n, run)``: the eager profile's shorter run."""
        t_cmp = time.perf_counter()
        eager, l_eager, w_eager, _ = measured(run, eager=True)
        graph, l_graph, w_graph, cache = measured(run, eager=False)
        parts = {k: same(eager[k], graph[k]) for k in ("samples", "counters", "mean", "second",
                                                         "state")}
        parts["launches"] = l_eager == l_graph
        line = (f"20 {label} ({n_it} it): wall without graphs {w_eager:.3f} s, with "
                f"{w_graph:.3f} s ({w_eager / w_graph:.2f}x); bit for bit {parts}; launches "
                f"{ {k: v for k, v in l_graph.items() if v} }")
        cache, captures = cache
        row = {"wall": (w_eager, w_graph), "same": parts, "captures": captures}
        if profiled:
            n_e, run_e = short or (n_it, run)
            t_prof = time.perf_counter()
            with graphs.disable_graphs():
                pe = launch_profile(run_e)
            pg = launch_profile(run)
            t_prof = time.perf_counter() - t_prof
            row["profile"] = (pe, pg, n_e)
            line += (f"; profiled: kernel launches an iteration {pe[2] / n_e:.1f} without "
                     f"graphs ({n_e} it), {pg[2] / n_it:.1f} with (graph launches "
                     f"{pg[3] / n_it:.2f}), device busy {100 * pe[1] / pe[0]:.1f}% / "
                     f"{100 * pg[1] / pg[0]:.1f}% of {pe[0]:.3f} / {pg[0]:.3f} s")
        line += (f"; graph cache after the run {cache}; the run's captures (wall s, pool MiB, body) "
                 f"{[(round(c, 3), round(b / 2 ** 20, 1), n) for c, b, n in captures]}; the "
                 f"comparison took {time.perf_counter() - t_cmp:.1f} s")
        print(line + (f", its profiles {t_prof:.1f} s" if profiled else "") + f" ({smi})")
        check(all(parts.values()), f"20 {label}: the run with graphs differs from the eager "
                                   f"run: {parts}")
        if profiled:
            check(pg[3] > 0, f"20 {label}: no graph was launched")
        res["paths"][label] = row

    for label, (n_it, run) in paths.items():
        compare(label, n_it, run, profiled=label != "headline, time limit")
    t_since = time.perf_counter()
    for label, (n_it, make) in since.items():
        compare(label, n_it, make, short=(n_it // GRAPH_EAGER_PROFILE_CUT,
                                          lambda make=make: make(GRAPH_EAGER_PROFILE_CUT)))
    res["since_wall"] = time.perf_counter() - t_since
    print(f"20 PT, AIES, ESS, the dense metric, jump_ess and jump_aies: {res['since_wall']:.1f} s "
          f"({smi})")

    # the trajectories of data-dependent length, in scopes on device
    # predicates (graphs.when): NUTS at phase 12's width and depth, ChEES at
    # 12a's, the jump forms in 12c's setting and NeuTra-ChEES as 12d
    def nuts20(cut=1):
        return nfmc_torch.sample(
            StandardGaussian((D,)), strategy="nuts", n_chains=NUTS_C, warmup=True,
            n_warmup_iterations=GRAPH_DYN_WARM // cut, n_iterations=GRAPH_DYN_ITERS // cut,
            kernel_kwargs={"max_tree_depth": NUTS_DEPTH, "step_size": NUTS_STEP_JAX_MID},
            param_kwargs={"store_samples_on_device": True}, seed=0, show_progress=False)

    def chees20(cut=1):
        return nfmc_torch.sample(
            target, strategy="chees_hmc", n_chains=CHEES_C, warmup=True,
            n_warmup_iterations=GRAPH_MCMC_WARM // cut, n_iterations=GRAPH_MCMC_ITERS // cut,
            param_kwargs={"store_samples_on_device": True}, seed=0, show_progress=False)

    def neutra20(cut=1):
        return nfmc_torch.sample(
            StandardGaussian((D,)), strategy="neutra_chees", flow=flow(), n_chains=C,
            warmup=True, n_warmup_iterations=GRAPH_MCMC_WARM // cut,
            n_iterations=GRAPH_MCMC_ITERS // cut,
            param_kwargs={"warmup_fit_kwargs": {"n_epochs": 0}, "store_samples_on_device": True},
            seed=0, show_progress=False)

    dynamic = {
        "nuts": (GRAPH_DYN_WARM + GRAPH_DYN_ITERS, nuts20),
        "chees_hmc": (GRAPH_MCMC_WARM + GRAPH_MCMC_ITERS, chees20),
        "jump_nuts": jump12("jump_nuts", GRAPH_JUMP_NUTS_OUTER,
                            inner_kernel_kwargs={"step_size": JUMP12_NUTS_STEP}),
        "jump_chees": jump12("jump_chees"),
        "neutra_chees": (GRAPH_MCMC_WARM + GRAPH_MCMC_ITERS, neutra20),
    }
    t_dyn = time.perf_counter()
    for label, (n_it, make) in dynamic.items():
        compare(label, n_it, make, short=(max(1, n_it // GRAPH_EAGER_PROFILE_CUT),
                                          lambda make=make: make(GRAPH_EAGER_PROFILE_CUT)))
    res["dynamic_wall"] = time.perf_counter() - t_dyn
    print(f"20 NUTS, ChEES, jump_nuts, jump_chees and NeuTra-ChEES: {res['dynamic_wall']:.1f} s "
          f"({smi})")

    # the refitting chunks, their refits inside each iteration's graph: the
    # refit an IF node where a gate row decides it (AdaptiveIMH, fit_nf), its
    # epochs a WHILE node
    std = StandardGaussian((D,))

    def dlmc20():
        return nfmc_torch.sample(
            std, strategy="dlmc", negative_log_likelihood=std, flow=flow(), n_chains=DLMC_C,
            n_iterations=GRAPH_DLMC_ITERS, seed=0, show_progress=False,
            param_kwargs={"flow_fit_kwargs": dict(DLMC_FIT_KWARGS),
                          "store_samples_on_device": True})

    def adaptive20():
        return nfmc_torch.sample(target, strategy="adaptive_imh", flow=flow(), n_chains=C, seed=0,
                                 show_progress=False)

    def tess_warmup20():
        s = nfmc_torch.create_sampler(std, strategy="tess", negative_log_likelihood=std,
                                      flow=flow(), device=dev,
                                      param_kwargs={"n_warmup_iterations": 20,
                                                    "flow_fit_kwargs": dict(TESS_FIT_KWARGS),
                                                    "store_samples_on_device": True})
        return s.warmup(torch.zeros(C, D, device=dev), show_progress=False, seed=0)

    def fit_nf20(name="realnvp"):
        return nfmc_torch.sample(
            std, strategy="jump_mala", flow=flow(name), n_chains=C, n_iterations=10,
            inner_param_kwargs={"n_iterations": INNER_N}, seed=0, show_progress=False,
            param_kwargs={"fit_nf": True, "flow_fit_kwargs": {"n_epochs": 2},
                          "n_jumps_before_training": 2, "store_samples_on_device": True})

    refitting = {
        "dlmc (1024 chains)": (GRAPH_DLMC_ITERS, dlmc20),
        "adaptive_imh": (100, adaptive20),
        "tess fused warmup": (20, tess_warmup20),
        "jump_mala fit_nf": (10, fit_nf20),
        "jump_mala fit_nf c-rqnsf": (10, lambda: fit_nf20("c-rqnsf")),
    }
    t_refit = time.perf_counter()
    for label, (n_it, run) in refitting.items():
        compare(label, n_it, run)
        # one captured iteration; besides it, where the graph's eager first
        # iteration refits, the fit's own graph of its epochs (``epoch``)
        bodies = [n for _c, _b, n in res["paths"][label]["captures"]]
        check(len(bodies) - bodies.count("epoch") == 1 and bodies.count("epoch") <= 1,
              f"20 {label}: the run did not replay one captured iteration: {bodies}")
    res["refit_wall"] = time.perf_counter() - t_refit
    print(f"20 DLMC, AdaptiveIMH, TESS's warmup and fit_nf (the refitting chunks): "
          f"{res['refit_wall']:.1f} s ({smi})")

    # ---- 20b. the headline on a one-rank NCCL mesh ---------------------------------
    check(not dist.is_initialized(), "20b: a process group is already running")
    mesh = chain_mesh()
    try:
        dist.all_reduce(torch.zeros(1, device=dev), group=mesh.get_group(0))
        compare("headline, one-rank NCCL mesh", GRAPH_OUTER, lambda: headline(mesh=mesh),
                profiled=False)
    finally:
        dist.destroy_process_group()
    res["wall"] = time.perf_counter() - t_phase
    print(f"phase 20: {res['wall']:.1f} s ({smi})")
    return res


FIT21_SPLINE_EPOCHS, FIT21_PROFILE_EPOCHS, FIT21_VFIT_PROFILE, FIT21_DLMC_REFITS = 20, 10, 50, 3
# AdaptiveIMH's refit closure (1 epoch on a history row of C draws) called
# from the host this many times, as the front door refits in its first
# iterations; the front door's refits run inside its chunk's graph (phase 20)
FIT21_IMH_REFITS = 100


def run_fit_graph_phases(dev, headline_data) -> dict:
    """Phase 21: the flow fits with graphs and under ``disable_graphs()`` in
    this process, each from one seed, bit for bit: the weights, the carried
    tensors each fit ends with (weights, Adam's moments and count, the best
    weights and loss; of every refit, for the refitting paths), the losses
    the host read, the steps and epochs counted, and each wrapper's launches
    and launches by shape. The fits: the headline's warmup fit on phase 5b's
    own data (``headline_data``), IMH's reverse-KL warmup fit at phase 10b's
    size, AdaptiveIMH's refit closure at 10c's size, DLMC's refit closure at
    11e's size, and a fit of each coupling spline flow (the refitting
    samplers' own chunks, their refits inside, are phase 20's).
    Prints ms per Adam step both ways, the device busy share of a short
    window of the headline, IMH and DLMC fits both ways (the graph windows
    replay graphs captured before them) and the graph cache's memory."""
    import nfmc_torch
    from nfmc_torch.core import graphs
    from nfmc_torch.flows import Flow, RealNVP
    from nfmc_torch.flows import train as train_mod
    from nfmc_torch.ops import build
    from nfmc_torch.potentials import DiagonalGaussian1

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    t_phase = time.perf_counter()
    res = {"fits": {}, "shapes": {}}
    x_train, x_val = headline_data
    target = DiagonalGaussian1(D)

    def neg_u(v):
        return -target(v)

    def flow(name="realnvp"):
        if name == "realnvp":
            return Flow(RealNVP((D,), n_layers=L, hidden_size=H), seed=0).to(dev)
        return nfmc_torch.create_flow_object(
            f'{name}%{{"n_layers": {L}, "hidden_size": {H}, "n_bins": {N_BINS}}}', (D,),
            seed=0).to(dev)

    jump_fit_kw = nfmc_torch.NFMCParameters().flow_fit_kwargs
    imh_fit_kw = dict(nfmc_torch.IMHParameters().warmup_fit_kwargs)
    dlmc_x = torch.randn((DLMC_C, D), generator=torch.Generator(device=dev).manual_seed(21),
                         device=dev) * torch.from_numpy(target.sigma).to(dev)

    def dlmc_refits(fit):
        fit_flow = flow()
        params, g = fit_flow.params, torch.Generator(device=dev).manual_seed(22)
        for _ in range(FIT21_DLMC_REFITS):
            params = fit(params, dlmc_x, g)
        return flat_params(params)

    def dlmc_closure(fit_flow):
        return train_mod.make_scan_fit(fit_flow, DLMC_C, train_pct=0.7, **DLMC_FIT_KWARGS)

    imh_hist = torch.randn((FIT21_IMH_REFITS, C, D), generator=torch.Generator(
        device=dev).manual_seed(24), device=dev) * torch.from_numpy(target.sigma).to(dev)

    def imh_refits():
        fit = train_mod.make_scan_fit(flow(), C, n_epochs=1)  # as AdaptiveIMH makes it
        params, g = flow().params, torch.Generator(device=dev).manual_seed(25)
        for k in range(FIT21_IMH_REFITS):
            params = fit(params, imh_hist[k], g)
        return flat_params(params)

    def fitted(name, call):
        def run():
            f = flow(name)
            call(f)
            return flat_params(f.params)
        return run

    fits = {
        "headline fit": fitted("realnvp", lambda f: f.fit(x_train, x_val=x_val, seed=0,
                                                          **jump_fit_kw)),
        "IMH reverse-KL fit": fitted("realnvp", lambda f: f.variational_fit(neg_u, seed=0,
                                                                            **imh_fit_kw)),
        "AdaptiveIMH refits": imh_refits,
        "DLMC refits": lambda: dlmc_refits(dlmc_closure(flow())),
        **{f"{name} fit": fitted(name, lambda f: f.fit(
            x_train, x_val=x_val, seed=0, n_epochs=FIT21_SPLINE_EPOCHS, batch_size=256))
           for name in SPLINE_FLOWS.values()},
    }

    def measured(run, eager):
        """``run()``'s weights, the carried tensors and host-read losses of
        each fit it made, its counts, launches and wall, with graphs or
        without (earlier graphs whose owners are gone freed first, as in
        phase 20)."""
        gc.collect()
        build.reset_launch_counts()
        before = dict(train_mod.COUNTS)
        carries, rec = [], RecordingNumpy()
        orig_fitted, orig_np = train_mod._fitted, train_mod.np

        def recording(carry, keep_best):
            carries.append(torch.cat([t.reshape(-1) for t in carry]).cpu())
            return orig_fitted(carry, keep_best)

        train_mod._fitted, train_mod.np = recording, rec
        try:
            with ShapeLaunches() as shapes:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with (graphs.disable_graphs() if eager else contextlib.nullcontext()):
                    out = run()
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            train_mod._fitted, train_mod.np = orig_fitted, orig_np
        return {"out": out, "carries": carries, "losses": rec.seen,
                "counts": {k: train_mod.COUNTS[k] - before[k] for k in before},
                "launches": {w.__name__: w.launches for w in build.WRAPPERS},
                "shapes": dict(shapes.n), "wall": wall}

    def same_list(a, b, eq):
        return len(a) == len(b) and all(eq(x, y) for x, y in zip(a, b))

    for label, run in fits.items():
        e, gr = measured(run, eager=True), measured(run, eager=False)
        parts = {"weights": torch.equal(e["out"], gr["out"]),
                 "carried": same_list(e["carries"], gr["carries"], torch.equal),
                 "losses": same_list(e["losses"], gr["losses"], np.array_equal),
                 "counts": e["counts"] == gr["counts"], "launches": e["launches"] == gr["launches"],
                 "by shape": e["shapes"] == gr["shapes"]}
        steps = gr["counts"]["steps"] + gr["counts"]["variational_steps"]
        res["fits"][label] = {"wall": (e["wall"], gr["wall"]), "steps": steps, "same": parts}
        res["shapes"][f"fit graphs, {label}"] = collections.Counter(gr["shapes"])
        print(f"21 {label}: {len(gr['carries'])} fits, {gr['counts']}, wall without graphs "
              f"{e['wall']:.3f} s, with {gr['wall']:.3f} s; ms per Adam step "
              f"{1e3 * e['wall'] / max(steps, 1):.3f} / {1e3 * gr['wall'] / max(steps, 1):.3f}; "
              f"bit for bit {parts}; launches {({k: v for k, v in gr['launches'].items() if v})}; "
              f"graph cache {graphs.CACHE.describe()} ({smi})")
        check(len(gr["carries"]) > 0 and steps > 0 and gr["out"].numel() > 0
              and sum(gr["launches"].values()) > 0, f"21 {label}: no fit ran on the card")
        check(all(parts.values()), f"21 {label}: the fit with graphs differs from the eager "
                                   f"fit: {parts}")
        check(gr["launches"]["fused_realnvp_vjp"] + gr["launches"]["fused_spline_vjp"] == steps,
              f"21 {label}: backward launches != Adam steps")

    # ---- 21b. the device's busy share, and the weight buffer's cache ----------------
    def profiled(label, eager_run, graph_run, n_steps):
        with graphs.disable_graphs():
            pe = launch_profile(eager_run)
        pg = launch_profile(graph_run)
        res["fits"][label]["profile"] = (pe, pg)
        print(f"21b {label}, {n_steps} Adam steps profiled: wall {pe[0]:.3f} / {pg[0]:.3f} s "
              f"({1e3 * pe[0] / n_steps:.3f} / {1e3 * pg[0] / n_steps:.3f} ms a step) without / "
              f"with graphs, device busy {100 * pe[1] / pe[0]:.1f}% / {100 * pg[1] / pg[0]:.1f}%, "
              f"kernel launches {pe[2]} / {pg[2]}, graph launches {pe[3]} / {pg[3]} ({smi})")
        check(pg[3] > 0 and pe[3] == 0, f"21b {label}: graph launches {pe[3]} / {pg[3]}")

    f_head = flow()
    bs = train_mod._adaptive_batch_size(len(x_train))
    short = dict(jump_fit_kw, n_epochs=FIT21_PROFILE_EPOCHS)
    f_head.fit(x_train, x_val=x_val, seed=1, **short)  # captures the graph the window replays
    # the graph's first epoch ran eagerly: the kernels' weight buffer was
    # packed from the static buffers there, and must not be cached
    graph_bufs = {b.untyped_storage().data_ptr() for gr_ in f_head._graphs.values()
                  for b in (*gr_.state, *gr_.inputs, *gr_.outputs)}
    held = {t.untyped_storage().data_ptr() for t, _v in f_head.bijection._packed_src}
    check(len(graph_bufs) > 0 and not held & graph_bufs,
          "21b: the weight buffer's cache holds a graph's static buffer")
    profiled("headline fit",
             lambda: flow().fit(x_train, x_val=x_val, seed=1, **short),
             lambda: f_head.fit(x_train, x_val=x_val, seed=1, **short),
             FIT21_PROFILE_EPOCHS * (len(x_train) // bs))
    f_imh = flow()
    vkw = dict(imh_fit_kw, n_epochs=FIT21_VFIT_PROFILE, early_stopping=False)
    f_imh.variational_fit(neg_u, seed=1, **vkw)
    profiled("IMH reverse-KL fit", lambda: flow().variational_fit(neg_u, seed=1, **vkw),
             lambda: f_imh.variational_fit(neg_u, seed=1, **vkw), FIT21_VFIT_PROFILE)
    f_dlmc = flow()
    closure = dlmc_closure(f_dlmc)
    g22 = torch.Generator(device=dev).manual_seed(23)
    closure(f_dlmc.params, dlmc_x, g22)
    n_train = int(0.7 * DLMC_C)
    profiled("DLMC refits", lambda: dlmc_closure(flow())(f_dlmc.params, dlmc_x, g22),
             lambda: closure(f_dlmc.params, dlmc_x, g22),
             DLMC_FIT_KWARGS["n_epochs"] * (n_train // train_mod._adaptive_batch_size(n_train)))
    res["cache"] = graphs.CACHE.describe()
    res["wall"] = time.perf_counter() - t_phase
    print(f"phase 21: {res['wall']:.1f} s; graph cache {res['cache']} ({smi})")
    return res


# phase 22: the transport layer and FAB at phase 17's widths (d = TR_D,
# RealNVP 2 x 32), their depth cut: FAB TR22_FAB_ITERS iterations, AIS its
# TR_AIS 128 levels, AFT TR22_AFT_LEVELS levels, CRAFT TR22_CRAFT_PASSES
# training passes and two sampling passes (the second a replay), PMC to its
# end. The profiled windows: without graphs on fresh objects, FAB
# TR22_FAB_PROFILE iterations, AFT and PMC TR22_PROFILE_LEVELS levels, CRAFT
# TR22_PROFILE_LEVELS passes, AIS its 128 levels; with graphs on the objects
# of the runs with graphs, which replay the graphs those captured: FAB a
# block of its graph's length, the others as long as the run
TR22_FAB_ITERS, TR22_FAB_PROFILE, TR22_AFT_LEVELS, TR22_CRAFT_PASSES = 20, 4, 6, 5
TR22_PROFILE_LEVELS = 2


def transport_graph_paths(dev) -> dict:
    """Phase 22's paths: {label: (iterations, unit, make)}, ``make()`` a run
    from one seed on fresh objects returning ``(results on the host, the
    object that owns the graphs)``."""
    import nfmc_torch
    from nfmc_torch.flow_training import FAB
    from nfmc_torch.transport import CRAFT, AnnealedFlowTransport, PreconditionedMonteCarlo
    from nfmc_torch.transport.ais import make_ais

    prior, target = transport_targets(TR_D)

    def flow(seed=0):
        return nfmc_torch.create_flow_object(TR_FLOW, (TR_D,), seed=seed).to(dev)

    def host(res):
        return {k: np.asarray(v) for k, v in res.items()}

    def fab(n=TR22_FAB_ITERS, alg=None):
        alg = alg or FAB(target, flow())
        alg.run(n_iterations=n, n_flow_training_steps=TR_FAB["n_flow_training_steps"],
                n_ais_particles=TR_FAB["n_ais_particles"], seed=0)
        return {"flow": flat_leaves(alg.flow.params), "loss": alg.loss_trace.cpu().numpy(),
                **{f"buffer {i}": b.cpu().numpy() for i, b in enumerate(alg._buf_state)}}, alg

    def ais(chain=None):
        a = TR_AIS
        chain = chain or make_ais(prior, target, a["n_steps"], a["n_mcmc_steps"],
                                  a["step_size"])
        g = torch.Generator(device=dev).manual_seed(0)
        x0 = prior.sample((a["n"],), generator=g)
        x, log_w = chain(x0, chain.draws(g, tuple(x0.shape)))
        return {"x": x.cpu().numpy(), "log_w": log_w.cpu().numpy()}, chain

    def aft(alg=None, levels=TR22_AFT_LEVELS):
        a = TR_AFT
        alg = alg or AnnealedFlowTransport(prior, target, flow(), n_steps=levels + 1,
                                           n_train_epochs=a["n_train_epochs"])
        out = alg.run(lambda b, generator=None: prior.sample(b, generator=generator),
                      n_particles=a["n_particles"], n_train_particles=a["n_train_particles"],
                      n_val_particles=a["n_val_particles"], full_output=True, seed=0)
        return {**host(out), "flow": flat_leaves(alg.flow.params)}, alg

    def craft(alg=None, samples=(1, 2), passes=TR22_CRAFT_PASSES):
        c = TR_CRAFT
        alg = alg or CRAFT(prior, target, [flow(seed=i).bijection
                                           for i in range(c["n_annealing_steps"])])
        draw = lambda b, generator=None: prior.sample(b, generator=generator)  # noqa: E731
        alg.train(draw, n_particles=c["n_particles"], n_training_steps=passes, seed=0)
        out = {"flow": np.concatenate([flat_leaves(b.params) for b in alg.bijections])}
        for seed in samples:
            res = alg.sample(draw, n_particles=c["n_particles"], seed=seed)
            out.update({f"{k} {seed}": np.asarray(v) for k, v in host(res).items()})
        return out, alg

    def pmc(alg=None, levels=200):
        p = TR_PMC
        alg = alg or PreconditionedMonteCarlo(prior, target, flow(),
                                              n_train_epochs=p["n_train_epochs"],
                                              n_mcmc_steps=p["n_mcmc_steps"], max_levels=levels)
        out = alg.run(lambda b, generator=None: prior.sample(b, generator=generator),
                      n_particles=p["n_particles"], full_output=True, seed=0)
        return {**host(out), "flow": flat_leaves(alg.flow.params)}, alg

    return {"fab": (TR22_FAB_ITERS, "iteration", fab), "ais": (TR_AIS["n_steps"], "level", ais),
            "aft": (TR22_AFT_LEVELS, "level", aft),
            "craft": (TR22_CRAFT_PASSES, "training pass", craft), "pmc": (None, "level", pmc)}


def run_transport_graph_phases(dev, known) -> dict:
    """Phase 22: the transport layer and FAB with graphs and under
    ``disable_graphs()`` in this process, each from one seed, bit for bit:
    the results (particles, log-weights, log Z, histories, traces, the
    flows' weights, FAB's buffer with its device index and fill), every
    loop's carried tensors and outputs (``graphs.iterations``: Adam's
    moments and counts, the best weights, ``rho_logit``), and each
    wrapper's launches and launches by shape. Prints each path's wall both
    ways, its kernel and graph launches an iteration (a FAB iteration, an
    AIS / AFT / PMC level, a CRAFT training pass) and device busy share from
    a profiled window, and the graph cache's memory, beside the card's name
    and power limit; holds each RealNVP shape the phase launched that phase
    17 did not (``known``: phase 17's timings by shape) against the plain
    version."""
    from nfmc_torch.core import graphs
    from nfmc_torch.ops import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    t_phase = time.perf_counter()
    res = {"paths": {}, "shapes": {}}
    paths = transport_graph_paths(dev)

    def measured(make, eager):
        loops, orig = [], graphs.iterations

        def recording(*args, **kw):
            carry, consts, outs = orig(*args, **kw)
            loops.append([v.detach().cpu().clone() for v in (*carry, *outs)])
            return carry, consts, outs

        graphs.iterations = recording
        build.reset_launch_counts()
        try:
            with RealNVPLaunches() as shapes:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with (graphs.disable_graphs() if eager else contextlib.nullcontext()):
                    out, owner = make()
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            graphs.iterations = orig
        return {"out": out, "loops": loops, "wall": wall, "shapes": dict(shapes.n),
                "launches": {w.__name__: w.launches for w in build.WRAPPERS},
                "graphs": len(owner.__dict__.get("_graphs", {})), "owner": owner}

    def same(a, b) -> bool:
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, list):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        return np.array_equal(np.asarray(a), np.asarray(b))

    for label, (n_it, unit, make) in paths.items():
        units = unit + ("es" if unit.endswith("s") else "s")
        e, gr = measured(make, eager=True), measured(make, eager=False)
        parts = {"results": same(e["out"], gr["out"]),
                 "launches": e["launches"] == gr["launches"],
                 "by shape": e["shapes"] == gr["shapes"]}
        if label != "ais":  # the eager chain is a plain loop over the levels
            parts["carried"] = same(e["loops"], gr["loops"])
        if n_it is None:  # PMC: its levels
            n_it = len(gr["out"]["beta_trace"]) - 1
        # the profiled windows: eagerly on fresh objects, with graphs on the
        # run's own objects, whose graphs it captured
        warm = gr.pop("owner")
        quiet = contextlib.redirect_stdout(io.StringIO())  # PMC's cut-short warning
        if label == "fab":
            (graph,) = warm._graphs.values()
            window, g_window = TR22_FAB_PROFILE, graph.length
            eager_run = lambda: make(window)  # noqa: E731
            graph_run = lambda: make(g_window, warm)  # noqa: E731
        elif label == "ais":
            window = g_window = n_it
            eager_run, graph_run = make, lambda: make(warm)
        else:
            window, g_window = TR22_PROFILE_LEVELS, n_it
            eager_run = {"aft": lambda: make(levels=window),
                         "craft": lambda: make(samples=(), passes=window),
                         "pmc": lambda: make(levels=window)}[label]
            graph_run = {"aft": lambda: make(warm), "craft": lambda: make(warm, samples=()),
                         "pmc": lambda: make(warm)}[label]
        with graphs.disable_graphs(), quiet:
            pe = launch_profile(eager_run)
        pg = launch_profile(graph_run)
        row = {"wall": (e["wall"], gr["wall"]), "n": n_it, "unit": units, "same": parts,
               "profile": (pe, pg), "window": (window, g_window),
               "cache": graphs.CACHE.describe()}
        res["paths"][label] = row
        res["shapes"][f"transport graphs, {label}"] = collections.Counter(gr["shapes"])
        print(f"22 {label} ({n_it} {units}): wall without graphs {e['wall']:.3f} s, with "
              f"{gr['wall']:.3f} s ({e['wall'] / gr['wall']:.1f}x); bit for bit {parts}; "
              f"{gr['graphs']} graphs; launches "
              f"{ {k: v for k, v in gr['launches'].items() if v} }; profiled windows of {window} "
              f"/ {g_window} {units}: kernel launches a {unit} {pe[2] / window:.1f} without "
              f"graphs, {pg[2] / g_window:.1f} with (graph launches {pg[3] / g_window:.2f}), "
              f"device busy "
              f"{100 * pe[1] / pe[0]:.1f}% / {100 * pg[1] / pg[0]:.1f}% of {pe[0]:.3f} / "
              f"{pg[0]:.3f} s; graph cache {row['cache']} ({smi})")
        check(all(parts.values()), f"22 {label}: the run with graphs differs from the eager "
                                   f"run: {parts}")
        check(gr["graphs"] > 0 and pg[3] > 0 and pe[3] == 0,
              f"22 {label}: {gr['graphs']} graphs, graph launches {pe[3]} / {pg[3]}")
        if label == "fab":
            check(pg[3] == g_window, f"22 fab: {pg[3]} graph launches for {g_window} iterations")
    all_shapes = collections.Counter()
    for shapes in res["shapes"].values():
        all_shapes.update(shapes)
    missing = {k: n for k, n in all_shapes.items() if k not in known}
    print(f"phase 22 kernels at the {len(missing)} shapes it launched that phase 17 did not:")
    res["timing"] = {**{k: known[k] for k in all_shapes if k in known},
                     **check_transport_shapes(dev, missing, "phase 22")}
    res["wall"] = time.perf_counter() - t_phase
    print(f"phase 22: {res['wall']:.1f} s; graph cache {graphs.CACHE.describe()} ({smi})")
    return res


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    import nfmc_torch
    from nfmc_torch.ops import build
    from nfmc_torch.ops import coupling as ops
    from nfmc_torch.potentials import DiagonalGaussian, StandardGaussian
    from nfmc_torch.utils import tree_leaves

    t_start = time.perf_counter()
    laps, t_lap = [], [t_start]

    def lap(what):
        """Print and keep the wall since the last lap (the script's time by
        phase, against its limit)."""
        now = time.perf_counter()
        laps.append((what, now - t_lap[0]))
        t_lap[0] = now
        print(f"[{what}: {laps[-1][1]:.1f} s, {now - t_start:.1f} s since the start]")

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    # ---- 1. facts --------------------------------------------------------------
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"device {name} capability {cap} count {torch.cuda.device_count()}")
    check(cap == (9, 0), f"expected a Hopper card (9, 0), got {cap}")
    nvcc = subprocess.run([build.find_nvcc(), "--version"], capture_output=True, text=True)
    print("nvcc:", [ln for ln in nvcc.stdout.splitlines() if "release" in ln][-1])
    try:
        import triton

        print(f"triton {triton.__version__} imports")
    except ImportError as e:
        print(f"triton does not import: {e}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    check(smi.returncode == 0, "nvidia-smi failed")
    print(smi.stdout.strip().splitlines()[0])

    # ---- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    build.library("coupling")  # builds and loads every source
    sources = {**build.SOURCES, **build.HELPERS}
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {build.build_seconds:.2f} s, "
          f"{len(sources)} sources in parallel: {', '.join(sources)})")
    for ln in build.build_log.splitlines():
        if "registers" in ln or "spill" in ln or ln.startswith("=="):
            print("  ptxas:", ln.strip())
    run_conditional_probe(dev)

    lap("phases 1-2b")

    # ---- 3. kernel vs plain ------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # phase 18 runs first: its trace (18a) missed the traced headline's last
    # ~70 device ops, its inverse among them, in each of four runs that
    # reached it after 790 s or more of this script, and held them in each
    # run that reached it by 705 s and in a fresh process (NVIDIA H100 80GB
    # HBM3, 700.00 W); the cause is not known
    par18 = run_parallel_phases(dev)
    lap("phase 18")
    g = torch.Generator(device=dev).manual_seed(0)
    err = {False: 0.0, True: 0.0}
    timing = {}
    # the IMH path adds FixedIMH's chunks, variational_fit's inverse at its
    # batch of 128 and AdaptiveIMH's refit forward at its batch of 64; the
    # flow-reparameterised paths (11-11e) jump_hmc's and DLMC's 1024 chains,
    # DLMC's refit validation rows (1024 - 716) and TESS's (100 - 70)
    for d, hid, nl, rows in [*((D, H, L, b) for b in IMH_CHUNK_ROWS), (D, H, L, OUTER * C),
                             (D, H, L, IMH_CAP * C), (D, H, L, REFIT_B), (D, H, L, 128),
                             (D, H, L, 256), (D, H, L, 512), (D, H, L, 3000), (7, 16, 3, 37),
                             (D, H, L, DLMC_C), (D, H, L, DLMC_C - int(0.7 * DLMC_C)),
                             (D, H, L, C - int(0.7 * C)), (D, H, L, CKPT_SEG * C),
                             (D, H, L, MESH_OUTER * C), (D, H, L, JUMP_HMC_OUTER * JUMP_HMC_C),
                             (D, H, L, MISFIT_OUTER * C)]:
        params = perturbed_params(d, hid, nl, seed=d + rows, device=dev)
        packed = ops.pack_weights(params)
        x = torch.randn((rows, d), generator=g, device=dev)
        for inverse in (False, True):
            wrapper = ops.fused_realnvp_inverse if inverse else ops.fused_realnvp_forward
            y, ld = wrapper(params, x, 3.0, packed=packed)
            torch.cuda.synchronize()
            y_ref, ld_ref = ops.realnvp_stack_plain(params, x, 3.0, inverse)
            e = max((y - y_ref).abs().max().item(), (ld - ld_ref).abs().max().item())
            check(bool(torch.isfinite(y).all() and torch.isfinite(ld).all()), "non-finite kernel output")
            err[inverse] = max(err[inverse], e)
            reps = 50 if rows <= 1000 else 10
            k_ms, k_dev, k_txt = kernel_ms(lambda: wrapper(params, x, 3.0, packed=packed), reps)
            p_ms = median_ms(lambda: ops.realnvp_stack_plain(params, x, 3.0, inverse), reps)
            bound_ms, bound_by = bound(*stack_cost(d, hid, nl, rows))
            timing[(d, rows, inverse)] = (k_ms, k_dev, p_ms, bound_ms, bound_by, e)
            print(f"coupling {'inverse' if inverse else 'forward'} d={d} H={hid} L={nl} B={rows}: "
                  f"max|diff| {e:.3e} (max|y| {y_ref.abs().max().item():.2f}), kernel {k_txt}, "
                  f"plain {p_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
            check(e <= TOL, f"kernel disagrees with the plain version: {e} > {TOL}")

    # ---- 3b. backward kernel vs plain ------------------------------------------------
    bwd_err, bwd_timing = 0.0, {}
    for d, hid, nl, rows in [(D, H, L, 512), (D, H, L, 256), (D, H, L, 128), (D, H, L, C),
                             (D, H, L, REFIT_B), (7, 16, 3, 37), (D, H, L, 1001),
                             (D, H, L, DLMC_C)]:
        params = perturbed_params(d, hid, nl, seed=d + rows + 1, device=dev)
        packed = ops.pack_weights(params)
        x, gy = (torch.randn((rows, d), generator=g, device=dev) for _ in range(2))
        gld = torch.randn((rows,), generator=g, device=dev)
        for inverse in (False, True):
            got = ops.fused_realnvp_vjp(params, x, gy, gld, 3.0, inverse, packed)
            again = ops.fused_realnvp_vjp(params, x, gy, gld, 3.0, inverse, packed)
            torch.cuda.synchronize()
            ref = ops.realnvp_stack_vjp_plain(params, x, gy, gld, 3.0, inverse)
            pairs = list(zip([got[0], *tree_leaves(got[1])], [ref[0], *tree_leaves(ref[1])]))
            e_abs = max((a - b).abs().max().item() for a, b in pairs)
            scale = max(1.0, max(b.abs().max().item() for _, b in pairs))
            same = torch.equal(got[0], again[0]) and all(
                torch.equal(a, b) for a, b in zip(tree_leaves(got[1]), tree_leaves(again[1])))
            check(all(bool(torch.isfinite(a).all()) for a, _ in pairs), "non-finite gradient")
            bwd_err = max(bwd_err, e_abs)
            line = (f"coupling vjp {'inverse' if inverse else 'forward'} d={d} H={hid} L={nl} "
                    f"B={rows}: max|diff| {e_abs:.3e} (scale max(1, max|ref|) = {scale:.2f}), "
                    f"bit-identical rerun {same}")
            if d == D and rows in (512, 256, 128, REFIT_B, C, DLMC_C):
                k_ms, k_dev, k_txt = kernel_ms(lambda: ops.fused_realnvp_vjp(params, x, gy, gld, 3.0,
                                                                      inverse, packed), 30)
                p_ms = median_ms(lambda: ops.realnvp_stack_vjp_plain(params, x, gy, gld, 3.0,
                                                                     inverse), 30)
                bound_ms, bound_by = bound(*stack_cost(d, hid, nl, rows, backward=True))
                bwd_timing[(rows, inverse)] = (k_ms, k_dev, p_ms, bound_ms, bound_by, e_abs)
                line += f", kernel {k_txt}, plain {p_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})"
                if rows == 256 and not inverse or rows == C and inverse:
                    # where the backward's time goes: its two kernels on the
                    # device; at B=100 in the inverse direction (NeuTra's
                    # input gradient) the weights kernel's share is work
                    # whose result the caller drops
                    split = device_us(lambda: ops.fused_realnvp_vjp(params, x, gy, gld, 3.0, inverse,
                                                                    packed))
                    vjp_us = {k: v for k, v in split.items() if "coupling_vjp" in k}
                    line += ("; device per launch: " + ", ".join(
                        f"{k} {v:.2f} us" for k, v in vjp_us.items()))
                    w_us = sum(v for k, v in vjp_us.items() if "weights" in k)
                    if vjp_us:
                        line += (f" (the weight-gradient kernel {100 * w_us / sum(vjp_us.values()):.1f}"
                                 "% of the VJP's device time)")
            print(line)
            check(e_abs <= TOL * scale, f"backward kernel disagrees with the plain version: "
                                        f"{e_abs} > {TOL} * {scale}")
            check(same, "two launches of the backward kernel gave different gradients")

    # ---- 3c. RealNVP at d=3000 and 3500 -------------------------------------------
    run_wide_realnvp(dev, g)

    # ---- 4. chunk runner, card vs CPU, same draws ----------------------------------
    from nfmc_torch.flows import Flow, RealNVP
    from nfmc_torch.samplers.mcmc import LangevinParameters
    from nfmc_torch.samplers.nfmc import JumpMALA

    small = {}
    draws = None
    for device in ("cpu", "cuda"):
        flow = Flow(RealNVP((6,), n_layers=2, hidden_size=16), seed=0)
        flow.params = perturbed_params(6, 16, 2, seed=5, device="cpu")
        target = DiagonalGaussian(np.full(6, 0.3, np.float32), np.float32(1.2))
        s = JumpMALA((6,), target, kernel=nfmc_torch.NFMCKernel((6,), flow=flow),
                     inner_params=LangevinParameters(n_iterations=2), device=device)
        if draws is None:
            draws = s.make_chunk_draws(torch.Generator().manual_seed(3), 3, 8)
        x0 = torch.randn((8, 6), generator=torch.Generator().manual_seed(4)).to(device)
        st, ys = s.run_chunk(s.init_chunk_state(x0), {
            k: tuple(t.to(device) for t in v) if k == "inner" else v.to(device)
            for k, v in draws.items()})
        small[device] = ys.cpu()
    e_chunk = (small["cpu"] - small["cuda"]).abs().max().item()
    print(f"chunk runner card vs CPU (3 outer x 2 MALA steps, d=6, C=8): max|diff| {e_chunk:.3e}")
    check(e_chunk <= TOL, "the chunk runner on the card disagrees with the CPU run")

    # ---- 4b. Flow.fit, card vs CPU ---------------------------------------------------
    from nfmc_torch.flows import train as train_mod

    rng = np.random.default_rng(7)
    x_fit = (1.3 * rng.standard_normal((70, 6)) + 0.5).astype(np.float32)
    x_fit_val = (1.3 * rng.standard_normal((30, 6)) + 0.5).astype(np.float32)
    fits = {}
    orig_np = train_mod.np
    try:
        for device in ("cpu", "cuda"):
            flow = Flow(RealNVP((6,), n_layers=2, hidden_size=16), seed=0)
            flow.params = perturbed_params(6, 16, 2, seed=9, device=device)
            train_mod.np = rec = RecordingNumpy()
            flow.fit(x_fit, x_val=x_fit_val, shuffle=False, early_stopping=False, n_epochs=5,
                     batch_size=16, seed=0)
            fits[device] = (flat_params(flow.params), np.concatenate(rec.seen))
    finally:
        train_mod.np = orig_np
    e_w = (fits["cpu"][0] - fits["cuda"][0]).abs().max().item()
    e_vl = float(np.max(np.abs(fits["cpu"][1] - fits["cuda"][1])))
    print(f"Flow.fit card vs CPU (d=6, 70 rows at batch 16, 5 epochs): weights max|diff| {e_w:.3e}, "
          f"per-epoch val loss max|diff| {e_vl:.3e} (val losses {np.round(fits['cuda'][1], 5).tolist()})")
    check(len(fits["cuda"][1]) == 5 and e_w <= TOL and e_vl <= TOL,
          "Flow.fit on the card disagrees with the CPU fit")

    lap("phases 3-4b")

    # ---- 5. main path: the headline through the front door ----------------------
    def headline(n_outer=OUTER):
        return nfmc_torch.sample(
            StandardGaussian((D,)), strategy="jump_mala",
            flow=Flow(RealNVP((D,), n_layers=L, hidden_size=H), seed=0),
            n_chains=C, n_iterations=n_outer, inner_param_kwargs={"n_iterations": INNER_N},
            param_kwargs={"store_samples_on_device": True},
            seed=0, show_progress=False)

    # warm run (library, cuBLAS handles, the sampler's first call), cut from
    # the whole OUTER outer iterations to HEADLINE_WARM to keep the script's
    # wall, phase 17 included, inside its limit on a slow host
    headline(HEADLINE_WARM)
    build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = headline()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in build.WRAPPERS}
    st = out.statistics
    samples = out.samples
    n_chunks = launches["fused_realnvp_inverse"]
    print(f"headline: wall {wall:.3f} s, {OUTER / wall:.1f} outer it/s, launches {launches}, "
          f"MALA acc {st.acceptance_rate:.4f}, jump acc {st.jump_acceptance_rate:.4f}, "
          f"max|mean| {np.abs(out.mean).max():.4f}, max|E[x^2]-1| {np.abs(out.second_moment - 1).max():.4f}")
    check(samples.device.type == "cuda", "samples left the device")
    check(tuple(samples.shape) == (OUTER * (INNER_N + 1), C, D), f"bad sample shape {tuple(samples.shape)}")
    check(bool(torch.isfinite(samples).all()), "non-finite samples")
    check(launches["fused_realnvp_forward"] == OUTER, f"forward launches {launches} != {OUTER}")
    check(n_chunks >= 1, "the proposals never went through the inverse kernel")
    check(st.n_target_calls == OUTER * (INNER_N * 2 * C + 2 * C), "target-call counter law")
    check(st.n_target_gradient_calls == OUTER * INNER_N * 2 * C, "gradient counter law")
    check(st.n_attempted_jumps == OUTER * C, "attempted-jump counter law")
    check(st.n_attempted_trajectories == OUTER * INNER_N * C, "attempted-trajectory counter law")
    check(np.abs(out.mean).max() < 0.05 and np.abs(out.second_moment - 1).max() < 0.1,
          "headline moments are off N(0, I)")
    headline_ess = ess_per_second(out, wall, max_window=16384, what="headline")
    profile_window(lambda: nfmc_torch.sample(
        StandardGaussian((D,)), strategy="jump_mala",
        flow=Flow(RealNVP((D,), n_layers=L, hidden_size=H), seed=0), n_chains=C,
        n_iterations=64, inner_param_kwargs={"n_iterations": INNER_N},
        param_kwargs={"store_samples_on_device": True}, seed=1, show_progress=False),
        "headline, 64 outer it")

    lap("phase 5")

    # ---- 5b. the headline with warmup -----------------------------------------
    warm_outer = 500
    build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Instrument() as ins:
        wout = nfmc_torch.sample(
            StandardGaussian((D,)), strategy="jump_mala",
            flow=Flow(RealNVP((D,), n_layers=L, hidden_size=H), seed=0),
            n_chains=C, n_iterations=warm_outer, inner_param_kwargs={"n_iterations": INNER_N},
            warmup=True, seed=0, show_progress=False)
        torch.cuda.synchronize()
    wall_w = time.perf_counter() - t0
    warm_launches = {w.__name__: w.launches for w in build.WRAPPERS}
    headline_fit_data = (ins.x_train, ins.x_val)
    wst = wout.statistics
    ik = ins.inner.kernel
    jacc_w, macc_w = wst.jump_acceptance_rate, wst.acceptance_rate
    print(f"headline with warmup ({warm_outer} outer it): wall {wall_w:.3f} s, of which inner "
          f"tuning {ins.inner_s:.3f} s and flow fit {ins.fit_s:.3f} s; fit {ins.epochs} epochs, "
          f"{ins.steps} optimizer steps, {1e3 * ins.fit_s / max(ins.steps, 1):.3f} ms per Adam step "
          f"(fit wall / steps); launches {warm_launches}; tuned step size "
          f"{ik.step_size:.6f} (default {D ** (-1 / 3):.6f}), inverse mass "
          f"[{ik.inv_mass_diag.min():.4f}, {ik.inv_mass_diag.max():.4f}]")
    print(f"headline with warmup: jump acc {jacc_w:.4f}, MALA acc {macc_w:.4f}, max|mean| "
          f"{np.abs(wout.mean).max():.4f}, max|E[x^2]-1| {np.abs(wout.second_moment - 1).max():.4f}")
    check(ins.steps > 0 and warm_launches["fused_realnvp_vjp"] == ins.steps,
          "backward launches != optimizer steps")
    check(warm_launches["fused_realnvp_forward"] == ins.steps + ins.epochs + warm_outer,
          "forward launches != training steps + validation epochs + jumps")
    check(warm_launches["fused_realnvp_inverse"] == 1, "proposals not in one inverse launch")
    check(tuple(wout.samples.shape) == (warm_outer * (INNER_N + 1), C, D), "bad sample shape")
    check(wst.n_target_calls == warm_outer * (INNER_N * 2 * C + 2 * C), "target-call counter law")
    check(wst.n_target_gradient_calls == warm_outer * INNER_N * 2 * C, "gradient counter law")
    check(wst.n_attempted_jumps == warm_outer * C, "attempted-jump counter law")
    check(abs(ik.step_size - D ** (-1 / 3)) > 1e-4, "the warmup did not tune the step size")
    check(WARM_JUMP_ACC[0] <= jacc_w <= WARM_JUMP_ACC[1],
          f"warmup jump acceptance {jacc_w} outside {WARM_JUMP_ACC}")
    check(WARM_MALA_ACC[0] <= macc_w <= WARM_MALA_ACC[1],
          f"warmup MALA acceptance {macc_w} outside {WARM_MALA_ACC}")
    check(np.abs(wout.mean).max() < 0.05 and np.abs(wout.second_moment - 1).max() < 0.1,
          "moments after warmup are off N(0, I)")

    # ---- 5c. fit_nf=True, both routes -----------------------------------------
    from nfmc_torch.flows.train import _adaptive_batch_size

    # 10 outer iterations (20 until phase 19 joined the script: its gates
    # are counts)
    nf_outer, n_before = 10, 2
    n_fits, rows = nf_outer - n_before, INNER_N * C
    n_train = int(rows * 0.7)
    bs = _adaptive_batch_size(n_train)
    for route, kw, batches in (("fixed-effort", {"n_epochs": 2}, n_train // bs),
                               ("host", {"n_epochs": 2, "early_stopping": True}, -(-n_train // bs))):
        flow = Flow(RealNVP((D,), n_layers=L, hidden_size=H), seed=0)
        before = flat_params(flow.params)
        build.reset_launch_counts()
        t0 = time.perf_counter()
        with Instrument() as ins:
            nout = nfmc_torch.sample(
                StandardGaussian((D,)), strategy="jump_mala", flow=flow, n_chains=C,
                n_iterations=nf_outer, inner_param_kwargs={"n_iterations": INNER_N},
                param_kwargs={"fit_nf": True, "flow_fit_kwargs": kw,
                              "n_jumps_before_training": n_before},
                seed=0, show_progress=False)
            torch.cuda.synchronize()
        nl = {w.__name__: w.launches for w in build.WRAPPERS}
        nst = nout.statistics
        change = (flat_params(flow.params) - before).abs().max().item()
        print(f"fit_nf ({route} route, {nf_outer} outer it): wall {time.perf_counter() - t0:.3f} s, "
              f"{ins.steps} optimizer steps, launches {nl}, jump acc {nst.jump_acceptance_rate:.4f}, "
              f"max|weight change| {change:.4f}")
        check(tuple(nout.samples.shape) == (nf_outer * (INNER_N + 1), C, D), "fit_nf shape law")
        check(bool(torch.isfinite(nout.samples).all()), "fit_nf: non-finite samples")
        check(nst.n_target_calls == nf_outer * (INNER_N * 2 * C + 2 * C), "fit_nf call counter law")
        check(nst.n_attempted_jumps == nf_outer * C, "fit_nf jump counter law")
        check(ins.steps == n_fits * 2 * batches, f"fit_nf: {ins.steps} steps, expected "
                                                 f"{n_fits} refits x 2 epochs x {batches} batches")
        check(nl["fused_realnvp_vjp"] == ins.steps, "fit_nf: backward launches != optimizer steps")
        check(nl["fused_realnvp_inverse"] == nf_outer, "fit_nf: one proposal launch per iteration")
        check(change > 0, "fit_nf: the flow did not change")

    lap("phases 5b-5c")

    # ---- 6. misfit target -------------------------------------------------------
    mu = 0.12
    t0 = time.perf_counter()
    mis = nfmc_torch.sample(
        DiagonalGaussian(np.full(D, mu, np.float32), np.float32(1.0)), strategy="jump_mala",
        flow=Flow(RealNVP((D,), n_layers=L, hidden_size=H), seed=0),
        n_chains=C, n_iterations=MISFIT_OUTER, inner_param_kwargs={"n_iterations": INNER_N},
        param_kwargs={"store_samples_on_device": True}, seed=0, show_progress=False)
    jacc = mis.statistics.jump_acceptance_rate
    print(f"misfit N({mu}*1, I): jump acc {jacc:.4f}, MALA acc {mis.statistics.acceptance_rate:.4f}, "
          f"max|mean - mu| {np.abs(mis.mean - mu).max():.4f}, wall {time.perf_counter() - t0:.3f} s")
    check(0.30 <= jacc <= 0.50, f"misfit jump acceptance {jacc} outside [0.30, 0.50]")

    lap("phase 6")
    spline = run_spline_phases(dev, g)
    lap("phases 7-8c")
    run_wide_spline(dev, g)
    run_fault_checks(dev)
    lap("phases 7d-9")
    imh = run_imh_phases(dev)
    lap("phase 10")
    flows11 = run_flow_sampler_phases(dev)
    lap("phase 11")
    mcmc12 = run_mcmc_phases(dev)
    lap("phase 12")
    last13 = run_last_strategy_phases(dev)
    lap("phase 13")
    zoo14 = run_flow_zoo_phases(dev)
    lap("phase 14")
    last15 = run_last_flow_phases(dev)
    lap("phase 15")
    ckpt16 = run_checkpoint_phases(dev)
    lap("phase 16")
    ranks19b = start_ranks19b()
    tr17 = run_transport_phases(dev)
    lap("phase 17")
    known = {**{("stack", "inverse" if inv else "forward", D, H, L, rows): t
                for (d_, rows, inv), t in timing.items() if d_ == D},
             **{("vjp", "inverse" if inv else "forward", D, H, L, rows): t
                for (rows, inv), t in bwd_timing.items()}, **tr17["timing"]}
    par19 = run_sharded_phases(dev, known, ranks19b)
    lap("phase 19")
    graph20 = run_graph_phases(dev)
    lap("phase 20")
    fit21 = run_fit_graph_phases(dev, headline_fit_data)
    lap("phase 21")
    tr22 = run_transport_graph_phases(dev, tr17["timing"])
    lap("phase 22")

    kernels = []

    def kernel_row(name_, source, replaces, launches_, max_err, t):
        k_ms, k_dev, p_ms, bound_ms, bound_by = t[:5]
        kernels.append({
            "name": name_, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches_, "max_abs_err": max_err, "ms": k_ms, "device_ms": k_dev,
            "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })

    fwd_src, fwd_tpu = "nfmc_torch/csrc/coupling.cu", "nfmc_tpu/ops/coupling_pallas.py:60"
    bwd_src, bwd_tpu = "nfmc_torch/csrc/coupling_bwd.cu", "nfmc_tpu/ops/coupling_pallas.py:217"
    for inverse, rows in ((False, C), (True, OUTER * C)):
        wrapper = ops.fused_realnvp_inverse if inverse else ops.fused_realnvp_forward
        kernel_row(wrapper.__name__, fwd_src, fwd_tpu, launches[wrapper.__name__], err[inverse],
                   timing[(D, rows, inverse)])
    # the warmup's training batches: 4096 rows at the adaptive batch of 256
    kernel_row("fused_realnvp_vjp", bwd_src, bwd_tpu, warm_launches["fused_realnvp_vjp"], bwd_err,
               bwd_timing[(256, False)])

    def path_rows(label, shapes):
        """A row for each shape a path launched, with its launches at that
        shape and its error there; every such shape must have been held
        against the plain version in phase 3, 3b, 7 or 7b."""
        for (kernel, direction, rows), n in sorted(shapes.items()):
            inverse = direction == "inverse"
            if kernel == "stack":
                t = timing.get((D, rows, inverse))
                name_, src, tpu = f"fused_realnvp_{direction} ({label}, B={rows})", fwd_src, fwd_tpu
            elif kernel == "vjp":
                t = bwd_timing.get((rows, inverse))
                name_, src, tpu = (f"fused_realnvp_vjp ({direction}, {label}, B={rows})", bwd_src,
                                   bwd_tpu)
            elif kernel.endswith(" vjp"):
                kind = kernel.split()[0]
                t = spline["bwd_timing"].get((kind, rows, inverse))
                name_, src, tpu = (f"fused_spline_vjp ({kind}, {direction}, {label}, B={rows})",
                                   "nfmc_torch/csrc/spline_bwd.cu", REPLACES["bwd"])
            else:
                t = spline["fwd_timing"].get((kernel, rows, inverse))
                name_, src, tpu = (f"fused_{kernel}_{direction} ({label}, B={rows})",
                                   "nfmc_torch/csrc/spline.cu", REPLACES["fwd"])
            check(t is not None, f"the {label} path launched {name_}, a shape phases 3/3b/7/7b "
                                 "do not check")
            kernel_row(name_, src, tpu, n, t[5], t)

    # the IMH path (phases 10-10c) and the flow-reparameterised paths (11-11e)
    path_rows("IMH", imh["imh_shapes"] + imh["vfit_shapes"] + imh["refit_shapes"])
    for label, shapes in (*flows11["shapes"].items(), *mcmc12["shapes"].items(),
                          *last13["shapes"].items(), *ckpt16["shapes"].items(),
                          *par18["shapes"].items(), *fit21["shapes"].items()):
        path_rows(label, shapes)
    # phase 17's, 19's and 22's paths: each path's launches at each shape (d, H, L, B)
    for res_ in (tr17, par19, tr22):
        for label, shapes in res_["shapes"].items():
            for key, n in sorted(shapes.items()):
                kernel, direction, d_, hid, nl, rows = key
                tag = f"{label}, d={d_}, H={hid}, L={nl}, B={rows}"
                if kernel == "stack":
                    name_, src, tpu = f"fused_realnvp_{direction} ({tag})", fwd_src, fwd_tpu
                else:
                    name_, src, tpu = f"fused_realnvp_vjp ({direction}, {tag})", bwd_src, bwd_tpu
                t = res_["timing"][key]
                kernel_row(name_, src, tpu, n, t[5], t)
    for kind in SPLINE_FLOWS:
        for inverse, rows in ((False, C), (True, 500 * C)):
            k_ms, k_dev, p_ms, bound_ms, bound_by, e = spline["fwd_timing"][(kind, rows, inverse)]
            name_ = f"fused_{kind}_{'inverse' if inverse else 'forward'}"
            kernels.append({
                "name": name_, "route": "cuda", "source": "nfmc_torch/csrc/spline.cu",
                "replaces": REPLACES["fwd"], "launches": spline["launches"][kind][name_],
                "max_abs_err": spline["fwd_err"][kind], "ms": k_ms, "device_ms": k_dev,
                "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            })
    for kind in SPLINE_FLOWS:
        # the warmup's training batches: 4096 rows at the adaptive batch of 256
        k_ms, k_dev, p_ms, bound_ms, bound_by = spline["bwd_timing"][(kind, 256, False)][:5]
        kernels.append({
            "name": f"fused_spline_vjp ({kind})", "route": "cuda",
            "source": "nfmc_torch/csrc/spline_bwd.cu", "replaces": REPLACES["bwd"],
            "launches": spline["launches"][kind]["fused_spline_vjp"],
            "max_abs_err": spline["bwd_err"][kind], "ms": k_ms, "device_ms": k_dev,
            "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
    print(f"ESS/s: headline {headline_ess:.1f}, IMH {imh['imh_ess_per_s']:.1f}, neutra_hmc "
          f"{flows11['neutra_ess_per_s']:.1f}, tess {flows11['tess_ess_per_s']:.1f}; it/s: "
          f"neutra_hmc {flows11['neutra_it_per_s']:.2f}, tess {flows11['tess_it_per_s']:.2f}, "
          f"jump_hmc@{JUMP_HMC_C} outer {flows11['jump_hmc_it_per_s']:.3f} "
          f"({flows11['jump_hmc_grads_per_s']:.0f} leapfrog gradients/s), dlmc@{DLMC_C} "
          f"{flows11['dlmc_it_per_s']:.3f} ({smi.stdout.strip().splitlines()[0]})")
    jump12 = ", ".join(f"jump_{k} {v[0]:.2f} outer it/s (jump acc {v[1]:.4f})"
                       for k, v in mcmc12["jump"].items())
    print(f"phase 12: nuts@{NUTS_C} {mcmc12['nuts_it_per_s']:.2f} it/s "
          f"({mcmc12['nuts_grads_per_s']:.0f} gradients/s, {mcmc12['nuts_ess_per_s']:.1f} ESS/s), "
          f"chees_hmc@{CHEES_C} {mcmc12['chees_it_per_s']:.2f} it/s "
          f"({mcmc12['chees_grads_per_s']:.0f} gradients/s), ess {mcmc12['ess_it_per_s']:.1f} it/s "
          f"({mcmc12['ess_ess_per_s']:.1f} ESS/s), neutra_chees "
          f"{mcmc12['neutra_chees_it_per_s']:.2f} it/s ({mcmc12['neutra_chees_ess_per_s']:.1f} "
          f"ESS/s), {jump12} ({smi.stdout.strip().splitlines()[0]})")
    dense13 = ", ".join(f"{k} {v[2]:.1f} it/s ({v[0]:.1f} / {v[1]:.1f} ESS/s mean / worst)"
                        for k, v in last13["dense"].items())
    pt13 = ", ".join(f"{k} {v[0]:.1f} it/s ({v[3]:.1f} ESS/s, balance error {v[1]:.4f})"
                     for k, v in last13["pt"].items())
    print(f"phase 13: {dense13}; worst-direction ESS ratio dense / diagonal hmc "
          f"{last13['dense_ratios']['hmc']:.2f}, mala {last13['dense_ratios']['mala']:.2f}; "
          f"{pt13}; aies@{AIES_C} {last13['aies_it_per_s']:.1f} it/s "
          f"({last13['aies_ess_per_s']:.1f} ESS/s), jump_aies {last13['jump_aies'][0]:.2f} outer "
          f"it/s ({last13['jump_aies_ess_per_s']:.1f} ESS/s, jump acc "
          f"{last13['jump_aies'][1]:.4f}) ({smi.stdout.strip().splitlines()[0]})")
    slowest = max(zoo14["ms"].items(), key=lambda kv: kv[1])
    print(f"phase 14: {zoo14['wall']:.1f} s; 14a slowest call {slowest[0][0]} {slowest[0][1]} "
          f"{slowest[1]:.1f} ms; IAF IMH {zoo14['iaf'][0]:.1f} it/s ({zoo14['iaf'][1]:.1f} "
          f"ESS/s, {zoo14['iaf'][2]:.3f} ms an Adam step) ({smi.stdout.strip().splitlines()[0]})")
    slowest = max(last15["ms"].items(), key=lambda kv: kv[1])
    print(f"phase 15: {last15['wall']:.1f} s; 15a slowest call {slowest[0][0][0]} "
          f"{slowest[0][0][1]} {slowest[0][1]} {slowest[1]:.1f} ms; phi^4 jump_hmc with Glow "
          f"{last15['phi4'][1]:.2f} outer it/s ({last15['phi4'][0]:.1f} s wall, fit "
          f"{last15['phi4'][2]:.1f} s over {last15['phi4'][3]} Adam steps); RNODE IMH "
          f"{last15['rnode'][1]:.1f} it/s ({last15['rnode'][0]:.1f} s wall, "
          f"{last15['rnode'][2]:.3f} ms a reverse-KL step); 15d {last15['15d']:.1f} s; "
          f"phase 16: {ckpt16['wall']:.1f} s ({smi.stdout.strip().splitlines()[0]})")
    print(f"phase 17: {tr17['wall']:.1f} s; " + ", ".join(
        f"{m} log Z {tr17['suite'][m][0]:.4f} in {tr17['walls'][m]:.2f} s" for m in TR_METHODS)
        + f"; snf {tr17['walls']['snf']:.2f} s, ns {tr17['walls']['ns']:.2f} s "
          f"({smi.stdout.strip().splitlines()[0]})")
    print(f"phase 19: {par19['wall']:.1f} s; 19a without / with the one-rank mesh " + ", ".join(
        f"{k} {v[0]:.2f} / {v[1]:.2f} s" for k, v in par19["walls"].items()
        if not k.startswith("19b")) + "; 19b unsharded / slowest rank (its collectives) "
        + ", ".join(f"{k[4:]} {v[0]:.2f} / {v[1]:.2f} s ({v[2]:.2f} s)"
                    for k, v in par19["walls"].items() if k.startswith("19b"))
        + f" ({smi.stdout.strip().splitlines()[0]})")
    print("phase 20, wall without / with graphs: " + ", ".join(
        f"{k} {v['wall'][0]:.3f} / {v['wall'][1]:.3f} s" for k, v in graph20["paths"].items())
        + f" ({smi.stdout.strip().splitlines()[0]})")
    print("phase 21, ms per Adam step without / with graphs: " + ", ".join(
        f"{k} {1e3 * v['wall'][0] / v['steps']:.3f} / {1e3 * v['wall'][1] / v['steps']:.3f}"
        for k, v in fit21["fits"].items()) + f" ({smi.stdout.strip().splitlines()[0]})")
    print("phase 22, wall without / with graphs: " + ", ".join(
        f"{k} {v['wall'][0]:.3f} / {v['wall'][1]:.3f} s ({v['n']} {v['unit']})"
        for k, v in tr22["paths"].items()) + f" ({smi.stdout.strip().splitlines()[0]})")
    print("walls by phase: " + ", ".join(f"{what} {s_:.1f} s" for what, s_ in laps))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
