"""Drive the PyTorch/CUDA port (nfmc_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
  1. facts: torch/CUDA versions, the card and its power limit, nvcc, triton;
  2. build the kernels from nfmc_torch/csrc/ with nvcc (the RealNVP coupling
     forward and backward, the spline coupling forward and backward), one
     process per source, all at once;
  3. forward kernel vs its plain PyTorch version, both directions, at the
     sampler's shapes (d=100, H=128, L=4 at B=100 and B=218,400), the flow
     fit's (B=256 training batches, B=3000 validation, and B=512) and a
     ragged odd shape (d=7, B=37): max |diff| <= 1e-4, with timings (CUDA
     events around the wrapper, and the kernel's own device time from
     torch.profiler);
  3b. backward kernel vs its plain version, both directions, at B=512, 256
     and 100, the ragged shape and B=1001 (many blocks, a partial last one):
     max |diff| <= 1e-4 * max(1, max |ref|); two launches bit-identical; at
     B=256 the device time of its two kernels (rows, weight gradients);
  3c. RealNVP at d=3000 and 3500, H=128 (the kernels' ring of 2 stages):
     forward, inverse and VJP against the plain version;
  4. the same three outer iterations with the same injected draws through
     the sampler's chunk runner on the card and on the CPU: they agree;
  4b. the same Flow.fit on the card and on the CPU: per-epoch validation
     losses and final weights agree to 1e-4;
  5. the main path through the front door: jump_mala, RealNVP (4 layers,
     hidden 128), 100 chains on a 100-d standard Gaussian, 2184 outer
     iterations of 5 MALA steps, with the kernel launch counts it made;
  5b. the same with warmup=True and 500 outer iterations: MALA tuning, the
     flow's MLE fit (every Adam step through the backward kernel), the
     reshuffle of warmup draws into x0; jump acceptance in [0.010, 0.035],
     MALA acceptance in [0.55, 0.72], the counter and launch laws; ms per
     Adam step (the fit's wall over its steps);
  5c. fit_nf=True at 20 outer iterations, on the fixed-effort route and on
     the host route: the interleaving law, the counters, a trained flow;
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
  8b. a frozen identity-init spline flow against N(0.12 * 1, I): jump
     acceptance in [0.30, 0.50], one forward launch per jump;
  8c. self-target: a frozen perturbed spline flow is the proposal and the
     target (U = -log q): jump acceptance >= 0.99, MALA acceptance in
     SELF_MALA_ACC, backward launches = the sampler's gradient passes;
  9. the repaired faults: a strided input (a column slice) gives the
     contiguous rows' log_prob; a flow with 3 hidden layers a conditioner
     runs with no kernel launch, one with 2 launches; MCMCStatistics folds
     CUDA draws through its data_transform.
Each path's launch counts are set to 0 just before it and read just after.
Prints the kernels' JSON line (each kernel's "ms" is the median of CUDA events
around its wrapper's call at the main path's shape, host included, as in every
earlier run; "device_ms" its kernels' device time a launch from torch.profiler,
over the launches the profiler recorded, null where it recorded none), then
as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Needs no JAX, no network, and exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

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
# Self-target (phase 8c): weights perturbed SELF_PERTURB from the identity,
# and the MALA acceptance band around the JAX package's on the same numpy
# weights (scripts/warmup_reference_cpu.py --self-target).
SELF_PERTURB, SELF_SEED = 0.01, 11
SELF_MALA_ACC = (0.03, 0.30)


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
    again, up to three windows. Empty if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    def name(key):  # "void (anonymous namespace)::kernel<8>(float const*, ...)" -> "kernel"
        m = re.search(r"(\w+)(?:<[^<>]*>)?\(", key)
        return m.group(1) if m else key

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        seen = {name(a.key): a.self_device_time_total / a.count
                for a in prof.key_averages() if a.self_device_time_total > 0 and a.count > 0}
        if seen:
            return seen
    return {}


def kernel_ms(fn, reps: int) -> tuple:
    """(the wrapper's ms a call: the median of CUDA events around the call,
    the host's Python included; the device ms a call of the kernels ``fn``
    launches, from torch.profiler, None where the profiler saw no device
    time; text giving both)."""
    wrapper = median_ms(fn, reps)
    dev = device_us(fn, reps)
    if not dev:
        return wrapper, None, f"{wrapper:.4f} ms (device time not measured)"
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
    1). ``scripts/warmup_reference_cpu.py --self-target`` loads the same
    arrays into both packages."""
    from nfmc_torch.flows.spline import n_params_per_dim

    rng = np.random.default_rng(seed)
    n_par = n_params_per_dim(kind, n_bins)
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


def flat_params(flow):
    return torch.cat([t.detach().reshape(-1).cpu() for p in flow.params
                      for v in p.values() for t in v])


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
    synchronise) of the inner sampler's warmup and of ``Flow.fit``, the
    epochs and optimizer steps of flow training, and the inner sampler."""

    def __enter__(self):
        from nfmc_torch.flows import base as flow_base
        from nfmc_torch.flows import train as train_mod
        from nfmc_torch.samplers.mcmc.base import MCMCSampler

        self.inner_s = self.fit_s = 0.0
        self.epochs = self.steps = 0
        self.inner = None
        self._orig = [(MCMCSampler, "warmup", MCMCSampler.warmup),
                      (flow_base.Flow, "fit", flow_base.Flow.fit),
                      (train_mod, "_train_epoch", train_mod._train_epoch),
                      (train_mod, "_train_step", train_mod._train_step)]
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

        def counted(fn, attr):
            def wrapper(*a, **k):
                setattr(rec, attr, getattr(rec, attr) + 1)
                return fn(*a, **k)
            return wrapper

        MCMCSampler.warmup = timed(MCMCSampler.warmup, "inner_s")
        flow_base.Flow.fit = timed(flow_base.Flow.fit, "fit_s")
        train_mod._train_epoch = counted(train_mod._train_epoch, "epochs")
        train_mod._train_step = counted(train_mod._train_step, "steps")
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._orig:
            setattr(owner, name, fn)


def device_busy_us(prof) -> float:
    """The time, in us, in which the device ran at least one of the kernels,
    copies or sets of a torch.profiler trace: the union of their intervals."""
    from torch.autograd import DeviceType

    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CUDA):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy


def profile_window(headline_iters: int) -> None:
    """Device busy share of the headline configuration over a short run
    (torch.profiler): the union of the device's kernel intervals over the
    host's wall time, and the operators that take the most device time."""
    import nfmc_torch
    from nfmc_torch.flows import Flow, RealNVP
    from nfmc_torch.potentials import StandardGaussian
    from torch.profiler import ProfilerActivity, profile

    def run():
        nfmc_torch.sample(StandardGaussian((D,)), strategy="jump_mala",
                          flow=Flow(RealNVP((D,), n_layers=L, hidden_size=H), seed=0),
                          n_chains=C, n_iterations=headline_iters,
                          inner_param_kwargs={"n_iterations": INNER_N},
                          param_kwargs={"store_samples_on_device": True}, seed=1, show_progress=False)

    run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    device_s = device_busy_us(prof) / 1e6
    if device_s == 0:
        print(f"profile ({headline_iters} outer it): wall {wall:.3f} s, device time not measured")
        return
    summed_s = sum(a.self_device_time_total for a in avgs) / 1e6
    print(f"profile ({headline_iters} outer it): wall {wall:.3f} s, device busy {device_s:.3f} s "
          f"({100 * device_s / wall:.1f}%; the operators' and kernels' device times summed, "
          f"which counts a kernel twice: {summed_s:.3f} s), "
          f"{sum(a.count for a in avgs if a.key == 'cudaLaunchKernel')} kernel launches")
    for a in sorted(avgs, key=lambda a: -a.self_device_time_total)[:6]:
        print(f"  {a.key[:60]:60s} device {a.self_device_time_total / 1e3:9.2f} ms  calls {a.count}")


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
                if d == D and rows == 256 and not inverse:
                    k_ms, k_dev, k_txt = kernel_ms(vjp, 30)
                    p_ms = median_ms(plain, 10)
                    bound_ms, bound_by = bound(*stack_cost(
                        d, hid, nl, rows, backward=True, n_par=n_params_per_dim(kind, nb)))
                    out["bwd_timing"][kind] = (k_ms, k_dev, p_ms, bound_ms, bound_by)
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
                fits[device] = (flat_params(flow), np.concatenate(rec.seen))
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
            n_chains=C, n_iterations=500, inner_param_kwargs={"n_iterations": INNER_N},
            param_kwargs={"store_samples_on_device": True}, seed=0, show_progress=False)
        nl_ = {w.__name__: w.launches for w in build.WRAPPERS}
        jacc = mis.statistics.jump_acceptance_rate
        print(f"{SPLINE_FLOWS[kind]} misfit N({mu}*1, I): jump acc {jacc:.4f} (JAX package, CPU: "
              f"0.3929), MALA acc {mis.statistics.acceptance_rate:.4f}, launches {nl_}, wall "
              f"{time.perf_counter() - t0:.3f} s")
        check(0.30 <= jacc <= 0.50, f"spline misfit jump acceptance {jacc} outside [0.30, 0.50]")
        check(nl_[f"fused_{kind}_forward"] == 500, "spline misfit: one forward launch per jump")
        check(nl_[f"fused_{kind}_inverse"] == 1, "spline misfit: proposals not in one launch")

    # ---- 8c. self-target: the flow is the proposal and the target ---------------------
    from nfmc_torch.flows import from_jax_params

    self_outer = 100
    for kind, cls in classes.items():
        flow = Flow(cls((D,), n_layers=L, hidden_size=H, n_bins=N_BINS))
        flow.params = from_jax_params(self_target_params(kind), device=dev)
        frozen = flow.params  # the sampler leaves a flow it does not fit as it is
        grad_passes = [0]

        def u(x, flow=flow, frozen=frozen):
            grad_passes[0] += int(x.requires_grad and torch.is_grad_enabled())
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
              f"(JAX package, CPU: RQS 0.132, LRS 0.0955), gradient passes {grad_passes[0]}, "
              f"launches {nl_}, wall {time.perf_counter() - t0:.3f} s")
        check(bool(torch.isfinite(sout.samples).all()), "self-target: non-finite samples")
        check(sst.jump_acceptance_rate >= 0.99,
              f"self-target jump acceptance {sst.jump_acceptance_rate} < 0.99: the kernels' "
              "forward, inverse and log-det disagree")
        check(SELF_MALA_ACC[0] <= sst.acceptance_rate <= SELF_MALA_ACC[1],
              f"self-target MALA acceptance {sst.acceptance_rate} outside {SELF_MALA_ACC}")
        check(grad_passes[0] > 0 and nl_["fused_spline_vjp"] == grad_passes[0],
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

    got, again = vjp(), vjp()
    torch.cuda.synchronize()
    same = torch.equal(got[0], again[0]) and all(
        torch.equal(a, b) for a, b in zip(cops._leaves(got[1]), cops._leaves(again[1])))
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


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    import nfmc_torch
    from nfmc_torch.ops import build
    from nfmc_torch.ops import coupling as ops
    from nfmc_torch.potentials import DiagonalGaussian, StandardGaussian

    t_start = time.perf_counter()
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
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {build.build_seconds:.2f} s, "
          f"{len(build.SOURCES)} sources in parallel: {', '.join(build.SOURCES)})")
    for ln in build.build_log.splitlines():
        if "registers" in ln or "spill" in ln or ln.startswith("=="):
            print("  ptxas:", ln.strip())

    # ---- 3. kernel vs plain ------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    err = {False: 0.0, True: 0.0}
    timing = {}
    for d, hid, nl, rows in [(D, H, L, C), (D, H, L, OUTER * C), (D, H, L, 256), (D, H, L, 512),
                             (D, H, L, 3000), (7, 16, 3, 37)]:
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
            timing[(d, rows, inverse)] = (k_ms, k_dev, p_ms, bound_ms, bound_by)
            print(f"coupling {'inverse' if inverse else 'forward'} d={d} H={hid} L={nl} B={rows}: "
                  f"max|diff| {e:.3e} (max|y| {y_ref.abs().max().item():.2f}), kernel {k_txt}, "
                  f"plain {p_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
            check(e <= TOL, f"kernel disagrees with the plain version: {e} > {TOL}")

    # ---- 3b. backward kernel vs plain ------------------------------------------------
    bwd_err, bwd_timing = 0.0, {}
    for d, hid, nl, rows in [(D, H, L, 512), (D, H, L, 256), (D, H, L, C), (7, 16, 3, 37),
                             (D, H, L, 1001)]:
        params = perturbed_params(d, hid, nl, seed=d + rows + 1, device=dev)
        packed = ops.pack_weights(params)
        x, gy = (torch.randn((rows, d), generator=g, device=dev) for _ in range(2))
        gld = torch.randn((rows,), generator=g, device=dev)
        for inverse in (False, True):
            got = ops.fused_realnvp_vjp(params, x, gy, gld, 3.0, inverse, packed)
            again = ops.fused_realnvp_vjp(params, x, gy, gld, 3.0, inverse, packed)
            torch.cuda.synchronize()
            ref = ops.realnvp_stack_vjp_plain(params, x, gy, gld, 3.0, inverse)
            pairs = list(zip([got[0], *ops._leaves(got[1])], [ref[0], *ops._leaves(ref[1])]))
            e_abs = max((a - b).abs().max().item() for a, b in pairs)
            scale = max(1.0, max(b.abs().max().item() for _, b in pairs))
            same = torch.equal(got[0], again[0]) and all(
                torch.equal(a, b) for a, b in zip(ops._leaves(got[1]), ops._leaves(again[1])))
            check(all(bool(torch.isfinite(a).all()) for a, _ in pairs), "non-finite gradient")
            bwd_err = max(bwd_err, e_abs)
            line = (f"coupling vjp {'inverse' if inverse else 'forward'} d={d} H={hid} L={nl} "
                    f"B={rows}: max|diff| {e_abs:.3e} (scale max(1, max|ref|) = {scale:.2f}), "
                    f"bit-identical rerun {same}")
            if d == D and rows in (512, 256):
                k_ms, k_dev, k_txt = kernel_ms(lambda: ops.fused_realnvp_vjp(params, x, gy, gld, 3.0,
                                                                      inverse, packed), 30)
                p_ms = median_ms(lambda: ops.realnvp_stack_vjp_plain(params, x, gy, gld, 3.0,
                                                                     inverse), 30)
                bound_ms, bound_by = bound(*stack_cost(d, hid, nl, rows, backward=True))
                bwd_timing[(rows, inverse)] = (k_ms, k_dev, p_ms, bound_ms, bound_by)
                line += f", kernel {k_txt}, plain {p_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})"
                if rows == 256 and not inverse:
                    # where the backward's time goes: its two kernels on the device
                    split = device_us(lambda: ops.fused_realnvp_vjp(params, x, gy, gld, 3.0, inverse,
                                                                    packed))
                    line += ("; device per launch: " + ", ".join(
                        f"{k} {v:.2f} us" for k, v in split.items() if "coupling_vjp" in k))
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
        st, ys = s.run_chunk(s.init_chunk_state(x0), {k: v.to(device) for k, v in draws.items()})
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
            fits[device] = (flat_params(flow), np.concatenate(rec.seen))
    finally:
        train_mod.np = orig_np
    e_w = (fits["cpu"][0] - fits["cuda"][0]).abs().max().item()
    e_vl = float(np.max(np.abs(fits["cpu"][1] - fits["cuda"][1])))
    print(f"Flow.fit card vs CPU (d=6, 70 rows at batch 16, 5 epochs): weights max|diff| {e_w:.3e}, "
          f"per-epoch val loss max|diff| {e_vl:.3e} (val losses {np.round(fits['cuda'][1], 5).tolist()})")
    check(len(fits["cuda"][1]) == 5 and e_w <= TOL and e_vl <= TOL,
          "Flow.fit on the card disagrees with the CPU fit")

    # ---- 5. main path: the headline through the front door ----------------------
    def headline():
        return nfmc_torch.sample(
            StandardGaussian((D,)), strategy="jump_mala",
            flow=Flow(RealNVP((D,), n_layers=L, hidden_size=H), seed=0),
            n_chains=C, n_iterations=OUTER, inner_param_kwargs={"n_iterations": INNER_N},
            param_kwargs={"store_samples_on_device": True},
            seed=0, show_progress=False)

    headline()  # warm run: allocator, library, cuBLAS handles
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
    profile_window(headline_iters=64)

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

    nf_outer, n_before = 20, 2
    n_fits, rows = nf_outer - n_before, INNER_N * C
    n_train = int(rows * 0.7)
    bs = _adaptive_batch_size(n_train)
    for route, kw, batches in (("fixed-effort", {"n_epochs": 2}, n_train // bs),
                               ("host", {"n_epochs": 2, "early_stopping": True}, -(-n_train // bs))):
        flow = Flow(RealNVP((D,), n_layers=L, hidden_size=H), seed=0)
        before = flat_params(flow)
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
        change = (flat_params(flow) - before).abs().max().item()
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

    # ---- 6. misfit target -------------------------------------------------------
    mu = 0.12
    t0 = time.perf_counter()
    mis = nfmc_torch.sample(
        DiagonalGaussian(np.full(D, mu, np.float32), np.float32(1.0)), strategy="jump_mala",
        flow=Flow(RealNVP((D,), n_layers=L, hidden_size=H), seed=0),
        n_chains=C, n_iterations=500, inner_param_kwargs={"n_iterations": INNER_N},
        param_kwargs={"store_samples_on_device": True}, seed=0, show_progress=False)
    jacc = mis.statistics.jump_acceptance_rate
    print(f"misfit N({mu}*1, I): jump acc {jacc:.4f}, MALA acc {mis.statistics.acceptance_rate:.4f}, "
          f"max|mean - mu| {np.abs(mis.mean - mu).max():.4f}, wall {time.perf_counter() - t0:.3f} s")
    check(0.30 <= jacc <= 0.50, f"misfit jump acceptance {jacc} outside [0.30, 0.50]")

    spline = run_spline_phases(dev, g)
    run_wide_spline(dev, g)
    run_fault_checks(dev)

    kernels = []
    for inverse, rows in ((False, C), (True, OUTER * C)):
        k_ms, k_dev, p_ms, bound_ms, bound_by = timing[(D, rows, inverse)]
        wrapper = ops.fused_realnvp_inverse if inverse else ops.fused_realnvp_forward
        kernels.append({
            "name": wrapper.__name__, "route": "cuda", "source": "nfmc_torch/csrc/coupling.cu",
            "replaces": "nfmc_tpu/ops/coupling_pallas.py:60", "launches": launches[wrapper.__name__],
            "max_abs_err": err[inverse], "ms": k_ms, "device_ms": k_dev, "plain_ms": p_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
    # the warmup's training batches: 4096 rows at the adaptive batch of 256
    k_ms, k_dev, p_ms, bound_ms, bound_by = bwd_timing[(256, False)]
    kernels.append({
        "name": "fused_realnvp_vjp", "route": "cuda", "source": "nfmc_torch/csrc/coupling_bwd.cu",
        "replaces": "nfmc_tpu/ops/coupling_pallas.py:217",
        "launches": warm_launches["fused_realnvp_vjp"], "max_abs_err": bwd_err, "ms": k_ms,
        "device_ms": k_dev, "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    })
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
        k_ms, k_dev, p_ms, bound_ms, bound_by = spline["bwd_timing"][kind]
        kernels.append({
            "name": f"fused_spline_vjp ({kind})", "route": "cuda",
            "source": "nfmc_torch/csrc/spline_bwd.cu", "replaces": REPLACES["bwd"],
            "launches": spline["launches"][kind]["fused_spline_vjp"],
            "max_abs_err": spline["bwd_err"][kind], "ms": k_ms, "device_ms": k_dev,
            "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
