"""Reference numbers for the flow-reparameterised samplers, on the CPU.

Correctness numbers, not speed: the JAX package runs, through its front
door, the configurations of ``chip_smoke.py`` phases 11-11e (the constants
are imported from it), once per seed, and prints what those phases gate,
then each quantity's range over the seeds and the band the phase gates on
(half the lowest to 1.5 times the highest, as for phase 10b):

  --neutra-hmc   phase 11: neutra_hmc, the identity-init RealNVP (4 layers,
                 hidden 128) frozen, 100 chains on a 100-d standard
                 Gaussian, HMC step 0.1, 20 leapfrog steps: acceptance and
                 the data-space moment errors;
  --neutra-mh    phase 11a: neutra_mh on Funnel(100) with warmup=True (the
                 capped reverse-KL fit), the random walk's scale 2.38 /
                 sqrt(d): acceptance and the data-space moments;
  --self-target  phase 11b: neutra_hmc (step NEUTRA_SELF_STEP) with a
                 frozen perturbed flow as its own target (U = -log q, weights from
                 ``chip_smoke.self_target_params``), RealNVP, c-rqnsf and
                 c-lrsnsf: acceptance and, over the dims of the latent
                 draws, the medians of |mean| and |var - 1|;
  --dlmc         phase 11e: dlmc, 1024 chains, fixed-effort refits of 10
                 epochs: acceptance and the moment error max |mean|.

With --port the port (``device="cpu"``) runs the same beside it.

    JAX_PLATFORMS=cpu python scripts/flow_samplers_reference_cpu.py --seeds 0 1 2 3 4 5 6 7 \\
        [--neutra-hmc] [--neutra-mh] [--self-target] [--dlmc] [--port]
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the repo root

import chip_smoke as cs  # noqa: E402

SELF_FLOWS = {"realnvp": "realnvp", "c-rqnsf": "rqs", "c-lrsnsf": "lrs"}


def packages(port: bool):
    """(name, package, potentials module, flows module, extra sample() kwargs)."""
    import nfmc_tpu
    import nfmc_tpu.flows
    import nfmc_tpu.potentials

    out = [("jax", nfmc_tpu, nfmc_tpu.potentials, nfmc_tpu.flows, {})]
    if port:
        import nfmc_torch
        import nfmc_torch.flows
        import nfmc_torch.potentials

        out.append(("torch cpu", nfmc_torch, nfmc_torch.potentials, nfmc_torch.flows,
                    {"device": "cpu"}))
    return out


def bijection(flows, name):
    cls = {"realnvp": "RealNVP", "c-rqnsf": "CouplingRQNSF", "c-lrsnsf": "CouplingLRS"}[name]
    kw = dict(n_layers=cs.L, hidden_size=cs.H)
    if name != "realnvp":
        kw["n_bins"] = cs.N_BINS
    if flows.__name__.startswith("nfmc_tpu"):
        kw["use_pallas"] = False
    return getattr(flows, cls)((cs.D,), **kw)


def identity_flow(flows):
    return flows.Flow(bijection(flows, "realnvp"), seed=0)


def report(rows: dict, keys) -> None:
    """Each key's range over the seeds and the band (half the low, 1.5
    times the high); for an acceptance, also the band of the rejection rate
    widened so, as an acceptance band (for rates near 1)."""
    for name, vals in rows.items():
        v = np.array(vals, dtype=np.float64)
        print(f"  {name} over {len(v)} seeds: " + "; ".join(
            f"{k} [{v[:, i].min():.6f}, {v[:, i].max():.6f}] -> band "
            f"[{0.5 * v[:, i].min():.6f}, {1.5 * v[:, i].max():.6f}]" for i, k in enumerate(keys)))
        rej = 1.0 - v[:, 0]
        print(f"  {name}: acceptance band from the rejection rate [{rej.min():.6f}, "
              f"{rej.max():.6f}]: [{1 - 1.5 * rej.max():.6f}, {1 - 0.5 * rej.min():.6f}]")


def neutra_hmc(seed, pkgs, rows):
    for name, pkg, pots, flows, extra in pkgs:
        t0 = time.time()
        out = pkg.sample(pots.StandardGaussian((cs.D,)), strategy="neutra_hmc",
                         flow=identity_flow(flows), n_chains=cs.C, n_iterations=cs.NEUTRA_ITERS,
                         inner_kernel_kwargs={"step_size": cs.NEUTRA_STEP}, seed=seed,
                         show_progress=False, **extra)
        acc = out.statistics.acceptance_rate
        m1 = float(np.abs(out.mean).max())
        m2 = float(np.abs(np.asarray(out.second_moment) - 1).max())
        rows.setdefault(name, []).append((acc, m1, m2))
        print(f"{name} neutra_hmc seed {seed}: acc {acc:.6f}, max|mean| {m1:.4f}, "
              f"max|E[x^2] - 1| {m2:.4f} ({time.time() - t0:.0f} s)")


def neutra_mh(seed, pkgs, rows):
    for name, pkg, pots, flows, extra in pkgs:
        t0 = time.time()
        out = pkg.sample(pots.Funnel(cs.D), strategy="neutra_mh", flow=identity_flow(flows),
                         n_chains=cs.C, n_iterations=cs.NEUTRA_MH_ITERS, warmup=True,
                         inner_kernel_kwargs={"inv_mass_diag": np.full(cs.D, cs.NEUTRA_MH_SCALE,
                                                                       np.float32)},
                         param_kwargs={"warmup_fit_kwargs": dict(cs.NEUTRA_MH_FIT_KWARGS)},
                         seed=seed, show_progress=False, **extra)
        acc = out.statistics.acceptance_rate
        mean, var = np.asarray(out.mean), np.asarray(out.variance)
        rows.setdefault(name, []).append((acc, float(var[0]), float(np.median(var[1:]))))
        print(f"{name} neutra_mh Funnel({cs.D}) seed {seed}: acc {acc:.6f}, finite "
              f"{bool(np.isfinite(mean).all() and np.isfinite(var).all())}, var x_0 {var[0]:.4f} "
              f"(exact 9), median var x_1.. {np.median(var[1:]):.4f}, "
              f"max|mean| {np.abs(mean).max():.4f} ({time.time() - t0:.0f} s)")


def self_target(seed, pkgs, rows):
    for flow_name, kind in SELF_FLOWS.items():
        params = cs.self_target_params(kind)
        for name, pkg, pots, flows, extra in pkgs:
            flow = flows.Flow(bijection(flows, flow_name), seed=0)
            if name == "jax":
                import jax.numpy as jnp

                flow.params = [{k: [jnp.asarray(a) for a in v] for k, v in p.items()}
                               for p in params]
            else:
                flow.params = flows.from_jax_params(params)
            frozen = flow.params
            t0 = time.time()
            out = pkg.sample(pots.CallablePotential(
                lambda x, flow=flow, frozen=frozen: -flow.log_prob_fn(frozen, x), (cs.D,)),
                strategy="neutra_hmc", flow=flow, n_chains=cs.C, n_iterations=cs.NEUTRA_SELF_ITERS,
                inner_kernel_kwargs={"step_size": cs.NEUTRA_SELF_STEP}, seed=seed,
                show_progress=False,
                **extra)
            z = np.asarray(out.samples, np.float64).reshape(-1, cs.D)
            acc = out.statistics.acceptance_rate
            med_mean = float(np.median(np.abs(z.mean(0))))
            med_var = float(np.median(np.abs(z.var(0) - 1)))
            rows.setdefault(f"{name} {flow_name}", []).append((acc, med_mean, med_var))
            print(f"{name} {flow_name} self-target neutra_hmc seed {seed}: acc {acc:.6f}, latent "
                  f"median|mean| {med_mean:.4f}, median|var - 1| {med_var:.4f} "
                  f"({time.time() - t0:.0f} s)")


def dlmc(seed, pkgs, rows):
    for name, pkg, pots, flows, extra in pkgs:
        t0 = time.time()
        target = pots.StandardGaussian((cs.D,))
        out = pkg.sample(target, strategy="dlmc", negative_log_likelihood=target,
                         flow=identity_flow(flows), n_chains=cs.DLMC_C,
                         n_iterations=cs.DLMC_ITERS,
                         param_kwargs={"flow_fit_kwargs": dict(cs.DLMC_FIT_KWARGS),
                                       "store_samples": False},
                         seed=seed, show_progress=False, **extra)
        acc = out.statistics.acceptance_rate
        err = float(np.abs(out.mean).max())
        m2 = float(np.abs(np.asarray(out.second_moment) - 1).max())
        rows.setdefault(name, []).append((acc, err, m2))
        print(f"{name} dlmc {cs.DLMC_C} chains, {cs.DLMC_ITERS} it, seed {seed}: acc {acc:.6f}, "
              f"moment err max|mean| {err:.4f}, max|E[x^2] - 1| {m2:.4f} "
              f"({time.time() - t0:.0f} s)")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4, 5, 6, 7])
    ap.add_argument("--neutra-hmc", action="store_true")
    ap.add_argument("--neutra-mh", action="store_true")
    ap.add_argument("--self-target", action="store_true")
    ap.add_argument("--dlmc", action="store_true")
    ap.add_argument("--port", action="store_true", help="run the port on the CPU beside it")
    args = ap.parse_args()
    torch.set_num_threads(4)
    pkgs = packages(args.port)
    for flag, fn, keys in (
            (args.neutra_hmc, neutra_hmc, ("acc", "max|mean|", "max|E[x^2]-1|")),
            (args.neutra_mh, neutra_mh, ("acc", "var x_0", "median var x_1..")),
            (args.self_target, self_target, ("acc", "median|mean|", "median|var-1|")),
            (args.dlmc, dlmc, ("acc", "max|mean|", "max|E[x^2]-1|"))):
        if flag:
            rows = {}
            for seed in args.seeds:
                fn(seed, pkgs, rows)
            print(f"{fn.__name__}:")
            report(rows, keys)


if __name__ == "__main__":
    main()
