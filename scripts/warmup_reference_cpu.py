"""Reference numbers for the warmup path of jump_mala, on the CPU.

Correctness numbers, not speed: for each seed it runs

  1. the inner MALA warmup alone (100 tuning steps, 100 chains, a 100-d
     standard Gaussian) and 100 sampling steps after it, in the JAX
     package and in the port (``device="cpu"``), printing the tuned step
     size and both acceptances, then the mean and spread of the tuned step
     over the seeds, so the spread that the dual averaging leaves can be
     read and the two packages compared;
  2. with --full, the headline with warmup through both front doors,
     ``nfmc_tpu.sample`` and ``nfmc_torch.sample(device="cpu")``: the flow
     of --flow (4 layers, hidden 128; the spline flows with 8 bins), 100
     chains, 500 outer iterations of 5 MALA steps, warmup=True, printing
     jump and MALA acceptance, the moment errors, and the fitted flow's NLL
     against the identity-init flow's on the fit's training and validation
     rows;
  3. with --self-target (spline flows only), the self-target check of
     ``chip_smoke.py`` phase 8c in both packages: a frozen spline flow whose
     weights come from ``chip_smoke.self_target_params`` (a numpy seed
     alone) is both the jump proposal and the target, U = -log q, 100
     chains, --self-outer outer iterations of 5 MALA steps, printing both
     acceptances;
  4. with --imh, IMH through both front doors (the default strategy) on
     ``DiagonalGaussian1(100)`` (sigma 1..10 tiled): a RealNVP (4 layers,
     hidden 128) fitted by the reverse-KL warmup with the default
     ``warmup_fit_kwargs``, 100 chains, IMH_ITERS iterations, printing the
     acceptance and the moment statistics of IMH_MOMENTS (the median and
     the extremes over the dims of the variance ratio and of |mean| / sigma);
     then the identity-init flow without warmup on the same target (``chip_smoke.py`` phase 10b), and the spread over
     the seeds.

    JAX_PLATFORMS=cpu python scripts/warmup_reference_cpu.py --seeds 0 1 2 [--full]
        [--flow realnvp|c-rqnsf|c-lrsnsf] [--self-target] [--no-inner] [--imh]
"""
import argparse
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the repo root

D, C, H, L, INNER_N, OUTER, N_BINS = 100, 100, 128, 4, 5, 500, 8
IMH_ITERS = 4000


def inner_spread(seed: int) -> dict:
    from nfmc_torch.potentials import StandardGaussian as TStandardGaussian
    from nfmc_torch.samplers.mcmc import MALA as TMALA
    from nfmc_tpu.potentials import StandardGaussian
    from nfmc_tpu.samplers.mcmc.langevin import MALA

    x0 = np.random.default_rng(seed).standard_normal((C, D)).astype(np.float32)
    steps = {}
    for name in ("jax", "torch cpu"):
        if name == "jax":
            s = MALA((D,), StandardGaussian((D,)))
            warm = s.warmup(jnp.asarray(x0), show_progress=False, seed=seed)
            last = jnp.asarray(np.asarray(warm.samples[-1]))
        else:
            s = TMALA((D,), TStandardGaussian((D,)), device="cpu")
            warm = s.warmup(torch.from_numpy(x0), show_progress=False, seed=seed)
            last = warm.samples[-1]
        out = s.sample(last, show_progress=False, seed=seed + 1000)
        steps[name] = s.kernel.step_size
        print(f"{name} inner warmup seed {seed}: step {s.kernel.step_size:.4f}, tuning acc "
              f"{warm.statistics.acceptance_rate:.4f}, sampling acc "
              f"{out.statistics.acceptance_rate:.4f}")
    return steps


def flows(flow: str):
    """(JAX bijection, port bijection) for --flow at the headline widths."""
    import nfmc_torch.flows as tflows
    import nfmc_tpu.flows as jflows

    name = {"realnvp": "RealNVP", "c-rqnsf": "CouplingRQNSF", "c-lrsnsf": "CouplingLRS"}[flow]
    kw = dict(n_layers=L, hidden_size=H) if flow == "realnvp" else dict(
        n_layers=L, hidden_size=H, n_bins=N_BINS)
    return (getattr(jflows, name)((D,), use_pallas=False, **kw), getattr(tflows, name)((D,), **kw))


def full(seed: int, flow: str) -> None:
    """Also prints the fitted flow's NLL against the identity-init flow's,
    on the fit's training and validation rows."""
    import nfmc_torch
    import nfmc_tpu
    from nfmc_torch.flows import Flow as TFlow
    from nfmc_torch.potentials import StandardGaussian as TStandardGaussian
    from nfmc_tpu.flows import Flow
    from nfmc_tpu.potentials import StandardGaussian

    common = dict(strategy="jump_mala", n_chains=C, n_iterations=OUTER,
                  inner_param_kwargs={"n_iterations": INNER_N}, warmup=True, seed=seed,
                  show_progress=False)
    (jbij, tbij), (jid, tid) = flows(flow), flows(flow)
    jflow, tflow = Flow(jbij, seed=0), TFlow(tbij, seed=0)
    runs = {
        "jax": (Flow, jflow, Flow(jid, seed=0), lambda a: jnp.asarray(a), lambda: nfmc_tpu.sample(
            StandardGaussian((D,)), flow=jflow, **common)),
        "torch cpu": (TFlow, tflow, TFlow(tid, seed=0), torch.from_numpy, lambda: nfmc_torch.sample(
            TStandardGaussian((D,)), flow=tflow, device="cpu", **common)),
    }
    for name, (cls, fitted, identity, to_array, run) in runs.items():
        rows, orig_fit = {}, cls.fit

        def recording_fit(self, x_train, *a, **k):
            rows["train"], rows["validation"] = np.asarray(x_train), np.asarray(k.get("x_val"))
            return orig_fit(self, x_train, *a, **k)

        cls.fit = recording_fit
        try:
            t0 = time.time()
            out = run()
        finally:
            cls.fit = orig_fit
        st = out.statistics
        nll = {k: [-float(np.mean(np.asarray(f.log_prob(to_array(v.astype(np.float32))))))
                   for f in (fitted, identity)] for k, v in rows.items()}
        print(f"{name} {flow} with warmup seed {seed}: jump acc {st.jump_acceptance_rate:.4f}, "
              f"MALA acc {st.acceptance_rate:.4f}, max|mean| {np.abs(out.mean).max():.4f}, "
              f"max|var - 1| {np.abs(out.variance - 1).max():.4f}; NLL fitted vs identity: "
              + ", ".join(f"{k} {a:.4f} vs {b:.4f}" for k, (a, b) in nll.items())
              + f" ({time.time() - t0:.0f} s)")


def self_target(seed: int, flow: str, n_outer: int) -> None:
    import nfmc_torch
    import nfmc_tpu
    from nfmc_torch.flows import Flow as TFlow
    from nfmc_torch.flows import from_jax_params
    from nfmc_torch.potentials import CallablePotential as TCallablePotential
    from nfmc_tpu.flows import Flow
    from nfmc_tpu.potentials import CallablePotential

    from chip_smoke import SELF_PERTURB, self_target_params

    params = self_target_params("rqs" if flow == "c-rqnsf" else "lrs")
    jbij, tbij = flows(flow)
    jflow, tflow = Flow(jbij, seed=0), TFlow(tbij)
    jflow.params = [{k: [jnp.asarray(a) for a in v] for k, v in p.items()} for p in params]
    tflow.params = from_jax_params(params)
    jparams, tparams = jflow.params, tflow.params
    common = dict(strategy="jump_mala", n_chains=C, n_iterations=n_outer,
                  inner_param_kwargs={"n_iterations": INNER_N}, seed=seed, show_progress=False)
    runs = {
        "jax": lambda: nfmc_tpu.sample(
            CallablePotential(lambda x: -jflow.log_prob_fn(jparams, x), (D,)), flow=jflow,
            **common),
        "torch cpu": lambda: nfmc_torch.sample(
            TCallablePotential(lambda x: -tflow.log_prob_fn(tparams, x), (D,)), flow=tflow,
            device="cpu", **common),
    }
    for name, run in runs.items():
        t0 = time.time()
        st = run().statistics
        print(f"{name} {flow} self-target (perturbation {SELF_PERTURB}, {n_outer} outer it) seed "
              f"{seed}: jump acc {st.jump_acceptance_rate:.4f}, MALA acc "
              f"{st.acceptance_rate:.4f} ({time.time() - t0:.0f} s)")


IMH_MOMENTS = ("median|var/sigma^2 - 1|", "min var/sigma^2", "max var/sigma^2",
               "median|mean|/sigma", "max|var/sigma^2 - 1|", "max|mean|/sigma")


def imh_moments(mean, variance, sigma2) -> tuple:
    """The moment statistics of IMH_MOMENTS over the dims of a run."""
    ratio = np.asarray(variance, np.float64) / sigma2
    z = np.abs(np.asarray(mean, np.float64)) / np.sqrt(sigma2)
    return (float(np.median(np.abs(ratio - 1))), float(ratio.min()), float(ratio.max()),
            float(np.median(z)), float(np.max(np.abs(ratio - 1))), float(z.max()))


def imh(seed: int) -> dict:
    """IMH with the reverse-KL warmup on DiagonalGaussian1(100) in both
    packages, and the identity flow without warmup; returns the
    acceptances and variance errors by package."""
    import nfmc_torch
    import nfmc_torch.flows
    import nfmc_tpu
    import nfmc_tpu.flows
    from nfmc_torch.potentials import DiagonalGaussian1 as TDiagonalGaussian1
    from nfmc_tpu.potentials import DiagonalGaussian1

    sigma2 = DiagonalGaussian1(D).sigma.astype(np.float64) ** 2
    res = {}
    for name, pkg, target, extra in (
            ("jax", nfmc_tpu, DiagonalGaussian1(D), {}),
            ("torch cpu", nfmc_torch, TDiagonalGaussian1(D), {"device": "cpu"})):
        def flow():
            return pkg.flows.Flow(flows("realnvp")[0 if name == "jax" else 1], seed=0)

        t0 = time.time()
        out = pkg.sample(target, flow=flow(), n_chains=C, n_iterations=IMH_ITERS, warmup=True,
                         seed=seed, show_progress=False, **extra)
        acc = out.statistics.acceptance_rate
        moments = imh_moments(out.mean, out.variance, sigma2)
        ident = pkg.sample(target, flow=flow(), n_chains=C, n_iterations=IMH_ITERS, seed=seed,
                           show_progress=False, **extra)
        res[name] = (acc, *moments, ident.statistics.acceptance_rate)
        print(f"{name} IMH with warmup on DiagonalGaussian1({D}) seed {seed}: acc {acc:.4f}, "
              + ", ".join(f"{k} {v:.4f}" for k, v in zip(IMH_MOMENTS, moments))
              + f"; identity flow without warmup: acc {ident.statistics.acceptance_rate:.6f} "
              f"({time.time() - t0:.0f} s)")
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--flow", choices=["realnvp", "c-rqnsf", "c-lrsnsf"], default="realnvp")
    ap.add_argument("--self-target", action="store_true")
    ap.add_argument("--self-outer", type=int, default=100)
    ap.add_argument("--no-inner", action="store_true", help="skip the inner warmups")
    ap.add_argument("--imh", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(4)
    if not args.no_inner:
        steps = [inner_spread(seed) for seed in args.seeds]
        for name in ("jax", "torch cpu"):
            v = np.array([s[name] for s in steps])
            print(f"{name} tuned step over {len(v)} seeds: mean {v.mean():.4f}, sd {v.std():.4f}")
    if args.full:
        for seed in args.seeds:
            full(seed, args.flow)
    if args.self_target:
        if args.flow == "realnvp":
            ap.error("--self-target takes a spline flow")
        for seed in args.seeds:
            self_target(seed, args.flow, args.self_outer)
    if args.imh:
        runs = [imh(seed) for seed in args.seeds]
        for name in ("jax", "torch cpu"):
            v = np.array([r[name] for r in runs])
            print(f"{name} IMH over {len(v)} seeds: acc [{v[:, 0].min():.4f}, "
                  f"{v[:, 0].max():.4f}] mean {v[:, 0].mean():.4f}; "
                  + "; ".join(f"{k} [{v[:, i].min():.4f}, {v[:, i].max():.4f}]"
                              for i, k in enumerate(IMH_MOMENTS, start=1))
                  + f"; identity acc max {v[:, -1].max():.6f}")

if __name__ == "__main__":
    main()
