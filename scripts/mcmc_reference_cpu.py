"""Reference numbers for NUTS, ChEES-HMC, elliptical slice sampling, their
jump variants and NeuTra-ChEES, on the CPU.

Correctness numbers, not speed: the JAX package runs, through its front
door, the configurations of ``chip_smoke.py`` phases 12-12d (the constants
are imported from it), once per seed, and prints what those phases gate,
then each quantity's range over the seeds and the band the phase gates on
(half the lowest to 1.5 times the highest, as for phase 10b):

  --nuts          phase 12: nuts, 1024 chains on a 100-d standard Gaussian,
                  max_tree_depth 10, 85 warmup and 100 sampling iterations:
                  acceptance (the share of chains that moved), the tuned
                  step size, leapfrogs a chain and iteration, the moments;
  --chees         phase 12a: chees_hmc, 1024 chains on DiagonalGaussian1(100),
                  341 warmup and 1000 sampling iterations: the tuned
                  trajectory length and step size, leapfrogs an iteration,
                  acceptance, max |mean| / sigma;
  --ess           phase 12b: ess with sigma linspace(0.4, 0.9, 5) and the
                  "residual" likelihood, 100 chains, 100 warmup iterations
                  (the ellipse adaptation) and 600: max |mean| / sigma and
                  max |var / sigma^2 - 1|;
  --jump          phase 12c: jump_ess, jump_nuts and jump_chees, 100 chains,
                  the identity-init RealNVP frozen, 5 inner iterations, 64
                  outer, target N(0.12 * 1, I): jump and inner acceptance;
  --neutra-chees  phase 12d: neutra_chees, 100 chains, the identity-init
                  RealNVP frozen, 100 warmup and 1000 iterations: acceptance,
                  the tuned step size and trajectory length, the moments;
  --dense         phase 13: hmc, dense_hmc, mala and dense_mala at
                  bench.py:1310-1437's sizes (d = 100, 100 chains, 341
                  warmup and 500 iterations) on the correlated and the
                  isotropic targets: the mean and the worst
                  eigen-direction ESS, max |mean| / sigma over the
                  eigen-directions, the scalar-mode flag, and the
                  worst-direction ESS ratios dense / diagonal;
  --pt            phase 13a: pt_mala, pt_mh, pt_hmc and mala at
                  bench.py:1231-1307's sizes (modes at -2 and 2 in 10-d, 64
                  chains started in mode 0, 1000 iterations, 8 rungs down
                  to beta 0.02): the mode balance error, the switch rate,
                  the cold acceptance and the swap acceptance;
  --aies          phase 13b: aies, 1024 walkers on 13's correlated target,
                  341 warmup and 1000 iterations: the tuned stretch scale,
                  acceptance, max |mean| / sigma over the eigen-directions
                  and max |var / sigma^2 - 1| over the coordinates;
  --jump-aies     phase 13c: jump_aies in 12c's setting: jump and inner
                  acceptance;
  --ess-draws     bench.py:1686-1691's matched ESS run of the JAX package
                  (tools/run_reference.py's run_ours_matched, 32 chains x 600
                  iterations, seed 2), written to chip_smoke.ESS_DRAWS for
                  phase 12f's two-sample test.

With --port the port (``device="cpu"``) runs the same beside it.

    JAX_PLATFORMS=cpu python scripts/mcmc_reference_cpu.py --seeds 0 1 2 3 4 5 6 7 \\
        [--nuts] [--chees] [--ess] [--jump] [--neutra-chees] [--dense] [--pt] [--aies] \\
        [--jump-aies] [--ess-draws] [--port]
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # the repo root

import chip_smoke as cs  # noqa: E402
from flow_samplers_reference_cpu import identity_flow, packages, report  # noqa: E402


def residual(pkg_name, sig):
    """The likelihood that turns ESS's N(0, I) prior into N(0, diag(sig^2))."""
    if pkg_name == "jax":
        import jax.numpy as jnp

        s = jnp.asarray(sig)
        return lambda x: 0.5 * jnp.sum((x / s) ** 2 - x ** 2, -1)
    s = torch.as_tensor(sig)
    return lambda x: 0.5 * ((x / s.to(x.device)) ** 2 - x ** 2).sum(-1)


def shifted(pkg_name, mu):
    """The likelihood that turns N(0, I) into N(mu, I): 0.5 |x - mu|^2 -
    0.5 |x|^2."""
    if pkg_name == "jax":
        import jax.numpy as jnp

        return lambda x: jnp.sum(0.5 * mu * mu - mu * x, -1)
    m = torch.as_tensor(mu)
    return lambda x: (0.5 * m * m - m * x).sum(-1)


def nuts(seed, pkgs, rows):
    for name, pkg, pots, _, extra in pkgs:
        t0 = time.time()
        out = pkg.sample(pots.StandardGaussian((cs.D,)), strategy="nuts", flow=None,
                         n_chains=cs.NUTS_C, n_warmup_iterations=cs.NUTS_WARM,
                         n_iterations=cs.NUTS_ITERS, warmup=True,
                         kernel_kwargs={"max_tree_depth": cs.NUTS_DEPTH}, seed=seed,
                         show_progress=False, **extra)
        st = out.statistics
        lf = st.n_target_gradient_calls / (cs.NUTS_ITERS * cs.NUTS_C) - 1
        m1 = float(np.abs(out.mean).max())
        m2 = float(np.abs(np.asarray(out.second_moment) - 1).max())
        rows.setdefault(name, []).append((st.acceptance_rate, out.kernel.step_size, lf, m1, m2))
        print(f"{name} nuts seed {seed}: acc {st.acceptance_rate:.6f}, step {out.kernel.step_size:.6f}, "
              f"leapfrogs a chain-iteration {lf:.4f}, max|mean| {m1:.4f}, max|E[x^2] - 1| {m2:.4f} "
              f"({time.time() - t0:.0f} s)")


def chees(seed, pkgs, rows):
    sigma = np.tile(np.arange(1, 11), cs.D // 10)[:cs.D].astype(np.float64)
    for name, pkg, pots, _, extra in pkgs:
        t0 = time.time()
        out = pkg.sample(pots.DiagonalGaussian1(n_dim=cs.D), strategy="chees_hmc", flow=None,
                         n_chains=cs.CHEES_C, n_warmup_iterations=cs.CHEES_WARM,
                         n_iterations=cs.CHEES_ITERS, warmup=True,
                         param_kwargs={"store_samples": False}, seed=seed, show_progress=False,
                         **extra)
        st, k = out.statistics, out.kernel
        lf = st.n_target_gradient_calls / (2 * cs.CHEES_ITERS * cs.CHEES_C)
        err = float(np.max(np.abs(np.asarray(out.mean)) / sigma))
        rows.setdefault(name, []).append((st.acceptance_rate, k.trajectory_length, k.step_size,
                                          lf, err))
        print(f"{name} chees_hmc seed {seed}: acc {st.acceptance_rate:.6f}, trajectory "
              f"{k.trajectory_length:.4f}, step {k.step_size:.6f}, leapfrogs an iteration "
              f"{lf:.4f}, max|mean|/sigma {err:.4f} ({time.time() - t0:.0f} s)")


def ess(seed, pkgs, rows):
    sig = cs.ESS_SIG.astype(np.float64)
    for name, pkg, pots, _, extra in pkgs:
        t0 = time.time()
        d = len(cs.ESS_SIG)
        out = pkg.sample(pots.DiagonalGaussian(np.zeros(d, np.float32), cs.ESS_SIG),
                         strategy="ess", flow=None,
                         negative_log_likelihood=residual(name, cs.ESS_SIG), n_chains=cs.ESS_C,
                         n_warmup_iterations=cs.ESS_WARM, n_iterations=cs.ESS_ITERS, warmup=True,
                         seed=seed, show_progress=False, **extra)
        m1 = float(np.max(np.abs(np.asarray(out.mean)) / sig))
        m2 = float(np.max(np.abs(np.asarray(out.variance) / sig ** 2 - 1)))
        rows.setdefault(name, []).append((out.statistics.acceptance_rate, m1, m2))
        print(f"{name} ess seed {seed}: acc {out.statistics.acceptance_rate:.6f}, max|mean|/sigma "
              f"{m1:.4f}, max|var/sigma^2 - 1| {m2:.4f} ({time.time() - t0:.0f} s)")


def jump(seed, pkgs, rows):
    mu = np.full(cs.D, cs.JUMP12_MU, np.float32)
    for kind in ("ess", "nuts", "chees"):
        for name, pkg, pots, flows, extra in pkgs:
            t0 = time.time()
            kw = dict(extra)
            if kind == "ess":
                kw["negative_log_likelihood"] = shifted(name, mu)
            if kind == "nuts":
                kw["inner_kernel_kwargs"] = {"step_size": cs.JUMP12_NUTS_STEP}
            out = pkg.sample(pots.DiagonalGaussian(mu, np.float32(1.0)), strategy=f"jump_{kind}",
                             flow=identity_flow(flows), n_chains=cs.C,
                             n_iterations=cs.JUMP12_OUTER,
                             inner_param_kwargs={"n_iterations": cs.JUMP12_INNER}, seed=seed,
                             show_progress=False, **kw)
            st = out.statistics
            m1 = float(np.abs(np.asarray(out.mean) - mu).max())
            rows.setdefault(f"{name} jump_{kind}", []).append(
                (st.jump_acceptance_rate, st.acceptance_rate, m1))
            print(f"{name} jump_{kind} seed {seed}: jump acc {st.jump_acceptance_rate:.6f}, inner "
                  f"acc {st.acceptance_rate:.6f}, max|mean - mu| {m1:.4f} "
                  f"({time.time() - t0:.0f} s)")


def neutra_chees(seed, pkgs, rows):
    for name, pkg, pots, flows, extra in pkgs:
        t0 = time.time()
        out = pkg.sample(pots.StandardGaussian((cs.D,)), strategy="neutra_chees",
                         flow=identity_flow(flows), n_chains=cs.C,
                         n_warmup_iterations=cs.NEUTRA_CHEES_WARM,
                         n_iterations=cs.NEUTRA_CHEES_ITERS, warmup=True,
                         param_kwargs={"warmup_fit_kwargs": {"n_epochs": 0}}, seed=seed,
                         show_progress=False, **extra)
        st, k = out.statistics, out.kernel
        m1 = float(np.abs(out.mean).max())
        m2 = float(np.abs(np.asarray(out.second_moment) - 1).max())
        rows.setdefault(name, []).append((st.acceptance_rate, k.step_size, k.trajectory_length,
                                          m1, m2))
        print(f"{name} neutra_chees seed {seed}: acc {st.acceptance_rate:.6f}, step "
              f"{k.step_size:.6f}, trajectory {k.trajectory_length:.4f}, max|mean| {m1:.4f}, "
              f"max|E[x^2] - 1| {m2:.4f} ({time.time() - t0:.0f} s)")


def jax_ess(draws: np.ndarray) -> np.ndarray:
    """The JAX package's ESS of draws (n, C, d), for either package's draws."""
    import jax.numpy as jnp

    from nfmc_tpu.diagnostics import effective_sample_size

    return np.asarray(effective_sample_size(jnp.asarray(draws), max_window=cs.DENSE_WINDOW,
                                            dim_slab=25))


def dense_targets(pots):
    q, eigs, chol = cs.dense_metric_targets()
    return {"corr": (pots.FullRankGaussian(mu=np.zeros(cs.D), chol=chol), q, np.sqrt(eigs)),
            "iso": (pots.StandardGaussian((cs.D,)), None, np.ones(cs.D))}


def dense(seed, pkgs, rows):
    """bench.py's measure(): a warmup from x0, then a run from the same x0."""
    for name, pkg, pots, _, extra in pkgs:
        targets = dense_targets(pots)
        min_ess = {}
        for kind, strategy in cs.DENSE_RUNS:
            t0 = time.time()
            target, q, scale = targets[kind]
            s = pkg.create_sampler(target, event_shape=(cs.D,), strategy=strategy,
                                   param_kwargs={"n_iterations": cs.DENSE_ITERS,
                                                 "n_warmup_iterations": cs.DENSE_WARM}, **extra)
            x0 = cs.dense_x0(kind, seed)
            s.warmup(x0, show_progress=False, seed=2 * seed + 1)
            out = s.sample(x0, show_progress=False, seed=2 * seed + 2)
            draws = np.asarray(out.samples, dtype=np.float64)
            if q is not None:
                draws = draws @ q  # into the true eigenbasis
            ess = jax_ess(draws.astype(np.float32))
            err = float(np.max(np.abs(draws.reshape(-1, cs.D).mean(0)) / scale))
            scalar = float(getattr(s.kernel, "_resume_scalar_mode", False))
            min_ess[(kind, strategy)] = float(ess.min())
            rows.setdefault(f"{name} {kind} {strategy}", []).append(
                (float(ess.mean()), float(ess.min()), err, scalar))
            print(f"{name} dense_metric {kind} {strategy} seed {seed}: ESS mean {ess.mean():.1f}, "
                  f"worst direction {ess.min():.1f}, max|mean|/sigma {err:.4f}, scalar mode "
                  f"{bool(scalar)}, acc {out.statistics.acceptance_rate:.4f}, step "
                  f"{s.kernel.step_size:.5f} ({time.time() - t0:.0f} s)")
        ratios = (min_ess[("corr", "dense_hmc")] / min_ess[("corr", "hmc")],
                  min_ess[("corr", "dense_mala")] / min_ess[("corr", "mala")])
        rows.setdefault(f"{name} corr worst-direction ESS ratio dense/diagonal", []).append(ratios)
        print(f"{name} dense_metric seed {seed}: worst-direction ESS ratio dense / diagonal on the "
              f"correlated target: hmc {ratios[0]:.3f}, mala {ratios[1]:.3f}")


def pt(seed, pkgs, rows):
    """bench.py's run_pt_multimodal at every seed, from numpy's mode-0 start."""
    means = np.stack([np.full(cs.PT_D, -cs.PT_MODE), np.full(cs.PT_D, cs.PT_MODE)])
    for name, pkg, pots, _, extra in pkgs:
        for strategy in cs.PT_RUNS:
            t0 = time.time()
            kw = dict(extra)
            if strategy.startswith("pt_"):
                kw["kernel_kwargs"] = {"n_temps": cs.PT_TEMPS, "beta_min": cs.PT_BETA_MIN}
            out = pkg.sample(pots.GaussianMixture(means.astype(np.float32), sigma=1.0),
                             strategy=strategy, n_chains=cs.PT_C, n_iterations=cs.PT_ITERS,
                             x0=cs.pt_x0(seed), warmup=False, seed=seed, show_progress=False, **kw)
            st = out.statistics
            bal, sw = cs.pt_mode_metrics(np.asarray(out.samples))
            swap = getattr(st, "swap_acceptance_rate", float("nan"))
            rates = getattr(out.kernel, "swap_acceptance_rates", None)
            rows.setdefault(f"{name} {strategy}", []).append(
                (st.acceptance_rate, bal, sw, swap))
            print(f"{name} pt_multimodal {strategy} seed {seed}: balance error {bal:.4f}, switch "
                  f"rate {sw:.5f}, cold acc {st.acceptance_rate:.6f}, swap acc {swap:.6f}, "
                  f"edge EMA rates {None if rates is None else np.round(rates, 3).tolist()} "
                  f"({time.time() - t0:.0f} s)")


def aies(seed, pkgs, rows):
    q, eigs, chol = cs.dense_metric_targets()
    sig = np.sqrt(np.diag(chol @ chol.T))
    for name, pkg, pots, _, extra in pkgs:
        t0 = time.time()
        s = pkg.create_sampler(pots.FullRankGaussian(mu=np.zeros(cs.D), chol=chol),
                               event_shape=(cs.D,), strategy="aies",
                               param_kwargs={"n_iterations": cs.AIES_ITERS,
                                             "n_warmup_iterations": cs.AIES_WARM,
                                             "store_samples": False}, **extra)
        x0 = cs.dense_x0("corr", seed, n=cs.AIES_C)
        s.warmup(x0, show_progress=False, seed=2 * seed + 1)
        out = s.sample(x0, show_progress=False, seed=2 * seed + 2)
        mean = np.asarray(out.mean, dtype=np.float64)
        err = float(np.max(np.abs(mean @ q) / np.sqrt(eigs)))
        var_err = float(np.max(np.abs(np.asarray(out.variance) / sig ** 2 - 1)))
        acc = out.statistics.acceptance_rate
        rows.setdefault(name, []).append((acc, s.kernel.a, err, var_err))
        print(f"{name} aies seed {seed}: acc {acc:.6f}, a {s.kernel.a:.5f}, max|mean|/sigma "
              f"(eigenbasis) {err:.4f}, max|var/sigma^2 - 1| {var_err:.4f} "
              f"({time.time() - t0:.0f} s)")


def jump_aies(seed, pkgs, rows):
    mu = np.full(cs.D, cs.JUMP12_MU, np.float32)
    for name, pkg, pots, flows, extra in pkgs:
        t0 = time.time()
        out = pkg.sample(pots.DiagonalGaussian(mu, np.float32(1.0)), strategy="jump_aies",
                         flow=identity_flow(flows), n_chains=cs.C, n_iterations=cs.JUMP12_OUTER,
                         inner_param_kwargs={"n_iterations": cs.JUMP12_INNER}, seed=seed,
                         show_progress=False, **extra)
        st = out.statistics
        m1 = float(np.abs(np.asarray(out.mean) - mu).max())
        rows.setdefault(name, []).append((st.jump_acceptance_rate, st.acceptance_rate, m1))
        print(f"{name} jump_aies seed {seed}: jump acc {st.jump_acceptance_rate:.6f}, inner acc "
              f"{st.acceptance_rate:.6f}, max|mean - mu| {m1:.4f} ({time.time() - t0:.0f} s)")


def ess_draws() -> None:
    sys.path.insert(0, str(ROOT / "tools"))
    from run_reference import run_ours_matched

    out = run_ours_matched("ess", cs.ESS_SIG, n_chains=cs.ESS_AB_C, n_iterations=cs.ESS_AB_ITERS,
                           seed=cs.ESS_AB_SEED, nll_spec="residual")
    draws = np.asarray(out["draws"], np.float32)
    np.savez_compressed(ROOT / cs.ESS_DRAWS, draws=draws)
    print(f"wrote {cs.ESS_DRAWS}: draws {draws.shape}, acc {out['accept_rate']:.4f}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4, 5, 6, 7])
    for flag in ("--nuts", "--chees", "--ess", "--jump", "--neutra-chees", "--dense", "--pt",
                 "--aies", "--jump-aies", "--ess-draws"):
        ap.add_argument(flag, action="store_true")
    ap.add_argument("--port", action="store_true", help="run the port on the CPU beside it")
    args = ap.parse_args()
    torch.set_num_threads(4)
    if args.ess_draws:
        ess_draws()
    pkgs = packages(args.port)
    for flag, fn, keys in (
            (args.nuts, nuts, ("acc", "step", "leapfrogs", "max|mean|", "max|E[x^2]-1|")),
            (args.chees, chees, ("acc", "trajectory", "step", "leapfrogs", "max|mean|/sigma")),
            (args.ess, ess, ("acc", "max|mean|/sigma", "max|var/sigma^2-1|")),
            (args.jump, jump, ("jump acc", "inner acc", "max|mean-mu|")),
            (args.neutra_chees, neutra_chees,
             ("acc", "step", "trajectory", "max|mean|", "max|E[x^2]-1|")),
            (args.dense, dense, ("ESS mean", "worst-direction ESS", "max|mean|/sigma",
                                 "scalar mode")),
            (args.pt, pt, ("cold acc", "balance error", "switch rate", "swap acc")),
            (args.aies, aies, ("acc", "a", "max|mean|/sigma", "max|var/sigma^2-1|")),
            (args.jump_aies, jump_aies, ("jump acc", "inner acc", "max|mean-mu|"))):
        if flag:
            rows = {}
            for seed in args.seeds:
                fn(seed, pkgs, rows)
            print(f"{fn.__name__}:")
            report({k: v for k, v in rows.items() if "ratio" not in k}, keys)
            ratios = {k: v for k, v in rows.items() if "ratio" in k}
            if ratios:
                report(ratios, ("hmc", "mala"))


if __name__ == "__main__":
    main()
