"""Reference numbers for ``chip_smoke.py`` phase 17 (the transport layer and
FAB at bench.py's ``transport_logz`` sizes), on the CPU.

  --suite   bench.py's ``run_transport_logz`` easy suite in the JAX package,
            once per seed (bench.py:1757-1810 with every seed 0 replaced by
            the run's seed, FAB's estimate drawn with seed 7 + seed): each
            method's log Z and |error|, FAB's IS ESS fraction and whether
            its 8-block two-standard-error band covers the truth;
  --snf     ``snf()`` at its defaults on the same 16-d target: the grand
            mean of the particles (the target's is 2);
  --ns      ``ns()`` at d=3, 64 live points, 400 iterations (the JAX
            package's accuracy test): log Z (the truth -7.214);
  --ops     the port's eager operations (each a kernel launch on the card)
            of one AFT level and one FAB iteration at phase 17's sizes;
  --ais     AIS alone at phase 17's sizes, a run a seed: the spread of its
            heavy-tailed log Z error.

With --port the port (``device="cpu"``) runs the same beside it.

    JAX_PLATFORMS=cpu python scripts/transport_reference_cpu.py --seeds 0 1 2 3 4 5 6 7 \\
        [--suite] [--snf] [--ns] [--ops] [--ais] [--port]
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the repo root

import chip_smoke as cs  # noqa: E402


def _jax():
    import jax

    import nfmc_tpu.flow_training
    import nfmc_tpu.potentials
    import nfmc_tpu.transport
    import nfmc_tpu.transport.ais

    return jax, nfmc_tpu


def fab_estimate(log_w: np.ndarray, true_abs: float) -> dict:
    """bench.py's FAB figures from the importance weights ``log_w`` of
    ``cs.TR_FAB_DRAWS`` flow draws (float64 on the host)."""
    from scipy.special import logsumexp

    log_w = np.asarray(log_w, np.float64)
    n = log_w.shape[0]
    est = float(logsumexp(log_w) - np.log(n))
    blocks = log_w.reshape(cs.TR_FAB_BLOCKS, -1)
    block_est = logsumexp(blocks, axis=1) - np.log(blocks.shape[1])
    two_se = float(2.0 * block_est.std(ddof=1) / np.sqrt(cs.TR_FAB_BLOCKS))
    return {"log_z": est, "err": abs(est - true_abs),
            "is_ess_frac": float(np.exp(2 * logsumexp(log_w) - logsumexp(2 * log_w)) / n),
            "two_se": two_se, "covers": bool(abs(block_est.mean() - true_abs) <= two_se)}


def jax_suite(seed: int) -> dict:
    """One seed of the easy suite in the JAX package (bench.py:1757-1810)."""
    jax, nt = _jax()
    pots = nt.potentials
    d = cs.TR_D
    prior = pots.StandardGaussian((d,))
    target = pots.DiagonalGaussian(mu=np.full(d, 2.0), sigma=np.full(d, 0.5))
    lse = jax.scipy.special.logsumexp
    res = {}
    t0 = time.time()
    a = cs.TR_AIS
    x0 = np.asarray(prior.sample((a["n"],), key=jax.random.key(seed)))
    _, log_w = nt.transport.ais.ais_base(x0, prior, target, n_steps=a["n_steps"],
                                         n_mcmc_steps=a["n_mcmc_steps"],
                                         step_size=a["step_size"], seed=seed)
    res["ais"] = (float(lse(log_w) - np.log(a["n"])), time.time() - t0)
    t0 = time.time()
    r = nt.transport.aft(prior, target, cs.TR_FLOW, seed=seed, **cs.TR_AFT)
    res["aft"] = (r["log_Z"], time.time() - t0)
    t0 = time.time()
    r = nt.transport.craft(prior, target, cs.TR_FLOW, seed=seed, **cs.TR_CRAFT)
    res["craft"] = (r["log_Z"], time.time() - t0)
    t0 = time.time()
    r = nt.transport.pmc(prior, target, cs.TR_FLOW, seed=seed, **cs.TR_PMC)
    res["pmc"] = (r["log_Z"], time.time() - t0)
    t0 = time.time()
    trained = nt.flow_training.fab(target, cs.TR_FLOW, seed=seed, **cs.TR_FAB)
    xq, log_q = trained.sample(cs.TR_FAB_DRAWS, seed=7 + seed, return_log_prob=True)
    fab = fab_estimate(np.asarray(-target(xq) - log_q), cs.TR_TRUE_LOG_Z + d / 2 * np.log(2 * np.pi))
    res["fab"] = (fab["log_z"], time.time() - t0, fab)
    return res


def suite(seeds, port: bool) -> None:
    runs = [("jax", jax_suite)] + ([("torch cpu", lambda s: cs.transport_suite(s, "cpu"))]
                                  if port else [])
    for name, run in runs:
        rows = []
        for seed in seeds:
            res = run(seed)
            errs = {}
            for m in cs.TR_METHODS:
                truth = (cs.TR_TRUE_LOG_Z + cs.TR_D / 2 * np.log(2 * np.pi) if m == "fab"
                         else cs.TR_TRUE_LOG_Z)
                errs[m] = abs(res[m][0] - truth)
            fab = res["fab"][2]
            rows.append([errs[m] for m in cs.TR_METHODS] + [fab["is_ess_frac"], fab["covers"]])
            print(f"{name} transport_logz seed {seed}: " + ", ".join(
                f"{m} log Z {res[m][0]:.4f} |err| {errs[m]:.4f} ({res[m][1]:.0f} s)"
                for m in cs.TR_METHODS)
                + f"; FAB IS ESS frac {fab['is_ess_frac']:.4f}, 2 SE {fab['two_se']:.4f}, "
                  f"covers {fab['covers']}", flush=True)
        v = np.array(rows, dtype=np.float64)
        print(f"{name} transport_logz over {len(v)} seeds: " + "; ".join(
            f"{m} |err| [{v[:, i].min():.6f}, {v[:, i].max():.6f}]"
            for i, m in enumerate(cs.TR_METHODS))
            + f"; FAB IS ESS frac [{v[:, 5].min():.6f}, {v[:, 5].max():.6f}], band covers the "
              f"truth in {int(v[:, 6].sum())} of {len(v)}", flush=True)


def ais_spread(seeds, port: bool) -> None:
    """AIS alone at 17b's sizes, a seed a run: its |log Z error| is heavy-
    tailed (an IS ESS of ~2-50 of 4096 particles, one lucky particle can
    carry the estimate), so its spread needs more seeds than the suite's."""
    for name in ("jax", "torch cpu") if port else ("jax",):
        errs = []
        for seed in seeds:
            if name == "jax":
                jax, nt = _jax()
                pots = nt.potentials
                prior = pots.StandardGaussian((cs.TR_D,))
                target = pots.DiagonalGaussian(mu=np.full(cs.TR_D, 2.0),
                                               sigma=np.full(cs.TR_D, 0.5))
                x0 = np.asarray(prior.sample((cs.TR_AIS["n"],), key=jax.random.key(seed)))
                _, lw = nt.transport.ais.ais_base(
                    x0, prior, target, n_steps=cs.TR_AIS["n_steps"],
                    n_mcmc_steps=cs.TR_AIS["n_mcmc_steps"], step_size=cs.TR_AIS["step_size"],
                    seed=seed)
                lw = torch.from_numpy(np.asarray(lw))
            else:
                from nfmc_torch.transport.ais import ais_base

                prior, target = cs.transport_targets(cs.TR_D)
                g = torch.Generator().manual_seed(seed)  # one stream, as cs.transport_suite
                x0 = prior.sample((cs.TR_AIS["n"],), generator=g)
                _, lw = ais_base(x0, prior, target, n_steps=cs.TR_AIS["n_steps"],
                                 n_mcmc_steps=cs.TR_AIS["n_mcmc_steps"],
                                 step_size=cs.TR_AIS["step_size"], generator=g, device="cpu")
            errs.append(float(torch.logsumexp(lw.double(), 0) - np.log(cs.TR_AIS["n"]))
                        - cs.TR_TRUE_LOG_Z)
        e = np.array(errs)
        print(f"{name} AIS over {len(e)} seeds ({seeds[0]}-{seeds[-1]}): log Z error "
              f"[{e.min():.6f}, {e.max():.6f}], |error| [{np.abs(e).min():.6f}, "
              f"{np.abs(e).max():.6f}], mean {e.mean():.6f}, sd {e.std(ddof=1):.6f}, "
              f"|error| above 0.5 in {int((np.abs(e) > 0.5).sum())}, above 1 in "
              f"{int((np.abs(e) > 1).sum())}", flush=True)


def snf_ns(seeds, port: bool, which: str) -> None:
    pkgs = [("jax", None)] + ([("torch cpu", "cpu")] if port else [])
    for name, device in pkgs:
        vals = []
        for seed in seeds:
            t0 = time.time()
            if device is None:
                _, nt = _jax()
                pots, tr, extra = nt.potentials, nt.transport, {}
            else:
                import nfmc_torch

                pots, tr, extra = nfmc_torch.potentials, nfmc_torch.transport, {"device": device}
            if which == "snf":
                d = cs.TR_D
                out = tr.snf(pots.StandardGaussian((d,)),
                             pots.DiagonalGaussian(mu=np.full(d, 2.0), sigma=np.full(d, 0.5)),
                             seed=seed, **cs.TR_SNF, **extra)
                p = np.asarray(out["particles"])
                vals.append(float(p.mean()))
                print(f"{name} snf seed {seed}: particles finite {bool(np.isfinite(p).all())}, "
                      f"mean {vals[-1]:.6f} ({time.time() - t0:.0f} s)", flush=True)
            else:
                d = cs.TR_NS_D
                out = tr.ns(pots.StandardGaussian((d,)),
                            pots.DiagonalGaussian(mu=np.full(d, 2.0), sigma=np.full(d, 0.5)),
                            cs.TR_FLOW, seed=seed, **cs.TR_NS, **extra)
                vals.append(out["log_Z"])
                print(f"{name} ns seed {seed}: log Z {vals[-1]:.6f} (truth "
                      f"{cs.TR_NS_TRUE_LOG_Z:.4f}; {time.time() - t0:.0f} s)", flush=True)
        print(f"{name} {which} over {len(vals)} seeds: [{min(vals):.6f}, {max(vals):.6f}]",
              flush=True)


def ops() -> None:
    """The port's eager operations of one AFT level and one FAB iteration
    at phase 17's sizes on the card's path (CPU tensors, each RealNVP call
    one kernel launch; each operation a launch on the card)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    import nfmc_torch
    from nfmc_torch.flow_training import FAB
    from nfmc_torch.potentials import DiagonalGaussian, StandardGaussian
    from nfmc_torch.transport import AnnealedFlowTransport

    from nfmc_torch.ops import coupling as ops_mod

    class Count(TorchDispatchMode):
        n, paused = 0, False

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view and not Count.paused:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    # the card's path: each RealNVP call is one kernel launch (counted as
    # one operation), its plain version run uncounted in the launch's place
    def launch(wrapper, params, x, clamp, inverse, packed):
        return fake(lambda: ops_mod.realnvp_stack_plain(params, x, clamp, inverse))

    def launch_vjp(params, x, gy, gld, clamp, inverse, packed):
        return fake(lambda: ops_mod.realnvp_stack_vjp_plain(params, x, gy, gld, clamp, inverse))

    def fake(fn):
        Count.n += 1
        Count.paused = True
        try:
            return fn()
        finally:
            Count.paused = False

    ops_mod._on_device = lambda x: True
    ops_mod._launch, ops_mod._launch_vjp = launch, launch_vjp
    d = cs.TR_D
    prior, target = StandardGaussian((d,)), DiagonalGaussian(np.full(d, 2.0), np.full(d, 0.5))
    flow = nfmc_torch.create_flow_object(cs.TR_FLOW, (d,), seed=0)
    a = cs.TR_AFT
    alg = AnnealedFlowTransport(prior, target, flow, n_steps=2,
                                n_train_epochs=a["n_train_epochs"])
    Count.n = 0
    with Count():
        alg.run(lambda b, generator=None: prior.sample(b, generator=generator),
                n_particles=a["n_particles"], n_train_particles=a["n_train_particles"],
                n_val_particles=a["n_val_particles"], seed=0)
    print(f"AFT: one level (fit {a['n_train_epochs']} epochs, transport, resample, 3 sweeps) "
          f"and the initial draws: {Count.n} operations", flush=True)
    f = cs.TR_FAB
    fab = FAB(target, nfmc_torch.create_flow_object(cs.TR_FLOW, (d,), seed=0))
    for label in ("first", "second"):
        Count.n = 0
        with Count():
            fab.run(n_iterations=1, n_flow_training_steps=f["n_flow_training_steps"],
                    n_ais_particles=f["n_ais_particles"], seed=0)
        print(f"FAB: one iteration ({label} run; {fab.n_ais_steps} AIS levels x "
              f"{fab.n_mcmc_steps} MALA steps, {f['n_flow_training_steps']} replay steps): "
              f"{Count.n} operations", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--suite", action="store_true")
    ap.add_argument("--snf", action="store_true")
    ap.add_argument("--ns", action="store_true")
    ap.add_argument("--ops", action="store_true")
    ap.add_argument("--ais", action="store_true")
    ap.add_argument("--port", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(4)
    if args.ops:
        ops()
    if args.ais:
        ais_spread(args.seeds, args.port)
    if args.snf:
        snf_ns(args.seeds, args.port, "snf")
    if args.ns:
        snf_ns(args.seeds, args.port, "ns")
    if args.suite:
        suite(args.seeds, args.port)


if __name__ == "__main__":
    main()
