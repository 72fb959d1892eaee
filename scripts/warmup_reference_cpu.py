"""Reference numbers for the warmup path of jump_mala, on the CPU.

Correctness numbers, not speed: for each seed it runs

  1. the inner MALA warmup alone (100 tuning steps, 100 chains, a 100-d
     standard Gaussian) and 100 sampling steps after it, in the JAX
     package and in the port (``device="cpu"``), printing the tuned step
     size and both acceptances, then the mean and spread of the tuned step
     over the seeds, so the spread that the dual averaging leaves can be
     read and the two packages compared;
  2. with --full, the headline with warmup through both front doors,
     ``nfmc_tpu.sample`` and ``nfmc_torch.sample(device="cpu")``: RealNVP
     (4 layers, hidden 128), 100 chains, 500 outer iterations of 5 MALA
     steps, warmup=True, printing jump and MALA acceptance and the moment
     errors.

    JAX_PLATFORMS=cpu python scripts/warmup_reference_cpu.py --seeds 0 1 2 [--full]
"""
import argparse
import time

import jax.numpy as jnp
import numpy as np
import torch

D, C, H, L, INNER_N, OUTER = 100, 100, 128, 4, 5, 500


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


def full(seed: int) -> None:
    import nfmc_torch
    import nfmc_tpu
    from nfmc_torch.flows import Flow as TFlow
    from nfmc_torch.flows import RealNVP as TRealNVP
    from nfmc_torch.potentials import StandardGaussian as TStandardGaussian
    from nfmc_tpu.flows import Flow, RealNVP
    from nfmc_tpu.potentials import StandardGaussian

    common = dict(strategy="jump_mala", n_chains=C, n_iterations=OUTER,
                  inner_param_kwargs={"n_iterations": INNER_N}, warmup=True, seed=seed,
                  show_progress=False)
    runs = {
        "jax": lambda: nfmc_tpu.sample(
            StandardGaussian((D,)),
            flow=Flow(RealNVP((D,), n_layers=L, hidden_size=H, use_pallas=False), seed=0), **common),
        "torch cpu": lambda: nfmc_torch.sample(
            TStandardGaussian((D,)), flow=TFlow(TRealNVP((D,), n_layers=L, hidden_size=H), seed=0),
            device="cpu", **common),
    }
    for name, run in runs.items():
        t0 = time.time()
        out = run()
        st = out.statistics
        print(f"{name} headline with warmup seed {seed}: jump acc {st.jump_acceptance_rate:.4f}, "
              f"MALA acc {st.acceptance_rate:.4f}, max|mean| {np.abs(out.mean).max():.4f}, "
              f"max|var - 1| {np.abs(out.variance - 1).max():.4f} ({time.time() - t0:.0f} s)")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(4)
    steps = [inner_spread(seed) for seed in args.seeds]
    for name in ("jax", "torch cpu"):
        v = np.array([s[name] for s in steps])
        print(f"{name} tuned step over {len(v)} seeds: mean {v.mean():.4f}, sd {v.std():.4f}")
    if args.full:
        for seed in args.seeds:
            full(seed)


if __name__ == "__main__":
    main()
