"""Reference numbers for ``chip_smoke.py`` phase 14 (the flows without a
kernel), on the CPU.

Correctness numbers, not speed: the JAX package runs, through its front
door, the configurations of phase 14b and 14c (the constants and the
weights are imported from ``chip_smoke.py``), once per seed, and prints what
those phases gate, then each quantity's range over the seeds:

  --self-target  phase 14b: for each of ``ZOO_NAMES``, IMH with the flow
                 (d = 100, default widths, the masked NAF flows at 1
                 layer: ``chip_smoke.zoo_flow``; ``zoo_weights``)
                 frozen as the proposal and as the target (U = -log q),
                 100 chains, ``zoo_self_iters(name)`` iterations: the
                 acceptance;
  --iaf          phase 14c: IMH with ``warmup=True`` (the reverse-KL fit)
                 through an IAF (2 layers, MADE 2 x 128) on
                 DiagonalGaussian1(100), ``ZOO_IAF_ITERS`` iterations: the
                 acceptance and the moments over the dims, and the
                 identity IAF's acceptance without warmup;
  --ops          the port's eager operations a call of each direction at
                 phase 14a's size (each a kernel launch on the card);
  --drift        the port's float32 results on the CPU against float64 at
                 phase 14a's weights and rows (its tolerances' basis).

With --port the port (``device="cpu"``) runs the same beside it.

    JAX_PLATFORMS=cpu python scripts/flow_zoo_reference_cpu.py --seeds 0 1 2 3 4 5 6 7 \\
        [--self-target] [--iaf] [--ops] [--drift] [--port] [--names nice maf ...]
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the repo root

import chip_smoke as cs  # noqa: E402

IMH_MOMENTS = ("median|var/sigma^2 - 1|", "min var/sigma^2", "max var/sigma^2",
               "median|mean|/sigma", "max|var/sigma^2 - 1|", "max|mean|/sigma")


def imh_moments(mean, variance, sigma2) -> tuple:
    ratio = np.asarray(variance, np.float64) / sigma2
    z = np.abs(np.asarray(mean, np.float64)) / np.sqrt(sigma2)
    return (float(np.median(np.abs(ratio - 1))), float(ratio.min()), float(ratio.max()),
            float(np.median(z)), float(np.max(np.abs(ratio - 1))), float(z.max()))


def packages(port: bool):
    """(name, package, potentials module, extra sample() kwargs, weights loader)."""
    import nfmc_tpu
    import nfmc_tpu.potentials

    out = [("jax", nfmc_tpu, nfmc_tpu.potentials, {}, lambda w: w)]
    if port:
        import nfmc_torch
        import nfmc_torch.potentials
        from nfmc_torch.flows import from_jax_params

        out.append(("torch cpu", nfmc_torch, nfmc_torch.potentials, {"device": "cpu"},
                    from_jax_params))
    return out


def self_target(seeds, names, port: bool) -> None:
    for name in names:
        spec = cs.zoo_flow(name)
        weights = cs.zoo_weights(spec)
        for pkg_name, pkg, pots, extra, load in packages(port):
            flow = pkg.create_flow_object(spec, (cs.D,), seed=0)
            flow.params = load(weights)
            params = flow.params
            target = pots.CallablePotential(lambda x: -flow.log_prob_fn(params, x), (cs.D,))
            accs = []
            t0 = time.time()
            n_it = cs.zoo_self_iters(name)
            for seed in seeds:
                out = pkg.sample(target, flow=flow, n_chains=cs.C, n_iterations=n_it, seed=seed,
                                 show_progress=False, **extra)
                accs.append(out.statistics.acceptance_rate)
            accs = np.array(accs)
            print(f"{pkg_name} {spec} self-target IMH ({n_it} it, seeds "
                  f"{seeds[0]}-{seeds[-1]}): acc [{accs.min():.6f}, {accs.max():.6f}], rejection "
                  f"rate max {1 - accs.min():.6f} ({time.time() - t0:.0f} s)", flush=True)


def ops(names) -> None:
    """The eager operations (views left out) of one call of each direction
    of the port's flow at phase 14a's size, counted on the CPU: each is a
    kernel launch on the card."""
    from torch.utils._python_dispatch import TorchDispatchMode

    import nfmc_torch
    from nfmc_torch.flows import from_jax_params

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    x = torch.from_numpy(np.random.default_rng(cs.ZOO_SEED).standard_normal(
        (cs.ZOO_B, cs.D)).astype(np.float32))
    for name in names:
        spec = cs.zoo_flow(name)
        flow = nfmc_torch.create_flow_object(spec, (cs.D,), seed=0)
        flow.params = from_jax_params(cs.zoo_weights(spec))
        counts = []
        with torch.no_grad():
            for fn in (flow.bijection.forward_fn, flow.bijection.inverse_fn):
                Count.n = 0
                with Count():
                    fn(flow.params, x)
                counts.append(Count.n)
        print(f"{spec} (d={cs.D}, B={cs.ZOO_B}): forward {counts[0]} operations a call, "
              f"inverse {counts[1]}", flush=True)


def drift(names) -> None:
    """The port's float32 results on the CPU against float64 at phase 14a's
    weights and rows, relative to max(1, max|float64|): the rounding a
    float32 run carries on any device."""
    import nfmc_torch
    from nfmc_torch.flows import from_jax_params
    from nfmc_torch.utils import tree_map

    for name in names:
        ref = cs.zoo_cpu_reference(name)
        spec = cs.zoo_flow(name)
        flow = nfmc_torch.create_flow_object(spec, (cs.D,), seed=0)
        p64 = tree_map(lambda t: t.double(), from_jax_params(cs.zoo_weights(spec)))
        line = []
        with torch.no_grad():
            for direction, v in zip(("forward", "inverse"), cs.zoo_inputs()):
                fn = flow.bijection.inverse_fn if direction == "inverse" else flow.bijection.forward_fn
                y64, ld64 = (t.numpy() for t in fn(p64, torch.from_numpy(v).double()))
                y32, ld32 = ref[direction]
                scale = max(1.0, float(np.abs(y64).max()), float(np.abs(ld64).max()))
                e = max(float(np.abs(y32 - y64).max()), float(np.abs(ld32 - ld64).max()))
                line.append(f"{direction} {e:.3e} ({e / scale:.3e} of scale {scale:.1f})")
            # the round trip in float32 through the cheap direction second, as 14a
            x, z = (torch.from_numpy(v) for v in cs.zoo_inputs())
            p32 = from_jax_params(cs.zoo_weights(spec))
            if name.startswith("ia-"):
                back = flow.bijection.inverse_fn(p32, torch.from_numpy(ref["forward"][0]))[0]
                rt = float((back - x).abs().max())
            else:
                back = flow.bijection.forward_fn(p32, torch.from_numpy(ref["inverse"][0]))[0]
                rt = float((back - z).abs().max())
            line.append(f"float32 round trip {rt:.3e}")
        print(f"{spec} float32 against float64 on the CPU: " + "; ".join(line), flush=True)


def iaf(seeds, port: bool) -> None:
    for pkg_name, pkg, pots, extra, _ in packages(port):
        target = pots.DiagonalGaussian1(cs.D)
        sigma2 = np.asarray(target.sigma, np.float64) ** 2
        rows = []
        for seed in seeds:
            t0 = time.time()
            out = pkg.sample(target, flow="iaf", n_chains=cs.C, n_iterations=cs.ZOO_IAF_ITERS,
                             warmup=True, seed=seed, show_progress=False, **extra)
            ident = pkg.sample(target, flow="iaf", n_chains=cs.C, n_iterations=cs.ZOO_IAF_ITERS,
                               seed=seed, show_progress=False, **extra)
            moments = imh_moments(out.mean, out.variance, sigma2)
            rows.append((out.statistics.acceptance_rate, *moments,
                         ident.statistics.acceptance_rate))
            print(f"{pkg_name} IAF IMH with warmup on DiagonalGaussian1({cs.D}) seed {seed}: acc "
                  f"{rows[-1][0]:.4f}, " + ", ".join(
                      f"{k} {v:.4f}" for k, v in zip(IMH_MOMENTS, moments))
                  + f"; identity IAF acc {rows[-1][-1]:.6f} ({time.time() - t0:.0f} s)",
                  flush=True)
        v = np.array(rows)
        print(f"{pkg_name} IAF IMH over {len(v)} seeds: acc [{v[:, 0].min():.4f}, "
              f"{v[:, 0].max():.4f}]; " + "; ".join(
                  f"{k} [{v[:, i].min():.4f}, {v[:, i].max():.4f}]"
                  for i, k in enumerate(IMH_MOMENTS, start=1))
              + f"; identity acc max {v[:, -1].max():.6f}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--self-target", action="store_true")
    ap.add_argument("--iaf", action="store_true")
    ap.add_argument("--port", action="store_true")
    ap.add_argument("--ops", action="store_true")
    ap.add_argument("--drift", action="store_true")
    ap.add_argument("--names", nargs="+", default=list(cs.ZOO_NAMES))
    args = ap.parse_args()
    torch.set_num_threads(4)
    if args.self_target:
        self_target(args.seeds, args.names, args.port)
    if args.iaf:
        iaf(args.seeds, args.port)
    if args.ops:
        ops(args.names)
    if args.drift:
        drift(args.names)


if __name__ == "__main__":
    main()
