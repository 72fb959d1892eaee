"""Reference numbers for ``chip_smoke.py`` phase 15 (the continuous,
multiscale / Glow and convolutional flows), on the CPU.

  --drift   the port's float32 results against float64 at phase 15a's
            weights and rows (``chip_smoke.LAST_CASES``) with the same
            probes (``chip_smoke.FixedProbes``), relative to
            max(1, max|float64|): the basis of 15a's per-case limits;
  --ops     the port's eager operations a call of each direction at 15a's
            size (each a kernel launch on the card);
  --phi4    phase 15b in the JAX package, once per seed: jump_hmc with
            glow-realnvp on Phi4Lattice(L=8, kappa=0.25, lam=0.022), 32
            chains, 100 outer iterations, warmup=True (the fit
            ``PHI4_FIT_KWARGS``): the mean |m| of the
            stored draws and the jump acceptance;
  --rnode   phase 15c in the JAX package: IMH with warmup=True (the
            reverse-KL fit with the kinetic term) through RNODE on
            DiagonalGaussian1(100), ``RNODE_FIT_KWARGS``' epochs and
            ``RNODE_ITERS`` iterations: the
            acceptance, the moments over the dims, and the kinetic term at
            the fitted flow's draws.

With --port the port (``device="cpu"``) runs the same beside it.

    JAX_PLATFORMS=cpu python scripts/last_flows_reference_cpu.py --seeds 0 1 2 3 4 5 6 7 \\
        [--drift] [--ops] [--phi4] [--rnode] [--port]
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the repo root

import chip_smoke as cs  # noqa: E402
from flow_zoo_reference_cpu import IMH_MOMENTS, imh_moments, packages  # noqa: E402


def drift() -> None:
    for case in cs.LAST_CASES:
        t0 = time.time()
        inputs = cs.last_inputs(case)
        ref32 = cs.last_cpu_reference(case, inputs)
        ref64 = cs.last_cpu_reference(case, inputs, torch.float64)
        line = []
        for direction in ("forward", "inverse"):
            (y32, ld32), (y64, ld64) = ref32[direction], ref64[direction]
            scale = max(1.0, float(np.abs(y64).max()), float(np.abs(ld64).max()))
            e = max(float(np.abs(y32 - y64).max()), float(np.abs(ld32 - ld64).max()))
            line.append(f"{direction} {e / scale:.3e} of scale {scale:.1f}")
        print(f"{case[0]} {case[1]} float32 against float64 on the CPU: " + "; ".join(line)
              + f" ({time.time() - t0:.1f} s)", flush=True)


def ops() -> None:
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    for name, shape in cs.LAST_CASES:
        flow = cs.last_flow(name, shape)
        x = torch.from_numpy(cs.last_inputs((name, shape))[0])
        counts = []
        with torch.no_grad():
            for fn in (flow.bijection.forward_fn, flow.bijection.inverse_fn):
                Count.n = 0
                with Count():
                    fn(flow.params, x)
                counts.append(Count.n)
        print(f"{name} {shape} (B={cs.LAST_B}): forward {counts[0]} operations a call, inverse "
              f"{counts[1]}", flush=True)


def phi4(seeds, port: bool) -> None:
    for pkg_name, pkg, pots, extra, _ in packages(port):
        rows = []
        for seed in seeds:
            t0 = time.time()
            out = pkg.sample(pots.Phi4Lattice(**cs.PHI4_KW), strategy="jump_hmc",
                             flow="glow-realnvp", n_chains=cs.PHI4_C, n_iterations=cs.PHI4_ITERS,
                             warmup=True, param_kwargs={"flow_fit_kwargs": cs.PHI4_FIT_KWARGS},
                             seed=seed, show_progress=False, **extra)
            phi = np.asarray(out.samples.cpu() if hasattr(out.samples, "cpu") else out.samples)
            m = float(np.abs(phi.mean(axis=(-1, -2))).mean())
            rows.append((m, out.statistics.jump_acceptance_rate))
            print(f"{pkg_name} phi4 jump_hmc glow-realnvp seed {seed}: mean |m| {m:.4f}, jump acc "
                  f"{rows[-1][1]:.4f} ({time.time() - t0:.0f} s)", flush=True)
        v = np.array(rows)
        print(f"{pkg_name} phi4 over {len(v)} seeds: mean |m| [{v[:, 0].min():.4f}, "
              f"{v[:, 0].max():.4f}], jump acc [{v[:, 1].min():.4f}, {v[:, 1].max():.4f}]",
              flush=True)


def rnode(seeds, port: bool) -> None:
    for pkg_name, pkg, pots, extra, _ in packages(port):
        target = pots.DiagonalGaussian1(cs.D)
        sigma2 = np.asarray(target.sigma, np.float64) ** 2
        rows = []
        for seed in seeds:
            t0 = time.time()
            out = pkg.sample(target, flow="rnode", n_chains=cs.C, n_iterations=cs.RNODE_ITERS,
                             warmup=True, param_kwargs={"warmup_fit_kwargs": cs.RNODE_FIT_KWARGS},
                             seed=seed, show_progress=False, **extra)
            flow = out.kernel.flow
            draws = out.samples[-1]
            kinetic = float(np.asarray(flow.bijection.regularization(flow.params, draws)).mean())
            moments = imh_moments(out.mean, out.variance, sigma2)
            rows.append((out.statistics.acceptance_rate, *moments, kinetic))
            print(f"{pkg_name} RNODE IMH with warmup seed {seed}: acc {rows[-1][0]:.4f}, "
                  + ", ".join(f"{k} {v:.4f}" for k, v in zip(IMH_MOMENTS, moments))
                  + f", kinetic term {kinetic:.4e} ({time.time() - t0:.0f} s)", flush=True)
        v = np.array(rows)
        print(f"{pkg_name} RNODE IMH over {len(v)} seeds: acc [{v[:, 0].min():.4f}, "
              f"{v[:, 0].max():.4f}]; " + "; ".join(
                  f"{k} [{v[:, i].min():.4f}, {v[:, i].max():.4f}]"
                  for i, k in enumerate(IMH_MOMENTS, start=1))
              + f"; kinetic [{v[:, -1].min():.4e}, {v[:, -1].max():.4e}]", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--drift", action="store_true")
    ap.add_argument("--ops", action="store_true")
    ap.add_argument("--phi4", action="store_true")
    ap.add_argument("--rnode", action="store_true")
    ap.add_argument("--port", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(4)
    if args.drift:
        drift()
    if args.ops:
        ops()
    if args.phi4:
        phi4(args.seeds, args.port)
    if args.rnode:
        rnode(args.seeds, args.port)


if __name__ == "__main__":
    main()
