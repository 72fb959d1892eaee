"""Time the eager loops (``disable_graphs()``, the path of several ranks)
of two checkouts on one NVIDIA card, in alternating turns (base, new, new,
base, ...), each turn a fresh process.

    python3 scripts/eager_ab.py --base DIR --new DIR [--pairs 2] [--set refits] [--graphs]

DIR holds a checkout, e.g. a ``git archive`` of a commit unpacked into a
git-ignored directory. The default set is NUTS and ChEES at
``chip_smoke.py``'s phase 12 and 12a sizes: NUTS on N(0, I_100) at 1024
chains, depth 10, from the step 0.67, 10 dual-averaging and 20 sampling
iterations; ChEES-HMC on ``DiagonalGaussian1(100)`` at 1024 chains, 50 +
250 iterations. ``--set refits`` times the refitting chunks instead, at
RealNVP 4 x 128 and d = 100: DLMC at 1024 chains, REFIT_DLMC_ITERS
iterations of 10-epoch refits (phase 11e); AdaptiveIMH's 100 iterations on
``DiagonalGaussian1(100)`` (10c); TESS's fused warmup, 20 iterations of
10-epoch refits (11c); jump_mala with fixed-effort ``fit_nf``, 10 outer
iterations of 5 MALA steps, 2-epoch refits from the third (5c).
``--graphs`` times the default path instead of the eager loop (replayed
graphs on the card). Each turn warms every run up, then times each twice
(the host's clock around the call, synchronised). Prints the card's name
and power limit first, then a line a turn and a last JSON line of every
wall, with a checksum of each run's draws: both checkouts must draw the
same numbers.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

NUTS_C, NUTS_DEPTH, NUTS_STEP, NUTS_WARM, NUTS_ITERS = 1024, 10, 0.67, 10, 20
CHEES_C, CHEES_WARM, CHEES_ITERS = 1024, 50, 250
D, C, H, L = 100, 100, 128, 4
REFIT_DLMC_C, REFIT_DLMC_ITERS = 1024, 25


def worker(root: str, which: str, graphed: bool) -> dict:
    sys.path.insert(0, root)
    import torch

    import nfmc_torch
    from nfmc_torch.core import disable_graphs
    from nfmc_torch.flows import Flow, RealNVP
    from nfmc_torch.potentials import DiagonalGaussian1, StandardGaussian

    def nuts(short):
        return nfmc_torch.sample(
            StandardGaussian((D,)), strategy="nuts", n_chains=NUTS_C, warmup=True,
            n_warmup_iterations=2 if short else NUTS_WARM, n_iterations=2 if short else NUTS_ITERS,
            kernel_kwargs={"max_tree_depth": NUTS_DEPTH, "step_size": NUTS_STEP},
            param_kwargs={"store_samples_on_device": True}, seed=0, show_progress=False)

    def chees(short):
        return nfmc_torch.sample(
            DiagonalGaussian1(n_dim=D), strategy="chees_hmc", n_chains=CHEES_C, warmup=True,
            n_warmup_iterations=2 if short else CHEES_WARM,
            n_iterations=2 if short else CHEES_ITERS,
            param_kwargs={"store_samples_on_device": True}, seed=0, show_progress=False)

    def flow():
        return Flow(RealNVP((D,), n_layers=L, hidden_size=H), seed=0)

    std = StandardGaussian((D,))

    def dlmc(short):
        return nfmc_torch.sample(
            std, strategy="dlmc", negative_log_likelihood=std, flow=flow(), n_chains=REFIT_DLMC_C,
            n_iterations=1 if short else REFIT_DLMC_ITERS, seed=0, show_progress=False,
            param_kwargs={"flow_fit_kwargs": {"n_epochs": 10, "lr": 5e-3},
                          "store_samples_on_device": True})

    def adaptive_imh(short):
        return nfmc_torch.sample(DiagonalGaussian1(n_dim=D), strategy="adaptive_imh",
                                 flow=flow(), n_chains=C, seed=0, show_progress=False)

    def tess_warmup(short):
        s = nfmc_torch.create_sampler(
            std, strategy="tess", negative_log_likelihood=std, flow=flow(),
            param_kwargs={"n_warmup_iterations": 2 if short else 20,
                          "flow_fit_kwargs": {"n_epochs": 10, "lr": 5e-3},
                          "store_samples_on_device": True})
        return s.warmup(torch.zeros(C, D, device=s.device), show_progress=False, seed=0)

    def fit_nf(short):
        return nfmc_torch.sample(
            std, strategy="jump_mala", flow=flow(), n_chains=C, n_iterations=3 if short else 10,
            inner_param_kwargs={"n_iterations": 5}, seed=0, show_progress=False,
            param_kwargs={"fit_nf": True, "flow_fit_kwargs": {"n_epochs": 2},
                          "n_jumps_before_training": 2, "store_samples_on_device": True})

    runs = ({"nuts": nuts, "chees": chees} if which == "nuts-chees" else
            {"dlmc": dlmc, "adaptive_imh": adaptive_imh, "tess_warmup": tess_warmup,
             "fit_nf": fit_nf})
    res = {}
    with (contextlib.nullcontext() if graphed else disable_graphs()):
        for run in runs.values():
            run(True)
        for label, run in runs.items():
            walls = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = run(False)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            res[label] = {"walls": walls, "draws_sum": float(out.samples.double().sum())}
            if getattr(out.kernel, "flow", None) is not None:
                res[label]["weights_sum"] = float(sum(
                    t.double().sum() for t in nfmc_torch.utils.tree_leaves(out.kernel.flow.params)))
            if hasattr(out.kernel, "step_size"):
                res[label]["step_size"] = float(out.kernel.step_size)
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base")
    ap.add_argument("--new")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--set", default="nuts-chees", choices=("nuts-chees", "refits"))
    ap.add_argument("--graphs", action="store_true")
    ap.add_argument("--worker")
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.set, args.graphs)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    turns = []
    for i in range(args.pairs):
        pair = [("base", args.base), ("new", args.new)]
        turns += [(f"{label}{i + 1}", root) for label, root in (pair if i % 2 == 0 else pair[::-1])]
    results, failed = {}, False
    for label, root in turns:
        r = subprocess.run([sys.executable, __file__, "--worker", root, "--set", args.set]
                           + (["--graphs"] if args.graphs else []), capture_output=True, text=True)
        if r.returncode != 0:
            print(f"==== {label} ({root}): rc {r.returncode}\n{r.stderr[-3000:]}", flush=True)
            failed = True
            continue
        results[label] = json.loads(r.stdout.strip().splitlines()[-1])
        print(f"==== {label} ({root}): {json.dumps(results[label])}", flush=True)
    labels = sorted({k for v in results.values() for k in v})
    for k in labels:
        if len({json.dumps({f: w for f, w in v[k].items() if f != "walls"})
                for v in results.values()}) > 1:
            print(f"{k}: the checkouts drew different numbers", flush=True)
            failed = True
    print(json.dumps(results))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
