"""Time the eager loops of NUTS and ChEES (``disable_graphs()``, the path
of several ranks) of two checkouts on one NVIDIA card, in alternating
turns (base, new, new, base, ...), each turn a fresh process.

    python3 scripts/eager_ab.py --base DIR --new DIR [--pairs 2]

DIR holds a checkout, e.g. a ``git archive`` of a commit unpacked into a
git-ignored directory. Sizes are ``chip_smoke.py``'s phase 12 and 12a:
NUTS on N(0, I_100) at 1024 chains, depth 10, from the step 0.67, 10
dual-averaging and 20 sampling iterations; ChEES-HMC on
``DiagonalGaussian1(100)`` at 1024 chains, 50 + 250 iterations. Each turn
warms both up, then times each twice (the host's clock around the call,
synchronised). Prints the card's name and power limit first, then a line
a turn and a last JSON line of every wall, with a checksum of each run's
draws: both checkouts must draw the same numbers.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

NUTS_C, NUTS_DEPTH, NUTS_STEP, NUTS_WARM, NUTS_ITERS = 1024, 10, 0.67, 10, 20
CHEES_C, CHEES_WARM, CHEES_ITERS = 1024, 50, 250
D = 100


def worker(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    import nfmc_torch
    from nfmc_torch.core import disable_graphs
    from nfmc_torch.potentials import DiagonalGaussian1, StandardGaussian

    def nuts(n_warm, n_iter):
        return nfmc_torch.sample(
            StandardGaussian((D,)), strategy="nuts", n_chains=NUTS_C, warmup=True,
            n_warmup_iterations=n_warm, n_iterations=n_iter,
            kernel_kwargs={"max_tree_depth": NUTS_DEPTH, "step_size": NUTS_STEP},
            param_kwargs={"store_samples_on_device": True}, seed=0, show_progress=False)

    def chees(n_warm, n_iter):
        return nfmc_torch.sample(
            DiagonalGaussian1(n_dim=D), strategy="chees_hmc", n_chains=CHEES_C, warmup=True,
            n_warmup_iterations=n_warm, n_iterations=n_iter,
            param_kwargs={"store_samples_on_device": True}, seed=0, show_progress=False)

    res = {}
    with disable_graphs():
        nuts(2, 2)
        chees(2, 2)
        for label, run in (("nuts", lambda: nuts(NUTS_WARM, NUTS_ITERS)),
                           ("chees", lambda: chees(CHEES_WARM, CHEES_ITERS))):
            walls = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = run()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            res[label] = {"walls": walls,
                          "draws_sum": float(out.samples.double().sum()),
                          "step_size": float(out.kernel.step_size)}
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base")
    ap.add_argument("--new")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--worker")
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker)))
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
        r = subprocess.run([sys.executable, __file__, "--worker", root],
                           capture_output=True, text=True)
        if r.returncode != 0:
            print(f"==== {label} ({root}): rc {r.returncode}\n{r.stderr[-3000:]}", flush=True)
            failed = True
            continue
        results[label] = json.loads(r.stdout.strip().splitlines()[-1])
        print(f"==== {label} ({root}): {json.dumps(results[label])}", flush=True)
    sums = {(k, lbl): v[k]["draws_sum"] for lbl, v in results.items() for k in ("nuts", "chees")}
    for k in ("nuts", "chees"):
        if len({s for (kk, _l), s in sums.items() if kk == k}) > 1:
            print(f"{k}: the checkouts drew different numbers", flush=True)
            failed = True
    print(json.dumps(results))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
