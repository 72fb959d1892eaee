"""Where a call of the continuous, multiscale / Glow and convolutional flows
spends its time on the card (``chip_smoke.py`` phase 15's flows and
weights).

For each case: the wall of a call (CUDA events around it, host included,
the median of ``--reps`` after two warm calls), its eager operations
(counted by a dispatch mode), the device time of its kernels
(torch.profiler, summed) and the host operations that take the most CPU
time. ``fit`` cases time one Adam step of ``Flow.fit`` at batch 256
(phase 15b's Glow fit). Prints the card's name and power limit.

    python3 scripts/last_flows_profile.py [--reps 5] [--cases glow-realnvp:fit ...]
        [--device cpu]   # a dry run without a card
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the repo root

import chip_smoke as cs  # noqa: E402

DEFAULT = ["glow-realnvp:fit", "glow-realnvp:8x8", "ms-realnvp:8x8", "conv-i-resnet:8x8",
           "conv-ffjord:8x8", "ffjord:100", "ot-flow:100"]


def parse(case):
    name, what = case.split(":")
    if what == "fit":
        return name, (8, 8), True
    shape = tuple(int(v) for v in what.split("x"))
    return name, shape, False


def main() -> None:
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    from nfmc_torch.flows import train

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cases", nargs="+", default=DEFAULT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip())

    def sync():
        if cuda:
            torch.cuda.synchronize()

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, a=(), kw=None):
            if not func.is_view:
                Count.n += 1
            return func(*a, **(kw or {}))

    for case in args.cases:
        name, shape, fit = parse(case)
        flow = cs.last_flow(name, shape, device=dev)
        if fit:
            x = torch.randn((256, *shape), generator=torch.Generator().manual_seed(0))
            data = x.numpy()
            opt = {"n_epochs": 1, "batch_size": 256, "shuffle": False, "seed": 0}
            steps = {"n": 0}
            orig = train._train_step

            def counted(*a, **k):
                steps["n"] += 1
                return orig(*a, **k)

            train._train_step = counted

            def call():
                flow.fit(data, x_val=data[:8], **opt)
        else:
            x = torch.from_numpy(cs.last_inputs((name, shape), device=dev)[0]).to(dev)

            def call():
                with torch.no_grad():
                    flow.bijection.forward_fn(flow.params, x)

        for _ in range(2):
            call()
        times = []
        for _ in range(args.reps):
            sync()
            t0 = time.perf_counter()
            call()
            sync()
            times.append(1e3 * (time.perf_counter() - t0))
        Count.n = 0
        with Count():
            call()
        n_ops = Count.n
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            call()
            sync()
        ka = prof.key_averages()
        device_ms = sum(a.self_device_time_total for a in ka) / 1e3
        top = sorted(ka, key=lambda a: a.self_cpu_time_total, reverse=True)[:6]
        what = (f"a fit epoch of {steps['n'] // (args.reps + 4)} Adam step at batch 256" if fit
                else f"forward at B={x.shape[0]}")
        if fit:
            train._train_step = orig
        print(f"{name} {shape} {what}: wall {np.median(times):.3f} ms (median of {args.reps}), "
              f"{n_ops} operations ({1e3 * np.median(times) / n_ops:.1f} us each), device "
              f"{device_ms:.3f} ms; most host time: "
              + ", ".join(f"{a.key} {a.self_cpu_time_total / 1e3:.2f} ms x{a.count}" for a in top),
              flush=True)


if __name__ == "__main__":
    main()
