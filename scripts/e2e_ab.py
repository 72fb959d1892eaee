"""Time the main path end to end (RealNVP, and the spline flows' warmups)
in two checkouts on one NVIDIA card, in alternating turns, each turn a
fresh process.

    python3 scripts/e2e_ab.py --base DIR [--turns 3]

DIR holds the other checkout, e.g. a ``git archive`` of the parent commit
unpacked into a git-ignored directory. The turns run in ABBA order (base,
new, new, base, base, new, ...), ``--turns`` of each. A turn imports the
``nfmc_torch`` of its checkout and measures, after a warm run:
  - the headline (``chip_smoke.py`` phase 5: 100 chains, d=100, RealNVP
    L=4, H=128, 5 MALA steps, 2184 outer iterations, frozen flow): wall and
    outer iterations per second;
  - the headline with ``warmup=True`` and 500 outer iterations (phase 5b):
    wall, the flow fit's wall (ending in a synchronise), its Adam steps and
    the fit wall per step;
  - the same warmup with each spline flow (phase 8: ``c-rqnsf`` and
    ``c-lrsnsf`` at L=4, H=128, K=8): wall, fit wall, Adam steps and the fit
    wall per step, keys prefixed ``rqs_`` and ``lrs_``;
  - a trace (torch.profiler, CPU and CUDA) of 64 RealNVP Adam steps at batch
    256 (``flows.train._train_step``, each in a ``record_function`` span):
    the host's time a step (the span on the host's clock, the profiler's
    own cost included), the device's busy time a step (the union of its
    kernels' intervals), the host operators that take the most time, and
    the wall a step of 200 untraced steps.
Prints the card's name and power limit, one JSON line a turn, and each
checkout's median and range of every number. Exits non-zero without a
CUDA device or when a turn fails.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
C, D, L, H, INNER_N, OUTER, WARM_OUTER = 100, 100, 4, 128, 5, 2184, 500


def turn(checkout: Path) -> dict:
    """The measurements of one turn, in this process, on ``checkout``."""
    sys.path.insert(0, str(checkout))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    import nfmc_torch
    from nfmc_torch.flows import Flow, RealNVP
    from nfmc_torch.flows import base as flow_base
    from nfmc_torch.flows import train
    from nfmc_torch.potentials import StandardGaussian

    assert Path(nfmc_torch.__file__).resolve().is_relative_to(checkout.resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    def headline(n_iter, flow=None, **kw):
        return nfmc_torch.sample(
            StandardGaussian((D,)), strategy="jump_mala",
            flow=flow or Flow(RealNVP((D,), n_layers=L, hidden_size=H), seed=0), n_chains=C,
            n_iterations=n_iter, inner_param_kwargs={"n_iterations": INNER_N}, seed=0,
            show_progress=False, **kw)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    out = {}
    on_device = {"store_samples_on_device": True}
    headline(20, param_kwargs=on_device)  # builds the kernels, warms the allocator
    _, wall = timed(lambda: headline(OUTER, param_kwargs=on_device))
    out["headline_wall_s"], out["headline_it_s"] = wall, OUTER / wall

    fit_s, steps = [0.0], [0]
    orig_fit, orig_step = flow_base.Flow.fit, train._train_step

    def fit(*a, **k):
        res, s = timed(lambda: orig_fit(*a, **k))
        fit_s[0] += s
        return res

    def step(*a, **k):
        steps[0] += 1
        return orig_step(*a, **k)

    # a checkout whose fits replay CUDA graphs counts its steps in
    # train.COUNTS (a replay runs no Python); an older one is counted here
    counts = getattr(train, "COUNTS", None)
    if counts is not None:
        step = orig_step

    flow_base.Flow.fit, train._train_step = fit, step
    try:
        for prefix, flow in (("", None),
                             ("rqs_", f'c-rqnsf%{{"n_layers": {L}, "hidden_size": {H}, "n_bins": 8}}'),
                             ("lrs_", f'c-lrsnsf%{{"n_layers": {L}, "hidden_size": {H}, "n_bins": 8}}')):
            fit_s[0], steps[0] = 0.0, 0
            before = dict(counts) if counts is not None else None
            _, wall = timed(lambda: headline(WARM_OUTER, flow=flow, warmup=True))
            if counts is not None:
                steps[0] = counts["steps"] - before["steps"]
            out.update({f"{prefix}warmup_wall_s": wall, f"{prefix}fit_s": fit_s[0],
                        f"{prefix}fit_steps": steps[0],
                        f"{prefix}fit_ms_per_step": 1e3 * fit_s[0] / max(steps[0], 1)})
    finally:
        flow_base.Flow.fit, train._train_step = orig_fit, orig_step

    flow = Flow(RealNVP((D,), n_layers=L, hidden_size=H), seed=0)
    flow.to(dev)
    like = flow.params
    theta = train._flatten(like)
    adam = train._Adam(theta, 0.005)
    xb = torch.randn((256, D), generator=torch.Generator(dev).manual_seed(0), device=dev)
    for _ in range(20):
        theta, _ = train._train_step(flow, like, theta, adam, xb, None)

    def steps_(n):
        nonlocal theta
        for _ in range(n):
            theta, _ = train._train_step(flow, like, theta, adam, xb, None)

    _, wall = timed(lambda: steps_(200))
    out["step_wall_ms"] = wall / 200 * 1e3
    n = 64
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            with record_function("adam_step"):
                theta, _ = train._train_step(flow, like, theta, adam, xb, None)
        torch.cuda.synchronize()
    events = prof.events()
    spans = [e for e in events if e.name == "adam_step" and e.device_type == DeviceType.CPU]
    out["step_host_ms"] = sum(e.time_range.elapsed_us() for e in spans) / len(spans) / 1e3
    # device busy: the union of the device's kernel, copy and set intervals
    # (a CPU operator's own device time repeats its kernels', so it is not
    # summed), the step spans' device-side annotations left out
    device = [e for e in events if e.device_type == DeviceType.CUDA and e.name != "adam_step"]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in device):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    out["step_device_ms"] = busy / n / 1e3 if device else None
    out["step_device_kernels"] = len(device) / n
    per_name = {}
    for e in device:
        per_name[e.name[:40]] = per_name.get(e.name[:40], 0.0) + e.time_range.elapsed_us()
    out["step_device_top"] = [[k, round(v / n / 1e3, 4)]
                              for k, v in sorted(per_name.items(), key=lambda kv: -kv[1])[:4]]
    ops = [a for a in prof.key_averages() if a.key != "adam_step" and a.self_cpu_time_total > 0]
    out["step_host_top"] = [[a.key[:40], round(a.self_cpu_time_total / n / 1e3, 4)]
                            for a in sorted(ops, key=lambda a: -a.self_cpu_time_total)[:6]]
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path, help="the other checkout")
    ap.add_argument("--turns", type=int, default=3, help="turns of each checkout")
    ap.add_argument("--turn", type=Path, help=argparse.SUPPRESS)  # one turn, in this process
    args = ap.parse_args()
    if args.turn is not None:
        print("E2E " + json.dumps(turn(args.turn)), flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    if args.base is None:
        sys.exit("--base DIR is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    checkouts = {"base": args.base.resolve(), "new": REPO}
    order = [tag for i in range(args.turns) for tag in (("base", "new") if i % 2 == 0
                                                       else ("new", "base"))]
    results = {"base": [], "new": []}
    for i, tag in enumerate(order):
        proc = subprocess.run([sys.executable, __file__, "--turn", str(checkouts[tag])],
                              capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("E2E ")]
        if proc.returncode != 0 or not lines:
            sys.exit(f"turn {i} ({tag}) failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        res = json.loads(lines[-1][4:])
        results[tag].append(res)
        print(f"turn {i} {tag}: {json.dumps(res)}", flush=True)
    for key in results["new"][0]:
        if key in ("step_host_top", "step_device_top", "step_device_kernels"):
            continue
        cells = []
        for tag in ("base", "new"):
            vals = [r[key] for r in results[tag] if r[key] is not None]
            if vals:
                cells.append(f"{tag} median {statistics.median(vals):.4f} "
                             f"[{min(vals):.4f}, {max(vals):.4f}]")
        print(f"{key}: " + "; ".join(cells))


if __name__ == "__main__":
    main()
