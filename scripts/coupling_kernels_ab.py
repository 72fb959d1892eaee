"""Time the coupling kernels of this checkout against those of another
checkout on one NVIDIA card, in turns (base, new, new, base).

    python3 scripts/coupling_kernels_ab.py --base DIR [--family realnvp|spline]

DIR holds the other checkout (its ``nfmc_torch/csrc``), e.g. a ``git
archive`` of the parent commit unpacked into a git-ignored directory. Both
versions of the family's two sources are built by
``nfmc_torch.ops.build.load`` with the same ``nvcc`` flags and called
through their C entry points with the same arguments, at the main path's
shapes (d=100, H=128, L=4):

- ``realnvp`` (``coupling.cu``, ``coupling_bwd.cu``): the forward at B=100,
  256, 3000 and 218,400 in both directions, and the VJP at B=256;
- ``spline`` (``spline.cu``, ``spline_bwd.cu``), RQS and LRS at K=8 on
  [-5, 5]: the forward at B=100, the inverse at B=50,000 (the hoisted
  proposals) and the VJP at B=256 (a warmup's training batch).

For each it prints the median time of a call (CUDA events around the bare
C call, no Python wrapper, a synchronise after each call), the kernels'
device time per call from torch.profiler (per kernel, so the VJP's split
between its rows and weight-gradient kernels shows), and checks both
versions against the plain PyTorch version (forward <= 1e-4 * max(1,
max|ref|), VJP <= 1e-4 (RealNVP) or 2e-4 (splines) * max(1, max|ref|)).
The RealNVP family also prints whether the two versions' outputs are
equal bit for bit. The spline family also prints, per version, the host's time to enqueue a
call (perf_counter around the bare C call, no synchronise), the event time
a call of 20 calls back to back, the device time from the profiler's raw
kernel events, and this checkout's Python wrapper time (events, as
``chip_smoke.py``'s ``ms``). Exits non-zero without a CUDA device or when
a version disagrees.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from nfmc_torch.ops import build  # noqa: E402
from nfmc_torch.ops import coupling as ops  # noqa: E402
from nfmc_torch.utils import tree_leaves  # noqa: E402

D, H, L, CLAMP = 100, 128, 4, 3.0
N_BINS, TAIL = 8, 5.0
SOURCES = {"realnvp": ("coupling", "coupling_bwd"), "spline": ("spline", "spline_bwd")}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, type=Path, help="the other checkout")
    ap.add_argument("--family", choices=sorted(SOURCES), default="realnvp")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0])
    versions = {tag: build.load({n: csrc / f"{n}.cu" for n in SOURCES[args.family]})
                for tag, csrc in (("base", args.base / "nfmc_torch" / "csrc"), ("new", build.CSRC))}
    (run if args.family == "realnvp" else run_spline)(versions)


def report(what, calls, check, reps, extra=None) -> bool:
    """Time ``calls[tag]`` in turns (base, new, new, base), print one line,
    and return whether both versions agree with the plain version."""
    times = {}
    for tag in ("base", "new", "new", "base"):
        times.setdefault(tag, []).append(cs.median_ms(calls[tag], reps))
    line, ok = what, True
    for tag in ("base", "new"):
        err = check(tag)
        ok &= err
        dev_us = cs.device_us(calls[tag], max(3, reps * 2 // 3))
        line += (f" | {tag}: {times[tag][0]:.4f} / {times[tag][1]:.4f} ms, device "
                 + ", ".join(f"{k} {v:.2f} us" for k, v in dev_us.items()) + f", agrees {err}")
        if extra is not None:
            line += extra(tag)
    print(line, flush=True)
    return ok


def bit_identical(outs: dict) -> bool:
    """Whether the two versions' last outputs (a tuple of tensors each) are
    equal bit for bit."""
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(outs["base"], outs["new"]))


def run(versions: dict) -> None:
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(0)
    params = cs.perturbed_params(D, H, L, seed=1, device=dev)
    packed = ops.pack_weights(params)
    ok = True

    for rows in (100, 256, 3000, 218400):
        x = torch.randn((rows, D), generator=g, device=dev)
        for inverse in (False, True):
            y_ref, ld_ref = ops.realnvp_stack_plain(params, x, CLAMP, inverse)
            outs = {tag: (torch.empty_like(x), torch.empty(rows, device=dev)) for tag in versions}

            def call(tag, x=x, inverse=inverse, rows=rows, outs=outs):
                y, ld = outs[tag]
                err = versions[tag]["coupling"].nfmc_coupling_stack(
                    x.data_ptr(), packed.data_ptr(), y.data_ptr(), ld.data_ptr(), rows, D, H, L,
                    CLAMP, int(inverse), stream)
                if err != 0:
                    sys.exit(f"{tag} launch failed: cudaError {err}")

            def check(tag, outs=outs, y_ref=y_ref, ld_ref=ld_ref):
                torch.cuda.synchronize()
                y, ld = outs[tag]
                return max((y - y_ref).abs().max().item(), (ld - ld_ref).abs().max().item()) <= 1e-4

            ok &= report(f"{'inverse' if inverse else 'forward'} B={rows}",
                         {tag: (lambda tag=tag: call(tag)) for tag in versions}, check,
                         30 if rows < 218400 else 5)
            print(f"  bit-identical to base: {bit_identical(outs)}", flush=True)

    rows = 256
    x, gy = (torch.randn((rows, D), generator=g, device=dev) for _ in range(2))
    gld = torch.randn((rows,), generator=g, device=dev)
    ref = ops.realnvp_stack_vjp_plain(params, x, gy, gld, CLAMP, False)
    ref_flat = torch.cat([t.reshape(-1) for t in tree_leaves(ref[1])])
    scale = max(1.0, ref[0].abs().max().item(), ref_flat.abs().max().item())
    outs = {}
    for tag, libs in versions.items():
        n = libs["coupling_bwd"].nfmc_coupling_vjp_scratch_floats(rows, D, H, L)
        outs[tag] = (torch.empty_like(x), torch.empty_like(packed), torch.empty(n, device=dev))

    def vjp(tag):
        gx, grads, scratch = outs[tag]
        err = versions[tag]["coupling_bwd"].nfmc_coupling_stack_vjp(
            x.data_ptr(), gy.data_ptr(), gld.data_ptr(), packed.data_ptr(), gx.data_ptr(),
            grads.data_ptr(), scratch.data_ptr(), rows, D, H, L, CLAMP, 0, stream)
        if err != 0:
            sys.exit(f"{tag} launch failed: cudaError {err}")

    def check_vjp(tag):
        torch.cuda.synchronize()
        gx, grads, _ = outs[tag]
        e = max((gx - ref[0]).abs().max().item(), (grads - ref_flat).abs().max().item())
        return e <= 1e-4 * scale

    ok &= report("vjp B=256", {tag: (lambda tag=tag: vjp(tag)) for tag in versions}, check_vjp, 30)
    print(f"  bit-identical to base: {bit_identical({t: o[:2] for t, o in outs.items()})}")
    if not ok:
        sys.exit("a version disagrees with the plain version")


def host_us(fn, reps: int = 50) -> float:
    """Median host time, in us, to enqueue one call (no synchronise inside
    the timed span)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e6 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return statistics.median(times)


def back_to_back_ms(fn, n: int = 20) -> float:
    """Event time a call over ``n`` calls enqueued back to back."""
    fn()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / n


def raw_device_us(fn, calls: int = 5) -> tuple:
    """(device us a call summed over the profiler's raw kernel events, the
    number of such events a call): a second reading beside
    ``key_averages``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in ev) / calls, len(ev) / calls


def run_spline(versions: dict) -> None:
    from nfmc_torch.flows.spline import n_params_per_dim
    from nfmc_torch.ops import spline as sops

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(0)
    ok = True
    for kind in ("rqs", "lrs"):
        lrs, n_par = int(kind == "lrs"), n_params_per_dim(kind, N_BINS)
        params = cs.spline_params(kind, D, H, L, N_BINS, seed=1, device=dev)
        packed = ops.pack_weights(params)
        for rows, inverse in ((100, False), (50000, True)):
            x = 3 * torch.randn((rows, D), generator=g, device=dev)
            y_ref, ld_ref = sops.spline_stack_plain(params, x, kind, N_BINS, TAIL, inverse)
            scale = max(1.0, y_ref.abs().max().item(), ld_ref.abs().max().item())
            outs = {tag: (torch.empty_like(x), torch.empty(rows, device=dev)) for tag in versions}

            def call(tag, x=x, inverse=inverse, rows=rows, outs=outs):
                y, ld = outs[tag]
                err = versions[tag]["spline"].nfmc_spline_stack(
                    x.data_ptr(), packed.data_ptr(), y.data_ptr(), ld.data_ptr(), rows, D, H, L,
                    N_BINS, TAIL, int(inverse), lrs, stream)
                if err != 0:
                    sys.exit(f"{tag} launch failed: cudaError {err}")

            def check(tag, outs=outs, y_ref=y_ref, ld_ref=ld_ref, scale=scale):
                torch.cuda.synchronize()
                y, ld = outs[tag]
                e = max((y - y_ref).abs().max().item(), (ld - ld_ref).abs().max().item())
                return e <= 1e-4 * scale

            wrapper = getattr(sops, f"fused_{kind}_{'inverse' if inverse else 'forward'}")
            calls = {tag: (lambda tag=tag: call(tag)) for tag in versions}

            def extra(tag, calls=calls, wrapper=wrapper, x=x, params=params, rows=rows):
                fn = calls[tag]
                raw_us, n_ev = raw_device_us(fn, 5 if rows < 50000 else 3)
                text = (f"; host enqueue {host_us(fn):.1f} us, back-to-back "
                        f"{back_to_back_ms(fn, 20 if rows < 50000 else 5):.4f} ms, raw device "
                        f"events {raw_us:.2f} us ({n_ev:.1f} a call)")
                if tag == "new":
                    text += (", wrapper " + f"{cs.median_ms(lambda: wrapper(params, x, N_BINS, TAIL, packed=packed), 20 if rows < 50000 else 5):.4f}"
                             + " ms")
                return text

            ok &= report(f"{kind} {'inverse' if inverse else 'forward'} B={rows}", calls, check,
                         30 if rows < 50000 else 5, extra)

        rows = 256
        x = 3 * torch.randn((rows, D), generator=g, device=dev)
        gy = torch.randn((rows, D), generator=g, device=dev)
        gld = torch.randn((rows,), generator=g, device=dev)
        ref = sops.spline_stack_vjp_plain(params, x, gy, gld, kind, N_BINS, TAIL, False)
        ref_flat = torch.cat([t.reshape(-1) for t in tree_leaves(ref[1])])
        scale = max(1.0, ref[0].abs().max().item(), ref_flat.abs().max().item())
        outs = {}
        for tag, libs in versions.items():
            n = libs["spline_bwd"].nfmc_spline_vjp_scratch_floats(rows, D, H, L, n_par)
            outs[tag] = (torch.empty_like(x), torch.empty_like(packed), torch.empty(n, device=dev))

        def vjp(tag, x=x, gy=gy, gld=gld, outs=outs, lrs=lrs):
            gx, grads, scratch = outs[tag]
            err = versions[tag]["spline_bwd"].nfmc_spline_stack_vjp(
                x.data_ptr(), gy.data_ptr(), gld.data_ptr(), packed.data_ptr(), gx.data_ptr(),
                grads.data_ptr(), scratch.data_ptr(), rows, D, H, L, N_BINS, TAIL, 0, lrs, stream)
            if err != 0:
                sys.exit(f"{tag} launch failed: cudaError {err}")

        def check_vjp(tag, outs=outs, ref=ref, ref_flat=ref_flat, scale=scale):
            torch.cuda.synchronize()
            gx, grads, _ = outs[tag]
            e = max((gx - ref[0]).abs().max().item(), (grads - ref_flat).abs().max().item())
            return e <= 2e-4 * scale

        ok &= report(f"{kind} vjp B=256", {tag: (lambda tag=tag: vjp(tag)) for tag in versions},
                     check_vjp, 30)
    if not ok:
        sys.exit("a version disagrees with the plain version")


if __name__ == "__main__":
    main()
