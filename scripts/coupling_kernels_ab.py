"""Time the RealNVP coupling kernels of this checkout against those of
another checkout on one NVIDIA card, in turns (base, new, new, base).

    python3 scripts/coupling_kernels_ab.py --base DIR

DIR holds the other checkout (its ``nfmc_torch/csrc``), e.g. a ``git
archive`` of the parent commit unpacked into a git-ignored directory. Both
versions of ``coupling.cu`` and ``coupling_bwd.cu`` are built by
``nfmc_torch.ops.build.load`` with the same ``nvcc`` flags and called
through their C entry points with the same arguments, at the main path's shapes (d=100, H=128, L=4): the forward at
B=100, 256, 3000 and 218,400 in both directions, and the VJP at B=256.
For each it prints the median time of a call (CUDA events around the bare
C call, no Python wrapper) and the kernels' device time per call from
torch.profiler, and checks both versions against the plain PyTorch version
(forward <= 1e-4, VJP <= 1e-4 * max(1, max|ref|)). Exits non-zero without a
CUDA device or when a version disagrees.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from nfmc_torch.ops import build  # noqa: E402
from nfmc_torch.ops import coupling as ops  # noqa: E402

D, H, L, CLAMP = 100, 128, 4, 3.0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, type=Path, help="the other checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0])
    versions = {tag: build.load({n: csrc / f"{n}.cu" for n in ("coupling", "coupling_bwd")})
                for tag, csrc in (("base", args.base / "nfmc_torch" / "csrc"), ("new", build.CSRC))}
    run(versions)


def run(versions: dict) -> None:
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(0)
    params = cs.perturbed_params(D, H, L, seed=1, device=dev)
    packed = ops.pack_weights(params)
    ok = True

    def report(what, calls, check):
        nonlocal ok
        times = {}
        for tag in ("base", "new", "new", "base"):
            times.setdefault(tag, []).append(cs.median_ms(calls[tag], 30 if "218400" not in what else 5))
        line = what
        for tag in ("base", "new"):
            err = check(tag)
            ok &= err
            dev_us = cs.device_us(calls[tag], 20 if "218400" not in what else 3)
            line += (f" | {tag}: {times[tag][0]:.4f} / {times[tag][1]:.4f} ms, device "
                     + ", ".join(f"{k} {v:.2f} us" for k, v in dev_us.items()) + f", agrees {err}")
        print(line, flush=True)

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

            report(f"{'inverse' if inverse else 'forward'} B={rows}",
                   {tag: (lambda tag=tag: call(tag)) for tag in versions}, check)

    rows = 256
    x, gy = (torch.randn((rows, D), generator=g, device=dev) for _ in range(2))
    gld = torch.randn((rows,), generator=g, device=dev)
    ref = ops.realnvp_stack_vjp_plain(params, x, gy, gld, CLAMP, False)
    ref_flat = torch.cat([t.reshape(-1) for t in ops._leaves(ref[1])])
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

    report("vjp B=256", {tag: (lambda tag=tag: vjp(tag)) for tag in versions}, check_vjp)
    if not ok:
        sys.exit("a version disagrees with the plain version")


if __name__ == "__main__":
    main()
