"""How far the spline VJP's float32 results lie from the plain version run
in float64, on one NVIDIA card: the kernel's (``fused_spline_vjp``) and the
plain version's in float32, at the shapes of ``tests/test_torch_kernels.py``
(d=100 at B=256 and 3000, d=500, 784 and 1024 at H=128, L=4, K=8; inputs
3 N(0, 1), weights 0.05 N(0, 1) from the identity).

    python3 scripts/spline_vjp_precision.py

For each kind, width and direction it prints max|diff| against float64 of
both float32 results and the tensor where it falls, relative to max(1,
max|ref|), and each row of gx off chip_smoke.py's gate (2e-4 of that
scale) with its witness from ``ops.spline.knot_witness``: the row's element
closest to a branch point of its spline, its float64 distance to it and
the layer's float32 drift. An element within that drift can take the
other bin in a float32 evaluation, and the row's VJP then differs by O(1).
Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from nfmc_torch.ops import coupling as cops  # noqa: E402
from nfmc_torch.ops import spline as sops  # noqa: E402
from nfmc_torch.utils import tree_leaves  # noqa: E402


def names(n_layers: int) -> list:
    return ["gx"] + [f"l{l}.{k}{i + 1}" for l in range(n_layers) for i in range(3) for k in "wb"]


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    for kind in ("rqs", "lrs"):
        for d, rows in ((100, 256), (100, 3000), (500, 300), (784, 300), (1024, 40)):
            for inverse in (False, True):
                params = cs.spline_params(kind, d, 128, 4, 8, seed=3, device=dev)
                g = torch.Generator(dev).manual_seed(4)
                x = 3 * torch.randn((rows, d), device=dev, generator=g)
                gy = torch.randn((rows, d), device=dev, generator=g)
                gld = torch.randn((rows,), device=dev, generator=g)
                p64 = [{k: [t.double() for t in v] for k, v in p.items()} for p in params]
                ref = sops.spline_stack_vjp_plain(p64, x.double(), gy.double(), gld.double(), kind,
                                                  8, 5.0, inverse)
                flat_ref = [ref[0], *tree_leaves(ref[1])]
                dist, drift, layer, dim = (t.cpu() for t in sops.knot_witness(
                    params, x, kind, 8, 5.0, inverse))
                line = (f"{kind} d={d} B={rows} {'inverse' if inverse else 'forward'} (rows with "
                        f"an element within float32 drift of a branch point: "
                        f"{int((dist <= drift).sum())}):")
                for what, got in (
                        ("kernel", sops.fused_spline_vjp(params, x, gy, gld, kind, 8, 5.0, inverse)),
                        ("plain float32", sops.spline_stack_vjp_plain(params, x, gy, gld, kind, 8,
                                                                      5.0, inverse))):
                    errs = [float((a.double() - b).abs().max())
                            for a, b in zip([got[0], *tree_leaves(got[1])], flat_ref)]
                    i = max(range(len(errs)), key=errs.__getitem__)
                    rel, scale, row_err = cops.vjp_error(got, ref)
                    off = (row_err > cs.SPLINE_BWD_TOL * scale).nonzero()[:, 0].tolist()
                    line += (f" | {what}: {errs[i]:.3e} at {names(4)[i]} (relative {rel:.2e}); "
                             f"rows of gx off the gate: {len(off)}")
                    for r in off:
                        line += (f"; row {r} off {float(row_err[r]):.3e}: layer {int(layer[r])} "
                                 f"dim {int(dim[r])} {float(dist[r]):.3e} from a branch point "
                                 f"(drift {float(drift[r]):.3e})")
                print(line, flush=True)


if __name__ == "__main__":
    main()
