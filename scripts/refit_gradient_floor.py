"""How many of a flow refit's gradient elements lie within float32 error
of zero, on the CPU.

Adam's first step moves every weight by +-lr whatever the size of its
gradient, so where float32 rounding can flip a gradient element's sign, two
correct implementations (the CUDA backward kernel and the plain PyTorch
VJP) refit to weights 2 lr apart. This computes the MLE gradient of a
RealNVP (d, H=128, L=4, weights moved 0.05 N(0, 1) off the identity as in
``chip_smoke.perturbed_params``) on a batch of 64 rows drawn from
``DiagonalGaussian1(d)``, in float32 and in float64, and prints the
largest gradient, the largest float32 error and how many elements are
smaller than a few error thresholds.

    python scripts/refit_gradient_floor.py [--d 100] [--seed 21]
"""
import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the repo root


def main() -> None:
    from chip_smoke import perturbed_params
    from nfmc_torch.flows import Flow, RealNVP
    from nfmc_torch.flows.train import _nll
    from nfmc_torch.potentials import DiagonalGaussian1
    from nfmc_torch.utils import tree_leaves

    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=100)
    ap.add_argument("--seed", type=int, default=21)
    args = ap.parse_args()
    d, hidden, n_layers = args.d, 128, 4
    params = perturbed_params(d, hidden, n_layers, seed=args.seed, device="cpu")
    flow = Flow(RealNVP((d,), n_layers=n_layers, hidden_size=hidden), seed=0)
    sigma = torch.from_numpy(DiagonalGaussian1(d).sigma)
    x = torch.randn((64, d), generator=torch.Generator().manual_seed(5)) * sigma

    def grad(dtype):
        p = [{k: [t.to(dtype).requires_grad_(True) for t in v] for k, v in q.items()}
             for q in params]
        loss = _nll(flow, p, x.to(dtype))
        return torch.cat([g.reshape(-1) for g in torch.autograd.grad(loss, tree_leaves(p))])

    g32, g64 = grad(torch.float32).double(), grad(torch.float64)
    err = (g32 - g64).abs()
    print(f"d={d}: {g64.numel()} gradient elements, max |g| {g64.abs().max().item():.4g}, "
          f"float32 error max {err.max().item():.3g}; elements with float32 error above |g|: "
          f"{int((err > g64.abs()).sum())}")
    for t in (1e-4, 1e-3, 1e-2):
        print(f"  |g| < {t:g}: {int((g64.abs() < t).sum())}")


if __name__ == "__main__":
    main()
