"""The flows without a kernel on the card: their plain PyTorch math on CUDA
tensors against the same math on the CPU. These need an NVIDIA card and
skip without one; run them there with
``python -m pytest --noconftest tests/test_torch_cuda_flows.py``.
``chip_smoke.py`` phases 14 and 15a cover the same ground at full width.

Tolerances, of max(1, max|ref|), as phase 14a: 1e-4 for a closed-form
direction, 1e-3 for one that solves (bisection, fixed point, Newton), 2e-3
for ia-naf-deep-dense's forward (its mixtures saturate at the float32
clamp; ``scripts/flow_zoo_reference_cpu.py --drift``)."""
import pytest
import torch

from nfmc_torch.api.registry import PORTED_FLOWS, create_flow_object
from nfmc_torch.utils import tree_map

pytestmark = pytest.mark.cuda
# the continuous, multiscale / Glow and convolutional flows
LAST = [n for n in PORTED_FLOWS if n in ("ot-flow", "ffjord", "ddb", "rnode")
        or n.startswith(("ms-", "glow-", "conv-"))]
NEW = [n for n in PORTED_FLOWS if n not in ("realnvp", "c-rqnsf", "c-lrsnsf") and n not in LAST]
SOLVES = ("i-resnet", "resflow", "proximal-resflow", "planar", "radial", "sylvester")


def _tol(name, inverse):
    if name == "ia-naf-deep-dense" and not inverse:
        return 2e-3
    if "naf" in name:
        return 1e-3 if inverse != name.startswith("ia-") else 1e-4
    return 1e-3 if inverse and name in SOLVES else 1e-4


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these paths run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _flow(name, d=12):
    flow = create_flow_object(name, (d,), seed=0, **(
        {} if name in ("planar", "radial", "sylvester") else {"hidden_size": 16}))
    g = torch.Generator().manual_seed(1)
    flow.params = tree_map(lambda t: t + 0.1 * torch.randn(t.shape, generator=g), flow.params)
    return flow


@pytest.mark.parametrize("name", NEW)
def test_flow_on_the_card_matches_the_cpu(cuda, name):
    flow = _flow(name)
    x = torch.randn((40, 12), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        for fn in ("forward_fn", "inverse_fn"):
            tol = _tol(name, fn == "inverse_fn")
            y_ref, ld_ref = getattr(flow.bijection, fn)(flow.params, x)
            params = tree_map(lambda t: t.to(cuda), flow.params)
            y, ld = getattr(flow.bijection, fn)(params, x.to(cuda))
            assert y.device.type == "cuda"
            scale = max(1.0, y_ref.abs().max().item(), ld_ref.abs().max().item())
            err = max((y.cpu() - y_ref).abs().max().item(), (ld.cpu() - ld_ref).abs().max().item())
            assert err <= tol * scale, (fn, err)


def _last_tol(name, inverse):
    """1e-4 for the closed forms; 1e-3 for the solves (Picard, the conv
    residual fixed point, NAF bisection, Glow's inverse of the 1 x 1
    weights) and the spline inverses, whose float32 drift from float64
    reaches 1e-2 of the scale at full width (chip_smoke.LAST_DRIFT)."""
    if inverse and ("rqnsf" in name or "lrsnsf" in name):
        return 5e-2
    return 1e-3 if inverse or "naf" in name else 1e-4


@pytest.mark.parametrize("name", LAST)
def test_last_flows_on_the_card_match_the_cpu(cuda, name):
    """The 23 flows of the last slice: forward and inverse on the card
    against the CPU under torch's default backend flags (cuDNN TF32 on: the
    convolutions are shifted views and a matmul, full float32), with the same
    Hutchinson probes on both devices (chip_smoke.FixedProbes). The inverse
    runs on the forward's image (a NAF flow's logit is bounded)."""
    import chip_smoke

    image = name.startswith(("ms-", "glow-", "conv-"))
    shape = (8, 8) if image else (40,)
    flow = create_flow_object(name, shape, seed=0, **(
        {"hidden_channels": 8} if image else {"hidden_size": 16}))
    g = torch.Generator().manual_seed(1)
    flow.params = tree_map(lambda t: t + 0.1 * torch.randn(t.shape, generator=g), flow.params)
    x = torch.randn((40, *shape), generator=torch.Generator().manual_seed(2))
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad(), chip_smoke.FixedProbes():
            z = flow.bijection.forward_fn(flow.params, x)[0]
            params = tree_map(lambda t: t.to(cuda), flow.params)
            for fn, v in (("forward_fn", x), ("inverse_fn", z)):
                y_ref, ld_ref = getattr(flow.bijection, fn)(flow.params, v)
                y, ld = getattr(flow.bijection, fn)(params, v.to(cuda))
                assert y.device.type == "cuda"
                scale = max(1.0, y_ref.abs().max().item(), ld_ref.abs().max().item())
                err = max((y.cpu() - y_ref).abs().max().item(),
                          (ld.cpu() - ld_ref).abs().max().item())
                assert err <= _last_tol(name, fn == "inverse_fn") * scale, (fn, err)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
