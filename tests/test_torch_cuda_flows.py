"""The flows without a kernel on the card: their plain PyTorch math on CUDA
tensors against the same math on the CPU. These need an NVIDIA card and
skip without one; run them there with
``python -m pytest --noconftest tests/test_torch_cuda_flows.py``.
``chip_smoke.py`` phase 14 covers the same ground at d=100.

Tolerances, of max(1, max|ref|), as phase 14a: 1e-4 for a closed-form
direction, 1e-3 for one that solves (bisection, fixed point, Newton), 2e-3
for ia-naf-deep-dense's forward (its mixtures saturate at the float32
clamp; ``scripts/flow_zoo_reference_cpu.py --drift``)."""
import pytest
import torch

from nfmc_torch.api.registry import PORTED_FLOWS, create_flow_object
from nfmc_torch.utils import tree_map

pytestmark = pytest.mark.cuda
NEW = [n for n in PORTED_FLOWS if n not in ("realnvp", "c-rqnsf", "c-lrsnsf")]
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
