"""The CUDA coupling kernels (forward and backward) against their plain
PyTorch versions. These need an NVIDIA card (and nvcc to build the kernels)
and skip without one; run them on the card with
``python -m pytest tests/test_torch_kernels.py``. ``chip_smoke.py`` covers
the same ground at the sampler's shapes.

The backward is held to 1e-4 * max(1, max|reference|): its weight
gradients sum products over the batch in another order than the plain
version's matrix products."""
import pytest
import torch

from nfmc_torch.flows import Flow, RealNVP
from nfmc_torch.ops import coupling as ops
from nfmc_torch.utils import tree_leaves

pytestmark = pytest.mark.cuda
TOL = 1e-4


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _params(d, hidden, n_layers, device, seed=0):
    flow = Flow(RealNVP((d,), n_layers=n_layers, hidden_size=hidden), seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    return [{k: [(t + 0.05 * torch.randn(t.shape, generator=g)).to(device) for t in v]
             for k, v in p.items()} for p in flow.params]


@pytest.mark.parametrize("d,hidden,n_layers,rows", [(7, 16, 3, 37), (100, 128, 4, 100),
                                                    (100, 128, 4, 64), (100, 128, 4, 128),
                                                    (100, 128, 4, 256), (100, 128, 4, 3000),
                                                    (100, 128, 4, 5000), (2, 8, 1, 1),
                                                    (33, 300, 2, 70), (784, 128, 2, 300),
                                                    (1024, 128, 2, 40)])
@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_matches_plain(cuda, d, hidden, n_layers, rows, inverse):
    params = _params(d, hidden, n_layers, cuda)
    x = torch.randn((rows, d), device=cuda, generator=torch.Generator(cuda).manual_seed(2))
    wrapper = ops.fused_realnvp_inverse if inverse else ops.fused_realnvp_forward
    before = wrapper.launches
    y, ld = wrapper(params, x, 3.0)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    y_ref, ld_ref = ops.realnvp_stack_plain(params, x, 3.0, inverse)
    assert float((y - y_ref).abs().max()) <= TOL
    assert float((ld - ld_ref).abs().max()) <= TOL


def test_kernel_refuses_what_it_does_not_take(cuda):
    params = _params(6, 8, 2, cuda)
    x = torch.randn((5, 6), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        ops.fused_realnvp_forward(params, x.double(), 3.0)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_realnvp_forward(params, torch.randn((6, 5), device=cuda).t(), 3.0)
    # an input that needs a gradient goes through the backward kernel
    before = ops.fused_realnvp_vjp.launches
    xg = x.clone().requires_grad_(True)
    z, ld = ops.fused_realnvp_forward(params, xg, 3.0)
    (gx,) = torch.autograd.grad((z * z).sum() + ld.sum(), xg)
    assert ops.fused_realnvp_vjp.launches == before + 1
    xc = x.cpu().requires_grad_(True)
    zc, ldc = ops.realnvp_stack_plain([{k: [t.cpu() for t in v] for k, v in p.items()}
                                       for p in params], xc, 3.0, False)
    (gxc,) = torch.autograd.grad((zc * zc).sum() + ldc.sum(), xc)
    assert float((gx.cpu() - gxc).abs().max()) <= TOL * max(1.0, float(gxc.abs().max()))
    # the wrapper refuses conditioners of 3 hidden layers; the flow runs
    # them on the plain stack, as the JAX package runs them on XLA
    three_hidden = Flow(RealNVP((6,), n_layers=2, hidden_size=8, n_hidden_layers=3), seed=0)
    three_hidden.to(cuda)
    with pytest.raises(ValueError, match="2 hidden layers"):
        ops.fused_realnvp_forward(three_hidden.params, x, 3.0)
    before = ops.fused_realnvp_forward.launches
    z3, ld3 = three_hidden.bijection.forward(x)
    z3_ref, ld3_ref = ops.realnvp_stack_plain(three_hidden.params, x, 3.0, False)
    assert ops.fused_realnvp_forward.launches == before
    assert torch.equal(z3, z3_ref) and torch.equal(ld3, ld3_ref)
    # a stack whose smallest tile does not fit a block's shared memory is
    # refused before the launch, with its sizes, and counts no launch
    wide = _params(3800, 128, 1, cuda)
    xw = torch.randn((2, 3800), device=cuda)
    before = ops.fused_realnvp_vjp.launches
    with pytest.raises(ValueError, match="bytes of shared memory"):
        ops.fused_realnvp_vjp(wide, xw, xw, torch.zeros(2, device=cuda), 3.0, False)
    assert ops.fused_realnvp_vjp.launches == before


@pytest.mark.parametrize("cls_name", ["RealNVP", "CouplingRQNSF"])
def test_flow_takes_strided_rows_on_cuda(cuda, cls_name):
    """``flow.log_prob(big[:, :d])`` on the card: the flow hands the kernels
    contiguous rows, and gives what it gives on the same rows made
    contiguous; the wrappers themselves still refuse the view."""
    import nfmc_torch.flows as flows

    flow = Flow(getattr(flows, cls_name)((100,), n_layers=4, hidden_size=128), seed=0).to(cuda)
    flow.params = [{k: [t + 0.01 for t in v] for k, v in p.items()} for p in flow.params]
    big = torch.randn((50, 130), device=cuda, generator=torch.Generator(cuda).manual_seed(3))
    view = big[:, :100]
    assert torch.equal(flow.log_prob(view), flow.log_prob(view.contiguous()))
    if cls_name == "RealNVP":
        with pytest.raises(ValueError, match="contiguous"):
            ops.fused_realnvp_forward(flow.params, view, 3.0)


@pytest.mark.parametrize("rows", [40, 300])
@pytest.mark.parametrize("inverse", [False, True])
def test_wide_realnvp_runs_both_ways(cuda, inverse, rows):
    """d=3000 and 3500 at H=128 (a ring of 2 stages): the forward and the
    VJP against their plain versions."""
    for d in (3000, 3500):
        params = _params(d, 128, 2, cuda, seed=d)
        g = torch.Generator(cuda).manual_seed(d)
        x, gy = (torch.randn((rows, d), device=cuda, generator=g) for _ in range(2))
        gld = torch.randn((rows,), device=cuda, generator=g)
        wrapper = ops.fused_realnvp_inverse if inverse else ops.fused_realnvp_forward
        y, ld = wrapper(params, x, 3.0)
        y_ref, ld_ref = ops.realnvp_stack_plain(params, x, 3.0, inverse)
        assert float((y - y_ref).abs().max()) <= TOL
        assert float((ld - ld_ref).abs().max()) <= TOL * max(1.0, float(ld_ref.abs().max()))
        got = ops.fused_realnvp_vjp(params, x, gy, gld, 3.0, inverse)
        assert _grad_err(got, ops.realnvp_stack_vjp_plain(params, x, gy, gld, 3.0, inverse)) <= TOL


def _grad_err(got, want):
    gx, grads = got
    rx, rgrads = want
    pairs = list(zip([gx, *tree_leaves(grads)], [rx, *tree_leaves(rgrads)]))
    return max(float((a - b).abs().max()) / max(1.0, float(b.abs().max())) for a, b in pairs)


@pytest.mark.parametrize("d,hidden,n_layers,rows", [(100, 128, 4, 512), (100, 128, 4, 256),
                                                    (100, 128, 4, 128), (100, 128, 4, 100),
                                                    (100, 128, 4, 64), (7, 16, 3, 37),
                                                    (100, 128, 4, 9001), (784, 128, 2, 300),
                                                    (1024, 128, 2, 40)])
@pytest.mark.parametrize("inverse", [False, True])
def test_backward_kernel_matches_plain(cuda, d, hidden, n_layers, rows, inverse):
    params = _params(d, hidden, n_layers, cuda, seed=3)
    g = torch.Generator(cuda).manual_seed(4)
    x, gy = (torch.randn((rows, d), device=cuda, generator=g) for _ in range(2))
    gld = torch.randn((rows,), device=cuda, generator=g)
    before = ops.fused_realnvp_vjp.launches
    got = ops.fused_realnvp_vjp(params, x, gy, gld, 3.0, inverse)
    torch.cuda.synchronize()
    assert ops.fused_realnvp_vjp.launches == before + 1
    assert _grad_err(got, ops.realnvp_stack_vjp_plain(params, x, gy, gld, 3.0, inverse)) <= TOL


@pytest.mark.parametrize("rows", [1000, 256])
def test_backward_kernel_is_deterministic(cuda, rows):
    params = _params(100, 128, 4, cuda, seed=5)
    g = torch.Generator(cuda).manual_seed(6)
    x, gy = (torch.randn((rows, 100), device=cuda, generator=g) for _ in range(2))
    gld = torch.randn((rows,), device=cuda, generator=g)
    a = ops.fused_realnvp_vjp(params, x, gy, gld, 3.0, False)
    b = ops.fused_realnvp_vjp(params, x, gy, gld, 3.0, False)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(u, v) for u, v in zip(tree_leaves(a[1]), tree_leaves(b[1])))


# ---- the spline coupling kernels (spline.cu, spline_bwd.cu) ----------------------

def _spline_params(kind, d, hidden, n_layers, n_bins, device, seed=0):
    from nfmc_torch.flows import CouplingLRS, CouplingRQNSF

    cls = CouplingRQNSF if kind == "rqs" else CouplingLRS
    flow = Flow(cls((d,), n_layers=n_layers, hidden_size=hidden, n_bins=n_bins), seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    return [{k: [(t + 0.05 * torch.randn(t.shape, generator=g)).to(device) for t in v]
             for k, v in p.items()} for p in flow.params]


SPLINE_SHAPES = [(100, 128, 4, 8, 100), (100, 128, 4, 8, 256), (100, 128, 4, 8, 3000),
                 (7, 16, 3, 4, 37), (784, 128, 4, 8, 300), (1024, 128, 4, 8, 40)]


@pytest.mark.parametrize("d,hidden,n_layers,n_bins,rows", SPLINE_SHAPES)
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("kind", ["rqs", "lrs"])
def test_spline_kernel_matches_plain(cuda, kind, inverse, d, hidden, n_layers, n_bins, rows):
    """Inputs 3 N(0, 1), so that the tails are hit; 1e-4 * max(1, max|ref|)."""
    from nfmc_torch.ops import spline as sops

    params = _spline_params(kind, d, hidden, n_layers, n_bins, cuda)
    x = 3 * torch.randn((rows, d), device=cuda, generator=torch.Generator(cuda).manual_seed(2))
    wrapper = getattr(sops, f"fused_{kind}_{'inverse' if inverse else 'forward'}")
    before = wrapper.launches
    y, ld = wrapper(params, x, n_bins, 5.0)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    y_ref, ld_ref = sops.spline_stack_plain(params, x, kind, n_bins, 5.0, inverse)
    scale = max(1.0, float(y_ref.abs().max()), float(ld_ref.abs().max()))
    assert float((y - y_ref).abs().max()) <= TOL * scale
    assert float((ld - ld_ref).abs().max()) <= TOL * scale


@pytest.mark.parametrize("d,hidden,n_layers,n_bins,rows", [(100, 128, 4, 8, 256),
                                                           (100, 128, 4, 8, 100),
                                                           (100, 128, 4, 8, 1001),
                                                           (100, 128, 4, 8, 3000),
                                                           (7, 16, 3, 4, 37),
                                                           (784, 128, 4, 8, 300),
                                                           (1024, 128, 4, 8, 40)])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("kind", ["rqs", "lrs"])
def test_spline_backward_kernel_matches_plain(cuda, kind, inverse, d, hidden, n_layers, n_bins,
                                              rows):
    """Against the autograd VJP of the plain version, to 1e-3 * max(1,
    max|ref|): the steep splines amplify rounding (chip_smoke.py phase 7b
    measures the margin). From d=784 the plain version runs in float64: its
    float32 run differs from its float64 run by more than the gate there
    (chip_smoke.py phase 7d prints it). The rule is
    ``ops.spline.compare_spline_vjp``: where the VJP misses the gate, the
    rows with an element within float32 drift of a branch point of its
    spline (the VJP jumps there) are left out by zeroing their cotangents,
    and every row of gx off the gate must be one of them."""
    from nfmc_torch.ops import spline as sops

    params = _spline_params(kind, d, hidden, n_layers, n_bins, cuda, seed=3)
    g = torch.Generator(cuda).manual_seed(4)
    x = 3 * torch.randn((rows, d), device=cuda, generator=g)
    gy = torch.randn((rows, d), device=cuda, generator=g)
    gld = torch.randn((rows,), device=cuda, generator=g)
    dt = torch.float64 if d >= 784 else torch.float32
    ref_params = [{k: [t.to(dt) for t in v] for k, v in p.items()} for p in params]

    def both(keep):
        return (sops.fused_spline_vjp(params, x, gy * keep[:, None], gld * keep, kind, n_bins,
                                      5.0, inverse),
                sops.spline_stack_vjp_plain(ref_params, x.to(dt), (gy * keep[:, None]).to(dt),
                                            (gld * keep).to(dt), kind, n_bins, 5.0, inverse))

    before = sops.fused_spline_vjp.launches
    got, want = both(torch.ones(rows, dtype=torch.bool, device=cuda))
    torch.cuda.synchronize()
    assert sops.fused_spline_vjp.launches == before + 1
    e, _, report = sops.compare_spline_vjp(got, want, both, params, x, kind, n_bins, 5.0,
                                           inverse, 1e-3)
    assert e <= 1e-3, report


@pytest.mark.parametrize("d,rows", [(100, 1000), (100, 256), (784, 300)])
@pytest.mark.parametrize("kind", ["rqs", "lrs"])
def test_spline_backward_kernel_is_deterministic(cuda, kind, d, rows):
    from nfmc_torch.ops import spline as sops

    params = _spline_params(kind, d, 128, 4, 8, cuda, seed=5)
    g = torch.Generator(cuda).manual_seed(6)
    x, gy = (torch.randn((rows, d), device=cuda, generator=g) for _ in range(2))
    gld = torch.randn((rows,), device=cuda, generator=g)
    a = sops.fused_spline_vjp(params, x, gy, gld, kind, 8, 5.0, False)
    b = sops.fused_spline_vjp(params, x, gy, gld, kind, 8, 5.0, False)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(u, v) for u, v in zip(tree_leaves(a[1]), tree_leaves(b[1])))


@pytest.mark.parametrize("kind", ["rqs", "lrs"])
def test_spline_flow_on_cuda_never_runs_the_plain_version(cuda, kind, monkeypatch):
    """Forward, inverse and a gradient of a spline flow on the card go
    through the kernels; a configuration whose shared memory does not fit
    raises and names its sizes instead of falling back."""
    from nfmc_torch.flows import CouplingLRS, CouplingRQNSF
    from nfmc_torch.ops import spline as sops

    def refuse(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(sops, "spline_stack_plain", refuse)
    monkeypatch.setattr(sops, "spline_stack_vjp_plain", refuse)
    cls = CouplingRQNSF if kind == "rqs" else CouplingLRS
    flow = Flow(cls((10,), n_layers=2, hidden_size=16), seed=0).to(cuda)
    x = torch.randn((5, 10), device=cuda).requires_grad_(True)
    z, ld = flow.bijection.forward(x)
    flow.bijection.inverse(z.detach())
    torch.autograd.grad(z.sum() + ld.sum(), x)
    wide = Flow(cls((3800,), n_layers=1, hidden_size=128), seed=0).to(cuda)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        wide.bijection.forward(torch.randn((2, 3800), device=cuda))


@pytest.mark.parametrize("rows", [128, 1024 * 100, 3135 * 100])
def test_imh_path_inverse_shapes_match_plain(cuda, rows):
    """The coupling kernel in the inverse direction at IMH's shapes:
    variational_fit's batch (128), FixedIMH's hoisted chunk at the
    north-star length (1024 iterations x 100 chains) and at the footprint
    cap (3135 x 100)."""
    params = _params(100, 128, 4, cuda)
    x = torch.randn((rows, 100), device=cuda, generator=torch.Generator(cuda).manual_seed(3))
    y, ld = ops.fused_realnvp_inverse(params, x, 3.0)
    torch.cuda.synchronize()
    y_ref, ld_ref = ops.realnvp_stack_plain(params, x, 3.0, True)
    assert bool(torch.isfinite(y).all() and torch.isfinite(ld).all())
    assert float((y - y_ref).abs().max()) <= TOL
    assert float((ld - ld_ref).abs().max()) <= TOL


def test_reverse_kl_gradient_through_the_inverse_vjp(cuda):
    """One variational_fit gradient at d=100, B=128 on the card: one inverse
    launch and one backward launch in the inverse direction, against the
    same gradient on the CPU's plain stack. The target reads x through a
    transpose, so its cotangent reaches the backward strided, and the mean
    gives the log-det an expanded cotangent."""
    from nfmc_torch.flows import train as ttrain

    def neg_u(x):
        return -0.5 * (x.t() ** 2).sum(0)

    flow = Flow(RealNVP((100,), n_layers=4, hidden_size=128), seed=0)
    flow.params = _params(100, 128, 4, "cpu")
    z = torch.randn((128, 100), generator=torch.Generator().manual_seed(4))
    grads = {}
    for device in ("cpu", cuda):
        params = [{k: [t.to(device).requires_grad_(True) for t in v] for k, v in p.items()}
                  for p in flow.params]
        before = (ops.fused_realnvp_inverse.launches, ops.fused_realnvp_vjp.launches)
        loss = ttrain._reverse_kl(flow, params, z.to(device), neg_u)
        leaves = [t for p in params for k in ("w", "b") for t in p[k]]
        grads[str(device)] = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
        after = (ops.fused_realnvp_inverse.launches, ops.fused_realnvp_vjp.launches)
        launched = tuple(a - b for a, b in zip(after, before))
        assert launched == ((0, 0) if device == "cpu" else (1, 1))
    scale = max(1.0, max(float(g.abs().max()) for g in grads["cpu"]))
    for a, b in zip(grads["cpu"], grads["cuda"]):
        assert float((a - b).abs().max()) <= TOL * scale


@pytest.mark.parametrize("rows", [30, 308, 1024])
@pytest.mark.parametrize("inverse", [False, True])
def test_flow_sampler_shapes_match_plain(cuda, rows, inverse):
    """The coupling kernel and its VJP at the shapes the flow-reparameterised
    samplers add: TESS's refit validation rows (30), DLMC's (308) and its
    1024 chains (jump_hmc's current states too)."""
    params = _params(100, 128, 4, cuda, seed=7)
    g = torch.Generator(cuda).manual_seed(8)
    x, gy = (torch.randn((rows, 100), device=cuda, generator=g) for _ in range(2))
    gld = torch.randn((rows,), device=cuda, generator=g)
    wrapper = ops.fused_realnvp_inverse if inverse else ops.fused_realnvp_forward
    y, ld = wrapper(params, x, 3.0)
    got = ops.fused_realnvp_vjp(params, x, gy, gld, 3.0, inverse)
    torch.cuda.synchronize()
    y_ref, ld_ref = ops.realnvp_stack_plain(params, x, 3.0, inverse)
    assert float((y - y_ref).abs().max()) <= TOL and float((ld - ld_ref).abs().max()) <= TOL
    assert _grad_err(got, ops.realnvp_stack_vjp_plain(params, x, gy, gld, 3.0, inverse)) <= TOL


def test_neutra_input_gradient_through_the_inverse_vjp(cuda):
    """NeuTra's gradient of U~ with respect to the latent input at d=100,
    B=100 on the card: one inverse launch and one inverse-direction VJP
    launch, against the CPU's plain stack (1e-4 of the largest), and no
    gradient left on weights that require grad."""
    from nfmc_torch.potentials import StandardGaussian
    from nfmc_torch.samplers.nfmc import NeuTraHMC, NeuTraKernel

    params = _params(100, 128, 4, "cpu", seed=9)
    z = torch.randn((100, 100), generator=torch.Generator().manual_seed(10))
    grads = {}
    for device in ("cpu", cuda):
        flow = Flow(RealNVP((100,), n_layers=4, hidden_size=128))
        flow.params = [{k: [t.detach().to(device).requires_grad_(True) for t in v]
                        for k, v in p.items()} for p in params]
        s = NeuTraHMC((100,), StandardGaussian((100,)), kernel=NeuTraKernel((100,), flow=flow),
                      device=device)
        before = (ops.fused_realnvp_inverse.launches, ops.fused_realnvp_vjp.launches)
        zd = z.to(device).requires_grad_(True)
        (grads[str(device)],) = torch.autograd.grad(s.adjusted_target(zd).sum(), zd)
        after = (ops.fused_realnvp_inverse.launches, ops.fused_realnvp_vjp.launches)
        assert tuple(a - b for a, b in zip(after, before)) == ((0, 0) if device == "cpu" else (1, 1))
        assert all(t.grad is None for p in flow.params for v in p.values() for t in v)
    want = grads["cpu"]
    assert float((grads["cuda"].cpu() - want).abs().max()) <= TOL * float(want.abs().max())
