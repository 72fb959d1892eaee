"""The coupling spline flows in nfmc_torch (``CouplingRQNSF``, ``c-rqnsf``;
``CouplingLRS``, ``c-lrsnsf``) against nfmc_tpu on the CPU, with the same
numpy weights carried across by ``from_jax_params``: the plain version of
the forward kernel (``spline_stack_plain``) against the JAX XLA flow and
against the Pallas kernel itself (interpret mode); the plain VJP
(``spline_stack_vjp_plain``) against ``jax.grad`` and the Pallas backward
kernel; the ``SplineStack`` Function's wiring; sampling from a base draw;
and the self-target check.

Tolerances, relative to max(1, max|reference|):
* values 2e-5: float32, the same terms in another order (a float32 value of
  magnitude m rounds by ~m * 6e-8 an operation), amplified by the slopes of
  the splines at a weight perturbation of 0.1;
* gradients 5e-4 at a perturbation of 0.1: the JAX package measured two
  exact paths 2e-4 apart there (``tests/test_pallas.py:175-180``), the
  steepness of the splines amplifying rounding;
* the round trip 5e-4 absolute, as the JAX package holds its own
  (``tests/test_pallas.py:217-222``): the RQS inverse solves a quadratic.
Inputs are 4 N(0, 1), so that both tails and every bin are hit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfmc_tpu.flows import CouplingLRS as JCouplingLRS
from nfmc_tpu.flows import CouplingRQNSF as JCouplingRQNSF
from nfmc_tpu.flows import Flow as JFlow
from nfmc_torch.flows import CouplingLRS, CouplingRQNSF, Flow, from_jax_params
from nfmc_torch.ops import build
from nfmc_torch.ops import coupling as cops
from nfmc_torch.ops import spline as ops
from nfmc_torch.utils import tree_leaves

TOL = 2e-5
GRAD_TOL = 5e-4
KINDS = {"rqs": (JCouplingRQNSF, CouplingRQNSF), "lrs": (JCouplingLRS, CouplingLRS)}
# (event_shape, n_layers, hidden, n_bins)
CASES = [((6,), 2, 16, 8), ((9,), 3, 16, 4), ((4, 4), 2, 16, 8)]


def _pair(kind, event_shape, n_layers, hidden, n_bins, pert=0.1, seed=0):
    """A JAX spline flow with every parameter perturbed by pert N(0, 1)
    (numpy; at zero init the flow is the identity) and its port."""
    jcls, tcls = KINDS[kind]
    jflow = JFlow(jcls(event_shape, n_layers=n_layers, hidden_size=hidden, n_bins=n_bins,
                       use_pallas=False), seed=seed)
    rng = np.random.default_rng(seed + 1)
    jflow.params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + pert * rng.standard_normal(p.shape).astype(np.float32),
        jflow.params)
    flow = Flow(tcls(event_shape, n_layers=n_layers, hidden_size=hidden, n_bins=n_bins))
    flow.params = from_jax_params(jflow.params)
    return jflow, flow


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    err = float(np.max(np.abs(np.asarray(got) - want)))
    bound = tol * max(1.0, float(np.max(np.abs(want))))
    assert err <= bound, (err, bound)


def _x(n, event_shape, seed=2):
    return (4.0 * np.random.default_rng(seed).standard_normal((n, *event_shape))).astype(np.float32)


@pytest.mark.parametrize("event_shape,n_layers,hidden,n_bins", CASES)
@pytest.mark.parametrize("kind", ["rqs", "lrs"])
def test_flow_matches_jax(kind, event_shape, n_layers, hidden, n_bins):
    """Forward, inverse and log_prob of the flow, and the plain stack on
    the flattened rows, against the JAX XLA flow; the CPU path launches no
    kernel."""
    build.reset_launch_counts()
    jflow, flow = _pair(kind, event_shape, n_layers, hidden, n_bins)
    x = _x(37, event_shape)
    xt = torch.from_numpy(x)
    assert float(np.mean(np.abs(x) > 5.0)) > 0.1  # both tails are hit
    for inverse in (False, True):
        jfn = jflow.bijection.inverse_fn if inverse else jflow.bijection.forward_fn
        tfn = flow.bijection.inverse_fn if inverse else flow.bijection.forward_fn
        y_j, ld_j = jfn(jflow.params, jnp.asarray(x))
        y_t, ld_t = tfn(flow.params, xt)
        assert y_t.shape == xt.shape and ld_t.shape == (37,)
        _close(y_t, y_j)
        _close(ld_t, ld_j)
        y_p, ld_p = ops.spline_stack_plain(flow.params, xt.reshape(37, -1), kind, n_bins, 5.0,
                                           inverse)
        assert torch.equal(y_p.reshape(xt.shape), y_t) and torch.equal(ld_p, ld_t)
    _close(flow.log_prob(xt), jflow.log_prob(jnp.asarray(x)))
    assert all(w.launches == 0 for w in build.WRAPPERS)


@pytest.mark.parametrize("kind", ["rqs", "lrs"])
def test_push_base_matches_jax_sampling(kind):
    """The JAX base draw for a key, pushed through both flows."""
    jflow, flow = _pair(kind, (6,), 2, 16, 8, seed=3)
    key = jax.random.key(4)
    z = jflow.sample_base_fn(key, 11)
    x_j, lq_j = jflow.sample_fn(jflow.params, key, 11, return_log_prob=True)
    x_t, lq_t = flow.push_base_fn(flow.params, torch.from_numpy(np.array(z)))
    _close(x_t, x_j)
    _close(lq_t, lq_j)


@pytest.fixture()
def interpret_spline(monkeypatch):
    import jax.experimental.pallas as pl

    import nfmc_tpu.ops.experimental_spline_pallas as sp

    orig = pl.pallas_call

    def interp_call(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(sp.pl, "pallas_call", interp_call)
    return sp


@pytest.mark.parametrize("kind", ["rqs", "lrs"])
def test_plain_stack_matches_pallas_kernel(interpret_spline, kind):
    """The port's plain version against the TPU kernel itself (interpret
    mode), odd d so that the kernel's packed [even | odd] halves differ in
    size."""
    sp = interpret_spline
    jflow, flow = _pair(kind, (9,), 2, 16, 8, seed=5)
    x = _x(21, (9,), seed=6)
    for inverse in (False, True):
        fused = getattr(sp, f"fused_{kind}_{'inverse' if inverse else 'forward'}")
        y_j, ld_j = fused(jflow.params, jnp.asarray(x), 9, 2, 8, 5.0)
        y_t, ld_t = ops.spline_stack_plain(flow.params, torch.from_numpy(x), kind, 8, 5.0,
                                           inverse)
        _close(y_t, y_j)
        _close(ld_t, ld_j)


@pytest.mark.parametrize("kind", ["rqs", "lrs"])
def test_roundtrip_and_identity_init(kind):
    flow = Flow(KINDS[kind][1]((6,), n_layers=3, hidden_size=16, n_bins=8), seed=0)
    x = torch.from_numpy(_x(9, (6,), seed=7))
    z, ld = flow.bijection.forward(x)
    # zero final layer: uniform bins, unit derivatives, the identity
    assert float((z - x).abs().max()) <= 1e-5 and float(ld.abs().max()) <= 1e-5
    _, pert = _pair(kind, (6,), 3, 16, 8, seed=8)
    z, ld = pert.bijection.forward(x)
    assert float((z - x).abs().max()) > 0.1  # the perturbed flow is not the identity
    x_back, ld_inv = pert.bijection.inverse(z)
    assert float((x_back - x).abs().max()) < 5e-4
    assert float((ld + ld_inv).abs().max()) < 5e-4


def _cotangents(n, d, seed=9):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("kind", ["rqs", "lrs"])
def test_plain_vjp_matches_jax_grad(kind, inverse):
    """``spline_stack_vjp_plain`` against ``jax.grad`` of the XLA flow, for
    the input and every weight, at a weight perturbation of 0.1."""
    jflow, flow = _pair(kind, (9,), 2, 16, 8, seed=10)
    x = _x(13, (9,), seed=11)
    gy, gld = _cotangents(13, 9)
    fn = jflow.bijection.inverse_fn if inverse else jflow.bijection.forward_fn

    def loss(params, xx):
        y, ld = fn(params, xx)
        return jnp.sum(y * gy) + jnp.sum(ld * gld)

    gp_j, gx_j = jax.grad(loss, argnums=(0, 1))(jflow.params, jnp.asarray(x))
    gx_t, gp_t = ops.spline_stack_vjp_plain(flow.params, torch.from_numpy(x),
                                            torch.from_numpy(gy), torch.from_numpy(gld), kind,
                                            8, 5.0, inverse)
    _close(gx_t, gx_j, GRAD_TOL)
    for got, want in zip(tree_leaves(gp_t), tree_leaves(from_jax_params(gp_j))):
        assert got.shape == want.shape
        _close(got, want, GRAD_TOL)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("kind", ["rqs", "lrs"])
def test_plain_vjp_matches_pallas_backward_kernel(interpret_spline, kind, inverse):
    """Against ``_fused_bwd_call`` (the TPU backward kernel, interpret mode),
    odd d and B = 20 over row blocks of 8 (a partial last block)."""
    sp = interpret_spline
    from nfmc_tpu.ops.coupling_pallas import _perm

    jflow, flow = _pair(kind, (9,), 2, 16, 4, seed=12)
    x = _x(20, (9,), seed=13)
    gy, gld = _cotangents(20, 9, seed=14)
    n_par = (3 if kind == "rqs" else 4) * 4 - 1
    pack, unpack = _perm(9)
    gx_p, gflat = sp._fused_bwd_call(
        jnp.take(jnp.asarray(x), pack, axis=-1), jnp.take(jnp.asarray(gy), pack, axis=-1),
        jnp.asarray(gld), sp._flatten_weights(jflow.params, n_par), 2, 4, 5.0, inverse, kind,
        block_b=8)
    gp_j = sp._unflatten_weight_grads(gflat, jflow.params, n_par)
    gx_t, gp_t = ops.spline_stack_vjp_plain(flow.params, torch.from_numpy(x),
                                            torch.from_numpy(gy), torch.from_numpy(gld), kind,
                                            4, 5.0, inverse)
    _close(gx_t, jnp.take(gx_p, unpack, axis=-1), GRAD_TOL)
    for got, want in zip(tree_leaves(gp_t), tree_leaves(from_jax_params(gp_j))):
        _close(got, want, GRAD_TOL)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("kind", ["rqs", "lrs"])
def test_spline_stack_gradcheck(kind, inverse):
    """``SplineStack`` in float64: its backward (the plain VJP on the CPU)
    against finite differences, in the input and every weight."""
    _, flow = _pair(kind, (4,), 2, 4, 3, pert=0.3, seed=15)
    leaves = [t.double().requires_grad_(True) for t in tree_leaves(flow.params)]
    x = torch.from_numpy(_x(3, (4,), seed=16) / 2).double().requires_grad_(True)

    def fn(x, *leaves):
        return ops.SplineStack.apply(x, None, kind, 3, 5.0, inverse, flow.params, *leaves)

    assert torch.autograd.gradcheck(fn, (x, *leaves), eps=1e-6, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("kind", ["rqs", "lrs"])
def test_gradient_goes_through_spline_stack(kind):
    """A flow's loss gradient runs ``SplineStack``'s backward, and on the
    CPU the plain VJP, never a kernel."""
    build.reset_launch_counts()
    _, flow = _pair(kind, (6,), 2, 16, 8, seed=17)
    x = torch.from_numpy(_x(5, (6,), seed=18)).requires_grad_(True)
    z, ld = getattr(ops, f"fused_{kind}_forward")(flow.params, x, 8, 5.0)
    assert type(z.grad_fn).__name__ == "SplineStackBackward"
    z, ld = flow.bijection.forward(x)
    (gx,) = torch.autograd.grad((z * z).sum() + ld.sum(), x)
    xc = x.detach().requires_grad_(True)
    zc, ldc = ops.spline_stack_plain(flow.params, xc, kind, 8, 5.0, False)
    (want,) = torch.autograd.grad((zc * zc).sum() + ldc.sum(), xc)
    assert torch.equal(gx, want)
    assert all(w.launches == 0 for w in build.WRAPPERS)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("kind", ["rqs", "lrs"])
def test_vjp_rule_leaves_out_only_a_row_at_a_branch_point(kind, inverse):
    """``compare_spline_vjp`` excuses a VJP off the gate only by leaving
    out the rows in which ``knot_witness`` finds an element within float32
    drift of a branch point: rows 0-2 have an input set onto an interior
    knot of the first layer applied. An error in row 1 is excused; the same
    error in row 3, which has no such element, is not, nor are three rows
    off of 200 (at most one in 100)."""
    _, flow = _pair(kind, (6,), 2, 16, 8)
    params = [{k: [t.double() for t in v] for k, v in p.items()} for p in flow.params]
    x = torch.from_numpy(_x(200, (6,))).double()
    found = []
    ops.spline_stack_plain(params, x, kind, 8, 5.0, inverse, found)
    l, b, s = found[0]
    for r in range(3):  # knot 3 of dim b[r], which depends on the other half only
        x[r, b[r]] = x[r, b[r]] - s[r, r, 3]
    x = x.float()
    dist, drift, layer, dim = ops.knot_witness(flow.params, x, kind, 8, 5.0, inverse)
    for r in range(3):
        assert float(dist[r]) <= float(drift[r]) and int(layer[r]) == l and int(dim[r]) == int(b[r])
    assert int((dist <= drift).sum()) <= 5
    gy, gld = (torch.from_numpy(a) for a in _cotangents(200, 6))

    def plain(keep):
        return ops.spline_stack_vjp_plain(flow.params, x, gy * keep[:, None], gld * keep, kind, 8,
                                          5.0, inverse)

    want = plain(torch.ones(200, dtype=torch.bool))

    def off_in(rows):
        gx = want[0].clone()
        gx[rows] += 1.0
        return ops.compare_spline_vjp((gx, want[1]), want, lambda keep: (plain(keep), plain(keep)),
                                      flow.params, x, kind, 8, 5.0, inverse, GRAD_TOL)

    e, _, report = off_in([1])
    assert e == 0.0 and "row 1:" in report and "without them" in report
    assert off_in([0, 1])[0] == 0.0
    assert off_in([3])[0] == float("inf")
    assert off_in([0, 1, 2])[0] == float("inf")


def test_from_jax_params_carries_spline_weights():
    """The layout is canonical on both sides: W3 is (H, P db), dim-major."""
    jflow, flow = _pair("lrs", (7,), 2, 16, 4)
    for jp, tp in zip(jflow.params, flow.params):
        for k in ("w", "b"):
            for a, b in zip(jp[k], tp[k]):
                assert b.dtype == torch.float32 and np.array_equal(np.asarray(a), b.numpy())
    assert flow.params[0]["w"][2].shape == (16, 15 * 3)  # P = 4 K - 1 = 15, db = 3
    assert cops.pack_weights(flow.params).numel() == flow.bijection.n_parameters()


def test_kernel_launcher_names_the_shared_memory_it_needs():
    """The launcher counts its own bytes (nfmc_spline{,_vjp}_tile_bytes;
    tests/test_torch_kernels_host.py runs it); the wrapper turns its
    refusals into errors that name the bytes or the raw values a dim."""

    class Lib:
        def nfmc_spline_tile_bytes(self, d, hidden):
            return 1000 * d + hidden

        nfmc_spline_vjp_tile_bytes = nfmc_spline_tile_bytes

    ops._check_launch(0, "lrs", 8, 100, 128, True, Lib())  # accepted
    for backward in (False, True):
        with pytest.raises(ValueError, match="needs 4000128 bytes of shared memory"):
            ops._check_launch(cops.TILE_TOO_LARGE, "lrs", 8, 4000, 128, backward, Lib())
    with pytest.raises(ValueError, match="at most 128 raw values a dim, got 131"):
        ops._check_launch(ops.INVALID_VALUE, "rqs", 44, 100, 128, False, Lib())
    with pytest.raises(RuntimeError, match="cudaError 2"):
        ops._check_launch(2, "rqs", 8, 100, 128, False, Lib())
    with pytest.raises(ValueError, match="unknown spline kind"):
        ops.fused_spline_vjp(None, torch.zeros(1, 2), torch.zeros(1, 2), torch.zeros(1),
                             "cubic", 8, 5.0, False)


@pytest.mark.parametrize("kind", ["rqs", "lrs"])
def test_self_target_jump_accepts_every_proposal(kind):
    """A frozen perturbed spline flow as both the jump proposal and the
    target, U = -log q: the Metropolis ratio of a jump is 1 when the
    forward, inverse and log-det agree, so every jump is accepted."""
    import nfmc_torch
    from nfmc_torch.potentials import CallablePotential

    _, flow = _pair(kind, (6,), 2, 16, 8, pert=0.05, seed=19)
    frozen = flow.state_dict()
    target = CallablePotential(lambda x: -flow.log_prob_fn(frozen, x), (6,))
    out = nfmc_torch.sample(target, strategy="jump_mala", flow=flow, n_chains=16,
                            n_iterations=6, inner_param_kwargs={"n_iterations": 2},
                            device="cpu", seed=0, show_progress=False)
    assert out.statistics.jump_acceptance_rate >= 0.99
    assert 0.0 < out.statistics.acceptance_rate < 1.0  # MALA moves the chains
    assert torch.isfinite(out.samples).all()


def _lrs_zero_denominator(inverse, discarded, n_bins=8, tail=5.0):
    """Raw conditioner outputs ``(1, 4 K - 1)`` and one input ``(1,)`` (x
    forward, y inverse) of the LRS transform where segment ``discarded`` (1
    or 2) of the input's bin is not the one taken and its denominator
    (``d_1 ** 2 w`` or ``d_2 ** 2 w``) is exactly 0 in float32, the other
    segment's terms taken at the input's phi: float32 neighbours of the
    root of that denominator, over numpy-seeded conditioner outputs."""
    from nfmc_torch.flows import spline as sp

    rng = np.random.default_rng(17)
    K = n_bins
    for _ in range(2000):
        raw = torch.from_numpy(rng.standard_normal((1, 4 * K - 1)).astype(np.float32))
        cumw, cumh = sp._make_knots(raw[..., :K], raw[..., K:2 * K], K, tail)
        derivs = sp._derivs(raw[..., 2 * K:3 * K - 1])
        lams = 0.025 + 0.95 * torch.sigmoid(raw[..., 3 * K - 1:])
        for k in range(K):
            x0, w = cumw[0, k], cumw[0, k + 1] - cumw[0, k]
            ya, h = cumh[0, k], cumh[0, k + 1] - cumh[0, k]
            yb = ya + h  # as the transform forms it, which may round off the knot
            d0, d1, lam = derivs[0, k], derivs[0, k + 1], lams[0, k]
            wb = torch.sqrt(d0 / d1)
            wc = (lam * d0 + (1.0 - lam) * wb * d1) / (h / w)
            yc = ((1.0 - lam) * ya + lam * wb * yb) / ((1.0 - lam) + lam * wb)
            # d_1 = (lam - phi) + wc phi vanishes beyond lam, d_2 = wc (1 -
            # phi) + wb (phi - lam) before it
            root = lam / (1.0 - wc) if discarded == 1 else (wb * lam - wc) / (wb - wc)
            if not (lam < root < 1.0 if discarded == 1 else 0.0 < root < lam):
                continue
            x_root = (x0 + w * root).reshape(1)
            centre = (sp.linear_rational_spline(x_root, raw, False)[0] if inverse else x_root)
            bits = centre.numpy().view(np.int32) + np.arange(-3000, 3000, dtype=np.int32)
            v = torch.from_numpy(bits.view(np.float32).copy())
            if inverse:
                # the inverse's phi in the segment taken
                if discarded == 1:
                    phi = ((wc * (v - yc) + lam * wb * (yb - v))
                           / (wc * (v - yc) + wb * (yb - v))).clamp(0.0, 1.0)
                else:
                    phi = (lam * (v - ya) / ((v - ya) - wc * (v - yc))).clamp(0.0, 1.0)
                taken = (v > yc) if discarded == 1 else (v <= yc)
                in_bin = (v >= ya) & (v < cumh[0, k + 1])
            else:
                phi = (v - x0) / w
                taken = (phi > lam) if discarded == 1 else (phi <= lam)
                in_bin = (v >= x0) & (v < cumw[0, k + 1])
            den = ((lam - phi) + wc * phi if discarded == 1
                   else wc * (1.0 - phi) + wb * (phi - lam))
            hit = (den * den * w == 0) & taken & in_bin
            if hit.any():
                i = int(hit.nonzero()[0, 0])
                return raw, v[i:i + 1]
    raise AssertionError("no input with a vanishing denominator found")


@pytest.mark.parametrize("discarded", [1, 2])
@pytest.mark.parametrize("inverse", [False, True])
def test_lrs_vjp_is_finite_where_the_discarded_segment_divides_by_zero(inverse, discarded):
    """Where the LRS segment not taken has a denominator of exactly 0 at the
    input's phi, the transform's VJP is finite (the JAX package's, which
    evaluates both segments at that phi, is NaN there, and a batch holding
    such an element spread NaN into every weight gradient of the plain
    spline VJP): the values equal the JAX package's (TOL) and
    the gradients in the input and the raw outputs equal the float64
    ones (1e-4 relative)."""
    from nfmc_torch.flows.spline import linear_rational_spline
    from nfmc_tpu.flows.spline import linear_rational_spline as jax_lrs

    raw, v = _lrs_zero_denominator(inverse, discarded)
    y_j, ld_j = jax_lrs(jnp.asarray(v.numpy()), jnp.asarray(raw.numpy()), inverse)

    def grads(dtype):
        vv, rr = v.to(dtype).requires_grad_(True), raw.to(dtype).requires_grad_(True)
        y, ld = linear_rational_spline(vv, rr, inverse)
        return (y, ld, *torch.autograd.grad(y.sum() + ld.sum(), (vv, rr)))

    y, ld, gv, graw = grads(torch.float32)
    _close(y.detach(), y_j)
    _close(ld.detach(), ld_j)
    assert bool(torch.isfinite(gv).all() and torch.isfinite(graw).all())
    _, _, gv64, graw64 = grads(torch.float64)
    _close(gv, gv64, 1e-4)
    _close(graw, graw64, 1e-4)
