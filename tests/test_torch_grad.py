"""The coupling stack's VJP in nfmc_torch on the CPU: the plain version of
the backward kernel (``realnvp_stack_vjp_plain``) against torch autograd
through the plain forward and against nfmc_tpu's Pallas backward kernel
itself (interpret mode), and the ``RealNVPStack`` Function's wiring.

Tolerance 1e-5 (float32) relative to max(1, max|reference|): the gradients
sum up to B products per weight, so where they are far above 1 the bound
scales with them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfmc_tpu.flows import Flow as JFlow
from nfmc_tpu.flows import RealNVP as JRealNVP
from nfmc_torch.flows import Flow, RealNVP, from_jax_params
from nfmc_torch.ops import build
from nfmc_torch.ops import coupling as ops
from nfmc_torch.utils import tree_leaves, tree_unflatten

TOL = 1e-5


def _pair(d, n_layers, hidden, seed=0, scale=0.1):
    jflow = JFlow(JRealNVP((d,), n_layers=n_layers, hidden_size=hidden, use_pallas=False), seed=seed)
    rng = np.random.default_rng(seed + 1)
    jflow.params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + scale * rng.standard_normal(p.shape).astype(np.float32),
        jflow.params)
    return jflow, from_jax_params(jflow.params)


def _inputs(n, d, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


def _assert_close(got, want):
    want = np.asarray(want)
    err = float(np.max(np.abs(np.asarray(got) - want)))
    bound = TOL * max(1.0, float(np.max(np.abs(want))))
    assert err <= bound, (err, bound)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("d,n_layers,hidden,n", [(6, 2, 8, 5), (9, 3, 16, 21), (100, 4, 128, 7)])
def test_plain_vjp_matches_autograd(inverse, d, n_layers, hidden, n):
    _, params = _pair(d, n_layers, hidden)
    params = [{k: [t.requires_grad_(True) for t in v] for k, v in p.items()} for p in params]
    x, gy, gld = (torch.from_numpy(a) for a in _inputs(n, d))
    x.requires_grad_(True)
    y, ld = ops.realnvp_stack_plain(params, x, 3.0, inverse)
    want = torch.autograd.grad((y * gy).sum() + (ld * gld).sum(), [x, *tree_leaves(params)])
    with torch.no_grad():
        gx, grads = ops.realnvp_stack_vjp_plain(params, x, gy, gld, 3.0, inverse)
    for g, w in zip([gx, *tree_leaves(grads)], want):
        assert g.shape == w.shape
        _assert_close(g, w)


@pytest.fixture()
def interpret_pallas(monkeypatch):
    import jax.experimental.pallas as pl

    import nfmc_tpu.ops.coupling_pallas as cp

    orig = pl.pallas_call

    def interp_call(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(cp.pl, "pallas_call", interp_call)
    return cp


@pytest.mark.parametrize("inverse", [False, True])
def test_plain_vjp_matches_pallas_backward_kernel(interpret_pallas, inverse):
    """Odd d (the packed halves differ in size) and B = 20 over row blocks
    of 8, so the TPU kernel accumulates across blocks and zero-pads the
    tail, as ``tests/test_pallas.py`` drives it."""
    cp = interpret_pallas
    d, n_layers = 9, 3
    jflow, params = _pair(d, n_layers, 16, seed=4)
    x, gy, gld = _inputs(20, d, seed=5)
    pack, unpack = cp._perm(d)
    gx_j, gflat = cp._fused_bwd_call(
        jnp.take(jnp.asarray(x), pack, axis=-1), jnp.take(jnp.asarray(gy), pack, axis=-1),
        jnp.asarray(gld), cp._flatten_weights(jflow.params), n_layers, 3.0, inverse, block_b=8)
    gparams_j = cp._unflatten_weight_grads(gflat, jflow.params)
    gx_t, grads_t = ops.realnvp_stack_vjp_plain(
        params, *(torch.from_numpy(a) for a in (x, gy, gld)), 3.0, inverse)
    _assert_close(gx_t.numpy(), jnp.take(gx_j, unpack, axis=-1))
    for l in range(n_layers):
        for k in ("w", "b"):
            for got, want in zip(grads_t[l][k], gparams_j[l][k]):
                _assert_close(got.numpy(), want)


def test_function_gradcheck_float64():
    """``torch.autograd.gradcheck`` of the Function in float64 on a tiny
    stack, both directions, gradients in x and every weight."""
    flow = Flow(RealNVP((5,), n_layers=3, hidden_size=6), seed=0)
    g = torch.Generator().manual_seed(0)
    params = [{k: [(t + 0.3 * torch.randn(t.shape, generator=g)).double().requires_grad_(True)
                   for t in v] for k, v in p.items()} for p in flow.params]
    leaves = tree_leaves(params)
    x = torch.randn(4, 5, generator=g, dtype=torch.float64, requires_grad=True)
    for fn in (ops.fused_realnvp_forward, ops.fused_realnvp_inverse):
        def f(x, *lv):
            return fn(tree_unflatten(params, lv), x, 3.0)

        assert torch.autograd.gradcheck(f, (x, *leaves))


def test_flow_is_differentiable_through_the_function():
    """``Flow.log_prob_fn`` goes through ``RealNVPStack`` when the weights
    need a gradient; on the CPU its backward is the plain VJP, which gives
    autograd's gradient and launches nothing."""
    build.reset_launch_counts()
    _, params = _pair(7, 3, 16, seed=6)
    flow = Flow(RealNVP((7,), n_layers=3, hidden_size=16))
    x = torch.from_numpy(_inputs(11, 7)[0])
    theta = torch.cat([t.reshape(-1) for t in tree_leaves(params)]).requires_grad_(True)
    lp = flow.log_prob_fn(ops.unpack_like(theta, params), x)
    assert lp.grad_fn is not None
    (g,) = torch.autograd.grad(lp.sum(), theta)
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(params)]
    p2 = tree_unflatten(params, leaves)
    z, ld = ops.realnvp_stack_plain(p2, x, 3.0, False)
    lp2 = flow.base_log_prob_fn(z) + ld
    want = torch.cat([t.reshape(-1) for t in torch.autograd.grad(lp2.sum(), leaves)])
    _assert_close(g.numpy(), want.numpy())
    assert all(w.launches == 0 for w in build.WRAPPERS)
