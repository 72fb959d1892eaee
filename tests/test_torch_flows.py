"""RealNVP in nfmc_torch against nfmc_tpu on the CPU: forward, inverse,
log_prob and sampling from an injected base draw, with the JAX parameters
carried across by ``from_jax_params``."""
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

TOL = 1e-5  # float32, as tests/test_pallas.py holds the Pallas kernel to XLA

# (event_shape, n_layers, hidden, scaled). A float32 value of magnitude m is
# rounded by ~m * 6e-8 at every operation, so where outputs are far above 1
# the bound is TOL * max|reference|: at d=100, H=128, L=4 with every weight
# perturbed by 0.1 N(0, 1), |z| reaches ~50 and |log q| ~2000.
CASES = [((5,), 2, 16, False), ((8, 8), 2, 32, False), ((100,), 4, 128, True), ((7,), 3, 16, False)]


def _pair(event_shape, n_layers, hidden, seed=0):
    """A JAX flow with every parameter perturbed by 0.1 N(0, 1) (the zero
    final layer would make the flow the identity) and its port."""
    jflow = JFlow(JRealNVP(event_shape, n_layers=n_layers, hidden_size=hidden, use_pallas=False),
                  seed=seed)
    rng = np.random.default_rng(seed + 1)
    jflow.params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape).astype(np.float32), jflow.params)
    flow = Flow(RealNVP(event_shape, n_layers=n_layers, hidden_size=hidden))
    flow.params = from_jax_params(jflow.params)
    return jflow, flow


def _close(a_torch, b_jax, scaled=False):
    b = np.asarray(b_jax)
    err = float(np.max(np.abs(a_torch.numpy() - b)))
    bound = TOL * max(1.0, float(np.max(np.abs(b)))) if scaled else TOL
    assert err <= bound, (err, bound)


@pytest.mark.parametrize("event_shape,n_layers,hidden,scaled", CASES)
def test_flow_matches_jax(event_shape, n_layers, hidden, scaled):
    build.reset_launch_counts()
    jflow, flow = _pair(event_shape, n_layers, hidden)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((37, *event_shape)).astype(np.float32)
    xt = torch.from_numpy(x)

    z_j, ld_j = jflow.bijection.forward_fn(jflow.params, jnp.asarray(x))
    z_t, ld_t = flow.bijection.forward_fn(flow.params, xt)
    assert z_t.shape == xt.shape and ld_t.shape == (37,)
    _close(z_t, z_j, scaled)
    _close(ld_t, ld_j, scaled)

    y_j, ldi_j = jflow.bijection.inverse_fn(jflow.params, jnp.asarray(x))
    y_t, ldi_t = flow.bijection.inverse_fn(flow.params, xt)
    _close(y_t, y_j, scaled)
    _close(ldi_t, ldi_j, scaled)

    # log q sums d squares: ~160 at d=64, where 1e-5 is one ulp
    _close(flow.log_prob(xt), jflow.log_prob(jnp.asarray(x)), scaled=True)

    # sampling: the JAX base draw for a key, pushed through both flows
    key = jax.random.key(3)
    z = jflow.sample_base_fn(key, 11)
    xs_j, lq_j = jflow.sample_fn(jflow.params, key, 11, return_log_prob=True)
    xs_t, lq_t = flow.push_base_fn(flow.params, torch.from_numpy(np.array(z)))
    _close(xs_t, xs_j, scaled)
    _close(lq_t, lq_j, scaled=True)

    # the CPU path computes the plain version and launches nothing
    assert ops.fused_realnvp_forward.launches == 0
    assert ops.fused_realnvp_inverse.launches == 0


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


def test_plain_version_matches_pallas_kernel(interpret_pallas):
    """The port's plain version against the TPU kernel itself (interpret
    mode), odd d so the packed [even | odd] halves differ in size."""
    cp = interpret_pallas
    jflow, flow = _pair((9,), 3, 16, seed=4)
    x = np.random.default_rng(5).standard_normal((21, 9)).astype(np.float32)
    for inverse in (False, True):
        fused = cp.fused_realnvp_inverse if inverse else cp.fused_realnvp_forward
        y_j, ld_j = fused(jflow.params, jnp.asarray(x), 9, 3, 3.0)
        y_t, ld_t = ops.realnvp_stack_plain(flow.params, torch.from_numpy(x), 3.0, inverse)
        _close(y_t, y_j)
        _close(ld_t, ld_j)


def test_pack_weights_is_canonical_order():
    _, flow = _pair((7,), 2, 8)
    packed = ops.pack_weights(flow.params)
    p0 = flow.params[0]
    n_w1 = p0["w"][0].numel()
    assert torch.equal(packed[:n_w1], p0["w"][0].reshape(-1))
    assert torch.equal(packed[n_w1:n_w1 + 8], p0["b"][0])
    assert packed.numel() == flow.bijection.n_parameters()


def test_roundtrip_and_identity_init():
    flow = Flow(RealNVP((6,), n_layers=3, hidden_size=16), seed=0)
    x = torch.randn(5, 6, generator=torch.Generator().manual_seed(0))
    z, ld = flow.bijection.forward(x)
    assert torch.equal(z, x) and torch.equal(ld, torch.zeros(5))  # zero final layer
    flow.params = Flow(RealNVP((6,), n_layers=3, hidden_size=16), seed=1).state_dict()
    flow.params = [{k: [t + 0.1 for t in v] for k, v in p.items()} for p in flow.params]
    z, ld = flow.bijection.forward(x)
    x_back, ld_inv = flow.bijection.inverse(z)
    assert float((x_back - x).abs().max()) < 1e-5
    assert float((ld + ld_inv).abs().max()) < 1e-5


def test_overridden_base_needs_paired_sampler():
    flow = Flow(RealNVP((4,)), seed=0)
    flow.set_base_log_prob(lambda z: -z.pow(2).sum(-1))
    with pytest.raises(ValueError, match="paired base sampler"):
        flow.sample(3, seed=0)
