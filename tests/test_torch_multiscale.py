"""The multiscale / Glow image flows and the convolutional residual and
continuous flows in nfmc_torch against nfmc_tpu on the CPU.

Each of the 19 image flows is built by name in both packages on a (4, 4)
event (hidden_channels 4, 2 steps a level or 2 steps / layers); two more on
(8, 8) take two levels, so that the split, the factor-out and the
reassembly run. The JAX weights, moved 0.1 N(0, 1) from the init, are
carried over with ``from_jax_params`` (the level lists of step dicts, Glow's
ActNorm and 1 x 1 weights, the conv dicts). The same Hutchinson probes are
injected into both packages. Tolerances, of ``max(1, max|reference|)``:
1e-5 for the closed-form directions (the affine / shift couplings, the
conv residual series, the conv CNFs), 2e-5 for the splines, the NAF
bisections, Glow's inverse (``inv`` of the 1 x 1 weights) and the conv
residual fixed point."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import nfmc_torch.flows.multiscale as tms
import nfmc_tpu.flows.multiscale as jms
from nfmc_torch.api import registry as treg
from nfmc_torch.flows import Flow, from_jax_params
from nfmc_torch.flows.multiscale import (
    ConvolutionalFFJORD,
    ConvolutionalRNODE,
    MultiscaleFlow,
    conv2d,
)
from nfmc_torch.flows.transforms import AffineTransform
from nfmc_torch.utils import tree_leaves, tree_map
from nfmc_tpu.api import registry as jreg

IMAGE = [n for n in treg.PORTED_FLOWS if n.startswith(("ms-", "glow-", "conv-"))]
RESIDUAL = ("conv-i-resnet", "conv-resflow")


def _kw(name):
    if name in RESIDUAL:
        return {"hidden_channels": 4, "n_layers": 2}
    if name.startswith("conv-"):
        return {"hidden_channels": 4, "n_steps": 2}
    return {"hidden_channels": 4, "n_steps_per_level": 2}


def _tol(name, inverse):
    if any(k in name for k in ("rqnsf", "lrsnsf", "naf")):
        return 2e-5
    if inverse and (name.startswith("glow-") or name in RESIDUAL):
        return 2e-5
    return 1e-5


@pytest.fixture(autouse=True)
def same_probes(monkeypatch):
    """The same Rademacher probes in both packages: a function of the row's
    size and the probe count alone."""
    def probes(d, n):
        return np.random.default_rng(100 * d + n).choice([-1.0, 1.0], size=(n, d)).astype(
            np.float32)

    monkeypatch.setattr(jms, "hutchinson_probes", lambda v, n, base_key=None, dtype=None:
                        jnp.asarray(probes(v.shape[-1], n)))
    monkeypatch.setattr(tms, "hutchinson_probes", lambda v, n, key=None: torch.from_numpy(
        probes(v.shape[-1], n)).to(v.dtype).expand(*v.shape[:-1], n, v.shape[-1]))


def _pair(name, shape, seed=3, scale=0.1, **kw):
    kw = {**_kw(name), **kw}
    jflow = jreg.create_flow_object(name, shape, seed=seed, **kw)
    rng = np.random.default_rng(seed + 2)
    jflow.params = jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + scale * rng.standard_normal(np.shape(p)).astype(np.float32), jflow.params)
    flow = treg.create_flow_object(name, shape, seed=0, **kw)
    flow.params = from_jax_params(jflow.params)
    return jflow, flow


def _x(shape, n=4, seed=2):
    return (1.2 * np.random.default_rng(seed).standard_normal((n, *shape))).astype(np.float32)


def _close(want, got, tol):
    want = np.asarray(want)
    scale = max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(want - got.detach().numpy())))
    assert err <= tol * scale, (err, tol * scale)


def _check(name, shape):
    jflow, flow = _pair(name, shape)
    x = _x(shape)
    jz, jld = jax.jit(jflow.bijection.forward_fn)(jflow.params, jnp.asarray(x))
    jx, jld_inv = jax.jit(jflow.bijection.inverse_fn)(jflow.params, jz)
    z, ld = flow.bijection.forward_fn(flow.params, torch.from_numpy(x))
    x_back, ld_inv = flow.bijection.inverse_fn(flow.params, torch.from_numpy(np.array(jz)))
    for want, got, inverse in ((jz, z, False), (jld, ld, False), (jx, x_back, True),
                               (jld_inv, ld_inv, True)):
        _close(want, got, _tol(name, inverse))
    assert z.shape == x.shape and ld.shape == (len(x),)
    # DDB's Euler steps run backward are its inverse to O(h) only
    x_rt, _ = flow.bijection.inverse_fn(flow.params, z)
    assert float((x_rt - torch.from_numpy(x)).abs().max()) <= (0.1 if name == "conv-ddb" else 1e-4)


@pytest.mark.parametrize("name", IMAGE)
def test_flow_matches_jax(name):
    """Forward, inverse (of the JAX latent) and the round trip on (4, 4)."""
    _check(name, (4, 4))


@pytest.mark.parametrize("name", ["ms-realnvp", "glow-rqnsf"])
def test_two_levels_match_jax(name):
    """On (8, 8) the automatic rule takes 2 levels: the factor-out of half
    the channels and the reassembly in the JAX order."""
    assert treg.create_flow_object(name, (8, 8), seed=0, hidden_channels=4).bijection.n_levels == 2
    _check(name, (8, 8))


@pytest.mark.parametrize("shape,n_levels", [((8, 8), None), ((16, 16), None), ((12, 8), None),
                                            ((3, 8, 8), None), ((4, 4), 2), ((2, 6), None),
                                            ((8, 8), 3), ((6, 6), 2), ((5, 4), None), ((4,), None)])
def test_level_rule_and_construction_errors_match_jax(shape, n_levels):
    """The automatic ``n_levels`` rule, the per-level channel bookkeeping and
    the construction-time ``ValueError`` s."""
    def build(mod, cls_name):
        try:
            b = getattr(mod, cls_name)(shape, n_levels=n_levels)
        except ValueError:
            return "ValueError"
        return b.n_levels, b.level_channels

    assert build(tms, "MultiscaleRealNVP") == build(jms, "MultiscaleRealNVP")


def test_conv2d_is_the_same_cross_correlation_as_f_conv2d():
    """The shifted-views-and-matmul convolution equals ``F.conv2d`` with SAME
    padding (on the CPU, where F.conv2d is full float32), 3 x 3 and 1 x 1."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 5, 6, 4), generator=g)
    for k in (3, 1):
        w = torch.randn((7, 5, k, k), generator=g)
        assert torch.allclose(conv2d(w, x), F.conv2d(x, w, padding=k // 2), atol=1e-5)


def test_from_jax_params_carries_the_image_trees():
    """Glow's list of per-level lists of step dicts, with the conditioner's
    conv dict inside, arrives as the same structure of float32 tensors."""
    jflow, flow = _pair("glow-realnvp", (8, 8))
    assert isinstance(flow.params, list) and len(flow.params) == 2
    step = flow.params[1][0]
    assert set(step) == {"conv", "actnorm_log_s", "actnorm_b", "conv1x1_w"}
    assert set(step["conv"]) == {"w1", "b1", "w2", "b2", "w3", "b3"}
    assert all(t.dtype == torch.float32 for t in tree_leaves(flow.params))
    assert flow.bijection.n_parameters() == sum(
        np.size(p) for p in jax.tree_util.tree_leaves(jflow.params))
    _, conv = _pair("conv-ffjord", (4, 4))
    assert set(conv.params) == {"w1", "b1", "w2", "b2"} and conv.params["w1"].shape == (4, 2, 3, 3)


@pytest.mark.parametrize("name", ["ms-realnvp", "glow-realnvp", "glow-rqnsf", "ms-naf-deep",
                                  "conv-ffjord"])
def test_log_det_matches_the_autograd_jacobian(name):
    """The forward log-det of two images against slogdet of the map's
    Jacobian, in float64. Exact for the couplings; the conv CNF's integrated
    trace differs from its RK4 map's Jacobian by O(h^4)
    (``tests/test_flow_zoo.py:133`` gates it at 5e-2)."""
    _, flow = _pair(name, (4, 4), scale=0.05)
    params = tree_map(lambda t: t.double(), flow.params)
    x = torch.from_numpy(_x((4, 4), 2, seed=6)).double() * 0.5
    _, ld = flow.bijection.forward_fn(params, x)
    tol = 5e-2 if name == "conv-ffjord" else 1e-8
    for i in range(2):
        J = torch.autograd.functional.jacobian(
            lambda v: flow.bijection.forward_fn(params, v[None])[0][0], x[i]).reshape(16, 16)
        assert abs(float(torch.linalg.slogdet(J)[1] - ld[i])) <= tol


def test_conv_cnf_trace_path_matches_jax():
    """Above ``exact_trace_dim`` (here 0) the conv CNF takes Hutchinson's
    trace with one VJP a probe, in both packages with the same probes."""
    jflow, flow = _pair("conv-ffjord", (4, 4), exact_trace_dim=0, n_probes=3)
    x = _x((4, 4))
    jz, jld = jax.jit(jflow.bijection.forward_fn)(jflow.params, jnp.asarray(x))
    z, ld = flow.bijection.forward_fn(flow.params, torch.from_numpy(x))
    _close(jz, z, 1e-5)
    _close(jld, ld, 1e-5)


def test_conv_rnode_trains_differently_from_conv_ffjord():
    """``tests/test_flow_zoo.py:236``: the conv kinetic term is live in
    ``fit``, and equals the JAX package's at the same weights."""
    x = np.random.default_rng(0).standard_normal((8, 4, 4)).astype(np.float32)

    def train(cls):
        f = Flow(cls((4, 4), hidden_channels=4, n_steps=2), seed=0)
        f.fit(x, n_epochs=2, batch_size=8, shuffle=False, seed=1)
        return tree_leaves(f.params)

    assert ConvolutionalRNODE.regularization_weight == 0.01
    assert max(float((a - b).abs().max())
               for a, b in zip(train(ConvolutionalFFJORD), train(ConvolutionalRNODE))) > 1e-6
    jflow, flow = _pair("conv-rnode", (4, 4))
    want = jflow.bijection.regularization(jflow.params, jnp.asarray(x))
    _close(want, flow.bijection.regularization(flow.params, torch.from_numpy(x)), 1e-5)


def test_glow_at_its_init_is_orthogonal_and_batch_shapes_pass():
    """At its init a Glow flow is orthogonal: the squeezes permute, the
    1 x 1 weights are orthogonal, the couplings start at the identity; so
    each image keeps its norm and the log-det is 0. Any batch shape passes
    through and back."""
    bij = MultiscaleFlow((3, 4, 4), AffineTransform(), glow=True, hidden_channels=4)
    flow = Flow(bij, seed=0)
    x = torch.randn((2, 3, 3, 4, 4), generator=torch.Generator().manual_seed(1))
    z, ld = bij.forward_fn(flow.params, x)
    assert z.shape == x.shape and ld.shape == (2, 3)
    norms = [v.reshape(2, 3, -1).norm(dim=-1) for v in (z, x)]
    assert torch.allclose(*norms, atol=1e-5) and float(ld.abs().max()) <= 1e-5
    x_back, ld_back = bij.inverse_fn(flow.params, z)
    assert float((x_back - x).abs().max()) <= 1e-5 and float(ld_back.abs().max()) <= 1e-5
