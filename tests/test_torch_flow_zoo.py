"""The masked, neural-autoregressive and residual flows (with NICE, Chain and
Inverse) in nfmc_torch against nfmc_tpu on the CPU, and the flow registry.

Each of the 22 flows is built by name in both packages; the JAX weights,
perturbed by 0.1 N(0, 1) numpy noise away from the identity init (as
``tests/test_flow_zoo.py`` perturbs them), are carried over with
``from_jax_params``. Forward, inverse and ``log_prob`` on the same numpy
inputs agree to ``TOL[family] * max(1, max|reference|)``: 1e-5 for the
closed-form maps (NICE, MAF / IAF, planar / radial / Sylvester forward) and
the residual blocks' fixed point, whose 40 contractions converge far below
float32 rounding; 2e-5 for the splines (as ``tests/test_torch_spline.py``)
and the bisection inverses (NAF, planar, radial), where both packages land
on the same root to within a few float32 ulps of the Newton step (measured
<= 4e-6 at these sizes). d = 6, widths 16, the masked NAF flows 1 layer."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nfmc_torch
import nfmc_torch.flows.train as ttrain
import nfmc_tpu.flows.train as jtrain
from nfmc_torch.api import registry as treg
from nfmc_torch.flows import Chain, Flow, Inverse, RealNVP, from_jax_params, hutchinson_probes
from nfmc_torch.ops import coupling as cops
from nfmc_torch.potentials import StandardGaussian
from nfmc_torch.utils import tree_leaves, tree_map, tree_unflatten
from nfmc_tpu.api import registry as jreg

D = 6
NAMES = list(treg.PORTED_FLOWS)
# the continuous and image flows have their own files (test_torch_continuous.py,
# test_torch_multiscale.py)
LAST = [n for n in NAMES if n in ("ot-flow", "ffjord", "ddb", "rnode")
        or n.startswith(("ms-", "glow-", "conv-"))]
NEW = [n for n in NAMES if n not in ("realnvp", "c-rqnsf", "c-lrsnsf") and n not in LAST]
ITERATIVE = ("naf", "planar", "radial")


def _kw(name):
    if name in ("planar", "radial"):
        return {"n_layers": 4}
    if name == "sylvester":
        return {"n_layers": 2}
    if name[:3] in ("ma-", "ia-") and "naf" in name:
        # one layer: JAX compiles a masked NAF layer's d nested bisection
        # loops slowly; the reversal between layers is the masked flows'
        # shared code, held at 2 layers by maf and the masked splines
        return {"n_layers": 1, "hidden_size": 16}
    return {"n_layers": 2, "hidden_size": 16}


def _tol(name):
    return 2e-5 if any(k in name for k in ITERATIVE + ("rqnsf", "lrsnsf")) else 1e-5


def _pair(name, seed=3, scale=0.1):
    """The JAX flow with perturbed weights and the port's flow holding them."""
    jflow = jreg.create_flow_object(name, (D,), seed=seed, **_kw(name))
    rng = np.random.default_rng(seed + 2)
    jflow.params = jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + scale * rng.standard_normal(np.shape(p)).astype(np.float32), jflow.params)
    flow = treg.create_flow_object(name, (D,), seed=0, **_kw(name))
    flow.params = from_jax_params(jflow.params)
    return jflow, flow


def _x(n=8, seed=2):
    return (1.2 * np.random.default_rng(seed).standard_normal((n, D))).astype(np.float32)


def _close(want, got, tol):
    want = np.asarray(want)
    scale = max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(want - got.detach().numpy())))
    assert err <= tol * scale, (err, tol * scale)


@pytest.mark.parametrize("name", NEW)
def test_flow_matches_jax(name):
    """Forward, inverse (of the JAX latent) and log_prob at the same weights;
    the round trip closes."""
    jflow, flow = _pair(name)
    x = _x()
    jz, jld = jax.jit(jflow.bijection.forward_fn)(jflow.params, jnp.asarray(x))
    jx, jld_inv = jax.jit(jflow.bijection.inverse_fn)(jflow.params, jz)
    jlp = jflow.base_log_prob(jz) + jld  # log_prob, without compiling the forward again
    z, ld = flow.bijection.forward_fn(flow.params, torch.from_numpy(x))
    x_back, ld_inv = flow.bijection.inverse_fn(flow.params, torch.from_numpy(np.array(jz)))
    tol = _tol(name)
    for want, got in ((jz, z), (jld, ld), (jx, x_back), (jld_inv, ld_inv),
                      (jlp, flow.log_prob(torch.from_numpy(x)))):
        _close(want, got, tol)
    x_rt, _ = flow.bijection.inverse_fn(flow.params, z)
    assert float((x_rt - torch.from_numpy(x)).abs().max()) <= 1e-4
    assert getattr(flow.bijection, "fused", False) is False  # no kernel for these flows


@pytest.mark.parametrize("name", NEW)
def test_log_det_matches_the_autograd_jacobian(name):
    """The forward log-det of two rows against slogdet of the Jacobian
    (float64 weights and inputs, so the check is of the math alone)."""
    _, flow = _pair(name, seed=4)
    params = tree_map(lambda t: t.double(), flow.params)
    x = torch.from_numpy(_x(2, seed=6)).double()
    _, ld = flow.bijection.forward_fn(params, x)
    for i in range(2):
        J = torch.autograd.functional.jacobian(
            lambda v: flow.bijection.forward_fn(params, v[None])[0][0], x[i])
        assert abs(float(torch.linalg.slogdet(J)[1] - ld[i])) <= 1e-6


def test_naf_inverse_log_det_gradient_matches_finite_differences():
    """The inverse log-det's gradient in the raw parameters carries the
    d(ld)/dx dx/d(raw) term (``tests/test_flow_zoo.py:52``), in float64."""
    from nfmc_torch.flows.naf import DeepSigmoidTransform

    tr = DeepSigmoidTransform(4)
    raw = torch.from_numpy(0.3 * np.random.default_rng(0).standard_normal(
        (3, tr.n_params_per_dim))).requires_grad_(True)
    y = torch.tensor([0.5, -1.2, 2.0], dtype=torch.float64)

    def ld_inv(r):
        return tr.inverse(y, r)[1].sum()

    (g,) = torch.autograd.grad(ld_inv(raw), raw)
    eps = 1e-6
    g_fd = torch.zeros_like(raw)
    with torch.no_grad():
        for i in range(raw.shape[0]):
            for j in range(raw.shape[1]):
                dp = torch.zeros_like(raw)
                dp[i, j] = eps
                g_fd[i, j] = (ld_inv(raw + dp) - ld_inv(raw - dp)) / (2 * eps)
    assert float((g - g_fd).abs().max()) <= 1e-6


def test_naf_inverse_expands_the_bracket():
    """Slopes at the clamp floor exp(-6) put preimages far outside the seed
    bracket of +-60 (``tests/test_flows.py:256``); the gradient stays finite."""
    from nfmc_torch.flows.naf import DeepSigmoidTransform

    t, K = DeepSigmoidTransform(8), 8
    raw = torch.cat([torch.full((3, K), -6.0), torch.zeros((3, K)), torch.zeros((3, K))], -1)
    raw.requires_grad_(True)
    x_true = torch.tensor([200.0, 1500.0, -900.0])
    y, _ = t.forward(x_true, raw)
    x_rec, _ = t.inverse(y.detach(), raw)
    assert float((x_rec - x_true).abs().max()) <= 1e-2
    (g,) = torch.autograd.grad(x_rec.sum(), raw)
    assert bool(torch.isfinite(g).all())


def test_hutchinson_probes_are_deterministic_per_input_and_key():
    v1 = torch.arange(6.0)
    p1 = hutchinson_probes(v1, 4)
    assert p1.shape == (4, 6) and set(p1.unique().tolist()) <= {-1.0, 1.0}
    assert torch.equal(p1, hutchinson_probes(v1.clone(), 4))
    assert not torch.equal(p1, hutchinson_probes(v1 + 1.0, 4))
    assert not torch.equal(p1, hutchinson_probes(v1.flip(0), 4))
    assert not torch.equal(p1, hutchinson_probes(v1, 4, 7))
    assert torch.equal(hutchinson_probes(v1, 4, 7),
                       hutchinson_probes(v1, 4, torch.Generator().manual_seed(7)))
    rows = torch.stack([v1, v1 + 1.0])  # a row's probes as if alone
    assert torch.equal(hutchinson_probes(rows, 4)[1], hutchinson_probes(v1 + 1.0, 4))
    # about half the signs flip between the probes of two inputs
    assert 0.25 < float((p1 != hutchinson_probes(v1 + 1.0, 4)).float().mean()) < 0.75


@pytest.mark.parametrize("name", ["i-resnet", "resflow", "proximal-resflow"])
def test_series_log_det_matches_jax_with_the_same_probes(monkeypatch, name):
    """Above ``exact_logdet_dim`` both packages take the truncated series;
    with the same probes injected into both they agree."""
    import nfmc_tpu.flows.residual as jres

    import nfmc_torch.flows.residual as tres

    probes = np.random.default_rng(1).choice([-1.0, 1.0], size=(4, D)).astype(np.float32)
    monkeypatch.setattr(jres, "hutchinson_probes",
                        lambda v, n, base_key=None, dtype=None: jnp.asarray(probes))
    monkeypatch.setattr(tres, "hutchinson_probes",
                        lambda v, n, key=None: torch.from_numpy(probes).expand(
                            *v.shape[:-1], *probes.shape))
    jflow, flow = _pair(name, scale=0.3)
    jflow.bijection.exact_logdet_dim = flow.bijection.exact_logdet_dim = 0
    x = _x()
    _, jld = jax.jit(jflow.bijection.forward_fn)(jflow.params, jnp.asarray(x))
    _, ld = flow.bijection.forward_fn(flow.params, torch.from_numpy(x))
    _close(jld, ld, 1e-5)


def test_series_log_det_is_unbiased_against_the_exact_one():
    """Per-row probes average the estimator's error out over inputs
    (``tests/test_flow_zoo.py:272``)."""
    from nfmc_torch.flows.residual import ResFlow

    bij = ResFlow((D,), n_layers=1, hidden_size=8)
    flow = Flow(bij, seed=2)
    g = torch.Generator().manual_seed(9)
    flow.params = tree_map(lambda t: t + 0.3 * torch.randn(t.shape, generator=g), flow.params)
    x = torch.randn((2048, D), generator=torch.Generator().manual_seed(11))
    p0 = flow.params[0]
    exact = bij._logdet(p0, x)
    bij.exact_logdet_dim, bij.series_terms = 0, 40
    est = bij._logdet(p0, x)
    assert abs(float((est - exact).mean())) < 0.02
    assert float((est - exact).std()) < 1.0


def test_chain_and_inverse_forward_a_childs_regularizer():
    """``tests/test_flows.py:161``: the child's weight applies inside
    ``Chain.regularization``; ``Inverse`` passes the child's weight on."""

    class Regularized(RealNVP):
        regularization_weight = 0.5

        def regularization(self, params, x):
            return torch.full(x.shape[:-1], 2.0)

    g = torch.Generator().manual_seed(0)
    chain = Chain([RealNVP((4,), n_layers=2, hidden_size=8),
                   Regularized((4,), n_layers=2, hidden_size=8)])
    inv = Inverse(Regularized((4,), n_layers=2, hidden_size=8))
    chain.params, inv.params = chain.init(g), inv.init(g)
    x = torch.randn((6, 4), generator=g)
    assert chain.regularization_weight == 1.0
    r = chain.regularization(chain.params, x)
    assert r.shape == (6,) and torch.allclose(r, torch.full((6,), 1.0))
    assert inv.regularization_weight == 0.5
    assert torch.allclose(inv.regularization(inv.params, x), torch.full((6,), 2.0))
    assert Chain([RealNVP((4,), n_layers=2, hidden_size=8)]).regularization_weight == 0.0


def test_chain_matches_jax_and_carries_nested_params():
    """A JAX ``Chain``'s list of lists carries over; the flow's state_dict,
    device and parameter count work on the nested and dict trees."""
    from nfmc_tpu.flows import Flow as JFlow
    from nfmc_tpu.flows.base import Chain as JChain
    from nfmc_tpu.flows.masked import MAF as JMAF
    from nfmc_tpu.flows.residual import PlanarFlow as JPlanar

    from nfmc_torch.flows import MAF, PlanarFlow

    jflow = JFlow(JChain([JMAF((D,), hidden_size=16), JPlanar((D,), n_layers=2)]), seed=1)
    rng = np.random.default_rng(4)
    jflow.params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(np.shape(p)).astype(np.float32),
        jflow.params)
    flow = Flow(Chain([MAF((D,), hidden_size=16), PlanarFlow((D,), n_layers=2)]), seed=0)
    flow.params = from_jax_params(jflow.params)
    x = _x()
    _close(jax.jit(jflow.log_prob_fn)(jflow.params, jnp.asarray(x)),
           flow.log_prob(torch.from_numpy(x)), 1e-5)
    jx = jax.jit(jflow.bijection.inverse_fn)(jflow.params, jnp.asarray(x))[0]
    _close(jx, flow.bijection.inverse_fn(flow.params, torch.from_numpy(x))[0], 1e-5)
    state = flow.state_dict()
    assert isinstance(state[1][0], dict) and set(state[1][0]) == {"u", "w", "b"}
    assert all(a is not b and torch.equal(a, b)
               for a, b in zip(tree_leaves(state), tree_leaves(flow.params)))
    assert flow.get_device().type == "cpu" and flow.to("cpu") is flow
    assert flow.bijection.n_parameters() == sum(
        np.size(p) for p in jax.tree_util.tree_leaves(jflow.params))


def test_the_coupling_leaf_order_is_the_packed_order():
    """The ``{"w", "b"}`` layout flattens per dense layer w then b, the
    kernels' packed buffer, and unflattens to the same tensors."""
    flow = Flow(RealNVP((D,), n_layers=3, hidden_size=16), seed=0)
    leaves = tree_leaves(flow.params)
    assert all(a is b for a, b in zip(leaves, [t for p in flow.params
                                              for w, b in zip(p["w"], p["b"]) for t in (w, b)]))
    assert torch.equal(cops.pack_weights(flow.params),
                       torch.cat([t.reshape(-1) for t in leaves]))
    again = tree_unflatten(flow.params, leaves)
    assert all(a is b for a, b in zip(tree_leaves(again), leaves))
    assert ttrain._mle_loss(flow) is ttrain._nll  # no regularizer: the unchanged loss


@pytest.mark.parametrize("name", ["maf", "c-naf-deep", "i-resnet"])
def test_fit_matches_jax(monkeypatch, name):
    """The same Adam steps on the same batches (70 rows at batch 16, the
    last padded, 2 epochs, no shuffle): the per-epoch validation losses and
    the weights to 1e-4, as ``tests/test_torch_train.py``."""
    jflow, flow = _pair(name, seed=5)
    rng = np.random.default_rng(3)
    x_train = (1.3 * rng.standard_normal((70, D)) + 0.5).astype(np.float32)
    kw = dict(shuffle=False, batch_size=16, n_epochs=2, early_stopping=False)
    seen = {}
    for mod, key in ((jtrain, "jax"), (ttrain, "torch")):
        rec = _RecordingNumpy()
        monkeypatch.setattr(mod, "np", rec)
        (jflow if key == "jax" else flow).fit(x_train, seed=0, **kw)
        seen[key] = rec.seen
    np.testing.assert_allclose(seen["torch"][0], seen["jax"][0], rtol=0, atol=1e-4)
    assert _max_diff(jflow.params, flow.params) <= 1e-4


class _RecordingNumpy:
    """numpy, except that ``isfinite`` records the per-epoch losses."""

    def __init__(self):
        self.seen = []

    def __getattr__(self, name):
        return getattr(np, name)

    def isfinite(self, a):
        if np.ndim(a) == 1:
            self.seen.append(np.array(a))
        return np.isfinite(a)


def _max_diff(jparams, params) -> float:
    """max |JAX - port| over the weights (``from_jax_params`` keeps the
    tree's structure, so the leaves pair up)."""
    return max(float((a - b.detach()).abs().max())
               for a, b in zip(tree_leaves(from_jax_params(jparams)), tree_leaves(params)))


@pytest.mark.parametrize("kind", ["per-sample", "scalar"])
def test_fit_with_a_regularizer_matches_jax(monkeypatch, kind):
    """A RealNVP with ``regularization_weight`` 0.5 and a regularizer that
    depends on the weights (the squared log-det, per sample or its mean) in
    both packages: the padded rows weigh 0 in the per-sample term."""
    from nfmc_tpu.flows import Flow as JFlow
    from nfmc_tpu.flows import RealNVP as JRealNVP

    def make(base):
        class Regularized(base):
            regularization_weight = 0.5

            def regularization(self, params, x):
                r = self.forward_fn(params, x)[1] ** 2
                return r.mean() if kind == "scalar" else r

        return Regularized

    jflow = JFlow(make(JRealNVP)((D,), n_layers=2, hidden_size=16, use_pallas=False),
                  seed=0)
    rng = np.random.default_rng(1)
    jflow.params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape).astype(np.float32),
        jflow.params)
    flow = Flow(make(RealNVP)((D,), n_layers=2, hidden_size=16))
    flow.params = from_jax_params(jflow.params)
    x_train = (1.3 * np.random.default_rng(2).standard_normal((70, D)) + 0.5).astype(np.float32)
    kw = dict(shuffle=False, batch_size=16, n_epochs=2, early_stopping=False)
    jflow.fit(x_train, seed=0, **kw)
    flow.fit(x_train, seed=0, **kw)
    assert _max_diff(jflow.params, flow.params) <= 1e-4


def test_variational_fit_adds_the_weighted_regularizer():
    """The reverse-KL loss with a regularized bijection is the plain loss
    plus the weight times the regularizer's mean at the pushed draws, and
    a fit on a dict-of-tensors flow trains."""

    class Regularized(RealNVP):
        regularization_weight = 0.25

        def regularization(self, params, x):
            return (x ** 2).sum(-1)

    flow = Flow(Regularized((D,), n_layers=2, hidden_size=8), seed=0)
    z = torch.randn((16, D), generator=torch.Generator().manual_seed(0))
    target = StandardGaussian((D,))
    plain = ttrain._reverse_kl(flow, flow.params, z, lambda v: -target(v))
    reg = ttrain._reverse_kl(flow, flow.params, z, lambda v: -target(v), 0.25)
    x, _ = flow.bijection.inverse_fn(flow.params, z)
    assert torch.allclose(reg, plain + 0.25 * (x ** 2).sum(-1).mean())
    planar = treg.create_flow_object("planar", (D,), seed=0)
    before = torch.cat([t.reshape(-1) for t in tree_leaves(planar.params)])
    planar.variational_fit(lambda v: -target(v) - 0.5 * v.sum(-1), n_epochs=20, seed=0)
    after = torch.cat([t.reshape(-1) for t in tree_leaves(planar.params)])
    assert isinstance(planar.params[0], dict) and not torch.equal(before, after)


@pytest.mark.parametrize("name", NEW)
def test_front_door_imh(name):
    """Each flow through ``sample`` (IMH, the default strategy) on the CPU."""
    flow = f"{name}%" + ('{"n_layers": 2}' if name in ("planar", "radial", "sylvester")
                         else '{"n_layers": 2, "hidden_size": 8}')
    out = nfmc_torch.sample(StandardGaussian((4,)), flow=flow, n_chains=4, n_iterations=3,
                            device="cpu", seed=0, show_progress=False)
    assert out.samples.shape == (3, 4, 4) and torch.isfinite(out.samples).all()
    assert 0.0 <= out.statistics.acceptance_rate <= 1.0


def test_neutra_caches_dict_params():
    """NeuTra's view of the flow's weights works on a dict-of-tensors tree
    and is re-taken when a tensor is replaced."""
    out = nfmc_torch.sample(StandardGaussian((3,)), strategy="neutra_mh", flow="planar",
                            n_chains=4, n_iterations=3, device="cpu", seed=0,
                            show_progress=False)
    assert torch.isfinite(out.samples).all()


# ---- the registry ----------------------------------------------------------------


def test_registry_data_and_lists_equal_jax():
    assert treg.FLOW_REFERENCE_DATA == jreg.FLOW_REFERENCE_DATA
    for fn in ("get_supported_autoregressive_flows", "get_supported_residual_flows",
               "get_supported_continuous_flows", "get_supported_normalizing_flows"):
        for synonyms in (True, False):
            assert getattr(treg, fn)(synonyms) == getattr(jreg, fn)(synonyms)
    aliases = treg.flatten_name_dictionary(treg.FLOW_NAMES)
    assert len(aliases) == 107 and aliases == jreg.flatten_name_dictionary(jreg.FLOW_NAMES)
    for name in ("c-naf-deep", "maf-naf-dense", "ddnf", "iresnet", "glow"):
        assert treg.get_flow_family(name) == jreg.get_flow_family(name)
    assert treg.get_supported_samplers() == jreg.get_supported_samplers()


def test_every_alias_of_a_ported_flow_builds_its_class():
    """Each alias resolves to the JAX package's canonical name (the first
    entry of ``FLOW_NAMES`` holding it) and builds that name's class."""
    constructors = jreg._constructors()
    for alias in treg.flatten_name_dictionary(treg.FLOW_NAMES):
        want = alias if alias in constructors else next(
            k for k, names in jreg.FLOW_NAMES.items() if alias in names)
        assert treg.canonical_flow_name(alias) == want
        assert treg.PORTED_FLOWS[want].__name__ == constructors[want].__name__
        shape = (4, 4) if want.startswith(("ms-", "glow-", "conv-")) else (4,)
        flow = treg.create_flow_object(alias, shape, seed=0)
        assert np.isfinite(flow.log_prob(torch.zeros((1, *shape))).item())


@pytest.mark.parametrize("name", LAST)
def test_the_last_flows_build_and_sample_through_the_front_door(name):
    """Each continuous, multiscale, Glow and convolutional name builds
    through ``create_flow_object`` (no "ROADMAP 1.7" any more) and runs IMH
    through ``sample`` on the CPU, at small widths: (4, 4) images, d = 4."""
    image = name.startswith(("ms-", "glow-", "conv-"))
    shape = (4, 4) if image else (4,)
    kw = ('{"hidden_channels": 4}' if image else '{"hidden_size": 8, "n_steps": 2}')
    out = nfmc_torch.sample(StandardGaussian(shape), flow=f"{name}%{kw}", n_chains=3,
                            n_iterations=2, device="cpu", seed=0, show_progress=False)
    assert out.samples.shape == (2, 3, *shape) and torch.isfinite(out.samples).all()
    assert 0.0 <= out.statistics.acceptance_rate <= 1.0


def test_unknown_flows_raise_value_error():
    for bad in ("no-such-flow", None):
        with pytest.raises(ValueError):
            treg.create_flow_object(bad, (4,))
        with pytest.raises(ValueError):
            jreg.create_flow_object(bad, (4,))
