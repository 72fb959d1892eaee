"""The transport layer in nfmc_torch against nfmc_tpu: the shared pieces
(``tempered``, ``log_ess``, systematic resampling, the Gumbel-max draw, the
MALA sweep and the AIS chain), one level of AFT and a CRAFT pass with the
same weights and the JAX package's draws rebuilt from its keys and injected
(1e-5 for a step, 1e-4 for a multi-epoch fit), NS's evidence over a fixed
sequence of replacements, AdamW against ``optax.adamw``; then whole runs of
the port at ``tests/test_transport.py``'s configurations, held to the
assertions that file makes of the JAX package (PMC and SNF:
``test_torch_pmc.py``, ``test_torch_snf.py``)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nfmc_tpu.transport as jtr
from nfmc_tpu.flows import Bijection as JBijection
from nfmc_tpu.flows import Flow as JFlow
from nfmc_tpu.flows import RealNVP as JRealNVP
from nfmc_tpu.potentials import StandardGaussian as JStandardGaussian
from nfmc_tpu.transport import ais as jais
from nfmc_tpu.transport import common as jcommon
from nfmc_torch import transport as ttr
from nfmc_torch.flows import Bijection, Flow, RealNVP, from_jax_params
from nfmc_torch.flows.train import _Adam, _AdamW, _flatten
from nfmc_torch.ops.coupling import unpack_like
from nfmc_torch.transport import ais as tais
from nfmc_torch.transport import common as tcommon
from nfmc_torch.utils import tree_leaves
from tests.transport_parity import (D, FIT_TOL, FLOW, JPRIOR, JTARGET, PRIOR, STEP_TOL, TARGET,
                                   TRUE_LOG_Z, close, close_trees, flows, jax_chain_draws,
                                   jax_sweep_draws, rows, t)
from tests.transport_parity import one_torch_thread  # noqa: F401 (an autouse fixture)


# ---- the shared pieces ------------------------------------------------------------
def hard(lib):
    """U = +inf where x_0 < 0, else 0.5 |x - 1|^2 (a hard-support target)."""
    if lib is jnp:
        return lambda x: jnp.where(x[..., 0] < 0.0, jnp.inf, 0.5 * jnp.sum((x - 1.0) ** 2, -1))
    return lambda x: torch.where(x[..., 0] < 0.0, math.inf, 0.5 * ((x - 1.0) ** 2).sum(-1))


def test_tempered_endpoints_and_hard_support():
    """u(x, 0) is the prior and u(x, 1) the target exactly, with no 0 * inf
    NaN from the switched-off side; u(x, 1/2) mixes them."""
    x = rows(32, scale=2.0)
    ju = jcommon.tempered(JPRIOR, hard(jnp))
    tu = tcommon.tempered(PRIOR, hard(torch))
    for lam in (0.0, 0.5, 1.0):
        want = np.asarray(ju(jnp.asarray(x), lam))
        got = tu(t(x), lam)
        close(got, want, STEP_TOL, f"lam {lam}")
        assert not torch.isnan(got).any()
    assert torch.isfinite(tu(t(x), 0.0)).all() and torch.isinf(tu(t(x), 1.0)).any()


def test_log_ess_and_systematic_resample_with_the_offset():
    rng = np.random.default_rng(2)
    lw = rng.standard_normal(200).astype(np.float32) * 2.0
    lw[::17] = -np.inf
    close(tcommon.log_ess(t(lw)), np.asarray(jcommon.log_ess(jnp.asarray(lw))), STEP_TOL)
    for seed in range(3):
        key = jax.random.key(seed)
        want = np.asarray(jcommon.systematic_resample(key, jnp.asarray(lw), 150))
        offset = torch.tensor(float(jax.random.uniform(key, ())))
        got = tcommon.systematic_resample(t(lw), 150, offset)
        np.testing.assert_array_equal(got.numpy(), want)
    # the defining low-variance property: counts match n*w within 1
    w = np.array([0.5, 0.25, 0.125, 0.0625, 0.0625])
    idx = tcommon.systematic_resample(torch.log(t(w)), 400, torch.tensor(0.37))
    assert np.abs(np.bincount(idx.numpy(), minlength=5) - 400 * w).max() <= 1.0


def test_gumbel_max_matches_jax_categorical_with_its_noise():
    logits = np.log(np.random.default_rng(3).dirichlet(np.ones(40))).astype(np.float32)
    logits[5] = -np.inf
    key = jax.random.key(4)
    want = np.asarray(jax.random.categorical(key, jnp.asarray(logits), shape=(300,)))
    noise = t(jax.random.gumbel(key, (300, 40)))
    np.testing.assert_array_equal(tcommon.categorical(t(logits), noise).numpy(), want)
    np.testing.assert_array_equal(tcommon.multinomial_resample(t(logits), noise).numpy(), want)
    assert tcommon.gumbel(torch.Generator().manual_seed(0), (7, 5)).shape == (7, 5)


def test_mala_sweep_matches_jax_and_force_moves_an_infinite_current():
    """Five steps at lam = 1/2 of the hard-support mixture: rows that start
    where U = +inf move to any evaluable proposal."""
    x = rows(64, scale=0.5, shift=0.6)
    x[:16, 0] = -0.05  # outside the support: U = +inf
    ju = jcommon.tempered(JPRIOR, hard(jnp))
    tu = tcommon.tempered(PRIOR, hard(torch))
    jsweep = jcommon.make_mala_sweep(ju, n_steps=5, step_size=0.05)
    tsweep = tcommon.make_mala_sweep(tu, n_steps=5, step_size=0.05)
    key = jax.random.key(7)
    want = np.asarray(jsweep(jnp.asarray(x), 0.5, key))
    got = tsweep(t(x), 0.5, jax_sweep_draws(key, 5, x.shape))
    close(got, want, STEP_TOL)
    assert (got[:16, 0] >= 0).sum() > 4  # forced moves out of the hole
    shapes = [tuple(a.shape) for a in tsweep.draws(torch.Generator().manual_seed(0), x.shape)]
    assert shapes == [(5, 64, D), (5, 64)]


def test_anneal_chain_matches_jax():
    x0 = rows(128)
    key = jax.random.key(11)
    jx, jlw = jais.make_ais(JPRIOR, JTARGET, n_steps=6, n_mcmc_steps=2, step_size=0.1)(
        jnp.asarray(x0), key)
    run = tais.make_ais(PRIOR, TARGET, n_steps=6, n_mcmc_steps=2, step_size=0.1)
    x, lw = run(t(x0), jax_chain_draws(key, 6, 2, x0.shape))
    close(x, np.asarray(jx), STEP_TOL, "x")
    close(lw, np.asarray(jlw), STEP_TOL, "log_w")


def test_anneal_chain_pins_nan_increments_to_minus_inf():
    """Out of support at both levels: inf - inf = NaN becomes -inf."""
    u = lambda x, lam: torch.full((x.shape[0],), math.inf)
    sweep = type("Identity", (), {"draws": lambda self, g, s: None,
                                  "__call__": lambda self, x, lam, d: x})()
    _, lw = tais.anneal_chain(u, sweep, 3)(torch.zeros(4, D), [None] * 3)
    assert torch.isneginf(lw).all()


def test_adamw_matches_optax():
    rng = np.random.default_rng(5)
    theta0 = rng.standard_normal(17).astype(np.float32)
    grads = [rng.standard_normal(17).astype(np.float32) for _ in range(4)]
    for ours, theirs in ((_AdamW, optax.adamw(3e-3)), (_Adam, optax.adam(3e-3))):
        p, state = jnp.asarray(theta0), theirs.init(jnp.asarray(theta0))
        theta = t(theta0)
        opt = ours(theta, 3e-3)
        for g in grads:
            upd, state = theirs.update(jnp.asarray(g), state, p)
            p = optax.apply_updates(p, upd)
            theta = opt.step(theta, t(g))
            close(theta, np.asarray(p), 1e-6)
    # the masked skip leaves the vector and the moments as they were
    before = (theta.clone(), opt.mu.clone(), opt.count.clone())
    theta = opt.step(theta, t(grads[0]), torch.tensor(False))
    assert torch.equal(theta, before[0]) and torch.equal(opt.mu, before[1])
    assert torch.equal(opt.count, before[2])


# ---- AFT ----------------------------------------------------------------------------
def aft_pair(n_steps=4, n_train_epochs=5, jflow=None, flow=None):
    if jflow is None:
        jflow, flow = flows()
    return (jtr.AnnealedFlowTransport(JPRIOR, JTARGET, jflow, n_steps=n_steps,
                                      n_train_epochs=n_train_epochs),
            ttr.AnnealedFlowTransport(PRIOR, TARGET, flow, n_steps=n_steps,
                                      n_train_epochs=n_train_epochs), jflow, flow)


def test_aft_loss_transport_and_a_five_epoch_level_fit():
    ja, ta, jflow, flow = aft_pair()
    x, w = rows(96, seed=1), np.random.default_rng(2).dirichlet(np.ones(96)).astype(np.float32)
    close(ta._loss_fn(flow.params, t(x), t(w), 0.5),
          np.asarray(ja._loss_fn(jflow.params, jnp.asarray(x), jnp.asarray(w), 0.5)), STEP_TOL)
    lw = np.log(w)
    for use in (True, False):
        want = ja._transport(jflow.params, jnp.asarray(x), jnp.asarray(lw), 1 / 3, 2 / 3,
                             jnp.asarray(use))
        got = ta._transport(flow.params, t(x), t(lw), 1 / 3, 2 / 3, torch.tensor(use))
        for a, b, what in zip(got, want, ("x", "log_W", "dlZ", "log_ess")):
            close(a, np.asarray(b), STEP_TOL, f"use_flow {use} {what}")
    xv = rows(48, seed=3)
    wv = np.random.default_rng(4).dirichlet(np.ones(48)).astype(np.float32)
    jp, jbest = ja._fit_level(jflow.params, ja.opt.init(jflow.params), jnp.asarray(x),
                              jnp.asarray(w), jnp.asarray(xv), jnp.asarray(wv), 1 / 3)
    p, best = ta._fit_level(flow.params, t(x), t(w), t(xv), t(wv), 1 / 3)
    close(best, np.asarray(jbest), FIT_TOL, "best val")
    close_trees(p, jp, FIT_TOL, "fitted params")
    assert not np.allclose(tree_leaves(p)[-1].numpy(), tree_leaves(flow.params)[-1].numpy())


def test_aft_identity_fallback_rejects_bad_transport():
    """As tests/test_transport.py: an identity-initialized flow ties the
    identity and is accepted; huge shifts collapse the val ESS and are
    rejected; in both packages, the same decisions and transported rows."""
    jflow = JFlow(JRealNVP((D,), n_layers=2, hidden_size=16, use_pallas=False), seed=0)
    flow = Flow(RealNVP((D,), n_layers=2, hidden_size=16))
    flow.params = from_jax_params(jflow.params)
    ja, ta, _, _ = aft_pair(jflow=jflow, flow=flow)
    xv = rows(128, seed=6)
    lw = np.full(128, -np.log(128.0), np.float32)
    bad_j = jax.tree_util.tree_map(lambda p: p + 40.0, jflow.params)
    bad_t = from_jax_params(bad_j)
    for jp, tp, accepted in ((jflow.params, flow.params, True), (bad_j, bad_t, False)):
        want = ja._select_transport(jp, jnp.asarray(xv), jnp.asarray(lw), 0.0, 0.5)
        got = ta._select_transport(tp, t(xv), t(lw), 0.0, 0.5)
        assert bool(got[0]) == bool(want[0]) == accepted
        close(got[1], np.asarray(want[1]), STEP_TOL)
        close(got[2], np.asarray(want[2]), STEP_TOL)
    # a whole run with the sabotaged flow degrades to tempered SMC
    flow.params = bad_t
    alg = ttr.AnnealedFlowTransport(PRIOR, TARGET, flow, n_steps=6, n_train_epochs=0)
    out = alg.run(lambda b, generator=None: PRIOR.sample(b, generator=generator),
                  n_particles=256, seed=0)
    assert np.isfinite(out["log_Z"]) and abs(out["log_Z"] - TRUE_LOG_Z) < 3.0


def test_aft_select_prefers_flow_when_identity_ess_is_nan():
    """A non-finite identity ESS (every val particle at U = +inf) must not
    veto a finite fitted transport (tests/test_transport.py's case)."""

    class JContract(JBijection):
        def init(self, key):
            return ()

        def forward_fn(self, params, x):
            return x / 50.0, jnp.full(x.shape[:-1], -3 * np.log(50.0))

        def inverse_fn(self, params, z):
            return z * 50.0, jnp.full(z.shape[:-1], 3 * np.log(50.0))

    class Contract(Bijection):
        def init(self, generator):
            return [torch.zeros(1)]

        def forward_fn(self, params, x):
            return x / 50.0, torch.full(x.shape[:-1], -3 * np.log(50.0))

        def inverse_fn(self, params, z):
            return z * 50.0, torch.full(z.shape[:-1], 3 * np.log(50.0))

    jhard = lambda x: jnp.where(jnp.sum(x ** 2, -1) > 0.25, jnp.inf, 0.5 * jnp.sum(x ** 2, -1))
    thard = lambda x: torch.where((x ** 2).sum(-1) > 0.25, math.inf, 0.5 * (x ** 2).sum(-1))
    ja = jtr.AnnealedFlowTransport(JPRIOR, jhard, JFlow(JContract((D,)), seed=0), n_steps=4)
    ta = ttr.AnnealedFlowTransport(PRIOR, thard, Flow(Contract((D,)), seed=0), n_steps=4)
    xv = rows(64, seed=0, shift=2.0)  # all outside
    lw = np.full(64, -np.log(64.0), np.float32)
    want = ja._select_transport((), jnp.asarray(xv), jnp.asarray(lw), 0.0, 0.5)
    use, x_t, lw_new = ta._select_transport(ta.flow.params, t(xv), t(lw), 0.0, 0.5)
    assert bool(use) and bool(want[0])
    close(x_t, np.asarray(want[1]), STEP_TOL)
    close(lw_new, np.asarray(want[2]), STEP_TOL)
    assert torch.isfinite(x_t).all() and torch.isfinite(lw_new).all()


# ---- CRAFT ---------------------------------------------------------------------------
def test_craft_level_loss_and_a_trained_pass():
    """The level loss, then one training pass over two levels (an AdamW step
    each, transport, the ESS-gated resample, the sweep) with JAX's draws."""
    (jf0, f0), (jf1, f1) = flows(seed=0), flows(seed=2)
    jc = jtr.CRAFT(JPRIOR, JTARGET, [jf0.bijection, jf1.bijection], sampling_threshold=0.6,
                   n_mcmc_steps=3)
    tc = ttr.CRAFT(PRIOR, TARGET, [f0.bijection, f1.bijection], sampling_threshold=0.6,
                   n_mcmc_steps=3)
    x = rows(128, seed=8)
    w = np.random.default_rng(9).dirichlet(np.ones(128)).astype(np.float32)
    w[:5] = 0.0
    close(tc._loss(f0.bijection, f0.params, t(x), t(w), 0.0, 0.5),
          np.asarray(jc._loss(jf0.bijection, jf0.params, jnp.asarray(x), jnp.asarray(w), 0.0, 0.5)),
          STEP_TOL)
    key = jax.random.key(12)
    lw0 = np.full(128, -np.log(128.0), np.float32)
    jps, jos, jx, jlw, jlz = jc._train_pass(
        jc._stack([jf0.params, jf1.params]),
        jc._stack([jc.opt.init(jf0.params), jc.opt.init(jf1.params)]),
        jnp.asarray(x), jnp.asarray(lw0), key)
    draws = []
    for k in jax.random.split(key, 2):
        k_res, k_mala = jax.random.split(k)
        draws.append((torch.tensor(float(jax.random.uniform(k_res, ()))),
                      jax_sweep_draws(k_mala, 3, x.shape)))
    thetas = [_flatten(f0.params), _flatten(f1.params)]
    opts = [_AdamW(th, tc.lr) for th in thetas]
    xo, lwo, lz, xs = tc._pass(thetas, opts, t(x), t(lw0), draws)
    close(xo, np.asarray(jx), STEP_TOL, "x")
    close(lwo, np.asarray(jlw), STEP_TOL, "log_W")
    close(lz, np.asarray(jlz), STEP_TOL, "log_Z")
    for i, jp in enumerate(jc._unstack(jps)):
        close_trees(unpack_like(thetas[i], f0.params), jp, STEP_TOL, f"level {i} params")
    assert len(xs) == 2


def test_craft_rejects_mixed_architectures():
    a = Flow(RealNVP((D,), n_layers=2, hidden_size=16), seed=0).bijection
    b = Flow(RealNVP((D,), n_layers=2, hidden_size=8), seed=1).bijection
    with pytest.raises(ValueError, match="level 1 differs"):
        ttr.CRAFT(PRIOR, TARGET, [a, b])


# ---- NS ------------------------------------------------------------------------------
class FixedPrior:
    """The prior potential with its ``sample`` replaced by fixed rows."""

    def __init__(self, pot, x0):
        self.pot, self.x0, self.event_shape = pot, x0, pot.event_shape

    def __call__(self, x):
        return self.pot(x)

    def sample(self, batch_shape, key=None, generator=None):
        return jnp.asarray(self.x0) if isinstance(self.pot, JStandardGaussian) else t(self.x0)


@pytest.mark.parametrize("stuck", [False, True])
def test_ns_evidence_over_a_fixed_sequence_of_replacements(stuck):
    """Both packages given the same live points, rejection candidates and
    flow populations (one admissible candidate each, so the SIR pick is
    forced), and no refit: the same log Z, dead and live points. With
    ``stuck`` the candidates run out at iteration 7: the worst point ends
    the run without being counted dead."""
    n_live, n_pop, n_it = 5, 6, 14
    rng = np.random.default_rng(15)
    x0 = rng.standard_normal((n_live, D)).astype(np.float32)
    cands = [rng.standard_normal((n_pop, D)).astype(np.float32) * 0.7 + 1.0 for _ in range(60)]
    ll_of = lambda c: -np.asarray(JTARGET(jnp.asarray(np.asarray(c))))
    out = {}
    for name, pot, pkg in (("jax", JPRIOR, jtr), ("torch", PRIOR, ttr)):
        flow = flows()[0 if name == "jax" else 1]
        flow.fit = lambda *a, **k: None
        # the same float32 likelihoods in both packages
        ll = ll_of if name == "jax" else (lambda c: t(ll_of(c)))
        alg = pkg.NestedSampling(FixedPrior(pot, x0), ll, flow, n_live_points=n_live,
                                 n_population_draws=n_pop)
        it = iter(cands)
        calls = [0]

        def prior_draw(*_):
            calls[0] += 1
            if stuck and calls[0] > 7:
                c = np.full((n_pop, D), 40.0, np.float32)  # below every L*
            else:
                c = next(it)
            return c, ll_of(c)

        def flow_propose(*_):
            c = next(it)
            lls = ll_of(c)
            lls[0] += 50.0  # the one admissible candidate
            lls[1:] = -np.inf
            return c, lls, np.zeros(n_pop, np.float32)

        alg._prior_draw, alg._flow_propose = prior_draw, flow_propose
        out[name] = alg.run(n_iterations=n_it, seed=0)
    j, p = out["jax"], out["torch"]
    assert p["log_Z"] == pytest.approx(j["log_Z"], rel=1e-12, abs=1e-12)
    np.testing.assert_array_equal(p["dead_points"], j["dead_points"])
    np.testing.assert_array_equal(p["live_points"], j["live_points"])
    np.testing.assert_array_equal(p["dead_log_likelihoods"], j["dead_log_likelihoods"])
    n_dead = len(p["dead_log_likelihoods"])
    assert (0 < n_dead < n_it) if stuck else n_dead == n_it


# ---- whole runs of the port (tests/test_transport.py's assertions) ---------------------
def test_ais_log_z():
    g = torch.Generator().manual_seed(0)  # one stream for the start and the chain
    x0 = PRIOR.sample((256,), generator=g)
    x, log_w = tais.ais_base(x0, PRIOR, TARGET, n_steps=24, n_mcmc_steps=3, step_size=0.05,
                             generator=g, device="cpu")
    est = float(torch.logsumexp(log_w, 0) - np.log(256))
    assert torch.isfinite(x).all()
    assert abs(est - TRUE_LOG_Z) < 1.5
    assert (x.mean(0) - 2.0).abs().max() < 1.0


def test_aft():
    out = ttr.aft(PRIOR, TARGET, FLOW, n_particles=64, n_iterations=5, seed=0, n_train_epochs=5,
                  device="cpu")
    assert np.isfinite(out["particles"]).all()
    assert out["history"].shape[0] == 5
    assert np.abs(out["particles"].mean(0) - 2.0).max() < 1.0
    assert np.isfinite(out["log_Z"])


def test_craft():
    out = ttr.craft(PRIOR, TARGET, FLOW, n_particles=64, n_iterations=5, n_annealing_steps=4,
                    seed=0, device="cpu")
    assert np.isfinite(out["particles"]).all()
    assert out["history"].shape[0] == 5
    assert np.abs(out["particles"].mean(0) - 2.0).max() < 1.0


def test_ns():
    out = ttr.ns(PRIOR, TARGET, FLOW, n_particles=25, n_iterations=60, seed=0, device="cpu")
    assert np.isfinite(out["log_Z"])
    assert out["dead_points"].shape[0] > 0
    assert out["live_log_likelihoods"].min() > out["dead_log_likelihoods"][0]


def test_ns_log_z_accuracy():
    true_log_z = 3 * (np.log(0.5) - 0.5 * np.log(1.25) - 1.6)  # = -7.214
    out = ttr.ns(PRIOR, TARGET, FLOW, n_particles=64, n_iterations=400, seed=1, device="cpu")
    assert abs(out["log_Z"] - true_log_z) < 1.0, (out["log_Z"], true_log_z)


def test_wrappers_run_on_cuda_by_default(monkeypatch):
    """Without device= every wrapper asks for CUDA (and raises here)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: ttr.aft(PRIOR, TARGET, FLOW, n_iterations=2),
                 lambda: ttr.craft(PRIOR, TARGET, FLOW, n_iterations=1, n_annealing_steps=2),
                 lambda: ttr.pmc(PRIOR, TARGET, FLOW), lambda: ttr.snf(PRIOR, TARGET),
                 lambda: ttr.ns(PRIOR, TARGET, FLOW),
                 lambda: tais.ais_base(np.zeros((4, D)), PRIOR, TARGET)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
