"""The rank side of ``tests/test_torch_parallel_strategies.py``: the
strategies declared for several ranks after ``tests/parallel_ranks.py``'s,
and the transport layer's sharded particles, run on a gloo group on the CPU
and unsharded in the test process for comparison.

Like ``tests/parallel_ranks.py`` (whose helpers and ``run_rank`` it uses)
it imports only torch, numpy and ``nfmc_torch``, so that the spawned ranks
never import JAX. Each scenario is a function of ``(mesh, workdir)``;
``mesh=None`` runs it without a mesh.
"""
import numpy as np

from tests.parallel_ranks import D, _entry, _flat, _flow, _metropolis, _result, _target, _x0
from tests.parallel_ranks import run_rank as _run_rank

# the transport runs: tests/test_sharding.py's target and flow
TR_D, AFT_SIZES, PMC_N = 3, (64, 100, 51), 128
TR_FLOW = 'realnvp%{"n_layers": 2, "hidden_size": 16}'
AIES_WALKERS = 12


def ula(mesh, workdir):
    """ULA: its warmup tunes the inverse mass (no step: it is unadjusted)."""
    from nfmc_torch.samplers.mcmc import ULA

    s = ULA((D,), _target(), device="cpu")
    s.params.n_warmup_iterations = 8
    s.params.n_iterations = 4
    _entry(s.warmup, _x0(30), mesh, seed=3)
    return _result(_entry(s.sample, _x0(30), mesh, seed=4), **_metropolis(s))


def uhmc(mesh, workdir):
    from nfmc_torch.samplers.mcmc import UHMC
    from nfmc_torch.samplers.mcmc.hmc import HMCKernel

    s = UHMC((D,), _target(), HMCKernel(event_size=D, n_leapfrog_steps=5, step_size=0.2),
             device="cpu")
    s.params.n_warmup_iterations = 8
    s.params.n_iterations = 4
    _entry(s.warmup, _x0(31), mesh, seed=3)
    return _result(_entry(s.sample, _x0(31), mesh, seed=4), **_metropolis(s))


def _mh(cls, mesh, seed):
    from nfmc_torch.samplers.mcmc.mh import MHKernel

    s = cls((D,), _target(), MHKernel(event_size=D, inv_mass_diag=np.full(D, 0.6)), device="cpu")
    s.params.n_warmup_iterations = 10
    s.params.n_iterations = 4
    _entry(s.warmup, _x0(seed), mesh, seed=3)
    return _result(_entry(s.sample, _x0(seed), mesh, seed=4), **_metropolis(s))


def mh(mesh, workdir):
    """MH: the proposal scale is the inverse mass, its EMA the tuning."""
    from nfmc_torch.samplers.mcmc import MH

    return _mh(MH, mesh, 32)


def random_walk(mesh, workdir):
    from nfmc_torch.samplers.mcmc.mh import RandomWalk

    return _mh(RandomWalk, mesh, 33)


def nuts(mesh, workdir):
    """NUTS with its tuning warmup; each rank breaks its trees' loops on
    its own chains; the tree depths over every run and rank."""
    from nfmc_torch.samplers.mcmc import NUTS
    from nfmc_torch.samplers.mcmc.nuts import NUTSKernel

    s = NUTS((D,), _target(), NUTSKernel(event_size=D, max_tree_depth=5), device="cpu")
    s.params.n_warmup_iterations = 10
    s.params.n_iterations = 4
    _entry(s.warmup, _x0(34), mesh, seed=3)
    out = _entry(s.sample, _x0(34), mesh, seed=4)
    return _result(out, depths=np.asarray(s.tree_depths(), np.float64), **_metropolis(s))


def _ess(mesh, dense, seed):
    from nfmc_torch.samplers.mcmc import ESS

    s = ESS((D,), _target(), _target(), device="cpu")
    s.params.dense_ellipse = dense
    s.params.n_warmup_iterations = 10
    s.params.n_iterations = 4
    warm = _entry(s.warmup, _x0(seed), mesh, seed=3)
    out = _entry(s.sample, _x0(seed), mesh, seed=4)
    cont = _entry(s.sample_continue, out.running_samples.last_sample, mesh, seed=5)
    return _result(out, warm=warm.samples.numpy(), ellipse=np.asarray(s.kernel.cov),
                   cont=cont.samples.numpy())


def ess_dense(mesh, workdir):
    """ESS's warmup adapting a dense ellipse to every chain's draws, the
    prior redraw of ``sample`` and a continuation."""
    return _ess(mesh, True, 35)


def ess_diag(mesh, workdir):
    """The same with the diagonal ellipse (the flushes' variance)."""
    return _ess(mesh, False, 36)


def _adaptive_imh(mesh, history_limit):
    from nfmc_torch.samplers.nfmc import AdaptiveIMH, IMHKernel

    s = AdaptiveIMH((D,), _target(), IMHKernel((D,), flow=_flow(seed=2)), device="cpu")
    s.history_element_limit = history_limit
    s.params.n_iterations = 6
    out = _entry(s.sample, _x0(37), mesh, seed=6)
    return _result(out, flow=_flat(s.kernel.flow.params))


def adaptive_imh_fused(mesh, workdir):
    """AdaptiveIMH's fused route: the history on the device, each refit a
    scan fit on one stored batch of all the chains, gathered."""
    return _adaptive_imh(mesh, 1 << 27)


def adaptive_imh_host(mesh, workdir):
    """The host route (a history over the limit): ``Flow.fit`` on the
    gathered batch."""
    return _adaptive_imh(mesh, 0)


def _neutra(cls, mesh, seed, **inner):
    from nfmc_torch.samplers.nfmc.neutra import NeuTraKernel

    s = cls((D,), _target(), kernel=NeuTraKernel((D,), flow=_flow()), device="cpu", **inner)
    s.params.warmup_fit_kwargs = {"n_epochs": 5, "n_samples": 32, "lr": 1e-2}
    s.params.n_warmup_iterations = 10
    s.params.n_iterations = 4
    _entry(s.warmup, _x0(seed), mesh, seed=5)
    out = _entry(s.sample, _x0(seed), mesh, seed=6)
    return _result(out, flow=_flat(s.kernel.flow.params),
                   step_size=s.inner_sampler.kernel.step_size,
                   inv_mass=np.asarray(s.inner_sampler.kernel.inv_mass_diag))


def neutra_mh(mesh, workdir):
    """NeuTra-MH: the reverse-KL warmup, the inner MH's tuning in the latent
    space, then sampling with the data-space moments."""
    from nfmc_torch.samplers.mcmc.mh import MHKernel
    from nfmc_torch.samplers.nfmc import NeuTraMH

    return _neutra(NeuTraMH, mesh, 38,
                   inner_kernel=MHKernel(event_size=D, inv_mass_diag=np.full(D, 0.6)))


def neutra_chees(mesh, workdir):
    """NeuTra-ChEES: the inner ChEES-HMC's tuning (the cross-chain ChEES
    gradient) in the latent space."""
    from nfmc_torch.samplers.mcmc.chees import CheesHMCKernel
    from nfmc_torch.samplers.nfmc import NeuTraChEES

    return _neutra(NeuTraChEES, mesh, 39,
                   inner_kernel=CheesHMCKernel(event_size=D, max_leapfrog_steps=8))


def _jump(cls, mesh, seed, fit_kwargs, inner_kernel=None, **kw):
    """A jump sampler: its warmup (the inner tuning, then the flow's fit on
    every chain's draws), then ``fit_nf=True`` sampling."""
    from nfmc_torch.core.sampler import NFMCKernel
    from nfmc_torch.samplers.nfmc.jump import JumpNFMCParameters

    s = cls((D,), _target(), *kw.pop("args", ()), kernel=NFMCKernel((D,), flow=_flow()),
            params=JumpNFMCParameters(fit_nf=True, n_jumps_before_training=1,
                                      flow_fit_kwargs=fit_kwargs),
            inner_kernel=inner_kernel, device="cpu")
    s.params.n_iterations = 3
    s.inner_sampler.params.n_iterations = 2
    s.inner_sampler.params.n_warmup_iterations = 6
    _entry(s.warmup, _x0(seed), mesh, seed=8)
    fitted = _flat(s.kernel.flow.params)
    out = _entry(s.sample, _x0(seed), mesh, seed=9)
    return _result(out, warm_flow=fitted, flow=_flat(s.kernel.flow.params))


FUSED = {"n_epochs": 2, "lr": 5e-3, "batch_size": 8}
HOST = {**FUSED, "early_stopping": True, "early_stopping_threshold": 5}


def jump_ula(mesh, workdir):
    from nfmc_torch.samplers.nfmc import JumpULA

    return _jump(JumpULA, mesh, 40, FUSED)


def jump_hmc(mesh, workdir):
    """JumpHMC with early-stopping refits (the host route)."""
    from nfmc_torch.samplers.mcmc.hmc import HMCKernel
    from nfmc_torch.samplers.nfmc import JumpHMC

    return _jump(JumpHMC, mesh, 41, HOST,
                 HMCKernel(event_size=D, n_leapfrog_steps=4, step_size=0.3))


def jump_uhmc(mesh, workdir):
    from nfmc_torch.samplers.mcmc.hmc import HMCKernel
    from nfmc_torch.samplers.nfmc import JumpUHMC

    return _jump(JumpUHMC, mesh, 42, FUSED,
                 HMCKernel(event_size=D, n_leapfrog_steps=4, step_size=0.2))


def jump_mh(mesh, workdir):
    from nfmc_torch.samplers.mcmc.mh import MHKernel
    from nfmc_torch.samplers.nfmc import JumpMH

    return _jump(JumpMH, mesh, 43, FUSED, MHKernel(event_size=D, inv_mass_diag=np.full(D, 0.6)))


def jump_ess(mesh, workdir):
    """JumpESS on the chunked route: the runner cuts the shrink uniforms by
    their chain axis (after the shrink steps) and each outer iteration's
    prior redraw by its rows."""
    from nfmc_torch.samplers.nfmc import JumpESS

    return _jump(JumpESS, mesh, 44, FUSED, args=(_target(),))


def jump_nuts(mesh, workdir):
    from nfmc_torch.samplers.mcmc.nuts import NUTSKernel
    from nfmc_torch.samplers.nfmc import JumpNUTS

    return _jump(JumpNUTS, mesh, 45, FUSED, NUTSKernel(event_size=D, max_tree_depth=4))


def jump_chees(mesh, workdir):
    """JumpChEES: the jitter drawn whole, the leapfrog counts hoisted."""
    from nfmc_torch.samplers.mcmc.chees import CheesHMCKernel
    from nfmc_torch.samplers.nfmc import JumpChEES

    return _jump(JumpChEES, mesh, 46, FUSED, CheesHMCKernel(event_size=D, max_leapfrog_steps=8))


def jump_aies(mesh, workdir):
    """JumpAIES: the stretch moves' draws kept whole, indexed by walker."""
    from nfmc_torch.samplers.nfmc import JumpAIES

    return _jump(JumpAIES, mesh, 47, FUSED)


def aies_odd(mesh, workdir):
    """AIES on 12 walkers: on three ranks, rank 1's block lies across both
    halves."""
    from nfmc_torch.samplers.mcmc import AIES

    s = AIES((D,), _target(), device="cpu")
    s.params.n_warmup_iterations = 8
    s.params.n_iterations = 6
    x0 = _x0(48, n=AIES_WALKERS)
    _entry(s.warmup, x0, mesh, seed=13)
    return _result(_entry(s.sample, x0, mesh, seed=14), step_size=s.kernel.a)


def _transport_problem():
    from nfmc_torch.api.registry import create_flow_object
    from nfmc_torch.potentials import DiagonalGaussian, StandardGaussian

    prior = StandardGaussian((TR_D,))
    target = DiagonalGaussian(mu=np.full(TR_D, 2.0), sigma=np.full(TR_D, 0.5))
    return prior, target, create_flow_object(TR_FLOW, (TR_D,), seed=0).to("cpu")


def _prior_sample(prior, mesh):
    """``prior_sample`` sharded over ``mesh`` where the group tiles it, as
    ``tests/test_sharding.py``'s; a group that does not stays whole."""
    from nfmc_torch.parallel import shard_chains

    def sample(batch_shape, generator=None):
        x = prior.sample(batch_shape, generator=generator)
        if mesh is None or x.shape[0] % mesh.size(0):
            return x
        return shard_chains(x, mesh)

    return sample


def _transport_result(out):
    r = {"log_Z": float(out["log_Z"]), "particles": np.asarray(out["particles"]),
         "history": np.asarray(out["history"])}
    for k in ("log_weights", "ess_trace", "beta_trace", "acceptance_trace"):
        if k in out:
            r[k] = np.asarray(out[k], np.float64)
    return r


def _aft(mesh, n_train_epochs):
    from nfmc_torch.transport.aft import AnnealedFlowTransport

    prior, target, flow = _transport_problem()
    algorithm = AnnealedFlowTransport(prior, target, flow, n_steps=4,
                                      n_train_epochs=n_train_epochs)
    n, n_train, n_val = AFT_SIZES
    out = algorithm.run(_prior_sample(prior, mesh), n_particles=n, n_train_particles=n_train,
                        n_val_particles=n_val, full_output=True, seed=0)
    return {**_transport_result(out), "flow": _flat(flow.params)}


def aft_nofit(mesh, workdir):
    """AFT with the fits off: the transports are the identity, so the SMC
    arithmetic is the unsharded run's up to the order of its sums. The val
    group (51 particles) does not tile two ranks and stays whole."""
    return _aft(mesh, 0)


def aft_fit(mesh, workdir):
    """AFT with 3 epochs a level: each a step summed over the ranks."""
    return _aft(mesh, 3)


def aft_level_fit(mesh, workdir):
    """One AFT level fit, the train group sharded and the val group whole
    on every rank: each rank's share of both losses (all of the val loss
    on rank 0), one all_reduce a step; the best val loss is the unsharded
    one."""
    import torch

    from nfmc_torch.core.chains import ChainShard
    from nfmc_torch.transport.aft import AnnealedFlowTransport

    prior, target, flow = _transport_problem()
    g = torch.Generator().manual_seed(5)
    x_train, x_val = prior.sample((32,), generator=g), prior.sample((16,), generator=g)
    w_train = torch.softmax(0.3 * torch.randn(32, generator=g), 0)
    w_val = torch.softmax(0.3 * torch.randn(16, generator=g), 0)
    shard = None if mesh is None else ChainShard(mesh)
    rows = (lambda t: t) if shard is None else shard.rows
    params, best = AnnealedFlowTransport(prior, target, flow, n_train_epochs=3)._fit_level(
        flow.params, rows(x_train), rows(w_train), x_val, w_val, 0.5, (shard, None))
    return {"flow": _flat(params), "best": float(best)}


def pmc(mesh, workdir):
    """PMC: the temperature from the gathered potentials, the weighted fit
    data-parallel, the pCN sweep's acceptance over every particle."""
    from nfmc_torch.transport.pmc import PreconditionedMonteCarlo

    prior, target, flow = _transport_problem()
    out = PreconditionedMonteCarlo(prior, target, flow).run(
        _prior_sample(prior, mesh), n_particles=PMC_N, full_output=True, seed=0)
    return {**_transport_result(out), "flow": _flat(flow.params)}


def transport_refusals(mesh, workdir):
    """CRAFT, AIS, nested sampling, SNF and FAB given a DTensor: each raises
    NotImplementedError naming ROADMAP 1.8d."""
    from nfmc_torch.flow_training import FAB
    from nfmc_torch.parallel import replicate
    from nfmc_torch.transport import CRAFT, SNF, NestedSampling, ais
    from nfmc_torch.transport.snf import HMCLayer

    prior, target, flow = _transport_problem()
    sharded = _prior_sample(prior, mesh)
    x0 = sharded((16,))
    runs = {
        "craft": lambda: CRAFT(prior, target, [flow.bijection], n_mcmc_steps=1).sample(
            sharded, n_particles=16, seed=0),
        "ais": lambda: ais.ais_base(x0, prior, target, n_steps=2, device="cpu"),
        "ais_chain": lambda: ais.make_ais(prior, target, n_steps=2)(x0, []),
        "ns": lambda: NestedSampling(_ShardedPrior(prior, mesh), lambda x: -target(x), flow,
                                        n_live_points=16).run(n_iterations=1, seed=0),
        "snf": lambda: SNF([HMCLayer((TR_D,))], target, prior, seed=0,
                               device="cpu").inverse(x0, seed=0),
        "snf_fit": lambda: SNF([HMCLayer((TR_D,))], target, prior, seed=0,
                                   device="cpu").fit(x0, n_epochs=1, seed=0),
    }
    fab_flow = _transport_problem()[2]
    fab_flow.params = replicate(fab_flow.params, mesh)
    runs["fab"] = lambda: FAB(target, fab_flow).run(n_iterations=1, seed=0)
    caught = {}
    for name, run in runs.items():
        try:
            run()
            caught[name] = "no error"
        except NotImplementedError as e:
            caught[name] = f"NotImplementedError: {e}"
    return {"caught": caught}


class _ShardedPrior:
    """A prior whose draws come sharded over ``mesh`` (nested sampling's
    live points)."""

    def __init__(self, prior, mesh):
        self.prior, self.sample = prior, _prior_sample(prior, mesh)

    def __call__(self, x):
        return self.prior(x)


SCENARIOS = {f.__name__: f for f in (
    ula, uhmc, mh, random_walk, nuts, ess_dense, ess_diag, adaptive_imh_fused, adaptive_imh_host,
    neutra_mh, neutra_chees, jump_ula, jump_hmc, jump_uhmc, jump_mh, jump_ess, jump_nuts,
    jump_chees, jump_aies, aft_nofit, aft_fit, aft_level_fit, pmc, transport_refusals)}
# run on three ranks
ODD_SCENARIOS = {"aies_odd": aies_odd}


def run_rank(rank: int, world: int, workdir: str, names) -> None:
    """One rank of ``tests/parallel_ranks.py::run_rank`` over these
    scenarios (those of ``ODD_SCENARIOS`` too)."""
    _run_rank(rank, world, workdir, names, {**SCENARIOS, **ODD_SCENARIOS})
