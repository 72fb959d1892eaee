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
import torch

from tests.parallel_ranks import D, _entry, _flat, _flow, _metropolis, _result, _target, _x0
from tests.parallel_ranks import run_rank as _run_rank

# the transport runs: tests/test_sharding.py's target and flow
TR_D, AFT_SIZES, PMC_N = 3, (64, 100, 51), 128
TR_FLOW = 'realnvp%{"n_layers": 2, "hidden_size": 16}'
# CRAFT's particles, levels and training passes; AIS's particles and
# levels; SNF's batch and epochs; nested sampling's live points and
# iterations (past 2 x NS_LIVE, where the flow proposes); FAB's iterations
CRAFT_N, CRAFT_LEVELS, CRAFT_PASSES = 64, 3, 3
AIS_N, AIS_STEPS = 128, 4
SNF_N, SNF_EPOCHS = 64, 3
NS_LIVE, NS_ITERS = 16, 40
FAB_ITERS = 2
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


def _aft(mesh, n_train_epochs, seed=0):
    from nfmc_torch.transport.aft import AnnealedFlowTransport

    prior, target, flow = _transport_problem()
    algorithm = AnnealedFlowTransport(prior, target, flow, n_steps=4,
                                      n_train_epochs=n_train_epochs)
    n, n_train, n_val = AFT_SIZES
    out = algorithm.run(_prior_sample(prior, mesh), n_particles=n, n_train_particles=n_train,
                        n_val_particles=n_val, full_output=True, seed=seed)
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


def pmc(mesh, workdir, seed=0):
    """PMC: the temperature from the gathered potentials, the weighted fit
    data-parallel, the pCN sweep's acceptance over every particle."""
    from nfmc_torch.transport.pmc import PreconditionedMonteCarlo

    prior, target, flow = _transport_problem()
    out = PreconditionedMonteCarlo(prior, target, flow).run(
        _prior_sample(prior, mesh), n_particles=PMC_N, full_output=True, seed=seed)
    return {**_transport_result(out), "flow": _flat(flow.params)}


def _sharded(x, mesh):
    """``x`` sharded over ``mesh`` (as it is without one)."""
    from nfmc_torch.parallel import shard_chains

    return x if mesh is None else shard_chains(x, mesh)


def _perturbed_bijections(n_levels, pert=0.05):
    """CRAFT's level maps: the transport flow's init at seeds 0.., each
    weight moved ``pert`` N(0, 1) (numpy, the level's seed), so that the
    untrained maps are not the identity."""
    import torch

    from nfmc_torch.api.registry import create_flow_object
    from nfmc_torch.utils import tree_map

    out = []
    for i in range(n_levels):
        b = create_flow_object(TR_FLOW, (TR_D,), seed=i).to("cpu").bijection
        rng = np.random.default_rng(100 + i)
        b.params = tree_map(lambda t: t + torch.from_numpy(
            pert * rng.standard_normal(tuple(t.shape)).astype(np.float32)), b.params)
        out.append(b)
    return out


def _craft(mesh, n_training_steps, seeds=(1, 2)):
    from nfmc_torch.transport import CRAFT

    prior, target, _ = _transport_problem()
    algorithm = CRAFT(prior, target, _perturbed_bijections(CRAFT_LEVELS), n_mcmc_steps=2,
                      lr=1e-2)
    sample = _prior_sample(prior, mesh)
    if n_training_steps:
        algorithm.train(sample, n_particles=CRAFT_N, n_training_steps=n_training_steps,
                        seed=seeds[0])
    out = algorithm.sample(sample, n_particles=CRAFT_N, seed=seeds[1])
    flows = np.concatenate([_flat(b.params) for b in algorithm.bijections])
    return {**_transport_result(out), "flow": flows}


def craft_sample(mesh, workdir):
    """CRAFT's sampling pass with untrained (perturbed) maps: global
    softmaxes, log-sums and ESS, the resample on the gathered group."""
    return _craft(mesh, 0)


def craft_train(mesh, workdir):
    """CRAFT trained for CRAFT_PASSES passes, each level's AdamW step on
    the loss summed over the ranks, then sampled."""
    return _craft(mesh, CRAFT_PASSES)


def _ais_start(mesh):
    prior, target, _ = _transport_problem()
    g = torch.Generator().manual_seed(21)
    return prior, target, g, _sharded(prior.sample((AIS_N,), generator=g), mesh)


def ais_base(mesh, workdir, seeded=True):
    """``ais_base`` on a sharded start: each rank anneals its rows with its
    rows of the global draws, the result gathered (the draws from the
    start's generator, or ``seeded=False`` from the global stream)."""
    from nfmc_torch.transport.ais import ais_base as run

    prior, target, g, x0 = _ais_start(mesh)
    x, log_w = run(x0, prior, target, n_steps=AIS_STEPS, n_mcmc_steps=2, step_size=0.1,
                   generator=g if seeded else None, device="cpu")
    return {"particles": x.numpy(), "log_w": log_w.numpy(),
            "plain": type(x) is torch.Tensor and type(log_w) is torch.Tensor}


def ais_chain(mesh, workdir):
    """``make_ais``'s chain called on a sharded start with the global draws."""
    from nfmc_torch.transport.ais import make_ais

    prior, target, g, x0 = _ais_start(mesh)
    run = make_ais(prior, target, n_steps=AIS_STEPS, n_mcmc_steps=2, step_size=0.1)
    x, log_w = run(x0, run.draws(g, tuple(x0.shape)))
    return {"particles": x.numpy(), "log_w": log_w.numpy(),
            "plain": type(x) is torch.Tensor and type(log_w) is torch.Tensor}


def _snf():
    """An SNF with a layer of each kind: MALA (draws with the particle axis
    first), RealNVP, HMC and MH (the steps first)."""
    from nfmc_torch.flows import RealNVP
    from nfmc_torch.transport.snf import SNF, FlowLayer, HMCLayer, MALALayer, MHLayer

    prior, target, _ = _transport_problem()
    layers = [MALALayer((TR_D,), time_step=0.1), FlowLayer(RealNVP((TR_D,), n_layers=2,
                                                                    hidden_size=8)),
              HMCLayer((TR_D,), n_steps=2, n_leapfrog=3), MHLayer((TR_D,), n_steps=2)]
    return prior, SNF(layers, target, prior, seed=0, device="cpu")


def snf_inverse(mesh, workdir, seed=3):
    """SNF's inverse of a sharded batch: each layer's rows of its draws."""
    prior, model = _snf()
    z = prior.sample((SNF_N,), generator=torch.Generator().manual_seed(22))
    history, x, log_w = model.inverse(_sharded(z, mesh), seed=seed)
    return {"history": history.numpy(), "particles": x.numpy(), "log_w": log_w.numpy()}


def snf_fit(mesh, workdir, seed=4):
    """SNF fit SNF_EPOCHS epochs on a sharded batch (the mean over the ranks'
    rows, one all_reduce a step), then log Z on fresh draws, unsharded."""
    prior, model = _snf()
    z = prior.sample((SNF_N,), generator=torch.Generator().manual_seed(23))
    model.fit(_sharded(z, mesh), n_epochs=SNF_EPOCHS, seed=seed)
    z_eval = prior.sample((SNF_N,), generator=torch.Generator().manual_seed(24))
    _, _, log_w = model.inverse(z_eval, seed=5)
    return {"log_Z": float(torch.logsumexp(log_w, 0) - np.log(SNF_N)),
            "loss": model.loss_trace.numpy(),
            "flow": np.concatenate([_flat(p) for p in model.params if p])}


def _replicated(params, mesh):
    from nfmc_torch.parallel import replicate

    return params if mesh is None else replicate(params, mesh)


def _placements(params, mesh):
    """Whether every parameter is a DTensor replicated over ``mesh``."""
    from torch.distributed.tensor import Replicate

    from nfmc_torch.core.chains import is_sharded
    from nfmc_torch.utils import tree_leaves

    return all(is_sharded(t) and t.device_mesh == mesh
               and all(p == Replicate() for p in t.placements) for t in tree_leaves(params))


def _local_flat(params):
    from nfmc_torch.core.chains import local_params

    return _flat(local_params(params)[0])


def ns(mesh, workdir, seed=0):
    """Nested sampling with live points drawn sharded and a flow replicated
    over the mesh: made whole, then the unsharded run on every rank, past
    the flow's refits (seeded from the run's generator) and into its
    proposals."""
    from nfmc_torch.transport import NestedSampling

    prior, target, flow = _transport_problem()
    flow.params = _replicated(flow.params, mesh)
    out = NestedSampling(_ShardedPrior(prior, mesh), lambda x: -target(x), flow,
                         n_live_points=NS_LIVE, n_population_draws=16,
                         flow_fit_kwargs={"n_epochs": 3, "lr": 0.01}).run(
        n_iterations=NS_ITERS, seed=seed)
    return {"log_Z": out["log_Z"], "live": out["live_points"], "dead": out["dead_points"],
            "flow": _local_flat(flow.params),
            "replicated": mesh is None or _placements(flow.params, mesh)}


def fab(mesh, workdir, seed=0):
    """FAB with the flow's parameters replicated over the mesh: each rank
    runs the unsharded run on its copy; the parameters come back
    replicated."""
    from nfmc_torch.flow_training import FAB

    _, target, flow = _transport_problem()
    flow.params = _replicated(flow.params, mesh)
    algorithm = FAB(target, flow, buffer_size=64, n_ais_steps=2)
    trained = algorithm.run(n_iterations=FAB_ITERS, n_flow_training_steps=3, n_ais_particles=16,
                            n_training_particles=8, seed=seed)
    return {"flow": _local_flat(trained.params), "loss": algorithm.loss_trace.numpy(),
            "replicated": mesh is None or _placements(trained.params, mesh)}


def fab_sharded_parameter(mesh, workdir):
    """FAB given a flow with a parameter placed ``Shard(0)``: the error."""
    from nfmc_torch.flow_training import FAB
    from nfmc_torch.utils import tree_leaves, tree_unflatten

    _, target, flow = _transport_problem()
    leaves = tree_leaves(_replicated(flow.params, mesh))
    leaves[0] = _sharded(leaves[0].to_local(), mesh)
    flow.params = tree_unflatten(flow.params, leaves)
    try:
        FAB(target, flow).run(n_iterations=1, seed=0)
    except ValueError as e:
        return {"caught": f"ValueError: {e}"}
    return {"caught": "no error"}


def _unseeded(run):
    """The scenario ``run(mesh, workdir)`` given no seed (nor generator),
    with the global stream pinned and then, on the mesh's second rank,
    advanced by one seed: the ranks must draw from the first rank's seed,
    and so match the unsharded run from the same stream."""
    def scenario(mesh, workdir):
        from nfmc_torch import set_seed
        from nfmc_torch.core.rng import next_seed

        set_seed(7)
        if mesh is not None and mesh.get_local_rank(0) == 1:
            next_seed()
        return run(mesh, workdir)

    return scenario


# each transport method given no seed, and the scenario it is held to
UNSEEDED = {
    "craft_train": lambda mesh, workdir: _craft(mesh, CRAFT_PASSES, seeds=(None, None)),
    "ais_base": lambda mesh, workdir: ais_base(mesh, workdir, seeded=False),
    "snf_inverse": lambda mesh, workdir: snf_inverse(mesh, workdir, seed=None),
    "snf_fit": lambda mesh, workdir: snf_fit(mesh, workdir, seed=None),
    "ns": lambda mesh, workdir: ns(mesh, workdir, seed=None),
    "fab": lambda mesh, workdir: fab(mesh, workdir, seed=None),
    "aft_nofit": lambda mesh, workdir: _aft(mesh, 0, seed=None),
    "pmc": lambda mesh, workdir: pmc(mesh, workdir, seed=None),
}


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
    jump_chees, jump_aies, aft_nofit, aft_fit, aft_level_fit, pmc, craft_sample, craft_train,
    ais_base, ais_chain, snf_inverse, snf_fit, ns, fab, fab_sharded_parameter)}
SCENARIOS.update({f"unseeded_{k}": _unseeded(run) for k, run in UNSEEDED.items()})
# run on three ranks
ODD_SCENARIOS = {"aies_odd": aies_odd}


def run_rank(rank: int, world: int, workdir: str, names) -> None:
    """One rank of ``tests/parallel_ranks.py::run_rank`` over these
    scenarios (those of ``ODD_SCENARIOS`` too)."""
    _run_rank(rank, world, workdir, names, {**SCENARIOS, **ODD_SCENARIOS})
