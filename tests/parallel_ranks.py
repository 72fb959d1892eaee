"""The rank side of ``tests/test_torch_parallel.py``: the scenarios that run
chain-sharded on a 2-rank gloo group on the CPU, and unsharded in the test
process for comparison.

It imports only torch, numpy and ``nfmc_torch``, so that the spawned ranks
never import JAX (nor ``tests/conftest.py``). Each scenario is a function of
``(mesh, workdir)``; ``mesh=None`` runs it without a mesh. It returns a dict
of numpy arrays and numbers, or raises.
"""
import os
import pickle
import time
import traceback
from datetime import timedelta

import numpy as np
import torch

D, C = 5, 16
FLOW = 'realnvp%{"n_layers": 2, "hidden_size": 8}'


def _target():
    from nfmc_torch.potentials import StandardGaussian

    return StandardGaussian((D,))


def _x0(seed, n=C):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32))


def _flow(seed=0):
    from nfmc_torch.flows import Flow, RealNVP

    return Flow(RealNVP((D,), n_layers=2, hidden_size=8), seed=seed)


def _flat(params):
    from nfmc_torch.utils import tree_leaves

    return torch.cat([t.detach().reshape(-1) for t in tree_leaves(params)]).numpy()


def _result(out, **extra):
    st = out.statistics
    r = {"samples": None if out.samples is None else out.samples.numpy(),
         "last": out.running_samples.last_sample.numpy(),
         "mean": np.asarray(out.mean, np.float64),
         "counters": [st.n_accepted_trajectories, st.n_attempted_trajectories,
                      st.n_divergences, st.n_target_calls, st.n_target_gradient_calls,
                      getattr(st, "n_accepted_jumps", 0), getattr(st, "n_attempted_jumps", 0)]}
    r.update(extra)
    return r


def _entry(entry, x0, mesh, **kw):
    """``entry(x0)``, with ``x0`` sharded over ``mesh`` when given."""
    from nfmc_torch.parallel import shard_chains

    if mesh is not None:
        x0 = shard_chains(x0, mesh, axis_name=mesh.mesh_dim_names[0])
    return entry(x0, show_progress=False, **kw)


def _metropolis(s):
    return {"step_size": s.kernel.step_size, "inv_mass": np.asarray(s.kernel.inv_mass_diag)}


def mala(mesh, workdir):
    from nfmc_torch.parallel import sharded_sample
    from nfmc_torch.samplers.mcmc import MALA

    s = MALA((D,), _target(), device="cpu")
    s.params.n_iterations = 4
    if mesh is None:
        return _result(s.sample(_x0(0), show_progress=False, seed=7))
    return _result(sharded_sample(s, _x0(0), mesh=mesh, show_progress=False, seed=7))


def hmc(mesh, workdir):
    """HMC with its tuning warmup (dual averaging, inverse-mass EMA)."""
    from nfmc_torch.samplers.mcmc import HMC

    s = HMC((D,), _target(), device="cpu")
    s.params.n_warmup_iterations = 30  # fewer leave a step that accepts nothing
    s.params.n_iterations = 4
    _entry(s.warmup, _x0(1), mesh, seed=3)
    return _result(_entry(s.sample, _x0(1), mesh, seed=4), **_metropolis(s))


def imh(mesh, workdir):
    """FixedIMH after its reverse-KL warmup (``variational_fit(mesh=...)``)."""
    from nfmc_torch.samplers.nfmc import FixedIMH, IMHKernel

    s = FixedIMH((D,), _target(), IMHKernel((D,), flow=_flow()), device="cpu")
    s.params.warmup_fit_kwargs = {"n_epochs": 6, "n_samples": 32, "lr": 1e-2}
    s.params.n_iterations = 6
    warm = _entry(s.warmup, _x0(2), mesh, seed=5)
    return _result(_entry(s.sample, _x0(2), mesh, seed=6), flow=_flat(s.kernel.flow.params),
                   warm=warm.samples.numpy())


def _jump(mesh, fit_kwargs):
    from nfmc_torch.samplers.nfmc import JumpMALA
    from nfmc_torch.samplers.nfmc.jump import JumpNFMCParameters
    from nfmc_torch.core.sampler import NFMCKernel

    s = JumpMALA((D,), _target(), kernel=NFMCKernel((D,), flow=_flow()),
                 params=JumpNFMCParameters(fit_nf=True, n_jumps_before_training=1,
                                           flow_fit_kwargs=fit_kwargs), device="cpu")
    s.params.n_iterations = 3
    s.inner_sampler.params.n_iterations = 2
    s.inner_sampler.params.n_warmup_iterations = 6
    _entry(s.warmup, _x0(3), mesh, seed=8)
    fitted = _flat(s.kernel.flow.params)
    out = _entry(s.sample, _x0(3), mesh, seed=9)
    return _result(out, warm_flow=fitted, flow=_flat(s.kernel.flow.params), **_metropolis(
        s.inner_sampler))


def jump_mala_fused(mesh, workdir):
    """JumpMALA: the warmup's fit (``fit(mesh=...)``), then ``fit_nf=True``
    with fixed-effort refits inside the chunk (the fused route)."""
    return _jump(mesh, {"n_epochs": 2, "lr": 5e-3, "batch_size": 8})


def jump_mala_host(mesh, workdir):
    """The same with early-stopping refits (the host route, ``Flow.fit``)."""
    return _jump(mesh, {"n_epochs": 2, "lr": 5e-3, "batch_size": 8, "early_stopping": True,
                        "early_stopping_threshold": 5})


def front_door(mesh, workdir):
    """``sample(..., mesh=...)`` with ``warmup=True`` (jump_mala)."""
    import nfmc_torch

    out = nfmc_torch.sample(_target(), strategy="jump_mala", flow=FLOW, n_chains=C,
                            n_iterations=3, n_warmup_iterations=6, warmup=True, seed=11,
                            inner_param_kwargs={"n_iterations": 2},
                            param_kwargs={"flow_fit_kwargs": {"n_epochs": 3, "batch_size": 16}},
                            device="cpu", show_progress=False, mesh=mesh)
    return _result(out, flow=_flat(out.kernel.flow.params))


def front_door_checkpoint(mesh, workdir):
    """``sample(..., mesh=..., checkpoint_path=...)``: MALA with its warmup,
    three segments, each sharded through ``shard_fn``."""
    import nfmc_torch

    path = os.path.join(workdir, "ck_" + ("plain" if mesh is None else "sharded"))
    out = nfmc_torch.sample(_target(), strategy="mala", n_chains=C, n_iterations=6,
                            n_warmup_iterations=4, warmup=True, seed=12, device="cpu",
                            show_progress=False, mesh=mesh, checkpoint_path=path,
                            checkpoint_segment_iterations=2)
    return _result(out, left=os.path.exists(path + ".npz"))


def resumable_shard_fn(mesh, workdir):
    """``sample_resumable`` with a ``shard_fn`` that counts its calls: it
    re-shards between segments (three segments, three calls)."""
    from nfmc_torch.checkpoint import sample_resumable
    from nfmc_torch.parallel import shard_chains
    from nfmc_torch.samplers.mcmc import MALA

    s = MALA((D,), _target(), device="cpu")
    s.params.n_iterations = 12
    pinned = []
    shard_fn = None
    if mesh is not None:
        def shard_fn(v):
            v = shard_chains(v, mesh)
            pinned.append(tuple(v.to_local().shape))
            return v

    path = os.path.join(workdir, "rs_" + ("plain" if mesh is None else "sharded"))
    x0 = _x0(13) if mesh is None else shard_chains(_x0(13), mesh)
    out = sample_resumable(s, x0, path, segment_iterations=4, seed=2, shard_fn=shard_fn)
    return _result(out, pinned=pinned)


def mala_divergent(mesh, workdir):
    """MALA on a Gaussian walled off at |x_i| > 1.5 (U = inf there) with a
    step of 0.05: in 9 of the 12 iterations some proposal hits the wall, on
    one rank or both, and a divergence counts once an iteration (not once a
    rank)."""
    from nfmc_torch.parallel import sharded_sample
    from nfmc_torch.samplers.mcmc import MALA
    from nfmc_torch.samplers.mcmc.langevin import LangevinKernel

    s = MALA((D,), _walled, LangevinKernel(event_size=D, step_size=0.05), device="cpu")
    s.params.n_iterations = 12
    x0 = 0.3 * _x0(15)
    if mesh is None:
        return _result(s.sample(x0, show_progress=False, seed=1))
    return _result(sharded_sample(s, x0, mesh=mesh, show_progress=False, seed=1))


def mala_divergent_graphed(mesh, workdir):
    """``mala_divergent`` through the capture layer's protocol (each chunk
    replays one iteration's body over static buffers, without capture):
    each rank writes its divergence flags at the counter, and a divergence
    still counts once an iteration."""
    from nfmc_torch.core import graphs

    with graphs.without_capture():
        return mala_divergent(mesh, workdir)


def jump_divergent_graphed(mesh, workdir):
    """JumpMALA with a frozen flow on the walled Gaussian, through the
    protocol: the outer iteration's inner divergence flags at the counter,
    pipelined and in synced chunks."""
    from nfmc_torch.core import graphs
    from nfmc_torch.core.sampler import NFMCKernel
    from nfmc_torch.parallel import sharded_sample
    from nfmc_torch.samplers.mcmc.langevin import LangevinKernel
    from nfmc_torch.samplers.nfmc import JumpMALA

    results = {}
    for label, limit in (("pipelined", None), ("synced", 1e9)):
        s = JumpMALA((D,), _walled, kernel=NFMCKernel((D,), flow=_flow()),
                     inner_kernel=LangevinKernel(event_size=D, step_size=0.05), device="cpu")
        s.params.n_iterations = 6
        s.inner_sampler.params.n_iterations = 2
        x0 = 0.3 * _x0(16)
        with graphs.without_capture():
            if mesh is None:
                out = s.sample(x0, show_progress=False, seed=2, time_limit_seconds=limit)
            else:
                out = sharded_sample(s, x0, mesh=mesh, show_progress=False, seed=2,
                                     time_limit_seconds=limit)
        results[label] = out
    r = _result(results["pipelined"])
    synced = _result(results["synced"])
    r.update(synced_samples=synced["samples"], synced_counters=np.asarray(synced["counters"]))
    return r


def _walled(x):
    u = 0.5 * (x ** 2).sum(-1)
    return torch.where((x.abs() > 1.5).any(-1), torch.full_like(u, float("inf")), u)


def _dense(cls, mesh):
    s = cls((D,), _target(), device="cpu")
    s.params.n_warmup_iterations = 16
    s.params.metric_refresh_every = 4
    s.params.n_iterations = 4
    _entry(s.warmup, _x0(16), mesh, seed=3)
    out = _entry(s.sample, _x0(16), mesh, seed=4)
    return _result(out, step_size=s.kernel.step_size, mass_cov=np.asarray(s.kernel.mass_cov))


def dense_mala(mesh, workdir):
    """DenseMALA's warmup: the split-half covariance EMAs over the global
    chains (even and odd indices), the refresh, dual averaging."""
    from nfmc_torch.samplers.mcmc import DenseMALA

    return _dense(DenseMALA, mesh)


def dense_hmc(mesh, workdir):
    from nfmc_torch.samplers.mcmc import DenseHMC

    return _dense(DenseHMC, mesh)


def neutra_hmc(mesh, workdir):
    """NeuTraHMC: its reverse-KL warmup, the inner HMC's tuning in the
    latent space, then sampling with the data-space moments."""
    from nfmc_torch.samplers.mcmc.hmc import HMCKernel
    from nfmc_torch.samplers.nfmc import NeuTraHMC
    from nfmc_torch.samplers.nfmc.neutra import NeuTraKernel

    # 5 leapfrogs, not 20: the test's time; 30 warmup iterations leave a
    # step that accepts
    s = NeuTraHMC((D,), _target(), inner_kernel=HMCKernel(event_size=D, n_leapfrog_steps=5),
                  kernel=NeuTraKernel((D,), flow=_flow()), device="cpu")
    s.params.warmup_fit_kwargs = {"n_epochs": 5, "n_samples": 32, "lr": 1e-2}
    s.params.n_warmup_iterations = 30
    s.params.n_iterations = 4
    _entry(s.warmup, _x0(17), mesh, seed=5)
    out = _entry(s.sample, _x0(17), mesh, seed=6)
    return _result(out, flow=_flat(s.kernel.flow.params), **_metropolis(s.inner_sampler))


def _tess(mesh, fit_kwargs):
    from nfmc_torch.samplers.nfmc import TESS
    from nfmc_torch.samplers.nfmc.tess import TESSKernel

    s = TESS((D,), _target(), _target(), kernel=TESSKernel((D,), flow=_flow()), device="cpu")
    s.params.flow_fit_kwargs = fit_kwargs
    s.params.n_warmup_iterations = 3
    s.params.n_iterations = 5
    warm = _entry(s.warmup, _x0(18), mesh, seed=7)
    out = _entry(s.sample, _x0(18), mesh, seed=8)
    return _result(out, flow=_flat(s.kernel.flow.params), warm=warm.samples.numpy(),
                   warm_counters=warm.statistics.n_accepted_trajectories)


def tess_fused(mesh, workdir):
    """TESS: the warmup with fixed-effort refits in the chunked driver (on
    all the chains' draws), then sampling."""
    return _tess(mesh, {"n_epochs": 2, "lr": 5e-3, "batch_size": 8})


def tess_host(mesh, workdir):
    """TESS: the warmup's host loop (early-stopping refits through
    ``fit(mesh=...)``), then sampling."""
    return _tess(mesh, {"n_epochs": 2, "lr": 5e-3, "batch_size": 8, "early_stopping": True,
                        "early_stopping_threshold": 5})


def _dlmc(mesh, fit_kwargs):
    from nfmc_torch.samplers.nfmc import DLMC
    from nfmc_torch.samplers.nfmc.dlmc import DLMCKernel

    s = DLMC((D,), _target(), _target(), kernel=DLMCKernel((D,), flow=_flow()), device="cpu")
    s.params.flow_fit_kwargs = fit_kwargs
    s.params.n_iterations = 4
    _entry(s.warmup, _x0(19), mesh, seed=9)
    out = _entry(s.sample, _x0(19), mesh, seed=10)
    return _result(out, flow=_flat(s.kernel.flow.params))


def dlmc_fused(mesh, workdir):
    """DLMC with fixed-effort refits on all the particles (the chunked
    driver's path)."""
    return _dlmc(mesh, {"n_epochs": 2, "lr": 5e-3, "batch_size": 8})


def dlmc_host(mesh, workdir):
    """DLMC's host loop: early-stopping refits through ``fit(mesh=...)``."""
    return _dlmc(mesh, {"n_epochs": 2, "lr": 5e-3, "batch_size": 8, "early_stopping": True,
                        "early_stopping_threshold": 5})


def _pt(cls, mesh, workdir, tag):
    """Parallel tempering (4 rungs): its tuning warmup (rung steps, the
    inverse mass, the ladder from every chain's swaps), sampling, then a
    continuation from the hot rungs through a checkpoint."""
    from nfmc_torch.checkpoint import sample_resumable
    from nfmc_torch.parallel import shard_chains
    from nfmc_torch.samplers.mcmc.pt import PTKernel

    s = cls((D,), _target(), kernel=PTKernel(event_size=D, n_temps=4), device="cpu")
    s.params.n_warmup_iterations = 8
    s.params.n_iterations = 6
    _entry(s.warmup, _x0(20), mesh, seed=11)
    path = os.path.join(workdir, f"pt_{tag}_" + ("plain" if mesh is None else "sharded"))
    x0 = _x0(20) if mesh is None else shard_chains(_x0(20), mesh)
    out = sample_resumable(s, x0, path, segment_iterations=3, seed=12,
                           shard_fn=None if mesh is None else lambda v: shard_chains(v, mesh))
    st = out.statistics
    return _result(out, betas=np.asarray(s.kernel.betas), step_sizes=np.asarray(s.kernel.step_sizes),
                   hot=s._final_mstate[1].numpy(),
                   swaps=[st.n_accepted_swaps, st.n_attempted_swaps])


def pt_mala(mesh, workdir):
    from nfmc_torch.samplers.mcmc import PTMALA

    return _pt(PTMALA, mesh, workdir, "mala")


def pt_mh(mesh, workdir):
    from nfmc_torch.samplers.mcmc import PTRWMH

    return _pt(PTRWMH, mesh, workdir, "mh")


def pt_hmc(mesh, workdir):
    from nfmc_torch.samplers.mcmc import PTHMC

    return _pt(PTHMC, mesh, workdir, "hmc")


def aies(mesh, workdir):
    """AIES: its stretch tuning, then sampling; each half's partners are
    drawn from the other half over every rank's walkers."""
    from nfmc_torch.samplers.mcmc import AIES

    s = AIES((D,), _target(), device="cpu")
    s.params.n_warmup_iterations = 8
    s.params.n_iterations = 6
    _entry(s.warmup, _x0(21), mesh, seed=13)
    return _result(_entry(s.sample, _x0(21), mesh, seed=14), step_size=s.kernel.a)


def chees_hmc(mesh, workdir):
    """ChEES-HMC in tuning mode: dual averaging on the mean acceptance and
    the trajectory length's Adam step on the cross-chain ChEES gradient."""
    from nfmc_torch.samplers.mcmc import CheesHMC

    s = CheesHMC((D,), _target(), device="cpu")
    s.params.n_iterations = 6
    s.params.tuning = True
    out = _entry(s.sample, _x0(22), mesh, seed=15)
    return _result(out, step_size=s.kernel.step_size, inv_mass=np.asarray(s.kernel.inv_mass_diag),
                   trajectory=s.kernel.trajectory_length)


def _mala_on(mesh):
    from nfmc_torch.parallel import sharded_sample
    from nfmc_torch.samplers.mcmc import MALA

    s = MALA((3,), _target3(), device="cpu")
    s.params.n_iterations = 3
    x0 = torch.from_numpy(np.random.default_rng(14).standard_normal((6, 3)).astype(np.float32))
    if mesh is None:
        return _result(s.sample(x0, show_progress=False, seed=2))
    return _result(sharded_sample(s, x0, mesh=mesh, show_progress=False, seed=2))


def _target3():
    from nfmc_torch.potentials import StandardGaussian

    return StandardGaussian((3,))


def mesh_2x1(mesh, workdir):
    """A (2, 1) ('chains', 'data') mesh: chains over the first axis."""
    from torch.distributed.device_mesh import init_device_mesh

    return _mala_on(None if mesh is None else init_device_mesh(
        "cpu", (2, 1), mesh_dim_names=("chains", "data")))


def mesh_1x2(mesh, workdir):
    """A (1, 2) mesh: its first axis has one rank, so each rank runs every
    chain (and 6 chains need not divide the mesh's size)."""
    from torch.distributed.device_mesh import init_device_mesh

    return _mala_on(None if mesh is None else init_device_mesh(
        "cpu", (1, 2), mesh_dim_names=("chains", "data")))


def custom_axis(mesh, workdir):
    """A 1-D mesh whose axis is not named 'chains'."""
    from nfmc_torch.parallel import chain_mesh

    return _mala_on(None if mesh is None else chain_mesh(axis_name="shards", device_type="cpu"))


def rejections(mesh, workdir):
    """Uneven chains raise ValueError (``sharded_sample`` and the front
    door); a sampler class that does not declare multi-rank support itself
    (a subclass of a declared one) raises NotImplementedError naming
    ROADMAP 1.8d."""
    import nfmc_torch
    from nfmc_torch.parallel import sharded_sample
    from nfmc_torch.samplers.mcmc import MALA

    class _Undeclared(MALA):
        pass

    caught = []
    for fn, exc in [
        (lambda: sharded_sample(MALA((D,), _target(), device="cpu"), _x0(0, n=15), mesh=mesh,
                                show_progress=False), ValueError),
        (lambda: nfmc_torch.sample(_target(), strategy="mala", n_chains=15, n_iterations=2,
                                   device="cpu", show_progress=False, mesh=mesh), ValueError),
        (lambda: sharded_sample(_Undeclared((D,), _target(), device="cpu"), _x0(0), mesh=mesh,
                                show_progress=False, seed=0), NotImplementedError),
    ]:
        try:
            fn()
            caught.append("no error")
        except exc as e:
            caught.append(f"{type(e).__name__}: {e}")
    return {"caught": caught}


def _fit_inputs(workdir, timeout_s=120.0):
    """The weights and data the test process carried across from the JAX
    package: it writes them while the ranks start, so wait for the file."""
    path = os.path.join(workdir, "fit_inputs.pkl")
    deadline = time.time() + timeout_s
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(f"no {path} after {timeout_s} s")
        time.sleep(0.05)
    with open(path, "rb") as f:
        return pickle.load(f)


def _fit_flow(inputs):
    from nfmc_torch.flows import Flow, RealNVP

    flow = Flow(RealNVP((inputs["d"],), n_layers=3, hidden_size=16))
    flow.params = inputs["params"]
    return flow


def fit(mesh, workdir):
    """``Flow.fit(mesh=...)`` from the weights and on the data that the test
    process carried across from the JAX package."""
    inputs = _fit_inputs(workdir)
    flow = _fit_flow(inputs)
    flow.fit(inputs["x_train"], x_val=inputs["x_val"], seed=0, mesh=mesh, **inputs["fit_kwargs"])
    return {"flow": _flat(flow.params)}


def variational_fit(mesh, workdir):
    """``Flow.variational_fit(mesh=...)`` on the JAX run's own base draws,
    each rank on its slice of every step's draws."""
    inputs = _fit_inputs(workdir)
    flow = _fit_flow(inputs)
    it = iter(inputs["zs"])
    mu = torch.tensor(inputs["mu"])
    flow.variational_fit(lambda x: -0.5 * ((x - mu) ** 2).sum(-1), seed=0, mesh=mesh,
                         base_draws=lambda g, n: next(it), **inputs["vfit_kwargs"])
    return {"flow": _flat(flow.params)}


DECLINED_ITERS = 6


def _graph_iterations(run) -> int:
    """``run()`` under the capture layer's protocol; the iterations it
    asked of ``IterationGraph.run``."""
    from nfmc_torch.core import graphs

    asked = [0]
    orig = graphs.IterationGraph.run

    def counted(self, n):
        asked[0] += n
        return orig(self, n)

    graphs.IterationGraph.run = counted
    try:
        with graphs.without_capture():
            run()
    finally:
        graphs.IterationGraph.run = orig
    return asked[0]


def pt_mala_declined(mesh, workdir):
    """PT-MALA sampling (its step sums the swap counts over the ranks)
    through the protocol: no graph over several ranks."""
    from nfmc_torch.samplers.mcmc import PTMALA
    from nfmc_torch.samplers.mcmc.pt import PTKernel

    s = PTMALA((D,), _target(), kernel=PTKernel(event_size=D, n_temps=4), device="cpu")
    s.params.n_iterations = DECLINED_ITERS
    return {"graph_iterations": _graph_iterations(lambda: _entry(s.sample, _x0(23), mesh, seed=3))}


def aies_declined(mesh, workdir):
    """AIES sampling (its step gathers the halves over the ranks) through
    the protocol: no graph over several ranks."""
    from nfmc_torch.samplers.mcmc import AIES

    s = AIES((D,), _target(), device="cpu")
    s.params.n_iterations = DECLINED_ITERS
    return {"graph_iterations": _graph_iterations(lambda: _entry(s.sample, _x0(24), mesh, seed=4))}


SCENARIOS = {f.__name__: f for f in (
    mala, hmc, imh, jump_mala_fused, jump_mala_host, front_door, front_door_checkpoint,
    resumable_shard_fn, mala_divergent, mala_divergent_graphed, jump_divergent_graphed,
    dense_mala, dense_hmc, neutra_hmc, tess_fused, tess_host,
    dlmc_fused, dlmc_host, pt_mala, pt_mh, pt_hmc, aies, chees_hmc, mesh_2x1, mesh_1x2, custom_axis, rejections, fit, variational_fit)}


def run_rank(rank: int, world: int, workdir: str, names, scenarios=None) -> None:
    """One rank: join the gloo group through a FileStore in ``workdir``, run
    the scenarios (``SCENARIOS`` by default) on a ``chain_mesh`` over it and
    write ``rank<r>.pkl`` (each scenario's result, or its traceback)."""
    import torch.distributed as dist

    from nfmc_torch.parallel import chain_mesh

    scenarios = SCENARIOS if scenarios is None else scenarios
    torch.set_num_threads(1)
    results = {}
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
                            rank=rank, world_size=world, timeout=timedelta(seconds=60))
    try:
        mesh = chain_mesh(device_type="cpu")
        for name in names:
            try:
                results[name] = scenarios[name](mesh, workdir)
            except Exception:
                results[name] = {"error": traceback.format_exc()}
            dist.barrier()
    finally:
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
        dist.destroy_process_group()
