"""Front door: ``create_sampler`` and ``sample``, with the signatures of
``nfmc_tpu/api/sample.py``. ``device`` defaults to CUDA; without a card the
call raises unless ``device="cpu"`` is passed."""
from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..core.chains import is_sharded
from ..core.output import MCMCOutput
from ..core.rng import next_seed
from ..core.sampler import NFMCKernel, Sampler
from ..flows import Flow
from ..potentials import Potential
from ..samplers.mcmc import (
    AIES,
    ESS,
    HMC,
    MALA,
    MH,
    NUTS,
    PTHMC,
    PTMALA,
    PTRWMH,
    UHMC,
    ULA,
    AIESKernel,
    AIESParameters,
    CheesHMC,
    CheesHMCKernel,
    CheesHMCParameters,
    DenseHMC,
    DenseHMCKernel,
    DenseHMCParameters,
    DenseLangevinKernel,
    DenseLangevinParameters,
    DenseMALA,
    ESSKernel,
    ESSParameters,
    HMCKernel,
    HMCParameters,
    LangevinKernel,
    LangevinParameters,
    MHKernel,
    MHParameters,
    NUTSKernel,
    NUTSParameters,
    PTKernel,
    PTParameters,
)
from ..samplers.nfmc import (
    DLMC,
    TESS,
    AdaptiveIMH,
    DLMCKernel,
    DLMCParameters,
    FixedIMH,
    IMHKernel,
    IMHParameters,
    JumpAIES,
    JumpChEES,
    JumpESS,
    JumpHMC,
    JumpMALA,
    JumpMH,
    JumpNFMCParameters,
    JumpNUTS,
    JumpUHMC,
    JumpULA,
    NeuTraChEES,
    NeuTraHMC,
    NeuTraKernel,
    NeuTraMH,
    NeuTraParameters,
    TESSKernel,
    TESSParameters,
)
from ..utils import resolve_device
from .registry import PORTED_STRATEGIES, create_flow_object


def create_sampler(
    target,
    event_shape: Optional[Tuple[int, ...]] = None,
    flow: Optional[Union[str, Flow]] = "realnvp",
    strategy: str = "imh",
    negative_log_likelihood=None,
    kernel_kwargs: Optional[dict] = None,
    param_kwargs: Optional[dict] = None,
    inner_kernel_kwargs: Optional[dict] = None,
    inner_param_kwargs: Optional[dict] = None,
    device=None,
    flow_kwargs: Optional[dict] = None,
) -> Sampler:
    """Build a Sampler for ``strategy`` on ``device``."""
    if strategy not in PORTED_STRATEGIES:
        raise ValueError(f"Unsupported sampling strategy: {strategy}")
    device = resolve_device(device)
    flow_kwargs = flow_kwargs or {}
    kernel_kwargs = kernel_kwargs or {}
    param_kwargs = param_kwargs or {"n_iterations": 100}
    inner_kernel_kwargs = inner_kernel_kwargs or {}
    inner_param_kwargs = dict(inner_param_kwargs or {})

    if flow is not None and not isinstance(flow, str):
        event_shape = flow.event_shape
    elif isinstance(target, Potential):
        event_shape = target.event_shape
    if event_shape is None:
        raise ValueError("event_shape could not be resolved")
    event_shape = tuple(int(s) for s in event_shape)
    event_size = int(np.prod(event_shape))

    if strategy in ("mala", "ula"):
        cls = MALA if strategy == "mala" else ULA
        return cls(event_shape, target, LangevinKernel(event_size=event_size, **kernel_kwargs),
                   LangevinParameters(**param_kwargs), device=device)
    if strategy in ("hmc", "uhmc"):
        cls = HMC if strategy == "hmc" else UHMC
        return cls(event_shape, target, HMCKernel(event_size=event_size, **kernel_kwargs),
                   HMCParameters(**param_kwargs), device=device)
    if strategy == "mh":
        return MH(event_shape, target, MHKernel(event_size=event_size, **kernel_kwargs),
                  MHParameters(**param_kwargs), device=device)
    if strategy == "nuts":
        return NUTS(event_shape, target, NUTSKernel(event_size=event_size, **kernel_kwargs),
                    NUTSParameters(**param_kwargs), device=device)
    if strategy == "chees_hmc":
        return CheesHMC(event_shape, target, CheesHMCKernel(event_size=event_size, **kernel_kwargs),
                        CheesHMCParameters(**param_kwargs), device=device)
    if strategy == "dense_hmc":
        return DenseHMC(event_shape, target, DenseHMCKernel(event_size=event_size, **kernel_kwargs),
                        DenseHMCParameters(**param_kwargs), device=device)
    if strategy == "dense_mala":
        return DenseMALA(event_shape, target,
                         DenseLangevinKernel(event_size=event_size, **kernel_kwargs),
                         DenseLangevinParameters(**param_kwargs), device=device)
    if strategy == "aies":
        return AIES(event_shape, target, AIESKernel(event_size=event_size, **kernel_kwargs),
                    AIESParameters(**param_kwargs), device=device)
    if strategy in ("pt_mala", "pt_mh", "pt_hmc"):
        cls = {"pt_mala": PTMALA, "pt_mh": PTRWMH, "pt_hmc": PTHMC}[strategy]
        return cls(event_shape, target, PTKernel(event_size=event_size, **kernel_kwargs),
                   PTParameters(**param_kwargs), device=device)
    if strategy == "ess":
        if negative_log_likelihood is None:
            raise ValueError("Negative log likelihood must be provided")
        return ESS(event_shape, target, negative_log_likelihood,
                   ESSKernel(event_shape=event_shape, **kernel_kwargs),
                   ESSParameters(**param_kwargs), device=device)

    if flow is None:
        raise ValueError("Flow object must be provided")
    if isinstance(flow, str):
        flow_object = create_flow_object(flow_string=flow, event_shape=event_shape, **flow_kwargs)
    elif isinstance(flow, Flow):
        flow_object = flow
    else:
        raise ValueError(f"Unknown type for normalizing flow: {type(flow)}")

    if strategy in ("imh", "fixed_imh"):
        return FixedIMH(event_shape, target,
                        IMHKernel(event_shape, flow=flow_object, **kernel_kwargs),
                        IMHParameters(**param_kwargs), device=device)
    if strategy == "adaptive_imh":
        # reference quirk parity: AdaptiveIMH ignores param_kwargs
        # (``nfmc_tpu/api/sample.py:213-216``), so it always runs 100 iterations
        return AdaptiveIMH(event_shape, target,
                           IMHKernel(event_shape, flow=flow_object, **kernel_kwargs),
                           IMHParameters(), device=device)

    if strategy.startswith("jump_"):
        kernel = NFMCKernel(event_shape, flow=flow_object, **kernel_kwargs)
        params = JumpNFMCParameters(**param_kwargs)
        inner = strategy[len("jump_"):]
        if inner in ("mala", "ula"):
            cls = JumpMALA if inner == "mala" else JumpULA
            inner_kernel = LangevinKernel(event_size=event_size, **inner_kernel_kwargs)
            inner_params = LangevinParameters(**inner_param_kwargs)
        elif inner in ("hmc", "uhmc"):
            cls = JumpHMC if inner == "hmc" else JumpUHMC
            if inner == "hmc" and "n_iterations" not in inner_param_kwargs:
                inner_param_kwargs["n_iterations"] = 5  # the reference's default for jump_hmc
            inner_kernel = HMCKernel(event_size=event_size, **inner_kernel_kwargs)
            inner_params = HMCParameters(**inner_param_kwargs)
        elif inner == "mh":
            cls = JumpMH
            inner_kernel = MHKernel(event_size=event_size, **inner_kernel_kwargs)
            inner_params = MHParameters(**inner_param_kwargs)
        elif inner == "aies":
            cls = JumpAIES
            inner_kernel = AIESKernel(event_size=event_size, **inner_kernel_kwargs)
            inner_params = AIESParameters(**inner_param_kwargs)
        elif inner == "ess":
            if negative_log_likelihood is None:
                raise ValueError("Negative log likelihood must be provided")
            return JumpESS(event_shape, target, negative_log_likelihood, kernel=kernel,
                           params=params,
                           inner_kernel=ESSKernel(event_shape=event_shape, **inner_kernel_kwargs),
                           inner_params=ESSParameters(**inner_param_kwargs), device=device)
        else:
            # nuts, chees: 5 inner iterations by default, as jump_hmc
            if "n_iterations" not in inner_param_kwargs:
                inner_param_kwargs["n_iterations"] = 5
            if inner == "nuts":
                cls = JumpNUTS
                inner_kernel = NUTSKernel(event_size=event_size, **inner_kernel_kwargs)
                inner_params = NUTSParameters(**inner_param_kwargs)
            else:
                cls = JumpChEES
                inner_kernel = CheesHMCKernel(event_size=event_size, **inner_kernel_kwargs)
                inner_params = CheesHMCParameters(**inner_param_kwargs)
        return cls(event_shape, target, kernel=kernel, params=params, inner_kernel=inner_kernel,
                   inner_params=inner_params, device=device)

    if strategy in ("tess", "dlmc"):
        if negative_log_likelihood is None:
            raise ValueError("Negative log likelihood must be provided")
        if strategy == "tess":
            return TESS(event_shape, target, negative_log_likelihood,
                        TESSKernel(event_shape, flow=flow_object, **kernel_kwargs),
                        TESSParameters(**param_kwargs), device=device)
        return DLMC(event_shape, target, negative_log_likelihood,
                    DLMCKernel(event_shape, flow=flow_object, **kernel_kwargs),
                    DLMCParameters(**param_kwargs), device=device)

    # neutra_hmc, neutra_mh, neutra_chees
    kernel = NeuTraKernel(event_shape, flow=flow_object, **kernel_kwargs)
    params = NeuTraParameters(**param_kwargs)
    if strategy == "neutra_chees":
        return NeuTraChEES(event_shape, target,
                           inner_kernel=CheesHMCKernel(event_size=event_size, **inner_kernel_kwargs),
                           inner_params=CheesHMCParameters(**inner_param_kwargs), kernel=kernel,
                           params=params, device=device)
    if strategy == "neutra_hmc":
        return NeuTraHMC(event_shape, target,
                         inner_kernel=HMCKernel(event_size=event_size, **inner_kernel_kwargs),
                         inner_params=HMCParameters(**inner_param_kwargs), kernel=kernel,
                         params=params, device=device)
    return NeuTraMH(event_shape, target,
                    inner_kernel=MHKernel(event_size=event_size, **inner_kernel_kwargs),
                    inner_params=MHParameters(**inner_param_kwargs), kernel=kernel,
                    params=params, device=device)


def sample(
    target,
    event_shape: Optional[Tuple[int, ...]] = None,
    flow: Optional[Union[str, Flow]] = "realnvp",
    strategy: str = "imh",
    n_iterations: int = 100,
    n_warmup_iterations: int = 100,
    n_chains: int = 100,
    x0=None,
    warmup: bool = False,
    show_progress: bool = True,
    sampling_time_limit_seconds: Optional[float] = None,
    warmup_time_limit_seconds: Optional[float] = None,
    seed: Optional[int] = None,
    mesh=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_segment_iterations: Optional[int] = None,
    checkpoint_save_samples: Optional[bool] = None,
    device=None,
    **kwargs,
) -> MCMCOutput:
    """One-call sampling entry. The default ``x0`` is drawn from N(0, I) on
    the device; ``seed`` fixes the flow's initial weights (for a flow given
    by name), ``x0``, the warmup and the run. With ``warmup=True`` the
    sampler warms up first and ``x0`` becomes a reshuffle of the warmup's
    stored draws (its last state when it stores none).

    ``mesh`` (a ``torch.distributed`` ``DeviceMesh``,
    :func:`nfmc_torch.parallel.chain_mesh`) shards the chains over its first
    axis end to end: every rank of the job makes this call, runs its block
    of chains through the warmup and the sampling, and gets the output with
    all the chains (:mod:`nfmc_torch.parallel`). ``n_chains`` must divide by
    that axis's size. Every strategy runs on any number of ranks; a sampler
    subclass runs on more than one only if it declares
    ``multi_rank_chains`` itself.

    ``checkpoint_path`` runs the sampling phase as checkpointed segments
    (:func:`nfmc_torch.checkpoint.sample_resumable`,
    ``checkpoint_segment_iterations`` each, about 10 by default). If the
    process dies, calling ``sample()`` again with the same arguments skips
    the warmup (the checkpoint holds the tuned kernel and flow) and goes on
    from the last completed segment, bit for bit as the uninterrupted run
    would: the segments' base seed comes from the checkpoint. On success
    the checkpoint is deleted, so a file on disk always means "resume".
    ``checkpoint_save_samples`` keeps every segment's draws in a sidecar
    file; None means ``store_samples`` on a fresh run and, on a resume, the
    checkpoint's own setting. Incompatible with
    ``sampling_time_limit_seconds``."""
    if mesh is not None:
        from torch.distributed.device_mesh import DeviceMesh

        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                            f"(nfmc_torch.parallel.chain_mesh), got {type(mesh).__name__}")
    ckpt_file, resume = None, False
    if checkpoint_path is not None:
        if sampling_time_limit_seconds is not None:
            raise ValueError("checkpoint_path is incompatible with sampling_time_limit_seconds")
        ckpt_file = str(checkpoint_path)
        if not ckpt_file.endswith(".npz"):
            ckpt_file += ".npz"
        # a checkpoint on disk means a previous call died mid-sampling
        resume = os.path.exists(ckpt_file)
    if flow == "None":
        flow = None
    if flow is not None and not isinstance(flow, str):
        event_shape = flow.event_shape
    elif isinstance(target, Potential):
        event_shape = target.event_shape
    device = resolve_device(device)

    kwargs["param_kwargs"] = {
        **(kwargs.get("param_kwargs") or {}),
        "n_iterations": n_iterations,
        "n_warmup_iterations": n_warmup_iterations,
    }
    # the first three words do not depend on how many are drawn, so runs
    # without warmup keep their seeds
    seeds = np.random.SeedSequence(seed if seed is not None else next_seed()).generate_state(5)
    seed_flow, seed_x0, seed_run, seed_warm, seed_shuffle = (int(s) for s in seeds)
    if isinstance(flow, str):
        kwargs["flow_kwargs"] = {"seed": seed_flow, **(kwargs.get("flow_kwargs") or {})}

    sampler = create_sampler(target=target, event_shape=event_shape, flow=flow,
                             strategy=strategy, device=device, **kwargs)
    if x0 is None:
        g = torch.Generator(device=device)
        g.manual_seed(seed_x0)
        x0 = torch.randn((n_chains, *sampler.event_shape), generator=g, device=device)
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=device)
    shard = None
    if mesh is not None:
        from ..parallel import shard_chains

        # chains shard over the mesh's first axis only
        axis = (mesh.mesh_dim_names or ("chains",))[0]
        if x0.shape[0] % mesh.size(0) != 0:
            raise ValueError(f"n_chains={x0.shape[0]} must be divisible by mesh axis "
                             f"{axis!r} size {mesh.size(0)}")

        def shard(v):
            return shard_chains(torch.as_tensor(v, dtype=torch.float32, device=device), mesh,
                                axis_name=axis)

        x0 = shard(x0)
    if warmup and not resume:
        warmup_output = sampler.warmup(x0=x0, show_progress=show_progress,
                                       time_limit_seconds=warmup_time_limit_seconds,
                                       seed=seed_warm)
        x0_is_warmup_draw = True
        if warmup_output.store_samples and warmup_output.running_samples.n_samples > 0:
            flat = warmup_output.samples.reshape(-1, *sampler.event_shape)
            g = torch.Generator(device=flat.device)
            g.manual_seed(seed_shuffle)
            perm = torch.randperm(len(flat), generator=g, device=flat.device)
            x0 = flat[perm[: x0.shape[0]]].to(device)
        elif warmup_output.running_samples.last_sample is not None:
            x0 = warmup_output.running_samples.last_sample.to(device)
        else:  # the warmup produced nothing: keep the original data-space x0
            x0_is_warmup_draw = False
        if (x0_is_warmup_draw and getattr(sampler, "warmup_draws_are_latent", False)
                and sampler.params.transport_x0):
            # NeuTra's warmup draws are latent, and with transport_x0 its
            # sample() maps x0 forward as a data-space point: hand it the
            # data-space points so that the transport gives the draws back
            x0 = sampler._latent_to_data(x0)
        if shard is not None and not is_sharded(x0):
            x0 = shard(x0)  # the reshuffle rebuilt x0 from all the chains: re-shard it
    if ckpt_file is not None:
        from ..checkpoint import checkpoint_writer, discard_resumable_checkpoint, sample_resumable

        if checkpoint_save_samples is None and not resume:
            checkpoint_save_samples = bool(sampler.params.store_samples)
        out = sample_resumable(sampler, x0, ckpt_file,
                               segment_iterations=checkpoint_segment_iterations, seed=seed_run,
                               show_progress=show_progress, save_samples=checkpoint_save_samples,
                               shard_fn=shard)
        if checkpoint_writer(x0):
            discard_resumable_checkpoint(ckpt_file)  # done: a leftover file means "resume"
        if shard is not None:
            # no rank starts another call before the checkpoint is gone
            import torch.distributed as dist

            dist.barrier()
        return out
    return sampler.sample(x0=x0, show_progress=show_progress,
                          time_limit_seconds=sampling_time_limit_seconds, seed=seed_run)
