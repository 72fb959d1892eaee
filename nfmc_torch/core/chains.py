"""Chains sharded over the ranks of a process group: this rank's block of
the chain axis and the collectives at the few points where chains meet.

The JAX package shards the chain axis of one program over a device mesh and
lets GSPMD insert the reductions. PyTorch runs one process a device (as
under ``torchrun``), so here every rank runs the sampler on its own rows as
plain local tensors, and the code reduces explicitly where chains meet: the
driver's statistics at each flush, dual averaging's mean acceptance, the
inverse-mass EMA's chain variance, the jump accumulators and the flow fits
on pooled draws. Each rank draws the global randomness of a chunk from the
shared seed and keeps its own rows, so a sharded run sees the numbers of the
unsharded one.

A sampler's public entries (``warmup``, ``sample``, ``sample_continue``) run
sharded when ``x0`` is a ``DTensor`` placed ``Shard(0)`` over the mesh's
first axis (:func:`nfmc_torch.parallel.shard_chains`): the rank's rows go to
the sampler with a :class:`ChainShard`, and the output comes back with the
global chain axis on every rank, gathered in rank order. On a mesh whose
first axis has more than one rank only the samplers that declare
``multi_rank_chains`` run; on one rank every sampler runs, bit for bit as
without a mesh.
"""
from __future__ import annotations

import contextlib
import functools
import sys
from typing import Optional

import torch

# the entries that take the chains as their first argument
SHARDED_ENTRIES = ("warmup", "sample", "sample_continue")


def is_sharded(x) -> bool:
    """Whether ``x`` is a DTensor (nothing is one before
    ``torch.distributed.tensor`` was imported, so this imports nothing)."""
    cls = getattr(sys.modules.get("torch.distributed.tensor"), "DTensor", None)
    return cls is not None and isinstance(x, cls)


def mesh_device(mesh) -> torch.device:
    """The device a mesh's collectives run on: this process's CUDA device
    for a ``"cuda"`` mesh (NCCL), the CPU otherwise (gloo)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class ChainShard:
    """This rank's block of the chain axis: the process group of the mesh's
    first axis, the rank's index on it and its size. Collectives run on the
    mesh's device; tensors on another device go there and come back."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.group = mesh.get_group(0)
        self.size = mesh.size(0)
        self.rank = mesh.get_local_rank(0)
        self.device = mesh_device(mesh)

    def n_global(self, n_local: int) -> int:
        return n_local * self.size

    def rows(self, t: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """This rank's block of ``t``'s (global) axis ``axis``: rows
        ``[r n / R, (r + 1) n / R)``, rounded down (equal blocks when R
        divides n)."""
        n = t.shape[axis]
        lo, hi = self.rank * n // self.size, (self.rank + 1) * n // self.size
        return t.narrow(axis, lo, hi - lo)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise sum over the ranks (a new tensor, on ``t``'s device)."""
        import torch.distributed as dist

        buf = t.detach().to(self.device, copy=True).contiguous()
        dist.all_reduce(buf, group=self.group)
        return buf.to(t.device)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise maximum over the ranks."""
        import torch.distributed as dist

        buf = t.detach().to(self.device, copy=True).contiguous()
        dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=self.group)
        return buf.to(t.device)

    def gather(self, t: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """The ranks' blocks of ``t`` concatenated along ``axis`` in rank
        order."""
        import torch.distributed as dist

        buf = t.detach().movedim(axis, 0).contiguous().to(self.device)
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf, group=self.group)
        return torch.cat(parts, 0).movedim(0, axis).to(t.device)

    def any(self, flag: bool) -> bool:
        """True on every rank iff ``flag`` is True on some rank (a time limit
        that one rank's clock reached stops them all)."""
        t = self.sum(torch.tensor([1.0 if flag else 0.0], device=self.device))
        return bool(t.item() > 0)

    def agree_seed(self, seed: int) -> int:
        """Rank 0's ``seed`` on every rank."""
        import torch.distributed as dist

        t = torch.tensor([int(seed)], dtype=torch.int64, device=self.device)
        dist.broadcast(t, src=dist.get_global_rank(self.group, 0), group=self.group)
        return int(t.item())


def all_rows(v: torch.Tensor, shard: Optional[ChainShard] = None, axis: int = 0) -> torch.Tensor:
    """Every rank's rows of ``v`` along ``axis`` (a refit's batch): ``v``
    itself on one rank, where a captured chunk gathers nothing."""
    return v if shard is None or shard.size == 1 else shard.gather(v, axis)


def chain_mean(v: torch.Tensor, shard: Optional[ChainShard] = None, dim: int = 0) -> torch.Tensor:
    """Mean over the (global) chain axis ``dim``. On one rank it is
    ``v.mean(dim)``; across ranks, the sum of the ranks' sums over the chain
    count."""
    if shard is None or shard.size == 1:
        return v.mean(dim)
    return shard.sum(v.sum(dim)) / shard.n_global(v.shape[dim])


def chain_var(v: torch.Tensor, shard: Optional[ChainShard] = None) -> torch.Tensor:
    """Population variance over the (global) chain axis 0 (``jnp.var``);
    across ranks in two passes, each a sum over the ranks."""
    if shard is None or shard.size == 1:
        return torch.var(v, dim=0, correction=0)
    m = chain_mean(v, shard)
    return chain_mean((v - m) ** 2, shard)


def chain_logsumexp(v: torch.Tensor, shard: Optional[ChainShard] = None) -> torch.Tensor:
    """``logsumexp`` over the (global) axis 0 of ``v``. On one rank it is
    ``torch.logsumexp(v, 0)``; across ranks in two passes: the maximum over
    the ranks, then the sum over them of the exponentials below it."""
    if shard is None or shard.size == 1:
        return torch.logsumexp(v, 0)
    m = shard.max(v.max(0).values)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))  # all -inf: log 0 below
    return torch.log(shard.sum(torch.exp(v - m).sum(0))) + m


def chain_softmax(log_w: torch.Tensor, shard: Optional[ChainShard] = None) -> torch.Tensor:
    """The normalised weights ``softmax(log_w)`` over the (global) axis 0,
    this rank's rows of them (``torch.softmax`` on one rank)."""
    if shard is None or shard.size == 1:
        return torch.softmax(log_w, 0)
    return torch.exp(log_w - chain_logsumexp(log_w, shard))


def mesh_seed(mesh, seed: int) -> int:
    """The ``seed`` of the mesh's first rank on each of its ranks: a
    broadcast along each axis in turn."""
    import torch.distributed as dist

    t = torch.tensor([int(seed)], dtype=torch.int64, device=mesh_device(mesh))
    for dim in range(mesh.ndim):
        group = mesh.get_group(dim)
        dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
    return int(t.item())


def local_params(tree):
    """``(local tree, mesh)``: a parameter tree whose tensors are DTensors
    replicated over a mesh (:func:`nfmc_torch.parallel.replicate`) as this
    rank's copy of each, with that mesh; a tree without a DTensor as it is,
    with None. The runs that take such a tree (FAB, nested sampling) work
    on the copy, as GSPMD runs the JAX package's jitted steps replicated. A
    tensor placed ``Shard`` raises ``ValueError``."""
    from ..utils import tree_leaves, tree_map

    placed = [t for t in tree_leaves(tree) if is_sharded(t)]
    if not placed:
        return tree, None
    mesh = placed[0].device_mesh
    for t in placed:
        if t.device_mesh != mesh or any(p.is_shard() for p in t.placements):
            raise ValueError("parameters must be replicated over one mesh, got placements "
                             f"{t.placements} on {t.device_mesh}")
    return tree_map(lambda t: t.to_local() if is_sharded(t) else t, tree), mesh


@contextlib.contextmanager
def on_local_copy(flow):
    """For the ``with`` block, ``flow``'s parameters are this rank's copy
    (:func:`local_params`), and the block gets their mesh (None for plain
    parameters); afterwards they are replicated again over it, as trained
    in the block."""
    params, mesh = local_params(flow.params)
    flow.params = params
    try:
        yield mesh
    finally:
        if mesh is not None:
            from ..parallel import replicate

            flow.params = replicate(flow.params, mesh)


def support_multi_rank(sampler) -> bool:
    """True iff the sampler's own class and those of its nested samplers
    each declare ``multi_rank_chains`` (a subclass must declare it again)."""
    return all(type(s).__dict__.get("multi_rank_chains", False) for s in sampler_tree(sampler))


def sampler_tree(sampler) -> list:
    """The sampler and the samplers it holds (a jump sampler's inner one)."""
    from .sampler import Sampler

    out = [sampler]
    for v in vars(sampler).values():
        if isinstance(v, Sampler) and v is not sampler:
            out.extend(sampler_tree(v))
    return out


@contextlib.contextmanager
def bind_chains(sampler, shard: ChainShard):
    """Give the sampler and its nested samplers the shard for one call."""
    tree = sampler_tree(sampler)
    saved = [s.chain_shard for s in tree]
    for s in tree:
        s.chain_shard = shard
    try:
        yield
    finally:
        for s, prev in zip(tree, saved):
            s.chain_shard = prev


def gather_output(out, shard: ChainShard):
    """The output of a rank's run with the global chain axis: the stored
    draws and the last state gathered in rank order. The statistics were
    reduced at each flush and the kernel's adapted state is the same on
    every rank."""
    rs = out.running_samples
    if rs.n_samples > 0:
        rs._running = [shard.gather(rs.as_tensor(), axis=1)]
    if rs.last_sample is not None:
        rs.last_sample = shard.gather(rs.last_sample, axis=0)
    return out


def run_sharded(sampler, fn, x0, args, kwargs):
    """Run entry ``fn`` of ``sampler`` on this rank's rows of the DTensor
    ``x0`` and return the output with the global chain axis."""
    from torch.distributed.tensor import Shard

    mesh = x0.device_mesh
    if not x0.placements or x0.placements[0] != Shard(0) or any(
            p.is_shard() for p in x0.placements[1:]):
        raise ValueError(f"chains must be sharded over their axis 0 on the mesh's first axis "
                         f"and replicated over the others, got placements {x0.placements}")
    shard = ChainShard(mesh)
    n_chains = x0.shape[0]
    axis_name = (mesh.mesh_dim_names or ("0",))[0]
    if n_chains % shard.size != 0:
        raise ValueError(f"n_chains={n_chains} must be divisible by the '{axis_name}' "
                         f"mesh axis size {shard.size}")
    if shard.size > 1 and not support_multi_rank(sampler):
        names = ", ".join(type(s).__name__ for s in sampler_tree(sampler))
        raise NotImplementedError(
            f"{names}: chains sharded over more than one rank are not supported yet "
            "(ROADMAP 1.8d); a mesh whose first axis has one rank runs every sampler")
    if kwargs.get("seed") is None and kwargs.get("generator") is None and len(args) < 3:
        from .rng import next_seed

        kwargs = {**kwargs, "seed": shard.agree_seed(next_seed())}
    local = x0.to_local()
    with bind_chains(sampler, shard):
        out = fn(sampler, local, *args, **kwargs)
    return gather_output(out, shard)


def sharded_entry(fn):
    """Wrap a sampler entry so that a DTensor ``x0`` runs it sharded."""

    @functools.wraps(fn)
    def entry(self, x0, *args, **kwargs):
        if is_sharded(x0):
            return run_sharded(self, fn, x0, args, kwargs)
        return fn(self, x0, *args, **kwargs)

    entry.sharded_entry = True
    return entry
