"""Shared transport machinery (counterpart of ``nfmc_tpu/transport/common.py``):
tempered potentials, the MALA correction sweep, systematic and multinomial
resampling, ESS.

The inverse temperature is a 0-d float32 tensor (:func:`tempered`), as the
JAX package traces it, so that one captured step serves every level of a
loop (:mod:`nfmc_torch.core.graphs`): AIS reads it at the graph's counter,
AFT and PMC hold it among a graph's constants, and CRAFT's passes, whose
levels one graph unrolls, fill it in as a kernel argument. FAB's unrolled
AIS round and the steps left eager give it as a host float.
Every stochastic step takes its random numbers as tensors, made by a
separate draws function from a ``torch.Generator``, so that two devices
(or the JAX package's keys, rebuilt) can be given the same numbers, and a
graph reads them from its static buffers.

A group of particles that ``prior_sample`` returns as a ``DTensor`` placed
``Shard(0)`` over its mesh's first axis is sharded, as the chains of a
sampler are (:mod:`nfmc_torch.core.chains`): each rank holds its rows, draws
the group's global randomness and keeps its rows of it, and reduces over
the ranks where the particles meet (log-sums, softmaxes, resampling, the
fits' losses). A plain tensor is the whole group on every rank. A run given
neither a generator nor a seed draws from the first rank's next seed on
every rank (:func:`first_draw`, :func:`run_generator`), so that ranks whose
process-wide streams differ still draw alike.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from ..core.chains import ChainShard, chain_logsumexp, is_sharded, mesh_seed
from ..core.rng import next_seed, resolve_generator
from ..utils import value_and_batched_grad


def tempered(prior_potential: Callable, target_potential: Callable):
    """u(x, lam) = (1-lam) * prior + lam * target, ``lam`` a 0-d float32
    tensor or a host float.

    In the JAX package's own form (``nfmc_tpu/transport/common.py:25-30``):
    both sides are evaluated and the zero-weight one is masked out, with
    ``where`` on a tensor ``lam`` (so that one captured step serves every
    level, reading ``lam`` on the device), on the host for a float. For
    hard-support potentials a ``U = +inf`` on the switched-off side then
    gives no ``0 * inf = NaN``: ``u(x, 0) = prior`` and ``u(x, 1) = target``
    exactly, and the masked side's gradient is a zero cotangent, as in JAX.
    A tensor ``lam`` computes its weights in float32, as the JAX package
    traces them; a host float in double, rounded once.
    """

    def u(x, lam):
        up = prior_potential(x)
        ut = target_potential(x)
        if isinstance(lam, torch.Tensor):
            a = torch.where(lam < 1.0, (1.0 - lam) * up, 0.0)
            b = torch.where(lam > 0.0, lam * ut, 0.0)
        else:
            a = (1.0 - lam) * up if lam < 1.0 else torch.zeros_like(up)
            b = lam * ut if lam > 0.0 else torch.zeros_like(ut)
        return a + b

    return u


def as_level(lam, like: torch.Tensor) -> torch.Tensor:
    """An inverse temperature as a 0-d float32 tensor on ``like``'s device:
    a tensor as it is, a host float through a fill (a kernel argument, no
    copy from the host, so legal inside a captured graph)."""
    if isinstance(lam, torch.Tensor):
        return lam
    return torch.full((), float(lam), dtype=torch.float32, device=like.device)


def log_ess(log_w: torch.Tensor, shard: Optional[ChainShard] = None) -> torch.Tensor:
    """log ESS of normalized or unnormalized log-weights (of a sharded
    group's global particles with its ``shard``)."""
    log_w = log_w - chain_logsumexp(log_w, shard)
    return -chain_logsumexp(2.0 * log_w, shard)


def take_particles(x):
    """A group's particles from ``prior_sample``: ``(this rank's rows as
    float32, its ChainShard)``, the shard None for a plain tensor (the
    whole group, on every rank)."""
    if not is_sharded(x):
        return x.to(torch.float32), None
    from torch.distributed.tensor import Shard

    if not x.placements or x.placements[0] != Shard(0) or any(
            p.is_shard() for p in x.placements[1:]):
        raise ValueError(f"particles must be sharded over their axis 0 on the mesh's first axis "
                         f"and replicated over the others, got placements {x.placements}")
    shard = ChainShard(x.device_mesh)
    if x.shape[0] % shard.size:
        raise ValueError(f"{x.shape[0]} particles must be divisible by the mesh's first axis "
                         f"size {shard.size}")
    return x.to_local().to(torch.float32), shard


def run_shard(shards) -> Optional[ChainShard]:
    """The run's shard: that of its sharded groups (None if none is), which
    must lie on one mesh."""
    found = [s for s in shards if s is not None]
    if any(s.mesh != found[0].mesh for s in found[1:]):
        raise ValueError("the sharded particle groups lie on different meshes")
    return found[0] if found else None


def gathered(x: torch.Tensor, shard: Optional[ChainShard], axis: int = 0) -> torch.Tensor:
    """The whole group: ``x`` (its particle axis ``axis``) gathered over the
    ranks of its shard."""
    return x if shard is None else shard.gather(x, axis)


def rank_share(v: torch.Tensor, shard: Optional[ChainShard],
               run: Optional[ChainShard]) -> torch.Tensor:
    """This rank's share of a sum over a group that the run sums over its
    ranks: a sharded group's own (its rows'), a whole group's all on the
    run's first rank, none on the others."""
    if run is None or shard is not None or run.rank == 0:
        return v
    return torch.zeros_like(v)


def draw_rows(draws, shard: Optional[ChainShard], axis: int = 1):
    """This rank's rows of draws made for a group's global particles (their
    particle axis ``axis``): of a tensor, or of each in a sequence."""
    if shard is None or draws is None:
        return draws
    if isinstance(draws, torch.Tensor):
        return shard.rows(draws, axis)
    return tuple(shard.rows(d, axis) for d in draws)


def run_generator(device, generator: Optional[torch.Generator] = None,
                  seed: Optional[int] = None, mesh=None) -> torch.Generator:
    """A run's generator (:func:`nfmc_torch.core.rng.resolve_generator`). On
    a ``mesh`` with neither a generator nor a seed given, the seed is the
    next one of the first rank's stream on every rank, so that the ranks
    draw the same global randomness whatever their own streams hold."""
    if mesh is not None and generator is None and seed is None:
        seed = mesh_seed(mesh, next_seed())
    return resolve_generator(device, generator, seed)


def first_draw(draw: Callable, device, generator: Optional[torch.Generator] = None,
               seed: Optional[int] = None, mesh=None):
    """``(the run's generator, draw(generator))`` for a run whose mesh, if
    it has one, may show first in what ``draw`` returns (a group of
    particles, or a list of groups, from ``prior_sample``): where a group
    comes back sharded and neither a generator nor a seed was given, the
    ranks agree on the first rank's seed (:func:`run_generator`) and each
    draws again from it. A run takes one seed of the stream either way."""
    if mesh is None and generator is None and seed is None:
        seed = next_seed()
        g = resolve_generator(device, None, seed)
        x = draw(g)
        placed = [t for t in (x if isinstance(x, (list, tuple)) else [x]) if is_sharded(t)]
        if not placed:
            return g, x
        seed = mesh_seed(placed[0].device_mesh, seed)
    g = run_generator(device, generator, seed, mesh)
    return g, draw(g)


def resample(x: torch.Tensor, log_w: torch.Tensor, offset: torch.Tensor,
             shard: Optional[ChainShard] = None) -> torch.Tensor:
    """Systematic resampling of a group with ``offset``: this rank's rows
    of the resampled particles. The index is global: sharded, the rank
    gathers the group and its weights and keeps its rows."""
    if shard is None:
        return x[systematic_resample(log_w, x.shape[0], offset)]
    x_all = shard.gather(x, 0)
    return shard.rows(x_all[systematic_resample(shard.gather(log_w, 0), x_all.shape[0], offset)])


def systematic_resample(log_w: torch.Tensor, n: int, offset: torch.Tensor) -> torch.Tensor:
    """Systematic (low-variance) resampling indices from log-weights: the
    uniform ``offset`` in [0, 1) and n evenly-spaced points through the
    weight CDF (left-side search, clipped)."""
    w = torch.exp(log_w - torch.logsumexp(log_w, 0))
    cdf = torch.cumsum(w, 0)
    u = (offset + torch.arange(n, dtype=w.dtype, device=w.device)) / n
    return torch.searchsorted(cdf, u, side="left").clamp(0, log_w.shape[0] - 1)


def resample_offset(generator: torch.Generator) -> torch.Tensor:
    """The draw of :func:`systematic_resample`: one uniform."""
    return torch.rand((), generator=generator, device=generator.device)


def gumbel(generator: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    """Standard Gumbel noise, ``-log(-log(U))`` with U uniform on [tiny, 1),
    as ``jax.random.gumbel`` draws it."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(tuple(shape), generator=generator, device=generator.device).clamp_min(tiny)
    return -torch.log(-torch.log(u))


def categorical(logits: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Gumbel-max draws from ``softmax(logits)``: ``argmax(logits + noise)``
    over the last axis, with ``noise`` of shape ``(*shape, len(logits))``
    (``jax.random.categorical`` given the same noise). No host check: a row
    of all ``-inf`` logits gives index 0, as in JAX."""
    return torch.argmax(logits + noise, dim=-1)


def multinomial_resample(log_w: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """n multinomial resampling indices from log-weights, given the
    ``(n, len(log_w))`` Gumbel draw ``noise`` (:func:`gumbel`)."""
    return categorical(log_w, noise)


class MALASweep:
    """The MALA correction sweep at inverse temperature ``lam`` (a 0-d
    tensor or a host float, :func:`tempered`):
    ``sweep(x, lam, draws) -> x'`` with ``draws = sweep.draws(generator,
    x.shape)``, the noise ``(n_steps, *x.shape)`` and the accept uniforms
    ``(n_steps, B)``. A step's U and grad U at the current state carry over
    from the last (the values JAX recomputes), so a sweep evaluates the
    potential and its gradient ``n_steps + 1`` times."""

    def __init__(self, u_tempered: Callable, n_steps: int = 5, step_size: float = 0.05):
        self.u = u_tempered
        self.n_steps = int(n_steps)
        self.step_size = float(step_size)

    def draws(self, generator: torch.Generator, shape: Sequence[int]):
        dev = generator.device
        return (torch.randn((self.n_steps, *shape), generator=generator, device=dev),
                torch.rand((self.n_steps, shape[0]), generator=generator, device=dev))

    def __call__(self, x: torch.Tensor, lam, draws) -> torch.Tensor:
        noise, uniforms = draws
        s = self.step_size
        u_and_grad = value_and_batched_grad(lambda v: self.u(v, lam))
        u_x, g_x = u_and_grad(x)
        flat = (x.shape[0], -1)

        def qpot(a, b, g):
            term = (a - b + s * g).reshape(flat)
            return (term * term).sum(-1) / (4.0 * s)

        for i in range(self.n_steps):
            x_prime = x - s * g_x + math.sqrt(2.0 * s) * noise[i]
            u_xp, g_xp = u_and_grad(x_prime)
            # (-u') - (-u) + (-q(x|x')) - (-q(x'|x)), bit for bit
            log_alpha = u_x - u_xp - qpot(x, x_prime, g_xp) + qpot(x_prime, x, g_x)
            # accept-guard semantics as the samplers' (utils.unevaluable_
            # current_mask): a current state with U = +inf or NaN is forced
            # to move to any evaluable proposal (its density under pi_lam is
            # zero); U = -inf currents keep log_alpha = -inf. Non-finite
            # proposals always reject.
            cur_bad = torch.isnan(u_x) | (u_x == math.inf)
            prop_ok = torch.isfinite(u_xp) & torch.isfinite(x_prime.reshape(flat)).all(-1)
            log_alpha = log_alpha.masked_fill(cur_bad, math.inf).masked_fill(~prop_ok, -math.inf)
            accept = torch.log(uniforms[i]) < log_alpha
            mask = accept.reshape(accept.shape + (1,) * (x.dim() - 1))
            x = torch.where(mask, x_prime, x)
            u_x = torch.where(accept, u_xp, u_x)
            g_x = torch.where(mask, g_xp, g_x)
        return x


def make_mala_sweep(u_tempered: Callable, n_steps: int = 5, step_size: float = 0.05) -> MALASweep:
    """The MALA correction sweep used between annealing levels (the
    reference's AFT intends ``mh``/``hmc`` there but crashes,
    ``annealed_flow_transport.py:120-128``)."""
    return MALASweep(u_tempered, n_steps=n_steps, step_size=step_size)


def flat_value_and_grad(loss_fn: Callable, theta: torch.Tensor, like):
    """``(loss, d loss / d theta)`` of ``loss_fn(params)`` at the flat
    parameter vector ``theta`` unpacked like the tree ``like``
    (:func:`nfmc_torch.ops.coupling.unpack_like`), both detached."""
    from ..ops.coupling import unpack_like

    with torch.enable_grad():
        th = theta.detach().requires_grad_(True)
        loss = loss_fn(unpack_like(th, like))
        (g,) = torch.autograd.grad(loss, th)
    return loss.detach(), g
