"""Shared numeric utilities (counterpart of ``nfmc_tpu/utils/__init__.py``)."""
from __future__ import annotations

import math
import sys
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

Shape = Tuple[int, ...]

LOG_2PI = math.log(2.0 * math.pi)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Raises when CUDA is asked for (or defaulted to) and absent:
    nothing falls back to the CPU silently."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; nfmc_torch runs on the GPU by default. "
            "Pass device='cpu' to run on the CPU."
        )
    return device


def event_size_of(event_shape: Sequence[int]) -> int:
    return int(np.prod(np.asarray(event_shape, dtype=np.int64))) if len(event_shape) else 1


def _is_mlp(node) -> bool:
    return (isinstance(node, dict) and set(node) == {"w", "b"}
            and isinstance(node["w"], (list, tuple)))


def tree_leaves(tree) -> list:
    """The tensors of a parameter tree (nested lists, tuples and dicts), in
    a fixed order: a list's children in order; a conditioner
    ``{"w": [...], "b": [...]}`` per dense layer ``w`` then ``b`` (the
    packed order of the coupling kernels' weight buffer); any other dict by
    sorted key, as ``jax.tree_util`` orders it."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if _is_mlp(tree):
        return [t for w, b in zip(tree["w"], tree["b"]) for t in (w, b)]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for child in tree for t in tree_leaves(child)]
    raise TypeError(f"not a parameter tree node: {type(tree).__name__}")


def tree_unflatten(like, leaves) -> object:
    """The tree shaped like ``like`` holding ``leaves`` in
    :func:`tree_leaves`'s order (lists and tuples come back as lists)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        if _is_mlp(node):
            pairs = [(next(it), next(it)) for _ in node["w"]]
            built = {"w": [w for w, _ in pairs], "b": [b for _, b in pairs]}
            return {k: built[k] for k in node}  # the keys in ``like``'s order
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        return [build(child) for child in node]

    return build(like)


def tree_map(fn, tree):
    """``fn`` applied to every tensor of ``tree``, in the same structure."""
    return tree_unflatten(tree, [fn(t) for t in tree_leaves(tree)])


def get_batch_shape(x: torch.Tensor, event_shape: Sequence[int]) -> Shape:
    return tuple(x.shape[: x.dim() - len(event_shape)])


def sum_except_batch(x: torch.Tensor, event_shape: Sequence[int]) -> torch.Tensor:
    """Sum over the trailing event dims."""
    if len(event_shape) == 0:
        return x
    return x.reshape(*get_batch_shape(x, event_shape), -1).sum(-1)


def flatten_event(x: torch.Tensor, event_shape: Sequence[int]) -> torch.Tensor:
    """Reshape ``(*batch, *event)`` to ``(*batch, event_size)``."""
    return x.reshape(*get_batch_shape(x, event_shape), event_size_of(event_shape))


def unflatten_event(x: torch.Tensor, event_shape: Sequence[int]) -> torch.Tensor:
    """Inverse of :func:`flatten_event`."""
    return x.reshape(*x.shape[:-1], *event_shape)


def metropolis_acceptance_log_ratio(
    log_prob_target_curr,
    log_prob_target_prime,
    log_prob_proposal_curr,
    log_prob_proposal_prime,
):
    """log alpha = log p(x') - log p(x) + log g(x|x') - log g(x'|x)."""
    return (
        log_prob_target_prime
        - log_prob_target_curr
        + log_prob_proposal_curr
        - log_prob_proposal_prime
    )


def unevaluable_current_mask(u_curr, logq_curr):
    """True where the current side of a flow-proposal MH ratio cannot be
    evaluated: a NaN potential or a current state of flow density zero
    (``log q = -inf``). Such chains always move to a finite proposal.
    ``U(x) = -inf`` is deliberately not included: ``log_alpha = -inf`` is
    then the correct accept probability. ``U(x) = +inf`` needs no clause, as
    ``log_alpha = +inf`` already accepts."""
    return torch.isnan(u_curr) | ~torch.isfinite(logq_curr)


def batched_grad(fn_batched: Callable[[torch.Tensor], torch.Tensor]):
    """Returns ``x -> dU/dx`` for a batched potential ``U: (B, *event) ->
    (B,)``: one autograd pass over the summed potential, taken with respect
    to ``x`` alone (``torch.autograd.grad``, never ``.backward()``), so
    tensors inside ``U`` that require grad (a flow's weights) accumulate
    nothing."""
    u_and_grad = value_and_batched_grad(fn_batched)
    return lambda x: u_and_grad(x)[1]


def value_and_batched_grad(fn_batched: Callable[[torch.Tensor], torch.Tensor]):
    """Returns ``x -> (U(x), dU/dx)``: one autograd pass over the summed
    potential gives every row's gradient."""

    def fn(x: torch.Tensor):
        with torch.enable_grad():
            v = x.detach().requires_grad_(True)
            u = fn_batched(v)
            (g,) = torch.autograd.grad(u.sum(), v)
        return u.detach(), g

    return fn


def multivariate_normal_sample(generator: torch.Generator, batch_shape: Shape,
                               event_shape: Shape, cov=None, chol=None) -> torch.Tensor:
    """Draws from N(0, cov), N(0, I) when ``cov`` and ``chol`` are None; a
    precomputed Cholesky factor ``chol`` saves the factorisation."""
    dev = generator.device
    if cov is None and chol is None:
        return torch.randn((*batch_shape, *event_shape), generator=generator, device=dev)
    d = event_size_of(event_shape)
    if chol is None:
        chol = torch.linalg.cholesky(torch.as_tensor(cov, dtype=torch.float32, device=dev))
    z = torch.randn((*batch_shape, d), generator=generator, device=dev)
    return (z @ chol.T).reshape(*batch_shape, *event_shape)


def std_normal_log_prob(x: torch.Tensor, event_shape: Sequence[int]) -> torch.Tensor:
    """Batched standard-normal log density over the event dims."""
    d = event_size_of(event_shape)
    return -0.5 * sum_except_batch(x * x, event_shape) - 0.5 * d * LOG_2PI


def as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Progress:
    """A minimal progress line on stderr (the port depends on nothing
    beyond torch and numpy)."""

    def __init__(self, total: int, desc: str = "", disable: bool = False):
        self.total, self.desc, self.disable = total, desc, disable
        self.n = 0
        self.postfix = ""

    def update(self, n: int = 1) -> None:
        self.n += n
        self._draw()

    def set_postfix_str(self, s: str = "") -> None:
        self.postfix = s
        self._draw()

    def _draw(self) -> None:
        if not self.disable:
            sys.stderr.write(f"\r{self.desc}: {self.n}/{self.total} {self.postfix}")
            sys.stderr.flush()

    def close(self) -> None:
        if not self.disable:
            sys.stderr.write("\n")
