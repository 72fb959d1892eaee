"""Flow training: forward-KL MLE ``fit``, the fixed-effort ``make_scan_fit``
and the reverse-KL ``variational_fit`` (counterpart of
``nfmc_tpu/flows/train.py``).

Adam (``optax.adam``: b1 0.9, b2 0.999, eps 1e-8; ``_AdamW`` adds
``optax.adamw``'s weight decay 1e-4) runs on one flat parameter vector in
:func:`nfmc_torch.utils.tree_leaves` order (for the coupling flows, the
packed order of the kernels), for any flow's tree. A batch whose
loss or any gradient is non-finite changes neither the parameters nor the
moments, through ``torch.where`` and with no host synchronisation; the best
weights and loss are tracked on the device per epoch. ``fit`` synchronises
with the host once per block of ``check_every`` epochs, where it applies the
early-stopping count, the time limit and the ``ValueError`` contract that
lets callers roll back. For RealNVP and the coupling splines each training
step goes forward through the flow's coupling kernel and back through its
backward kernel (``RealNVPStack`` or ``SplineStack``); a ``variational_fit``
step goes through the flow's inverse and back through the backward kernel
in the inverse direction. Other flows train through autograd of their plain
PyTorch math. A bijection with a nonzero ``regularization_weight`` adds its
regularizer to the MLE and reverse-KL losses.

``mesh`` (a ``torch.distributed`` ``DeviceMesh``) trains data-parallel, as
the JAX package's ``mesh`` does: the batch rounds to a multiple of the
mesh's size, each rank of the mesh's first axis takes its slice of every
global batch (or of each step's base draws) and computes its share of the
global loss, and one ``all_reduce`` a step sums the flat gradient and the
loss before Adam's step. The validation loss is summed the same way, so
every rank takes the same steps and ends with the same weights. On a
one-rank mesh the weights equal those of the run without a mesh bit for
bit.

On CUDA, a fit of a flow whose bijection declares ``graph_capturable``
(RealNVP and the coupling splines; :func:`nfmc_torch.core.graphs.
fit_captures`) runs as replays of a captured CUDA graph, as the JAX package
runs each block as one jitted ``lax.scan``: a graph's iteration is one epoch
of ``fit`` or ``make_scan_fit`` (every batch's Adam step, then the
validation loss and the best weights) or one step of ``variational_fit``.
The carried tensors (the flat weights, Adam's moments and count, the best
weights and loss) and the fit's data live in the graph's static buffers.
An eager prologue makes the draws (each epoch's permutation, each step's
base draws) from the fit's generator in the eager loop's order, and the
graph reads them at its counter; the host reads a block's losses once, as
before. The graphs live in :data:`nfmc_torch.core.graphs.CACHE`, owned by
the flow (``fit``, ``variational_fit``) or by the ``make_scan_fit``
closure, so a refit of the same shapes replays a graph captured once. A
``make_scan_fit`` call inside another graph's capture (a refitting
sampler's iteration) replays no graph of its own: its epochs run inline, a
WHILE node, on rows the caller hoisted. A fit
on several ranks, of a flow without the declaration, or under
:func:`~nfmc_torch.core.graphs.disable_graphs` runs the eager loop, with
which a replayed fit agrees bit for bit. :data:`COUNTS` holds the MLE Adam
steps and epochs and the reverse-KL steps done, a replay adding what its
capture recorded.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..core import graphs
from ..core.rng import resolve_generator
from ..ops import build
from ..ops.coupling import unpack_like
from ..utils import Progress, as_numpy, tree_leaves, tree_map

#: Flow-training work done in this process: the MLE Adam steps
#: (``_train_step``) and epochs (``_train_epoch``) and the reverse-KL Adam
#: steps, each replay of a captured fit adding what its capture recorded
#: (:func:`nfmc_torch.ops.build.tally`).
COUNTS = {"steps": 0, "epochs": 0, "variational_steps": 0}


def _finite_update(loss: torch.Tensor, grads: torch.Tensor) -> torch.Tensor:
    """True iff the loss AND every gradient are finite: a finite loss does
    not imply finite gradients, and NaN gradients would poison the Adam
    moments."""
    return torch.isfinite(loss) & torch.isfinite(grads).all()


def _adaptive_batch_size(n_train: int) -> int:
    """'adaptive' rule: ~n/10 clamped to [32, 4096], rounded to a power of two."""
    if n_train <= 32:
        return max(n_train, 1)
    target = max(32, min(4096, n_train // 10 if n_train >= 320 else n_train))
    return 1 << int(math.floor(math.log2(target)))


def _pad_to_multiple(x: np.ndarray, multiple: int):
    n = len(x)
    n_pad = (-n) % multiple
    if n_pad:
        pad = np.repeat(x[-1:], n_pad, axis=0)
        x = np.concatenate([x, pad], axis=0)
    weights = np.ones(len(x), dtype=np.float32)
    weights[n:] = 0.0
    return x, weights


def fixed_effort_fit_config(fit_kwargs):
    """Static config tuple when ``fit_kwargs`` describe a fixed-effort fit (no
    early stopping, no time limit, no unknown kwargs) that can run inside a
    chunk runner, else ``None``."""
    kw = dict(fit_kwargs or {})
    if kw.get("early_stopping", False) or kw.get("time_limit_seconds") is not None:
        return None
    allowed = {
        "n_epochs", "lr", "batch_size", "keep_best_weights", "shuffle",
        "early_stopping", "early_stopping_threshold", "show_progress",
        "check_for_divergences", "time_limit_seconds",  # explicit None is fixed-effort
    }
    if set(kw) - allowed:
        return None
    return (
        int(kw.get("n_epochs", 500)),
        float(kw.get("lr", 5e-3)),
        kw.get("batch_size", "adaptive"),
        bool(kw.get("keep_best_weights", True)),
        bool(kw.get("shuffle", True)),
    )


def _data_shard(mesh):
    """``(shard, n_devices)`` of a ``DeviceMesh`` (``(None, 1)`` for None):
    the slices go over the mesh's first axis, the batch rounds to a
    multiple of all its devices."""
    if mesh is None:
        return None, 1
    from torch.distributed.device_mesh import DeviceMesh

    from ..core.chains import ChainShard

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(nfmc_torch.parallel.chain_mesh), got {type(mesh).__name__}")
    return ChainShard(mesh), mesh.size()


def _agreed_generator(device, generator, seed, shard):
    """The fit's generator; with a shard and no seed, rank 0's next seed on
    every rank, so that the ranks shuffle and draw alike."""
    if shard is not None and generator is None and seed is None:
        from ..core.rng import next_seed

        seed = shard.agree_seed(next_seed())
    return resolve_generator(device, generator, seed)


def _flatten(params) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1) for t in tree_leaves(params)]).to(torch.float32)


class _Adam:
    """``optax.adam(lr)`` on a flat parameter vector, with the masked skip:
    where ``finite`` is False neither the vector nor the moments change
    (``finite=None`` updates unconditionally, as an unguarded optax step)."""

    b1, b2, eps = 0.9, 0.999, 1e-8
    weight_decay = 0.0

    def __init__(self, theta: torch.Tensor, lr: float):
        self.lr = lr
        self.mu = torch.zeros_like(theta)
        self.nu = torch.zeros_like(theta)
        self.count = torch.zeros((), dtype=torch.float32, device=theta.device)

    @classmethod
    def resume(cls, lr: float, mu: torch.Tensor, nu: torch.Tensor, count: torch.Tensor):
        """The optimizer at moments ``mu``, ``nu`` and step ``count``."""
        adam = cls.__new__(cls)
        adam.lr, adam.mu, adam.nu, adam.count = lr, mu, nu, count
        return adam

    def step(self, theta, g, finite=None):
        count = self.count + 1.0
        mu = (1.0 - self.b1) * g + self.b1 * self.mu
        nu = (1.0 - self.b2) * (g * g) + self.b2 * self.nu
        mu_hat = mu / (1.0 - torch.pow(self.b1, count))
        nu_hat = nu / (1.0 - torch.pow(self.b2, count))
        update = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        if self.weight_decay:
            update = update + self.weight_decay * theta
        theta_new = theta + (-self.lr) * update
        if finite is None:
            self.mu, self.nu, self.count = mu, nu, count
            return theta_new
        self.mu = torch.where(finite, mu, self.mu)
        self.nu = torch.where(finite, nu, self.nu)
        self.count = torch.where(finite, count, self.count)
        return torch.where(finite, theta_new, theta)


class _AdamW(_Adam):
    """``optax.adamw(lr)`` at optax's defaults: Adam's update plus
    ``weight_decay * theta``, both scaled by ``-lr``."""

    weight_decay = 1e-4


def _rows(t, shard):
    return t if shard is None or t is None else shard.rows(t)


def _batch_mean(v, x, w, shard):
    """The mean of per-row terms ``v`` (this rank's rows) over the global
    batch ``x``, weighted by ``w`` when given: with a shard, this rank's
    share of it (the shares sum to the mean)."""
    if w is None:
        return v.sum() / x.shape[0]
    return (v * _rows(w, shard)).sum() / w.sum().clamp_min(1.0)


def _nll(flow, params, x, w=None, shard=None) -> torch.Tensor:
    """Negative mean log-likelihood, weighted when ``w`` is given (padding
    rows carry weight 0); with a data ``shard``, this rank's share of it."""
    return -_batch_mean(flow.log_prob_fn(params, _rows(x, shard)), x, w, shard)


def _mle_loss(flow):
    """The MLE loss ``(flow, params, x, w) -> loss``: the weighted NLL, plus
    the bijection's regularizer times its ``regularization_weight`` when
    that is nonzero (a per-sample regularizer weighted like the samples, a
    scalar one applied unweighted), as ``nfmc_tpu/flows/train.py:271-286``."""
    reg_weight = float(getattr(flow.bijection, "regularization_weight", 0.0))
    if not reg_weight:
        return _nll

    def loss(flow, params, x, w=None, shard=None):
        reg = flow.bijection.regularization(params, _rows(x, shard))
        if reg.dim():
            reg = _batch_mean(reg, x, w, shard)
        elif shard is not None:
            reg = reg / shard.size
        return _nll(flow, params, x, w, shard) + reg_weight * reg

    return loss


def _sum_shares(g, loss, shard):
    """The gradient and loss summed over the ranks' shares, in one
    ``all_reduce``."""
    if shard is None:
        return g, loss
    both = shard.sum(torch.cat([g, loss.reshape(1)]))
    return both[:-1], both[-1]


def _train_step(flow, like, theta, adam, xb, wb, loss_fn=_nll, shard=None):
    """One Adam step on a batch (this rank's slice of it, with a data
    ``shard``); returns ``(theta, loss)``."""
    build.tally(COUNTS, "steps")
    with torch.enable_grad():
        th = theta.detach().requires_grad_(True)
        loss = loss_fn(flow, unpack_like(th, like), xb, wb, shard)
        (g,) = torch.autograd.grad(loss, th)
    g, loss = _sum_shares(g, loss.detach(), shard)
    with torch.no_grad():
        return adam.step(theta, g, _finite_update(loss, g)), loss


def _train_epoch(flow, like, theta, adam, xs, ws, loss_fn=_nll, shard=None):
    """Adam steps over the batches ``xs`` (n_batches, bs, *event) with
    weights ``ws`` (or None); returns ``(theta, losses)``."""
    build.tally(COUNTS, "epochs")
    losses = []
    for i in range(xs.shape[0]):
        theta, loss = _train_step(flow, like, theta, adam, xs[i], None if ws is None else ws[i],
                                  loss_fn, shard)
        losses.append(loss)
    return theta, torch.stack(losses)


# ---- a fit's iterations, eager or replayed --------------------------------------------------
# (the carried tensors: theta, Adam's mu, nu and count, the best theta and loss)

def _start(theta: torch.Tensor, lr: float) -> list:
    """A fit's carried tensors at its start: a fresh Adam, the best loss
    inf and the best weights ``theta`` (made on the device: a tensor of host
    data cannot be made under a capture)."""
    adam = _Adam(theta, lr)
    return [theta, adam.mu, adam.nu, adam.count, theta,
            torch.full((), math.inf, device=theta.device)]


def _resume(carry, lr: float):
    """``(theta, adam, best, best_loss)`` of the carried tensors."""
    theta, mu, nu, count, best, best_loss = carry
    return theta, _Adam.resume(lr, mu, nu, count), best, best_loss


def _fitted(carry, keep_best: bool) -> torch.Tensor:
    """The flat weights a fit ends with (the best ones with ``keep_best``),
    copied: the carried tensors may be a graph's static buffers, which its
    next replay overwrites."""
    return (carry[4] if keep_best else carry[0]).clone()


def _skeleton(params):
    """``params``'s tree with shape-only (meta) tensors, for
    :func:`unpack_like` in a cached graph's body, which must not keep the
    weights of the call that made it."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), params)


def _replays(owner, flow, config: tuple, step, outs, length: int, keep=()):
    """:func:`nfmc_torch.core.graphs.replays` for a fit of ``flow``: the key
    also holds the ids of ``flow``'s bijection and base-density override,
    which the graph keeps alive, besides ``keep``."""
    return graphs.replays(owner, config, step, outs, length,
                          (flow.bijection, flow._base_log_prob_override, *keep))


def make_scan_fit(flow, n_rows: int, n_epochs: int, lr: float = 0.005,
                  batch_size="adaptive", shuffle: bool = True,
                  keep_best_weights: bool = False, train_pct: float = None,
                  max_train_size: int = 4096, max_val_size: int = 4096):
    """Fixed-effort MLE fit with no host synchronisation:
    ``fit(params, data, generator=None, rows=None) -> params`` with
    ``data: (n_rows, *event)``.

    Mirrors :func:`fit` without host control flow: a fresh Adam per call,
    ``n_epochs`` of minibatch steps, optional per-epoch best-weight tracking
    and a rollback to the input params when the fitted ones give a
    non-finite loss. With ``train_pct`` set the data shuffles into a
    train/val split (capped at the max sizes) and best weights track the
    val loss. As in the JAX package, the train set truncates to a multiple
    of the batch size instead of padding the last batch.

    A call's randomness is its ``rows``: the split's permutation (with
    ``train_pct``), then each epoch's (with ``shuffle``), as ``fit.draw
    (generator)`` makes them, in that order; without ``rows`` the call
    draws them so from ``generator``. ``fit.draws(generator, gate)`` makes
    the rows of a block of calls up front (the refitting chunks hoist them
    from the fit's generator), ``fit.row_elems`` counts one call's.

    A call replays a graph of its own epochs (where
    :func:`nfmc_torch.core.graphs.fit_captures` holds) or runs them
    eagerly, also in a graph's first, eager iteration. Inside a graph's
    capture (a refitting chunk's iteration, the JAX package's scan with
    this fit in its body) it runs inline on hoisted rows: a
    :func:`graphs.loop` over the epochs (a WHILE node) that reads each
    epoch's permutation at its counter; no host read, no tensor of host
    data."""
    event_shape = flow.event_shape
    if train_pct is not None:
        n_train = max(1, min(int(n_rows * train_pct), max_train_size))
        n_val = min(n_rows - n_train, max_val_size)
    else:
        n_train = n_rows
        n_val = 0
    if batch_size in ("adaptive", None):
        bs = _adaptive_batch_size(n_train)
    else:
        bs = min(int(batch_size), n_train)
    n_eff = max(bs, (n_train // bs) * bs)
    n_batches = n_eff // bs
    keep_best = keep_best_weights and n_val > 0
    # the rows an epoch's permutation ranges over: the split's train rows,
    # or all the data
    n_perm = n_eff if train_pct is not None else n_rows
    shapes = ([(n_rows,)] if train_pct is not None else []) + (
        [(n_epochs, n_eff)] if shuffle else [])

    def draw(generator):
        rows = []
        if train_pct is not None:
            rows.append(torch.randperm(n_rows, generator=generator, device=generator.device))
        if shuffle:
            rows.append(torch.stack([
                torch.randperm(n_perm, generator=generator, device=generator.device)[:n_eff]
                for _ in range(n_epochs)]) if n_epochs else
                torch.empty((0, n_eff), dtype=torch.int64, device=generator.device))
        return rows

    def draws(generator, gate):
        """The rows of ``len(gate)`` calls, stacked: drawn in order for the
        calls where ``gate`` holds (an int: that many calls, all drawn), as
        many eager calls would draw them; zeros where it does not."""
        if isinstance(gate, int):
            gate = [True] * gate
        if not shapes:
            return []
        device = generator.device
        drawn = [draw(generator) for g in gate if g]
        out = []
        for i, shape in enumerate(shapes):
            if len(drawn) == len(gate):
                out.append(torch.stack([d[i] for d in drawn]))
                continue
            t = torch.zeros((len(gate), *shape), dtype=torch.int64, device=device)
            if drawn:
                at = torch.as_tensor(np.flatnonzero(np.asarray(gate, dtype=bool)), device=device)
                t.index_copy_(0, at, torch.stack([d[i] for d in drawn]))
            out.append(t)
        return out

    def scan_fit(params, data, generator=None, rows=None):
        if rows is None:
            if graphs.in_body() and shapes:
                raise RuntimeError("inside a graph's body a fit takes hoisted rows "
                                   "(fit.draws), not a generator")
            rows = draw(generator)
        rows = list(rows)
        split = rows.pop(0) if train_pct is not None else None
        perms = rows.pop(0) if shuffle else None
        device = data.device
        with torch.no_grad():
            if split is not None:
                xt = data[split[:n_eff]]
                xv = data[split[n_train:n_train + n_val]] if n_val else data[split[:bs]]
            else:
                xt = data
                xv = data[:bs]
        theta0 = _flatten(params)
        like = _skeleton(params)

        def epoch(carry, consts, rows):
            xt_, xv_ = consts
            theta, adam, best, best_loss = _resume(carry, lr)
            xs = xt_[rows[0]] if shuffle else xt_[:n_eff]
            theta, losses = _train_epoch(flow, like, theta, adam,
                                         xs.reshape(n_batches, bs, *event_shape), None)
            with torch.no_grad():
                vl = _nll(flow, unpack_like(theta, like), xv_) if keep_best else losses.mean()
                better = vl < best_loss
                best_loss = torch.where(better, vl, best_loss)
                if keep_best:
                    best = torch.where(better, theta, best)
            return [theta, adam.mu, adam.nu, adam.count, best, best_loss], []

        if graphs.in_body() and not graphs.warming():
            carry = _inline_epochs(epoch, _start(theta0, lr), [xt, xv], perms, n_epochs, device)
        else:
            # the WHILE node that a capture of the body around this call opens
            graphs.eager_scope(device)
            graph_of, length = None, 1
            if graphs.fit_captures(flow, device):
                length = graphs.hoist_length(n_epochs, 2 * n_eff if shuffle else 0)
                graph_of = _replays(scan_fit, flow, ("make_scan_fit",), epoch, [], length)
            carry, _, _ = graphs.iterations(epoch, _start(theta0, lr), [xt, xv],
                                            graphs.sliced([perms] if shuffle else []),
                                            n_epochs, graph_of, length)
        with torch.no_grad():
            fitted = _fitted(carry, keep_best)
            ok = torch.isfinite(_nll(flow, unpack_like(fitted, params), xv))
            return unpack_like(torch.where(ok, fitted, theta0), params)

    scan_fit.draw, scan_fit.draws = draw, draws
    # a call's rows in float32 elements (int64 rows count twice)
    scan_fit.row_elems = 2 * sum(int(np.prod(s)) for s in shapes)
    # what a body that calls the fit bakes in, for a graph's key
    scan_fit.config = (id(flow), id(flow.bijection), id(flow._base_log_prob_override), n_rows,
                       n_epochs, float(lr), bs, bool(shuffle), bool(keep_best_weights), train_pct,
                       max_train_size, max_val_size)
    return scan_fit


def _inline_epochs(epoch, carry: list, consts: list, perms, n_epochs: int, device) -> list:
    """A fit's epochs inside a graph's capture: a :func:`graphs.loop` over
    them, the carried tensors fresh copies made before it and written in
    place each epoch (a loop's state crosses its scope so), epoch ``t``'s
    permutation read at the loop's device counter ``t``."""
    carry = [t.clone() for t in carry]

    def run(t):
        rows = [] if perms is None else [perms.index_select(0, t.view(1))[0]]
        new, _ = epoch(carry, consts, rows)
        for c, n in zip(carry, new):
            if n is not c:
                c.copy_(n)

    graphs.loop(n_epochs, lambda t: t < n_epochs, run, device)
    return carry


def fit(
    flow,
    x_train,
    x_val=None,
    n_epochs: int = 500,
    lr: float = 0.005,  # the reference's 0.05 diverges with He-init tanh conditioners
    batch_size="adaptive",
    shuffle: bool = True,
    early_stopping: bool = False,
    early_stopping_threshold: int = 50,
    keep_best_weights: bool = True,
    show_progress: bool = False,
    time_limit_seconds: Optional[float] = None,
    check_for_divergences: bool = False,
    mesh=None,
    generator: Optional[torch.Generator] = None,
    seed: Optional[int] = None,
) -> None:
    """Forward-KL MLE on samples; replaces ``flow.params``. Raises
    ``ValueError`` when training diverges (non-finite validation loss).
    ``mesh``: a ``DeviceMesh`` to train over data-parallel (module doc)."""
    t_start = time.time()
    shard, n_devices = _data_shard(mesh)
    device = flow.get_device()
    generator = _agreed_generator(device, generator, seed, shard)
    event_shape = flow.event_shape

    x_train = as_numpy(x_train).astype(np.float32)
    x_train = x_train.reshape(len(x_train), *event_shape)
    n_train = len(x_train)
    if n_train == 0:
        raise ValueError("empty training set")
    if batch_size == "adaptive" or batch_size is None:
        bs = _adaptive_batch_size(n_train)
    else:
        bs = min(int(batch_size), n_train)
    if mesh is not None:
        bs = max(n_devices, (bs // n_devices) * n_devices)  # the batch tiles the mesh
    x_train_p, w_train = _pad_to_multiple(x_train, bs)
    n_batches = len(x_train_p) // bs
    data = torch.as_tensor(x_train_p, device=device)
    w_data = torch.as_tensor(w_train, device=device)

    if x_val is not None and len(x_val) > 0:
        # JAX pads the validation set to a power-of-two bucket only so that
        # refits reuse one compiled trainer; the weighted mean is the same,
        # so here it stays unpadded (weight None: the plain mean)
        x_val = as_numpy(x_val).astype(np.float32)
        val_data = torch.as_tensor(x_val.reshape(len(x_val), *event_shape), device=device)
        val_weights = None
    else:
        val_data, val_weights = data, w_data

    like = _skeleton(flow.params)
    loss_fn = _mle_loss(flow)
    reg_weight = float(getattr(flow.bijection, "regularization_weight", 0.0))
    check_every = max(1, min(64, early_stopping_threshold if early_stopping else 64, n_epochs))
    graphed = graphs.fit_captures(flow, device, shard)
    # a captured fit runs on one rank, where the shares are the sums
    step_shard = None if graphed else shard
    own_val = val_weights is None

    def epoch(carry, consts, rows):
        data_, w_data_, *val = consts
        theta, adam, best, best_loss = _resume(carry, lr)
        xs, ws = (data_[rows[0]], w_data_[rows[0]]) if shuffle else (data_, w_data_)
        theta, _ = _train_epoch(flow, like, theta, adam, xs.reshape(n_batches, bs, *event_shape),
                                ws.reshape(n_batches, bs), loss_fn, step_shard)
        with torch.no_grad():
            vl = loss_fn(flow, unpack_like(theta, like), *((val[0], None) if own_val
                                                           else (data_, w_data_)), step_shard)
            if step_shard is not None:
                vl = step_shard.sum(vl)
            better = vl < best_loss
            best_loss = torch.where(better, vl, best_loss)
            if keep_best_weights:
                best = torch.where(better, theta, best)
        return [theta, adam.mu, adam.nu, adam.count, best, best_loss], [vl]

    def draw(k):
        if not shuffle:
            return []
        return [torch.stack([torch.randperm(len(data), generator=generator, device=device)
                             for _ in range(k)])]

    carry = _start(_flatten(flow.params), lr)
    consts = [data, w_data] + ([val_data] if own_val else [])
    graph_of, length = None, 1
    if graphed:
        length = graphs.hoist_length(check_every, len(data) if shuffle else 0)
        graph_of = _replays(flow, flow, ("fit", n_batches, bs, bool(shuffle),
                                         bool(keep_best_weights), own_val, float(lr), reg_weight),
                            epoch, [((), torch.float32)], length)

    epochs_done = 0
    epochs_since_best = 0
    global_best = math.inf

    bar = Progress(total=n_epochs, desc="Fitting NF", disable=not show_progress)
    try:
        while epochs_done < n_epochs:
            if time_limit_seconds is not None and _over(t_start, time_limit_seconds, shard):
                break
            block = min(check_every, n_epochs - epochs_done)
            carry, consts, (vls,) = graphs.iterations(epoch, carry, consts, draw, block,
                                                      graph_of, length)
            vls = vls.cpu().numpy()  # the block's one synchronisation
            epochs_done += block
            bar.update(block)
            if not np.all(np.isfinite(vls)):
                # the ValueError contract: callers roll the weights back
                if check_for_divergences or not np.isfinite(vls[-1]):
                    flow.params = unpack_like(_fitted(carry, keep_best_weights), like)
                    raise ValueError("flow training diverged (non-finite loss)")
            for vl in vls:
                if vl < global_best:
                    global_best = float(vl)
                    epochs_since_best = 0
                else:
                    epochs_since_best += 1
            if show_progress:
                bar.set_postfix_str(f"val loss: {vls[-1]:.4f} (best {global_best:.4f})")
            if early_stopping and epochs_since_best >= early_stopping_threshold:
                break
    finally:
        bar.close()

    flow.params = unpack_like(_fitted(carry, keep_best_weights), like)


def _reverse_kl(flow, params, z, target_log_prob, reg_weight: float = 0.0,
                shard=None) -> torch.Tensor:
    """``mean(-target_log_prob(x) - log_det_inv)`` with ``x = inverse(z)``;
    the base entropy is constant and dropped. A nonzero ``reg_weight`` adds
    that times the mean of the bijection's regularizer at ``x``. With a data
    ``shard``, this rank's share of it over its slice of ``z``."""
    x, log_det_inv = flow.bijection.inverse_fn(params, _rows(z, shard))
    loss = _batch_mean(-target_log_prob(x) - log_det_inv, z, None, shard)
    if reg_weight:
        loss = loss + reg_weight * _batch_mean(flow.bijection.regularization(params, x), z, None,
                                               shard)
    return loss


def _over(t_start: float, limit: float, shard) -> bool:
    """The time limit is reached (on some rank's clock, with a shard: the
    ranks stop together)."""
    over = time.time() - t_start > limit
    return shard.any(over) if shard is not None else over


def variational_fit(
    flow,
    target_log_prob: Callable,
    n_samples: int = 128,
    n_epochs: int = 500,
    lr: float = 0.005,  # the reference's 0.05 diverges with He-init tanh conditioners
    early_stopping: bool = False,
    early_stopping_threshold: int = 50,
    keep_best_weights: bool = True,
    show_progress: bool = False,
    time_limit_seconds: Optional[float] = None,
    check_for_divergences: bool = False,
    mesh=None,
    generator: Optional[torch.Generator] = None,
    seed: Optional[int] = None,
    base_draws: Optional[Callable] = None,
) -> None:
    """Reverse-KL fit to an unnormalised ``target_log_prob`` (= -U); replaces
    ``flow.params``. An epoch is one Adam step on ``n_samples`` base draws
    ``base_draws(generator, n_samples)`` (default ``flow.sample_base_fn``).

    As in the JAX package: the best weights are those the best finite loss
    was measured at (taken before the step's update, gated on the loss
    alone); a step whose loss or gradient is not finite changes neither the
    parameters nor Adam's moments; the host looks at the losses once per
    block of ``min(128, n_epochs)`` epochs, counts early stopping per epoch,
    and with ``check_for_divergences`` stops once more than a block's worth
    of losses were not finite. ``mesh``: a ``DeviceMesh`` to train over
    data-parallel, each rank on its slice of every step's draws (module
    doc)."""
    t_start = time.time()
    shard, n_devices = _data_shard(mesh)
    device = flow.get_device()
    generator = _agreed_generator(device, generator, seed, shard)
    base_draws = base_draws or flow.sample_base_fn
    n_samples = max(1, int(n_samples))
    if mesh is not None:
        n_samples = max(n_devices, (n_samples // n_devices) * n_devices)

    like = _skeleton(flow.params)
    reg_weight = float(getattr(flow.bijection, "regularization_weight", 0.0))
    check_every = max(1, min(128, n_epochs))
    graphed = graphs.fit_captures(flow, device, shard)
    # a captured fit runs on one rank, where the shares are the sums
    step_shard = None if graphed else shard

    def step(carry, consts, rows):
        theta, adam, best, best_loss = _resume(carry, lr)
        build.tally(COUNTS, "variational_steps")
        with torch.enable_grad():
            th = theta.detach().requires_grad_(True)
            loss = _reverse_kl(flow, unpack_like(th, like), rows[0], target_log_prob, reg_weight,
                               step_shard)
            (g,) = torch.autograd.grad(loss, th)
        g, loss = _sum_shares(g, loss.detach(), step_shard)
        with torch.no_grad():
            better = torch.isfinite(loss) & (loss < best_loss)
            best_loss = torch.where(better, loss, best_loss)
            if keep_best_weights:
                best = torch.where(better, theta, best)
            theta = adam.step(theta, g, _finite_update(loss, g))
        return [theta, adam.mu, adam.nu, adam.count, best, best_loss], [loss]

    def draw(k):
        return [torch.stack([base_draws(generator, n_samples) for _ in range(k)])]

    carry = _start(_flatten(flow.params), lr)
    graph_of, length = None, 1
    if graphed:
        length = graphs.hoist_length(check_every, n_samples * int(np.prod(flow.event_shape)))
        graph_of = _replays(flow, flow, ("variational_fit", float(lr), bool(keep_best_weights),
                                         reg_weight), step, [((), torch.float32)], length,
                            (target_log_prob,))

    epochs_done = 0
    epochs_since_best = 0
    global_best = math.inf
    n_nonfinite = 0

    bar = Progress(total=n_epochs, desc="Fitting NF (variational)", disable=not show_progress)
    try:
        while epochs_done < n_epochs:
            if time_limit_seconds is not None and _over(t_start, time_limit_seconds, shard):
                break
            block = min(check_every, n_epochs - epochs_done)
            carry, _, (losses,) = graphs.iterations(step, carry, [], draw, block, graph_of, length)
            losses = losses.cpu().numpy()  # the block's one synchronisation
            epochs_done += block
            bar.update(block)
            n_nonfinite += int(np.sum(~np.isfinite(losses)))
            if check_for_divergences and n_nonfinite > block:
                break  # persistent divergence: stop, keep the best weights
            for loss in losses:
                if np.isfinite(loss) and loss < global_best:
                    global_best = float(loss)
                    epochs_since_best = 0
                else:
                    epochs_since_best += 1
            if show_progress:
                bar.set_postfix_str(f"loss: {losses[-1]:.4f} (best {global_best:.4f})")
            if early_stopping and epochs_since_best >= early_stopping_threshold:
                break
    finally:
        bar.close()

    flow.params = unpack_like(_fitted(carry, keep_best_weights), like)
