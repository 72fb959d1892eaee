"""Spline coupling stack: the hand-written CUDA kernels, their wrappers,
their plain PyTorch versions and the ``torch.autograd.Function`` that ties
the two directions of the forward kernel to the backward one.

Each coupling layer applies an elementwise monotone spline to its
transformed half: rational-quadratic (``kind="rqs"``, ``c-rqnsf``) or
linear-rational (``kind="lrs"``, ``c-lrsnsf``), with ``P = 3K - 1`` or
``4K - 1`` raw conditioner outputs per transformed dim (K bins), dim-major
in W3's columns (``i * P + p``).

* ``nfmc_torch/csrc/spline.cu`` replaces the Pallas TPU kernel
  ``nfmc_tpu/ops/experimental_spline_pallas.py::_kernel`` (launched by
  ``_fused_call``; entries ``fused_rqs_forward``, ``fused_rqs_inverse``,
  ``fused_lrs_forward`` and ``fused_lrs_inverse``). What bounds it on an
  H100: FP32 arithmetic. A row costs about 1.36 MFLOP (RQS) or 1.77 MFLOP
  (LRS) at d=100, H=128, L=4, K=8, W3's products the most of it.
* ``nfmc_torch/csrc/spline_bwd.cu`` replaces ``_kernel_bwd`` (launched by
  ``_fused_bwd_call``): the VJP in either direction and kind, gx and every
  weight gradient summed over the batch, deterministically. Entry
  ``fused_spline_vjp``; ``SplineStack`` makes it the gradient of the four
  forward entries, so every flow training step runs it once.

On a CPU tensor the wrappers compute the plain versions. On a CUDA tensor
they launch the kernel or raise: they never fall back. Each wrapper counts
its launches in ``.launches``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from ..flows.spline import branch_points, n_params_per_dim
from ..utils import tree_leaves, tree_unflatten
from .build import count_launch, library, register
from .coupling import (TILE_TOO_LARGE, _check_params, _check_rows, _layer_sets, _on_device,
                       unpack_like, vjp_error)

INVALID_VALUE = 1  # cudaErrorInvalidValue: a launcher's refusal of its arguments
_CHUNK_COLUMNS = 128  # the output columns the kernels produce at a time


def spline_stack_plain(params, x: torch.Tensor, kind: str, n_bins: int, tail_bound: float,
                       inverse: bool, branches: Optional[list] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the forward kernel: ``(B, d) -> (y,
    log_det)``, layer by layer as ``nfmc_tpu/flows/coupling.py:76-106``.
    Layer l conditions on the dims with ``(i + l) % 2 == 0``; its raw output
    is reshaped dim-major to ``(B, db, P)``. With a list ``branches``, each
    layer appends ``(l, b, s)``: its transformed dims b and the signed
    distances ``s (B, db, M)`` from their inputs to the spline's branch
    points (``flows.spline.branch_points``)."""
    from ..flows.conditioners import mlp_apply
    from ..flows.transforms import LRSplineTransform, RQSplineTransform

    transform = (RQSplineTransform if kind == "rqs" else LRSplineTransform)(n_bins, tail_bound)
    n, d = x.shape
    ld = torch.zeros(n, dtype=x.dtype, device=x.device)
    layers = range(len(params) - 1, -1, -1) if inverse else range(len(params))
    for l in layers:
        a, b = _layer_sets(d, l, x.device)
        raw = mlp_apply(params[l], x[:, a]).reshape(n, b.numel(), transform.n_params_per_dim)
        if branches is not None:
            branches.append((l, b, x[:, b, None] - branch_points(raw, kind, n_bins, tail_bound,
                                                                  inverse)))
        step = transform.inverse if inverse else transform.forward
        vb, ld_elem = step(x[:, b], raw)
        x = x.index_copy(1, b, vb)
        ld = ld + ld_elem.sum(-1)
    return x, ld


def spline_stack_vjp_plain(params, x: torch.Tensor, gy: torch.Tensor, gld: torch.Tensor,
                           kind: str, n_bins: int, tail_bound: float, inverse: bool):
    """The plain PyTorch version of the backward kernel: the VJP of
    ``spline_stack_plain``, taken by ``torch.autograd``, so that it is
    independent of the kernel's hand-derived calculus. Returns ``(gx,
    grads)`` with ``grads`` shaped like ``params``."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    xd = x.detach().requires_grad_(True)
    with torch.enable_grad():
        y, ld = spline_stack_plain(tree_unflatten(params, leaves), xd, kind, n_bins, tail_bound,
                                   inverse)
        gx, *grads = torch.autograd.grad((y, ld), [xd, *leaves], (gy, gld))
    return gx, tree_unflatten(params, grads)


def knot_witness(params, x: torch.Tensor, kind: str, n_bins: int, tail_bound: float,
                 inverse: bool):
    """For each row of ``x``, the transformed element that the stack brings
    closest to a branch point of its spline, measured against float32
    rounding. Layer by layer: each element's float64 distance to its nearest
    branch point, and the layer's float32 drift, the largest change of that
    distance over the batch when the plain version runs in float32. Returns
    ``(dist, drift, layer, dim)``, each ``(B,)``: for the row's element with
    the smallest dist / drift. Where ``dist <= drift`` a float32 evaluation
    of the row can take the other branch."""
    found = {}
    for dt in (torch.float64, torch.float32):
        found[dt] = []
        spline_stack_plain([{k: [t.to(dt) for t in v] for k, v in p.items()} for p in params],
                           x.to(dt), kind, n_bins, tail_bound, inverse, found[dt])
    rows = torch.arange(x.shape[0], device=x.device)
    per_layer = []
    for (l, b, s64), (_, _, s32) in zip(found[torch.float64], found[torch.float32]):
        near = s64.abs().argmin(-1, keepdim=True)
        s64 = s64.gather(-1, near)[..., 0]
        dist = s64.abs()
        drift = (s32.double().gather(-1, near)[..., 0] - s64).abs().max()
        j = dist.argmin(1)
        per_layer.append((dist[rows, j], drift.expand(len(rows)), torch.full_like(j, l), b[j]))
    dist, drift, layer, dim = (torch.stack(t) for t in zip(*per_layer))
    k = (dist / drift.clamp_min(1e-300)).argmin(0)
    return tuple(t[k, rows] for t in (dist, drift, layer, dim))


def compare_spline_vjp(got, want, rerun, params, x: torch.Tensor, kind: str, n_bins: int,
                       tail_bound: float, inverse: bool, tol: float) -> Tuple[float, float, str]:
    """The acceptance rule of the spline VJP against a reference: ``got``
    and ``want`` are ``(gx, grads)`` for the rows of ``x``; the error is
    max|got - want| over gx and every weight gradient relative to max(1,
    max|want|). The VJP of the log-det jumps where an element meets a branch
    point, so a float32 evaluation near one may take the other branch and
    differ by O(1) in its row's gx and in its share of the weight gradients.
    Where the error exceeds ``tol``, the rows that ``knot_witness`` finds
    with an element within float32 drift of a branch point are left out:
    ``rerun(keep)`` gives ``(got, want)`` again with the cotangents of the
    rows where ``keep`` is False set to zero (the same launch shape, those
    rows' shares exactly zero), held to ``tol``. Not excused (inf): a row of
    gx off ``tol`` without a witness, more than one row in 100 off, or more
    than one row in 10 with a witness. Returns the relative error, its scale
    and a report naming the rows off (the first 10) and their witnesses."""
    rel, scale, row_err = vjp_error(got, want)
    off = row_err > tol * scale
    text = (f"max|diff| {rel * scale:.3e} (scale max(1, max|ref|) = {scale:.2f}, relative "
            f"{rel:.2e}), rows of gx off the gate {int(off.sum())}")
    if rel <= tol:
        return rel, scale, text
    dist, drift, layer, dim = (t.cpu() for t in knot_witness(params, x, kind, n_bins,
                                                             tail_bound, inverse))
    near = dist <= drift
    rows = off.nonzero()[:, 0].tolist()
    for r in rows[:10]:
        text += (f"; row {r}: gx {float(row_err[r]):.3e} off, its layer {int(layer[r])} dim "
                 f"{int(dim[r])} lies {float(dist[r]):.3e} from a branch point (the layer's "
                 f"float32 drift {float(drift[r]):.3e})")
    n = len(off)
    text += (f"; {len(rows) - 10} more rows off" if len(rows) > 10 else "") + (
        f"; rows with such a witness: {int(near.sum())} of {n}")
    if (not bool(near.any()) or bool((off & ~near).any()) or int(off.sum()) > n // 100
            or int(near.sum()) > n // 10):
        return float("inf"), scale, text + "; not excused"
    rel, scale, _ = vjp_error(*rerun(~near.to(x.device)))
    return rel, scale, text + f"; without them: relative {rel:.2e}"


def _check_launch(err: int, kind: str, n_bins: int, d: int, hidden: int, backward: bool,
                  lib) -> None:
    """Raise for a launcher's nonzero return ``err``: a ValueError naming
    the bytes when the stack's row tile does not fit a block's shared memory
    (the launcher's own count, ``nfmc_spline{,_vjp}_tile_bytes``), or when a
    dim's raw values exceed an output chunk of 128 columns; else a
    RuntimeError with the CUDA error."""
    what = "backward kernel" if backward else "kernel"
    if err == TILE_TOO_LARGE:
        need = (lib.nfmc_spline_vjp_tile_bytes if backward else lib.nfmc_spline_tile_bytes)(
            d, hidden)
        raise ValueError(f"the spline {what} needs {need} bytes of shared memory a block "
                         f"(8 rows of d={d}, H={hidden}), more than a block can hold")
    if err == INVALID_VALUE and n_params_per_dim(kind, n_bins) > _CHUNK_COLUMNS:
        raise ValueError(f"the spline {what} takes at most {_CHUNK_COLUMNS} raw values a dim, "
                         f"got {n_params_per_dim(kind, n_bins)} ({kind}, n_bins={n_bins})")
    if err != 0:
        raise RuntimeError(f"spline {what} launch failed: cudaError {err}")


def _launch(wrapper, params, x: torch.Tensor, kind: str, n_bins: int, tail_bound: float,
            inverse: bool, packed: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_rows(x, "input")
    packed = _check_params(params, x, packed)
    n, d = x.shape
    hidden = int(params[0]["w"][1].shape[0])
    y = torch.empty_like(x)
    ld = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return y, ld
    lib = library("spline")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.nfmc_spline_stack(
            x.data_ptr(), packed.data_ptr(), y.data_ptr(), ld.data_ptr(), n, d, hidden,
            len(params), int(n_bins), float(tail_bound), int(inverse), int(kind == "lrs"), stream)
    _check_launch(err, kind, n_bins, d, hidden, False, lib)
    count_launch(wrapper, (kind, "inverse" if inverse else "forward", d, hidden, len(params), n))
    return y, ld


def _launch_vjp(params, x, gy, gld, kind, n_bins, tail_bound, inverse, packed):
    _check_rows(x, "input")
    _check_rows(gy, "output cotangent")
    if gy.shape != x.shape or gld.shape != (x.shape[0],) or gld.dtype != torch.float32:
        raise ValueError(f"cotangents {tuple(gy.shape)}, {tuple(gld.shape)} do not match "
                         f"the input {tuple(x.shape)}")
    if gy.device != x.device or gld.device != x.device:
        raise ValueError("input and cotangents are on different devices")
    packed = _check_params(params, x, packed)
    gld = gld.contiguous()
    n, d = x.shape
    hidden = int(params[0]["w"][1].shape[0])
    gx = torch.empty_like(x)
    grads = torch.empty_like(packed)
    if n == 0:
        return gx, unpack_like(grads.zero_(), params)
    lib = library("spline_bwd")
    n_par = n_params_per_dim(kind, n_bins)
    scratch = torch.empty(lib.nfmc_spline_vjp_scratch_floats(n, d, hidden, len(params), n_par),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.nfmc_spline_stack_vjp(
            x.data_ptr(), gy.data_ptr(), gld.data_ptr(), packed.data_ptr(), gx.data_ptr(),
            grads.data_ptr(), scratch.data_ptr(), n, d, hidden, len(params), int(n_bins),
            float(tail_bound), int(inverse), int(kind == "lrs"), stream)
    _check_launch(err, kind, n_bins, d, hidden, True, lib)
    count_launch(fused_spline_vjp,
                 (f"{kind} vjp", "inverse" if inverse else "forward", d, hidden, len(params), n))
    return gx, unpack_like(grads, params)


def _stack(params, x, kind, n_bins, tail_bound, inverse, packed):
    if not _on_device(x):
        return spline_stack_plain(params, x, kind, n_bins, tail_bound, inverse)
    wrapper = {("rqs", False): fused_rqs_forward, ("rqs", True): fused_rqs_inverse,
               ("lrs", False): fused_lrs_forward, ("lrs", True): fused_lrs_inverse}[kind, inverse]
    return _launch(wrapper, params, x, kind, n_bins, tail_bound, inverse, packed)


class SplineStack(torch.autograd.Function):
    """The spline coupling stack with the backward kernel as its gradient,
    on both devices: the kernels on CUDA tensors, their plain versions on
    CPU ones. Saves x and the weights, not activations: the backward
    recomputes them.

    ``apply(x, packed, kind, n_bins, tail_bound, inverse, like, *leaves)``
    with ``leaves`` the parameter tensors in packed order (``tree_leaves``)
    of the tree ``like``."""

    @staticmethod
    def forward(ctx, x, packed, kind, n_bins, tail_bound, inverse, like, *leaves):
        params = tree_unflatten(like, leaves)
        ctx.save_for_backward(x, *leaves)
        ctx.packed, ctx.like = packed, like
        ctx.spline = (kind, n_bins, tail_bound, inverse)
        return _stack(params, x, kind, n_bins, tail_bound, inverse, packed)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy, gld):
        x, *leaves = ctx.saved_tensors
        params = tree_unflatten(ctx.like, leaves)
        gx, grads = fused_spline_vjp(params, x, gy.contiguous(), gld.contiguous(), *ctx.spline,
                                     packed=ctx.packed)
        return (gx if ctx.needs_input_grad[0] else None, None, None, None, None, None, None,
                *tree_leaves(grads))


def _apply(params, x, kind, n_bins, tail_bound, inverse, packed):
    n_params_per_dim(kind, n_bins)  # validates the kind
    leaves = tree_leaves(params)
    if torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in leaves)):
        return SplineStack.apply(x, packed, kind, int(n_bins), float(tail_bound), bool(inverse),
                                 params, *leaves)
    return _stack(params, x, kind, n_bins, tail_bound, inverse, packed)


def fused_rqs_forward(params, x: torch.Tensor, n_bins: int, tail_bound: float,
                      packed: Optional[torch.Tensor] = None):
    """Data -> latent through the rational-quadratic stack: ``(B, d) -> (z,
    log_det)``, differentiable in ``x`` and the weights. ``packed`` is
    ``pack_weights(params)``, built once per parameter version by the caller
    (packed here when omitted)."""
    return _apply(params, x, "rqs", n_bins, tail_bound, False, packed)


def fused_rqs_inverse(params, z: torch.Tensor, n_bins: int, tail_bound: float,
                      packed: Optional[torch.Tensor] = None):
    """Latent -> data, layers in reverse: ``(B, d) -> (x, log_det)``."""
    return _apply(params, z, "rqs", n_bins, tail_bound, True, packed)


def fused_lrs_forward(params, x: torch.Tensor, n_bins: int, tail_bound: float,
                      packed: Optional[torch.Tensor] = None):
    """The linear-rational stack (``c-lrsnsf``); the contract of
    ``fused_rqs_forward``."""
    return _apply(params, x, "lrs", n_bins, tail_bound, False, packed)


def fused_lrs_inverse(params, z: torch.Tensor, n_bins: int, tail_bound: float,
                      packed: Optional[torch.Tensor] = None):
    return _apply(params, z, "lrs", n_bins, tail_bound, True, packed)


def fused_spline_vjp(params, x: torch.Tensor, gy: torch.Tensor, gld: torch.Tensor, kind: str,
                     n_bins: int, tail_bound: float, inverse: bool,
                     packed: Optional[torch.Tensor] = None):
    """The VJP of the stack in either direction and kind: ``(gx, grads)``
    with ``grads`` shaped like ``params`` (on CUDA, views of one packed
    buffer)."""
    n_params_per_dim(kind, n_bins)  # validates the kind
    if not _on_device(x):
        return spline_stack_vjp_plain(params, x, gy, gld, kind, n_bins, tail_bound, inverse)
    return _launch_vjp(params, x, gy, gld, kind, n_bins, tail_bound, inverse, packed)


register(fused_rqs_forward, fused_rqs_inverse, fused_lrs_forward, fused_lrs_inverse,
         fused_spline_vjp)
