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

from ..flows.spline import n_params_per_dim
from .build import library, register
from .coupling import (_check_params, _check_rows, _from_leaves, _layer_sets, _leaves, _on_device,
                       unpack_like)

_MAX_SHARED_BYTES = 232448  # what one block can opt into on an H100
_WARPS = 8  # the kernels' warps per block


def spline_stack_plain(params, x: torch.Tensor, kind: str, n_bins: int, tail_bound: float,
                       inverse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the forward kernel: ``(B, d) -> (y,
    log_det)``, layer by layer as ``nfmc_tpu/flows/coupling.py:76-106``.
    Layer l conditions on the dims with ``(i + l) % 2 == 0``; its raw output
    is reshaped dim-major to ``(B, db, P)``."""
    from ..flows.conditioners import mlp_apply
    from ..flows.transforms import LRSplineTransform, RQSplineTransform

    transform = (RQSplineTransform if kind == "rqs" else LRSplineTransform)(n_bins, tail_bound)
    n, d = x.shape
    ld = torch.zeros(n, dtype=x.dtype, device=x.device)
    layers = range(len(params) - 1, -1, -1) if inverse else range(len(params))
    for l in layers:
        a, b = _layer_sets(d, l, x.device)
        raw = mlp_apply(params[l], x[:, a]).reshape(n, b.numel(), transform.n_params_per_dim)
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
    leaves = [t.detach().requires_grad_(True) for t in _leaves(params)]
    xd = x.detach().requires_grad_(True)
    with torch.enable_grad():
        y, ld = spline_stack_plain(_from_leaves(leaves, [len(p["w"]) for p in params]), xd,
                                   kind, n_bins, tail_bound, inverse)
        gx, *grads = torch.autograd.grad((y, ld), [xd, *leaves], (gy, gld))
    return gx, _from_leaves(grads, [len(p["w"]) for p in params])


def shared_bytes(kind: str, n_bins: int, d: int, hidden: int, backward: bool) -> int:
    """Shared memory a kernel block needs at one row per warp: the rows'
    state (and, backward, its cotangent), both hidden activations and the
    widest conditioner output."""
    width = (2 if backward else 1) * d + 2 * hidden + ((d + 1) // 2) * n_params_per_dim(kind, n_bins)
    return _WARPS * 4 * width


def _check_fits(kind, n_bins, d, hidden, backward):
    need = shared_bytes(kind, n_bins, d, hidden, backward)
    if need > _MAX_SHARED_BYTES:
        raise ValueError(
            f"the spline {'backward ' if backward else ''}kernel needs {need} bytes of shared "
            f"memory a block ({_WARPS} rows of d={d}, H={hidden}, "
            f"{n_params_per_dim(kind, n_bins)} raw parameters per dim), more than the "
            f"{_MAX_SHARED_BYTES} an H100 block can hold")


def _launch(wrapper, params, x: torch.Tensor, kind: str, n_bins: int, tail_bound: float,
            inverse: bool, packed: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_rows(x, "input")
    packed = _check_params(params, x, packed)
    n, d = x.shape
    hidden = int(params[0]["w"][1].shape[0])
    _check_fits(kind, n_bins, d, hidden, backward=False)
    y = torch.empty_like(x)
    ld = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return y, ld
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = library("spline").nfmc_spline_stack(
            x.data_ptr(), packed.data_ptr(), y.data_ptr(), ld.data_ptr(), n, d, hidden,
            len(params), int(n_bins), float(tail_bound), int(inverse), int(kind == "lrs"), stream)
    if err != 0:
        raise RuntimeError(f"spline kernel launch failed: cudaError {err}")
    wrapper.launches += 1
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
    _check_fits(kind, n_bins, d, hidden, backward=True)
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
    if err != 0:
        raise RuntimeError(f"spline backward kernel launch failed: cudaError {err}")
    fused_spline_vjp.launches += 1
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

    ``apply(x, packed, kind, n_bins, tail_bound, inverse, depths, *leaves)``
    with ``leaves`` the parameter tensors in packed order (``_leaves``)."""

    @staticmethod
    def forward(ctx, x, packed, kind, n_bins, tail_bound, inverse, depths, *leaves):
        params = _from_leaves(leaves, depths)
        ctx.save_for_backward(x, *leaves)
        ctx.packed, ctx.depths = packed, depths
        ctx.spline = (kind, n_bins, tail_bound, inverse)
        return _stack(params, x, kind, n_bins, tail_bound, inverse, packed)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy, gld):
        x, *leaves = ctx.saved_tensors
        params = _from_leaves(leaves, ctx.depths)
        gx, grads = fused_spline_vjp(params, x, gy.contiguous(), gld.contiguous(), *ctx.spline,
                                     packed=ctx.packed)
        return (gx if ctx.needs_input_grad[0] else None, None, None, None, None, None, None,
                *_leaves(grads))


def _apply(params, x, kind, n_bins, tail_bound, inverse, packed):
    n_params_per_dim(kind, n_bins)  # validates the kind
    leaves = _leaves(params)
    if torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in leaves)):
        return SplineStack.apply(x, packed, kind, int(n_bins), float(tail_bound), bool(inverse),
                                 tuple(len(p["w"]) for p in params), *leaves)
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
