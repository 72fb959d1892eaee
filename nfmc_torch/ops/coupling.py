"""RealNVP coupling stack: the hand-written CUDA kernels, their wrappers,
their plain PyTorch versions and the ``torch.autograd.Function`` that ties
the two directions of the forward kernel to the backward one.

* ``nfmc_torch/csrc/coupling.cu`` replaces the Pallas TPU kernel
  ``nfmc_tpu/ops/coupling_pallas.py::_kernel`` (launched by ``_fused_call``;
  entries ``fused_realnvp_forward`` and ``fused_realnvp_inverse``). It runs
  every coupling layer of a row block in one launch, with the rows' state
  and hidden activations in shared memory. What bounds it on an H100: FP32
  arithmetic. At the jump sampler's hoisted shape (d=100, H=128, L=4) a row
  costs about 285 kFLOP, so one chunk of 218,400 proposal rows is about
  62 GFLOP against about 175 MB of input and output; at one jump's 100 rows
  the bound is launch latency.
* ``nfmc_torch/csrc/coupling_bwd.cu`` replaces ``_kernel_bwd`` (launched by
  ``_fused_bwd_call``, wired as the custom VJP of ``_fused_dir``): the VJP in
  either direction, gx and every weight gradient summed over the batch,
  deterministically (see the note in the source). Entry
  ``fused_realnvp_vjp``; ``RealNVPStack`` makes it the gradient of the two
  forward entries, so every flow training step runs it once.

On a CPU tensor the wrappers compute the plain versions. On a CUDA tensor
they launch the kernel or raise: they never fall back. Each wrapper counts
its launches in ``.launches``.

The kernels are built and loaded by :mod:`nfmc_torch.ops.build`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from ..utils import tree_leaves, tree_unflatten
from .build import count_launch, library, register

# What the launchers return, without launching, when not even a row tile of
# 8 rows fits a block's shared memory (cudaErrorInvalidConfiguration;
# kErrTileTooLarge in csrc/coupling_tile.cuh).
TILE_TOO_LARGE = 9


def pack_weights(params) -> torch.Tensor:
    """One contiguous f32 buffer holding, per layer in order, w1, b1, w2, b2,
    w3, b3 in the canonical layout of the parameter pytree (``w`` is
    ``(in, out)`` row-major; w3's columns are dim-major ``(shift_j,
    raw_logscale_j)``). This is the kernels' weight argument, and the
    backward kernel writes the weight gradients in the same layout."""
    parts = []
    for p in params:
        if len(p["w"]) != 3:
            raise ValueError("the coupling kernel needs exactly 2 hidden layers "
                             f"per conditioner, got {len(p['w']) - 1}")
        for w, b in zip(p["w"], p["b"]):
            parts += [w.detach().reshape(-1), b.detach().reshape(-1)]
    return torch.cat(parts).to(torch.float32).contiguous()


def unpack_like(flat: torch.Tensor, params):
    """Split a flat buffer in :func:`tree_leaves` order into views shaped
    like the parameter tree ``params`` (any flow's layout)."""
    leaves = tree_leaves(params)
    parts = flat.split([t.numel() for t in leaves])
    return tree_unflatten(params, [v.view(t.shape) for v, t in zip(parts, leaves)])


def _layer_sets(d: int, l: int, device):
    ids = torch.arange(d, device=device)
    return ids[(ids + l) % 2 == 0], ids[(ids + l) % 2 == 1]


def realnvp_stack_plain(params, x: torch.Tensor, clamp: float,
                        inverse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the forward kernel: ``(B, d) -> (y,
    log_det)``. Layer l conditions on the dims with ``(i + l) % 2 == 0``
    (``nfmc_tpu/flows/coupling.py:55-61``)."""
    from ..flows.conditioners import mlp_apply
    from ..flows.transforms import AffineTransform

    transform = AffineTransform(clamp)
    n, d = x.shape
    ld = torch.zeros(n, dtype=x.dtype, device=x.device)
    layers = range(len(params) - 1, -1, -1) if inverse else range(len(params))
    for l in layers:
        a, b = _layer_sets(d, l, x.device)
        raw = mlp_apply(params[l], x[:, a]).reshape(n, b.numel(), 2)
        step = transform.inverse if inverse else transform.forward
        vb, ld_elem = step(x[:, b], raw)
        x = x.index_copy(1, b, vb)
        ld = ld + ld_elem.sum(-1)
    return x, ld


def realnvp_stack_vjp_plain(params, x: torch.Tensor, gy: torch.Tensor, gld: torch.Tensor,
                            clamp: float, inverse: bool):
    """The plain PyTorch version of the backward kernel, written out
    analytically as the kernel computes it: recompute the forward, then go
    back through the affine map, the soft clamp (factor ``1 - s^2``) and the
    tanh MLP. Returns ``(gx, grads)`` with ``grads`` shaped like
    ``params``."""
    n, d = x.shape
    order = list(range(len(params) - 1, -1, -1)) if inverse else list(range(len(params)))
    saved = []
    for l in order:
        a, b = _layer_sets(d, l, x.device)
        ws, bs = params[l]["w"], params[l]["b"]
        hs = [x[:, a]]
        for w, bias in zip(ws[:-1], bs[:-1]):
            hs.append(torch.tanh(hs[-1] @ w + bias))
        raw = (hs[-1] @ ws[-1] + bs[-1]).reshape(n, b.numel(), 2)
        t, s = raw[..., 0], torch.tanh(raw[..., 1] / clamp)
        ls = clamp * s
        vb = x[:, b]
        vb_new = vb * torch.exp(ls) + t if inverse else (vb - t) * torch.exp(-ls)
        saved.append((l, a, b, hs, s, ls, vb, vb_new))
        x = x.index_copy(1, b, vb_new)

    gx = gy
    grads = [None] * len(params)
    g_ld = gld[:, None]
    for l, a, b, hs, s, ls, vb, vb_new in reversed(saved):
        g_vbn = gx[:, b]
        if inverse:
            e = torch.exp(ls)
            g_t, g_ls, g_vb = g_vbn, g_vbn * vb * e + g_ld, g_vbn * e
        else:
            em = torch.exp(-ls)
            g_vb, g_t, g_ls = g_vbn * em, -g_vbn * em, -g_vbn * vb_new - g_ld
        g = torch.stack([g_t, g_ls * (1.0 - s * s)], -1).reshape(n, -1)  # g_raw
        ws = params[l]["w"]
        gws, gbs = [None] * len(ws), [None] * len(ws)
        for k in range(len(ws) - 1, -1, -1):
            gws[k], gbs[k] = hs[k].T @ g, g.sum(0)
            g = g @ ws[k].T
            if k:
                g = g * (1.0 - hs[k] * hs[k])
        grads[l] = {"w": gws, "b": gbs}
        gx = gx.index_copy(1, b, g_vb).index_add(1, a, g)
    return gx, grads


def vjp_error(got, want):
    """max|got - want| over gx and every weight gradient relative to max(1,
    max|want|), the scale, and each row's max|gx - want gx|."""
    pairs = [(a.to(b.dtype), b) for a, b in
             zip([got[0], *tree_leaves(got[1])], [want[0], *tree_leaves(want[1])])]
    if not all(bool(torch.isfinite(a).all()) for a, _ in pairs):
        return float("inf"), 1.0, torch.full(got[0].shape[:1], float("inf"))
    scale = max(1.0, max(float(b.abs().max()) for _, b in pairs))
    return (max(float((a - b).abs().max()) for a, b in pairs) / scale, scale,
            (pairs[0][0] - pairs[0][1]).abs().amax(1).cpu())


def _check_rows(x: torch.Tensor, what: str) -> None:
    if x.dim() != 2:
        raise ValueError(f"expected (batch, d) {what}, got shape {tuple(x.shape)}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"the coupling kernels take a contiguous float32 {what}")


def check_launch(err: int, d: int, hidden: int, backward: bool, lib) -> None:
    """Raise for a launcher's nonzero return ``err``: a ValueError naming
    the bytes when the stack's row tile does not fit a block's shared memory
    (the launcher's own count, ``nfmc_coupling{,_vjp}_tile_bytes``), else a
    RuntimeError with the CUDA error."""
    what = "backward kernel" if backward else "kernel"
    if err == TILE_TOO_LARGE:
        need = (lib.nfmc_coupling_vjp_tile_bytes if backward else lib.nfmc_coupling_tile_bytes)(
            d, hidden)
        raise ValueError(f"the coupling {what} needs {need} bytes of shared memory a block "
                         f"(8 rows of d={d}, H={hidden}), more than a block can hold")
    if err != 0:
        raise RuntimeError(f"coupling {what} launch failed: cudaError {err}")


def _check_params(params, x: torch.Tensor, packed: Optional[torch.Tensor]) -> torch.Tensor:
    if any(t.device != x.device for t in tree_leaves(params)):
        raise ValueError("flow parameters and input are on different devices")
    return pack_weights(params) if packed is None else packed


def _launch(wrapper, params, x: torch.Tensor, clamp: float, inverse: bool,
            packed: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_rows(x, "input")
    packed = _check_params(params, x, packed)
    n, d = x.shape
    hidden = int(params[0]["w"][1].shape[0])
    y = torch.empty_like(x)
    ld = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return y, ld
    lib = library("coupling")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.nfmc_coupling_stack(
            x.data_ptr(), packed.data_ptr(), y.data_ptr(), ld.data_ptr(),
            n, d, hidden, len(params), float(clamp), int(inverse), stream)
    check_launch(err, d, hidden, False, lib)
    count_launch(wrapper, ("stack", "inverse" if inverse else "forward", d, hidden, len(params), n))
    return y, ld


def _launch_vjp(params, x, gy, gld, clamp: float, inverse: bool,
                packed: Optional[torch.Tensor]):
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
    lib = library("coupling_bwd")
    scratch = torch.empty(lib.nfmc_coupling_vjp_scratch_floats(n, d, hidden, len(params)),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.nfmc_coupling_stack_vjp(
            x.data_ptr(), gy.data_ptr(), gld.data_ptr(), packed.data_ptr(), gx.data_ptr(),
            grads.data_ptr(), scratch.data_ptr(), n, d, hidden, len(params), float(clamp),
            int(inverse), stream)
    check_launch(err, d, hidden, True, lib)
    count_launch(fused_realnvp_vjp,
                 ("vjp", "inverse" if inverse else "forward", d, hidden, len(params), n))
    return gx, unpack_like(grads, params)


def _on_device(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one (the
    plain version); raises for any other device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type == "cuda"


def _stack(params, x, clamp, inverse, packed):
    if not _on_device(x):
        return realnvp_stack_plain(params, x, clamp, inverse)
    wrapper = fused_realnvp_inverse if inverse else fused_realnvp_forward
    return _launch(wrapper, params, x, clamp, inverse, packed)


class RealNVPStack(torch.autograd.Function):
    """The coupling stack with the backward kernel as its gradient, on both
    devices: the kernels on CUDA tensors, their plain versions on CPU ones.
    Saves x and the weights, not activations: the backward recomputes them.

    ``apply(x, packed, clamp, inverse, like, *leaves)`` with ``leaves`` the
    parameter tensors in packed order (``tree_leaves``) of the tree
    ``like``."""

    @staticmethod
    def forward(ctx, x, packed, clamp, inverse, like, *leaves):
        params = tree_unflatten(like, leaves)
        ctx.save_for_backward(x, *leaves)
        ctx.packed, ctx.clamp, ctx.inverse, ctx.like = packed, clamp, inverse, like
        return _stack(params, x, clamp, inverse, packed)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy, gld):
        x, *leaves = ctx.saved_tensors
        params = tree_unflatten(ctx.like, leaves)
        gx, grads = fused_realnvp_vjp(params, x, gy.contiguous(), gld.contiguous(),
                                      ctx.clamp, ctx.inverse, ctx.packed)
        return (gx if ctx.needs_input_grad[0] else None, None, None, None, None,
                *tree_leaves(grads))


def _apply(params, x, clamp, inverse, packed):
    leaves = tree_leaves(params)
    if torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in leaves)):
        return RealNVPStack.apply(x, packed, float(clamp), bool(inverse), params, *leaves)
    return _stack(params, x, clamp, inverse, packed)


def fused_realnvp_forward(params, x: torch.Tensor, clamp: float,
                          packed: Optional[torch.Tensor] = None):
    """Data -> latent through the whole stack: ``(B, d) -> (z, log_det)``,
    differentiable in ``x`` and the weights. ``packed`` is
    ``pack_weights(params)``, built once per parameter version by the caller
    (packed here when omitted)."""
    return _apply(params, x, clamp, False, packed)


def fused_realnvp_inverse(params, z: torch.Tensor, clamp: float,
                          packed: Optional[torch.Tensor] = None):
    """Latent -> data, layers in reverse: ``(B, d) -> (x, log_det)``."""
    return _apply(params, z, clamp, True, packed)


def fused_realnvp_vjp(params, x: torch.Tensor, gy: torch.Tensor, gld: torch.Tensor,
                      clamp: float, inverse: bool, packed: Optional[torch.Tensor] = None):
    """The VJP of the stack in either direction: ``(gx, grads)`` with
    ``grads`` shaped like ``params`` (on CUDA, views of one packed buffer)."""
    if not _on_device(x):
        return realnvp_stack_vjp_plain(params, x, gy, gld, clamp, inverse)
    return _launch_vjp(params, x, gy, gld, clamp, inverse, packed)


register(fused_realnvp_forward, fused_realnvp_inverse, fused_realnvp_vjp)
