"""Coupling flows: RealNVP, NICE and the coupling spline flows (RQS and LRS);
the coupling NAF flows (``flows/naf.py``) build on ``Coupling`` too.

Layer l conditions on the flattened-event indices with ``(i + l) % 2 == 0``
and transforms the rest; its conditioner's output columns are dim-major
(``nfmc_tpu/flows/coupling.py:55-80``): ``(shift_j, raw_logscale_j)`` for
RealNVP, the spline's P raw parameters of dim j for the spline flows.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core import graphs
from ..ops import coupling as coupling_ops
from ..ops import spline as spline_ops
from .base import Bijection
from .conditioners import mlp_apply, mlp_init
from .transforms import AffineTransform, LRSplineTransform, RQSplineTransform, ShiftTransform


class Coupling(Bijection):
    """Stack of coupling layers with a shared elementwise transform type.

    The class and the conditioner's depth decide, once at construction, how
    the stack runs, as in the JAX package (``len(self.hidden) != 2`` sends
    a flow to its XLA path, ``nfmc_tpu/flows/coupling.py:148`` and
    ``:213``). A class with kernels (``has_kernels``: RealNVP and the
    coupling splines) whose conditioners have exactly 2 hidden layers runs
    through the kernel wrappers of :mod:`nfmc_torch.ops`, which launch the
    CUDA kernels on a CUDA tensor (or raise) and run their plain versions
    on a CPU one. Every other coupling flow (NICE, the NAF couplings, other
    depths) runs the plain PyTorch stack of ``nfmc_tpu/flows/coupling.py::
    Coupling._layer`` on whatever device the tensors are on, as the JAX
    package runs them through XLA. That is a choice by configuration, not a
    fallback: a depth-2 RealNVP or spline flow on CUDA never runs the plain
    version.
    """

    has_kernels = False

    def __init__(
        self,
        event_shape: Sequence[int],
        transform,
        n_layers: int = 2,
        hidden_size: Optional[int] = None,
        n_hidden_layers: int = 2,
        conditioner_kwargs: Optional[dict] = None,
        **_ignored,
    ):
        super().__init__(event_shape)
        d = self.event_size
        if d < 2:
            raise ValueError("Coupling flows need event_size >= 2")
        self.transform = transform
        self.n_layers = int(n_layers)
        if conditioner_kwargs:
            n_hidden_layers = conditioner_kwargs.get("n_layers", n_hidden_layers)
            hidden_size = conditioner_kwargs.get("n_hidden", hidden_size)
        if hidden_size is None:
            hidden_size = int(min(max(32, 2 ** int(np.ceil(np.log2(max(4 * d, 32))))), 128))
        self.hidden = [int(hidden_size)] * int(n_hidden_layers)
        # the kernels take 2 hidden layers
        self.fused = self.has_kernels and len(self.hidden) == 2
        # (conditioning ids, transformed ids) per layer
        ids = np.arange(d)
        self.layer_idx = [(ids[(ids + l) % 2 == 0], ids[(ids + l) % 2 == 1])
                          for l in range(self.n_layers)]
        self._packed_src = ()
        self._packed = None
        self._index_cache = {}

    @property
    def layers(self):
        """Per-layer descriptors, ``(conditioning ids, transformed ids)``
        (torchflows ``bijection.layers`` parity)."""
        return self.layer_idx

    def init(self, generator: torch.Generator):
        return [
            mlp_init(generator, len(a), self.hidden, len(b) * self.transform.n_params_per_dim)
            for a, b in self.layer_idx
        ]

    def _packed_weights(self, params, device):
        """The kernels' weight buffer, rebuilt only when a parameter tensor
        changes (another tensor, or an in-place update). The key holds the
        tensors themselves, so a freed tensor's address cannot alias it."""
        if device.type != "cuda" or not self.fused:
            return None
        if torch.cuda.is_current_stream_capturing() or graphs.in_body():
            # a graph packs inside itself, from the weights' addresses, on
            # every replay: a cached buffer would hold the capture's values,
            # and a key the graph's static buffers, which replays change
            # with no version bump
            return None
        src = tuple((t, t._version) for p in params for v in p.values() for t in v)
        if (len(src) != len(self._packed_src)
                or any(a is not b or va != vb for (a, va), (b, vb) in zip(src, self._packed_src))):
            self._packed = coupling_ops.pack_weights(params)
            self._packed_src = src
        return self._packed

    def _stack(self, params, flat, inverse: bool, packed):
        """The whole stack on ``(B, event_size)`` rows through the kernel
        wrappers: ``(y, log_det)``."""
        raise NotImplementedError

    def _indices(self, device):
        """Each layer's (conditioning, transformed) index tensors on
        ``device``, made once per device."""
        if device not in self._index_cache:
            self._index_cache[device] = [
                (torch.as_tensor(a, device=device), torch.as_tensor(b, device=device))
                for a, b in self.layer_idx]
        return self._index_cache[device]

    def _layer(self, p, idx, v, inverse: bool):
        a, b = idx
        vb = v[:, b]
        raw = mlp_apply(p, v[:, a]).reshape(*vb.shape, self.transform.n_params_per_dim)
        step = self.transform.inverse if inverse else self.transform.forward
        vb_new, ld_elem = step(vb, raw)
        return v.index_copy(1, b, vb_new), ld_elem.sum(-1)

    def _plain_stack(self, params, flat, inverse: bool):
        """The whole stack in plain PyTorch on ``(B, event_size)`` rows, the
        math of ``nfmc_tpu/flows/coupling.py:73-113``."""
        log_det = torch.zeros(flat.shape[0], dtype=flat.dtype, device=flat.device)
        layers = list(zip(params, self._indices(flat.device)))
        for p, idx in (reversed(layers) if inverse else layers):
            flat, ld = self._layer(p, idx, flat, inverse)
            log_det = log_det + ld
        return flat, log_det

    def _run(self, params, v, inverse: bool):
        batch_shape = v.shape[: v.dim() - len(self.event_shape)]
        flat = v.reshape(-1, self.event_size)
        if not self.fused:
            y, ld = self._plain_stack(params, flat, inverse)
        else:
            if flat.device.type == "cuda":
                # the kernels take contiguous float32 rows: a strided view
                # (a column slice) or another float type is copied here
                flat = flat.to(torch.float32).contiguous()
            y, ld = self._stack(params, flat, inverse, self._packed_weights(params, flat.device))
        return y.reshape(v.shape), ld.reshape(batch_shape)

    def forward_fn(self, params, x):
        return self._run(params, x, inverse=False)

    def inverse_fn(self, params, z):
        return self._run(params, z, inverse=True)


class RealNVP(Coupling):
    """Affine coupling flow (Dinh et al. 2017).

    With 2 hidden layers a conditioner (the default), both directions run
    the whole stack through :mod:`nfmc_torch.ops.coupling`: the CUDA kernels
    on a CUDA tensor, their plain PyTorch versions on a CPU tensor. Both are
    differentiable in the input and the weights, with the backward kernel as
    the gradient. Other depths run the plain stack (``Coupling``).
    """

    has_kernels = True
    # both directions run no host read: a sampler's captured step may call it
    graph_capturable = True

    def __init__(self, event_shape, n_layers: int = 2, clamp: float = 3.0, **kwargs):
        super().__init__(event_shape, AffineTransform(clamp=clamp), n_layers=n_layers, **kwargs)
        self.clamp = float(clamp)

    def _stack(self, params, flat, inverse, packed):
        fn = coupling_ops.fused_realnvp_inverse if inverse else coupling_ops.fused_realnvp_forward
        return fn(params, flat, self.clamp, packed=packed)

    def _plain_stack(self, params, flat, inverse):
        return coupling_ops.realnvp_stack_plain(params, flat, self.clamp, inverse)


class NICE(Coupling):
    """Additive coupling flow (Dinh et al. 2015), volume preserving. It has
    no kernel in either package: the plain stack on every device."""

    def __init__(self, event_shape, n_layers: int = 2, **kwargs):
        super().__init__(event_shape, ShiftTransform(), n_layers=n_layers, **kwargs)


class _CouplingSpline(Coupling):
    """Coupling flow whose layers apply an elementwise monotone spline with
    ``n_bins`` bins on ``[-tail_bound, tail_bound]`` and identity tails.

    With 2 hidden layers a conditioner, both directions run the whole stack
    through :mod:`nfmc_torch.ops.spline`: the CUDA kernels on a CUDA tensor,
    their plain PyTorch versions on a CPU tensor, differentiable in the
    input and the weights with the backward kernel as the gradient. Other
    depths run the plain stack (``Coupling``). The JAX package's
    ``use_pallas`` is accepted (for the flow-string DSL) and ignored, as by
    ``Coupling``: on CUDA a depth-2 flow always runs the kernels."""

    _transform = None
    has_kernels = True

    def __init__(self, event_shape, n_layers: int = 2, n_bins: int = 8,
                 tail_bound: float = 5.0, **kwargs):
        super().__init__(event_shape, self._transform(n_bins=n_bins, tail_bound=tail_bound),
                         n_layers=n_layers, **kwargs)
        self.n_bins = int(n_bins)
        self.tail_bound = float(tail_bound)

    def _stack(self, params, flat, inverse, packed):
        fn = {("rqs", False): spline_ops.fused_rqs_forward,
              ("rqs", True): spline_ops.fused_rqs_inverse,
              ("lrs", False): spline_ops.fused_lrs_forward,
              ("lrs", True): spline_ops.fused_lrs_inverse}[self.transform.kind, inverse]
        return fn(params, flat, self.n_bins, self.tail_bound, packed=packed)

    def _plain_stack(self, params, flat, inverse):
        return spline_ops.spline_stack_plain(params, flat, self.transform.kind, self.n_bins,
                                             self.tail_bound, inverse)


class CouplingRQNSF(_CouplingSpline):
    """Coupling rational-quadratic neural spline flow (``c-rqnsf``, Durkan
    et al. 2019)."""

    _transform = RQSplineTransform
    graph_capturable = True


class CouplingLRS(_CouplingSpline):
    """Coupling linear-rational spline flow (``c-lrsnsf``, Dolatabadi et
    al. 2020)."""

    _transform = LRSplineTransform
    graph_capturable = True
