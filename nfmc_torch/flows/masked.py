"""Masked autoregressive flows: MAF / IAF and their spline variants
(``ma-`` / ``ia-rqnsf``, ``ma-`` / ``ia-lrsnsf``), as in
``nfmc_tpu/flows/masked.py``.

MAF's density direction (data -> latent) is one parallel MADE pass a layer;
its sampling direction inverts dim by dim, d masked passes a layer (the
autoregressive cost; JAX's ``lax.fori_loop`` is an eager loop here). IAF is
the ``Inverse`` of the same stack, so sampling is its parallel direction.
Neither package has a kernel for these flows: they run as plain PyTorch on
every device, the spline variants through the plain spline math of
:mod:`nfmc_torch.flows.spline` (not the coupling spline kernels).
"""
from __future__ import annotations

from typing import Sequence

import torch

from .base import Bijection, Inverse
from .conditioners import made_apply, made_init, made_masks, masked_weights, mlp_apply
from .transforms import AffineTransform, LRSplineTransform, RQSplineTransform


class MaskedAutoregressive(Bijection):
    """Stack of MADE-conditioned autoregressive layers, the dim order
    reversed between layers.

    forward (parallel): z_i = T(x_i ; theta_i(x_<i)).
    inverse (sequential): d masked passes, then a pass for the log-det.
    """

    def __init__(
        self,
        event_shape: Sequence[int],
        transform,
        n_layers: int = 2,
        hidden_size: int = 128,
        n_hidden_layers: int = 2,
        conditioner_kwargs=None,
        **_,
    ):
        super().__init__(event_shape)
        self.transform = transform
        self.n_layers = int(n_layers)
        if conditioner_kwargs:
            n_hidden_layers = conditioner_kwargs.get("n_layers", n_hidden_layers)
            hidden_size = conditioner_kwargs.get("n_hidden", hidden_size)
        self.hidden = [int(hidden_size)] * int(n_hidden_layers)
        # built once on the host; copied to a device once (_masks)
        self.masks = made_masks(self.event_size, self.hidden, transform.n_params_per_dim)
        self._mask_cache = {}

    def _masks(self, device):
        if device not in self._mask_cache:
            self._mask_cache[device] = [torch.as_tensor(m, device=device) for m in self.masks]
        return self._mask_cache[device]

    @property
    def layers(self):
        return list(range(self.n_layers))

    def init(self, generator):
        return [made_init(generator, self.event_size, self.hidden, self.transform.n_params_per_dim)
                for _ in range(self.n_layers)]

    def _layer_forward(self, p, v):
        raw = made_apply(p, self._masks(v.device), v)
        z, ld_elem = self.transform.forward(v, raw.reshape(*v.shape, -1))
        return z, ld_elem.sum(-1)

    def _layer_inverse(self, p, z):
        """Dim i is exact after pass i: its parameters see only the dims
        before it. A pass evaluates the conditioner's last layer and the
        transform on dim i alone (the values JAX keeps from its full pass)."""
        pm = masked_weights(p, self._masks(z.device))
        n_par = self.transform.n_params_per_dim
        x = torch.zeros_like(z)
        cols = torch.arange(self.event_size, device=z.device)
        for i in range(self.event_size):
            h = x
            for w, b in zip(pm["w"][:-1], pm["b"][:-1]):
                h = torch.tanh(torch.addmm(b, h, w))
            sl = slice(i * n_par, (i + 1) * n_par)
            raw_i = torch.addmm(pm["b"][-1][sl], h, pm["w"][-1][:, sl])
            x_i, _ = self.transform.inverse(z[:, i], raw_i)
            x = x.index_copy(1, cols[i:i + 1], x_i[:, None])
        _, ld_elem = self.transform.inverse(z, mlp_apply(pm, x).reshape(*z.shape, n_par))
        return x, ld_elem.sum(-1)

    def _run(self, params, v, inverse: bool):
        batch = v.shape[: v.dim() - len(self.event_shape)]
        flat = v.reshape(-1, self.event_size)
        log_det = torch.zeros(flat.shape[0], dtype=flat.dtype, device=flat.device)
        step = self._layer_inverse if inverse else self._layer_forward
        for l, p in enumerate(reversed(params) if inverse else params):
            flat, ld = step(p, flat)
            log_det = log_det + ld
            if l != self.n_layers - 1:
                flat = flat.flip(-1)
        return flat.reshape(v.shape), log_det.reshape(batch)

    def forward_fn(self, params, x):
        return self._run(params, x, inverse=False)

    def inverse_fn(self, params, z):
        return self._run(params, z, inverse=True)


class MAF(MaskedAutoregressive):
    """Masked affine autoregressive flow (Papamakarios et al. 2017)."""

    def __init__(self, event_shape, n_layers: int = 2, clamp: float = 3.0, **kwargs):
        super().__init__(event_shape, AffineTransform(clamp=clamp), n_layers=n_layers, **kwargs)


class MaskedAutoregressiveRQNSF(MaskedAutoregressive):
    """Masked autoregressive rational-quadratic spline flow (``ma-rqnsf``)."""

    def __init__(self, event_shape, n_layers: int = 2, n_bins: int = 8,
                 tail_bound: float = 5.0, **kwargs):
        super().__init__(event_shape, RQSplineTransform(n_bins=n_bins, tail_bound=tail_bound),
                         n_layers=n_layers, **kwargs)


class MaskedAutoregressiveLRS(MaskedAutoregressive):
    """Masked autoregressive linear-rational spline flow (``ma-lrsnsf``)."""

    def __init__(self, event_shape, n_layers: int = 2, n_bins: int = 8,
                 tail_bound: float = 5.0, **kwargs):
        super().__init__(event_shape, LRSplineTransform(n_bins=n_bins, tail_bound=tail_bound),
                         n_layers=n_layers, **kwargs)


def IAF(event_shape, **kwargs) -> Inverse:
    """Inverse autoregressive flow: parallel sampling, sequential density."""
    return Inverse(MAF(event_shape, **kwargs))


def InverseAutoregressiveRQNSF(event_shape, **kwargs) -> Inverse:
    return Inverse(MaskedAutoregressiveRQNSF(event_shape, **kwargs))


def InverseAutoregressiveLRS(event_shape, **kwargs) -> Inverse:
    return Inverse(MaskedAutoregressiveLRS(event_shape, **kwargs))
