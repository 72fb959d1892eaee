"""Neural autoregressive flow transforms (Huang et al. 2018): deep sigmoid
(DSF), dense sigmoid (DDSF) and deep-dense, in coupling / masked /
inverse-masked arrangements (``c-naf-*``, ``ma-naf-*``, ``ia-naf-*``), as
in ``nfmc_tpu/flows/naf.py``.

Each elementwise transform is a strictly monotone sigmoid mixture followed
by a logit. Its inverse has no closed form: a bracket expansion and a
fixed-count bisection, then one Newton step that carries the gradient
(implicit function theorem). The expansion and the bisection run under
``torch.no_grad`` (JAX's ``stop_gradient``), so autograd records only the
Newton step and the final forward. None of these flows has a kernel in
either package: plain PyTorch on every device.
"""
from __future__ import annotations

import torch

from .base import Inverse
from .coupling import Coupling
from .masked import MaskedAutoregressive

_EPS = 1e-6
_BRACKET = 60.0
_BISECT_ITERS = 50
# 16 doublings take the bracket to ~4e6: with slopes clamped at exp(-6) a
# preimage needs |x| ~ (logit(1 - eps) + |b|) / exp(-6)
_EXPAND_ITERS = 16


def _logit(p):
    p = p.clamp(_EPS, 1.0 - _EPS)
    return torch.log(p) - torch.log1p(-p)


class _MonotoneSigmoidTransform:
    """Forward: pre-activation mixture -> logit; inverse: bisection."""

    def _prepare(self, raw):
        """The mixture's parameters from the raw conditioner outputs."""
        raise NotImplementedError

    def _mixture(self, x, prm):
        """``(p, dp/dx)`` with p in (0, 1) strictly increasing in x."""
        raise NotImplementedError

    def _y(self, x, prm):
        """The forward's value alone, in few operations (the bisection's
        function: a few hundred evaluations a solve)."""
        raise NotImplementedError

    def _forward(self, x, prm):
        p, dp = self._mixture(x, prm)
        p = p.clamp(_EPS, 1.0 - _EPS)
        y = _logit(p)
        # dy/dx = dp/dx / (p (1 - p))
        ld = torch.log(dp.clamp_min(1e-30)) - torch.log(p) - torch.log1p(-p)
        return y, ld

    def forward(self, x, raw):
        return self._forward(x, self._prepare(raw))

    def _solve(self, y, raw):
        """The bracket expansion (small learned slopes put preimages far
        outside the seed bracket) and the bisection, with no graph:
        ``(lo, hi, x0)`` stacked, the expanded bracket and the point."""
        prm = self._prepare(raw)
        lh = torch.stack([torch.full_like(y, -_BRACKET), torch.full_like(y, _BRACKET)])
        for _ in range(_EXPAND_ITERS):
            f_lh = self._y(lh, prm)
            lh = torch.where(torch.stack([f_lh[0] >= y, f_lh[1] <= y]), lh * 2.0, lh)
        lo, hi = lh[0], lh[1]
        for _ in range(_BISECT_ITERS):
            mid = 0.5 * (lo + hi)
            below = self._y(mid, prm) < y
            lo = torch.where(below, mid, lo)
            hi = torch.where(below, hi, mid)
        return torch.stack([lh[0], lh[1], 0.5 * (lo + hi)])

    def inverse(self, y, raw):
        prm = self._prepare(raw)
        with torch.no_grad():
            b_lo, b_hi, x0 = self._solve(y.detach(), raw.detach())
        # one Newton step from the converged point: the value unchanged to
        # the solver's tolerance, the gradient exact to first order; the
        # step clamped (a saturated plateau would shoot it to ~1e30), the
        # result clamped to the expanded bracket
        y0, ld0 = self._forward(x0, prm)
        dydx = torch.exp(ld0)
        x = x0 - ((y0 - y) / dydx.clamp_min(1e-30)).clamp(-1.0, 1.0)
        x = torch.clamp(x, b_lo, b_hi)
        # the log-det at the DIFFERENTIABLE x: its gradient needs the
        # d(ld)/dx * dx/d(y, raw) term
        _, ld = self._forward(x, prm)
        return x, -ld


def _softmax(v):
    return torch.softmax(v, dim=-1)


class DeepSigmoidTransform(_MonotoneSigmoidTransform):
    """DSF: y = logit( sum_k w_k sigma(exp(a_k) x + b_k) )."""

    def __init__(self, n_components: int = 8):
        self.K = int(n_components)

    @property
    def n_params_per_dim(self):
        return 3 * self.K

    def _prepare(self, raw):
        K = self.K
        a = torch.exp(raw[..., :K].clamp(-6.0, 6.0))
        return a, raw[..., K:2 * K], _softmax(raw[..., 2 * K:])

    def _mixture(self, x, prm):
        a, b, w = prm
        s = torch.sigmoid(a * x[..., None] + b)
        return (w * s).sum(-1), (w * a * s * (1.0 - s)).sum(-1)

    def _y(self, x, prm):
        a, b, w = prm
        return torch.logit((w * torch.sigmoid(torch.addcmul(b, a, x[..., None]))).sum(-1), _EPS)


def _dense_layer(u, du, W, c):
    """One dense sigmoid layer with an interleaved logit (the NAF paper's
    DDSF): h = sigma(logit(W u) + c), W's rows softmax-normalised. The logit
    keeps the composed transform's range all of R in practice."""
    v = (W @ u[..., None])[..., 0]  # in (0, 1)
    h = torch.sigmoid(_logit(v) + c)
    dv = (W @ du[..., None])[..., 0]
    v_c = v.clamp(_EPS, 1.0 - _EPS)
    dt = dv / (v_c * (1.0 - v_c))
    return h, h * (1.0 - h) * dt


def _dense_value(u, W, c):
    """``_dense_layer``'s h alone."""
    return torch.sigmoid(torch.logit((W @ u[..., None])[..., 0], _EPS) + c)


class DenseSigmoidTransform(_MonotoneSigmoidTransform):
    """DDSF: y = logit(w . sigma(logit(W u) + c)), u = sigma(exp(a) x + b)."""

    def __init__(self, n_components: int = 4):
        self.K = int(n_components)

    @property
    def n_params_per_dim(self):
        K = self.K
        return K * K + 4 * K  # a, b, W, c, w

    def _take(self, raw, layout):
        """Consecutive slices of ``raw``'s last axis, ``"v"`` of K values and
        ``"W"`` of K * K, each W a (K, K) matrix with softmaxed rows."""
        K, i, out = self.K, 0, []
        for kind in layout:
            n = K * K if kind == "W" else K
            v = raw[..., i:i + n]
            out.append(_softmax(v.reshape(*raw.shape[:-1], K, K)) if kind == "W" else v)
            i += n
        return out

    def _prepare(self, raw):
        a, b, W, c, w = self._take(raw, "vvWvv")
        return torch.exp(a.clamp(-6.0, 6.0)), b, W, c, _softmax(w)

    def _mixture(self, x, prm):
        a, b, W, c, w = prm
        u = torch.sigmoid(a * x[..., None] + b)
        h, dh = _dense_layer(u, a * u * (1.0 - u), W, c)
        return (w * h).sum(-1), (w * dh).sum(-1)

    def _y(self, x, prm):
        a, b, W, c, w = prm
        h = _dense_value(torch.sigmoid(torch.addcmul(b, a, x[..., None])), W, c)
        return torch.logit((w * h).sum(-1), _EPS)


class DeepDenseSigmoidTransform(DenseSigmoidTransform):
    """Deep-dense: a second dense sigmoid layer on top of DDSF."""

    @property
    def n_params_per_dim(self):
        K = self.K
        return 2 * K * K + 5 * K  # a, b (2K) + W1, W2 (2K^2) + c1, c2 (2K) + w (K)

    def _prepare(self, raw):
        a, b, W1, c1, W2, c2, w = self._take(raw, "vvWvWvv")
        return torch.exp(a.clamp(-6.0, 6.0)), b, W1, c1, W2, c2, _softmax(w)

    def _mixture(self, x, prm):
        a, b, W1, c1, W2, c2, w = prm
        u = torch.sigmoid(a * x[..., None] + b)
        h1, dh1 = _dense_layer(u, a * u * (1.0 - u), W1, c1)
        h2, dh2 = _dense_layer(h1, dh1, W2, c2)
        return (w * h2).sum(-1), (w * dh2).sum(-1)

    def _y(self, x, prm):
        a, b, W1, c1, W2, c2, w = prm
        u = torch.sigmoid(torch.addcmul(b, a, x[..., None]))
        h = _dense_value(_dense_value(u, W1, c1), W2, c2)
        return torch.logit((w * h).sum(-1), _EPS)


class CouplingDeepSF(Coupling):
    def __init__(self, event_shape, n_layers: int = 2, n_components: int = 8, **kwargs):
        super().__init__(event_shape, DeepSigmoidTransform(n_components), n_layers=n_layers,
                         **kwargs)


class CouplingDenseSF(Coupling):
    def __init__(self, event_shape, n_layers: int = 2, n_components: int = 4, **kwargs):
        super().__init__(event_shape, DenseSigmoidTransform(n_components), n_layers=n_layers,
                         **kwargs)


class CouplingDeepDenseSF(Coupling):
    def __init__(self, event_shape, n_layers: int = 2, n_components: int = 4, **kwargs):
        super().__init__(event_shape, DeepDenseSigmoidTransform(n_components),
                         n_layers=n_layers, **kwargs)


class MaskedAutoregressiveDeepSF(MaskedAutoregressive):
    def __init__(self, event_shape, n_layers: int = 2, n_components: int = 8, **kwargs):
        super().__init__(event_shape, DeepSigmoidTransform(n_components), n_layers=n_layers,
                         **kwargs)


class MaskedAutoregressiveDenseSF(MaskedAutoregressive):
    def __init__(self, event_shape, n_layers: int = 2, n_components: int = 4, **kwargs):
        super().__init__(event_shape, DenseSigmoidTransform(n_components), n_layers=n_layers,
                         **kwargs)


class MaskedAutoregressiveDeepDenseSF(MaskedAutoregressive):
    def __init__(self, event_shape, n_layers: int = 2, n_components: int = 4, **kwargs):
        super().__init__(event_shape, DeepDenseSigmoidTransform(n_components),
                         n_layers=n_layers, **kwargs)


def InverseAutoregressiveDeepSF(event_shape, **kwargs):
    return Inverse(MaskedAutoregressiveDeepSF(event_shape, **kwargs))


def InverseAutoregressiveDenseSF(event_shape, **kwargs):
    return Inverse(MaskedAutoregressiveDenseSF(event_shape, **kwargs))


def InverseAutoregressiveDeepDenseSF(event_shape, **kwargs):
    return Inverse(MaskedAutoregressiveDeepDenseSF(event_shape, **kwargs))
