"""Residual flows: planar / radial / Sylvester (the matrix-determinant family)
and contractive residual blocks (i-ResNet, ResFlow, proximal ResFlow), as
in ``nfmc_tpu/flows/residual.py``.

``forward`` (data -> latent) is the analytic direction. The inverse is a
monotone scalar bisection with a Newton step (planar, radial), a small
batched Newton solve (Sylvester), or a contraction fixed point (the residual
blocks). Log-dets: the matrix determinant lemma for planar / radial /
Sylvester; for the residual blocks the exact ``slogdet`` of I + J with the
tanh MLP's analytic Jacobian J = W2 diag(1 - tanh^2) W1 when the event has
at most ``exact_logdet_dim`` dims, else the truncated series
``tr log(I + J) = sum_k (-1)^(k+1) tr(J^k) / k`` with Hutchinson probes.
No kernel in either package: plain PyTorch on every device.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .base import Bijection, hutchinson_probes


def _flatten(v, event_shape):
    """``(B, d)`` rows, B the product of all batch dims."""
    batch = v.shape[: v.dim() - len(event_shape)]
    return v.reshape(int(np.prod(batch)) if batch else 1, -1), batch


def _randn(generator, *shape):
    return torch.randn(shape, generator=generator, dtype=torch.float32, device=generator.device)


def _zeros(generator, *shape):
    return torch.zeros(shape, dtype=torch.float32, device=generator.device)


class _LayerStack(Bijection):
    """A stack of ``n_layers`` layers on flattened rows: forward applies
    ``_layer_forward`` in order, inverse ``_layer_inverse`` in reverse."""

    def __init__(self, event_shape: Sequence[int], n_layers: int):
        super().__init__(event_shape)
        self.n_layers = int(n_layers)

    @property
    def layers(self):
        return list(range(self.n_layers))

    def _run(self, params, v, inverse: bool):
        flat, batch = _flatten(v, self.event_shape)
        ld = torch.zeros(flat.shape[0], dtype=flat.dtype, device=flat.device)
        step = self._layer_inverse if inverse else self._layer_forward
        for p in (reversed(params) if inverse else params):
            flat, l = step(p, flat)
            ld = ld + l
        return flat.reshape(v.shape), ld.reshape(batch)

    def forward_fn(self, params, x):
        return self._run(params, x, inverse=False)

    def inverse_fn(self, params, z):
        return self._run(params, z, inverse=True)


def _bisect(g, target, lo, hi, n_iter: int = 40):
    """Bisection for ``g(t) = target``, g increasing; no graph is recorded
    (JAX's ``stop_gradient`` on the result)."""
    with torch.no_grad():
        lo, hi = lo.detach(), hi.detach()
        for _ in range(n_iter):
            mid = 0.5 * (lo + hi)
            below = g(mid) < target
            lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
        return 0.5 * (lo + hi)


# ---------------------------------------------------------------------------
# Planar
# ---------------------------------------------------------------------------

class PlanarFlow(_LayerStack):
    """Planar maps z = x + u_hat tanh(w.x + b) (Rezende & Mohamed 2015), with
    the invertibility constraint w.u_hat > -1."""

    def __init__(self, event_shape: Sequence[int], n_layers: int = 8, **_):
        super().__init__(event_shape, n_layers)

    def init(self, generator):
        d = self.event_size
        return [{"u": 0.01 * _randn(generator, d), "w": _randn(generator, d) / math.sqrt(d),
                 "b": _zeros(generator)} for _ in range(self.n_layers)]

    @staticmethod
    def _u_hat(p):
        w, u = p["w"], p["u"]
        wu = torch.dot(w, u)
        m = -1.0 + F.softplus(wu)
        return u + (m - wu) * w / torch.dot(w, w).clamp_min(1e-12)

    def _layer_forward(self, p, x):
        u_hat = self._u_hat(p)
        h = torch.tanh(x @ p["w"] + p["b"])
        z = x + u_hat[None] * h[:, None]
        wu = torch.dot(p["w"], u_hat)
        return z, torch.log(torch.abs(1.0 + wu * (1.0 - h ** 2)))

    def _layer_inverse(self, p, z):
        u_hat = self._u_hat(p)
        wu = torch.dot(p["w"], u_hat)
        a_z = z @ p["w"] + p["b"]  # = a + wu tanh(a), monotone in a

        def f(a):
            return a + wu * torch.tanh(a)

        span = torch.abs(wu) + 1e-3
        a0 = _bisect(f, a_z, a_z - span, a_z + span)
        # Newton polish (exact first-order implicit gradients)
        a = a0 - (f(a0) - a_z) / (1.0 + wu * (1.0 - torch.tanh(a0) ** 2))
        h = torch.tanh(a)
        x = z - u_hat[None] * h[:, None]
        return x, -torch.log(torch.abs(1.0 + wu * (1.0 - h ** 2)))


# ---------------------------------------------------------------------------
# Radial
# ---------------------------------------------------------------------------

class RadialFlow(_LayerStack):
    """Radial maps z = x + beta_hat (x - x0) / (alpha + r)."""

    def __init__(self, event_shape: Sequence[int], n_layers: int = 8, **_):
        super().__init__(event_shape, n_layers)

    def init(self, generator):
        d = self.event_size
        return [{"x0": 0.1 * _randn(generator, d), "log_alpha": _zeros(generator),
                 "beta_raw": torch.full((), -2.0, device=generator.device)}
                for _ in range(self.n_layers)]

    @staticmethod
    def _ab(p):
        alpha = torch.exp(p["log_alpha"])
        return alpha, -alpha + F.softplus(p["beta_raw"])  # beta > -alpha

    @staticmethod
    def _log_det(d, alpha, beta, r):
        h = 1.0 / (alpha + r)
        return ((d - 1) * torch.log(torch.abs(1.0 + beta * h))
                + torch.log(torch.abs(1.0 + beta * h - beta * r / (alpha + r) ** 2)))

    def _layer_forward(self, p, x):
        alpha, beta = self._ab(p)
        diff = x - p["x0"][None]
        r = torch.linalg.vector_norm(diff, dim=-1)
        z = x + beta * (1.0 / (alpha + r))[:, None] * diff
        return z, self._log_det(x.shape[-1], alpha, beta, r)

    def _layer_inverse(self, p, z):
        alpha, beta = self._ab(p)
        diff = z - p["x0"][None]
        rz = torch.linalg.vector_norm(diff, dim=-1)

        def g(r):  # rz = r (1 + beta / (alpha + r)), monotone for r >= 0
            return r * (1.0 + beta / (alpha + r))

        r0 = _bisect(g, rz, torch.zeros_like(rz), rz + torch.abs(beta) + 1.0)
        r = r0 - (g(r0) - rz) / (1.0 + beta * alpha / (alpha + r0) ** 2)
        x = p["x0"][None] + diff * (r / rz.clamp_min(1e-12))[:, None]
        return x, -self._log_det(z.shape[-1], alpha, beta, r)


# ---------------------------------------------------------------------------
# Sylvester
# ---------------------------------------------------------------------------

class SylvesterFlow(_LayerStack):
    """Sylvester flows (van den Berg et al. 2018): z = x + Q R tanh(Rt Q^T x +
    b), Q column-orthonormal (d x m, the QR of ``q_raw``), R and Rt upper
    triangular with diagonal products in (-0.99, 0.99)."""

    def __init__(self, event_shape: Sequence[int], n_layers: int = 4, m: int = None, **_):
        super().__init__(event_shape, n_layers)
        self.m = int(m) if m is not None else min(self.event_size, 8)

    def init(self, generator):
        d, m = self.event_size, self.m
        return [{"q_raw": _randn(generator, d, m) / math.sqrt(d),
                 "r_up": 0.01 * _randn(generator, m, m), "rt_up": 0.01 * _randn(generator, m, m),
                 "r_diag_raw": _zeros(generator, m), "rt_diag_raw": _zeros(generator, m),
                 "b": _zeros(generator, m)} for _ in range(self.n_layers)]

    def _mats(self, p):
        q, _ = torch.linalg.qr(p["q_raw"])  # (d, m), orthonormal columns
        c = math.sqrt(0.99)
        r_diag = c * torch.tanh(p["r_diag_raw"])
        rt_diag = c * torch.tanh(p["rt_diag_raw"])
        r = torch.triu(p["r_up"], diagonal=1) + torch.diag(r_diag)
        rt = torch.triu(p["rt_up"], diagonal=1) + torch.diag(rt_diag)
        return q, r, rt, r_diag * rt_diag

    def _layer_forward(self, p, x):
        q, r, rt, diag = self._mats(p)
        h = torch.tanh(x @ q @ rt.T + p["b"][None])  # (B, m)
        z = x + h @ r.T @ q.T
        return z, torch.log(torch.abs(1.0 + diag * (1.0 - h ** 2))).sum(-1)

    def _layer_inverse(self, p, z):
        q, r, rt, diag = self._mats(p)
        v_z = z @ q @ rt.T + p["b"][None]  # (B, m)
        A = rt @ r  # v + (Rt R) tanh(v) = v_z
        eye = torch.eye(self.m, dtype=z.dtype, device=z.device)[None]
        v = v_z
        for _ in range(25):
            h = torch.tanh(v)
            g = v + h @ A.T - v_z
            J = eye + A[None] * (1.0 - h ** 2)[:, None, :]
            v = v - torch.linalg.solve(J, g[..., None])[..., 0]
        h = torch.tanh(v)
        x = z - h @ r.T @ q.T
        return x, -torch.log(torch.abs(1.0 + diag * (1.0 - h ** 2))).sum(-1)


# ---------------------------------------------------------------------------
# Contractive residual blocks (i-ResNet / ResFlow / proximal)
# ---------------------------------------------------------------------------

def _safe_norm(v):
    """L2 norm with a finite gradient at v = 0 (the residual blocks start
    with zero output weights, where a plain norm's gradient is NaN)."""
    return torch.sqrt((v * v).sum() + 1e-24)


def _spectral_normalize(w, lipschitz: float, n_iter: int = 5):
    """``w`` scaled so that its spectral norm is at most ``lipschitz``: a
    power iteration from the fixed vector ones / sqrt(n)."""
    u = torch.full((w.shape[1],), 1.0 / np.sqrt(w.shape[1]), dtype=w.dtype, device=w.device)
    for _ in range(n_iter):
        v = w @ u
        v = v / _safe_norm(v)
        u = w.T @ v
        u = u / _safe_norm(u)
    sigma = _safe_norm(w @ u)
    return w * (lipschitz / torch.clamp(sigma, min=lipschitz))


class _ContractiveResidual(_LayerStack):
    """y = x + g(x) with Lip(g) < 1: g a spectral-normalised tanh MLP."""

    lipschitz = 0.9
    series_terms = 8
    n_probes = 4

    def __init__(self, event_shape: Sequence[int], n_layers: int = 4,
                 hidden_size: int = 64, exact_logdet_dim: int = 128, **_):
        super().__init__(event_shape, n_layers)
        self.hidden = int(hidden_size)
        self.exact_logdet_dim = int(exact_logdet_dim)

    def init(self, generator):
        d, h = self.event_size, self.hidden
        return [{"w1": _randn(generator, h, d) / math.sqrt(d), "b1": _zeros(generator, h),
                 "w2": _zeros(generator, d, h), "b2": _zeros(generator, d)}
                for _ in range(self.n_layers)]

    def _weights(self, p):
        c = float(np.sqrt(self.lipschitz))
        return _spectral_normalize(p["w1"], c), _spectral_normalize(p["w2"], c)

    def _g(self, p, x, w=None):
        w1, w2 = self._weights(p) if w is None else w
        return torch.tanh(x @ w1.T + p["b1"]) @ w2.T + p["b2"]

    def _logdet(self, p, x, w=None):
        """log |det(I + dg/dx)| a row."""
        w1, w2 = self._weights(p) if w is None else w
        s = 1.0 - torch.tanh(x @ w1.T + p["b1"]) ** 2  # (B, h)
        d = x.shape[-1]
        if d <= self.exact_logdet_dim:
            J = torch.einsum("dh,bh,he->bde", w2, s, w1)
            return torch.linalg.slogdet(torch.eye(d, dtype=x.dtype, device=x.device)[None] + J)[1]
        probes = hutchinson_probes(x, self.n_probes, self.probe_key)  # (B, P, d)
        ld = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        v = probes
        for k in range(1, self.series_terms + 1):
            v = ((v @ w1.T) * s[:, None, :]) @ w2.T  # J^k e
            ld = ld + ((-1.0) ** (k + 1)) * (probes * v).sum(-1).mean(-1) / k
        return ld

    def _layer_forward(self, p, x):
        w = self._weights(p)
        return x + self._g(p, x, w), self._logdet(p, x, w)

    def _layer_inverse(self, p, z):
        w = self._weights(p)
        u = z
        for _ in range(40):
            u = z - self._g(p, u, w)
        return u, -self._logdet(p, u, w)


class InvertibleResNet(_ContractiveResidual):
    """i-ResNet (Behrmann et al. 2019)."""

    lipschitz = 0.9
    series_terms = 8


class ResFlow(_ContractiveResidual):
    """Residual flow (Chen et al. 2019); a longer series for lower bias."""

    lipschitz = 0.9
    series_terms = 16


class ProximalResFlow(_ContractiveResidual):
    """Proximal residual flow (Hertrich 2022), simplified as in the JAX
    package: the same block family with Lipschitz constant 0.5."""

    lipschitz = 0.5
    series_terms = 8
