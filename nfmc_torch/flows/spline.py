"""Monotone spline transforms: rational-quadratic (RQS) and linear-rational
(LRS), counterpart of ``nfmc_tpu/flows/spline.py``.

RQS: Durkan, Bekasov, Murray, Papamakarios, "Neural Spline Flows" (2019).
LRS: Dolatabadi, Erfani, Leckie, "Invertible Generative Modeling using
Linear Rational Splines" (2020).

Both act elementwise inside ``[-tail_bound, tail_bound]`` with identity
tails outside, take ``P`` raw conditioner outputs per element (``3K - 1``
for RQS, ``4K - 1`` for LRS, K bins) and return per-element log-dets. Every
branch is a ``torch.where`` on clipped values, so forward and inverse share
one code path and autograd sees no NaN from the branch not taken. The bin
lookup is the gather form (``_searchsorted`` + ``_gather_bin``); the JAX
package's select-accumulate lookup exists only for the TPU.

This module is the oracle of the spline kernels (``csrc/spline.cu`` and
``csrc/spline_bwd.cu``): they compute the same terms in the same order.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

_MIN_BIN = 1e-3
_MIN_DERIV = 1e-3
# Shift so that a zero-init conditioner gives interior derivatives of
# exactly 1 (_MIN_DERIV + softplus(_DERIV_SHIFT) == 1): the flow starts as
# the identity.
_DERIV_SHIFT = math.log(math.expm1(1.0 - _MIN_DERIV))


def n_params_per_dim(kind: str, n_bins: int) -> int:
    """Raw conditioner outputs per transformed element."""
    if kind not in ("rqs", "lrs"):
        raise ValueError(f"unknown spline kind {kind!r} (expected 'rqs' or 'lrs')")
    return (3 if kind == "rqs" else 4) * int(n_bins) - 1


def _make_knots(raw_w, raw_h, n_bins: int, tail_bound: float):
    """Knot positions ``(..., K + 1)``: softmax with a ``_MIN_BIN`` floor,
    running sum, scaled to ``[-T, T]``, the last knot pinned to ``T``."""
    def knots(raw):
        sizes = _MIN_BIN + (1.0 - _MIN_BIN * n_bins) * torch.softmax(raw, dim=-1)
        cum = torch.cumsum(sizes, dim=-1)
        cum = torch.cat([torch.zeros_like(cum[..., :1]), cum], dim=-1)
        cum = cum * (2.0 * tail_bound) - tail_bound
        return torch.cat([cum[..., :-1], torch.full_like(cum[..., -1:], tail_bound)], dim=-1)

    return knots(raw_w), knots(raw_h)


def _derivs(raw_d):
    """Knot derivatives ``(..., K + 1)``: the boundary ones are 1."""
    d = _MIN_DERIV + F.softplus(raw_d + _DERIV_SHIFT)
    ones = torch.ones_like(d[..., :1])
    return torch.cat([ones, d, ones], dim=-1)


def _searchsorted(cum, x):
    """Index k with ``cum[k] <= x < cum[k + 1]`` (cum has K + 1 knots): the
    count of knots 1..K at or below x, clipped to K - 1."""
    n_bins = cum.shape[-1] - 1
    idx = (x[..., None] >= cum[..., 1:]).sum(-1)
    return idx.clamp(0, n_bins - 1)


def _gather_bin(vals, idx):
    """``vals[..., idx]`` elementwise."""
    return torch.gather(vals, -1, idx[..., None])[..., 0]


def _guard(den):
    return torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12), den)


def rational_quadratic_spline(inputs: torch.Tensor, raw: torch.Tensor, inverse: bool,
                              n_bins: int = 8, tail_bound: float = 5.0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RQS transform. ``inputs (...,)``, ``raw (..., 3 n_bins - 1)``;
    returns ``(outputs, log_det_elementwise)``."""
    K, T = n_bins, tail_bound
    cumw, cumh = _make_knots(raw[..., :K], raw[..., K:2 * K], K, T)
    derivs = _derivs(raw[..., 2 * K:])

    inside = inputs.abs() <= T
    x = inputs.clamp(-T, T)
    k = _searchsorted(cumh if inverse else cumw, x)
    x_k = _gather_bin(cumw, k)
    w_k = _gather_bin(cumw, k + 1) - x_k
    y_k = _gather_bin(cumh, k)
    h_k = _gather_bin(cumh, k + 1) - y_k
    d_k = _gather_bin(derivs, k)
    d_k1 = _gather_bin(derivs, k + 1)
    s_k = h_k / w_k
    corr = d_k1 + d_k - 2.0 * s_k

    if not inverse:
        xi = (x - x_k) / w_k
        xi1m = xi * (1.0 - xi)
        denom = s_k + corr * xi1m
        out = y_k + h_k * (s_k * xi * xi + d_k * xi1m) / denom
        sign = 1.0
    else:
        term = x - y_k
        a = h_k * (s_k - d_k) + term * corr
        b = h_k * d_k - term * corr
        c = -s_k * term
        disc = (b * b - 4.0 * a * c).clamp_min(0.0)
        xi = ((2.0 * c) / (-b - torch.sqrt(disc))).clamp(0.0, 1.0)
        xi1m = xi * (1.0 - xi)
        denom = s_k + corr * xi1m
        out = x_k + w_k * xi
        sign = -1.0
    dydx = (s_k * s_k * (d_k1 * xi * xi + 2.0 * s_k * xi1m + d_k * (1.0 - xi) ** 2)
            ) / (denom * denom)
    return (torch.where(inside, out, inputs),
            torch.where(inside, sign * torch.log(dydx), torch.zeros_like(inputs)))


def linear_rational_spline(inputs: torch.Tensor, raw: torch.Tensor, inverse: bool,
                           n_bins: int = 8, tail_bound: float = 5.0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LRS transform. ``inputs (...,)``, ``raw (..., 4 n_bins - 1)``. Each
    bin is two monotone linear-rational segments that meet at an interior
    point ``lambda`` (Dolatabadi et al. 2020, eqs. 7-10)."""
    K, T = n_bins, tail_bound
    cumw, cumh = _make_knots(raw[..., :K], raw[..., K:2 * K], K, T)
    derivs = _derivs(raw[..., 2 * K:3 * K - 1])
    lam_all = 0.025 + 0.95 * torch.sigmoid(raw[..., 3 * K - 1:])

    inside = inputs.abs() <= T
    x = inputs.clamp(-T, T)
    k = _searchsorted(cumh if inverse else cumw, x)
    x0 = _gather_bin(cumw, k)
    w = _gather_bin(cumw, k + 1) - x0
    y0 = _gather_bin(cumh, k)
    h = _gather_bin(cumh, k + 1) - y0
    d0 = _gather_bin(derivs, k)
    d1 = _gather_bin(derivs, k + 1)
    lam = _gather_bin(lam_all, k)
    s = h / w

    # wa = 1 in the paper's notation; multiplying by it is exact, so it is
    # left out
    wb = torch.sqrt(d0 / d1)
    wc = (lam * d0 + (1.0 - lam) * wb * d1) / s
    ya = y0
    yb = y0 + h
    yc = ((1.0 - lam) * ya + lam * wb * yb) / ((1.0 - lam) + lam * wb)

    if not inverse:
        phi = (x - x0) / w
        seg1 = phi <= lam
    else:
        seg1 = x <= yc
        phi1 = lam * (x - ya) / _guard((x - ya) - wc * (x - yc))
        phi2 = (wc * (x - yc) + lam * wb * (yb - x)) / _guard(wc * (x - yc) + wb * (yb - x))
        phi = torch.where(seg1, phi1, phi2).clamp(0.0, 1.0)
    # each segment's terms at a phi of its own segment: the other segment's
    # denominator can be exactly 0 there (d_1 beyond lam, d_2 before it),
    # and its branch, discarded by the where, would still give autograd
    # 0 / 0; at lam both are positive
    phi_1 = torch.where(seg1, phi, lam)
    phi_2 = torch.where(seg1, lam, phi)
    d_1 = (lam - phi_1) + wc * phi_1
    d_2 = wc * (1.0 - phi_2) + wb * (phi_2 - lam)
    if not inverse:
        y1 = (ya * (lam - phi_1) + wc * yc * phi_1) / d_1
        y2 = (wc * yc * (1.0 - phi_2) + wb * yb * (phi_2 - lam)) / d_2
        out = torch.where(seg1, y1, y2)
        sign = 1.0
    else:
        out = x0 + w * phi
        sign = -1.0
    dydx1 = lam * wc * (yc - ya) / (d_1 * d_1 * w)
    dydx2 = (1.0 - lam) * wb * wc * (yb - yc) / (d_2 * d_2 * w)
    dydx = torch.where(seg1, dydx1, dydx2)
    return (torch.where(inside, out, inputs),
            torch.where(inside, sign * torch.log(dydx), torch.zeros_like(inputs)))


def branch_points(raw: torch.Tensor, kind: str, n_bins: int, tail_bound: float,
                  inverse: bool) -> torch.Tensor:
    """Where the spline's branches switch, ``(..., M)``, in the coordinate
    the transform searches (x forward, y inverse): the K + 1 knots, whose
    outer two are the tails' edges, and for LRS each bin's interior point
    (x0 + lam w forward, yc inverse). An input within rounding of one of
    them can take either branch; the value is continuous there, the VJP of
    the log-det is not."""
    K, T = n_bins, tail_bound
    cumw, cumh = _make_knots(raw[..., :K], raw[..., K:2 * K], K, T)
    points = cumh if inverse else cumw
    if kind == "lrs":
        lam = 0.025 + 0.95 * torch.sigmoid(raw[..., 3 * K - 1:])
        if inverse:
            derivs = _derivs(raw[..., 2 * K:3 * K - 1])
            wb = torch.sqrt(derivs[..., :-1] / derivs[..., 1:])
            inner = (((1.0 - lam) * cumh[..., :-1] + lam * wb * cumh[..., 1:])
                     / ((1.0 - lam) + lam * wb))
        else:
            inner = cumw[..., :-1] + lam * (cumw[..., 1:] - cumw[..., :-1])
        points = torch.cat([points, inner], dim=-1)
    return points
