"""Multiscale and Glow image flows and the convolutional residual and
continuous flows, as in ``nfmc_tpu/flows/multiscale.py``.

Events are ``(H, W)`` (one channel) or ``(C, H, W)``. A multiscale flow
runs, per level: a 2 x 2 space-to-depth squeeze, ``n_steps_per_level``
channel-split couplings with a convolutional conditioner (the split
alternates which half conditions), then half the channels factor out to the
latent. Glow steps add ActNorm and an invertible 1 x 1 convolution. The
latent is the factored parts concatenated in level order and reshaped to
the event, so the base distribution is unchanged.

Every convolution is the input's shifted views and one matmul
(:func:`conv2d`), in full float32 whatever the caller's cuDNN TF32 flag
(``F.conv2d`` on float32 CUDA tensors computes in TF32 by PyTorch's
default). No kernel in either package: plain PyTorch on every device.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .base import Bijection, hutchinson_probes
from .naf import DeepDenseSigmoidTransform, DeepSigmoidTransform, DenseSigmoidTransform
from .residual import _randn, _safe_norm, _zeros
from .transforms import AffineTransform, LRSplineTransform, RQSplineTransform, ShiftTransform


def conv2d(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """SAME cross-correlation of ``x (B, C, H, W)`` with ``w (O, C, k, k)``,
    k odd, as ``lax.conv_general_dilated`` in NCHW / OIHW: the k^2 shifted
    views of the zero-padded input stacked channel-major as ``w``'s rows,
    times the weights, one matmul. (``F.unfold`` would give the same
    patches, but on CUDA it launches one kernel a batch row.)"""
    b, c, h, wd = x.shape
    k = w.shape[-1]
    if k == 1:
        cols = x.reshape(b, c, h * wd)
    else:
        xp = F.pad(x, (k // 2,) * 4)
        cols = torch.stack([xp[:, :, dy:dy + h, dx:dx + wd] for dy in range(k)
                            for dx in range(k)], dim=2).reshape(b, c * k * k, h * wd)
    return (w.reshape(w.shape[0], -1) @ cols).reshape(b, w.shape[0], h, wd)


def _bias(b):
    return b[None, :, None, None]


def _chw(event_shape, what: str):
    if len(event_shape) == 2:
        return (1, int(event_shape[0]), int(event_shape[1]))
    if len(event_shape) == 3:
        return tuple(int(s) for s in event_shape)
    raise ValueError(f"{what} need (H, W) or (C, H, W) events, got {tuple(event_shape)}")


def _batch(v, event_shape):
    batch = v.shape[: v.dim() - len(event_shape)]
    return batch, (int(np.prod(batch)) if batch else 1)


# ---------------------------------------------------------------------------
# the convolutional conditioner (NCHW)
# ---------------------------------------------------------------------------

def conv_init(generator, in_ch, hidden_ch, out_ch, kernel=3):
    """3 x 3 -> tanh -> 1 x 1 -> tanh -> 3 x 3, the last layer zero (the
    flow starts as the identity); the 1 x 1 layer's fan-in is
    ``hidden_ch``."""
    return {
        "w1": (_randn(generator, hidden_ch, in_ch, kernel, kernel)
               / np.sqrt(in_ch * kernel * kernel)),
        "b1": _zeros(generator, hidden_ch),
        "w2": _randn(generator, hidden_ch, hidden_ch, 1, 1) / np.sqrt(hidden_ch),
        "b2": _zeros(generator, hidden_ch),
        "w3": _zeros(generator, out_ch, hidden_ch, kernel, kernel),
        "b3": _zeros(generator, out_ch),
    }


def conv_apply(p, x):
    """``(B, C, H, W) -> (B, out_ch, H, W)``."""
    h = torch.tanh(conv2d(p["w1"], x) + _bias(p["b1"]))
    h = torch.tanh(conv2d(p["w2"], h) + _bias(p["b2"]))
    return conv2d(p["w3"], h) + _bias(p["b3"])


def _squeeze(x):
    """``(B, C, H, W) -> (B, 4C, H/2, W/2)`` space-to-depth."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, 4 * c, h // 2, w // 2)


def _unsqueeze(x):
    b, c4, h, w = x.shape
    c = c4 // 4
    x = x.reshape(b, c, 2, 2, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, c, 2 * h, 2 * w)


class MultiscaleFlow(Bijection):
    """Generic multiscale coupling flow; ``glow=True`` adds ActNorm and the
    invertible 1 x 1 convolution to every step."""

    def __init__(self, event_shape: Sequence[int], transform, n_steps_per_level: int = 2,
                 n_levels: Optional[int] = None, hidden_channels: int = 32,
                 glow: bool = False, **_):
        super().__init__(event_shape)
        self.chw = _chw(event_shape, "multiscale flows")
        c, h, w = self.chw
        if h % 2 or w % 2:
            raise ValueError("spatial dims must be even for squeezing")
        if n_levels is None:
            n_levels = 1
            hh, ww = h // 2, w // 2
            while hh % 2 == 0 and ww % 2 == 0 and min(hh, ww) >= 4 and n_levels < 3:
                n_levels += 1
                hh, ww = hh // 2, ww // 2
        elif h % (2 ** int(n_levels)) or w % (2 ** int(n_levels)):
            # every level squeezes 2x in each spatial dim
            raise ValueError(f"n_levels={n_levels} needs spatial dims divisible by "
                             f"{2 ** int(n_levels)}, got ({h}, {w})")
        self.n_levels = int(n_levels)
        self.n_steps = int(n_steps_per_level)
        self.hidden_channels = int(hidden_channels)
        self.transform = transform
        self.glow = glow
        # channels at each level after its squeeze; a split keeps ceil(ch / 2)
        self.level_channels: List[int] = []
        ch = c
        for lvl in range(self.n_levels):
            ch *= 4
            self.level_channels.append(ch)
            if lvl != self.n_levels - 1:
                ch -= ch // 2

    @property
    def layers(self):
        return list(range(self.n_levels * self.n_steps))

    def init(self, generator):
        params = []
        for ch in self.level_channels:
            c_a = ch // 2
            level = []
            for _ in range(self.n_steps):
                step = {"conv": conv_init(generator, c_a, self.hidden_channels,
                                          (ch - c_a) * self.transform.n_params_per_dim)}
                if self.glow:
                    q, _ = torch.linalg.qr(_randn(generator, ch, ch))
                    step["actnorm_log_s"] = _zeros(generator, ch)
                    step["actnorm_b"] = _zeros(generator, ch)
                    step["conv1x1_w"] = q  # orthogonal: log-det 0
                level.append(step)
            params.append(level)
        return params

    # ---- one flow step ---------------------------------------------------------
    def _halves(self, v, swap):
        ch = v.shape[1]
        c_a = ch // 2
        # swap alternates which half conditions; the channel order is kept
        return (v[:, ch - c_a:], v[:, :ch - c_a]) if swap else (v[:, :c_a], v[:, c_a:])

    def _raw(self, p, va, vb):
        b, _, h, w = va.shape
        n_p = self.transform.n_params_per_dim
        return conv_apply(p["conv"], va).reshape(b, vb.shape[1], n_p, h, w).permute(0, 1, 3, 4, 2)

    def _step_forward(self, p, v, swap):
        b, _, h, w = v.shape
        ld = torch.zeros(b, dtype=v.dtype, device=v.device)
        if self.glow:
            v = v * torch.exp(_bias(p["actnorm_log_s"])) + _bias(p["actnorm_b"])
            ld = ld + p["actnorm_log_s"].sum() * h * w
            v = torch.einsum("ij,bjhw->bihw", p["conv1x1_w"], v)
            ld = ld + torch.linalg.slogdet(p["conv1x1_w"])[1] * h * w
        va, vb = self._halves(v, swap)
        vb_new, ld_elem = self.transform.forward(vb, self._raw(p, va, vb))
        ld = ld + ld_elem.reshape(b, -1).sum(-1)
        return (torch.cat([vb_new, va], 1) if swap else torch.cat([va, vb_new], 1)), ld

    def _step_inverse(self, p, v, swap):
        b, _, h, w = v.shape
        ld = torch.zeros(b, dtype=v.dtype, device=v.device)
        va, vb_new = self._halves(v, swap)
        vb, ld_elem = self.transform.inverse(vb_new, self._raw(p, va, vb_new))
        ld = ld + ld_elem.reshape(b, -1).sum(-1)
        v = torch.cat([vb, va], 1) if swap else torch.cat([va, vb], 1)
        if self.glow:
            v = torch.einsum("ij,bjhw->bihw", torch.linalg.inv(p["conv1x1_w"]), v)
            ld = ld - torch.linalg.slogdet(p["conv1x1_w"])[1] * h * w
            v = (v - _bias(p["actnorm_b"])) * torch.exp(-_bias(p["actnorm_log_s"]))
            ld = ld - p["actnorm_log_s"].sum() * h * w
        return v, ld

    # ---- whole passes ----------------------------------------------------------
    def forward_fn(self, params, x):
        batch, b = _batch(x, self.event_shape)
        v = x.reshape(b, *self.chw)
        ld = torch.zeros(b, dtype=x.dtype, device=x.device)
        factored = []
        for lvl in range(self.n_levels):
            v = _squeeze(v)
            for s, p in enumerate(params[lvl]):
                v, l = self._step_forward(p, v, swap=bool(s % 2))
                ld = ld + l
            if lvl != self.n_levels - 1:
                keep = v.shape[1] - v.shape[1] // 2
                factored.append(v[:, keep:].reshape(b, -1))
                v = v[:, :keep]
        factored.append(v.reshape(b, -1))
        z = torch.cat(factored, -1)
        return z.reshape(*batch, *self.event_shape), ld.reshape(batch)

    def _factored_shapes(self):
        """The (c, h, w) of each level's factored part, the last level's
        remainder last."""
        shapes = []
        c, h, w = self.chw
        for lvl in range(self.n_levels):
            c, h, w = c * 4, h // 2, w // 2
            if lvl != self.n_levels - 1:
                keep = c - c // 2
                shapes.append((c - keep, h, w))
                c = keep
        shapes.append((c, h, w))
        return shapes

    def inverse_fn(self, params, z):
        batch, b = _batch(z, self.event_shape)
        flat = z.reshape(b, -1)
        ld = torch.zeros(b, dtype=z.dtype, device=z.device)
        shapes = self._factored_shapes()
        offsets = np.cumsum([0] + [int(np.prod(s)) for s in shapes])
        parts = [flat[:, offsets[i]:offsets[i + 1]].reshape(b, *s) for i, s in enumerate(shapes)]
        v = parts[-1]
        for lvl in reversed(range(self.n_levels)):
            if lvl != self.n_levels - 1:
                v = torch.cat([v, parts[lvl]], 1)
            for s in reversed(range(self.n_steps)):
                v, l = self._step_inverse(params[lvl][s], v, swap=bool(s % 2))
                ld = ld + l
            v = _unsqueeze(v)
        return v.reshape(*batch, *self.event_shape), ld.reshape(batch)


def _ms(transform_factory, glow=False):
    def ctor(event_shape, n_steps_per_level: int = 2, n_levels=None,
             hidden_channels: int = 32, **kwargs):
        return MultiscaleFlow(event_shape, transform_factory(**kwargs),
                              n_steps_per_level=n_steps_per_level, n_levels=n_levels,
                              hidden_channels=hidden_channels, glow=glow)

    return ctor


def _affine(**kw):
    return AffineTransform(clamp=kw.get("clamp", 3.0))


def _shift(**kw):
    return ShiftTransform()


def _rqs(**kw):
    return RQSplineTransform(n_bins=kw.get("n_bins", 4), tail_bound=kw.get("tail_bound", 5.0))


def _lrs(**kw):
    return LRSplineTransform(n_bins=kw.get("n_bins", 4), tail_bound=kw.get("tail_bound", 5.0))


def _naf_deep(**kw):
    return DeepSigmoidTransform(n_components=kw.get("n_components", 4))


def _naf_dense(**kw):
    return DenseSigmoidTransform(n_components=kw.get("n_components", 4))


def _naf_dd(**kw):
    return DeepDenseSigmoidTransform(n_components=kw.get("n_components", 4))


MultiscaleRealNVP = _ms(_affine)
MultiscaleNICE = _ms(_shift)
MultiscaleRQNSF = _ms(_rqs)
MultiscaleLRSNSF = _ms(_lrs)
MultiscaleDeepSigmoid = _ms(_naf_deep)
MultiscaleDenseSigmoid = _ms(_naf_dense)
MultiscaleDeepDenseSigmoid = _ms(_naf_dd)
AffineGlow = _ms(_affine, glow=True)
ShiftGlow = _ms(_shift, glow=True)
RQSGlow = _ms(_rqs, glow=True)
LRSGlow = _ms(_lrs, glow=True)
DeepSigmoidGlow = _ms(_naf_deep, glow=True)
DenseSigmoidGlow = _ms(_naf_dense, glow=True)
DeepDenseSigmoidGlow = _ms(_naf_dd, glow=True)


# ---------------------------------------------------------------------------
# convolutional residual flows
# ---------------------------------------------------------------------------

class _ConvResidual(Bijection):
    """y = x + g(x), g a spectrally normalised conv net (Lip < 1), the
    log-det by the truncated series ``sum_k (-1)^(k+1) tr(J^k) / k`` with
    Hutchinson probes, ``J^k e`` by k JVPs. A conv's operator norm is at
    most sqrt(kh kw) times its reshaped matrix's spectral norm, so each
    kernel is normalised with that factor: the block is a contraction and
    the series converges at rate ``lipschitz^k``."""

    lipschitz = 0.5
    series_terms = 12

    def __init__(self, event_shape: Sequence[int], n_layers: int = 4,
                 hidden_channels: int = 16, n_probes: int = 4, **_):
        super().__init__(event_shape)
        self.chw = _chw(event_shape, "conv flows")
        self.n_layers = int(n_layers)
        self.hidden_channels = int(hidden_channels)
        self.n_probes = int(n_probes)

    @property
    def layers(self):
        return list(range(self.n_layers))

    def init(self, generator):
        c, hc = self.chw[0], self.hidden_channels
        return [{"w1": _randn(generator, hc, c, 3, 3) / np.sqrt(c * 9), "b1": _zeros(generator, hc),
                 "w2": _zeros(generator, c, hc, 3, 3), "b2": _zeros(generator, c)}
                for _ in range(self.n_layers)]

    @staticmethod
    def _sn(w, c):
        """``w`` scaled so that its conv operator norm is at most ``c``: a
        power iteration on the reshaped kernel from ones / sqrt(n), times
        sqrt(kernel area)."""
        flat = w.reshape(w.shape[0], -1)
        u = torch.ones(flat.shape[1], dtype=w.dtype, device=w.device) / np.sqrt(flat.shape[1])
        for _ in range(5):
            v = flat @ u
            v = v / _safe_norm(v)
            u = flat.T @ v
            u = u / _safe_norm(u)
        sigma = _safe_norm(flat @ u) * np.sqrt(float(np.prod(w.shape[2:])))
        return w * (c / torch.clamp(sigma, min=c))

    def _weights(self, p):
        c = float(np.sqrt(self.lipschitz))
        return self._sn(p["w1"], c), self._sn(p["w2"], c)

    def _g(self, p, w, x):
        w1, w2 = w
        return conv2d(w2, torch.tanh(conv2d(w1, x) + _bias(p["b1"]))) + _bias(p["b2"])

    def _logdet(self, p, w, x):
        """log |det(I + dg/dx)| a row by the series: ``J e`` is
        ``conv(w2, (1 - tanh^2) conv(w1, e))``, the JVP of ``g``."""
        w1, w2 = w
        b, n_p = x.shape[0], self.n_probes
        probes = hutchinson_probes(x.reshape(b, -1), n_p, self.probe_key)  # (B, P, d)
        s = 1.0 - torch.tanh(conv2d(w1, x) + _bias(p["b1"])) ** 2
        s = s.repeat_interleave(n_p, dim=0)  # a row's for each of its probes
        e = probes.reshape(b * n_p, *self.chw)
        v = e
        ld = torch.zeros(b, n_p, dtype=x.dtype, device=x.device)
        for k in range(1, self.series_terms + 1):
            v = conv2d(w2, s * conv2d(w1, v))
            ld = ld + ((-1.0) ** (k + 1)) * (e * v).reshape(b, n_p, -1).sum(-1) / k
        return ld.mean(-1)

    def forward_fn(self, params, x):
        batch, b = _batch(x, self.event_shape)
        v = x.reshape(b, *self.chw)
        ld = torch.zeros(b, dtype=x.dtype, device=x.device)
        for p in params:
            w = self._weights(p)
            ld = ld + self._logdet(p, w, v)
            v = v + self._g(p, w, v)
        return v.reshape(x.shape), ld.reshape(batch)

    def inverse_fn(self, params, z):
        batch, b = _batch(z, self.event_shape)
        v = z.reshape(b, *self.chw)
        ld = torch.zeros(b, dtype=z.dtype, device=z.device)
        for p in reversed(params):
            w = self._weights(p)
            u = v
            for _ in range(40):
                u = v - self._g(p, w, u)
            ld = ld - self._logdet(p, w, u)
            v = u
        return v.reshape(z.shape), ld.reshape(batch)


class ConvolutionalInvertibleResNet(_ConvResidual):
    lipschitz = 0.5
    series_terms = 12


class ConvolutionalResFlow(_ConvResidual):
    lipschitz = 0.6
    series_terms = 20


# ---------------------------------------------------------------------------
# convolutional continuous flows
# ---------------------------------------------------------------------------

class _ConvContinuous(Bijection):
    """CNF with convolutional dynamics and fixed-step RK4. The trace of the
    dynamics' Jacobian ``J = W2 diag(1 - tanh^2) W1`` (the time channel
    has no tangent) is exact up to ``exact_trace_dim`` dims: each diagonal
    entry ``df_c(p)/dv_c(p)`` sums ``w2[c, k, o] (1 - tanh^2)_k(p + o - 1)
    w1[k, c, 2 - o]`` over the hidden channels k and the offsets o whose
    pixel lies inside the image, so the trace is one contraction of
    ``1 - tanh^2`` with a per-pixel weight map. Above, Hutchinson's
    ``e . J e`` with the JVP ``conv(w2, (1 - tanh^2) conv(w1, e))``."""

    method = "rk4"

    def __init__(self, event_shape: Sequence[int], hidden_channels: int = 16,
                 n_steps: int = 6, n_probes: int = 8, exact_trace_dim: int = 64, **_):
        super().__init__(event_shape)
        self.chw = _chw(event_shape, "conv flows")
        self.hidden_channels = int(hidden_channels)
        self.n_steps = int(n_steps)
        self.n_probes = int(n_probes)
        self.exact_trace_dim = int(exact_trace_dim)

    @property
    def layers(self):
        return list(range(self.n_steps))

    def init(self, generator):
        c, hc = self.chw[0], self.hidden_channels
        return {"w1": _randn(generator, hc, c + 1, 3, 3) / np.sqrt((c + 1) * 9),
                "b1": _zeros(generator, hc), "w2": _zeros(generator, c, hc, 3, 3),
                "b2": _zeros(generator, c)}

    def _hidden(self, p, v, t):
        """The hidden layer's tanh of ``v (b, C, H, W)`` at the float32 time
        ``t`` (a 0-d tensor)."""
        tmap = t.to(v.dtype).expand(v.shape[0], 1, *v.shape[2:])
        return torch.tanh(conv2d(p["w1"], torch.cat([v, tmap], 1)) + _bias(p["b1"]))

    def _f(self, p, v, t):
        return conv2d(p["w2"], self._hidden(p, v, t)) + _bias(p["b2"])

    def _trace_map(self, p, like):
        """``M[k, q]``: the weight of ``(1 - tanh^2)_k(q)`` in the trace,
        ``sum_o G[k, o] [q - o + 1 inside]`` with ``G[k, o] = sum_c
        w2[c, k, o] w1[k, c, 2 - o]`` (a matmul with the offsets' 0 / 1
        masks, full float32)."""
        c, h, w = self.chw
        qy, qx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        masks = np.stack([(0 <= qy - dy + 1) & (qy - dy + 1 < h) & (0 <= qx - dx + 1)
                          & (qx - dx + 1 < w) for dy in range(3) for dx in range(3)])
        masks = torch.as_tensor(masks.reshape(9, h * w), dtype=like.dtype, device=like.device)
        g = (p["w2"].transpose(0, 1) * p["w1"][:, :c].flip(-1, -2)).sum(1)  # (hc, 3, 3)
        return (g.reshape(g.shape[0], 9) @ masks).reshape(1, g.shape[0], h, w)

    def _f_and_trace(self, p, v, t):
        b, d = v.shape[0], int(np.prod(self.chw))
        h = self._hidden(p, v, t)
        f = conv2d(p["w2"], h) + _bias(p["b2"])
        s = 1.0 - h * h  # (b, hc, H, W)
        if d <= self.exact_trace_dim:
            return f, (s * self._trace_map(p, v)).sum((1, 2, 3))
        probes = hutchinson_probes(v.reshape(b, -1), self.n_probes, self.probe_key)  # (b, P, d)
        e = probes.reshape(b * self.n_probes, *self.chw)
        inner = conv2d(p["w1"][:, :self.chw[0]], e).reshape(b, self.n_probes, -1, *self.chw[1:])
        je = conv2d(p["w2"], (s[:, None] * inner).reshape(b * self.n_probes, *inner.shape[2:]))
        return f, (probes * je.reshape(b, self.n_probes, d)).sum(-1).mean(-1)

    def _n_steps(self) -> int:
        return self.n_steps

    def _integrate(self, params, x, reverse: bool):
        batch, b = _batch(x, self.event_shape)
        v = x.reshape(b, *self.chw)
        n = self._n_steps()
        h = 1.0 / n
        sign = -1.0 if reverse else 1.0
        ld = torch.zeros(b, dtype=x.dtype, device=x.device)
        # +sign: d/dt log|det dz_t/dx| = +tr(df/dx) (see flows/continuous.py)
        for i in torch.arange(n, dtype=torch.float32, device=v.device):
            t = (1.0 - i * h) if reverse else (i * h)
            if self.method == "euler":
                f, tr = self._f_and_trace(params, v, t)
                v, ld = v + sign * h * f, ld + sign * h * tr
                continue
            f1, tr1 = self._f_and_trace(params, v, t)
            f2, tr2 = self._f_and_trace(params, v + sign * 0.5 * h * f1, t + sign * 0.5 * h)
            f3, tr3 = self._f_and_trace(params, v + sign * 0.5 * h * f2, t + sign * 0.5 * h)
            f4, tr4 = self._f_and_trace(params, v + sign * h * f3, t + sign * h)
            v = v + sign * h / 6.0 * (f1 + 2 * f2 + 2 * f3 + f4)
            ld = ld + sign * h / 6.0 * (tr1 + 2 * tr2 + 2 * tr3 + tr4)
        return v.reshape(x.shape), ld.reshape(batch)

    def forward_fn(self, params, x):
        return self._integrate(params, x, reverse=False)

    def inverse_fn(self, params, z):
        return self._integrate(params, z, reverse=True)

    def regularization(self, params, x):
        """Per-sample kinetic energy E_t[|f|^2] over the conv dynamics at t
        in linspace(0, 1, 4), shaped ``(batch,)``."""
        batch, b = _batch(x, self.event_shape)
        v = x.reshape(b, *self.chw)
        ts = torch.linspace(0.0, 1.0, 4, dtype=torch.float32, device=v.device)
        f = torch.stack([self._f(params, v, t) for t in ts])
        return (f * f).sum((2, 3, 4)).mean(0).reshape(batch)


class ConvolutionalFFJORD(_ConvContinuous):
    """Conv CNF trained by plain MLE (no kinetic term)."""


class ConvolutionalRNODE(_ConvContinuous):
    """Conv CNF with the kinetic regularizer weighted into training."""

    regularization_weight = 0.01


class ConvolutionalDDB(_ConvContinuous):
    """Euler with at least 12 steps (DDB style)."""

    method = "euler"

    def _n_steps(self) -> int:
        return max(self.n_steps, 12)
