"""Continuous normalizing flows: FFJORD, RNODE, OT-Flow and DDB, as in
``nfmc_tpu/flows/continuous.py``.

The map is the flow of ``dx/dt = f_theta(x, t)`` (a tanh MLP of ``(x, t)``),
integrated with a fixed-step RK4 (Euler for DDB) over ``t in [0, 1]``.

* Events of at most ``exact_trace_dim`` dims: the bijection is the discrete
  integrator map itself. The forward applies the steps and adds each step's
  exact ``slogdet`` (the step's Jacobian through ``torch.func.jacfwd``); the
  inverse solves each step by 20 Picard iterations and masks a row whose
  residual exceeds ``1e-3 (1 + |y|)`` to NaN (a tensor select, no host
  check), so that the samplers count it as a divergence.
* Larger events: the instantaneous trace is integrated beside the state,
  Hutchinson's estimator with one VJP a probe, and the inverse runs the
  dynamics backward. The probes come from
  :func:`nfmc_torch.flows.base.hutchinson_probes`, so they differ from the
  JAX package's draws.

OT-Flow's dynamics are ``-grad Phi`` of a scalar potential MLP, whose trace
is ``-laplacian Phi``, so its training takes gradients of gradients. RNODE
is FFJORD with a kinetic-energy regularizer active in training. No kernel
in either package: plain PyTorch on every device.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch.func import grad, jacfwd, jvp, vjp, vmap

from .base import Bijection, hutchinson_probes
from .conditioners import mlp_apply, mlp_init


class ContinuousFlow(Bijection):
    method = "rk4"

    def __init__(self, event_shape: Sequence[int], hidden_size: int = 64,
                 n_hidden_layers: int = 2, n_steps: int = 12,
                 exact_trace_dim: int = 32, n_probes: int = 4, **_):
        super().__init__(event_shape)
        self.hidden = [int(hidden_size)] * int(n_hidden_layers)
        self.n_steps = int(n_steps)
        self.exact_trace_dim = int(exact_trace_dim)
        self.n_probes = int(n_probes)

    @property
    def layers(self):
        return list(range(self.n_steps))

    def init(self, generator):
        return mlp_init(generator, self.event_size + 1, self.hidden, self.event_size)

    # ---- dynamics: rows (..., d) at a float32 time t (a 0-d tensor) -------------
    @staticmethod
    def _with_time(v, t):
        return torch.cat([v, t.to(v.dtype).expand(*v.shape[:-1], 1)], dim=-1)

    def _f(self, params, v, t):
        return mlp_apply(params, self._with_time(v, t))

    def _f_and_trace(self, params, v, t):
        """``(f, tr df/dv)`` a row by Hutchinson's estimator: the mean over
        the row's probes e of e . (e^T df/dv), one VJP a probe."""
        probes = hutchinson_probes(v, self.n_probes, self.probe_key).transpose(0, 1)
        y, pull = vjp(lambda u: self._f(params, u, t), v)
        (pulled,) = vmap(pull)(probes)
        return y, (probes * pulled).sum(-1).mean(0)

    def _step(self, params, v, t, h):
        """One forward integrator step of rows ``v``."""
        if self.method == "euler":
            return v + h * self._f(params, v, t)
        f1 = self._f(params, v, t)
        f2 = self._f(params, v + 0.5 * h * f1, t + 0.5 * h)
        f3 = self._f(params, v + 0.5 * h * f2, t + 0.5 * h)
        f4 = self._f(params, v + h * f3, t + h)
        return v + h / 6.0 * (f1 + 2 * f2 + 2 * f3 + f4)

    def _step_log_det(self, params, v, t, h):
        """log |det| of each row's step Jacobian."""
        def one(u):
            return self._step(params, u[None], t, h)[0]

        return torch.linalg.slogdet(vmap(jacfwd(one))(v))[1]

    def _exact(self) -> bool:
        return self.event_size <= self.exact_trace_dim

    def _integrate(self, params, x, reverse: bool):
        batch_shape = x.shape[: x.dim() - len(self.event_shape)]
        v = x.reshape(-1, self.event_size)
        h = 1.0 / self.n_steps
        ld = torch.zeros(v.shape[0], dtype=v.dtype, device=v.device)
        steps = torch.arange(self.n_steps, dtype=torch.float32, device=v.device)  # as JAX's

        if self._exact():
            for i in steps:
                if not reverse:
                    t = i * h
                    ld = ld + self._step_log_det(params, v, t, h)
                    v = self._step(params, v, t, h)
                    continue
                # invert the step at t = (n_steps - 1 - i) h by Picard,
                # u <- u + (y - step(u)): the step is the identity + O(h)
                t = (self.n_steps - 1.0 - i) * h
                y = v
                u = y
                for _ in range(20):
                    u = u + (y - self._step(params, u, t, h))
                # Picard contracts only while h Lip(f) < 1: a row left
                # unconverged becomes NaN, never a confidently wrong inverse
                resid = torch.linalg.vector_norm(y - self._step(params, u, t, h), dim=-1)
                ok = resid <= 1e-3 * (1.0 + torch.linalg.vector_norm(y, dim=-1))
                u = torch.where(ok[:, None], u, torch.full_like(u, float("nan")))
                ld = ld - self._step_log_det(params, u, t, h)
                v = u
            return v.reshape(x.shape), ld.reshape(batch_shape)

        # above exact_trace_dim: integrate the instantaneous trace. The
        # forward (sign +1) accumulates log|det dz/dx| = +int tr dt; the
        # backward traversal (sign -1) log|det dx/dz| = -int tr dt, the sign
        # that the exact path's slogdet holds it to
        sign = -1.0 if reverse else 1.0
        for i in steps:
            t = (1.0 - i * h) if reverse else (i * h)
            if self.method == "euler":
                f, tr = self._f_and_trace(params, v, t)
                v = v + sign * h * f
                ld = ld + sign * h * tr
                continue
            f1, tr1 = self._f_and_trace(params, v, t)
            f2, tr2 = self._f_and_trace(params, v + sign * 0.5 * h * f1, t + sign * 0.5 * h)
            f3, tr3 = self._f_and_trace(params, v + sign * 0.5 * h * f2, t + sign * 0.5 * h)
            f4, tr4 = self._f_and_trace(params, v + sign * h * f3, t + sign * h)
            v = v + sign * h / 6.0 * (f1 + 2 * f2 + 2 * f3 + f4)
            ld = ld + sign * h / 6.0 * (tr1 + 2 * tr2 + 2 * tr3 + tr4)
        return v.reshape(x.shape), ld.reshape(batch_shape)

    def forward_fn(self, params, x):
        return self._integrate(params, x, reverse=False)

    def inverse_fn(self, params, z):
        return self._integrate(params, z, reverse=True)

    def regularization(self, params, x):
        """Per-sample kinetic energy E_t[|f|^2] at t in linspace(0, 1, 4)
        (RNODE; Finlay et al. 2020), shaped ``(batch,)``."""
        batch_shape = x.shape[: x.dim() - len(self.event_shape)]
        v = x.reshape(-1, self.event_size)
        ts = torch.linspace(0.0, 1.0, 4, dtype=torch.float32, device=v.device)
        f = torch.stack([self._f(params, v, t) for t in ts])
        return (f * f).sum(-1).mean(0).reshape(batch_shape)


class FFJORD(ContinuousFlow):
    """Grathwohl et al. 2019."""


class RNODE(ContinuousFlow):
    """FFJORD with the kinetic-energy regularizer weighted into the
    ``fit`` / ``variational_fit`` losses (Finlay et al. 2020)."""

    regularization_weight = 0.01


class DeepDiffeomorphicBijection(ContinuousFlow):
    """Euler-discretised NODE bijection (DDB): more, cheaper steps."""

    method = "euler"

    def __init__(self, event_shape, n_steps: int = 20, **kwargs):
        super().__init__(event_shape, n_steps=n_steps, **kwargs)


class OTFlow(ContinuousFlow):
    """Potential-driven dynamics f = -grad Phi(x, t); trace -laplacian Phi."""

    def init(self, generator):
        return mlp_init(generator, self.event_size + 1, self.hidden, 1)

    def _grad_phi(self, params, t):
        """``v -> grad Phi`` a row (rows are independent, so the gradient
        of the summed potential)."""
        return grad(lambda u: mlp_apply(params, self._with_time(u, t))[..., 0].sum())

    def _f(self, params, v, t):
        return -self._grad_phi(params, t)(v)

    def _f_and_trace(self, params, v, t):
        probes = hutchinson_probes(v, self.n_probes, self.probe_key).transpose(0, 1)
        grad_phi = self._grad_phi(params, t)
        _, hvp = vmap(lambda e: jvp(grad_phi, (v,), (e,)))(probes)
        return -grad_phi(v), -(probes * hvp).sum(-1).mean(0)
