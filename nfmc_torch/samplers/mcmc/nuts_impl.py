"""Multinomial NUTS with iterative tree doubling, batched over chains
(counterpart of ``nfmc_tpu/samplers/mcmc/nuts_impl.py``).

The JAX package runs each chain's trajectory as a ``lax.while_loop`` under
``vmap``. Here every chain takes a leapfrog at every leaf of the current
subtree, and a chain that has finished (turned, diverged, or filled its
subtree) keeps its state through ``torch.where``, never a product: a
finished lane may hold inf or NaN. Only running chains count leapfrogs.

* U-turn detection inside a subtree uses a checkpoint stack of the left
  endpoints of the open subtrees, ``(C, max_depth + 1, d)`` positions and
  momenta, indexed by popcount: an odd leaf ``i`` pushes at ``popcount(i) -
  1``, an even leaf checks ``popcount(i) - 1 .. popcount(i - 1) - 1``,
  each entry written in the same subtree before it is read. The leaf index
  is the same for every chain that runs (all start a subtree together), so
  the stack's indices are host integers.
* Backward subtrees check trajectory-ordered endpoints: walking backward
  the current leaf is the earlier point in trajectory time.
* A leaf diverges when ``delta > max_delta_energy`` or its energy is not
  finite; a non-finite leaf counts as acceptance 0.
* Progressive multinomial sampling inside a subtree, biased across
  subtrees.

The randomness is injected, one iteration's worth per call: the momenta's
raw normals ``(C, d)``, the direction bits and the merge uniforms ``(C,
max_depth)``, and one uniform a leaf ``(C, 2^max_depth - 1)`` (depth ``j``,
leaf ``i`` at ``2^j - 1 + i``). The JAX package derives the same numbers
from a key chain that does not depend on the state.

The host checks whether any chain is still running once before each
doubling and every ``NUTS_SYNC_LEAVES`` leaves inside a subtree (one
device-to-host copy each); a subtree in which no chain runs ends there.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from ...utils import event_size_of, value_and_batched_grad

# leaves between the host's checks for a running chain inside a subtree
NUTS_SYNC_LEAVES = 8


def nuts_step_draws(generator: torch.Generator, prefix: Tuple[int, ...], n_chains: int,
                    event_size: int, max_tree_depth: int):
    """``(p_raw, go_right, merge_u, leaf_u)`` for ``prefix`` iterations."""
    dev = generator.device
    p_raw = torch.randn((*prefix, n_chains, event_size), generator=generator, device=dev)
    go_right = torch.rand((*prefix, n_chains, max_tree_depth), generator=generator, device=dev) < 0.5
    merge_u = torch.rand((*prefix, n_chains, max_tree_depth), generator=generator, device=dev)
    leaf_u = torch.rand((*prefix, n_chains, (1 << max_tree_depth) - 1), generator=generator,
                        device=dev)
    return p_raw, go_right, merge_u, leaf_u


def _is_turning(z_minus, r_minus, z_plus, r_plus, imd):
    dz = z_plus - z_minus
    return ((dz * (imd * r_minus)).sum(-1) < 0.0) | ((dz * (imd * r_plus)).sum(-1) < 0.0)


def _where(mask, new, old):
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)), new, old)


def make_nuts_step(target: Callable, event_shape: Tuple[int, ...], max_tree_depth: int = 10,
                   max_delta_energy: float = 1000.0):
    """Returns ``nuts_step(x, eps, inv_mass_diag, draws) -> (x', moved,
    diverged, accept_stat, n_leapfrog, depth)`` for a batch ``x: (C,
    *event)``: per chain the new state, whether it moved, whether the
    trajectory diverged, the trajectory-average acceptance statistic, the
    leapfrog count and the tree depth reached."""
    d = event_size_of(event_shape)
    u_and_grad_batched = value_and_batched_grad(target)

    def u_grad(z):
        u, g = u_and_grad_batched(z.reshape(z.shape[0], *event_shape))
        return u, g.reshape(z.shape[0], d)

    def nuts_step(x, eps, inv_mass_diag, draws):
        p_raw, go_right_all, merge_u, leaf_u = draws
        n_chains = x.shape[0]
        dev = x.device
        imd = inv_mass_diag
        z0 = x.reshape(n_chains, d)
        r0 = p_raw / torch.sqrt(imd)
        u0, g0 = u_grad(z0)
        energy0 = u0 + 0.5 * (r0 * r0 * imd).sum(-1)

        zl, rl, gl = z0, r0, g0
        zr, rr, gr = z0, r0, g0
        z_prop = z0
        log_sum_w = torch.zeros(n_chains, dtype=z0.dtype, device=dev)  # the first leaf: w = 0
        sum_accept = torch.zeros(n_chains, dtype=z0.dtype, device=dev)
        turning = torch.zeros(n_chains, dtype=torch.bool, device=dev)
        diverged = torch.zeros(n_chains, dtype=torch.bool, device=dev)
        n_leapfrog = torch.zeros(n_chains, dtype=torch.int32, device=dev)
        depth = torch.zeros(n_chains, dtype=torch.int32, device=dev)
        ckpt_z = torch.zeros((n_chains, max_tree_depth + 1, d), dtype=z0.dtype, device=dev)
        ckpt_r = torch.zeros_like(ckpt_z)

        for j in range(max_tree_depth):
            active = ~turning & ~diverged
            if not bool(active.any()):
                break
            go_right = go_right_all[:, j]
            fwd = go_right.reshape(-1, 1)
            signed_eps = torch.where(go_right, eps, -eps).reshape(-1, 1).to(z0.dtype)
            # the subtree starts at the endpoint in its direction
            z = torch.where(fwd, zr, zl)
            r = torch.where(fwd, rr, rl)
            g = torch.where(fwd, gr, gl)
            s_prop = z
            s_log_sum_w = torch.full((n_chains,), float("-inf"), dtype=z0.dtype, device=dev)
            s_accept = torch.zeros(n_chains, dtype=z0.dtype, device=dev)
            s_turning = torch.zeros(n_chains, dtype=torch.bool, device=dev)
            s_diverged = torch.zeros(n_chains, dtype=torch.bool, device=dev)
            for i in range(1, (1 << j) + 1):  # 1-based leaf index
                run = active & ~s_turning & ~s_diverged
                if i > 1 and (i - 1) % NUTS_SYNC_LEAVES == 0 and not bool(run.any()):
                    break
                # leapfrog
                r_half = r - 0.5 * signed_eps * g
                z_new = z + signed_eps * imd * r_half
                u_new, g_new = u_grad(z_new)
                r_new = r_half - 0.5 * signed_eps * g_new
                energy = u_new + 0.5 * (r_new * r_new * imd).sum(-1)
                delta = energy - energy0
                finite = torch.isfinite(delta)
                s_diverged = s_diverged | (run & ((delta > max_delta_energy) | ~finite))
                leaf_accept = torch.where(finite, torch.clamp(torch.exp(-delta), max=1.0),
                                          torch.zeros_like(delta))
                s_accept = torch.where(run, s_accept + leaf_accept, s_accept)
                # progressive multinomial sampling inside the subtree
                w = -delta
                lsw_new = torch.logaddexp(s_log_sum_w, w)
                take = run & (leaf_u[:, (1 << j) - 1 + (i - 1)] < torch.exp(w - lsw_new))
                s_prop = _where(take, z_new, s_prop)
                s_log_sum_w = torch.where(run, lsw_new, s_log_sum_w)
                z, r, g = _where(run, z_new, z), _where(run, r_new, r), _where(run, g_new, g)
                if i % 2 == 1:
                    # push the left endpoint of the subtrees this leaf opens
                    # (a finished chain writes its frozen endpoint: it reads
                    # its stack no more in this subtree)
                    k = bin(i).count("1") - 1
                    ckpt_z[:, k] = z
                    ckpt_r[:, k] = r
                else:
                    # check every subtree whose right endpoint is this leaf
                    t = torch.zeros_like(s_turning)
                    for k in range(bin(i).count("1") - 1, bin(i - 1).count("1")):
                        z_lo = torch.where(fwd, ckpt_z[:, k], z)
                        r_lo = torch.where(fwd, ckpt_r[:, k], r)
                        z_hi = torch.where(fwd, z, ckpt_z[:, k])
                        r_hi = torch.where(fwd, r, ckpt_r[:, k])
                        t = t | _is_turning(z_lo, r_lo, z_hi, r_hi, imd)
                    s_turning = s_turning | (run & t)
                n_leapfrog = n_leapfrog + run.to(torch.int32)

            # merge the subtree into the trajectory (active chains only)
            ok = active & ~s_turning & ~s_diverged
            p_sub = torch.clamp(torch.exp(s_log_sum_w - log_sum_w), max=1.0)
            take = ok & (merge_u[:, j] < p_sub)
            z_prop = _where(take, s_prop, z_prop)
            log_sum_w = torch.where(ok, torch.logaddexp(log_sum_w, s_log_sum_w), log_sum_w)
            right, left = ok & go_right, ok & ~go_right
            zr, rr, gr = _where(right, z, zr), _where(right, r, rr), _where(right, g, gr)
            zl, rl, gl = _where(left, z, zl), _where(left, r, rl), _where(left, g, gl)
            turning_global = _is_turning(zl, rl, zr, rr, imd)
            turning = torch.where(active, s_turning | (ok & turning_global), turning)
            diverged = torch.where(active, s_diverged, diverged)
            sum_accept = torch.where(active, sum_accept + s_accept, sum_accept)
            depth = depth + active.to(torch.int32)

        moved = (z_prop != z0).any(-1)
        accept_stat = sum_accept / torch.clamp(n_leapfrog.to(z0.dtype), min=1.0)
        return z_prop.reshape(x.shape), moved, diverged, accept_stat, n_leapfrog, depth

    return nuts_step
