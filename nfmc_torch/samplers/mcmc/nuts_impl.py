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
  is the same for every chain that runs (all start a subtree together).
  Where the host runs the leaf loop it is a host integer, as are the
  stack's indices, and an odd leaf checks nothing; where the device runs
  it (a captured iteration) it is the loop's device counter, the indices
  are computed on the device and every leaf checks its subtree's slots at
  once, masked (none for an odd leaf). Both give the same numbers.
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

Where the JAX package's ``lax.while_loop``s test for a running chain, the
trajectory runs in scopes of :mod:`nfmc_torch.core.graphs`: each doubling
runs while some chain runs its trajectory (``graphs.when``), and its
leaves while some chain runs its subtree (``graphs.loop``). Both
predicates only fall. In a captured iteration a doubling is an IF node and
its leaves a WHILE node, tested on the device before every leaf. Eagerly
the host reads the predicates before each doubling and every
``NUTS_SYNC_LEAVES`` leaves (one device-to-host copy each); the leaves
between run as no-ops for finished chains, so both ways give the same
numbers. The state the scopes carry lives in tensors made before them,
written in place.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from ...core import graphs
from ...utils import event_size_of, value_and_batched_grad

# leaves between the eager loop's host checks for a running chain inside a
# subtree (a captured iteration checks on the device every leaf)
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


def _where(mask, new, old, out=None):
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)), new, old, out=out)


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

        def zeros(shape, dtype=z0.dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        # the trajectory's state and the subtree's, in tensors made before
        # the scopes, which write them in place
        zl, rl, gl = z0.clone(), r0.clone(), g0.clone()
        zr, rr, gr = z0.clone(), r0.clone(), g0.clone()
        z_prop = z0.clone()
        log_sum_w = zeros(n_chains)  # the first leaf: w = 0
        sum_accept = zeros(n_chains)
        turning = zeros(n_chains, torch.bool)
        diverged = zeros(n_chains, torch.bool)
        n_leapfrog = zeros(n_chains, torch.int32)
        depth = zeros(n_chains, torch.int32)
        ckpt_z = zeros((n_chains, max_tree_depth + 1, d))
        ckpt_r = torch.zeros_like(ckpt_z)
        z, r, g, s_prop = (torch.empty_like(z0) for _ in range(4))
        s_log_sum_w, s_accept = zeros(n_chains), zeros(n_chains)
        s_turning, s_diverged = zeros(n_chains, torch.bool), zeros(n_chains, torch.bool)
        active = zeros(n_chains, torch.bool)

        bit = torch.arange(max_tree_depth + 1, device=dev)

        def leaf(j, t, fwd, half_eps, eps_imd):
            """Leaf ``i = t + 1`` of the subtree of doubling ``j`` (``t`` the
            loop's index: an int, or a 0-d int64 tensor where the device
            runs the loop), with ``half_eps = 0.5 * eps`` and ``eps_imd =
            eps * imd`` signed by its direction."""
            on_host = isinstance(t, int)
            run = active & ~s_turning & ~s_diverged
            # leapfrog
            r_half = r - half_eps * g
            z_new = z + eps_imd * r_half
            u_new, g_new = u_grad(z_new)
            r_new = r_half - half_eps * g_new
            energy = u_new + 0.5 * (r_new * r_new * imd).sum(-1)
            delta = energy - energy0
            finite = torch.isfinite(delta)
            s_diverged.copy_(s_diverged | (run & ((delta > max_delta_energy) | ~finite)))
            leaf_accept = torch.where(finite, torch.clamp(torch.exp(-delta), max=1.0),
                                      torch.zeros_like(delta))
            torch.where(run, s_accept + leaf_accept, s_accept, out=s_accept)
            # progressive multinomial sampling inside the subtree
            w = -delta
            lsw_new = torch.logaddexp(s_log_sum_w, w)
            col = (1 << j) - 1 + t
            u_leaf = leaf_u[:, col] if on_host else leaf_u.index_select(1, col.view(1))[:, 0]
            take = run & (u_leaf < torch.exp(w - lsw_new))
            _where(take, z_new, s_prop, out=s_prop)
            torch.where(run, lsw_new, s_log_sum_w, out=s_log_sum_w)
            _where(run, z_new, z, out=z)
            _where(run, r_new, r, out=r)
            _where(run, g_new, g, out=g)
            # an odd leaf pushes the left endpoint of the subtrees it opens
            # at popcount(i) - 1 (a finished chain writes its frozen
            # endpoint: it reads its stack no more in this subtree); on the
            # device an even one writes the unused last slot
            i = t + 1
            if on_host:
                pop_i, pop_t = bin(i).count("1"), bin(t).count("1")
                if i % 2 == 1:
                    ckpt_z[:, pop_i - 1] = z
                    ckpt_r[:, pop_i - 1] = r
            else:
                pop_i, pop_t = ((i >> bit) & 1).sum(), ((t >> bit) & 1).sum()
                slot = torch.where((i & 1) == 1, pop_i - 1, max_tree_depth).view(1)
                ckpt_z.index_copy_(1, slot, z.unsqueeze(1))
                ckpt_r.index_copy_(1, slot, r.unsqueeze(1))
            if j > 0 and not (on_host and i % 2 == 1):
                # an even leaf checks every subtree whose right endpoint it
                # is, k in [popcount(i) - 1, popcount(i - 1)) (none for an
                # odd leaf), all j slots at once
                k = bit[:j]
                checked = (k >= pop_i - 1) & (k < pop_t)
                fwd3 = fwd.unsqueeze(-1)
                zk, rk = ckpt_z[:, :j], ckpt_r[:, :j]
                z1, r1 = z.unsqueeze(1), r.unsqueeze(1)
                z_lo, r_lo = torch.where(fwd3, zk, z1), torch.where(fwd3, rk, r1)
                z_hi, r_hi = torch.where(fwd3, z1, zk), torch.where(fwd3, r1, rk)
                turn = (_is_turning(z_lo, r_lo, z_hi, r_hi, imd) & checked).any(-1)
                s_turning.copy_(s_turning | (run & turn))
            n_leapfrog.add_(run.to(torch.int32))

        def doubling(j):
            go_right = go_right_all[:, j]
            fwd = go_right.reshape(-1, 1)
            signed_eps = torch.where(go_right, eps, -eps).reshape(-1, 1).to(z0.dtype)
            # the leaves' factors, as the products (0.5 eps) g and (eps imd) r
            # group them
            half_eps, eps_imd = 0.5 * signed_eps, signed_eps * imd
            # the subtree starts at the endpoint in its direction
            torch.where(fwd, zr, zl, out=z)
            torch.where(fwd, rr, rl, out=r)
            torch.where(fwd, gr, gl, out=g)
            s_prop.copy_(z)
            s_log_sum_w.fill_(float("-inf"))
            s_accept.zero_()
            s_turning.zero_()
            s_diverged.zero_()
            # the leaves, while some chain runs its subtree (tested on the
            # host every NUTS_SYNC_LEAVES leaves, on the device every leaf)
            graphs.loop(1 << j, lambda _t: (active & ~s_turning & ~s_diverged).any(),
                        lambda t: leaf(j, t, fwd, half_eps, eps_imd), dev,
                        every=NUTS_SYNC_LEAVES)

            # merge the subtree into the trajectory (active chains only)
            ok = active & ~s_turning & ~s_diverged
            p_sub = torch.clamp(torch.exp(s_log_sum_w - log_sum_w), max=1.0)
            take = ok & (merge_u[:, j] < p_sub)
            _where(take, s_prop, z_prop, out=z_prop)
            torch.where(ok, torch.logaddexp(log_sum_w, s_log_sum_w), log_sum_w, out=log_sum_w)
            right, left = ok & go_right, ok & ~go_right
            for end, new, m in ((zr, z, right), (rr, r, right), (gr, g, right),
                                (zl, z, left), (rl, r, left), (gl, g, left)):
                _where(m, new, end, out=end)
            turning_global = _is_turning(zl, rl, zr, rr, imd)
            torch.where(active, s_turning | (ok & turning_global), turning, out=turning)
            torch.where(active, s_diverged, diverged, out=diverged)
            torch.where(active, sum_accept + s_accept, sum_accept, out=sum_accept)
            depth.add_(active.to(torch.int32))

        for j in range(max_tree_depth):
            active.copy_(~turning & ~diverged)
            # the doubling runs while some chain runs its trajectory
            graphs.when(active.any(), lambda j=j: doubling(j))

        moved = (z_prop != z0).any(-1)
        accept_stat = sum_accept / torch.clamp(n_leapfrog.to(z0.dtype), min=1.0)
        return z_prop.reshape(x.shape), moved, diverged, accept_stat, n_leapfrog, depth

    return nuts_step
