"""Conditioner networks as plain (init, apply) function pairs: the tanh MLP
of the coupling flows and the MADE network of the masked flows.

Parameters are ``{"w": [...], "b": [...]}`` with ``w[i]`` shaped
``(in, out)``, the layout of ``nfmc_tpu/flows/conditioners.py``. The final
layer starts at zero, so every flow starts as the identity map.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch


def mlp_init(generator: torch.Generator, in_dim: int, hidden: Sequence[int], out_dim: int):
    """He-initialised tanh MLP with a zero-initialised final layer."""
    sizes = [max(in_dim, 1)] + list(hidden) + [out_dim]
    n_layers = len(sizes) - 1
    device = generator.device
    ws, bs = [], []
    for i in range(n_layers):
        if i == n_layers - 1:
            w = torch.zeros((sizes[i], sizes[i + 1]), dtype=torch.float32, device=device)
        else:
            w = torch.randn((sizes[i], sizes[i + 1]), generator=generator,
                            dtype=torch.float32, device=device)
            w = w * math.sqrt(2.0 / sizes[i])
        ws.append(w)
        bs.append(torch.zeros((sizes[i + 1],), dtype=torch.float32, device=device))
    return {"w": ws, "b": bs}


def mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    h = x
    for w, b in zip(params["w"][:-1], params["b"][:-1]):
        h = torch.tanh(h @ w + b)
    return h @ params["w"][-1] + params["b"][-1]


def made_masks(d: int, hidden: Sequence[int], n_params_per_dim: int):
    """MADE's binary masks (numpy, float32), so that output ``i`` depends
    only on the inputs before ``i``: input degrees 1..d, hidden degrees
    cycling 1..d-1 (1 when d == 1), each dim's ``n_params_per_dim`` outputs
    (dim-major) of its input's degree, the last mask strict."""
    degrees = [np.arange(1, d + 1)]
    for h in hidden:
        degrees.append((np.arange(h) % (d - 1)) + 1 if d > 1 else np.ones(h, dtype=np.int64))
    out_deg = np.repeat(np.arange(1, d + 1), n_params_per_dim)
    masks = [(degrees[i][:, None] <= degrees[i + 1][None, :]).astype(np.float32)
             for i in range(len(hidden))]
    masks.append((degrees[-1][:, None] < out_deg[None, :]).astype(np.float32))
    return masks


def made_init(generator: torch.Generator, d: int, hidden: Sequence[int], n_params_per_dim: int):
    """MADE's weights: the MLP of :func:`mlp_init` from ``d`` inputs to
    ``d * n_params_per_dim`` outputs (the masks are config, not weights)."""
    return mlp_init(generator, d, hidden, d * n_params_per_dim)


def made_apply(params, masks, x: torch.Tensor) -> torch.Tensor:
    """(B, d) -> (B, d * n_params_per_dim), autoregressively masked;
    ``masks`` are tensors on ``x``'s device."""
    return mlp_apply(masked_weights(params, masks), x)


def masked_weights(params, masks):
    """The conditioner with each weight times its mask, for reuse across
    the d passes of a masked inverse."""
    return {"w": [w * m for w, m in zip(params["w"], masks)], "b": params["b"]}
