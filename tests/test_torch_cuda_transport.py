"""The transport layer and FAB captured on the card (marker ``cuda``): they
skip without one; run them there with
``python -m pytest --noconftest tests/test_torch_cuda_transport.py``.

FAB's iterations and the AIS chain's levels replay a captured CUDA graph,
bit for bit against the eager loop (``graphs.disable_graphs``), with equal
launch counts; a second FAB run of the same shapes replays the graph the
first captured. (The CPU tests of the same protocol without capture:
``tests/test_torch_transport_graph.py``.)"""
import contextlib

import numpy as np
import pytest
import torch

from nfmc_torch.core import graphs
from nfmc_torch.flow_training import FAB
from nfmc_torch.flows import Flow, RealNVP
from nfmc_torch.ops import build
from nfmc_torch.potentials import DiagonalGaussian, StandardGaussian
from nfmc_torch.transport.ais import make_ais
from nfmc_torch.utils import tree_leaves, tree_map

pytestmark = pytest.mark.cuda

D = 4
PRIOR = StandardGaussian((D,))
TARGET = DiagonalGaussian(mu=np.full(D, 2.0), sigma=np.full(D, 0.5))
FAB_KW = dict(n_flow_training_steps=3, n_ais_particles=24, n_training_particles=10)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these graphs are captured on the card")
    return torch.device("cuda")


def _flow(dev):
    flow = Flow(RealNVP((D,), n_layers=2, hidden_size=8), seed=0)
    g = torch.Generator().manual_seed(100)
    flow.params = tree_map(lambda v: v + 0.2 * torch.randn(v.shape, generator=g), flow.params)
    return flow.to(dev)


def _flat(params):
    return torch.cat([v.reshape(-1) for v in tree_leaves(params)])


def test_fab_captures_on_the_card(cuda):
    def run(ctx):
        alg = FAB(TARGET, _flow(cuda), buffer_size=64, n_ais_steps=3, n_mcmc_steps=2)
        build.reset_launch_counts()
        with ctx:
            alg.run(n_iterations=3, seed=0, **FAB_KW)
            alg.run(n_iterations=3, seed=1, **FAB_KW)
        torch.cuda.synchronize()
        return alg, {w.__name__: w.launches for w in build.WRAPPERS}

    eager, le = run(graphs.disable_graphs())
    graphed, lg = run(contextlib.nullcontext())
    assert "_graphs" not in vars(eager)
    (graph,) = graphed._graphs.values()
    # 6 iterations: the first eager, the other five replays of one capture
    assert graph.captured and graph.replays == 5
    # a gradient a MALA evaluation (3 levels of 2 steps and the start's) and
    # a replay step, each iteration
    assert le == lg and lg["fused_realnvp_vjp"] == 6 * (3 * 3 + FAB_KW["n_flow_training_steps"])
    assert torch.equal(_flat(eager.flow.params), _flat(graphed.flow.params))
    assert torch.equal(eager.loss_trace, graphed.loss_trace)
    for a, b in zip(eager._buf_state, graphed._buf_state):
        assert torch.equal(a, b)
    assert (int(graphed._buf_state[3]), int(graphed._buf_state[4])) == (6 * 24 % 64, 64)


def test_ais_chain_captures_on_the_card(cuda):
    chain = make_ais(PRIOR, TARGET, n_steps=8, n_mcmc_steps=2, step_size=0.1)

    def run(ctx):
        g = torch.Generator(device=cuda).manual_seed(0)
        x0 = PRIOR.sample((64,), generator=g)
        with ctx:
            out = chain(x0, chain.draws(g, tuple(x0.shape)))
        torch.cuda.synchronize()
        return out

    x_e, lw_e = run(graphs.disable_graphs())
    x_g, lw_g = run(contextlib.nullcontext())
    (graph,) = chain._graphs.values()
    assert graph.captured and graph.replays == 7
    assert torch.equal(x_e, x_g) and torch.equal(lw_e, lw_g)
