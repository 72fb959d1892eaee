"""Transport / annealing algorithms (counterpart of ``nfmc_tpu/transport``;
reference L5, SURVEY.md section 2.7).

The reference ships these partially broken (AFT calls a module as a function,
CRAFT calls a nonexistent signature, SNF's MCMC layers crash, nested sampling
references an undefined helper: ``transport/annealed_flow_transport.py:120-128``,
``:355-363``, ``stochastic_normalizing_flows.py:72-87``, ``nested.py:26``).
These are the JAX package's corrected versions, in eager PyTorch; the flows
run on the coupling kernels on CUDA.
"""
from . import ais, common
from .aft import AnnealedFlowTransport, aft
from .craft import CRAFT, craft
from .ns import NestedSampling, ns
from .pmc import PreconditionedMonteCarlo, pmc
from .snf import SNF, snf

__all__ = [
    "AnnealedFlowTransport", "aft",
    "CRAFT", "craft",
    "SNF", "snf",
    "NestedSampling", "ns",
    "PreconditionedMonteCarlo", "pmc",
]
