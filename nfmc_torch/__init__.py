"""nfmc-torch: normalizing-flow-assisted MCMC in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

The port of ``nfmc_tpu`` (JAX on a TPU), which stays the reference. Same
module layout and public names; entry points run on CUDA unless the caller
passes ``device="cpu"``. Ported so far: ``sample``/``create_sampler`` for
``jump_mala`` and ``jump_ula`` with a RealNVP, rational-quadratic spline
(``c-rqnsf``) or linear-rational spline (``c-lrsnsf``) coupling flow (frozen,
fitted by the warmup, or refitted with ``fit_nf=True``) and for ``mala`` and
``ula``.
"""
from .api import create_flow_object, create_sampler, parse_flow_string, sample
from .core import (
    JumpNFMCOutput,
    JumpNFMCStatistics,
    MCMCKernel,
    MCMCOutput,
    MCMCParameters,
    MCMCSamples,
    MCMCStatistics,
    NFMCKernel,
    NFMCParameters,
    Sampler,
    set_seed,
)
from .flows import CouplingLRS, CouplingRQNSF, Flow, RealNVP
from .samplers.nfmc import JumpMALA, JumpNFMCParameters, JumpULA

__version__ = "0.1.0"

__all__ = [
    "sample", "create_sampler", "create_flow_object", "parse_flow_string", "set_seed",
    "MCMCOutput", "JumpNFMCOutput", "MCMCStatistics", "JumpNFMCStatistics", "MCMCSamples",
    "MCMCKernel", "MCMCParameters", "NFMCKernel", "NFMCParameters", "Sampler",
    "Flow", "RealNVP", "CouplingRQNSF", "CouplingLRS", "JumpMALA", "JumpULA", "JumpNFMCParameters",
]
