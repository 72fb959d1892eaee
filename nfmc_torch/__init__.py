"""nfmc-torch: normalizing-flow-assisted MCMC in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

The port of ``nfmc_tpu`` (JAX on a TPU), which stays the reference. Same
module layout and public names; entry points run on CUDA unless the caller
passes ``device="cpu"``. Ported so far: ``sample``/``create_sampler`` for
``imh`` (the default; ``fixed_imh``) and ``adaptive_imh``, with the
reverse-KL warmup, for ``jump_mala`` and ``jump_ula`` with a RealNVP,
rational-quadratic spline (``c-rqnsf``) or linear-rational spline
(``c-lrsnsf``) coupling flow (frozen, fitted by the warmup, or refitted with
``fit_nf=True``), for ``jump_hmc``, ``jump_uhmc``, ``jump_mh``, ``jump_ess``,
``jump_nuts`` and ``jump_chees``, for the flow-reparameterised
``neutra_hmc``, ``neutra_mh`` and ``neutra_chees``, ``tess`` and ``dlmc``,
and for ``mala``, ``ula``, ``hmc``, ``uhmc``, ``mh``, ``ess``, ``nuts`` and
``chees_hmc``; the ESS and R-hat diagnostics; every potential of
``nfmc_tpu.potentials``.
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
from . import diagnostics, potentials
from .flows import CouplingLRS, CouplingRQNSF, Flow, RealNVP
from .samplers.mcmc import ESS, HMC, MALA, MH, NUTS, UHMC, ULA, CheesHMC
from .samplers.nfmc import (
    DLMC,
    TESS,
    AdaptiveIMH,
    FixedIMH,
    IMHKernel,
    IMHParameters,
    JumpChEES,
    JumpESS,
    JumpHMC,
    JumpMALA,
    JumpMH,
    JumpNFMCParameters,
    JumpNUTS,
    JumpUHMC,
    JumpULA,
    NeuTraChEES,
    NeuTraHMC,
    NeuTraMH,
)

__version__ = "0.1.0"

__all__ = [
    "sample", "create_sampler", "create_flow_object", "parse_flow_string", "set_seed",
    "MCMCOutput", "JumpNFMCOutput", "MCMCStatistics", "JumpNFMCStatistics", "MCMCSamples",
    "MCMCKernel", "MCMCParameters", "NFMCKernel", "NFMCParameters", "Sampler",
    "Flow", "RealNVP", "CouplingRQNSF", "CouplingLRS", "JumpMALA", "JumpULA", "JumpNFMCParameters",
    "FixedIMH", "AdaptiveIMH", "IMHKernel", "IMHParameters", "diagnostics", "potentials",
    "MALA", "ULA", "HMC", "UHMC", "MH", "JumpHMC", "JumpUHMC", "JumpMH", "NeuTraHMC",
    "NeuTraMH", "TESS", "DLMC", "ESS", "NUTS", "CheesHMC", "JumpESS", "JumpNUTS", "JumpChEES",
    "NeuTraChEES",
]
