"""nfmc-torch: normalizing-flow-assisted MCMC in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

The port of ``nfmc_tpu`` (JAX on a TPU), which stays the reference. Same
module layout and public names; entry points run on CUDA unless the caller
passes ``device="cpu"``. ``sample``/``create_sampler`` run every strategy of
``nfmc_tpu``'s registry: ``imh`` (the default; ``fixed_imh``) and
``adaptive_imh``, with the reverse-KL warmup; the jump samplers
(``jump_mala``, ``jump_ula``, ``jump_hmc``, ``jump_uhmc``, ``jump_mh``,
``jump_ess``, ``jump_nuts``, ``jump_chees``, ``jump_aies``) with any
ported flow (frozen, fitted by the warmup, or refitted with
``fit_nf=True``); the flow-reparameterised ``neutra_hmc``, ``neutra_mh`` and
``neutra_chees``, ``tess`` and ``dlmc``; and ``mala``, ``ula``, ``hmc``,
``uhmc``, ``mh``, ``ess``, ``nuts``, ``chees_hmc``, ``dense_hmc``,
``dense_mala``, ``pt_mala``, ``pt_mh``, ``pt_hmc`` and ``aies``. The
ported flows: RealNVP and the coupling splines ``c-rqnsf`` / ``c-lrsnsf``
(on the CUDA kernels), NICE, MAF / IAF and the masked splines, the nine NAF
flows, the six residual flows, the continuous flows (FFJORD, RNODE,
OT-Flow, DDB), the multiscale / Glow image flows and the convolutional
residual and continuous flows (plain PyTorch on every device, as the JAX
package runs them through XLA): all 48 names of the registry, with
``Chain`` and ``Inverse``. Also the ESS and R-hat diagnostics, every
potential of ``nfmc_tpu.potentials``, ``checkpoint`` (resumable runs:
``sample(..., checkpoint_path=...)``), the evidence estimators of
``transport`` (AIS, AFT, CRAFT, PMC, nested sampling, SNF) and
``flow_training``'s FAB, and, loaded on first access, ``parallel``
(chain-sharded sampling and data-parallel fits over a ``torch.distributed``
``DeviceMesh``), ``profiling`` (``torch.profiler`` traces and NVTX spans) and
``validation``.
"""
import importlib

from .api import (create_flow_object, create_sampler, get_supported_mcmc_samplers,
                  get_supported_nfmc_samplers, get_supported_normalizing_flows,
                  get_supported_samplers, parse_flow_string, sample)
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
from . import checkpoint, diagnostics, flow_training, potentials, transport
from .flows import (IAF, MAF, NICE, Chain, CouplingLRS, CouplingRQNSF, Flow, Inverse,
                    InvertibleResNet, PlanarFlow, ProximalResFlow, RadialFlow, RealNVP, ResFlow,
                    SylvesterFlow)
from .samplers.mcmc import (AIES, ESS, HMC, MALA, MH, NUTS, PTHMC, PTMALA, PTRWMH, UHMC, ULA,
                            CheesHMC, DenseHMC, DenseMALA)
from .samplers.nfmc import (
    DLMC,
    TESS,
    AdaptiveIMH,
    FixedIMH,
    IMHKernel,
    IMHParameters,
    JumpAIES,
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
    "get_supported_samplers", "get_supported_mcmc_samplers", "get_supported_nfmc_samplers",
    "get_supported_normalizing_flows",
    "MCMCOutput", "JumpNFMCOutput", "MCMCStatistics", "JumpNFMCStatistics", "MCMCSamples",
    "MCMCKernel", "MCMCParameters", "NFMCKernel", "NFMCParameters", "Sampler",
    "Flow", "RealNVP", "CouplingRQNSF", "CouplingLRS", "NICE", "MAF", "IAF", "Chain", "Inverse",
    "PlanarFlow", "RadialFlow", "SylvesterFlow", "InvertibleResNet", "ResFlow", "ProximalResFlow",
    "JumpMALA", "JumpULA", "JumpNFMCParameters",
    "FixedIMH", "AdaptiveIMH", "IMHKernel", "IMHParameters", "checkpoint", "diagnostics",
    "potentials", "transport", "flow_training",
    "MALA", "ULA", "HMC", "UHMC", "MH", "JumpHMC", "JumpUHMC", "JumpMH", "NeuTraHMC",
    "NeuTraMH", "TESS", "DLMC", "ESS", "NUTS", "CheesHMC", "JumpESS", "JumpNUTS", "JumpChEES",
    "NeuTraChEES", "DenseHMC", "DenseMALA", "PTMALA", "PTRWMH", "PTHMC", "AIES", "JumpAIES",
]

# submodules loaded on first access, as in nfmc_tpu (importing the package
# starts no process group)
_LAZY_MODULES = ("parallel", "profiling", "validation")


def __getattr__(name):
    if name in _LAZY_MODULES:
        return importlib.import_module("." + name, __name__)
    raise AttributeError(f"module 'nfmc_torch' has no attribute {name}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY_MODULES))
