"""Normalizing flows: the coupling flows (RealNVP, NICE, the RQS and LRS
splines, the NAF couplings), the masked and inverse-masked autoregressive
flows, the residual and continuous flows, the multiscale / Glow image flows
and the convolutional residual and continuous flows, ``Chain`` /
``Inverse`` and the Flow wrapper."""
from .base import Bijection, Chain, Flow, Inverse, hutchinson_probes
from .continuous import FFJORD, RNODE, ContinuousFlow, DeepDiffeomorphicBijection, OTFlow
from .convert import from_jax_metropolis_state, from_jax_params
from .coupling import NICE, Coupling, CouplingLRS, CouplingRQNSF, RealNVP
from .masked import (
    IAF,
    MAF,
    InverseAutoregressiveLRS,
    InverseAutoregressiveRQNSF,
    MaskedAutoregressive,
    MaskedAutoregressiveLRS,
    MaskedAutoregressiveRQNSF,
)
from .multiscale import (
    AffineGlow,
    ConvolutionalDDB,
    ConvolutionalFFJORD,
    ConvolutionalInvertibleResNet,
    ConvolutionalResFlow,
    ConvolutionalRNODE,
    DeepDenseSigmoidGlow,
    DeepSigmoidGlow,
    DenseSigmoidGlow,
    LRSGlow,
    MultiscaleDeepDenseSigmoid,
    MultiscaleDeepSigmoid,
    MultiscaleDenseSigmoid,
    MultiscaleFlow,
    MultiscaleLRSNSF,
    MultiscaleNICE,
    MultiscaleRealNVP,
    MultiscaleRQNSF,
    RQSGlow,
    ShiftGlow,
)
from .naf import (
    CouplingDeepDenseSF,
    CouplingDeepSF,
    CouplingDenseSF,
    InverseAutoregressiveDeepDenseSF,
    InverseAutoregressiveDeepSF,
    InverseAutoregressiveDenseSF,
    MaskedAutoregressiveDeepDenseSF,
    MaskedAutoregressiveDeepSF,
    MaskedAutoregressiveDenseSF,
)
from .residual import (
    InvertibleResNet,
    PlanarFlow,
    ProximalResFlow,
    RadialFlow,
    ResFlow,
    SylvesterFlow,
)
from .train import fit, variational_fit

__all__ = [
    "Bijection", "Chain", "Inverse", "Flow", "hutchinson_probes", "Coupling", "RealNVP", "NICE",
    "CouplingRQNSF", "CouplingLRS", "MaskedAutoregressive", "MAF", "IAF",
    "MaskedAutoregressiveRQNSF", "MaskedAutoregressiveLRS", "InverseAutoregressiveRQNSF",
    "InverseAutoregressiveLRS", "CouplingDeepSF", "CouplingDenseSF", "CouplingDeepDenseSF",
    "MaskedAutoregressiveDeepSF", "MaskedAutoregressiveDenseSF", "MaskedAutoregressiveDeepDenseSF",
    "InverseAutoregressiveDeepSF", "InverseAutoregressiveDenseSF",
    "InverseAutoregressiveDeepDenseSF", "PlanarFlow", "RadialFlow", "SylvesterFlow",
    "InvertibleResNet", "ResFlow", "ProximalResFlow", "ContinuousFlow", "FFJORD", "RNODE",
    "DeepDiffeomorphicBijection", "OTFlow", "MultiscaleFlow", "MultiscaleRealNVP", "MultiscaleNICE",
    "MultiscaleRQNSF", "MultiscaleLRSNSF", "MultiscaleDeepSigmoid", "MultiscaleDenseSigmoid",
    "MultiscaleDeepDenseSigmoid", "AffineGlow", "ShiftGlow", "RQSGlow", "LRSGlow",
    "DeepSigmoidGlow", "DenseSigmoidGlow", "DeepDenseSigmoidGlow",
    "ConvolutionalInvertibleResNet", "ConvolutionalResFlow", "ConvolutionalFFJORD",
    "ConvolutionalRNODE", "ConvolutionalDDB", "fit", "variational_fit", "from_jax_params",
    "from_jax_metropolis_state",
]
