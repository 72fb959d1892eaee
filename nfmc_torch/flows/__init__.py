"""Normalizing flows: the coupling flows (RealNVP, NICE, the RQS and LRS
splines, the NAF couplings), the masked and inverse-masked autoregressive
flows, the residual flows, ``Chain`` / ``Inverse`` and the Flow wrapper."""
from .base import Bijection, Chain, Flow, Inverse, hutchinson_probes
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
    "InvertibleResNet", "ResFlow", "ProximalResFlow", "fit", "variational_fit",
    "from_jax_params", "from_jax_metropolis_state",
]
