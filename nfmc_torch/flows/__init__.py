"""Normalizing flows: the coupling flows (RealNVP and the RQS and LRS spline
flows) and the Flow wrapper."""
from .base import Bijection, Flow
from .convert import from_jax_metropolis_state, from_jax_params
from .coupling import Coupling, CouplingLRS, CouplingRQNSF, RealNVP

__all__ = ["Bijection", "Flow", "Coupling", "RealNVP", "CouplingRQNSF", "CouplingLRS",
           "from_jax_params", "from_jax_metropolis_state"]
