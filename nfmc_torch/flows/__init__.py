"""Normalizing flows: the RealNVP coupling flow and the Flow wrapper."""
from .base import Bijection, Flow
from .convert import from_jax_metropolis_state, from_jax_params
from .coupling import Coupling, RealNVP

__all__ = ["Bijection", "Flow", "Coupling", "RealNVP", "from_jax_params",
           "from_jax_metropolis_state"]
