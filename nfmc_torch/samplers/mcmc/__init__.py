from .base import MCMCSampler, MetropolisKernel, MetropolisParameters, MetropolisState
from .hmc import HMC, UHMC, HMCKernel, HMCParameters
from .langevin import MALA, ULA, Langevin, LangevinKernel, LangevinParameters
from .mh import MH, MHKernel, MHParameters, RandomWalk

__all__ = ["MCMCSampler", "MetropolisKernel", "MetropolisParameters", "MetropolisState",
           "Langevin", "LangevinKernel", "LangevinParameters", "MALA", "ULA",
           "HMC", "UHMC", "HMCKernel", "HMCParameters", "MH", "MHKernel", "MHParameters",
           "RandomWalk"]
