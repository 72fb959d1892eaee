from .base import MCMCSampler, MetropolisKernel, MetropolisParameters, MetropolisState
from .chees import CheesHMC, CheesHMCKernel, CheesHMCParameters, CheesState
from .ess import ESS, ESSKernel, ESSParameters, ESSState
from .hmc import HMC, UHMC, HMCKernel, HMCParameters
from .langevin import MALA, ULA, Langevin, LangevinKernel, LangevinParameters
from .mh import MH, MHKernel, MHParameters, RandomWalk
from .nuts import NUTS, NUTSKernel, NUTSParameters

__all__ = ["MCMCSampler", "MetropolisKernel", "MetropolisParameters", "MetropolisState",
           "Langevin", "LangevinKernel", "LangevinParameters", "MALA", "ULA",
           "HMC", "UHMC", "HMCKernel", "HMCParameters", "MH", "MHKernel", "MHParameters",
           "RandomWalk", "ESS", "ESSKernel", "ESSParameters", "ESSState", "NUTS", "NUTSKernel",
           "NUTSParameters", "CheesHMC", "CheesHMCKernel", "CheesHMCParameters", "CheesState"]
