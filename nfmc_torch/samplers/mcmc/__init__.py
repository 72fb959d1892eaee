from .base import (MCMCSampler, MetropolisKernel, MetropolisParameters, MetropolisSampler,
                   MetropolisState)
from .chees import CheesHMC, CheesHMCKernel, CheesHMCParameters, CheesState
from .dense import (DenseHMC, DenseHMCKernel, DenseHMCParameters, DenseLangevinKernel,
                    DenseLangevinParameters, DenseMALA, DenseMetropolisState)
from .ensemble import AIES, AIESKernel, AIESParameters, AIESState
from .ess import ESS, ESSKernel, ESSParameters, ESSState
from .hmc import HMC, UHMC, HMCKernel, HMCParameters
from .langevin import MALA, ULA, Langevin, LangevinKernel, LangevinParameters
from .mh import MH, MHKernel, MHParameters, RandomWalk
from .nuts import NUTS, NUTSKernel, NUTSParameters
from .pt import PTHMC, PTMALA, PTRWMH, ParallelTempering, PTKernel, PTParameters, PTState

__all__ = ["MCMCSampler", "MetropolisKernel", "MetropolisParameters", "MetropolisSampler",
           "MetropolisState",
           "Langevin", "LangevinKernel", "LangevinParameters", "MALA", "ULA",
           "HMC", "UHMC", "HMCKernel", "HMCParameters", "MH", "MHKernel", "MHParameters",
           "RandomWalk", "ESS", "ESSKernel", "ESSParameters", "ESSState", "NUTS", "NUTSKernel",
           "NUTSParameters", "CheesHMC", "CheesHMCKernel", "CheesHMCParameters", "CheesState",
           "PTHMC", "PTMALA", "PTRWMH", "ParallelTempering", "PTKernel", "PTParameters",
           "PTState", "AIES", "AIESKernel", "AIESParameters", "AIESState", "DenseHMC",
           "DenseHMCKernel", "DenseHMCParameters", "DenseMALA", "DenseLangevinKernel",
           "DenseLangevinParameters", "DenseMetropolisState"]
