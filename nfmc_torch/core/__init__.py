"""Core runtime: sampler bases, driver, sample store, statistics, outputs, RNG."""
from .output import JumpNFMCOutput, MCMCOutput
from .rng import set_seed
from .sampler import MCMCKernel, MCMCParameters, NFMCKernel, NFMCParameters, Sampler
from .samples import MCMCSamples
from .statistics import JumpNFMCStatistics, MCMCStatistics, PTStatistics

__all__ = [
    "JumpNFMCOutput", "MCMCOutput", "set_seed", "MCMCKernel", "MCMCParameters",
    "NFMCKernel", "NFMCParameters", "Sampler", "MCMCSamples", "JumpNFMCStatistics",
    "MCMCStatistics", "PTStatistics",
]
