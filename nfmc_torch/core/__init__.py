"""Core runtime: sampler bases, driver, sample store, statistics, outputs, RNG."""
from .driver import ChunkedScanDriver, StatsAccum, StepInfo, chunk_schedule
from .graphs import disable_graphs
from .output import JumpNFMCOutput, MCMCOutput
from .rng import set_seed
from .sampler import MCMCKernel, MCMCParameters, NFMCKernel, NFMCParameters, Sampler
from .samples import MCMCSamples
from .statistics import (JumpNFMCStatistics, MCMCExpectation, MCMCExpectationDict,
                         MCMCStatistics, PTStatistics)
from .tuning import (DualAveragingParams, DualAveragingState, da_init, da_step, da_value,
                     train_val_split)

__all__ = [
    "ChunkedScanDriver", "StatsAccum", "StepInfo", "chunk_schedule", "disable_graphs",
    "JumpNFMCOutput", "MCMCOutput", "set_seed", "MCMCKernel", "MCMCParameters",
    "NFMCKernel", "NFMCParameters", "Sampler", "MCMCSamples", "JumpNFMCStatistics",
    "MCMCExpectation", "MCMCExpectationDict", "MCMCStatistics", "PTStatistics",
    "DualAveragingParams", "DualAveragingState", "da_init", "da_step", "da_value",
    "train_val_split",
]
