from .dlmc import DLMC, DLMCKernel, DLMCParameters
from .imh import AbstractIMH, AdaptiveIMH, FixedIMH, IMHKernel, IMHParameters, sample_bounded_geom
from .jump import (JumpAIES, JumpChEES, JumpESS, JumpHMC, JumpMALA, JumpMH, JumpNFMC,
                   JumpNFMCParameters, JumpNUTS, JumpUHMC, JumpULA)
from .neutra import NeuTra, NeuTraChEES, NeuTraHMC, NeuTraKernel, NeuTraMH, NeuTraParameters
from .tess import TESS, TESSKernel, TESSParameters, make_tess_step

__all__ = ["AbstractIMH", "FixedIMH", "AdaptiveIMH", "IMHKernel", "IMHParameters",
           "sample_bounded_geom", "JumpNFMC", "JumpNFMCParameters", "JumpMALA", "JumpULA",
           "JumpHMC", "JumpUHMC", "JumpMH", "JumpESS", "JumpNUTS", "JumpChEES", "JumpAIES", "NeuTra",
           "NeuTraHMC", "NeuTraMH", "NeuTraChEES",
           "NeuTraKernel", "NeuTraParameters", "TESS", "TESSKernel", "TESSParameters",
           "make_tess_step", "DLMC", "DLMCKernel", "DLMCParameters"]
