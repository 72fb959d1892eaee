from .imh import AbstractIMH, AdaptiveIMH, FixedIMH, IMHKernel, IMHParameters, sample_bounded_geom
from .jump import JumpMALA, JumpNFMC, JumpNFMCParameters, JumpULA

__all__ = ["AbstractIMH", "FixedIMH", "AdaptiveIMH", "IMHKernel", "IMHParameters",
           "sample_bounded_geom", "JumpNFMC", "JumpNFMCParameters", "JumpMALA", "JumpULA"]
