from .registry import (create_flow_object, get_supported_mcmc_samplers,
                       get_supported_nfmc_samplers, get_supported_normalizing_flows,
                       get_supported_samplers, parse_flow_string)
from .sample import create_sampler, sample

__all__ = ["create_flow_object", "parse_flow_string", "create_sampler", "sample",
           "get_supported_samplers", "get_supported_mcmc_samplers", "get_supported_nfmc_samplers",
           "get_supported_normalizing_flows"]
