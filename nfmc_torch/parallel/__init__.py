from .mesh import (
    chain_mesh,
    constrain_chains,
    replicate,
    shard_chains,
    sharded_sample,
)

__all__ = ["chain_mesh", "shard_chains", "replicate", "constrain_chains", "sharded_sample"]
