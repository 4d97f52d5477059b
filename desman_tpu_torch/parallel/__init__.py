"""Sampler runs over a (chain, data) mesh of ranks on torch.distributed:
chains over the chain axis, positions over the data axis (counterpart of
``desman_tpu.parallel``; parallel tempering and auto-length runs on a mesh
are ROADMAP queue 1 item 15)."""

from .distributed import is_coordinator, launch, maybe_initialize, rank_device
from .mesh import Mesh, make_mesh, pad_positions, pad_tau
from .sharded import (
    Shard, ShardNoise, run_chain_sharded_checkpointed, run_chains_sharded,
    run_chains_sharded_checkpointed,
)

__all__ = [
    "Mesh", "Shard", "ShardNoise", "is_coordinator", "launch", "make_mesh",
    "maybe_initialize", "pad_positions", "pad_tau", "rank_device",
    "run_chain_sharded_checkpointed", "run_chains_sharded",
    "run_chains_sharded_checkpointed",
]
