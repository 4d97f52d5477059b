"""Sampler runs over a (chain, data) mesh of ranks on torch.distributed:
chains (or parallel-tempering replicas) over the chain axis, positions over
the data axis (counterpart of ``desman_tpu.parallel``). Auto-length runs on
a mesh are ``converge.run_chains_auto(mesh=...)``. The JAX package's
``shard_counts``, ``shard_keys`` and ``make_*_sweep_sharded`` place arrays
and sweeps on a JAX mesh; a rank here holds its block itself (``Shard``),
so they have no counterpart."""

from .distributed import is_coordinator, launch, maybe_initialize, rank_device
from .mesh import Mesh, make_mesh, pad_positions, pad_tau
from .sharded import (
    Shard, ShardNoise, run_chain_pt_sharded, run_chain_pt_sharded_checkpointed,
    run_chain_sharded_checkpointed, run_chains_sharded,
    run_chains_sharded_checkpointed,
)

__all__ = [
    "Mesh", "Shard", "ShardNoise", "is_coordinator", "launch", "make_mesh",
    "maybe_initialize", "pad_positions", "pad_tau", "rank_device",
    "run_chain_pt_sharded", "run_chain_pt_sharded_checkpointed",
    "run_chain_sharded_checkpointed", "run_chains_sharded",
    "run_chains_sharded_checkpointed",
]
