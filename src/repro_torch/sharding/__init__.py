"""Sharding rules and their execution across ranks.

rules.py      the reference's profiles, the parameter rules table,
              ``use_rules`` / ``current_rules``, ``param_pspecs``
placement.py  this rank's slice of a leaf, the gather back, the sharded
              init, a batch's slab, ``NamedSharding`` for checkpoints

The collectives the model runs across ranks are in
``core.collectives`` (``MeshComm``).
"""

from .rules import (AXIS_DATA, AXIS_MODEL, AXIS_POD, ShardingRules,
                    check_executable, current_rules, fsdp_dim,
                    leaf_pspecs, mesh_sizes, param_pspecs, shard, use_rules)

__all__ = ["AXIS_POD", "AXIS_DATA", "AXIS_MODEL", "ShardingRules",
           "use_rules", "current_rules", "shard", "param_pspecs",
           "leaf_pspecs", "mesh_sizes", "check_executable", "fsdp_dim"]
