"""Logical-axis sharding on ``DeviceMesh`` / DTensor (the JAX package's
``sharding``), and the helper that runs kernels on local shards."""
from .rules import (AbstractMesh, AxisRules, DEFAULT_RULES, PartitionSpec,
                    best_spec, current_rules, distribute, gather_fsdp,
                    logical_shard,
                    mesh_shape, named_sharding, param_spec, placements,
                    shard_tree, spec_leaves, use_rules)

__all__ = ["AbstractMesh", "AxisRules", "DEFAULT_RULES", "PartitionSpec",
           "best_spec", "current_rules", "distribute", "gather_fsdp",
           "logical_shard",
           "mesh_shape", "named_sharding", "param_spec", "placements",
           "shard_tree", "spec_leaves", "use_rules"]
