"""Parallelism layer of the port: meshes, logical-axis sharding rules,
and the local-shard execution of a sharded step (dp, fsdp, tp).

Port of ``tony_tpu/parallel/`` as far as dp, fsdp and tp go: a mesh is a
``DeviceMesh`` over every process, parameters are DTensors laid out by
the rules, and a step runs on local shards with explicit collectives
(:mod:`tony_tpu_torch.parallel.spmd`). cp (ring and Ulysses attention),
pp (pipelines) and ep (MoE) are not ported.
"""

from tony_tpu_torch.parallel.mesh import (AXIS_ORDER, PRESETS,
                                          make_hybrid_mesh, make_mesh,
                                          mesh_shape, parse_mesh_string)
from tony_tpu_torch.parallel.sharding import (DEFAULT_RULES, Sharding,
                                              constrain, logical_sharding,
                                              logical_to_spec,
                                              param_shardings, shard_pytree)

__all__ = [
    "AXIS_ORDER",
    "DEFAULT_RULES",
    "PRESETS",
    "Sharding",
    "constrain",
    "logical_sharding",
    "logical_to_spec",
    "make_hybrid_mesh",
    "make_mesh",
    "mesh_shape",
    "param_shardings",
    "parse_mesh_string",
    "shard_pytree",
]
