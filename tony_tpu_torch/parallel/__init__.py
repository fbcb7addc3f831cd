"""Parallelism layer of the port: meshes, logical-axis sharding rules,
the local-shard execution of a sharded step (dp, fsdp, tp, ep, cp, pp),
mixture-of-experts routing, context-parallel attention and pipelines.

Port of ``tony_tpu/parallel/``: a mesh is a ``DeviceMesh`` over every
process, parameters are DTensors laid out by the rules, and a step runs
on local shards with explicit collectives
(:mod:`tony_tpu_torch.parallel.spmd`); MoE dispatch is
:mod:`tony_tpu_torch.parallel.moe` (on a pipeline stage's layout it is
the reference's ``moe_ffn_manual``), ring and Ulysses attention over cp
:mod:`~tony_tpu_torch.parallel.ring_attention` and
:mod:`~tony_tpu_torch.parallel.ulysses`, GPipe, 1F1B and the
cross-slice 1F1B over pp :mod:`~tony_tpu_torch.parallel.pipeline`.
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
