"""Parallelism layer of the port: meshes, logical-axis sharding rules,
the local-shard execution of a sharded step (dp, fsdp, tp, ep, cp),
mixture-of-experts routing and context-parallel attention.

Port of ``tony_tpu/parallel/`` as far as dp, fsdp, tp, ep and cp go: a
mesh is a ``DeviceMesh`` over every process, parameters are DTensors
laid out by the rules, and a step runs on local shards with explicit
collectives (:mod:`tony_tpu_torch.parallel.spmd`); MoE dispatch is
:mod:`tony_tpu_torch.parallel.moe`, ring and Ulysses attention over cp
:mod:`~tony_tpu_torch.parallel.ring_attention` and
:mod:`~tony_tpu_torch.parallel.ulysses`. pp (pipelines, and the MoE arm
they run, ``moe_ffn_manual``) is not ported.
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
