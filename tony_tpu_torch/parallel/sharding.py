"""Logical-axis sharding rules: names in models, meshes at run time.

Port of ``tony_tpu/parallel/sharding.py``. Models name the axes of their
arrays with *logical* names (``"batch"``, ``"embed"``, ``"heads"``, ...);
a rule table maps each name to mesh axes. The resolution is the JAX
package's, written as pure functions of the mesh's shape and names
(:func:`logical_to_spec` takes a ``DeviceMesh`` or an ordered dict of axis
sizes), so tests compare it with JAX's ``logical_to_spec`` with no process
group. A spec is a tuple with one entry per array dimension, ``None``, a
mesh axis name or a tuple of names, like a ``PartitionSpec``.

The JAX package hands the spec to XLA as a ``NamedSharding``. Here a spec
becomes DTensor placements over the mesh (:func:`spec_placements`):
``Shard(dim)`` on each mesh dimension the spec names for ``dim``,
``Replicate()`` elsewhere. :func:`shard_pytree` lays a parameter tree out
that way with ``distribute_tensor``; :func:`constrain` redistributes a
DTensor to a logical layout; :func:`attention_spec` names the live axes
of the context-parallel attention operands. The reference's ``psum_rep``
(all-reduce forward, identity backward) is ``spmd._SumOver``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from tony_tpu_torch.parallel.mesh import mesh_shape

Rules = Sequence[tuple[str, "str | tuple[str, ...] | None"]]

# First matching rule wins; a mesh axis absent from the mesh (or of size
# 1) resolves to replication.
DEFAULT_RULES: Rules = (
    ("batch", ("dp", "fsdp")),       # batch over dp and fsdp jointly
    ("seq", "cp"),                   # context parallelism: sequence split
    ("embed", "fsdp"),               # FSDP shards params on the embed dim
    ("heads", "tp"),                 # attention heads over tensor axis
    ("kv", None),                    # per-head dim: never sharded
    ("mlp", "tp"),                   # MLP hidden over tensor axis
    ("vocab", "tp"),                 # embedding/logits vocab over tensor axis
    ("expert", "ep"),                # MoE experts over expert axis
    ("stage", "pp"),                 # pipeline stages
    ("norm", None),
)


def _resolve(logical: str | None, rules: Rules, shape: dict[str, int],
             used: set[str]):
    """Mesh axes of one logical name: the first matching rule's targets
    that are in the mesh, of size > 1 and not taken by an earlier
    dimension of the same array (earlier dimensions win)."""
    if logical is None:
        return None
    for name, target in rules:
        if name == logical:
            if target is None:
                return None
            targets = (target,) if isinstance(target, str) else tuple(target)
            live = tuple(t for t in targets
                         if shape.get(t, 1) > 1 and t not in used)
            if not live:
                return None
            used.update(live)
            return live if len(live) > 1 else live[0]
    return None


def logical_to_spec(logical_axes: Sequence[str | None], mesh,
                    rules: Rules = DEFAULT_RULES) -> tuple:
    """``("batch", "embed")`` → ``(("dp", "fsdp"), None)`` on a
    dp × fsdp mesh: one entry per dimension, dropping mesh axes that are
    absent, of size 1, or already used by an earlier dimension."""
    shape = mesh_shape(mesh)
    used: set[str] = set()
    return tuple(_resolve(ax, rules, shape, used) for ax in logical_axes)


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_placements(spec: tuple, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh dimension that entry ``d`` names, ``Replicate()`` on the rest.
    A dimension split over several mesh axes is split in mesh order (the
    first mesh dimension major), which is the spec's order whenever the
    rules list axes in :data:`~tony_tpu_torch.parallel.mesh.AXIS_ORDER`;
    another order raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_shape(mesh))
    placements = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise NotImplementedError(
                f"dimension {dim} is split over {axes}, against the mesh "
                f"order {tuple(names)}")
        for i in idx:
            placements[i] = Shard(dim)
    return placements


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A layout: a mesh and a spec (the counterpart of a
    ``NamedSharding``). The spec covers the leading dimensions of an
    array; the rest are replicated."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> list:
        return spec_placements(self.spec, self.mesh)


def logical_sharding(logical_axes: Sequence[str | None], mesh,
                     rules: Rules = DEFAULT_RULES) -> Sharding:
    return Sharding(mesh, logical_to_spec(logical_axes, mesh, rules))


def is_axes_leaf(x: Any) -> bool:
    """A leaf of a logical-axes tree: None, or a tuple of names/None."""
    return x is None or (isinstance(x, tuple) and all(
        e is None or isinstance(e, str) for e in x))


def param_shardings(logical_tree: Any, mesh,
                    rules: Rules = DEFAULT_RULES) -> Any:
    """A logical-axes tree (nested dicts) → a tree of :class:`Sharding`."""
    if is_axes_leaf(logical_tree):
        return logical_sharding(logical_tree or (), mesh, rules)
    return {k: param_shardings(v, mesh, rules)
            for k, v in logical_tree.items()}


def shard_pytree(tree: Any, logical_tree: Any, mesh,
                 rules: Rules = DEFAULT_RULES) -> Any:
    """Every tensor leaf of ``tree`` as a DTensor laid out by its logical
    axes in ``logical_tree`` (the same nested dicts). Every rank passes
    the same values (the JAX package's ``device_put`` contract): each
    leaf is scattered from rank 0."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return {k: shard_pytree(v, logical_tree[k], mesh, rules)
                for k, v in tree.items()}
    return distribute_tensor(
        tree, mesh, logical_sharding(logical_tree or (), mesh,
                                     rules).placements)


def constrain(x, logical_axes: Sequence[str | None], mesh=None,
              rules: Rules = DEFAULT_RULES):
    """Redistribute a DTensor to the layout of ``logical_axes`` (on its
    own mesh unless ``mesh`` is given); a plain tensor is returned as it
    is, as the JAX package's ``constrain`` is a no-op without a mesh."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh if mesh is None else mesh
    return x.redistribute(mesh, logical_sharding(logical_axes, mesh,
                                                 rules).placements)


def attention_spec(mesh, batch_axes: Sequence[str], seq_axis: str | None,
                   head_axis: str | None) -> tuple:
    """The live axes of ``[B, S, H, D]`` attention operands: ``(batch
    axes, seq axis, head axis)`` — the live subset of ``batch_axes`` (a
    tuple, maybe empty), then ``seq_axis`` and ``head_axis`` or None
    where absent from the mesh or of size 1. The JAX package returns
    these as a ``PartitionSpec`` for ``shard_map``; the port's ring and
    Ulysses wrappers cut their operands by them."""
    shape = mesh_shape(mesh)
    live = lambda a: a is not None and shape.get(a, 1) > 1
    return (tuple(a for a in batch_axes if live(a)),
            seq_axis if live(seq_axis) else None,
            head_axis if live(head_axis) else None)
