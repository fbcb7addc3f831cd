"""Device meshes over every process, and their named presets.

Port of ``tony_tpu/parallel/mesh.py``. A mesh names the parallelism axes
of a job — ``dp`` (batch split), ``fsdp`` (batch and params split),
``tp`` (heads and MLP split inside a layer), and ``cp``, ``pp``, ``ep``,
which the port does not run yet — and lays every process of the job out
on them. Here it is a ``torch.distributed.device_mesh.DeviceMesh`` with
those dimension names over all ranks, one card (or one CPU process) per
rank; the JAX package builds a ``jax.sharding.Mesh`` over all devices.

The layout rules are the JAX package's, kept in pure functions
(:func:`mesh_layout`, :func:`hybrid_mesh_layout`) that tests compare with
the JAX meshes without a process group: the canonical order
:data:`AXIS_ORDER`, at most one axis inferred (``-1`` or ``0``) from the
process count, size-1 axes kept, empty axes giving ``{"dp": n}``. Ranks
fill the mesh in row-major order, as the JAX package reshapes its device
list.
"""

from __future__ import annotations

import math

import torch

AXIS_ORDER = ("pp", "dp", "fsdp", "cp", "ep", "tp")
"""Canonical major→minor order. tp, the most latency-sensitive group, is
minor-most (neighbouring ranks); pp, the least chatty, is major."""


def _infer(axes: dict[str, int], n: int, what: str, count: str) -> dict:
    """``axes`` with its one ``-1``/``0`` size (if any) set so the sizes
    multiply to ``n``; raises on two inferred axes or an indivisible
    count."""
    axes = dict(axes)
    unknown = [k for k, v in axes.items() if v in (-1, 0)]
    known = math.prod(v for v in axes.values() if v not in (-1, 0))
    if len(unknown) == 1:
        if n % known:
            raise ValueError(f"cannot infer {unknown[0]}: {n} {count} not "
                             f"divisible by {known}")
        axes[unknown[0]] = n // known
    elif len(unknown) > 1:
        raise ValueError(f"at most one inferred (-1) {what} axis: {axes}")
    return axes


def _ordered(axes: dict[str, int]) -> tuple[str, ...]:
    """Canonical order first, then custom axes in declaration order."""
    names = tuple(a for a in AXIS_ORDER if a in axes)
    return names + tuple(a for a in axes if a not in names)


def mesh_layout(axes: dict[str, int] | None, n: int,
                axis_order: tuple[str, ...] | None = None
                ) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """``(names, shape)`` of the mesh :func:`make_mesh` builds over ``n``
    processes, by the JAX package's ``make_mesh`` rules."""
    axes = dict(axes or {}) or {"dp": n}
    axes = _infer(axes, n, "mesh", "devices")
    total = math.prod(axes.values())
    if total != n:
        raise ValueError(f"mesh axes {axes} require {total} devices, "
                         f"have {n}")
    names = _ordered(axes) if axis_order is None else tuple(axis_order)
    return names, tuple(axes[name] for name in names)


def hybrid_mesh_layout(ici_axes: dict[str, int] | None,
                       dcn_axes: dict[str, int], n: int
                       ) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """``(names, shape)`` of a mesh spanning slices: the ``dcn_axes``
    major (across slices, explicit sizes whose product is the slice
    count), the ``ici_axes`` minor (within a slice, one of them may be
    inferred from the per-slice count). Without dcn axes it is
    :func:`mesh_layout`. Process ids are slice-major, so contiguous rank
    ranges are slices, as in the JAX package's fallback layout."""
    dcn_axes = dict(dcn_axes)
    if not dcn_axes:
        return mesh_layout(ici_axes, n)
    if any(v in (-1, 0) for v in dcn_axes.values()):
        raise ValueError(f"dcn axes must be explicit (no -1): {dcn_axes}")
    num_slices = math.prod(dcn_axes.values())
    if n % num_slices:
        raise ValueError(f"{n} devices do not split into {num_slices} "
                         f"slices (dcn axes {dcn_axes})")
    per_slice = n // num_slices
    ici_axes = dict(ici_axes or {})
    if not ici_axes:
        # the default name must not collide with a dcn axis
        name = next(a for a in ("dp", "fsdp", "ici") if a not in dcn_axes)
        ici_axes = {name: per_slice}
    ici_axes = _infer(ici_axes, per_slice, "ici", "per-slice devices")
    if math.prod(ici_axes.values()) != per_slice:
        raise ValueError(f"ici axes {ici_axes} require "
                         f"{math.prod(ici_axes.values())} devices per "
                         f"slice, have {per_slice}")
    dcn_names, ici_names = _ordered(dcn_axes), _ordered(ici_axes)
    overlap = set(dcn_names) & set(ici_names)
    if overlap:
        raise ValueError(f"axes {sorted(overlap)} appear in both the ici "
                         f"and dcn layouts")
    shape = (tuple(dcn_axes[a] for a in dcn_names)
             + tuple(ici_axes[a] for a in ici_names))
    return dcn_names + ici_names, shape


def _device_mesh(names, shape, device_type: str | None):
    """A DeviceMesh of ``shape`` named ``names`` over every rank of the
    default process group (which must exist), ranks in row-major
    order."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "tony_tpu_torch.runtime.initialize() first")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(dist.get_world_size()).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=names)


def make_mesh(axes: dict[str, int] | None = None,
              axis_order: tuple[str, ...] | None = None,
              device_type: str | None = None):
    """A ``DeviceMesh`` over every rank of the default process group,
    laid out by :func:`mesh_layout`. ``device_type`` defaults to the
    group's: ``cuda`` under NCCL, ``cpu`` under gloo."""
    import torch.distributed as dist
    n = dist.get_world_size() if dist.is_initialized() else 1
    names, shape = mesh_layout(axes, n, axis_order)
    return _device_mesh(names, shape, device_type)


def make_hybrid_mesh(ici_axes: dict[str, int] | None,
                     dcn_axes: dict[str, int],
                     device_type: str | None = None):
    """A ``DeviceMesh`` laid out by :func:`hybrid_mesh_layout`: dcn axes
    major, ici axes minor. Only the layout is ported; a model run across
    slices is not (:func:`tony_tpu_torch.runtime.mesh` refuses one)."""
    import torch.distributed as dist
    n = dist.get_world_size() if dist.is_initialized() else 1
    names, shape = hybrid_mesh_layout(ici_axes, dcn_axes, n)
    return _device_mesh(names, shape, device_type)


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}`` in mesh order, for a ``DeviceMesh`` or an
    ordered dict of sizes (which the pure sharding rules also take)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh needs named dimensions")
    return dict(zip(names, mesh.mesh.shape))


def parse_mesh_string(spec: str) -> dict[str, int]:
    """Parse ``tony.application.mesh``: ``"dp=2,tp=4"`` → ``{"dp": 2,
    "tp": 4}``; ``-1`` sizes are allowed (inferred at mesh build)."""
    axes: dict[str, int] = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        name, _, size = part.partition("=")
        if not size:
            raise ValueError(f"malformed mesh axis {part!r} in {spec!r}")
        axes[name.strip()] = int(size)
    return axes


# Presets: each returns an axes dict for make_mesh; -1 folds in the rest.

def preset_dp() -> dict[str, int]:
    """Pure data parallelism: every rank holds the full params."""
    return {"dp": -1}


def preset_fsdp() -> dict[str, int]:
    """Fully-sharded data parallelism: batch and params over one axis."""
    return {"fsdp": -1}


def preset_dp_tp(tp: int) -> dict[str, int]:
    """Batch over dp, layer internals over tp (the minor axis)."""
    return {"dp": -1, "tp": tp}


def preset_fsdp_tp(tp: int) -> dict[str, int]:
    return {"fsdp": -1, "tp": tp}


def preset_long_context(cp: int, tp: int = 1) -> dict[str, int]:
    """Sequence over cp, internals over tp (cp is not ported yet)."""
    return {"dp": -1, "cp": cp, "tp": tp}


def preset_pipeline(pp: int, tp: int = 1) -> dict[str, int]:
    return {"pp": pp, "dp": -1, "tp": tp}


def preset_moe(ep: int, tp: int = 1) -> dict[str, int]:
    """Experts over ep, dense internals over tp (ep is not ported yet)."""
    return {"dp": -1, "ep": ep, "tp": tp}


PRESETS = {
    "dp": preset_dp,
    "fsdp": preset_fsdp,
    "dp_tp": preset_dp_tp,
    "fsdp_tp": preset_fsdp_tp,
    "long_context": preset_long_context,
    "pipeline": preset_pipeline,
    "moe": preset_moe,
}
