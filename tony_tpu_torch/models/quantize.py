"""Weight-only int8 quantization for the serving path.

Port of ``tony_tpu/models/quantize.py``. A decode step reads every
weight once per generated token, so halving the bytes of each weight
halves the weight read of the step.

Scheme: symmetric per-OUTPUT-CHANNEL absmax int8. For every served
matmul ``y = x @ W`` the scale is constant along the contracted axes,
so it factors out of the product:
``(x @ W_int8) * scale``, the scale applied in f32 outside the
contraction. :func:`tony_tpu_torch.models.decode._weinsum` is the one
place where weight products are dispatched (its docstring gives the
route rule).

Scope: every decode and serving entry point of
:mod:`tony_tpu_torch.models.decode` and :mod:`~tony_tpu_torch.models.serve`
takes a quantized tree; the training forward does not (training needs
weight gradients: quantize a snapshot for serving). The embedding and
the norms pass through unchanged.

Usage::

    sparams = quantize_weights_int8(params)     # serving snapshot
    out = decode.generate(sparams, prompt, cfg, n)

Tensor-parallel serving quantizes AFTER sharding, as the JAX package
does: ``quantize_weights_int8(shard_pytree(params, T.logical_axes(cfg),
mesh))`` quantizes each rank's shard, its scales the global ones
(:func:`_quantize_sharded`), and ``decode.generate(sparams, prompt, cfg,
n, mesh=mesh)`` decodes on it. The emulation of a dict mesh quantizes
the global tree and cuts q and scale per rank
(:func:`quantized_axes`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QuantizedWeight(NamedTuple):
    """int8 weight + per-output-channel f32 scale. Both keep the stacked
    ``[L, ...]`` leading dim of a block weight, so indexing a layer
    slices ``q`` and ``scale`` together (:func:`layer`)."""
    q: torch.Tensor        # int8, the original weight's shape
    scale: torch.Tensor    # f32, the output-channel dims (contracted axes
    #                        squeezed out)


def _quantize(w: torch.Tensor, contract_axes: tuple[int, ...]
              ) -> QuantizedWeight:
    """absmax / 127 per output channel, clamped below at 1e-8; q rounds
    half to even and clips to ±127. The JAX package's arithmetic, so the
    result is bitwise its ``_quantize`` on the same weight; a DTensor goes
    through :func:`_quantize_sharded`."""
    from torch.distributed.tensor import DTensor
    if isinstance(w, DTensor):
        return _quantize_sharded(w, contract_axes)
    w32 = w.float()
    scale = w32.abs().amax(dim=contract_axes, keepdim=True)
    scale = torch.clamp_min(scale / 127.0, 1e-8)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QuantizedWeight(q, scale.squeeze(contract_axes))


def _quantize_sharded(w, contract_axes: tuple[int, ...]
                      ) -> QuantizedWeight:
    """:func:`_quantize` of a DTensor, on each rank's local shard. Where
    the mesh splits a contracted dimension (``wo``'s heads and
    ``w_down``'s hidden over tp, a weight's ``d`` over fsdp) a rank's own
    absmax covers part of the channel, so the absmax is all-reduced (MAX,
    exact) over that mesh dimension first: every rank then holds the
    global scales, as the JAX package's quantization of a sharded array
    does (XLA reduces over the whole axis), and q and scale are bitwise
    the unsharded ones. q keeps the weight's placements; the scale is
    replicated over the contracted dimensions' mesh axes and keeps its
    other splits (on its dimensions, past the squeezed ones)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = w.device_mesh
    w32 = w.to_local().float()
    absmax = w32.abs().amax(dim=contract_axes, keepdim=True)
    scale_placements = []
    for i, p in enumerate(w.placements):
        if p.is_shard() and p.dim in contract_axes:
            dist.all_reduce(absmax, op=dist.ReduceOp.MAX,
                            group=mesh.get_group(i))
            scale_placements.append(Replicate())
        elif p.is_shard():
            scale_placements.append(Shard(
                p.dim - sum(a < p.dim for a in contract_axes)))
        else:
            scale_placements.append(p)
    scale = torch.clamp_min(absmax / 127.0, 1e-8)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    scale_shape = torch.Size(n for d, n in enumerate(w.shape)
                             if d not in contract_axes)
    return QuantizedWeight(
        DTensor.from_local(q, mesh, w.placements, run_check=False,
                           shape=w.shape, stride=_strides(w.shape)),
        DTensor.from_local(scale.squeeze(contract_axes), mesh,
                           scale_placements, run_check=False,
                           shape=scale_shape,
                           stride=_strides(scale_shape)))


def _strides(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    out, step = [], 1
    for n in reversed(shape):
        out.append(step)
        step *= n
    return tuple(reversed(out))


#: blocks-tree weights served through matmuls, with the axes each
#: contracts over (leading dim 0 is the stacked layer axis L)
_BLOCK_AXES = {
    "wq": (1,), "wk": (1,), "wv": (1,),    # [L, d, H, hd] contract d
    "wo": (1, 2),                          # [L, H, hd, d] contract (H, hd)
    "w_gate": (1,), "w_up": (1,),          # [L, d, f]     contract d
    "w_down": (1,),                        # [L, f, d]     contract f
}


@torch.no_grad()
def quantize_weights_int8(params: dict) -> dict:
    """Serving snapshot: the dense matmul weights and the lm_head →
    :class:`QuantizedWeight` on the weights' device; everything else
    (embed, norms, MoE experts and router) passes through unchanged."""
    blocks = dict(params["blocks"])
    moe = "router" in blocks
    for name, axes in _BLOCK_AXES.items():
        if name not in blocks:
            continue
        if moe and name in ("w_gate", "w_up", "w_down"):
            continue        # expert weights keep their own dispatch
        blocks[name] = _quantize(blocks[name], axes)
    out = dict(params, blocks=blocks)
    out["lm_head"] = _quantize(params["lm_head"], (0,))   # [d, v]
    return out


def quantized_axes(params: dict, axes: dict) -> dict:
    """The logical-axes tree of ``params``, which
    :func:`quantize_weights_int8` may have quantized, from ``axes``, the
    float tree's: a quantized leaf gets ``QuantizedWeight(the weight's
    axes, the weight's axes without the contracted ones)`` — q is laid
    out as the weight, the scale as its output channels."""
    def leaf(w, logical, contract):
        if not isinstance(w, QuantizedWeight):
            return logical
        return QuantizedWeight(logical, tuple(
            a for d, a in enumerate(logical) if d not in contract))
    blocks = {n: leaf(w, axes["blocks"][n], _BLOCK_AXES.get(n, ()))
              for n, w in params["blocks"].items()}
    return dict(axes, blocks=blocks,
                lm_head=leaf(params["lm_head"], axes["lm_head"], (0,)))


def layer(w, li: int):
    """Layer ``li`` of a stacked leaf, plain or quantized."""
    if isinstance(w, QuantizedWeight):
        return QuantizedWeight(w.q[li], w.scale[li])
    return w[li]


def weight_bytes(params: dict) -> int:
    """Bytes of every tensor in a (possibly quantized) parameter tree."""
    if isinstance(params, dict):
        return sum(weight_bytes(v) for v in params.values())
    if isinstance(params, QuantizedWeight):
        return sum(weight_bytes(t) for t in params)
    return params.numel() * params.element_size()
