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
    result is bitwise its ``_quantize`` on the same weight."""
    w32 = w.float()
    scale = w32.abs().amax(dim=contract_axes, keepdim=True)
    scale = torch.clamp_min(scale / 127.0, 1e-8)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QuantizedWeight(q, scale.squeeze(contract_axes))


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
