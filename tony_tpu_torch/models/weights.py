"""Parameter trees between numpy and the port.

:func:`params_from_numpy` turns a parameter tree of numpy arrays — e.g.
the JAX package's ``init_params`` output fetched to the host — into the
port's torch tree with the same keys, shapes and (by default) dtypes;
:func:`params_to_numpy` is its inverse, bit for bit. bfloat16 arrays
(``ml_dtypes.bfloat16``, as JAX hands them out) are recognized by dtype
NAME and moved through a 16-bit integer view, so this module never
imports ``ml_dtypes``. An int8 serving snapshot crosses too: a weight
of the JAX package's quantized tree (a ``QuantizedWeight`` NamedTuple
whose ``q``/``scale`` are numpy arrays after ``jax.device_get``) becomes
the port's :class:`~tony_tpu_torch.models.quantize.QuantizedWeight`, and
back as the port's NamedTuple of numpy arrays. A tree may also hold
torch tensors (a weight artifact landed by
:func:`~tony_tpu_torch.serving.weightstore.pull_weights` keeps its
bfloat16 leaves as tensors); they are moved as they are. An MoE tree's
router is f32 in a model of any dtype (``transformer.init_params``): it
crosses as f32, and a cast to the model's dtype leaves it f32. A ResNet
``(params, stats)`` pair converts tree by tree; its statistics are f32
in a model of any dtype, so they cross without a cast.
"""

from __future__ import annotations

import numpy as np
import torch

from tony_tpu_torch import resolve_device
from tony_tpu_torch.models.quantize import QuantizedWeight

#: leaves a model keeps in f32 whatever its dtype (the MoE router): a
#: cast of the tree leaves them f32
_F32_LEAVES = frozenset({"router"})

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
}


def _leaf_from_numpy(a, device, dtype):
    if isinstance(a, torch.Tensor):
        t = a
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    elif a.dtype in _NP_TO_TORCH:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    else:
        raise TypeError(f"unsupported parameter dtype {a.dtype}")
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device=None, dtype=None):
    """numpy tree (or torch leaves) → torch tree on ``device`` (the card
    unless the caller passes ``"cpu"``). ``dtype`` casts floating leaves
    but the f32 router (None keeps each leaf's dtype). Nested dicts keep
    their keys."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(
            v, dev, None if k in _F32_LEAVES else dtype)
            for k, v in tree.items()}
    if getattr(tree, "_fields", None) == QuantizedWeight._fields:
        # int8 q and f32 scale keep their dtypes
        return QuantizedWeight(*(_leaf_from_numpy(a, dev, None)
                                 for a in tree))
    return _leaf_from_numpy(tree, dev, dtype)


def params_to_numpy(params, bf16_dtype=None):
    """torch tree → numpy tree (host copies, bit-exact). bfloat16 leaves
    come back as ``uint16`` arrays of their bits, or viewed as
    ``bf16_dtype`` when the caller passes one (e.g.
    ``ml_dtypes.bfloat16``), which restores the JAX package's dtype. A
    sharded (DTensor) leaf is gathered to its full array first — a
    collective call on every rank of its mesh — so a sharded tree and
    the unsharded one give the same arrays and the same digest."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v, bf16_dtype) for k, v in params.items()}
    if isinstance(params, QuantizedWeight):
        return QuantizedWeight(*(params_to_numpy(t) for t in params))
    if hasattr(params, "full_tensor"):
        params = params.full_tensor()
    # a copy even of a CPU tensor: the optimizers update params in place,
    # and a numpy view would follow them
    t = params.detach().cpu().clone()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        return bits if bf16_dtype is None else bits.view(bf16_dtype)
    return t.numpy()
