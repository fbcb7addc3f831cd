"""Parameter trees between numpy and the port.

:func:`params_from_numpy` turns a parameter tree of numpy arrays — e.g.
the JAX package's ``init_params`` output fetched to the host — into the
port's torch tree with the same keys, shapes and (by default) dtypes;
:func:`params_to_numpy` is its inverse, bit for bit. bfloat16 arrays
(``ml_dtypes.bfloat16``, as JAX hands them out) are recognized by dtype
NAME and moved through a 16-bit integer view, so this module never
imports ``ml_dtypes``.
"""

from __future__ import annotations

import numpy as np
import torch

from tony_tpu_torch import resolve_device

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
    """numpy tree → torch tree on ``device`` (the card unless the caller
    passes ``"cpu"``). ``dtype`` casts floating leaves (None keeps each
    leaf's dtype). Nested dicts keep their keys."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev, dtype) for k, v in tree.items()}
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
    if hasattr(params, "full_tensor"):
        params = params.full_tensor()
    # a copy even of a CPU tensor: the optimizers update params in place,
    # and a numpy view would follow them
    t = params.detach().cpu().clone()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        return bits if bf16_dtype is None else bits.view(bf16_dtype)
    return t.numpy()
