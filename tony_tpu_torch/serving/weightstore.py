"""The content digest of a served weight tree.

The port's copy of ``flatten_tree`` and ``tree_digest`` from
``tony_tpu/serving/weightstore.py``: a replica advertises the digest in
HELLO and STATS, and a tree converted between the packages digests the
same (test-pinned), so a router can pin sessions to a weights
generation across a mixed fleet. Leaves may be torch tensors (a
bfloat16 tensor hashes its 16-bit payload under the dtype name
``bfloat16``, as ``ml_dtypes`` names it) or numpy arrays. The weights
lane, ``pack_weights`` and the blob codec are not ported.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

#: path separator in flattened tree names; list indices are marked ``#i``
_SEP = "/"
_IDX = "#"


def flatten_tree(tree, prefix: str = "") -> dict:
    """Flatten a nested params tree (dicts / lists / tuples of tensors or
    array-likes) to ``{path: leaf}`` with deterministic ``/``-joined
    paths (``#i`` for sequence indices)."""
    out: dict = {}
    if isinstance(tree, dict):
        for k in tree:
            if not isinstance(k, str) or _SEP in k or k.startswith(_IDX):
                raise ValueError(
                    f"weight tree key {k!r} is not flattenable (string "
                    f"keys without {_SEP!r}, not starting with {_IDX!r})")
            sub = prefix + _SEP + k if prefix else k
            out.update(flatten_tree(tree[k], sub))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            sub = f"{prefix}{_SEP}{_IDX}{i}" if prefix else f"{_IDX}{i}"
            out.update(flatten_tree(v, sub))
    else:
        out[prefix or _IDX + "0"] = tree
    return out


def _leaf_bytes(leaf) -> tuple[str, tuple, bytes]:
    """(dtype name, shape, C-order payload) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if hasattr(t, "full_tensor"):
            t = t.full_tensor()
        t = t.cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return ("bfloat16", tuple(t.shape),
                    t.view(torch.int16).numpy().tobytes())
        a = t.numpy()
    else:
        a = np.ascontiguousarray(np.asarray(leaf))
    return str(a.dtype), a.shape, a.tobytes()


def tree_digest(tree) -> str:
    """sha256 hex over the canonical serialized weight tree: entries in
    sorted flattened-path order, each framed ``buf\\0path\\0dtype\\0
    shape\\0`` + C-contiguous payload + ``\\0`` — content only."""
    flat = flatten_tree(tree)
    h = hashlib.sha256()
    for path in sorted(flat):
        dtype, shape, payload = _leaf_bytes(flat[path])
        dims = ",".join(str(d) for d in shape)
        h.update(f"buf\0{path}\0{dtype}\0{dims}\0".encode("utf-8"))
        h.update(payload)
        h.update(b"\0")
    return h.hexdigest()
