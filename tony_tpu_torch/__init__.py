"""tony_tpu_torch — the PyTorch / CUDA port of tony-tpu's compute layer.

A package of its own beside ``tony_tpu``: it imports ``torch`` and
numpy, never ``jax``, and nothing from ``tony_tpu``. Module names mirror
the JAX package's (``ops/attention.py``, ``models/decode.py``, ...) so
each counterpart is easy to find. The ported slices are the serving
and the single-device training paths of the flagship decoder LM and
single-device BERT MLM pretraining; their attention, norms and fused
optimizer run through hand-written CUDA kernels (``csrc/``).

Entry points run on the card unless the caller passes ``device="cpu"``;
with no card and no explicit CPU they raise (:func:`resolve_device`).
"""

from __future__ import annotations


def resolve_device(device=None) -> "torch.device":  # noqa: F821
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Raises when the card is asked for (explicitly or by
    default) and there is none — never falls back to the CPU. (torch is
    imported here, not with the package: the router and the wire codecs
    run on hosts with no model stack.)"""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def tree_leaves(tree) -> list:
    """Leaves of nested dicts (a parameter tree, a batch) in insertion
    order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)
