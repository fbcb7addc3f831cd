"""tony_tpu_torch — the PyTorch / CUDA port of tony-tpu's compute layer.

A package of its own beside ``tony_tpu``: it imports ``torch`` and
numpy, never ``jax``, and nothing from ``tony_tpu``. Module names mirror
the JAX package's (``ops/attention.py``, ``models/decode.py``, ...) so
each counterpart is easy to find. This slice ports the serving path of
the flagship decoder LM; attention in prefill runs through a hand-written
CUDA flash-attention forward (``csrc/flash_fwd.cu``).

Entry points run on the card unless the caller passes ``device="cpu"``;
with no card and no explicit CPU they raise (:func:`resolve_device`).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Raises when the card is asked for (explicitly or by
    default) and there is none — never falls back to the CPU."""
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
