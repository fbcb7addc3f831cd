"""MNIST models, the north-star workload — the port of
``tony_tpu/models/mnist.py``.

The JAX package's MLP and LeNet-scale CNN, their trees key for key
(``layer_{i}/{w,b}``; ``conv1``, ``conv2``, ``fc1``, ``fc2``, HWIO conv
weights), the negative log-likelihood, the accuracy and the synthetic
batch. Weights draw from an explicit CPU ``torch.Generator``: the same
scaling as the JAX package, other bits, so a parity test converts one
package's weights into the other.

:func:`synthetic_batch` builds its labels' class patterns as the JAX
function does, but draws the labels and the noise from ``torch``
(``randint``, ``randn``), not from ``jax.random``'s ``randint`` and
``normal``: the noise is held to its distribution (uniform labels,
N(0, 0.3²) noise), not to JAX's bits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tony_tpu_torch import resolve_device

NUM_CLASSES = 10
INPUT_DIM = 784


def _normal(gen, shape, scale, dtype, device):
    x = torch.randn(shape, generator=gen, dtype=torch.float32)
    return (x * scale).to(device=device, dtype=dtype)


def init_mlp(gen: torch.Generator, hidden: int = 512, depth: int = 2,
             dtype=torch.float32, device=None) -> dict:
    """``depth`` hidden layers of ``hidden`` units, on ``device`` (the
    card unless the caller passes ``"cpu"``); weights ``N(0, 1/fan_in)``,
    biases zero."""
    dev = resolve_device(device)
    dims = [INPUT_DIM] + [hidden] * depth + [NUM_CLASSES]
    return {
        f"layer_{i}": {
            "w": _normal(gen, (dims[i], dims[i + 1]), dims[i] ** -0.5,
                         dtype, dev),
            "b": torch.zeros((dims[i + 1],), dtype=dtype, device=dev),
        }
        for i in range(depth + 1)
    }


def mlp_logical_axes(params: dict) -> dict:
    return {name: {"w": ("embed", "mlp"), "b": ("mlp",)}
            for name in params}


def mlp_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: [B, 784] → logits [B, 10] (f32)."""
    n = len(params)
    for i in range(n):
        p = params[f"layer_{i}"]
        x = x @ p["w"] + p["b"]
        if i < n - 1:
            x = torch.relu(x)
    return x.float()


def init_cnn(gen: torch.Generator, dtype=torch.float32, device=None) -> dict:
    """LeNet-scale convnet: two 5x5 convs (32, 64 channels), fc 256, fc
    10; weights ``N(0, 1/fan_in)``."""
    dev = resolve_device(device)

    def conv(shape):
        return _normal(gen, shape, (shape[0] * shape[1] * shape[2]) ** -0.5,
                       dtype, dev)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=dev)

    # drawn in the JAX function's order of keys: conv1, conv2, fc1, fc2
    return {
        "conv1": {"w": conv((5, 5, 1, 32)), "b": zeros(32)},
        "conv2": {"w": conv((5, 5, 32, 64)), "b": zeros(64)},
        "fc1": {"w": _normal(gen, (7 * 7 * 64, 256), (7 * 7 * 64) ** -0.5,
                             dtype, dev), "b": zeros(256)},
        "fc2": {"w": _normal(gen, (256, NUM_CLASSES), 256 ** -0.5, dtype,
                             dev), "b": zeros(NUM_CLASSES)},
    }


def cnn_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: [B, 784] or [B, 28, 28, 1] → logits [B, 10] (f32). ``"SAME"``
    5x5 convs at stride 1 pad 2 on every side; the 2x2 pools are
    ``"VALID"``. Activations stay NHWC, so the flattened features are in
    the JAX package's (H, W, C) order."""
    if x.dim() == 2:
        x = x.reshape(-1, 28, 28, 1)
    h = x.permute(0, 3, 1, 2)             # NCHW view of the NHWC input
    for name in ("conv1", "conv2"):
        p = params[name]
        w = p["w"].permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        h = torch.relu(F.conv2d(h, w, padding=2)
                       + p["b"][None, :, None, None])
        h = F.max_pool2d(h, 2, 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = torch.relu(h @ params["fc1"]["w"] + params["fc1"]["b"])
    return (h @ params["fc2"]["w"] + params["fc2"]["b"]).float()


def nll_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[:, None].long())[:, 0].mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean()


def synthetic_batch(gen: torch.Generator, batch_size: int,
                    device=None) -> dict:
    """Learnable synthetic MNIST on ``device`` (the card unless the
    caller passes ``"cpu"``): each image is its label's one-hot tiled
    across the 784 pixels, plus N(0, 0.3²) noise. Labels and noise come
    from ``gen`` (module docstring: JAX's distribution, not its bits)."""
    dev = resolve_device(device)
    labels = torch.randint(0, NUM_CLASSES, (batch_size,), generator=gen)
    base = F.one_hot(labels, NUM_CLASSES).float()
    pattern = base.tile(1, INPUT_DIM // NUM_CLASSES + 1)[:, :INPUT_DIM]
    noise = torch.randn((batch_size, INPUT_DIM), generator=gen) * 0.3
    return {"image": (pattern + noise).to(dev),
            "label": labels.to(torch.int32).to(dev)}
