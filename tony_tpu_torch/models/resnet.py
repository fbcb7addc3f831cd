"""ResNet-50 (v1.5), functional, data-parallel with synchronised batch
norm — the port of ``tony_tpu/models/resnet.py``.

The parameter tree is the JAX package's, key for key: HWIO conv weights,
``scale``/``bias`` per batch norm in the model dtype, and a second tree
of f32 ``mean``/``var`` statistics, so one package's weights convert into
the other's and keep their ``tree_digest``. Activations are NHWC, as
there; a convolution views its input as NCHW (``permute``: a contiguous
NHWC tensor is an NCHW tensor in ``channels_last``), copies its weight
once into OIHW ``channels_last`` and runs ``F.conv2d``, so cuDNN works in
channels-last throughout and the result viewed back is NHWC again.

Things the reference gets from XLA that are written out here:

- ``"SAME"`` padding splits an odd total with the extra row after
  (``lo = total // 2``): the stride-2 stem pads a 224 image 2 before and
  3 after, a stage's first 3x3/2 conv and the 3x3/2 max pool pad an even
  size 0 and 1. Where the two sides differ the input is padded first
  (``-inf`` for the pool) and the op runs with no padding.
- Batch norm in training mode normalises with the biased variance over
  (N, H, W) in f32, casts back to the input dtype, and moves the stored
  statistics by ``0.9 · old + 0.1 · batch`` with that biased variance
  (not ``F.batch_norm``'s running update, which stores the unbiased
  one).
- Under a mesh the JAX program's reductions over the batch are global
  (pjit inserts the cross-replica sums): sync-BN. Here each rank holds
  its rows (``Layout.local``), sums each channel over its rows, and
  all-reduces the sum over the data ranks (``Layout.sync_data``); the
  squared deviations from the global mean likewise. The global mean and
  variance feed every rank's rows, so the cotangent a rank holds for them
  is partial: the all-reduce's backward all-reduces it.

Parameters replicate over the data ranks (DTensors; their gradients come
back summed by ``Layout.local_params``); the statistics are plain tensors,
equal on every rank since they come from the global sums.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tony_tpu_torch import resolve_device
from tony_tpu_torch.parallel import spmd

STAGE_SIZES = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def _conv_init(gen, shape, dtype, device):
    fan_out = shape[0] * shape[1] * shape[3]   # He init, fan-out
    x = torch.randn(shape, generator=gen, dtype=torch.float32)
    return (x * ((2.0 / fan_out) ** 0.5)).to(device=device, dtype=dtype)


def _bn_init(c, dtype, device):
    return {"scale": torch.ones((c,), dtype=dtype, device=device),
            "bias": torch.zeros((c,), dtype=dtype, device=device)}


def _bn_stats(c, device):
    return {"mean": torch.zeros((c,), dtype=torch.float32, device=device),
            "var": torch.ones((c,), dtype=torch.float32, device=device)}


def init_resnet(gen: torch.Generator, depth: int = 50,
                num_classes: int = 1000, dtype=torch.bfloat16,
                device=None) -> tuple[dict, dict]:
    """(params, batch_stats) drawn from ``gen`` (a CPU
    ``torch.Generator``) on ``device``, the card unless the caller passes
    ``"cpu"``. The JAX ``init_resnet``'s tree and scaling (He fan-out for
    convs, ``in_c ** -0.5`` for the head); the draws differ."""
    if depth not in STAGE_SIZES:
        raise ValueError(f"unsupported depth {depth}")
    dev = resolve_device(device)
    conv = lambda shape: _conv_init(gen, shape, dtype, dev)  # noqa: E731
    bn = lambda c: _bn_init(c, dtype, dev)                    # noqa: E731
    params: dict = {"stem": {"conv": conv((7, 7, 3, 64)), "bn": bn(64)}}
    stats: dict = {"stem": _bn_stats(64, dev)}
    in_c = 64
    for si, blocks in enumerate(STAGE_SIZES[depth]):
        width = 64 * (2 ** si)
        out_c = width * 4
        for bi in range(blocks):
            p = {"conv1": conv((1, 1, in_c, width)), "bn1": bn(width),
                 "conv2": conv((3, 3, width, width)), "bn2": bn(width),
                 "conv3": conv((1, 1, width, out_c)), "bn3": bn(out_c)}
            s = {"bn1": _bn_stats(width, dev), "bn2": _bn_stats(width, dev),
                 "bn3": _bn_stats(out_c, dev)}
            if bi == 0:
                p["proj"] = conv((1, 1, in_c, out_c))
                p["proj_bn"] = bn(out_c)
                s["proj_bn"] = _bn_stats(out_c, dev)
            params[f"stage{si}_block{bi}"] = p
            stats[f"stage{si}_block{bi}"] = s
            in_c = out_c
    w = torch.randn((in_c, num_classes), generator=gen, dtype=torch.float32)
    params["head"] = {
        "w": (w * in_c ** -0.5).to(device=dev, dtype=dtype),
        "b": torch.zeros((num_classes,), dtype=dtype, device=dev)}
    return params, stats


def _same(size: int, k: int, s: int) -> tuple[int, int]:
    """(before, after) of XLA's ``"SAME"`` padding along one dimension."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _nchw(x):
    """An NHWC tensor as the NCHW view (channels_last memory)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _same_input(x, k: int, s: int, value: float = 0.0):
    """NHWC ``x`` as NCHW, and the symmetric padding left for the op:
    asymmetric ``"SAME"`` padding is applied here (``value``-filled)."""
    (t, b), (lft, r) = _same(x.shape[1], k, s), _same(x.shape[2], k, s)
    xc = _nchw(x)
    if (t, lft) == (b, r):
        return xc, (t, lft)
    return F.pad(xc, (lft, r, t, b), value=value), (0, 0)


def _conv(x, w, stride: int = 1):
    """``lax.conv_general_dilated(x, w, (stride, stride), "SAME",
    ("NHWC", "HWIO", "NHWC"))``: x NHWC, w HWIO, NHWC out."""
    xc, pad = _same_input(x, w.shape[0], stride)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return _nhwc(F.conv2d(xc, wc, stride=stride, padding=pad))


def _max_pool(x, k: int = 3, s: int = 2):
    """``lax.reduce_window(x, -inf, max, (1, k, k, 1), (1, s, s, 1),
    "SAME")`` on NHWC ``x``."""
    xc, pad = _same_input(x, k, s, value=float("-inf"))
    return _nhwc(F.max_pool2d(xc, k, s, padding=pad))


def _moments(xf, lay):
    """Per-channel mean and biased variance of f32 NHWC ``xf`` over (N,
    H, W) — and over the data ranks with a layout, each sum all-reduced
    with an all-reducing backward."""
    count = xf.shape[0] * xf.shape[1] * xf.shape[2]
    total = xf.sum(dim=(0, 1, 2))
    if lay is not None:
        total, count = lay.sync_data(total), count * lay.data_size
    mean = total / count
    d = xf - mean
    sq = (d * d).sum(dim=(0, 1, 2))
    if lay is not None:
        sq = lay.sync_data(sq)
    return mean, sq / count, d


def _batch_norm(x, p, s, train: bool, momentum=0.9, eps=1e-5, lay=None):
    """Returns (y, new_stats): normalised in f32, cast back to x's dtype.
    In training the batch's statistics (global with a layout) normalise
    and move the stored ones; in eval the stored ones normalise."""
    if train:
        mean, var, d = _moments(x.float(), lay)
        with torch.no_grad():
            new_s = {"mean": momentum * s["mean"] + (1 - momentum) * mean,
                     "var": momentum * s["var"] + (1 - momentum) * var}
    else:
        mean, var, new_s = s["mean"], s["var"], s
        d = x.float() - mean
    y = d * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype), new_s


def _bottleneck(x, p, s, stride: int, train: bool, lay=None):
    new_s = {}
    shortcut = x
    if "proj" in p:
        shortcut = _conv(x, p["proj"], stride)
        shortcut, new_s["proj_bn"] = _batch_norm(
            shortcut, p["proj_bn"], s["proj_bn"], train, lay=lay)
    h = _conv(x, p["conv1"])
    h, new_s["bn1"] = _batch_norm(h, p["bn1"], s["bn1"], train, lay=lay)
    h = torch.relu(h)
    h = _conv(h, p["conv2"], stride)        # v1.5: stride on the 3x3
    h, new_s["bn2"] = _batch_norm(h, p["bn2"], s["bn2"], train, lay=lay)
    h = torch.relu(h)
    h = _conv(h, p["conv3"])
    h, new_s["bn3"] = _batch_norm(h, p["bn3"], s["bn3"], train, lay=lay)
    return torch.relu(h + shortcut), new_s


def _forward_local(params, stats, x, depth, train, lay=None):
    new_stats: dict = {}
    h = _conv(x, params["stem"]["conv"], stride=2)
    h, new_stats["stem"] = _batch_norm(h, params["stem"]["bn"],
                                       stats["stem"], train, lay=lay)
    h = _max_pool(torch.relu(h))
    for si, blocks in enumerate(STAGE_SIZES[depth]):
        for bi in range(blocks):
            name = f"stage{si}_block{bi}"
            stride = 2 if (bi == 0 and si > 0) else 1
            h, new_stats[name] = _bottleneck(h, params[name], stats[name],
                                             stride, train, lay)
    h = h.mean(dim=(1, 2))                  # global average pool
    logits = h @ params["head"]["w"] + params["head"]["b"]
    return logits.float(), new_stats


def _local_inputs(params, x, mesh):
    """This rank's params (gathered, gradients summed over the data
    ranks), rows of ``x`` and layout; as given with no mesh."""
    if mesh is None:
        return params, x, None
    lay = spmd.Layout(mesh)
    return lay.local_params(params), lay.local(x), lay


def forward(params: dict, stats: dict, x: torch.Tensor, depth: int = 50,
            train: bool = True, mesh=None) -> tuple[torch.Tensor, dict]:
    """x: [B, H, W, 3] → (logits f32, new_batch_stats). With a ``mesh``
    the logits are this rank's rows and the statistics the global
    batch's."""
    params, x, lay = _local_inputs(params, x, mesh)
    return _forward_local(params, stats, x, depth, train, lay)


def classification_loss(params, stats, batch, depth=50, mesh=None):
    """(mean cross-entropy over the global batch, new_stats); training
    mode. With a ``mesh``, the same plain 0-d tensor on every rank: the
    rows' sum summed over the data ranks, over the global count."""
    params, x, lay = _local_inputs(params, batch["image"], mesh)
    logits, new_stats = _forward_local(params, stats, x, depth, True, lay)
    labels = batch["label"] if lay is None else lay.local(batch["label"])
    logp = torch.log_softmax(logits, dim=-1)
    total = -logp.gather(-1, labels[:, None].long())[:, 0].sum()
    count = labels.shape[0]
    if lay is not None:
        total, count = lay.sum_data(total), count * lay.data_size
    return total / count, new_stats
