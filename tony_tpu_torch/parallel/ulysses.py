"""Ulysses sequence parallelism: all-to-all context parallelism over ``cp``.

Port of ``tony_tpu/parallel/ulysses.py``. Where the ring keeps the
sequence split and rotates K/V, Ulysses re-shards: one all-to-all turns
the sequence-split ``[B, S/c, H, D]`` into the head-split ``[B, S,
H/c, D]``, attention runs over the whole sequence on H/c local heads
(the unsplit flash kernels, K1 and K2 on the card), and a second
all-to-all restores the sequence split. Two all-to-alls in all, against
the ring's cp hops; the head count must split over cp.

The JAX package's ``lax.all_to_all`` becomes ``dist.all_to_all_single``
in a ``torch.autograd.Function`` whose backward is the same exchange of
the cotangent (:class:`_AllToAll`; the exchange is its own adjoint).
The layout work around it (:func:`_to_heads_send`, :func:`_to_heads_recv`,
:func:`_to_seq_send`, :func:`_to_seq_recv`) is shared by the distributed
body (:func:`ulysses_attention_local`) and the single-process emulation
(:func:`ulysses_attention_emulated`), where the exchange is a transpose
of the ranks' send buffers. The JAX package's check that the full
sequence tiles a flash block is TPU tiling and is not carried over.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from tony_tpu_torch.ops.attention import ForwardStash, _check_kv_heads
from tony_tpu_torch.parallel.ring_attention import (_single_chunk,
                                                    emulate_mesh,
                                                    expand_kv_unless)


def _to_heads_send(x, cp: int):
    """``[B, S/c, H', D]`` → the send buffer ``[c, B, S/c, H'/c, D]``:
    entry j (head group j) goes to rank j."""
    b, s, h, d = x.shape
    return x.reshape(b, s, cp, h // cp, d).permute(2, 0, 1, 3, 4) \
        .contiguous()


def _to_heads_recv(buf):
    """The received ``[c, B, S/c, H'/c, D]`` (entry j: rank j's sequence
    chunk of this rank's heads) → ``[B, S, H'/c, D]``."""
    c, b, s, h, d = buf.shape
    return buf.permute(1, 0, 2, 3, 4).reshape(b, c * s, h, d)


def _to_seq_send(y, cp: int):
    """``[B, S, H'/c, D]`` → the send buffer ``[c, B, S/c, H'/c, D]``:
    entry j (sequence chunk j) goes to rank j."""
    b, s, h, d = y.shape
    return y.reshape(b, cp, s // cp, h, d).permute(1, 0, 2, 3, 4) \
        .contiguous()


def _to_seq_recv(buf):
    """The received ``[c, B, S/c, H'/c, D]`` (entry j: rank j's head
    group of this rank's chunk) → ``[B, S/c, H', D]``."""
    c, b, s, h, d = buf.shape
    return buf.permute(1, 2, 0, 3, 4).reshape(b, s, c * h, d)


class _AllToAll(torch.autograd.Function):
    """Entry j of this rank's buffer to rank j, rank j's entry for this
    rank into entry j (``all_to_all_single`` over the leading dim); the
    backward is the same exchange of the cotangent."""

    @staticmethod
    def forward(ctx, buf, group):
        ctx.group = group
        return _all_to_all(buf, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _all_to_all(buf, group):
    # both buffers contiguous: the collective reads and writes them flat
    buf = buf.contiguous()
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=group)
    return out


def _exchange(sends: list) -> list:
    """The all-to-all of ``len(sends)`` emulated ranks: rank r receives
    entry r of every rank's buffer, in rank order."""
    return list(torch.stack(sends).transpose(0, 1).unbind(0))


def _check_heads(h: int, hk: int, cp: int) -> None:
    if h % cp:
        raise ValueError(f"n_heads={h} not divisible by cp={cp}")
    if hk % cp:
        raise ValueError(f"kv heads ({hk}) not divisible by cp={cp}; "
                         f"expand K/V first (ulysses_attention does this "
                         f"automatically)")


def ulysses_attention_local(q, k, v, group=None, *, causal: bool = True,
                            scale: float | None = None,
                            stash: ForwardStash | None = None):
    """One rank's Ulysses body. q: ``[B, S_local, H, D]``, k/v ``[B,
    S_local, H_kv, D]``, this rank's chunk of a sequence split over
    ``group`` (None is one rank). Grouped-query K/V ride the all-to-alls
    unexpanded: H_kv splits over cp like the query heads, and the
    contiguous split keeps each rank's query heads with their kv heads.
    H and H_kv must both divide cp's size (:func:`ulysses_attention` and
    the model expand K/V first when H_kv cannot). Returns ``[B,
    S_local, H, D]``."""
    cp = 1 if group is None else dist.get_world_size(group)
    _check_heads(q.shape[2], k.shape[2], cp)
    if cp == 1:
        return _single_chunk(q, k, v, causal=causal, scale=scale,
                             stash=stash)
    qh, kh, vh = (_to_heads_recv(_AllToAll.apply(_to_heads_send(x, cp),
                                                 group)) for x in (q, k, v))
    o = _single_chunk(qh, kh, vh, causal=causal, scale=scale, stash=stash)
    return _to_seq_recv(_AllToAll.apply(_to_seq_send(o, cp), group))


def ulysses_attention_emulated(qs, ks, vs, *, causal: bool = True,
                               scale: float | None = None,
                               stash: ForwardStash | None = None) -> list:
    """Ulysses over ``len(qs)`` ranks in one process (rank r's chunks
    ``qs[r]``, ``ks[r]``, ``vs[r]``): the distributed body's layout
    steps with the exchange a transpose of the send buffers. Returns
    every rank's output."""
    cp = len(qs)
    _check_heads(qs[0].shape[2], ks[0].shape[2], cp)
    if cp == 1:
        return [_single_chunk(qs[0], ks[0], vs[0], causal=causal,
                              scale=scale, stash=stash)]
    qh, kh, vh = ([_to_heads_recv(buf) for buf in
                   _exchange([_to_heads_send(x, cp) for x in xs])]
                  for xs in (qs, ks, vs))
    os_ = [_single_chunk(a, b, c, causal=causal, scale=scale, stash=stash)
           for a, b, c in zip(qh, kh, vh)]
    return [_to_seq_recv(buf) for buf in
            _exchange([_to_seq_send(o, cp) for o in os_])]


def ulysses_attention(q, k, v, mesh, *, causal: bool = True,
                      scale: float | None = None,
                      batch_axes: Sequence[str] = ("dp", "fsdp"),
                      seq_axis: str = "cp", head_axis: str = "tp"):
    """Sequence-parallel attention over global ``[B, S, H, D]`` tensors
    on ``mesh`` (a ``DeviceMesh`` or its sizes), every rank emulated in
    this process — the all-to-all counterpart of
    :func:`~tony_tpu_torch.parallel.ring_attention.ring_attention`, the
    same call shape. With tp live each tp shard runs Ulysses over its
    own heads. GQA K/V stay unexpanded when the kv heads split over
    tp·cp, and are expanded first otherwise, as in the JAX package."""
    from tony_tpu_torch.parallel.mesh import mesh_shape
    shape = mesh_shape(mesh)
    h = q.shape[2]
    _check_kv_heads(h, k.shape[2])
    tp = shape.get(head_axis, 1) if head_axis else 1
    cp = shape.get(seq_axis, 1) if seq_axis else 1
    k, v = expand_kv_unless(k, v, h, tp * cp)
    return emulate_mesh(
        lambda qs, ks, vs: ulysses_attention_emulated(
            qs, ks, vs, causal=causal, scale=scale),
        q, k, v, mesh, batch_axes=batch_axes, seq_axis=seq_axis,
        head_axis=head_axis)
