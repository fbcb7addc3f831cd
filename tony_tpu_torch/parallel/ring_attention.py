"""Ring attention: context parallelism over the mesh's ``cp`` axis.

Port of ``tony_tpu/parallel/ring_attention.py``. The sequence is split
over ``cp``; each rank holds a Q/K/V chunk, attends its Q to the K/V
chunk it holds, then passes K/V one hop around the ring (rank ``i`` to
``i + 1``) while merging the hops' results, so the full sequence is
never held by one rank. The JAX package rotates with ``lax.ppermute``
inside a ``scan`` and lets AD transpose it; here the pass is a
``torch.autograd.Function`` over ``dist.batch_isend_irecv`` in the cp
group whose backward passes the cotangent the other way
(:class:`_RingKV`), and the hops are a Python loop.

Two engines per hop, as in the JAX package:

- the flash arm (``_ring_flash``'s): each hop's chunk runs
  :func:`~tony_tpu_torch.ops.attention.flash_attention_with_lse` — K1
  forward, K2 (or K3a + K3b) backward on the card — and the hops merge
  by logsumexp, each chunk's o cast to f32 first. lse is differentiated,
  so the merge hands the backward kernels a non-zero lse cotangent. A hop
  is a full chunk (wholly in the past: no mask), the diagonal chunk
  (causal) or a future chunk, which contributes o = 0 and lse = -1e30:
  the merge weights that to exactly nothing, so it launches nothing and
  is skipped. It runs whenever the tensors are on the card: the kernels
  take any chunk length, so the JAX package's block ladder (TPU tiling)
  is not carried over;
- the dense arm (:func:`_block_attn`): the f32 online softmax with a
  -1e30 additive mask, the plain version, taken on the CPU unless a test
  forces the flash arm (``_USE_FLASH_CHUNKS = True``, which runs the
  kernels' plain versions there).

The hop (:func:`_ring_hop`) is one function shared by the distributed
body (:func:`ring_attention_local`, one rank of a process group) and the
single-process emulation (:func:`ring_attention_emulated`, every rank in
turn with the pass a rotation of a list), which the tests and the chip
smoke use where a group of several cards is not at hand.
:func:`ring_attention` takes global ``[B, S, H, D]`` tensors and a mesh's
sizes and runs the emulation over them, the JAX wrapper's contract.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from tony_tpu_torch.ops.attention import (ForwardStash, _check_kv_heads,
                                          flash_attention,
                                          flash_attention_with_lse)
from tony_tpu_torch.parallel.sharding import attention_spec

_NEG_INF = -1.0e30

#: the per-chunk engine on the CPU: None or False the dense online
#: softmax, True the flash arm (through the kernels' plain versions).
#: CUDA tensors always take the flash arm.
_USE_FLASH_CHUNKS: bool | None = None


def _flash_chunks(x: torch.Tensor) -> bool:
    return x.is_cuda or bool(_USE_FLASH_CHUNKS)


def _block_attn(q, k, v, m, l, o, scale, q_off, kv_off, causal):
    """One blockwise-attention accumulation step (online softmax), the
    plain per-hop version. q: ``[B, Sq, H, D]``; k/v: ``[B, Sk, H_kv,
    D]`` (H_kv divides H: query head j reads kv head j // (H/H_kv),
    grouped in the product, never expanded); m/l: ``[B, H, Sq]``; o:
    ``[B, Sq, H, D]``, all f32. q_off/kv_off are the chunks' global
    offsets, for the causal mask across hops."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    qf, kf = q.float(), k.float()
    if hk != h:
        rep = h // hk
        s = torch.einsum("bqhrd,bkhd->bhrqk", qf.reshape(b, sq, hk, rep, d),
                         kf).reshape(b, h, sq, sk) * scale
    else:
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        q_pos = q_off + torch.arange(sq, device=q.device)[:, None]
        kv_pos = kv_off + torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(q_pos < kv_pos, _NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # masked lanes underflow to 0; m is floored at -1e30, never -inf
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    pr = p.to(v.dtype).float()
    vf = v.float()
    if hk != h:
        pv = torch.einsum("bhrqk,bkhd->bqhrd",
                          pr.reshape(b, hk, h // hk, sq, sk),
                          vf).reshape(b, sq, h, d)
    else:
        pv = torch.einsum("bhqk,bkhd->bqhd", pr, vf)
    o_new = o * corr.transpose(1, 2)[..., None] + pv
    return m_new, l_new, o_new


def _ring_hop(q, k, v, acc, *, rank: int, hop: int, cp: int, causal: bool,
              scale: float, stash: ForwardStash | None = None):
    """Rank ``rank``'s work at hop ``hop`` of a ring of ``cp``: attend its
    q chunk to the K/V chunk it holds, which began on rank ``(rank -
    hop) mod cp``, and merge into ``acc`` (None before the first hop).
    The one function the distributed body and the emulation share."""
    s_loc = q.shape[1]
    q_off, kv_off = rank * s_loc, ((rank - hop) % cp) * s_loc
    if not _flash_chunks(q):
        if acc is None:
            b, _, h, d = q.shape
            acc = (torch.full((b, h, s_loc), _NEG_INF, device=q.device),
                   torch.zeros((b, h, s_loc), device=q.device),
                   torch.zeros((b, s_loc, h, d), device=q.device))
        return _block_attn(q, k, v, *acc, scale, q_off, kv_off, causal)
    if causal and kv_off > q_off:
        # a future chunk: (o = 0, lse = -1e30) merges to the identity
        return acc
    o_c, lse_c = flash_attention_with_lse(
        q, k, v, causal=causal and kv_off == q_off, scale=scale,
        stash=stash)
    o_c = o_c.float()
    if acc is None:
        # merging into (0, -1e30) gives the chunk itself
        return o_c, lse_c
    o_acc, lse_acc = acc
    lse_new = torch.logaddexp(lse_acc, lse_c)               # [B, H, S]
    w_acc = torch.exp(lse_acc - lse_new).transpose(1, 2)[..., None]
    w_c = torch.exp(lse_c - lse_new).transpose(1, 2)[..., None]
    return o_acc * w_acc + o_c * w_c, lse_new


def _ring_finish(acc, dtype):
    """The attention output of a ring's accumulator, in ``dtype``."""
    if len(acc) == 3:                  # dense arm: (m, l, o)
        _, l, o = acc
        # every causal query attends at least itself, so l > 0
        return (o / l.transpose(1, 2)[..., None]).to(dtype)
    return acc[0].to(dtype)


def _send_recv(tensors, group, offset: int):
    """Each of ``tensors`` sent to the rank ``offset`` ahead in ``group``
    while the one ``offset`` behind's arrive: new tensors."""
    size, me = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + offset) % size)
    src = dist.get_global_rank(group, (me - offset) % size)
    outs, ops = [], []
    for tag, t in enumerate(tensors):
        t = t.contiguous()
        out = torch.empty_like(t)
        outs.append(out)
        ops += [dist.P2POp(dist.isend, t, dst, group, tag),
                dist.P2POp(dist.irecv, out, src, group, tag)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _RingKV(torch.autograd.Function):
    """K and V as this rank holds them at each hop of the ring: entry t
    is the pair that began on rank ``(rank - t) mod cp``, each hop
    passing the pair it holds to the next rank (``lax.ppermute`` with
    ``i → i + 1``, cp - 1 times). The backward passes the cotangents the
    other way, adding at each hop the cotangent of the chunk held there.
    One node for every hop, whose first output (the rank's own pair,
    which hop 0 always reads) is always differentiated: its backward
    runs on every rank, so the ranks' transfers pair up even where a
    rank's causal hops skip the future chunks and read no K/V."""

    @staticmethod
    def forward(ctx, group, k, v):
        ctx.group = group
        ctx.set_materialize_grads(False)
        ks, vs = [k.view_as(k)], [v.view_as(v)]
        for _ in range(dist.get_world_size(group) - 1):
            k, v = _send_recv((k, v), group, 1)
            ks.append(k)
            vs.append(v)
        return tuple(ks) + tuple(vs)

    @staticmethod
    def backward(ctx, *grads):
        n = len(grads) // 2
        like = [g for g in grads if g is not None][0]
        zero = lambda g: torch.zeros_like(like) if g is None else g
        dk, dv = zero(grads[n - 1]), zero(grads[-1])
        for t in range(n - 1, 0, -1):
            dk, dv = _send_recv((dk, dv), ctx.group, -1)
            if grads[t - 1] is not None:
                dk = dk + grads[t - 1]
            if grads[n + t - 1] is not None:
                dv = dv + grads[n + t - 1]
        return None, dk, dv


def _scale(q, scale):
    return (q.shape[-1] ** -0.5) if scale is None else scale


def ring_attention_local(q, k, v, group=None, *, causal: bool = True,
                         scale: float | None = None,
                         stash: ForwardStash | None = None):
    """One rank's ring body. q: ``[B, S_local, H, D]``, k/v ``[B,
    S_local, H_kv, D]``: this rank's chunk of a sequence split over
    ``group`` (the cp group; its rank order is the sequence order; None
    is one rank). Returns this rank's ``[B, S_local, H, D]`` output.
    ``stash``: see :class:`~tony_tpu_torch.ops.attention.ForwardStash`."""
    cp = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    scale = _scale(q, scale)
    kvs = _RingKV.apply(group, k, v) if cp > 1 else (k, v)
    acc = None
    for hop in range(cp):
        acc = _ring_hop(q, kvs[hop], kvs[cp + hop], acc, rank=rank,
                        hop=hop, cp=cp, causal=causal, scale=scale,
                        stash=stash)
    return _ring_finish(acc, q.dtype)


def ring_attention_emulated(qs, ks, vs, *, causal: bool = True,
                            scale: float | None = None,
                            stash: ForwardStash | None = None) -> list:
    """The ring over ``len(qs)`` ranks in one process: ``qs[r]``,
    ``ks[r]``, ``vs[r]`` are rank r's chunks, as
    :func:`ring_attention_local` takes them; the pass is a rotation of
    the lists (rank r receives rank r - 1's), the hops the same
    :func:`_ring_hop` in lockstep. Returns every rank's output."""
    cp = len(qs)
    scale = _scale(qs[0], scale)
    ks, vs = list(ks), list(vs)
    accs = [None] * cp
    for hop in range(cp):
        accs = [_ring_hop(qs[r], ks[r], vs[r], accs[r], rank=r, hop=hop,
                          cp=cp, causal=causal, scale=scale, stash=stash)
                for r in range(cp)]
        if hop + 1 < cp:
            ks, vs = ks[-1:] + ks[:-1], vs[-1:] + vs[:-1]
    return [_ring_finish(a, q.dtype) for a, q in zip(accs, qs)]


def _single_chunk(q, k, v, *, causal: bool, scale: float | None,
                  stash: ForwardStash | None = None):
    """Attention over one whole local sequence by the same engine choice
    as the ring's hops (flash, or the dense online softmax)."""
    scale = _scale(q, scale)
    if _flash_chunks(q):
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               stash=stash)
    b, s, h, d = q.shape
    m = torch.full((b, h, s), _NEG_INF, device=q.device)
    l = torch.zeros((b, h, s), device=q.device)
    o = torch.zeros((b, s, h, d), device=q.device)
    m, l, o = _block_attn(q, k, v, m, l, o, scale, 0, 0, causal)
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def expand_kv_unless(k, v, h: int, parts: int):
    """K/V expanded to ``h`` heads (each kv head repeated across its query
    group) unless their heads split evenly into ``parts``."""
    hk = k.shape[2]
    if hk == h or hk % max(parts, 1) == 0:
        return k, v
    rep = h // hk
    return k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)


def emulate_mesh(fn, q, k, v, mesh, *, batch_axes, seq_axis, head_axis):
    """Global ``[B, S, H, D]`` operands cut as a mesh lays them out —
    batch over the live ``batch_axes``, heads over ``head_axis``, the
    sequence over ``seq_axis`` — and ``fn(qs, ks, vs)`` run on each
    (batch, heads) shard's list of sequence chunks; the outputs are put
    back together. Only the mesh's sizes are read."""
    from tony_tpu_torch.parallel.mesh import mesh_shape
    shape = mesh_shape(mesh)
    b_axes, s_axis, h_axis = attention_spec(mesh, batch_axes, seq_axis,
                                            head_axis)
    nb = 1
    for a in b_axes:
        nb *= shape[a]
    ns = shape[s_axis] if s_axis else 1
    nh = shape[h_axis] if h_axis else 1
    rows = []
    for qb, kb, vb in zip(*(x.chunk(nb, dim=0) for x in (q, k, v))):
        heads = []
        for qh, kh, vh in zip(*(x.chunk(nh, dim=2) for x in (qb, kb, vb))):
            outs = fn(*(list(x.chunk(ns, dim=1)) for x in (qh, kh, vh)))
            heads.append(torch.cat(outs, dim=1))
        rows.append(torch.cat(heads, dim=2))
    return torch.cat(rows, dim=0)


def ring_attention(q, k, v, mesh, *, causal: bool = True,
                   scale: float | None = None,
                   batch_axes: Sequence[str] = ("dp", "fsdp"),
                   seq_axis: str = "cp", head_axis: str = "tp"):
    """Context-parallel attention over global ``[B, S, H, D]`` tensors on
    ``mesh`` (a ``DeviceMesh`` or its sizes), every rank emulated in this
    process: batch over the live data axes, the sequence over cp, heads
    over tp, the JAX wrapper's layout. GQA K/V ride the ring unexpanded
    when the kv heads split over tp (the ring's traffic is the K/V
    rotation) and are expanded first otherwise, as in the JAX package.
    Without a live cp axis each shard attends its whole sequence."""
    from tony_tpu_torch.parallel.mesh import mesh_shape
    h = q.shape[2]
    _check_kv_heads(h, k.shape[2])
    tp = mesh_shape(mesh).get(head_axis, 1) if head_axis else 1
    k, v = expand_kv_unless(k, v, h, tp)
    return emulate_mesh(
        lambda qs, ks, vs: ring_attention_emulated(
            qs, ks, vs, causal=causal, scale=scale),
        q, k, v, mesh, batch_axes=batch_axes, seq_axis=seq_axis,
        head_axis=head_axis)
