"""Pipeline parallelism: in-slice GPipe and 1F1B over ``pp``, and the
cross-slice 1F1B over TONYC1 stage links.

Port of ``tony_tpu/parallel/pipeline.py``. Stages hold contiguous layer
groups; a stage function maps an activation to one of the same shape
and dtype (``stage_fn(stage_params, h)``, or ``(h, aux)`` with
``with_aux``). Two in-slice schedules, each in two forms that run the
same per-rank step (the tick):

- **GPipe** (:func:`pipeline_apply`): every microbatch forward, then the
  backward through autograd, which replays the schedule in reverse. The
  hop is a pair of autograd functions over ``dist`` point-to-point
  (:class:`_SendAct`, :class:`_RecvAct`), whose backward sends the
  cotangent the other way: the counterpart of ``lax.ppermute``.
- **1F1B** (:func:`pipeline_value_and_grad`): the Megatron
  non-interleaved schedule in closed form (:func:`_fwd_sched`,
  :func:`_bwd_sched`). A forward tick saves only the stage input; a
  backward tick recomputes the stage forward under ``enable_grad`` and
  takes ``torch.autograd.grad`` of it, so at most S microbatch inputs
  are live per stage. The last stage seeds its backward from the loss
  head. It returns the loss and the gradients; it is not differentiated
  through.

The single-process forms (:func:`pipeline_apply`,
:func:`pipeline_value_and_grad`) take the global stacked params
``[S, ...]``, the global batch and a mesh's sizes, and emulate every
rank of it — the stages in turn, the hop a hand-over between them, the
data shards one after another. The distributed forms
(:func:`pipeline_apply_local`, :func:`pipeline_value_and_grad_local`)
run one rank's stage in a pp process group. The two call the same tick,
so their results agree bit for bit (CPU-tested in gloo groups); the
card runs the emulation, because NCCL refuses two ranks on one device.

Bubble ticks are skipped, not computed on garbage as the reference's
``lax.scan`` does, and the last stage folds its forward into its
backward tick (the cross-slice reference's rule). The transport is
arranged so that every rank runs the same sends and receives whatever
it skips: GPipe's receive node takes the stage's own params as an input,
so its backward (the cotangent's send) runs whichever leaves the caller
differentiates, and 1F1B exchanges one batch of point-to-point
operations a tick, which both ends derive from the same closed form.

**Cross-slice 1F1B** (:class:`CrossSlicePipeline`): each stage runs in
its own gang (process set), activations and cotangents hop between
gangs over TONYC1 channels (:mod:`tony_tpu_torch.channels.registry`).
The host drives the stage's share of the same schedule; a send copies
the tensor into pinned host memory on a side stream after an event and
hands it to a per-lane sender thread, so microbatch m±1's transport
overlaps microbatch m's compute. Its per-microbatch math is the in-slice
1F1B's own functions, so loss and gradients are bit-identical to
:func:`pipeline_value_and_grad` on the same params and microbatches.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Callable

import torch
import torch.distributed as dist

from tony_tpu_torch.parallel.mesh import mesh_shape
from tony_tpu_torch.parallel.spmd import _all_reduce, _CopyTo, _SumOver


# ---------------------------------------------------------------------------
# pytrees of dicts, tuples and lists
# ---------------------------------------------------------------------------
# the package's tree helpers walk dicts; a stage's params may also be
# tuples and lists, as the reference's pytrees are
def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree, leaves):
    it = iter(leaves)
    return _map(lambda _: next(it), tree)


def _fresh(tree):
    """Detached leaves that record a gradient (float leaves only)."""
    return _map(lambda t: t.detach().requires_grad_(t.is_floating_point()),
                tree)


def _add(acc, tree):
    return _map(torch.add, acc, tree)


# ---------------------------------------------------------------------------
# the 1F1B schedule in closed form (the reference's, per stage ``sg`` of S)
# ---------------------------------------------------------------------------
def _fwd_sched(sg: int, t: int, S: int, m: int) -> int | None:
    """The microbatch stage ``sg`` runs forward at tick ``t``, or None:
    warmup microbatch i < w = S-1-sg at tick sg + i, then microbatch
    i >= w at tick 2i + sg."""
    w = S - 1 - sg
    ts = t - sg
    if ts < 0:
        return None
    if ts < min(w, m):
        return ts
    if ts % 2 == 0 and w <= ts // 2 < m:
        return ts // 2
    return None


def _bwd_sched(sg: int, t: int, S: int, m: int) -> int | None:
    """The microbatch stage ``sg`` runs backward at tick ``t`` (tick
    2S-1-sg + 2i for microbatch i), or None."""
    u = t - (2 * S - 1 - sg)
    if u >= 0 and u % 2 == 0 and u // 2 < m:
        return u // 2
    return None


# ---------------------------------------------------------------------------
# one microbatch's backward, shared by every 1F1B form
# ---------------------------------------------------------------------------
def _grad_tree(tree, grads):
    return _rebuild(tree, [torch.zeros_like(t) if g is None else g
                           for t, g in zip(_leaves(tree), grads)])


def _stage_grads(stage_fn, params, saved, cot, with_aux=False,
                 aux_weight=0.0):
    """A mid stage's backward tick: recompute ``stage_fn(params, saved)``
    and pull ``cot`` (and, with ``with_aux``, the aux loss weighted by
    ``aux_weight``) back through it. Returns (the weighted aux as an f32
    0-d tensor, param grads, input cotangent)."""
    with torch.enable_grad():
        p = _fresh(params)
        x = saved.detach().requires_grad_(True)
        res = stage_fn(p, x)
        if with_aux:
            out, aux = res
            outs = (out, aux)
            seeds = (cot, torch.full_like(aux, aux_weight))
            lval = (aux_weight * aux.detach()).float()
        else:
            outs, seeds = (res,), (cot,)
            lval = torch.zeros((), dtype=torch.float32, device=saved.device)
        grads = torch.autograd.grad(outs, _leaves(p) + [x], seeds,
                                    allow_unused=True)
    return lval, _grad_tree(p, grads[:-1]), grads[-1]


def _last_grads(stage_fn, loss_head, params, head_params, saved, head_mb,
                with_aux=False, aux_weight=0.0, reduce_groups=()):
    """The last stage's backward tick: ``loss_head(head_params,
    stage_fn(params, saved), head_mb)`` (plus the weighted aux) seeded
    with 1. With ``reduce_groups`` (a vocab-sharded head) each rank's
    gradients are partial over those groups: the input cotangent is
    summed over them here, the param and head grads by the caller. The
    aux path is replicated there, so its seed is divided by the groups'
    size and the loss re-weighted (the reference's ``w_eff``). Returns
    (loss as an f32 0-d tensor, param grads, head grads, input
    cotangent)."""
    denom = 1
    for g in reduce_groups:
        denom *= dist.get_world_size(g)
    w_eff = aux_weight / denom
    with torch.enable_grad():
        p, hp = _fresh(params), _fresh(head_params)
        x = saved.detach().requires_grad_(True)
        res = stage_fn(p, x)
        if with_aux:
            out, aux = res
            loss = loss_head(hp, out, head_mb) + w_eff * aux
        else:
            loss = loss_head(hp, res, head_mb)
        n_p = len(_leaves(p))
        grads = torch.autograd.grad(loss, _leaves(p) + _leaves(hp) + [x],
                                    allow_unused=True)
    lval = loss.detach()
    if with_aux:
        lval = lval + (aux_weight - w_eff) * aux.detach().to(lval.dtype)
    dx = grads[-1]
    if reduce_groups:
        dx = _all_reduce(dx, reduce_groups)
    return (lval.float(), _grad_tree(p, grads[:n_p]),
            _grad_tree(hp, grads[n_p:-1]), dx)


class _Rank1F1B:
    """One rank's 1F1B state across the ticks of a step."""

    def __init__(self, s, params, head_params, xs, head_batches):
        self.s = s
        self.params, self.head_params = params, head_params
        self.xs, self.head_batches = xs, head_batches
        self.inbox: dict[int, torch.Tensor] = {}    # arrived activations
        self.resid: dict[int, torch.Tensor] = {}    # saved stage inputs
        self.cot: torch.Tensor | None = None        # arrived cotangent
        self.grads = _map(torch.zeros_like, params)
        self.hgrads = (None if head_params is None
                       else _map(torch.zeros_like, head_params))
        self.loss = torch.zeros((), dtype=torch.float32,
                                device=xs.device if xs is not None
                                else _leaves(params)[0].device)
        self.dxs: dict[int, torch.Tensor] = {}


def _tick_1f1b(st: _Rank1F1B, t: int, S: int, m: int, stage_fn, loss_head,
               with_aux: bool, aux_weight: float, reduce_groups=()):
    """Rank ``st.s``'s work at tick ``t``: its scheduled forward (the
    stage input saved; the output computed without a graph, except on
    the last stage, which folds it into the backward) and its scheduled
    backward. Returns what it sends: ``(i, activation)`` to the next
    stage and ``(j, cotangent)`` to the previous one, or None."""
    s = st.s
    send_f = send_b = None
    i = _fwd_sched(s, t, S, m)
    if i is not None:
        inp = st.xs[i] if s == 0 else st.inbox.pop(i)
        st.resid[i] = inp
        if s < S - 1:
            with torch.no_grad():
                out = stage_fn(st.params, inp)
            send_f = (i, out[0] if with_aux else out)
    j = _bwd_sched(s, t, S, m)
    if j is not None:
        saved = st.resid.pop(j)
        if s == S - 1:
            head_mb = _map(lambda a: a[j], st.head_batches)
            lval, dp, dhp, dx = _last_grads(
                stage_fn, loss_head, st.params, st.head_params, saved,
                head_mb, with_aux, aux_weight, reduce_groups)
            st.hgrads = _add(st.hgrads, dhp)
        else:
            cot, st.cot = st.cot, None
            lval, dp, dx = _stage_grads(stage_fn, st.params, saved, cot,
                                        with_aux, aux_weight)
        st.loss = st.loss + lval
        st.grads = _add(st.grads, dp)
        if s == 0:
            st.dxs[j] = dx
        else:
            send_b = (j, dx)
    return send_f, send_b


def _stage_views(stacked, S: int) -> list:
    """The S stage slices of a stacked ``[S, ...]`` tree (one unbind a
    leaf: its backward stacks the stages' grads once)."""
    per = [a.unbind(0) for a in _leaves(stacked)]
    return [_rebuild(stacked, [u[s] for u in per]) for s in range(S)]


def _num_stages(stacked) -> int:
    return _leaves(stacked)[0].shape[0]


def _data_size(shape: dict) -> int:
    """The number of data shards of a mesh's sizes: dp × fsdp."""
    return shape.get("dp", 1) * shape.get("fsdp", 1)


def _data_shards(xs, d: int) -> list:
    """The d data shards of microbatches ``[M, mb, ...]``: the mb rows
    split over the data ranks (the reference's ``P(None, data)``)."""
    if d == 1:
        return [xs]
    mb = xs.shape[1]
    if mb % d:
        raise ValueError(f"microbatch of {mb} rows does not split over "
                         f"{d} data ranks")
    n = mb // d
    return [xs[:, k * n:(k + 1) * n] for k in range(d)]


def _check_divisible(b: int, m: int) -> None:
    if b % m:
        raise ValueError(f"batch {b} not divisible into {m} microbatches")


def _check_stages(num_stages: int, pp: int) -> None:
    if num_stages != pp:
        raise ValueError(f"{num_stages} stacked stages but pp axis has "
                         f"{pp} ranks — need exactly one stage per rank")


# ---------------------------------------------------------------------------
# 1F1B
# ---------------------------------------------------------------------------
def _run_1f1b_emulated(stage_fn, stages, head_params, xs, head_batches, *,
                       loss_head, with_aux, aux_weight):
    """Every stage of one data shard through the 1F1B ticks in one
    process: each tick runs every rank's step, then hands the sends
    over (the hop a list rotation). Returns the per-rank states."""
    S, m = len(stages), xs.shape[0]
    ranks = [_Rank1F1B(s, stages[s], head_params if s == S - 1 else None,
                       xs if s == 0 else None,
                       head_batches if s == S - 1 else None)
             for s in range(S)]
    for t in range(2 * m + 2 * S - 2):
        sent = [_tick_1f1b(r, t, S, m, stage_fn, loss_head, with_aux,
                           aux_weight) for r in ranks]
        for s, (send_f, send_b) in enumerate(sent):
            if send_f is not None:
                ranks[s + 1].inbox[send_f[0]] = send_f[1]
            if send_b is not None:
                ranks[s - 1].cot = send_b[1]
    return ranks


def _degenerate_value_and_grad(stage_fn, stacked, head_params, xs,
                               head_batches, loss_head, with_aux,
                               aux_weight):
    """No pp axis: the same value and gradient by plain autograd, the
    stages in turn on each microbatch, the loss the microbatches' mean."""
    with torch.enable_grad():
        sp, hp = _fresh(stacked), _fresh(head_params)
        x = xs.detach().requires_grad_(True)
        stages = _stage_views(sp, _num_stages(sp))
        losses = []
        for i in range(xs.shape[0]):
            h = x[i]
            aux = 0.0
            for p in stages:
                res = stage_fn(p, h)
                h, aux = (res[0], aux + res[1]) if with_aux else (res, aux)
            loss = loss_head(hp, h, _map(lambda a: a[i], head_batches))
            losses.append(loss + aux_weight * aux if with_aux else loss)
        loss = torch.stack(losses).mean()
        n_s, n_h = len(_leaves(sp)), len(_leaves(hp))
        grads = torch.autograd.grad(loss, _leaves(sp) + _leaves(hp) + [x],
                                    allow_unused=True)
    return (loss.detach().float(), _grad_tree(sp, grads[:n_s]),
            _grad_tree(hp, grads[n_s:n_s + n_h]), grads[-1])


def pipeline_value_and_grad(stage_fn: Callable, stacked_params: Any,
                            x: torch.Tensor, head_params: Any,
                            head_batch: Any, mesh, *, loss_head: Callable,
                            num_microbatches: int, with_aux: bool = False,
                            aux_weight: float = 0.0):
    """1F1B: loss and gradients in one schedule, every rank of ``mesh``
    (a dict of axis sizes) emulated in this process.

    ``stacked_params``: leaves ``[S, ...]``, S the pp axis' size;
    ``x``: the global ``[B, ...]`` stage-0 input; ``head_batch``: leaves
    ``[B, ...]`` (targets), microbatched beside it;
    ``loss_head(head_params, out_mb, head_batch_mb) -> scalar``, the
    mean loss of one microbatch shard. Returns ``(loss, stage_grads,
    head_grads, dx)`` as the reference: the loss and grads averaged over
    microbatches and data shards, ``dx = d loss / d x`` (feed it to the
    backward of whatever produced ``x``). Without a pp axis the same
    contract by plain autograd."""
    b = x.shape[0]
    m = num_microbatches
    _check_divisible(b, m)
    shape = mesh_shape(mesh) if mesh is not None else {}
    xs = x.reshape((m, b // m) + x.shape[1:])
    head_xs = _map(lambda a: a.reshape((m, b // m) + a.shape[1:]),
                   head_batch)
    pp = shape.get("pp", 1)
    if pp == 1:
        loss, g_sp, g_hp, g_xs = _degenerate_value_and_grad(
            stage_fn, stacked_params, head_params, xs, head_xs, loss_head,
            with_aux, aux_weight)
        return loss, g_sp, g_hp, g_xs.reshape(x.shape)
    S = _num_stages(stacked_params)
    _check_stages(S, pp)
    d = _data_size(shape)
    stages = [_map(torch.Tensor.detach, p)
              for p in _stage_views(stacked_params, S)]
    head = _map(torch.Tensor.detach, head_params)
    shard_x = _data_shards(xs.detach(), d)
    shard_h = list(zip(*[_data_shards(a, d)
                         for a in _leaves(head_xs)]))
    runs = [_run_1f1b_emulated(stage_fn, stages, head, shard_x[k],
                               _rebuild(head_xs, shard_h[k]),
                               loss_head=loss_head, with_aux=with_aux,
                               aux_weight=aux_weight) for k in range(d)]
    # the reference's reductions: the loss sums over stages; over data
    # shards the loss and grads average (the grads as the sum of each
    # shard's share, as the distributed ranks' Partial grads add up); dx
    # is each shard's, scaled
    loss = _sum_in_order([_sum_in_order([r.loss for r in ranks]) / m
                          for ranks in runs]) / d
    grads = [_map(lambda *g: _sum_in_order([x / d / m for x in g]),
                  *[runs[k][s].grads for k in range(d)]) for s in range(S)]
    hgrads = _map(lambda *g: _sum_in_order([x / d / m for x in g]),
                  *[runs[k][-1].hgrads for k in range(d)])
    dxs = torch.cat([torch.stack([runs[k][0].dxs[i] for i in range(m)])
                     for k in range(d)], dim=1) / (m * d)
    g_sp = _map(lambda *g: torch.stack(g), *grads)
    return loss, g_sp, hgrads, dxs.reshape(x.shape)


def _sum_in_order(xs):
    out = xs[0]
    for v in xs[1:]:
        out = out + v
    return out


def _peers(group) -> list[int]:
    return dist.get_process_group_ranks(group)


def _exchange(st: _Rank1F1B, t: int, S: int, m: int, send_f, send_b,
              like: torch.Tensor, peers: list[int], group) -> None:
    """One tick's point-to-point batch in the pp group: this rank's
    sends, and the receives its neighbours' closed-form schedule says
    are coming (the activation stage s-1 forwarded this tick, the
    cotangent stage s+1 pulled back)."""
    s = st.s
    ops, recv_a, recv_c = [], None, None
    if send_f is not None:
        ops.append(dist.P2POp(dist.isend, send_f[1].contiguous(),
                              peers[s + 1], group))
    if send_b is not None:
        ops.append(dist.P2POp(dist.isend, send_b[1].contiguous(),
                              peers[s - 1], group))
    i = _fwd_sched(s - 1, t, S, m) if s > 0 else None
    if i is not None:
        recv_a = (i, torch.empty_like(like))
        ops.append(dist.P2POp(dist.irecv, recv_a[1], peers[s - 1], group))
    if s < S - 1 and _bwd_sched(s + 1, t, S, m) is not None:
        recv_c = torch.empty_like(like)
        ops.append(dist.P2POp(dist.irecv, recv_c, peers[s + 1], group))
    if not ops:
        return
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if recv_a is not None:
        st.inbox[recv_a[0]] = recv_a[1]
    if recv_c is not None:
        st.cot = recv_c


def pipeline_value_and_grad_local(stage_fn: Callable, stage_params: Any,
                                  head_params: Any, xs: torch.Tensor,
                                  head_batches: Any, *,
                                  loss_head: Callable, pp_group,
                                  data_groups=(), head_reduce_groups=(),
                                  head_sharded: Any = None,
                                  with_aux: bool = False,
                                  aux_weight: float = 0.0):
    """One rank of :func:`pipeline_value_and_grad` in the process group
    ``pp_group`` (its rank there is its stage).

    ``stage_params``: this stage's params; ``head_params``: the head's,
    passed on every stage (their shapes are the pp all-reduce's);
    ``head_batches`` (leaves ``[M, mb, ...]``): the last stage's (others
    may pass None); ``xs``: this rank's microbatches ``[M, mb, ...]``
    (every stage passes them: their shape and dtype are the wire's).
    ``data_groups``: the groups of the data axes the loss and grads
    average over: the loss comes back averaged, the stage and head grads
    as this rank's share of the average (its grads over the data size
    and the microbatch count), for the caller to sum over the data
    ranks, as the backward of a ``Partial`` placement does.
    ``head_reduce_groups``: the groups a vocab-sharded head is split
    over (the last stage's param grads, and its head leaves not marked
    in ``head_sharded`` — a tree of bools beside ``head_params`` — are
    summed over them). Returns ``(loss, stage_grads, head_grads, dxs)``:
    the loss, head grads and dxs replicated over pp."""
    S, s = dist.get_world_size(pp_group), dist.get_rank(pp_group)
    m = xs.shape[0]
    peers = _peers(pp_group)
    params = _map(torch.Tensor.detach, stage_params)
    last = s == S - 1
    st = _Rank1F1B(s, params, _map(torch.Tensor.detach, head_params)
                   if last else None, xs.detach() if s == 0 else None,
                   head_batches if last else None)
    for t in range(2 * m + 2 * S - 2):
        send_f, send_b = _tick_1f1b(st, t, S, m, stage_fn, loss_head,
                                    with_aux, aux_weight,
                                    head_reduce_groups)
        _exchange(st, t, S, m, send_f, send_b, xs[0], peers, pp_group)
    grads, hgrads = st.grads, st.hgrads
    if last and head_reduce_groups:
        # the last stage's partials over the head's vocab shards
        grads = _map(lambda g: _all_reduce(g, head_reduce_groups), grads)
        sharded = (head_sharded if head_sharded is not None
                   else _map(lambda _: False, head_params))
        hgrads = _map(lambda g, sh: g if sh else
                      _all_reduce(g, head_reduce_groups), hgrads, sharded)
    # the loss sums over stages; the head grads and dxs live on one
    # stage each and are replicated over pp
    loss = _all_reduce(st.loss, [pp_group]) / m
    if not last:
        hgrads = _map(torch.zeros_like, head_params)
    hgrads = _map(lambda g: _all_reduce(g, [pp_group]), hgrads)
    dxs = (torch.stack([st.dxs[i] for i in range(m)]) if s == 0
           else torch.zeros_like(xs))
    dxs = _all_reduce(dxs, [pp_group])
    d = 1
    for g in data_groups:
        d *= dist.get_world_size(g)
    if data_groups:
        loss = _all_reduce(loss, data_groups) / d
    grads = _map(lambda g: g / d / m, grads)
    hgrads = _map(lambda g: g / d / m, hgrads)
    return loss, grads, hgrads, dxs / (m * d)


# ---------------------------------------------------------------------------
# GPipe
# ---------------------------------------------------------------------------
def _gpipe_stage(stage_fn, params, h, with_aux):
    """One stage on one microbatch: (output, aux or None)."""
    res = stage_fn(params, h)
    return res if with_aux else (res, None)


class _RecvAct(torch.autograd.Function):
    """Receive a microbatch's activation from the previous stage;
    backward: send its cotangent back. ``anchors`` (the stage's params,
    and the microbatch input when it records a gradient) tie the node
    into this rank's graph, so its backward runs whatever the caller
    differentiates; they get no gradient from it but the input's zero."""

    @staticmethod
    def forward(ctx, like, src, group, with_mb, *anchors):
        ctx.src, ctx.group = src, group
        ctx.n, ctx.with_mb = len(anchors), with_mb
        buf = torch.empty_like(like)
        dist.recv(buf, src=src, group=group)
        return buf

    @staticmethod
    def backward(ctx, g):
        dist.send(g.contiguous(), dst=ctx.src, group=ctx.group)
        grads = [None] * ctx.n
        if ctx.with_mb:
            grads[0] = torch.zeros_like(g)
        return (None, None, None, None, *grads)


class _SendAct(torch.autograd.Function):
    """Send a microbatch's activation to the next stage; returns a 0-d
    zero (summed into this rank's output so autograd reaches the node);
    backward: receive the activation's cotangent from the next stage."""

    @staticmethod
    def forward(ctx, out, dst, group):
        ctx.dst, ctx.group = dst, group
        ctx.like = (out.shape, out.dtype, out.device)
        dist.send(out.contiguous(), dst=dst, group=group)
        return out.new_zeros(())

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.like
        buf = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(buf, src=ctx.dst, group=ctx.group)
        return buf, None, None


def _gpipe_emulated(stage_fn, stages, xs, with_aux):
    """Every stage of one data shard in one process, microbatch by
    microbatch: ([M, mb, ...] last-stage outputs, per-stage aux sums)."""
    outs = []
    aux = [torch.zeros((), dtype=torch.float32, device=xs.device)
           for _ in stages]
    for i in range(xs.shape[0]):
        h = xs[i]
        for s, p in enumerate(stages):
            h, a = _gpipe_stage(stage_fn, p, h, with_aux)
            if with_aux:
                aux[s] = aux[s] + a
        outs.append(h)
    return torch.stack(outs), aux


def pipeline_apply(stage_fn: Callable, stacked_params: Any, x: torch.Tensor,
                   mesh, *, num_microbatches: int, with_aux: bool = False):
    """GPipe: ``x`` (global ``[B, ...]``) through S stages of
    ``stage_fn``, every rank of ``mesh`` (a dict of axis sizes) emulated
    in this process; differentiable through autograd. Returns ``[B,
    ...]``, and with ``with_aux`` ``(out, aux)``: the stages' scalars of
    their microbatches summed over stages, averaged over microbatches
    and data shards (the MoE load-balance channel). Without a pp axis
    the stages run in turn on the whole batch."""
    b = x.shape[0]
    m = num_microbatches
    _check_divisible(b, m)
    shape = mesh_shape(mesh) if mesh is not None else {}
    S = _num_stages(stacked_params)
    stages = _stage_views(stacked_params, S)
    pp = shape.get("pp", 1)
    if pp == 1:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for p in stages:
            x, a = _gpipe_stage(stage_fn, p, x, with_aux)
            if with_aux:
                aux = aux + a
        return (x, aux) if with_aux else x
    _check_stages(S, pp)
    d = _data_size(shape)
    xs = x.reshape((m, b // m) + x.shape[1:])
    runs = [_gpipe_emulated(stage_fn, stages, shard, with_aux)
            for shard in _data_shards(xs, d)]
    out = torch.cat([r[0] for r in runs], dim=1).reshape(x.shape)
    if not with_aux:
        return out
    aux = _sum_in_order([_sum_in_order(r[1]) for r in runs]) / d
    return out, aux / m


def pipeline_apply_local(stage_fn: Callable, stage_params: Any,
                         xs: torch.Tensor, *, pp_group, data_groups=(),
                         with_aux: bool = False):
    """One rank of :func:`pipeline_apply` in the process group
    ``pp_group`` (its rank there is its stage): ``stage_params`` this
    stage's, ``xs`` this rank's microbatches ``[M, mb, ...]``, the same
    on every stage (stage 0 reads them). Returns the last stage's
    outputs ``[M, mb, ...]`` on every stage (summed over pp, identity
    backward), and with ``with_aux`` the aux averaged over the
    ``data_groups`` and microbatches. The cotangent of ``xs`` is summed
    over pp, so every stage's copy of it gets the whole gradient."""
    S, s = dist.get_world_size(pp_group), dist.get_rank(pp_group)
    peers = _peers(pp_group)
    m = xs.shape[0]
    grad_on = torch.is_grad_enabled()
    if grad_on and xs.requires_grad:
        xs = _CopyTo.apply(xs, [pp_group])
    anchors = [t for t in _leaves(stage_params)
               if grad_on and t.requires_grad][:1]
    outs, toks = [], []
    aux = torch.zeros((), dtype=torch.float32, device=xs.device)
    for i in range(m):
        if s == 0:
            h = xs[i]
        else:
            mb_anchor = [xs[i]] if grad_on and xs.requires_grad else []
            h = _RecvAct.apply(xs[i].detach(), peers[s - 1], pp_group,
                               bool(mb_anchor), *mb_anchor, *anchors)
        h, a = _gpipe_stage(stage_fn, stage_params, h, with_aux)
        if with_aux:
            aux = aux + a
        if s < S - 1:
            toks.append(_SendAct.apply(h, peers[s + 1], pp_group))
        else:
            outs.append(h)
    if s == S - 1:
        local = torch.stack(outs)
    else:
        local = torch.zeros_like(xs)
        for tok in toks:
            local = local + tok.to(local.dtype)
    out = _SumOver.apply(local, [pp_group])
    if not with_aux:
        return out
    aux = _SumOver.apply(aux, [pp_group])
    if data_groups:
        d = 1
        for g in data_groups:
            d *= dist.get_world_size(g)
        aux = _SumOver.apply(aux, list(data_groups)) / d
    return out, aux / m


# ---------------------------------------------------------------------------
# cross-slice MPMD 1F1B over TONYC1 channels
# ---------------------------------------------------------------------------
class _DeviceClock:
    """Busy time of compute sections: CUDA events on the card (summed
    once the step's work is done), the host's clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.pairs: list = []
        self.host = 0.0

    def section(self):
        clock = self

        class _Section:
            def __enter__(self):
                if clock.cuda:
                    self.ev = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
                    self.ev[0].record()
                else:
                    self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                if clock.cuda:
                    self.ev[1].record()
                    clock.pairs.append(self.ev)
                else:
                    clock.host += time.perf_counter() - self.t0

        return _Section()

    def seconds(self) -> float:
        if self.cuda:
            torch.cuda.synchronize()
            return sum(a.elapsed_time(b) for a, b in self.pairs) / 1e3
        return self.host


class _Lane:
    """One outgoing channel and its sender thread. ``put`` takes a
    device tensor: on the card it is copied into pinned host memory on a
    side stream after an event that follows its compute, and the thread
    waits for that copy before handing the buffer to the channel, so the
    schedule's thread never waits on the wire or the copy. The thread is
    the channel's only producer, and it keeps the order of ``put``."""

    def __init__(self, sender, timeout: float | None):
        self.sender, self.timeout = sender, timeout
        self.q: queue.Queue = queue.Queue()
        self.error: BaseException | None = None
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name=f"tony-pp-{sender.channel}")
        self.thread.start()
        self._stream = None

    def _run(self) -> None:
        while True:
            item = self.q.get()
            try:
                if item is None:
                    return
                host, done, on_sent = item
                if done is not None:
                    done.synchronize()
                if self.error is None:
                    seq = self.sender.send(host, timeout=self.timeout)
                    if on_sent is not None:
                        on_sent(seq)
            except BaseException as exc:    # raised on the next put
                self.error = exc
            finally:
                self.q.task_done()

    def put(self, t: torch.Tensor, on_sent=None) -> None:
        """Queue ``t``; ``on_sent(seq)`` runs on the lane's thread once
        the channel took it."""
        if self.error is not None:
            raise self.error
        t = t.detach()
        if t.device.type != "cuda":
            self.q.put((t, None, on_sent))
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=t.device)
        ready = torch.cuda.Event()
        ready.record()
        self._stream.wait_event(ready)
        with torch.cuda.stream(self._stream):
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        t.record_stream(self._stream)
        self.q.put((host, done, on_sent))

    def flush(self) -> None:
        self.q.join()
        if self.error is not None:
            raise self.error

    def close(self) -> None:
        self.q.put(None)
        self.thread.join(timeout=30)


def _to_device(arr, device) -> torch.Tensor:
    """A received wire array (numpy, or a CPU ``torch.bfloat16``) on
    ``device``."""
    t = arr if isinstance(arr, torch.Tensor) else torch.tensor(arr)
    return t.to(device)


class CrossSlicePipeline:
    """Host-driven 1F1B for one stage gang of a cross-slice pipeline.

    Each gang builds one around its own (unstacked) ``stage_fn`` and its
    :class:`~tony_tpu_torch.channels.registry.StageLinks`; every gang
    calling :meth:`value_and_grad` with the same microbatch count runs
    the Megatron non-interleaved 1F1B across gangs: stage ``s`` runs
    ``min(S-1-s+lookahead, M)`` warmup forwards, then forward/backward
    pairs, then drains its backwards. Activations go to ``stage+1`` and
    cotangents to ``stage-1`` over the links; a send returns once its
    tensor is handed to the lane's thread (``sync_transport=True`` sends
    on the schedule's thread and waits for the ack: the serialized
    baseline). A backward recomputes the stage forward from the saved
    input — the in-slice 1F1B's functions, so the loss and gradients are
    bit-identical to :func:`pipeline_value_and_grad`.

    The last stage owns ``loss_head``. With ``links.interleave`` = v > 1
    the gang holds v chunks (chunk j is virtual stage ``j*S + s``), each
    driven by its own host thread through its projection of the V-stage
    schedule, a per-gang lock serializing their compute; ``params`` is
    then a list of v per-chunk trees. ``with_aux`` stage functions are
    not supported across slices (as in the reference).

    Observability: ``tony_pipeline_step_seconds`` (wall a call),
    ``tony_pipeline_bubble_fraction{stage=}`` (1 - compute/wall of the
    last call; compute is device time from CUDA events on the card) and
    ``tony_pipeline_microbatches_total{stage=}`` in the registry, and a
    span a step and a microbatch under a trace id every gang derives from
    the job's trace, session and epoch and the call's ordinal.
    """

    def __init__(self, stage_fn: Callable, links, *,
                 loss_head: Callable | None = None, lookahead: int = 0,
                 sync_transport: bool = False,
                 send_timeout_s: float | None = 120.0,
                 recv_timeout_s: float | None = 120.0,
                 registry=None, device=None) -> None:
        from tony_tpu_torch import constants as _c
        from tony_tpu_torch import resolve_device
        from tony_tpu_torch.runtime import metrics as metrics_mod
        from tony_tpu_torch.runtime import tracing
        self._tracing = tracing
        self._tracer = tracing.get_tracer()
        job_ctx = tracing.parse_env_ctx()
        # every gang of one generation derives the same seed: the job
        # trace, the session and the cluster epoch (a relaunched trainer
        # never re-mints a previous generation's ids)
        self._trace_seed = (
            (job_ctx["tid"] if job_ctx else "local-pipeline")
            + f":{os.environ.get(_c.SESSION_ID, '0')}"
            + f":{os.environ.get(_c.CLUSTER_EPOCH, '0')}")
        self._calls = 0
        self.device = resolve_device(device)
        self.stage_fn, self.loss_head = stage_fn, loss_head
        self.links = links
        self.stage = links.stage
        self.num_stages = links.num_stages
        #: extra in-flight microbatches beyond the 1F1B minimum (more
        #: warmup forwards cover the wire's round trip); the backwards'
        #: order never changes, so results are bit-identical at any value
        self.lookahead = lookahead
        self.sync_transport = sync_transport
        self.send_timeout_s = send_timeout_s
        self.recv_timeout_s = recv_timeout_s
        self.interleave = getattr(links, "interleave", 1) or 1
        self.num_virtual = self.num_stages * self.interleave
        self._device_lock = threading.Lock()
        if links.is_last and loss_head is None:
            raise ValueError("the last stage needs the loss head")
        self._lanes: dict[int, _Lane] = {}
        self.last_step: dict = {}
        reg = registry if registry is not None \
            else metrics_mod.get_default()
        self._step_hist = reg.histogram(
            "tony_pipeline_step_seconds",
            help="wall seconds per cross-slice 1F1B value_and_grad call",
            stage=str(self.stage))
        self._bubble_gauge = reg.gauge(
            "tony_pipeline_bubble_fraction",
            help="1 - compute/wall for the last 1F1B call (this stage's "
                 "pipeline bubble + transport stall share)",
            stage=str(self.stage))
        self._mb_counter = reg.counter(
            "tony_pipeline_microbatches_total",
            help="microbatches processed by this stage",
            stage=str(self.stage))

    # -- transport ------------------------------------------------------
    def _send(self, sender, t: torch.Tensor, on_sent=None) -> None:
        """Ship ``t``; ``on_sent(seq)`` gets its channel seq (on the
        lane's thread unless the transport is synchronous)."""
        if self.sync_transport:
            seq = sender.send(t.detach().cpu(), sync=True,
                              timeout=self.send_timeout_s)
            if on_sent is not None:
                on_sent(seq)
            return
        lane = self._lanes.get(id(sender))
        if lane is None:
            lane = self._lanes[id(sender)] = _Lane(sender,
                                                   self.send_timeout_s)
        lane.put(t, on_sent)

    def _recv(self, receiver) -> torch.Tensor:
        return _to_device(receiver.recv(self.recv_timeout_s), self.device)

    def _flush(self) -> None:
        for lane in self._lanes.values():
            lane.flush()

    def close(self) -> None:
        """Stop the lanes' threads (their queued sends go out first)."""
        for lane in self._lanes.values():
            lane.flush()
            lane.close()
        self._lanes.clear()

    # -- compute (methods, so instrumentation can wrap them) -------------
    def _forward_compute(self, params, x):
        with torch.no_grad():
            return self.stage_fn(params, x)

    def _backward_compute(self, params, saved, cot):
        _, dp, dx = _stage_grads(self.stage_fn, params, saved, cot)
        return dp, dx

    def _last_compute(self, params, head_params, saved, head_mb):
        lval, dp, dhp, dx = _last_grads(self.stage_fn, self.loss_head,
                                        params, head_params, saved, head_mb)
        return lval, dp, dhp, dx

    def _ids(self):
        self._calls += 1
        tid = self._tracing.deterministic_trace_id(
            f"{self._trace_seed}:step:{self._calls}")
        root = self._tracing.deterministic_span_id(f"{tid}:root")
        stage = self._tracing.deterministic_span_id(f"{tid}:s{self.stage}")
        traced = (self._tracer.enabled
                  and self._tracing.deterministic_sample(
                      tid, self._tracer.sample_rate))
        return tid, root, stage, traced

    def _check_inputs(self, m, microbatches, head_params, head_batches):
        if self.links.is_first:
            if microbatches is None:
                raise ValueError("stage 0 must supply microbatches")
            if microbatches.shape[0] != m:
                raise ValueError(
                    f"microbatches leading dim {microbatches.shape[0]} != "
                    f"num_microbatches {m}")
        if self.links.is_last and (head_batches is None
                                   or head_params is None):
            raise ValueError("the last stage must supply head_params and "
                             "head_batches")

    def _finish(self, wall, busy, m, tid, root, stage_sid, traced,
                **attrs) -> float:
        self._step_hist.observe(wall)
        bubble = max(0.0, 1.0 - busy / wall) if wall > 0 else 0.0
        self._bubble_gauge.set(bubble)
        #: the last call's wall, compute (busy) seconds and bubble share
        self.last_step = {"wall_s": wall, "busy_s": busy, "bubble": bubble}
        if traced:
            self._tracer.record_span(
                "pipeline.stage", wall, trace_id=tid, span_id=stage_sid,
                parent_id=root, stage=self.stage, microbatches=m,
                bubble=round(bubble, 4), **attrs)
            if self.links.is_first:
                self._tracer.record_span(
                    "pipeline.step", wall, trace_id=tid, span_id=root,
                    step=self._calls, num_stages=self.num_stages,
                    microbatches=m)
        return bubble

    def value_and_grad(self, params, *, num_microbatches: int,
                       microbatches: torch.Tensor | None = None,
                       head_params: Any = None, head_batches: Any = None):
        """This stage's share of one global batch's 1F1B; every gang
        calls it with the same ``num_microbatches``. Stage 0 supplies
        ``microbatches`` (``[M, mb, ...]``), the last stage
        ``head_params`` and ``head_batches`` (leaves ``[M, mb, ...]``).
        Returns ``(loss, grads, head_grads, dxs)``: ``loss`` and
        ``head_grads`` only on the last stage, ``dxs`` (``[M, mb,
        ...]``) only on stage 0, ``grads`` like ``params``."""
        if self.interleave > 1:
            return self._value_and_grad_interleaved(
                params, num_microbatches=num_microbatches,
                microbatches=microbatches, head_params=head_params,
                head_batches=head_batches)
        links = self.links
        m = num_microbatches
        self._check_inputs(m, microbatches, head_params, head_batches)
        tid, root, stage_sid, traced = self._ids()
        t_start = time.perf_counter()
        clock = _DeviceClock(self.device)
        saved: dict[int, torch.Tensor] = {}
        grads = _map(torch.zeros_like, params)
        hgrads = (_map(torch.zeros_like, head_params) if links.is_last
                  else None)
        loss_acc = (torch.zeros((), dtype=torch.float32, device=self.device)
                    if links.is_last else None)
        dx_list: list[torch.Tensor] = []

        def mb_span(name, i, t0, seq_in, seq_out=-1):
            # the hop seqs (sender and receiver tag the same one) let a
            # reader stitch microbatch i's journey across gangs
            attrs = {"stage": self.stage, "mb": i}
            if seq_in >= 0:
                attrs["seq"] = seq_in
            if seq_out >= 0:
                attrs.setdefault("seq", seq_out)
                attrs["seq_out"] = seq_out
            self._tracer.record_span(name, time.perf_counter() - t0,
                                     trace_id=tid, parent_id=stage_sid,
                                     **attrs)

        def sent(name, i, tmb, seq_in):
            if not traced:
                return None
            return lambda seq: mb_span(name, i, tmb, seq_in, seq)

        def do_forward(i):
            tmb = time.perf_counter()
            seq_in = -1
            if links.is_first:
                x = microbatches[i]
            else:
                x = self._recv(links.act_in)
                seq_in = links.act_in.last_seq
            saved[i] = x
            if links.is_last:
                if traced:
                    mb_span("pipeline.forward", i, tmb, seq_in)
                return      # the last stage folds its forward into _last
            with clock.section():
                out = self._forward_compute(params, x)
            self._send(links.act_out, out,
                       sent("pipeline.forward", i, tmb, seq_in))

        def do_backward(i):
            nonlocal grads, hgrads, loss_acc
            tmb = time.perf_counter()
            seq_in = -1
            if links.is_last:
                head_mb = _map(lambda a: a[i], head_batches)
                with clock.section():
                    lval, dp, dhp, dx = self._last_compute(
                        params, head_params, saved.pop(i), head_mb)
                    loss_acc = loss_acc + lval
                    grads = _add(grads, dp)
                    hgrads = _add(hgrads, dhp)
            else:
                cot = self._recv(links.grad_in)
                seq_in = links.grad_in.last_seq
                with clock.section():
                    dp, dx = self._backward_compute(params, saved.pop(i),
                                                    cot)
                    grads = _add(grads, dp)
            if links.is_first:
                dx_list.append(dx)
                if traced:
                    mb_span("pipeline.backward", i, tmb, seq_in)
            else:
                self._send(links.grad_out, dx,
                           sent("pipeline.backward", i, tmb, seq_in))
            self._mb_counter.inc()

        warmup = min(self.num_stages - 1 - self.stage + self.lookahead, m)
        for i in range(warmup):
            do_forward(i)
        for i in range(m):
            if i + warmup < m:
                do_forward(i + warmup)
            do_backward(i)
        self._flush()
        grads = _map(lambda g: g / m, grads)
        loss = None
        if links.is_last:
            loss = loss_acc / m
            hgrads = _map(lambda g: g / m, hgrads)
        dxs = torch.stack(dx_list) / m if links.is_first else None
        busy = clock.seconds()
        wall = time.perf_counter() - t_start
        self._finish(wall, busy, m, tid, root, stage_sid, traced)
        return loss, grads, hgrads, dxs

    def _value_and_grad_interleaved(self, params_list, *,
                                    num_microbatches: int,
                                    microbatches=None, head_params=None,
                                    head_batches=None):
        """Chunk j is virtual stage ``g = j*S + s`` of the V-stage
        pipeline, driven by its own host thread through the per-stage
        projection of the V-stage non-interleaved schedule (warmup
        ``min(V-1-g+lookahead, m)``). Receives block on the per-chunk
        lanes, so the global order emerges from the data flow; each
        chunk accumulates in microbatch order, which makes it
        bit-identical to stage g of the in-slice V-stage schedule."""
        links = self.links
        v, S, V = self.interleave, self.num_stages, self.num_virtual
        m = num_microbatches
        if not isinstance(params_list, (list, tuple)) or \
                len(params_list) != v:
            raise ValueError(f"interleave={v}: params must be a list/tuple "
                             f"of {v} per-chunk trees")
        self._check_inputs(m, microbatches, head_params, head_batches)
        tid, root, stage_sid, traced = self._ids()
        t_start = time.perf_counter()
        clock = _DeviceClock(self.device)
        results: list = [None] * v
        failures: list = []

        def run_chunk(j):
            g = j * S + self.stage
            params = params_list[j]
            act_in, act_out = links.act_ins[j], links.act_outs[j]
            grad_in, grad_out = links.grad_ins[j], links.grad_outs[j]
            saved: dict[int, torch.Tensor] = {}
            grads = _map(torch.zeros_like, params)
            hgrads = (_map(torch.zeros_like, head_params) if g == V - 1
                      else None)
            loss_acc = (torch.zeros((), dtype=torch.float32,
                                    device=self.device)
                        if g == V - 1 else None)
            dx_list: list = []

            def do_forward(i):
                x = microbatches[i] if g == 0 else self._recv(act_in)
                saved[i] = x
                if g == V - 1:
                    return
                with self._device_lock, clock.section():
                    out = self._forward_compute(params, x)
                self._send(act_out, out)

            def do_backward(i):
                nonlocal grads, hgrads, loss_acc
                if g == V - 1:
                    head_mb = _map(lambda a: a[i], head_batches)
                    with self._device_lock, clock.section():
                        lval, dp, dhp, dx = self._last_compute(
                            params, head_params, saved.pop(i), head_mb)
                        loss_acc = loss_acc + lval
                        grads = _add(grads, dp)
                        hgrads = _add(hgrads, dhp)
                else:
                    cot = self._recv(grad_in)
                    with self._device_lock, clock.section():
                        dp, dx = self._backward_compute(
                            params, saved.pop(i), cot)
                        grads = _add(grads, dp)
                if g == 0:
                    dx_list.append(dx)
                else:
                    self._send(grad_out, dx)
                self._mb_counter.inc()

            warmup = min(V - 1 - g + self.lookahead, m)
            for i in range(warmup):
                do_forward(i)
            for i in range(m):
                if i + warmup < m:
                    do_forward(i + warmup)
                do_backward(i)
            results[j] = (grads, loss_acc, hgrads, dx_list)

        def chunk_main(j):
            try:
                run_chunk(j)
            except BaseException as exc:    # raised after the join
                failures.append((j, exc))

        threads = [threading.Thread(target=chunk_main, args=(j,),
                                    name=f"tony-pp-chunk{j}", daemon=True)
                   for j in range(v)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if failures:
            j, exc = failures[0]
            raise RuntimeError(f"interleaved chunk {j} (virtual stage "
                               f"{j * S + self.stage}) failed") from exc
        self._flush()
        grads_out = [_map(lambda a: a / m, r[0]) for r in results]
        loss = hgrads = dxs = None
        if links.is_last:
            loss = results[v - 1][1] / m
            hgrads = _map(lambda a: a / m, results[v - 1][2])
        if links.is_first:
            dxs = torch.stack(results[0][3]) / m
        busy = clock.seconds()
        wall = time.perf_counter() - t_start
        self._finish(wall, busy, m, tid, root, stage_sid, traced,
                     interleave=v)
        return loss, grads_out, hgrads, dxs
