"""Mixture-of-experts: gshard-style top-k routing with capacity, and the
expert feed-forward block.

Port of ``tony_tpu/parallel/moe.py`` (``MoEMetrics``, ``router_dispatch``,
``default_capacity``, ``moe_ffn``), op for op. Dispatch and combine are
dense einsums against a capacity-bounded one-hot routing tensor
``[B, S, E, C]``: each expert takes a fixed ``capacity`` of tokens per
batch row, and the tokens past it are dropped (their combine weight is
zero). Static shapes, no per-token gather or scatter. The einsums are
plain ``torch.einsum``; no kernel of the JAX package lies on this path.

Routing order is the JAX package's: the top-k experts of a token in
descending probability, the lower expert index first among equal
probabilities (``lax.top_k``'s order; ``torch.topk`` leaves ties in an
unspecified order, so the port takes a stable descending sort), and the
capacity slots token-major, so earlier positions win them.

Under a mesh (:class:`~tony_tpu_torch.parallel.spmd.Layout` ``lay``) the
activations are replicated over the expert axis (``ep``) and each rank
holds ``E/ep`` experts, the function the JAX package's ``moe_ffn``
computes under GSPMD: every rank routes the same tokens the same way,
keeps its experts' columns of dispatch and combine, runs them, and the
partial outputs are summed over ep (and over tp, whose ranks each hold a
slice of the experts' hidden). Gradients: the input of the expert
products and the combine weights are read by each rank in part, so
their cotangents are summed over ep and tp
(:func:`~tony_tpu_torch.parallel.spmd.copy_to_experts`); the router
reads its input whole. The load-balance loss and the dropped fraction are
of the global batch: the per-expert counts and probability sums are
summed over the data axes before they are combined.

Under context parallelism (``cp``) a rank holds a chunk of every
sequence, and routing stays the reference's over the whole sequence:
capacity follows the global length, and a rank's tokens take their
expert slots after every lower rank's (slots are token-major), so each
row's slot numbers start at the assignments the lower ranks made to
each expert (``lower`` of :func:`router_dispatch`, an exclusive scan
over cp of the per-row, per-expert counts). The slots of the ranks are
disjoint, so a rank runs its experts on its own slots (the others'
are zero rows whose outputs no token of its chunk combines) and no
activation crosses cp; the metrics sum their counts and probability
sums over cp with the data axes. A dict mesh's emulation
(:class:`~tony_tpu_torch.parallel.spmd.EmulatedCp`) routes each chunk of
the global tensors the same way, the lower counts taken from the
chunks before it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from tony_tpu_torch.parallel import spmd


class MoEMetrics(NamedTuple):
    """Router health numbers (load-balance aux loss per Switch
    Transformer)."""
    aux_loss: torch.Tensor         # scalar: E * sum(frac_tokens * frac_probs)
    dropped_fraction: torch.Tensor


def ordered_top_k(probs: torch.Tensor,
                  k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest entries on the last axis,
    in descending order and, among equal values, lower index first — the
    order of ``lax.top_k``."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :k]
    return probs.gather(-1, idx), idx


def _sum_data(x, lay):
    return x if lay is None else lay.sum_data(x)


def _count_data(x, lay):
    return x if lay is None else lay.count_data(x)


class _Gates(NamedTuple):
    """A chunk's routing before capacity: f32 probabilities ``[B, S,
    E]``, the normalized top-k gate values ``[B, S, k]`` and their
    experts one-hot ``[B, S, k, E]``."""
    probs: torch.Tensor
    gate_vals: torch.Tensor
    onehot: torch.Tensor


def _gates(logits: torch.Tensor, top_k: int) -> _Gates:
    e = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, gate_idx = ordered_top_k(probs, top_k)            # [B,S,k]
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)
    return _Gates(probs, gate_vals, F.one_hot(gate_idx, e).float())


def assignments(g: _Gates) -> torch.Tensor:
    """``[B, E]``: the top-k assignments each row of the chunk makes to
    each expert (what a higher cp rank's slots start after)."""
    return g.onehot.sum(dim=(1, 2))


def _slots(g: _Gates, capacity: int, lower=None) -> tuple:
    """(dispatch, combine ``[B, S, E, C]``, kept assignments ``[B, S·k,
    E]``, all assignments ``[B, S·k, E]``) of a chunk whose rows have
    ``lower`` ``[B, E]`` assignments ahead of it (None: none)."""
    b, s, top_k, e = g.onehot.shape
    # token-major priority: earlier sequence positions win capacity slots
    oh = g.onehot.reshape(b, s * top_k, e)
    pos = torch.cumsum(oh, dim=1) - oh                   # slot within expert
    if lower is not None:
        pos = pos + lower[:, None, :]
    keep = (pos < capacity).float() * oh                         # [B,S*k,E]
    slots = torch.arange(capacity, device=oh.device, dtype=pos.dtype)
    pos_oh = (pos[..., None] == slots).float() * keep[..., None]
    combine = pos_oh * g.gate_vals.reshape(b, s * top_k, 1, 1)
    dispatch = pos_oh.reshape(b, s, top_k, e, capacity).sum(2)
    combine = combine.reshape(b, s, top_k, e, capacity).sum(2)
    return dispatch, combine, keep, oh


def _total(parts: list, lay, differentiable: bool = False):
    """The chunks' parts summed in chunk order, then over the layout's
    data and cp ranks (with an identity backward where
    ``differentiable``, outside autograd otherwise)."""
    t = parts[0]
    for p in parts[1:]:
        t = t + p
    return (_sum_data if differentiable else _count_data)(t, lay)


def _metrics(e: int, gates: list, slots: list, lay) -> MoEMetrics:
    """Switch-Transformer load-balance loss ``E * sum_e f_e * p_e`` and
    the dropped fraction, over the global batch: the chunks' counts and
    probability sums summed, then over the ranks of ``lay``."""
    b = gates[0].probs.shape[0]
    dev = gates[0].probs.device
    # a fill, not a host-to-device copy: a pageable copy would wait for
    # every kernel queued ahead of it
    tokens = _total([torch.full((), float(b * g.probs.shape[1]), device=dev)
                     for g in gates], lay)
    frac_tokens = _total([g.onehot[:, :, 0, :].sum(dim=(0, 1))
                          for g in gates], lay) / tokens     # top-1 share
    frac_probs = _total([g.probs.sum(dim=(0, 1)) for g in gates], lay,
                        differentiable=True) / tokens
    aux = e * torch.sum(frac_tokens * frac_probs)
    routed = _total([k.sum() for _, _, k, _ in slots], lay) / torch.clamp(
        _total([oh.sum() for _, _, _, oh in slots], lay), min=1.0)
    return MoEMetrics(aux, 1.0 - routed)


def router_dispatch(logits: torch.Tensor, num_experts: int, *,
                    top_k: int = 2, capacity: int, lay=None, lower=None):
    """Top-k routing with capacity. logits: ``[B, S, E]``.

    Returns (dispatch ``[B, S, E, C]`` one-hot, combine ``[B, S, E, C]``
    weights, both f32, and :class:`MoEMetrics`). With a layout ``lay``
    the metrics are those of the global batch (the data and cp ranks'
    counts and probability sums summed first). ``lower`` ``[B, E]``
    (the cp arm: ``logits`` are one chunk of sequences split over cp,
    ``capacity`` the whole sequences') holds each row's assignments to
    each expert on the lower cp ranks, after which this chunk's slots
    start."""
    g = _gates(logits, top_k)
    sl = _slots(g, capacity, lower)
    return sl[0], sl[1], _metrics(num_experts, [g], [sl], lay)


def default_capacity(tokens_per_group: int, num_experts: int, top_k: int,
                     capacity_factor: float = 1.25) -> int:
    c = int(math.ceil(top_k * tokens_per_group / num_experts
                      * capacity_factor))
    return max(c, 1)


def lower_counts(counts: torch.Tensor, lay) -> torch.Tensor | None:
    """``[B, E]``: each row's assignments on the cp ranks below this one
    (an exclusive scan over cp of every rank's ``counts``, gathered in
    the cp group), or None without a live cp group."""
    if lay is None or lay.cp_size == 1 or lay.cp_group is None:
        return None
    import torch.distributed as dist
    parts = [torch.empty_like(counts) for _ in range(lay.cp_size)]
    dist.all_gather(parts, counts.contiguous(), group=lay.cp_group)
    return _exclusive_scan(parts)[lay.cp_rank]


def _exclusive_scan(parts: list) -> list:
    """The running sums of ``parts`` before each one (zeros first)."""
    out, acc = [], torch.zeros_like(parts[0])
    for p in parts:
        out.append(acc)
        acc = acc + p
    return out


def _experts(x, dispatch, combine, w_in, w_out, activation, lay,
             expert_rank: int = 0):
    """This rank's experts on the slots ``dispatch`` fills from ``x``,
    combined back onto ``x``'s positions (its partial output over ep and
    tp). The rank on the expert axis is ``lay``'s, else
    ``expert_rank``."""
    e = dispatch.shape[2]
    # each rank reads its experts' combine columns and its part of the
    # expert products: their cotangents sum over ep and tp
    combine = spmd.copy_to_experts(combine, lay)
    x_e = spmd.copy_to_experts(x, lay)
    e_loc = w_in.shape[0]
    if e_loc != e:
        lo = (lay.expert_rank if lay is not None else expert_rank) * e_loc
        dispatch = dispatch[:, :, lo:lo + e_loc]
        combine = combine[:, :, lo:lo + e_loc]
    dispatch = dispatch.to(x.dtype)
    combine = combine.to(x.dtype)
    # [B,S,E,C] x [B,S,D] -> [E,B,C,D]
    expert_in = torch.einsum("bsec,bsd->ebcd", dispatch, x_e)
    h = activation(torch.einsum("ebcd,edh->ebch", expert_in, w_in))
    expert_out = torch.einsum("ebch,ehd->ebcd", h, w_out)
    # [B,S,E,C] x [E,B,C,D] -> [B,S,D]
    return torch.einsum("bsec,ebcd->bsd", combine, expert_out)


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w_in: torch.Tensor,
            w_out: torch.Tensor, *, top_k: int = 2,
            capacity_factor: float = 1.25, activation=F.gelu,
            lay=None, expert_rank: int = 0
            ) -> tuple[torch.Tensor, MoEMetrics]:
    """Mixture-of-experts feed-forward block.

    x: ``[B, S, D]``; router_w: ``[D, E]`` (f32 in a bf16 model: the
    logits are ``x`` in f32 against it, as the JAX package's einsum
    promotes them); w_in: ``[E_local, D, H]``; w_out: ``[E_local, H,
    D]``, where ``E_local`` is ``E`` without a layout and ``E/ep`` (this
    rank's experts, in order) with one; without a layout, ``E_local <
    E`` runs the experts of rank ``expert_rank`` of ``E/E_local`` (an
    inference rank body, its output this rank's part of the sum over
    ep). Capacity follows the sequence
    length per batch row: this call's ``S``, or with a live cp axis the
    whole sequence's (``S`` times cp, each rank's slots after the lower
    ranks', :func:`lower_counts`); an :class:`~tony_tpu_torch.parallel
    .spmd.EmulatedCp` layout routes the cp chunks of the global ``x`` in
    turn. Dispatch and combine are cast to x's dtype before the expert
    einsums."""
    b, s, d = x.shape
    e = router_w.shape[1]
    cp = 1 if lay is None else lay.cp_size
    emulated = cp > 1 and lay.cp_group is None
    chunks = list(x.chunk(cp, dim=1)) if emulated else [x]
    capacity = default_capacity(s if emulated else s * cp, e, top_k,
                                capacity_factor)

    gates = [_gates(torch.einsum("bsd,de->bse", c.float(),
                                 router_w.float()), top_k) for c in chunks]
    if emulated:
        lowers = _exclusive_scan([assignments(g) for g in gates])
    else:
        lowers = [lower_counts(assignments(gates[0]), lay)]
    slots = [_slots(g, capacity, lo) for g, lo in zip(gates, lowers)]
    metrics = _metrics(e, gates, slots, lay)
    outs = [_experts(c, sl[0], sl[1], w_in, w_out, activation, lay,
                     expert_rank) for c, sl in zip(chunks, slots)]
    out = torch.cat(outs, dim=1) if emulated else outs[0]
    return spmd.reduce_from_experts(out, lay), metrics
