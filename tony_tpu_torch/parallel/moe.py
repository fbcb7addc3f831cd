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


def router_dispatch(logits: torch.Tensor, num_experts: int, *,
                    top_k: int = 2, capacity: int, lay=None):
    """Top-k routing with capacity. logits: ``[B, S, E]``.

    Returns (dispatch ``[B, S, E, C]`` one-hot, combine ``[B, S, E, C]``
    weights, both f32, and :class:`MoEMetrics`). With a layout ``lay``
    the metrics are those of the global batch (the data ranks' counts
    and probability sums summed first)."""
    b, s, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, gate_idx = ordered_top_k(probs, top_k)            # [B,S,k]
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)

    onehot = F.one_hot(gate_idx, e).float()                      # [B,S,k,E]
    # token-major priority: earlier sequence positions win capacity slots
    oh = onehot.reshape(b, s * top_k, e)
    pos = torch.cumsum(oh, dim=1) - oh                   # slot within expert
    keep = (pos < capacity).float() * oh                         # [B,S*k,E]
    slots = torch.arange(capacity, device=logits.device, dtype=pos.dtype)
    pos_oh = (pos[..., None] == slots).float() * keep[..., None]
    combine = pos_oh * gate_vals.reshape(b, s * top_k, 1, 1)
    dispatch = pos_oh.reshape(b, s, top_k, e, capacity).sum(2)
    combine = combine.reshape(b, s, top_k, e, capacity).sum(2)

    # Switch-Transformer load-balance loss: E * sum_e f_e * p_e, over the
    # global batch
    # a fill, not a host-to-device copy: a pageable copy would wait for
    # every kernel queued ahead of it
    tokens = _count_data(torch.full((), float(b * s), device=logits.device),
                         lay)
    frac_tokens = _count_data(onehot[:, :, 0, :].sum(dim=(0, 1)),
                              lay) / tokens                  # top-1 share
    frac_probs = _sum_data(probs.sum(dim=(0, 1)), lay) / tokens
    aux = e * torch.sum(frac_tokens * frac_probs)
    routed = _count_data(keep.sum(), lay) / torch.clamp(
        _count_data(oh.sum(), lay), min=1.0)
    return dispatch, combine, MoEMetrics(aux, 1.0 - routed)


def default_capacity(tokens_per_group: int, num_experts: int, top_k: int,
                     capacity_factor: float = 1.25) -> int:
    c = int(math.ceil(top_k * tokens_per_group / num_experts
                      * capacity_factor))
    return max(c, 1)


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w_in: torch.Tensor,
            w_out: torch.Tensor, *, top_k: int = 2,
            capacity_factor: float = 1.25, activation=F.gelu,
            lay=None) -> tuple[torch.Tensor, MoEMetrics]:
    """Mixture-of-experts feed-forward block.

    x: ``[B, S, D]``; router_w: ``[D, E]`` (f32 in a bf16 model: the
    logits are ``x`` in f32 against it, as the JAX package's einsum
    promotes them); w_in: ``[E_local, D, H]``; w_out: ``[E_local, H,
    D]``, where ``E_local`` is ``E`` without a layout and ``E/ep`` (this
    rank's experts, in order) with one. Capacity follows this call's own
    ``S`` (per batch row). Dispatch and combine are cast to x's dtype
    before the expert einsums."""
    b, s, d = x.shape
    e = router_w.shape[1]
    capacity = default_capacity(s, e, top_k, capacity_factor)

    logits = torch.einsum("bsd,de->bse", x.float(), router_w.float())
    dispatch, combine, metrics = router_dispatch(
        logits, e, top_k=top_k, capacity=capacity, lay=lay)

    # each rank reads its experts' combine columns and its part of the
    # expert products: their cotangents sum over ep and tp
    combine = spmd.copy_to_experts(combine, lay)
    x_e = spmd.copy_to_experts(x, lay)
    e_loc = w_in.shape[0]
    if e_loc != e:
        lo = lay.expert_rank * e_loc
        dispatch = dispatch[:, :, lo:lo + e_loc]
        combine = combine[:, :, lo:lo + e_loc]
    dispatch = dispatch.to(x.dtype)
    combine = combine.to(x.dtype)
    # [B,S,E,C] x [B,S,D] -> [E,B,C,D]
    expert_in = torch.einsum("bsec,bsd->ebcd", dispatch, x_e)
    h = activation(torch.einsum("ebcd,edh->ebch", expert_in, w_in))
    expert_out = torch.einsum("ebch,ehd->ebcd", h, w_out)
    # [B,S,E,C] x [E,B,C,D] -> [B,S,D]
    out = torch.einsum("bsec,ebcd->bsd", combine, expert_out)
    return spmd.reduce_from_experts(out, lay), metrics
