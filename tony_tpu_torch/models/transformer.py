"""Flagship decoder-only transformer LM in PyTorch: forward and loss.

Port of ``tony_tpu/models/transformer.py``: the same config, presets and
parameter tree — plain dicts with the same keys, the same stacked
``[L, ...]`` shapes and the same einsum layouts as the JAX
``init_params`` — so weights move between the packages by
:mod:`tony_tpu_torch.models.weights` and keep their digest.

Attention runs the CUDA flash kernels on the card (K1 forward; K2, or
K3a + K3b, backward) and their plain versions on the CPU, through the
differentiable :func:`~tony_tpu_torch.ops.attention.flash_attention`.
With ``cfg.remat`` each block runs under ``torch.utils.checkpoint`` by
``cfg.remat_policy``, the JAX package's three: ``"full"`` keeps only the
block's input, and the backward recomputes the block (K1 included)
before differentiating it; ``"dots"`` also keeps the outputs of the
products with no batch dimension (the projections and the MLP's; a
selective checkpoint policy) and recomputes the elementwise work and
attention; ``"attn"`` keeps only K1's o and lse of each attention call
(:class:`~tony_tpu_torch.ops.attention.ForwardStash`), so the
recompute re-runs the projections and RoPE but not K1. RMSNorm
runs the CUDA kernel K5 on the card and its plain version on the CPU
(:func:`~tony_tpu_torch.ops.norms.rms_norm`, f32 math). RoPE and the
SwiGLU MLP are plain torch with the JAX package's f32 points: RoPE in
f32 math, the lm_head accumulated in f32 and stored in
``cfg.logits_storage_dtype``.

With a ``mesh`` (dp, fsdp, tp, ep; :func:`logical_axes` and the rule table
lay the params out as DTensors), :func:`forward` and :func:`lm_loss` run
each rank's local shard (:mod:`tony_tpu_torch.parallel.spmd`): the batch
split over the data axes, heads, the MLP hidden and the vocab split over
tp with Megatron-style collectives, the kernels launched on local
tensors. Under GQA with tp the K/V projections are replicated, as in the
JAX package; each rank cuts K and V to the kv heads its query heads read
(:func:`~tony_tpu_torch.ops.attention.tp_kv_heads`).

With a live ``cp`` axis (``"seq"`` → cp) each rank holds its chunk of
the sequence: RoPE takes the chunk's global positions, attention is the
ring (:func:`~tony_tpu_torch.parallel.ring_attention.ring_attention_local`)
or Ulysses (:func:`~tony_tpu_torch.parallel.ulysses.ulysses_attention_local`)
by ``cfg.cp_strategy``, and the loss sums over data and cp ranks. As in
the JAX package, a sliding window (``attn_window``) and cp raise
``NotImplementedError``; so do MoE and cp here (the reference routes over
the global sequence, and capacity follows its length).

With ``cfg.num_experts`` the MLP is a mixture of experts
(:func:`~tony_tpu_torch.parallel.moe.moe_ffn`, silu experts with no
``w_up``, an f32 router): each block returns its load-balance loss, the
forward returns their sum over layers and :func:`lm_loss` adds it with
``cfg.moe_aux_weight``. Under a mesh the experts split over ``ep`` (the
``"expert"`` rule), the activations replicated over it.

With a live ``pp`` axis the blocks run as pipeline stages
(:mod:`~tony_tpu_torch.parallel.pipeline`): the stacked ``[L, ...]``
blocks split into ``pp`` contiguous layer groups (the ``"stage"`` rule),
embed, final norm and lm_head replicated over pp. :func:`forward` and
:func:`lm_loss` run GPipe (:func:`_forward_pp`), differentiable;
:func:`lm_value_and_grad` runs 1F1B and returns the loss and the
gradients itself (``make_train_step(..., value_and_grad_fn=)``), its
loss head vocab-sharded over tp when tp is live. Both take the
microbatch count of :func:`_pp_layout`. A ``mesh`` given as a dict of
axis sizes (``{"pp": 2}``) emulates every rank of it in this process,
the form one card runs; a ``DeviceMesh`` runs this rank's stage in its
pp group. pp with cp raises ``NotImplementedError``; so does 1F1B with
a live ep axis, as in the reference.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from tony_tpu_torch import resolve_device
from tony_tpu_torch.models.train import masked_cross_entropy
from tony_tpu_torch.ops.attention import (ForwardStash, _check_kv_heads,
                                          flash_attention, tp_kv_heads)
from tony_tpu_torch.ops.norms import rms_norm
from tony_tpu_torch import tree_leaves, tree_map
from tony_tpu_torch.parallel import spmd
from tony_tpu_torch.parallel.mesh import mesh_shape
from tony_tpu_torch.parallel.moe import moe_ffn
from tony_tpu_torch.parallel.pipeline import (pipeline_apply,
                                              pipeline_apply_local,
                                              pipeline_value_and_grad,
                                              pipeline_value_and_grad_local)
from tony_tpu_torch.parallel.ring_attention import (expand_kv_unless,
                                                    ring_attention_local)
from tony_tpu_torch.parallel.sharding import DEFAULT_RULES
from tony_tpu_torch.parallel.ulysses import ulysses_attention_local


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Same fields, defaults and validation as the JAX config; ``dtype``
    and ``logits_dtype`` are torch dtypes. Fields that only training or
    parallelism read (remat, scan_unroll, cp/pp/MoE knobs) are kept so a
    config converts field for field."""
    vocab_size: int = 32_000
    d_model: int = 512
    n_layers: int = 8
    n_heads: int = 8
    n_kv_heads: int | None = None
    d_ff: int = 2048
    max_seq: int = 2048
    dtype: Any = torch.bfloat16
    logits_dtype: Any = None
    remat: bool = True
    remat_policy: str = "full"
    scan_unroll: int = 1
    cp_strategy: str = "ring"
    attn_window: int = 0
    kv_cache_capacity: int = 0
    pp_microbatches: int = 0
    pp_schedule: str = "gpipe"
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    kv_cache_dtype: str = "model"

    def __post_init__(self):
        kv = self.n_kv_heads if self.n_kv_heads is not None else self.n_heads
        if kv <= 0 or self.n_heads % kv:
            raise ValueError(f"n_kv_heads={kv} must be a positive divisor "
                             f"of n_heads={self.n_heads}")
        if self.remat_policy not in ("full", "dots", "attn"):
            raise ValueError(f"unknown remat_policy "
                             f"{self.remat_policy!r}; expected 'full', "
                             f"'dots', or 'attn'")
        if self.pp_schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"unknown pp_schedule {self.pp_schedule!r}; "
                             f"expected 'gpipe' or '1f1b'")
        if self.kv_cache_dtype not in ("model", "int8"):
            raise ValueError(f"unknown kv_cache_dtype "
                             f"{self.kv_cache_dtype!r}; expected 'model' "
                             f"or 'int8'")
        if self.attn_window < 0:
            raise ValueError(f"attn_window must be >= 0 (0 = full causal "
                             f"attention), got {self.attn_window}")
        if self.kv_cache_capacity:
            if not self.attn_window:
                raise ValueError(
                    "kv_cache_capacity (rolling KV cache) requires "
                    "attn_window > 0: a full-causal query attends the "
                    "whole history, which a ring buffer has overwritten")
            if self.kv_cache_capacity < self.attn_window:
                raise ValueError(
                    f"kv_cache_capacity ({self.kv_cache_capacity}) must "
                    f"be >= attn_window ({self.attn_window}): a decode "
                    f"step reads its window's rows from the ring")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return (self.n_kv_heads if self.n_kv_heads is not None
                else self.n_heads)

    @property
    def kv_quant(self) -> bool:
        return self.kv_cache_dtype == "int8"

    @property
    def logits_storage_dtype(self):
        if self.logits_dtype is not None:
            return self.logits_dtype
        return torch.bfloat16 if self.dtype == torch.bfloat16 \
            else torch.float32

    def scaled(self, **overrides) -> "TransformerConfig":
        return dataclasses.replace(self, **overrides)


PRESETS = {
    "tiny": TransformerConfig(d_model=128, n_layers=2, n_heads=4, d_ff=512,
                              vocab_size=1024, max_seq=256),
    "small": TransformerConfig(d_model=512, n_layers=8, n_heads=8, d_ff=2048),
    "base": TransformerConfig(d_model=768, n_layers=12, n_heads=12,
                              d_ff=3072),
    "large": TransformerConfig(d_model=1536, n_layers=24, n_heads=16,
                               d_ff=6144),
}


def init_params(gen: torch.Generator, cfg: TransformerConfig,
                device=None) -> dict:
    """Initialize the parameter tree (layer params stacked ``[L, ...]``)
    from ``gen``, a CPU ``torch.Generator``, on ``device`` (the card
    unless the caller passes ``"cpu"``). Same tree and scaling as the JAX
    ``init_params``; the draws differ (another generator), so a parity
    test converts one package's weights into the other. An MoE config
    (``num_experts``) gets ``router`` ``[L, d, E]`` (f32, rounded through
    ``cfg.dtype`` first, as the JAX package draws it), ``w_gate`` ``[L,
    E, d, f]`` and ``w_down`` ``[L, E, f, d]``, and no ``w_up``."""
    dev = resolve_device(device)
    d, h, hd, f, L = (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
                      cfg.n_layers)
    kv = cfg.kv_heads

    def normal(shape, fan_in):
        x = torch.randn(shape, generator=gen, dtype=torch.float32)
        return (x * fan_in ** -0.5).to(device=dev, dtype=cfg.dtype)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    embed = normal((cfg.vocab_size, d), d)
    blocks = {
        "attn_norm": ones((L, d)),
        "wq": normal((L, d, h, hd), d),
        "wk": normal((L, d, kv, hd), d),
        "wv": normal((L, d, kv, hd), d),
        "wo": normal((L, h, hd, d), d),
        "mlp_norm": ones((L, d)),
    }
    if cfg.num_experts:
        e = cfg.num_experts
        # experts are 2-matrix MLPs (silu), as in the JAX package
        blocks.update({
            "router": normal((L, d, e), d).float(),
            "w_gate": normal((L, e, d, f), d),
            "w_down": normal((L, e, f, d), f),
        })
    else:
        blocks.update({
            "w_gate": normal((L, d, f), d),
            "w_up": normal((L, d, f), d),
            "w_down": normal((L, f, d), f),
        })
    return {"embed": embed, "blocks": blocks,
            "final_norm": ones((d,)), "lm_head": normal((d, cfg.vocab_size),
                                                        d)}


def logical_axes(cfg: TransformerConfig) -> dict:
    """Logical-axis tree matching :func:`init_params` (the JAX package's:
    leading ``"stage"`` on the stacked leaves). Under GQA the K/V
    projections replicate over tp instead of claiming ``"heads"``; MoE
    experts lead with ``"expert"``, the router replicates."""
    kv_head_axis = "heads" if cfg.kv_heads == cfg.n_heads else None
    blocks = {
        "attn_norm": ("stage", "norm"),
        "wq": ("stage", "embed", "heads", "kv"),
        "wk": ("stage", "embed", kv_head_axis, "kv"),
        "wv": ("stage", "embed", kv_head_axis, "kv"),
        "wo": ("stage", "heads", "kv", "embed"),
        "mlp_norm": ("stage", "norm"),
    }
    if cfg.num_experts:
        blocks.update({
            "router": ("stage", "embed", None),
            "w_gate": ("stage", "expert", "embed", "mlp"),
            "w_down": ("stage", "expert", "mlp", "embed"),
        })
    else:
        blocks.update({
            "w_gate": ("stage", "embed", "mlp"),
            "w_up": ("stage", "embed", "mlp"),
            "w_down": ("stage", "mlp", "embed"),
        })
    return {
        "embed": ("vocab", "embed"),
        "blocks": blocks,
        "final_norm": ("norm",),
        "lm_head": ("embed", "vocab"),
    }


def layer_params(params: dict, li: int) -> dict:
    """Layer ``li``'s slice of the stacked block params (views)."""
    return {n: a[li] for n, a in params["blocks"].items()}


def rope_tables(positions: torch.Tensor, d: int):
    """(cos, sin) tables ``[B, S, 1, d/2]`` for head dim ``d`` from
    integer positions ``[B, S]``, in f32."""
    half = d // 2
    f32 = dict(dtype=torch.float32, device=positions.device)
    # the constant in f32, as the JAX package computes it
    step = torch.log(torch.tensor(10000.0, **f32)) / half
    freqs = torch.exp(-torch.arange(0, half, **f32) * step)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``[B, S, H, D]`` by precomputed tables (f32 math, x-dtype
    out; half-split rotation)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def expand_kv(q, k, v):
    """GQA → full heads: each K/V head repeated across its query group
    (blocked layout: query head h reads kv head h // (H/KV))."""
    h = q.shape[2]
    _check_kv_heads(h, k.shape[2])
    return expand_kv_unless(k, v, h, h)


def _attention(q, k, v, cp_strategy: str = "ring",
               window: int | None = None, lay=None,
               stash: ForwardStash | None = None):
    """Causal GQA attention, differentiable: the CUDA flash kernels for
    CUDA tensors, their plain versions for CPU tensors. Under a layout
    with a live cp axis, q/k/v are this rank's sequence chunk and the
    ranks attend together by ``cp_strategy``: the ring rides GQA K/V
    unexpanded (they are already this rank's kv heads), Ulysses expands
    them when they do not split over cp (the JAX package's rule applied
    to the local heads)."""
    if cp_strategy not in ("ring", "ulysses"):
        raise ValueError(f"unknown cp_strategy {cp_strategy!r}; "
                         f"expected 'ring' or 'ulysses'")
    if lay is not None and lay.cp_size > 1:
        if window is not None:
            raise NotImplementedError(_CP_WINDOW)
        if cp_strategy == "ulysses":
            k, v = expand_kv_unless(k, v, q.shape[2], lay.cp_size)
            return ulysses_attention_local(q, k, v, lay.cp_group,
                                           causal=True, stash=stash)
        return ring_attention_local(q, k, v, lay.cp_group, causal=True,
                                    stash=stash)
    return flash_attention(q, k, v, causal=True, window=window, stash=stash)


_CP_WINDOW = ("attn_window is not supported with context parallelism "
              "(cp > 1) yet; shard long sequences with cp OR bound "
              "attention with a window, not both")


def _mlp(h, p, lay=None):
    """Dense SwiGLU feed-forward on ``[B, S, D]`` (``h`` already passed
    through :func:`~tony_tpu_torch.parallel.spmd.copy_to_model`); under
    tp the hidden is this rank's slice and the output sums over the
    ranks."""
    gate = torch.einsum("bsd,df->bsf", h, p["w_gate"])
    up = torch.einsum("bsd,df->bsf", h, p["w_up"])
    out = torch.einsum("bsf,fd->bsd", F.silu(gate) * up, p["w_down"])
    return spmd.reduce_from_model(out, lay)


def _project_qkv(x, p, rope, lay=None):
    """A block's attention inputs: RMSNorm, the Q/K/V projections and
    RoPE on q and k. x: ``[B, S, D]``; returns q ``[B, S, H, hd]`` and
    k, v ``[B, S, KV, hd]`` (this rank's heads under tp)."""
    cos, sin = rope
    h = spmd.copy_to_model(rms_norm(x, p["attn_norm"]), lay)
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, p["wv"])
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _local_kv(k, v, cfg: TransformerConfig, lay):
    """Under tp with replicated (GQA) K/V: the kv heads this rank's query
    heads read."""
    if lay is None or lay.model_size == 1 or cfg.kv_heads == cfg.n_heads:
        return k, v
    lo, hi = tp_kv_heads(cfg.n_heads, cfg.kv_heads, lay.model_rank,
                         lay.model_size)
    return k[:, :, lo:hi], v[:, :, lo:hi]


def _moe(h, p, cfg: TransformerConfig, lay=None):
    """The MoE feed-forward on ``[B, S, D]`` with silu experts: (output,
    :class:`~tony_tpu_torch.parallel.moe.MoEMetrics`). Under a layout
    the experts are this rank's (its ep shard, their hidden its tp
    slice) and the output sums over ep and tp inside."""
    return moe_ffn(h, p["router"], p["w_gate"], p["w_down"],
                   top_k=cfg.moe_top_k,
                   capacity_factor=cfg.moe_capacity_factor,
                   activation=F.silu, lay=lay)


def _finish_block(x, o, p, cfg: TransformerConfig, lay=None):
    """The rest of a block after attention: the output projection and
    the residual, then RMSNorm, the MLP (dense or MoE) and its residual.
    Returns (x, the block's aux loss, or None for a dense MLP)."""
    x = x + spmd.reduce_from_model(
        torch.einsum("bshk,hkd->bsd", o, p["wo"]), lay)
    h = rms_norm(x, p["mlp_norm"])
    if "router" in p:
        out, metrics = _moe(h, p, cfg, lay)
        return x + out, metrics.aux_loss
    return x + _mlp(spmd.copy_to_model(h, lay), p, lay), None


def _positions(b: int, s: int, device, lay=None) -> torch.Tensor:
    """The global positions ``[B, S]`` of a local sequence of ``s``:
    under cp, this rank's chunk of the whole."""
    off = lay.cp_rank * s if lay is not None else 0
    return torch.arange(off, off + s, device=device).expand(b, s)


def _block(x, p, cfg: TransformerConfig, rope=None, lay=None,
           stash: ForwardStash | None = None):
    """One decoder block. x: ``[B, S, D]``; p: this layer's params
    (unstacked; this rank's shards); ``rope``: precomputed (cos, sin)
    tables; ``lay``: the :class:`~tony_tpu_torch.parallel.spmd.Layout`
    of a sharded step, or None; ``stash``: the ``"attn"`` policy's
    record of the attention forward. Returns (x, the block's aux loss
    or None)."""
    b, s, _ = x.shape
    if rope is None:
        rope = rope_tables(_positions(b, s, x.device, lay), cfg.head_dim)
    q, k, v = _project_qkv(x, p, rope, lay)
    k, v = _local_kv(k, v, cfg, lay)
    o = _attention(q, k, v, cfg.cp_strategy, cfg.attn_window or None, lay,
                   stash)
    return _finish_block(x, o, p, cfg, lay)


def _save_dots(ctx, func, *args, **kwargs):
    """The ``"dots"`` policy (``dots_with_no_batch_dims_saveable``): keep
    the outputs of matrix products with no batch dimension, recompute
    the rest. ``torch.einsum`` lowers such a product (``bsd,df->bsf``,
    ``bsd,dhk->bshk``, ``bshk,hkd->bsd``) to ``bmm`` over a batch of one,
    and a product with batch dimensions (attention's) to a larger
    batch."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    if func is aten.mm.default or (func is aten.bmm.default
                                   and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(_save_dots)


def _remat_block(x, p, cfg: TransformerConfig, rope, lay=None):
    """:func:`_block` under ``torch.utils.checkpoint`` by
    ``cfg.remat_policy`` (the JAX package's ``_remat_policy``): ``"full"``
    saves nothing inside the block, ``"dots"`` the products with no batch
    dimension (:func:`_save_dots`), ``"attn"`` only each attention call's
    o and lse (a :class:`~tony_tpu_torch.ops.attention.ForwardStash`,
    replayed by the recompute)."""
    if cfg.remat_policy == "attn":
        stash = ForwardStash()

        def run(x, p):
            stash.begin()
            return _block(x, p, cfg, rope, lay, stash)

        return torch.utils.checkpoint.checkpoint(run, x, p,
                                                 use_reentrant=False)
    kw = {"context_fn": _dots_contexts} if cfg.remat_policy == "dots" \
        else {}
    return torch.utils.checkpoint.checkpoint(_block, x, p, cfg, rope, lay,
                                             use_reentrant=False, **kw)


def lm_head_logits(x, w, cfg: TransformerConfig):
    """``x @ lm_head`` accumulated in f32, stored in
    ``cfg.logits_storage_dtype`` (one rounding, as in the JAX package)."""
    return (x.float() @ w.float()).to(cfg.logits_storage_dtype)


def _lm_head(params: dict, x, cfg: TransformerConfig, lay=None):
    """final_norm + lm_head on block output ``[B, S, D]`` → logits (this
    rank's vocab slice under tp)."""
    x = spmd.copy_to_model(rms_norm(x, params["final_norm"]), lay)
    return lm_head_logits(x, params["lm_head"], cfg)


def _forward_local(params: dict, tokens: torch.Tensor,
                   cfg: TransformerConfig, lay=None) -> tuple:
    """The forward on local tensors: ``params`` and ``tokens`` are this
    rank's (the whole tree and batch without a mesh); returns this
    rank's logits and the aux loss (the blocks' summed over layers)."""
    x = spmd.embed_lookup(params["embed"], tokens, lay,
                          cfg.vocab_size).to(cfg.dtype)
    b, s = tokens.shape
    # hoisted out of the loop
    rope = rope_tables(_positions(b, s, tokens.device, lay), cfg.head_dim)
    x, aux = _run_blocks(params["blocks"], x, cfg, rope, lay)
    return _lm_head(params, x, cfg, lay), aux


def _run_blocks(blocks: dict, x, cfg: TransformerConfig, rope, lay=None):
    """The stacked ``blocks`` (``[n, ...]`` leaves) in turn on ``x``,
    each under remat by ``cfg`` when a gradient of them is recorded:
    (x, the aux loss summed over the layers, f32)."""
    names = list(blocks)
    # one unbind per stacked leaf: its backward stacks the layers' grads
    # once, where indexing each layer would scatter into a zeroed [L, ...]
    layers = zip(*(blocks[n].unbind(0) for n in names))
    remat = cfg.remat and torch.is_grad_enabled() and any(
        a.requires_grad for a in blocks.values())
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for vals in layers:
        p = dict(zip(names, vals))
        if remat:
            x, layer_aux = _remat_block(x, p, cfg, rope, lay)
        else:
            x, layer_aux = _block(x, p, cfg, rope=rope, lay=lay)
        if layer_aux is not None:
            aux = aux + layer_aux
    return x, aux


def _stage_fn(cfg: TransformerConfig, lay=None, with_aux: bool = True):
    """A pipeline stage of the LM: ``stage_fn(blocks, h) -> (h, aux)``
    (``h`` alone without ``with_aux``) over the stage's ``[L/pp, ...]``
    blocks, RoPE at the stage input's positions, the blocks under
    ``cfg``'s remat policy, ``lay`` the stage's layout
    (:meth:`~tony_tpu_torch.parallel.spmd.Layout.stage_layout`)."""
    def stage_fn(blocks, h):
        b, s = h.shape[0], h.shape[1]
        rope = rope_tables(_positions(b, s, h.device), cfg.head_dim)
        h, aux = _run_blocks(blocks, h, cfg, rope, lay)
        return (h, aux) if with_aux else h
    return stage_fn


def _pp_layout(cfg: TransformerConfig, mesh, batch: int) -> tuple:
    """(pp, microbatches) of a pipelined step on ``mesh`` (a
    ``DeviceMesh`` or its sizes) of global ``batch`` rows: one
    definition of the stage-divisibility check and the auto-microbatch
    rule for both schedules. ``cfg.pp_microbatches``, or the largest
    divisor of the rows per data rank no larger than 2·pp (bubble
    (pp-1)/(3·pp-1)), the JAX package's rule."""
    shape = mesh_shape(mesh) if mesh is not None else {}
    pp = shape.get("pp", 1)
    if cfg.n_layers % max(pp, 1):
        raise ValueError(f"n_layers={cfg.n_layers} not divisible into "
                         f"{pp} pipeline stages")
    m = cfg.pp_microbatches
    if not m:
        dp_total = 1
        for a in ("dp", "fsdp"):
            dp_total *= shape.get(a, 1)
        per = max(batch // max(dp_total, 1), 1)
        m = next(k for k in range(min(2 * pp, per), 0, -1) if per % k == 0)
    return pp, m


def _pipelined(mesh) -> bool:
    return mesh is not None and mesh_shape(mesh).get("pp", 1) > 1


def _check_pp(cfg: TransformerConfig, shape: dict) -> None:
    if shape.get("cp", 1) > 1:
        raise NotImplementedError(
            "pipeline parallelism with context parallelism (pp > 1 and "
            "cp > 1) is not ported")
    ep = shape.get("ep", 1)
    if cfg.num_experts and cfg.num_experts % ep:
        raise ValueError(f"num_experts={cfg.num_experts} not divisible "
                         f"over ep={ep}")


def _stacked_stages(blocks: dict, pp: int) -> dict:
    """``[L, ...]`` blocks as ``[pp, L/pp, ...]``: contiguous layer
    groups, stage s the s-th."""
    return {k: a.reshape((pp, a.shape[0] // pp) + a.shape[1:])
            for k, a in blocks.items()}


def _microbatches(x, m: int):
    if x.shape[0] % m:
        raise ValueError(f"{x.shape[0]} rows a data rank do not split into "
                         f"{m} microbatches")
    return x.reshape((m, x.shape[0] // m) + x.shape[1:])


def _forward_pp(params: dict, tokens, cfg: TransformerConfig, mesh,
                rules=DEFAULT_RULES) -> tuple:
    """The GPipe forward: (logits, aux, layout). On a dict mesh every
    rank is emulated on the global params and batch (global logits, no
    layout); on a ``DeviceMesh`` this rank embeds its rows, runs its
    stage of the pipeline over its pp group (:func:`~tony_tpu_torch
    .parallel.pipeline.pipeline_apply_local`), and every stage runs the
    head on the last stage's output: its local logits (vocab-sharded
    under tp) and its layout."""
    shape = mesh_shape(mesh)
    _check_pp(cfg, shape)
    pp, m = _pp_layout(cfg, shape, tokens.shape[0])
    if isinstance(mesh, dict):
        x = params["embed"][tokens.long()].to(cfg.dtype)
        x, aux = pipeline_apply(_stage_fn(cfg),
                                _stacked_stages(params["blocks"], pp), x,
                                shape, num_microbatches=m, with_aux=True)
        return _lm_head(params, x, cfg), aux, None
    p, tok, lay = _local_step_inputs(params, tokens, cfg, mesh, rules)
    x = spmd.embed_lookup(p["embed"], tok, lay, cfg.vocab_size).to(cfg.dtype)
    out, aux = pipeline_apply_local(
        _stage_fn(cfg, lay.stage_layout()), p["blocks"],
        _microbatches(x, m), pp_group=lay.pp_group,
        data_groups=lay._data_groups, with_aux=True)
    return _lm_head(p, out.reshape(x.shape), cfg, lay), aux, lay


def _local_step_inputs(params: dict, tokens, cfg: TransformerConfig,
                       mesh, rules) -> tuple:
    """(local params, local tokens, layout) of a sharded step: the
    params gathered over the data axes (GQA's replicated K/V projections
    marked partial over tp), the batch cut to this rank (its rows, and
    its chunk of the sequence under cp). An MoE config whose experts do
    not split evenly over ep raises ``ValueError``; a window or MoE with
    a live cp axis ``NotImplementedError``."""
    ep = mesh_shape(mesh).get("ep", 1)
    if cfg.num_experts and cfg.num_experts % ep:
        raise ValueError(f"num_experts={cfg.num_experts} not divisible "
                         f"over ep={ep}")
    if spmd.seq_parallel_size(mesh, rules) > 1:
        if cfg.attn_window:
            raise NotImplementedError(_CP_WINDOW)
        if cfg.num_experts:
            raise NotImplementedError(
                "mixture of experts with context parallelism (cp > 1) is "
                "not ported: the reference routes over the global "
                "sequence, and capacity follows its length")
    if _pipelined(mesh):
        _check_pp(cfg, mesh_shape(mesh))
    lay = spmd.Layout(mesh, rules)
    partial = (frozenset({("blocks", "wk"), ("blocks", "wv")})
               if cfg.kv_heads != cfg.n_heads else frozenset())
    return lay.local_params(params, partial), lay.local(tokens), lay


def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
            mesh=None, rules=DEFAULT_RULES) -> tuple:
    """tokens ``[B, S]`` int → (logits ``[B, S, V]`` in
    ``cfg.logits_storage_dtype``, aux_loss scalar — 0 for dense
    models). Differentiable in the params; callers that only infer wrap it
    in ``torch.no_grad()``. With ``cfg.remat``, when a gradient of the
    block params is recorded, each block is checkpointed (recomputed in
    the backward). With a ``mesh`` the params are DTensors laid out by
    :func:`logical_axes`, ``tokens`` is the global batch (a DTensor, or
    a tensor every rank passes whole) and the logits come back as a
    DTensor split by ``("batch", "seq", "vocab")``. A live pp axis runs
    the blocks as GPipe stages (:func:`_forward_pp`); a dict mesh with
    one emulates its ranks and returns plain global logits."""
    if mesh is None:
        return _forward_local(params, tokens, cfg)
    if _pipelined(mesh):
        logits, aux, lay = _forward_pp(params, tokens, cfg, mesh, rules)
        if lay is None:
            return logits, aux
        return lay.wrap(logits, ("batch", "seq", "vocab")), aux
    params, tokens, lay = _local_step_inputs(params, tokens, cfg, mesh,
                                             rules)
    logits, aux = _forward_local(params, tokens, cfg, lay)
    return lay.wrap(logits, ("batch", "seq", "vocab")), aux


def train_flops_per_token(cfg: TransformerConfig, seq: int) -> float:
    """Model FLOPs per trained token: forward matmul FLOPs × 3 (backward
    ≈ 2× forward). Remat recompute is excluded, so this yields MFU (not
    HFU). Attention counts the causal half of the S² products; windowed
    configs count the mean attended length. The JAX package's formula
    (``tony_tpu/models/transformer.py:566-592``), copied."""
    d, f, L, v = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size
    kv_width = cfg.kv_heads * cfg.head_dim     # == d for MHA
    proj = 4 * d * d + 4 * d * kv_width   # wq + wo, + wk + wv (GQA-aware)
    if cfg.attn_window and cfg.attn_window < seq:
        w = cfg.attn_window
        # positions 0..w-1 attend position+1 keys; the rest attend w
        mean_attended = (w * (w + 1) / 2 + (seq - w) * w) / seq
        attn = 4 * mean_attended * d      # QK^T + AV over attended keys
    else:
        attn = 2 * seq * d                # QK^T + AV, causal half of 4·S·d
    if cfg.num_experts:
        mlp = 2 * d * cfg.num_experts + cfg.moe_top_k * 4 * d * f
    else:
        mlp = 6 * d * f                   # gate + up + down
    fwd = L * (proj + attn + mlp) + 2 * d * v   # + lm_head
    return 3.0 * fwd


def lm_loss(params: dict, batch: dict, cfg: TransformerConfig,
            mesh=None, rules=DEFAULT_RULES) -> torch.Tensor:
    """Next-token cross-entropy. batch: ``{"tokens": [B, S]}`` (shifted
    inside) or ``{"inputs", "targets"}``; targets == -1 are ignored. With
    a ``mesh``, the mean over the global batch, the same plain 0-d tensor
    on every rank. Tokens are shifted on the global rows before a rank
    cuts its cp chunk, so a chunk's last position takes its target from
    the next chunk."""
    if "inputs" in batch:
        inputs, targets = batch["inputs"], batch["targets"]
    else:
        inputs, targets = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    if mesh is None:
        logits, aux = _forward_local(params, inputs, cfg)
        return masked_cross_entropy(logits, targets) \
            + cfg.moe_aux_weight * aux
    if _pipelined(mesh):
        logits, aux, lay = _forward_pp(params, inputs, cfg, mesh, rules)
        if lay is None:
            return masked_cross_entropy(logits, targets) \
                + cfg.moe_aux_weight * aux
    else:
        params, inputs, lay = _local_step_inputs(params, inputs, cfg, mesh,
                                                 rules)
        logits, aux = _forward_local(params, inputs, cfg, lay)
    return spmd.cross_entropy(logits, lay.local(targets), lay,
                              cfg.vocab_size) + cfg.moe_aux_weight * aux


def _loss_head(cfg: TransformerConfig, lay=None):
    """The 1F1B loss head: final norm, lm_head and the masked mean
    cross-entropy of one microbatch shard. With ``lay`` (a live model
    axis) the head's vocab is this rank's slice and each rank's
    gradients are partial over tp: no copy before the head, the
    logsumexp and the target logit summed over tp with identity
    backward (``spmd._SumOver``, the reference's ``psum_rep``); the
    pipeline sums the partials once."""
    if lay is None:
        def head(hp, out, tgt):
            return masked_cross_entropy(_lm_head(hp, out, cfg), tgt)
        return head
    shard = copy.copy(lay)
    shard._loss_groups = []         # one microbatch shard's own mean

    def head(hp, out, tgt):
        return spmd.cross_entropy(_lm_head(hp, out, cfg), tgt, shard,
                                  cfg.vocab_size)
    return head


_EP_1F1B = ("pp_schedule='1f1b' supports MoE with REPLICATED experts "
            "only (no ep axis), as in the reference: shard experts over "
            "ep with pp_schedule='gpipe'")


def lm_value_and_grad(params: dict, batch: dict, cfg: TransformerConfig,
                      mesh, rules=DEFAULT_RULES) -> tuple:
    """Next-token loss and parameter gradients by the 1F1B schedule
    (:func:`~tony_tpu_torch.parallel.pipeline.pipeline_value_and_grad`):
    the loss head runs inside the pipeline, so this function is the
    differentiation. Plug it into ``make_train_step(...,
    value_and_grad_fn=)``. Returns ``(loss, grads)``, the grads a tree
    like ``params`` (DTensors on their placements under a
    ``DeviceMesh``). The loss normalizes per microbatch and data shard,
    equal to :func:`lm_loss`'s when every shard has the same count of
    targets. Without a pp axis it is ``lm_loss`` and its autograd
    gradient (the reference averages per-microbatch losses there; for a
    dense model the two agree)."""
    if "inputs" in batch:
        inputs, targets = batch["inputs"], batch["targets"]
    else:
        inputs, targets = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    shape = mesh_shape(mesh) if mesh is not None else {}
    if cfg.num_experts and shape.get("ep", 1) > 1:
        raise NotImplementedError(_EP_1F1B)
    leaves = tree_leaves(params)
    fresh = [t.detach().requires_grad_(t.is_floating_point())
             for t in leaves]
    it = iter(fresh)
    P = tree_map(lambda _: next(it), params)
    if not _pipelined(mesh):
        with torch.enable_grad():
            loss = lm_loss(P, {"inputs": inputs, "targets": targets}, cfg,
                           None if isinstance(mesh, dict) else mesh, rules)
            grads = torch.autograd.grad(loss, fresh, allow_unused=True)
        return loss.detach(), _grads_like(params, fresh, grads)
    _check_pp(cfg, shape)
    pp, m = _pp_layout(cfg, shape, inputs.shape[0])
    with_aux = bool(cfg.num_experts)
    names = ("final_norm", "lm_head")
    if isinstance(mesh, dict):
        with torch.enable_grad():
            x = P["embed"][inputs.long()].to(cfg.dtype)
        loss, g_blocks, g_head, dx = pipeline_value_and_grad(
            _stage_fn(cfg, None, with_aux), _stacked_stages(
                {k: v.detach() for k, v in P["blocks"].items()}, pp),
            x.detach(), {k: P[k].detach() for k in names}, targets, shape,
            loss_head=_loss_head(cfg), num_microbatches=m,
            with_aux=with_aux, aux_weight=cfg.moe_aux_weight)
        outs = [x] + [P["blocks"][k] for k in P["blocks"]] \
            + [P[k] for k in names]
        seeds = [dx] + [g_blocks[k].reshape(P["blocks"][k].shape)
                        for k in P["blocks"]] + [g_head[k] for k in names]
    else:
        p, tok, lay = _local_step_inputs(P, inputs, cfg, mesh, rules)
        with torch.enable_grad():
            x = spmd.embed_lookup(p["embed"], tok, lay,
                                  cfg.vocab_size).to(cfg.dtype)
        head_lay = lay if lay.model_size > 1 else None
        loss, g_blocks, g_head, dxs = pipeline_value_and_grad_local(
            _stage_fn(cfg, lay.stage_layout(), with_aux), p["blocks"],
            {k: p[k] for k in names}, _microbatches(x.detach(), m),
            _microbatches(lay.local(targets), m),
            loss_head=_loss_head(cfg, head_lay), pp_group=lay.pp_group,
            data_groups=lay._data_groups,
            head_reduce_groups=lay._model_groups if head_lay else (),
            head_sharded={"final_norm": False, "lm_head": True},
            with_aux=with_aux, aux_weight=cfg.moe_aux_weight)
        # this rank's shares, summed over the data axes by the backward
        # of the step's gather (the params' Partial placements)
        outs = [x] + [p["blocks"][k] for k in p["blocks"]] \
            + [p[k] for k in names]
        seeds = [dxs.reshape(x.shape)] + [g_blocks[k] for k in p["blocks"]] \
            + [g_head[k] for k in names]
    grads = torch.autograd.grad(outs, fresh, seeds, allow_unused=True)
    return loss.detach(), _grads_like(params, fresh, grads)


def _grads_like(params, fresh, grads):
    """``grads`` (one per leaf of ``params``, None for an unread leaf)
    as a tree like ``params``, zeros where None."""
    it = iter(torch.zeros_like(t) if g is None else g
              for t, g in zip(fresh, grads))
    return tree_map(lambda _: next(it), params)
