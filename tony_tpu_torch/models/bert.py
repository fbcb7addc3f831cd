"""BERT encoder + MLM head in PyTorch: forward and loss.

Port of ``tony_tpu/models/bert.py``: the same config, the BERT-base and
tiny configs, and the same parameter tree (keys, stacked ``[L, ...]``
shapes, dtypes; ``mlm_bias`` in f32), so weights move between the
packages by :mod:`tony_tpu_torch.models.weights` and keep their digest.
The classic BERT shape: learned position embeddings, a post-LN encoder
(``LN(x + attn)``, then ``LN(x + mlp)``), a GELU MLP with bias adds in
the model dtype, and an MLM head whose output projection is tied to the
token embedding.

On the card, attention is non-causal flash attention (K1 forward, K2 or
K3a + K3b backward) and every LayerNorm is K6, through
:func:`~tony_tpu_torch.ops.norms.layer_norm`; on the CPU both take their
plain versions. GELU is the tanh approximation, ``jax.nn.gelu``'s
default. The tied head multiplies in f32 with f32 accumulation (both
sides cast to f32, TF32 off), the port's form of the JAX einsum's
``preferred_element_type=f32``, as the LM's ``lm_head_logits`` does.
No remat: the JAX BERT has none.

With a ``mesh`` (dp, fsdp, tp; params laid out by :func:`logical_axes`)
each rank runs its local shard, as the LM does
(:mod:`tony_tpu_torch.parallel.spmd`): the batch over the data axes,
heads and the MLP hidden over tp, the tied head and the MLM bias split
by vocab, the loss combined across the vocab split without gathering
the logits. BERT has no experts: on an ep axis every leaf and activation
replicates.

As in the reference, where the compiler splits the activations'
``"seq"`` and the blocks carry ``"stage"`` but no pipeline schedule
runs, cp and pp leave the function the unsharded forward:

- under cp a rank holds its chunk of the sequence, its position
  embeddings those of the chunk's global positions, and the blocks
  attend non-causally across the chunks by the ring
  (:func:`~tony_tpu_torch.parallel.ulysses.context_attention`); the MLM
  loss is the global masked mean;
- under pp the stacked blocks stay split over pp as parameters, and
  every rank gathers them and runs every layer on its rows; their
  gradients come back whole on every pp rank (replicated, not
  partial), each keeping its stage's shard.

A dict of sizes emulates its cp ranks in this process on the global
tensors (:class:`~tony_tpu_torch.parallel.spmd.EmulatedCp`); its other
axes, pp among them, leave the function unsharded.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from tony_tpu_torch import resolve_device
from tony_tpu_torch.models.train import masked_cross_entropy
from tony_tpu_torch.ops.attention import flash_attention
from tony_tpu_torch.ops.norms import layer_norm
from tony_tpu_torch.parallel import spmd
from tony_tpu_torch.parallel.sharding import DEFAULT_RULES
from tony_tpu_torch.parallel.ulysses import context_attention


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """The JAX config's fields and defaults; ``dtype`` is a torch dtype."""
    vocab_size: int = 30_522
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_seq: int = 512
    type_vocab: int = 2
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


BERT_BASE = BertConfig()
BERT_TINY = BertConfig(vocab_size=1024, d_model=128, n_layers=2, n_heads=4,
                       d_ff=512, max_seq=128)


def init_params(gen: torch.Generator, cfg: BertConfig, device=None) -> dict:
    """Initialize the parameter tree from ``gen``, a CPU
    ``torch.Generator``, on ``device`` (the card unless the caller passes
    ``"cpu"``). Same tree and scaling as the JAX ``init_params``; the
    draws differ (another generator), so a parity test converts one
    package's weights into the other."""
    dev = resolve_device(device)
    d, h, hd, f, L = (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
                      cfg.n_layers)
    dt = cfg.dtype

    def dense(shape, fan_in):
        x = torch.randn(shape, generator=gen, dtype=torch.float32)
        return (x * fan_in ** -0.5).to(device=dev, dtype=dt)

    def fill(shape, value, dtype=dt):
        return torch.full(shape, value, dtype=dtype, device=dev)

    def ln(lead=()):
        return {"scale": fill(lead + (d,), 1.0), "bias": fill(lead + (d,), 0.0)}

    # drawn in the JAX package's key order
    tok, pos, typ = (dense((cfg.vocab_size, d), d), dense((cfg.max_seq, d), d),
                     dense((cfg.type_vocab, d), d))
    wq, wk, wv = (dense((L, d, h, hd), d) for _ in range(3))
    wo = dense((L, h, hd, d), d)
    w_in, w_out = dense((L, d, f), d), dense((L, f, d), f)
    return {
        "tok_embed": tok,
        "pos_embed": pos,
        "type_embed": typ,
        "embed_ln": ln(),
        "blocks": {
            "wq": wq, "wk": wk, "wv": wv, "wo": wo,
            "attn_ln": ln((L,)),
            "w_in": w_in,
            "b_in": fill((L, f), 0.0),
            "w_out": w_out,
            "b_out": fill((L, d), 0.0),
            "mlp_ln": ln((L,)),
        },
        "mlm_dense": dense((d, d), d),
        "mlm_ln": ln(),
        "mlm_bias": fill((cfg.vocab_size,), 0.0, torch.float32),
    }


def logical_axes(cfg: BertConfig) -> dict:
    """Logical-axis tree matching :func:`init_params` (the JAX
    package's)."""
    def ln(lead):
        return {"scale": lead + ("norm",), "bias": lead + ("norm",)}
    return {
        "tok_embed": ("vocab", "embed"),
        "pos_embed": (None, "embed"),
        "type_embed": (None, "embed"),
        "embed_ln": ln(()),
        "blocks": {
            "wq": ("stage", "embed", "heads", "kv"),
            "wk": ("stage", "embed", "heads", "kv"),
            "wv": ("stage", "embed", "heads", "kv"),
            "wo": ("stage", "heads", "kv", "embed"),
            "attn_ln": ln(("stage",)),
            "w_in": ("stage", "embed", "mlp"),
            "b_in": ("stage", "mlp"),
            "w_out": ("stage", "mlp", "embed"),
            "b_out": ("stage", "embed"),
            "mlp_ln": ln(("stage",)),
        },
        "mlm_dense": ("embed", "embed"),
        "mlm_ln": ln(()),
        "mlm_bias": ("vocab",),
    }


def _layers(blocks: dict):
    """The stacked block params as one dict per layer (views): one
    unbind per stacked leaf, so the backward stacks each leaf's layer
    gradients once."""
    def unbind(tree):
        if isinstance(tree, dict):
            per = {k: unbind(v) for k, v in tree.items()}
            return [dict(zip(per, vals)) for vals in zip(*per.values())]
        return tree.unbind(0)
    return unbind(blocks)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _block(x, p, lay=None):
    """One post-LN encoder block on ``[B, S, D]`` (this rank's heads and
    MLP slice under tp; the row-parallel outputs sum over the ranks
    before their bias; under cp this rank's chunk, attending every
    chunk by the ring)."""
    h = spmd.copy_to_model(x, lay)
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, p["wv"])
    if lay is not None and lay.cp_size > 1:
        o = context_attention(q, k, v, lay, causal=False)
    else:
        o = flash_attention(q, k, v, causal=False)
    attn = spmd.reduce_from_model(torch.einsum("bshk,hkd->bsd", o, p["wo"]),
                                  lay)
    x = layer_norm(x + attn, p["attn_ln"]["scale"], p["attn_ln"]["bias"])
    h = spmd.copy_to_model(x, lay)
    inner = _gelu(torch.einsum("bsd,df->bsf", h, p["w_in"]) + p["b_in"])
    mlp = spmd.reduce_from_model(
        torch.einsum("bsf,fd->bsd", inner, p["w_out"]), lay) + p["b_out"]
    return layer_norm(x + mlp, p["mlp_ln"]["scale"], p["mlp_ln"]["bias"])


def _forward_local(params: dict, tokens: torch.Tensor, cfg: BertConfig,
                   type_ids=None, lay=None) -> torch.Tensor:
    """The forward on this rank's params and batch (the whole tree and
    batch without a mesh) → this rank's f32 logits."""
    s = tokens.shape[1]
    off = lay.cp_rank * s if lay is not None else 0
    x = spmd.embed_lookup(params["tok_embed"], tokens, lay, cfg.vocab_size)
    x = x + params["pos_embed"][None, off:off + s]
    if type_ids is not None:
        x = x + params["type_embed"][type_ids.long()]
    x = layer_norm(x, params["embed_ln"]["scale"],
                   params["embed_ln"]["bias"]).to(cfg.dtype)
    for p in _layers(params["blocks"]):
        x = _block(x, p, lay)
    h = _gelu(torch.einsum("bsd,de->bse", x, params["mlm_dense"]))
    h = layer_norm(h, params["mlm_ln"]["scale"], params["mlm_ln"]["bias"])
    h = spmd.copy_to_model(h, lay)
    # weight-tied output projection, f32 products with f32 accumulation
    logits = torch.einsum("bsd,vd->bsv", h.float(),
                          params["tok_embed"].float())
    return logits + params["mlm_bias"]


def _local_inputs(params, batch: dict, mesh, rules):
    """(local params, local batch, layout) of a sharded step: the blocks
    gathered over pp (not a pipeline), the batch cut to this rank's rows
    and, under cp, its chunk of the sequence."""
    lay = spmd.Layout(mesh, rules, pipelined=False)
    local = {k: (lay.local(v) if v is not None else None)
             for k, v in batch.items()}
    return lay.local_params(params), local, lay


def _emulated_layout(mesh: dict, rules):
    cp = spmd.seq_parallel_size(mesh, rules)
    return spmd.EmulatedCp(cp) if cp > 1 else None


def forward(params: dict, tokens: torch.Tensor, cfg: BertConfig,
            type_ids: torch.Tensor | None = None, mesh=None,
            rules=DEFAULT_RULES) -> torch.Tensor:
    """tokens ``[B, S]`` int → MLM logits ``[B, S, V]`` (f32).
    Differentiable in the params; callers that only infer wrap it in
    ``torch.no_grad()``. With a ``mesh`` the params are DTensors laid
    out by :func:`logical_axes`, the inputs the global batch, and the
    logits a DTensor split by ``("batch", "seq", "vocab")``; a dict of
    sizes emulates its cp ranks on global params and returns global
    logits."""
    if mesh is None or isinstance(mesh, dict):
        lay = None if mesh is None else _emulated_layout(mesh, rules)
        return _forward_local(params, tokens, cfg, type_ids, lay)
    params, b, lay = _local_inputs(
        params, {"tokens": tokens, "type_ids": type_ids}, mesh, rules)
    logits = _forward_local(params, b["tokens"], cfg, b["type_ids"], lay)
    return lay.wrap(logits, ("batch", "seq", "vocab"))


def mlm_loss(params: dict, batch: dict, cfg: BertConfig, mesh=None,
             rules=DEFAULT_RULES) -> torch.Tensor:
    """batch: ``{"tokens" [B, S], "targets" [B, S]}`` (-1 = unmasked,
    ignored), optional ``"type_ids"``. With a ``mesh``, the mean over the
    global batch, the same plain 0-d tensor on every rank (a dict of
    sizes: its cp ranks emulated, as :func:`forward`)."""
    if mesh is None or isinstance(mesh, dict):
        lay = None if mesh is None else _emulated_layout(mesh, rules)
        logits = _forward_local(params, batch["tokens"], cfg,
                                batch.get("type_ids"), lay)
        return masked_cross_entropy(logits, batch["targets"])
    params, b, lay = _local_inputs(params, batch, mesh, rules)
    logits = _forward_local(params, b["tokens"], cfg, b.get("type_ids"),
                            lay)
    return spmd.cross_entropy(logits, b["targets"], lay, cfg.vocab_size)
