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
No remat: the JAX BERT has none. Sharding (``mesh``/``rules``) comes
with the dp/fsdp/tp slice and raises ``NotImplementedError`` here.
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


def _check_unsharded(mesh, rules) -> None:
    if mesh is not None or rules is not None:
        raise NotImplementedError("sharded BERT (mesh / rules) is not "
                                  "ported yet")


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


def _block(x, p):
    """One post-LN encoder block on ``[B, S, D]``."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    o = flash_attention(q, k, v, causal=False)
    attn = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    x = layer_norm(x + attn, p["attn_ln"]["scale"], p["attn_ln"]["bias"])
    inner = _gelu(torch.einsum("bsd,df->bsf", x, p["w_in"]) + p["b_in"])
    mlp = torch.einsum("bsf,fd->bsd", inner, p["w_out"]) + p["b_out"]
    return layer_norm(x + mlp, p["mlp_ln"]["scale"], p["mlp_ln"]["bias"])


def forward(params: dict, tokens: torch.Tensor, cfg: BertConfig,
            type_ids: torch.Tensor | None = None, mesh=None,
            rules=None) -> torch.Tensor:
    """tokens ``[B, S]`` int → MLM logits ``[B, S, V]`` (f32).
    Differentiable in the params; callers that only infer wrap it in
    ``torch.no_grad()``."""
    _check_unsharded(mesh, rules)
    s = tokens.shape[1]
    x = params["tok_embed"][tokens.long()]
    x = x + params["pos_embed"][None, :s]
    if type_ids is not None:
        x = x + params["type_embed"][type_ids.long()]
    x = layer_norm(x, params["embed_ln"]["scale"],
                   params["embed_ln"]["bias"]).to(cfg.dtype)
    for p in _layers(params["blocks"]):
        x = _block(x, p)
    h = _gelu(torch.einsum("bsd,de->bse", x, params["mlm_dense"]))
    h = layer_norm(h, params["mlm_ln"]["scale"], params["mlm_ln"]["bias"])
    # weight-tied output projection, f32 products with f32 accumulation
    logits = torch.einsum("bsd,vd->bsv", h.float(),
                          params["tok_embed"].float())
    return logits + params["mlm_bias"]


def mlm_loss(params: dict, batch: dict, cfg: BertConfig, mesh=None,
             rules=None) -> torch.Tensor:
    """batch: ``{"tokens" [B, S], "targets" [B, S]}`` (-1 = unmasked,
    ignored), optional ``"type_ids"``."""
    logits = forward(params, batch["tokens"], cfg, batch.get("type_ids"),
                     mesh, rules)
    return masked_cross_entropy(logits, batch["targets"])
