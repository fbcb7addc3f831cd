"""Flagship decoder-only transformer LM in PyTorch: forward and loss.

Port of ``tony_tpu/models/transformer.py``: the same config, presets and
parameter tree — plain dicts with the same keys, the same stacked
``[L, ...]`` shapes and the same einsum layouts as the JAX
``init_params`` — so weights move between the packages by
:mod:`tony_tpu_torch.models.weights` and keep their digest.

Attention runs the CUDA flash kernels on the card (K1 forward; K2, or
K3a + K3b, backward) and their plain versions on the CPU, through the
differentiable :func:`~tony_tpu_torch.ops.attention.flash_attention`.
With ``cfg.remat`` (policy ``"full"``) each block runs under
``torch.utils.checkpoint``: only its input is kept, and the backward
recomputes the block (K1 included) before differentiating it. RMSNorm,
RoPE and the SwiGLU MLP are plain torch with the JAX package's f32
points: RoPE and norms in
f32 math, the lm_head accumulated in f32 and stored in
``cfg.logits_storage_dtype``.

Not ported yet (they raise ``NotImplementedError``): MoE layers,
pipeline (pp) and context (cp) parallelism, and the remat policies
``"dots"`` and ``"attn"``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from tony_tpu_torch import resolve_device
from tony_tpu_torch.models.train import masked_cross_entropy
from tony_tpu_torch.ops.attention import flash_attention
from tony_tpu_torch.ops.norms import rms_norm_reference


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


def _check_dense(cfg: TransformerConfig) -> None:
    if cfg.num_experts:
        raise NotImplementedError("MoE layers are not ported yet")


def init_params(gen: torch.Generator, cfg: TransformerConfig,
                device=None) -> dict:
    """Initialize the parameter tree (layer params stacked ``[L, ...]``)
    from ``gen``, a CPU ``torch.Generator``, on ``device`` (the card
    unless the caller passes ``"cpu"``). Same tree and scaling as the JAX
    ``init_params``; the draws differ (another generator), so a parity
    test converts one package's weights into the other."""
    _check_dense(cfg)
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
        "w_gate": normal((L, d, f), d),
        "w_up": normal((L, d, f), d),
        "w_down": normal((L, f, d), f),
    }
    return {"embed": embed, "blocks": blocks,
            "final_norm": ones((d,)), "lm_head": normal((d, cfg.vocab_size),
                                                        d)}


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
    h, hk = q.shape[2], k.shape[2]
    if h == hk:
        return k, v
    if hk <= 0 or h % hk:
        raise ValueError(f"kv heads ({hk}) must divide heads ({h})")
    rep = h // hk
    return k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)


def _attention(q, k, v, mesh=None, cp_strategy: str = "ring",
               window: int | None = None):
    """Causal GQA attention, differentiable: the CUDA flash kernels for
    CUDA tensors, their plain versions for CPU tensors."""
    if cp_strategy not in ("ring", "ulysses"):
        raise ValueError(f"unknown cp_strategy {cp_strategy!r}; "
                         f"expected 'ring' or 'ulysses'")
    if mesh is not None:
        raise NotImplementedError("context parallelism is not ported yet")
    return flash_attention(q, k, v, causal=True, window=window)


def _mlp(h, p):
    """Dense SwiGLU feed-forward on ``[B, S, D]``."""
    gate = torch.einsum("bsd,df->bsf", h, p["w_gate"])
    up = torch.einsum("bsd,df->bsf", h, p["w_up"])
    return torch.einsum("bsf,fd->bsd", F.silu(gate) * up, p["w_down"])


def _project_qkv(x, p, rope):
    """A block's attention inputs: RMSNorm, the Q/K/V projections and
    RoPE on q and k. x: ``[B, S, D]``; returns q ``[B, S, H, hd]`` and
    k, v ``[B, S, KV, hd]``."""
    cos, sin = rope
    h = rms_norm_reference(x, p["attn_norm"])
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, p["wv"])
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _finish_block(x, o, p):
    """The rest of a block after attention: the output projection and
    the residual, then RMSNorm, the MLP and its residual."""
    x = x + torch.einsum("bshk,hkd->bsd", o, p["wo"])
    h = rms_norm_reference(x, p["mlp_norm"])
    return x + _mlp(h, p)


def _block(x, p, cfg: TransformerConfig, rope=None):
    """One decoder block. x: ``[B, S, D]``; p: this layer's params
    (unstacked); ``rope``: precomputed (cos, sin) tables."""
    _check_dense(cfg)
    b, s, _ = x.shape
    if rope is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
        rope = rope_tables(positions, cfg.head_dim)
    q, k, v = _project_qkv(x, p, rope)
    o = _attention(q, k, v, None, cfg.cp_strategy, cfg.attn_window or None)
    return _finish_block(x, o, p)


def lm_head_logits(x, w, cfg: TransformerConfig):
    """``x @ lm_head`` accumulated in f32, stored in
    ``cfg.logits_storage_dtype`` (one rounding, as in the JAX package)."""
    return (x.float() @ w.float()).to(cfg.logits_storage_dtype)


def _lm_head(params: dict, x, cfg: TransformerConfig):
    """final_norm + lm_head on block output ``[B, S, D]`` → logits."""
    x = rms_norm_reference(x, params["final_norm"])
    return lm_head_logits(x, params["lm_head"], cfg)


def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
            mesh=None) -> tuple:
    """tokens ``[B, S]`` int → (logits ``[B, S, V]`` in
    ``cfg.logits_storage_dtype``, aux_loss scalar — 0 for dense
    models). Differentiable in the params; callers that only infer wrap it
    in ``torch.no_grad()``. With ``cfg.remat``, when a gradient of the
    block params is recorded, each block is checkpointed (recomputed in
    the backward)."""
    if mesh is not None:
        raise NotImplementedError("pipeline / context parallelism is not "
                                  "ported yet")
    _check_dense(cfg)
    x = params["embed"][tokens].to(cfg.dtype)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    rope = rope_tables(positions, cfg.head_dim)   # hoisted out of the loop
    names = list(params["blocks"])
    # one unbind per stacked leaf: its backward stacks the layers' grads
    # once, where indexing each layer would scatter into a zeroed [L, ...]
    layers = zip(*(params["blocks"][n].unbind(0) for n in names))
    remat = cfg.remat and torch.is_grad_enabled() and any(
        a.requires_grad for a in params["blocks"].values())
    if remat and cfg.remat_policy != "full":
        raise NotImplementedError(f"remat_policy {cfg.remat_policy!r} is not "
                                  f"ported yet (only 'full')")
    for vals in layers:
        p = dict(zip(names, vals))
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                _block, x, p, cfg, rope, use_reentrant=False)
        else:
            x = _block(x, p, cfg, rope=rope)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    return _lm_head(params, x, cfg), aux


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
            mesh=None) -> torch.Tensor:
    """Next-token cross-entropy. batch: ``{"tokens": [B, S]}`` (shifted
    inside) or ``{"inputs", "targets"}``; targets == -1 are ignored."""
    if "inputs" in batch:
        inputs, targets = batch["inputs"], batch["targets"]
    else:
        inputs, targets = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    logits, aux = forward(params, inputs, cfg, mesh)
    return masked_cross_entropy(logits, targets) + cfg.moe_aux_weight * aux
