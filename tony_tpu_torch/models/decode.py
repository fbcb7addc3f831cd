"""Autoregressive decoding with a KV cache for the flagship transformer.

Port of ``tony_tpu/models/decode.py``: greedy decoding, sampling
(top-k → temperature → nucleus, drawn from the JAX package's threefry
streams through :mod:`tony_tpu_torch.ops.prng`, so a seed gives JAX's
tokens), speculative decoding (greedy and rejection-sampled, host-driven
at batch 1 or round by round at any batch) and beam search. The layouts
are the JAX package's: the cache is a ``[L, B, rows, KV, hd]`` buffer
pair, prefill runs the whole prompt through the model (attention through
the CUDA flash kernel on the card) and writes its K/V, and each decode
step attends its query positions over the cache.

Cache kinds, from the config:

- ``kv_cache_dtype="int8"``: k/v stored int8 with per-token, per-kv-head
  absmax scales in ``k_scale``/``v_scale`` buffers ``[L, B, rows, KV,
  1]`` f32, written by every write path beside k/v; the scales fold
  outside the dots (:func:`_kv_quantize`);
- ``kv_cache_capacity`` (with ``attn_window``): a ROLLING cache of that
  many rows per slot, written modulo the capacity and read by each
  row's ring offset (:func:`_ring_cached_attention`), single-token
  decode steps only.

Weights may be an int8 serving snapshot
(:func:`~tony_tpu_torch.models.quantize.quantize_weights_int8`): every
weight product goes through :func:`_weinsum`.

Where the JAX package donated buffers to a jitted program, the port
writes the cache IN PLACE (:func:`_write_kv_chunk`, :func:`place_rows`),
so a decode step never copies the cache.

Frontiers: ``cache["length"]`` is a Python int when every row sits at
the same position (:func:`prefill`, :func:`generate`) and a ``[B]`` int32
tensor when rows sit at their own positions (:func:`prefill_rows`, the
serving batcher, the batched speculative loop). The length-aware
blockwise walk over large caches needs the highest query position to
bound its loop; the JAX package traced it on the device, the port takes
it from the caller's host-side bookkeeping (``pos_range``) so a serving
step never waits on the card.

MoE configs decode through the same paths: the block's MLP is the
training block's mixture of experts (:func:`_mlp`), whose capacity
follows each call's own sequence length.

Tensor parallelism: ``generate``, ``prefill``, ``prefill_rows``,
``extend_step``, ``decode_step`` and ``beam_search`` take ``mesh=``, as
``transformer.forward`` does — a ``DeviceMesh`` with the DTensor params
of ``shard_pytree`` (quantized after sharding for int8 weights), or a
dict of sizes that emulates every tp rank in this process (the form one
card runs) — or a :class:`ShardedParams` from :func:`shard_params` in
place of ``params``. Each rank runs its query heads (prefill: K1 on
them and its kv heads), keeps its kv heads' cache, sums the
row-parallel products (``wo``, ``w_down``) over the ranks, looks the
embedding up vocab-parallel and gathers the vocab-split logits before
any argmax, filter or sample, so every rank commits the same tokens.
Every other entry point built on those (speculative decoding) takes a
:class:`ShardedParams` the same way; the serving batcher takes no mesh,
as in the JAX package.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from tony_tpu_torch import resolve_device
from tony_tpu_torch.models import transformer as T
from tony_tpu_torch.models.quantize import (QuantizedWeight, layer,
                                            quantized_axes)
from tony_tpu_torch.ops import prng
from tony_tpu_torch.ops.attention import tp_kv_heads
from tony_tpu_torch.ops.norms import rms_norm
from tony_tpu_torch.parallel import spmd
from tony_tpu_torch.parallel.sharding import DEFAULT_RULES, logical_to_spec

#: Token positions (the sequence axis) strictly above which a quantized
#: product with bf16 activations casts the int8 weight to bf16 instead of
#: running in f32: prefill over a long prompt is compute-bound, and f32
#: throughput is far below bf16's. The JAX package's rung: a prompt and
#: its power-of-two admission bucket land on the same side (``next_pow2(n)
#: <= 256 iff n <= 256``), so bucketed admission and an exact-length
#: prefill of one prompt take the same route.
_QUANT_PREFILL_MIN_S = 256


def _weinsum(spec: str, x, w, f32_out: bool = False):
    """The one dispatch of weight products. A plain weight takes the
    plain einsum. A :class:`QuantizedWeight` computes the product on the
    int8 weight cast to f32 (exact: integers up to 127) and applies the
    per-output-channel scale outside the contraction, in f32; bf16
    activations with more than ``_QUANT_PREFILL_MIN_S`` positions on the
    sequence axis cast the weight to bf16 instead (the scale still
    applies in f32, after the product; the port's product rounds to bf16
    once before it, where the JAX package's accumulates straight to
    f32). ``f32_out`` (the lm_head) returns the f32 result, else it is
    cast back to the activations' dtype."""
    if isinstance(w, QuantizedWeight):
        s_len = x.shape[1] if x.dim() >= 3 else 1
        if s_len > _QUANT_PREFILL_MIN_S and x.dtype == torch.bfloat16:
            y = torch.einsum(spec, x, w.q.to(x.dtype)).float() * w.scale
        else:
            y = torch.einsum(spec, x.float(), w.q.float()) * w.scale
        return y if f32_out else y.to(x.dtype)
    return torch.einsum(spec, x, w)


class GenerateOutput(NamedTuple):
    tokens: torch.Tensor     # [B, prompt_len + max_new_tokens]
    logprobs: torch.Tensor   # [B, max_new_tokens] logprob of each token


class BeamSearchOutput(NamedTuple):
    tokens: torch.Tensor     # [B, W, prompt_len + max_new_tokens], best first
    scores: torch.Tensor     # [B, W] sum of token logprobs (length-penalized
    #                          ordering; raw sums reported)
    lengths: torch.Tensor    # [B, W] generated tokens incl. eos


class ShardedParams(NamedTuple):
    """A decode's params under tensor parallelism (:func:`shard_params`):
    one tree per model-axis rank this process runs, each with the rank's
    query heads, kv heads, MLP hidden and vocab slice, and the
    collectives between the ranks. Every entry point takes one in place
    of ``params``."""
    shards: list                 # one param tree per rank in ``ranks``
    ranks: spmd.ModelRanks


def shard_params(params: dict, cfg: T.TransformerConfig, mesh,
                 rules=DEFAULT_RULES) -> ShardedParams:
    """``params`` laid out for tensor-parallel decoding on ``mesh``.

    - a ``DeviceMesh``: ``params`` are the DTensors of
      :func:`~tony_tpu_torch.parallel.sharding.shard_pytree` (float or
      quantized after sharding); this rank keeps its model-axis shards,
      gathered over the data axes
      (:meth:`~tony_tpu_torch.parallel.spmd.Layout.local_params`), and
      the collectives run in the model axis's group;
    - a dict of sizes (``{"tp": 4}``): ``params`` are global tensors, cut
      into every model-axis rank's shards, all run in this process
      (:func:`~tony_tpu_torch.parallel.spmd.emulated_shards`).

    The data axes replicate: every rank decodes the whole batch. Under
    GQA the K/V projections replicate over tp (:func:`T.logical_axes`);
    each rank keeps the kv heads its query heads read
    (:func:`~tony_tpu_torch.ops.attention.tp_kv_heads`). cp, pp and ep
    axes, and MoE under tp, raise ``NotImplementedError``."""
    for logical, what in ((("batch", "seq"), "cp"), (("stage",), "pp"),
                          (("batch", "expert"), "ep")):
        entry = logical_to_spec(logical, mesh, rules)[-1]
        if entry is not None:
            raise NotImplementedError(
                f"decoding on a mesh with a live {what} axis ({entry}) is "
                f"not ported: decode runs over tp and the data axes")
    axes = quantized_axes(params, T.logical_axes(cfg))
    if isinstance(mesh, dict):
        ranks, shards = spmd.emulated_shards(params, axes, mesh, rules)
    else:
        from torch.distributed.tensor import DTensor
        if not isinstance(params["embed"], DTensor):
            raise ValueError("decoding on a DeviceMesh takes the params "
                             "laid out by shard_pytree (DTensors); a dict "
                             "of sizes emulates the mesh on global params")
        lay = spmd.Layout(mesh, rules)
        ranks, shards = lay.model_ranks(), [lay.local_params(params)]
    if ranks.size > 1 and cfg.num_experts:
        raise NotImplementedError("mixture-of-experts decoding under "
                                  "tensor parallelism is not ported")
    return ShardedParams([_rank_kv(p, cfg, r, ranks.size)
                          for r, p in zip(ranks.ranks, shards)], ranks)


def _rank_kv(p: dict, cfg: T.TransformerConfig, rank: int,
             size: int) -> dict:
    """Under GQA with tp (K/V projections replicated), ``p`` with ``wk``
    and ``wv`` cut to the kv heads rank ``rank`` reads."""
    if size == 1 or cfg.kv_heads == cfg.n_heads:
        return p
    lo, hi = tp_kv_heads(cfg.n_heads, cfg.kv_heads, rank, size)

    def cut(w):       # [L, d, KV, hd]; a quantized scale is [L, KV, hd]
        if isinstance(w, QuantizedWeight):
            return QuantizedWeight(w.q[:, :, lo:hi], w.scale[:, lo:hi])
        return w[:, :, lo:hi]
    blocks = dict(p["blocks"], wk=cut(p["blocks"]["wk"]),
                  wv=cut(p["blocks"]["wv"]))
    return dict(p, blocks=blocks)


def _ranked(params, cfg: T.TransformerConfig, mesh=None) -> ShardedParams:
    """``params`` as a :class:`ShardedParams`: as given when it is one,
    laid out on ``mesh`` when there is one, else the one rank of an
    unsharded run."""
    if isinstance(params, ShardedParams):
        return params
    if mesh is not None:
        return shard_params(params, cfg, mesh)
    return ShardedParams([params], spmd.SOLO)


def _rank_bufs(bufs: dict, i: int, n: int) -> dict:
    """Rank ``i``'s view of a cache's buffers that hold ``n`` ranks' kv
    heads side by side, rank-major, on the kv-head axis (the buffers
    themselves when ``n`` is 1)."""
    if n == 1:
        return bufs
    kv = bufs["k"].shape[3] // n
    return {name: b[:, :, :, i * kv:(i + 1) * kv] for name, b in
            bufs.items()}


def _embed(sp: ShardedParams, tokens, cfg: T.TransformerConfig):
    """The token embedding ``[B, S, D]`` in ``cfg.dtype``: under tp the
    vocab-parallel lookup, each rank's part summed over the ranks."""
    if sp.ranks.size == 1:
        return sp.shards[0]["embed"][tokens.long()].to(cfg.dtype)
    return sp.ranks.sum([spmd.embed_partial(p["embed"], tokens, r) for
                         r, p in zip(sp.ranks.ranks, sp.shards)]
                        ).to(cfg.dtype)


def _head(sp: ShardedParams, x, cfg: T.TransformerConfig, select=None):
    """Logits of block output ``x`` ``[..., D]``: on each rank the final
    RMSNorm, ``select`` (the positions the head runs on, after the norm)
    and its vocab slice of the lm_head; the slices gathered over the
    ranks, so every rank holds the full ``[..., V]`` before any argmax,
    filter or sample."""
    parts = []
    for p in sp.shards:
        h = rms_norm(x, p["final_norm"])
        parts.append(_lm_head(h if select is None else select(h),
                              p["lm_head"], cfg))
    return sp.ranks.gather(parts)


# Length-aware decode attention: caches at or above this many positions
# take the block-wise path whose cost follows the LIVE length; below it
# the dense path is cheaper and matches the training forward exactly.
DECODE_BLOCK = 256
_BLOCKWISE_MIN_LEN = 2 * DECODE_BLOCK

#: cache keys that hold per-position buffers ("length" is the frontier):
#: k/v, and their scales in an int8 cache
_KV_BUFS = ("k", "v", "k_scale", "v_scale")


def to_device(a, device) -> torch.Tensor:
    """Host array → tensor on ``device``. To the card it goes through
    pinned memory without blocking: a pageable copy would wait for every
    kernel already queued, which would stall the serving pipeline."""
    t = torch.as_tensor(np.asarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _ring_capacity(cfg: T.TransformerConfig) -> int:
    """Rolling-cache rows per slot (0 = a linear cache of max_len rows)."""
    return cfg.kv_cache_capacity


def _check_no_ring(cfg: T.TransformerConfig, what: str) -> None:
    """Entry points whose cache discipline needs the LINEAR cache
    (bucketed prefill, chunked verifies, beam gathers) reject rolling
    caches up front."""
    if _ring_capacity(cfg):
        raise ValueError(f"{what} requires a linear KV cache; unset "
                         f"kv_cache_capacity (rolling cache) for it")


def init_kv_cache(cfg: T.TransformerConfig, batch: int, max_len: int,
                  device=None, mesh=None) -> dict:
    """Zeroed cache on ``device`` (the card unless the caller passes
    ``"cpu"``), frontier 0: k/v of shape ``[L, B, rows, KV, hd]`` in
    ``cfg.dtype``, or int8 with ``k_scale``/``v_scale`` ``[L, B, rows,
    KV, 1]`` f32 when ``cfg.kv_cache_dtype == "int8"``. ``rows`` is
    ``max_len``, or ``cfg.kv_cache_capacity`` for a rolling cache (which
    warns at 4x the window or more: its attention reads every row each
    step, so the cost per token is O(capacity), not O(window)).

    With a ``mesh`` (see :func:`shard_params`) ``KV`` holds only the kv
    heads of the model-axis ranks this process runs: on a
    ``DeviceMesh`` this rank's, on a dict of sizes every rank's, side by
    side in rank order."""
    if mesh is None:
        ranks = spmd.SOLO
    elif isinstance(mesh, dict):
        ranks = spmd.emulated_ranks(mesh)
    else:
        ranks = spmd.Layout(mesh).model_ranks()
    return _new_cache(cfg, batch, max_len, device, ranks)


def _new_cache(cfg: T.TransformerConfig, batch: int, max_len: int, device,
               ranks: spmd.ModelRanks) -> dict:
    """:func:`init_kv_cache` for the model-axis ranks ``ranks``."""
    dev = resolve_device(device)
    cap = _ring_capacity(cfg)
    rows = cap or max_len
    if cap and cfg.attn_window and cap >= 4 * cfg.attn_window:
        warnings.warn(
            f"kv_cache_capacity={rows} is {rows // cfg.attn_window}x "
            f"attn_window={cfg.attn_window}: ring-cache attention reads "
            "every capacity row per token (O(capacity), not O(window)) — "
            "size the capacity near the window", stacklevel=2)
    lo, hi = tp_kv_heads(cfg.n_heads, cfg.kv_heads, 0, ranks.size)
    shape = (cfg.n_layers, batch, rows, (hi - lo) * len(ranks.ranks),
             cfg.head_dim)
    if cfg.kv_quant:
        sshape = shape[:-1] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_scale": torch.zeros(sshape, device=dev),
                "v_scale": torch.zeros(sshape, device=dev),
                "length": 0}
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "length": 0}


def _kv_bufs(cache: dict) -> dict:
    """The cache's position-indexed buffers, without the frontier."""
    return {n: cache[n] for n in _KV_BUFS if n in cache}


def _kv_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of a K/V chunk ``[..., KV, hd]`` along
    its head dim: scale = absmax/127 per (token, kv head), clamped below
    at 1e-8; q = round(x/scale) in [-127, 127]. Returns (q int8, scale
    ``[..., KV, 1]`` f32). The scale is constant along hd, so the cached
    attention applies it outside the dots and reads the cache int8."""
    x32 = x.float()
    scale = torch.clamp_min(x32.abs().amax(dim=-1, keepdim=True) / 127.0,
                            1e-8)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def _kv_writes(bufs: dict, k, v) -> dict:
    """The buffer → chunk map a K/V write applies: k/v for a float cache;
    quantized k/v and their scale chunks for an int8 cache."""
    if "k_scale" in bufs:
        kq, ks = _kv_quantize(k)
        vq, vs = _kv_quantize(v)
        return {"k": kq, "k_scale": ks, "v": vq, "v_scale": vs}
    return {"k": k, "v": v}


def _q_positions(q_start, b: int, n_q: int, device) -> torch.Tensor:
    """``[B, Q]`` absolute positions of a decode chunk. ``q_start`` is an
    int (all rows at one frontier) or a ``[B]`` tensor (per-row
    frontiers)."""
    ar = torch.arange(n_q, device=device)
    if isinstance(q_start, torch.Tensor) and q_start.dim() == 1:
        return q_start.long()[:, None] + ar[None, :]
    return (int(q_start) + ar).expand(b, n_q)


def _pos_range(pos, n_q: int) -> tuple[int, int]:
    """(lowest, highest) query position of a chunk at ``pos``, on the
    host. A tensor ``pos`` is read back (a sync) — callers on the serving
    path pass their own bookkeeping instead."""
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        return int(pos.min()), int(pos.max()) + n_q - 1
    return int(pos), int(pos) + n_q - 1


def _scale_row(bufs, name: str, li: int, lo: int = 0, hi=None):
    """An int8 cache's scales of layer ``li``, positions [lo, hi), as
    ``[B, KV, S]`` for the scores' trailing axes."""
    return bufs[name][li, :, lo:hi, :, 0].permute(0, 2, 1)


def _cached_attention_blockwise(q, bufs, li, q_start, q_range,
                                block: int = DECODE_BLOCK,
                                attn_window: int | None = None):
    """Online-softmax cached attention over the ACTIVE cache blocks only:
    blocks ``lo .. n_active-1`` where ``n_active = (max_qpos + block) //
    block`` (capped at the cache's block count — blocks past the end are
    fully masked and change nothing) and ``lo`` is the window's first
    block. ``q_range`` carries (min, max) query position from the host;
    a bound looser than the true one walks more (fully masked) blocks
    and gives the same result. Same contract as the dense path; numerics
    are flash-style, so logits agree with it to flash tolerance, not
    bitwise. A trailing partial block re-reads from ``max_len - block``
    and masks the re-read rows. An int8 cache's K scale applies on the
    scores and its V scale on ``p``, outside the dots."""
    k_all, v_all = bufs["k"], bufs["v"]
    quant = "k_scale" in bufs
    b, n_q, h, d = q.shape
    max_len, kv = k_all.shape[2], k_all.shape[3]
    group = h // kv
    scale = d ** -0.5
    q_pos = _q_positions(q_start, b, n_q, q.device)           # [B, Q]
    lo_pos, hi_pos = q_range
    n_active = min((hi_pos + block) // block, -(-max_len // block))
    lo = (max(lo_pos - attn_window + 1, 0) // block
          if attn_window is not None else 0)
    pdt = q.dtype if quant else v_all.dtype      # the value product's operand
    qg = q.reshape(b, n_q, kv, group, d).float()
    m = torch.full((b, kv, group, n_q), -torch.inf, device=q.device)
    l = torch.zeros((b, kv, group, n_q), device=q.device)
    acc = torch.zeros((b, kv, group, n_q, d), device=q.device)
    for i in range(lo, n_active):
        start = min(i * block, max_len - block)
        kb = k_all[li, :, start:start + block]                # [B, S, KV, hd]
        vb = v_all[li, :, start:start + block]
        k_pos = start + torch.arange(block, device=q.device)
        mask = ((k_pos >= i * block)[None, None, :]
                & (k_pos[None, None, :] <= q_pos[:, :, None]))  # [B, Q, S]
        if attn_window is not None:
            mask = mask & (q_pos[:, :, None] - k_pos[None, None, :]
                           < attn_window)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kb.float()) * scale
        if quant:
            s = s * _scale_row(bufs, "k_scale", li, start,
                               start + block)[:, :, None, None, :]
        s = s.masked_fill(~mask[:, None, None], -torch.inf)
        new_m = torch.maximum(m, s.amax(dim=-1))
        # all-masked (query, block) pairs keep m = -inf; subtract 0 there
        safe_m = torch.where(torch.isneginf(new_m), 0.0, new_m)
        alpha = torch.exp(m - safe_m)
        p = torch.exp(s - safe_m[..., None])
        l = l * alpha + p.sum(dim=-1)
        if quant:
            p = p * _scale_row(bufs, "v_scale", li, start,
                               start + block)[:, :, None, None, :]
        pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(pdt).float(),
                          vb.float())
        acc = acc * alpha[..., None] + pv
        m = new_m
    o = acc / l[..., None]          # l > 0: every query attends itself
    o = o.permute(0, 3, 1, 2, 4).reshape(b, n_q, h, d)
    return o.to(q.dtype)


def _dense_cached(q, bufs, li, mask):
    """Dense attention of q ``[B, Q, H, hd]`` over layer ``li`` of the
    cache under ``mask`` ``[B, Q, S]`` (True = attended): scores and
    softmax in f32 from cache-dtype operands, GQA read unexpanded, an
    int8 cache's scales folded outside the dots."""
    quant = "k_scale" in bufs
    k_cache, v_cache = bufs["k"][li], bufs["v"][li]
    b, n_q, h, d = q.shape
    kv = k_cache.shape[2]
    qg = q.reshape(b, n_q, kv, h // kv, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                          k_cache.float()) * (d ** -0.5)
    if quant:
        scores = scores * _scale_row(bufs, "k_scale", li)[:, :, None, None]
    scores = scores.masked_fill(~mask[:, None, None], -torch.inf)
    probs = torch.softmax(scores, dim=-1)
    if quant:
        probs = probs * _scale_row(bufs, "v_scale", li)[:, :, None, None]
    pdt = q.dtype if quant else v_cache.dtype
    o = torch.einsum("bkgqs,bskd->bqkgd", probs.to(pdt).float(),
                     v_cache.float())
    return o.reshape(b, n_q, h, d).to(q.dtype)


def _cached_attention(q, bufs, li, q_start, attn_window=None,
                      q_range=None):
    """q: ``[B, K, H, hd]`` at positions q_start..q_start+K-1; ``bufs``:
    the stacked ``[L, B, max_len, KV, hd]`` buffers (and an int8 cache's
    scales), ``li`` this layer. Query i attends cache positions <=
    q_start+i (and within the window). Caches of ``_BLOCKWISE_MIN_LEN``
    positions or more take the length-aware blockwise path."""
    b, n_q, h, d = q.shape
    max_len = bufs["k"].shape[2]
    if max_len >= _BLOCKWISE_MIN_LEN:
        if q_range is None:
            q_range = _pos_range(q_start, n_q)
        return _cached_attention_blockwise(q, bufs, li, q_start, q_range,
                                           attn_window=attn_window)
    q_pos = _q_positions(q_start, b, n_q, q.device)           # [B, Q]
    k_pos = torch.arange(max_len, device=q.device)
    mask = k_pos[None, None, :] <= q_pos[:, :, None]          # [B, Q, S]
    if attn_window is not None:
        mask = mask & (q_pos[:, :, None] - k_pos[None, None, :]
                       < attn_window)
    return _dense_cached(q, bufs, li, mask)


def _ring_cached_attention(q, bufs, li, q_pos, attn_window: int):
    """Cached attention over a ROLLING cache ``[L, B, C, KV, hd]``:
    writes wrap modulo C, so ring row ``r`` holds the most recent
    absolute position congruent to r. A query at ``q_pos`` attends the
    rows whose offset ``(q_pos - r) mod C`` is below ``min(attn_window,
    q_pos + 1)`` — in-window history of the current occupant only (older
    residue in a reused slot never passes the offset test). Dense over
    the C rows; single-position queries (q ``[B, 1, H, hd]``, q_pos
    ``[B]``)."""
    c = bufs["k"].shape[2]
    offset = torch.remainder(q_pos[:, None].long()
                             - torch.arange(c, device=q.device)[None, :], c)
    mask = offset < torch.clamp(q_pos[:, None].long() + 1, max=attn_window)
    return _dense_cached(q, bufs, li, mask[:, None, :])


def _window_positions(pos, n_k: int, max_len: int, window: int):
    """Per-row write positions of the bounded-window write (the JAX
    package's ``_window_write``): the window's base is the lowest row
    frontier, CLAMPED to ``max_len - window`` — near the end of
    generation the draft writes' base runs up to k past the slowest
    active row, and the clamp keeps the window on the cache; each row's
    offset from the clamped base is clipped into ``[0, window - K]``
    (the commit schedule keeps live rows inside; a clipped frozen row
    writes into its own dead rows). Returns ``[B]`` start positions,
    computed on the device."""
    base = torch.clamp(pos.min(), max=max_len - window)
    return base + torch.clamp(pos - base, 0, window - n_k)


def _write_kv_chunk(buf, chunk, li, pos, fits: bool = True,
                    window: int | None = None) -> None:
    """Write a K-token chunk ``[B, K, KV, d]`` into the stacked buffer
    ``[L, B, rows, KV, d]`` at layer ``li`` IN PLACE (the JAX package
    donated the buffer). ``pos``: an int (one contiguous slice) or a
    ``[B]`` tensor (per-row positions). With ``window`` a per-row write
    takes the bounded-window positions (:func:`_window_positions`).
    Per-row positions past the cache end are dropped, as JAX's scatter
    drops them — only finished rows still decoding garbage reach there;
    ``fits`` (from the caller's host bookkeeping) says none can, which
    skips that masking."""
    n_k = chunk.shape[1]
    if not (isinstance(pos, torch.Tensor) and pos.dim() == 1):
        p = int(pos)
        buf[li, :, p:p + n_k] = chunk
        return
    max_len = buf.shape[2]
    if window is not None:
        pos = _window_positions(pos.long(), n_k, max_len, window)
        fits = True
    b_idx = torch.arange(chunk.shape[0], device=buf.device)[:, None]
    s_idx = pos.long()[:, None] + torch.arange(n_k, device=buf.device)
    if not fits:
        # a dropped write rewrites the value already there; only garbage
        # rows straddle the end, so a clamped duplicate hits only them
        valid = (s_idx < max_len)[..., None, None]
        s_idx = s_idx.clamp(max=max_len - 1)
        chunk = torch.where(valid, chunk, buf[li, b_idx, s_idx])
    buf[li, b_idx, s_idx] = chunk


def _project_qkv(x, p, rope):
    """RMSNorm, the Q/K/V products (through :func:`_weinsum`) and RoPE on
    q and k. x: ``[B, S, D]``."""
    cos, sin = rope
    h = rms_norm(x, p["attn_norm"])
    q = _weinsum("bsd,dhk->bshk", h, p["wq"])
    k = _weinsum("bsd,dhk->bshk", h, p["wk"])
    v = _weinsum("bsd,dhk->bshk", h, p["wv"])
    return T.apply_rope(q, cos, sin), T.apply_rope(k, cos, sin), v


def _mlp(h, p, cfg: T.TransformerConfig):
    """Dense SwiGLU (through :func:`_weinsum`) or MoE feed-forward on
    ``[B, S, D]`` — the training block's params.

    MoE caveat: routing capacity scales with the LOCAL sequence length,
    so single-position decode (S=1, capacity >= top_k) never drops
    tokens while a full forward at low ``moe_capacity_factor`` may —
    cached generation can then diverge from the training forward on
    overflow tokens. This is the standard gshard trade; raise the
    capacity factor if you need exact equivalence."""
    if "router" in p:
        return T._moe(h, p, cfg)[0]
    gate = _weinsum("bsd,df->bsf", h, p["w_gate"])
    up = _weinsum("bsd,df->bsf", h, p["w_up"])
    return _weinsum("bsf,fd->bsd", F.silu(gate) * up, p["w_down"])


def _finish_block(x, os, ps, cfg: T.TransformerConfig,
                  ranks: spmd.ModelRanks):
    """The output projection and residual, then RMSNorm, the MLP and its
    residual — the training block's, through :func:`_weinsum`. ``os`` and
    ``ps`` are each rank's attention output and layer params: the
    row-parallel products (``wo``, ``w_down``) give each rank a part of
    the residual update, summed over the ranks."""
    x = x + ranks.sum([_weinsum("bshk,hkd->bsd", o, p["wo"])
                       for o, p in zip(os, ps)])
    return x + ranks.sum([_mlp(rms_norm(x, p["mlp_norm"]), p, cfg)
                          for p in ps])


def _layer_params(params: dict, li: int) -> dict:
    return {n: layer(a, li) for n, a in params["blocks"].items()}


def _lm_head(x, w, cfg: T.TransformerConfig):
    """logits of ``x`` ``[..., D]`` in ``cfg.logits_storage_dtype``,
    accumulated in f32."""
    if isinstance(w, QuantizedWeight):
        spec = "bsd,dv->bsv" if x.dim() == 3 else "bd,dv->bv"
        return _weinsum(spec, x, w, f32_out=True).to(
            cfg.logits_storage_dtype)
    return T.lm_head_logits(x, w, cfg)


def _decode_block(x, ps, bufs, li, pos, cfg, rope, q_range, window,
                  ranks: spmd.ModelRanks):
    """Chunked decoder block. x: ``[B, K, D]`` at positions pos..pos+K-1;
    on each rank (its layer params in ``ps``, its kv heads of ``bufs``)
    writes the chunk's K/V into the stacked cache in place (modulo the
    capacity for a rolling cache), then attends over it."""
    cap = _ring_capacity(cfg)
    os = []
    for i, p in enumerate(ps):
        rb = _rank_bufs(bufs, i, len(ps))
        q, k, v = _project_qkv(x, p, rope)
        if cap:
            ring_pos = pos % cap if isinstance(pos, torch.Tensor) \
                else int(pos) % cap
            for n, c in _kv_writes(rb, k, v).items():
                _write_kv_chunk(rb[n], c, li, ring_pos)
            q_pos = pos if isinstance(pos, torch.Tensor) else torch.full(
                (x.shape[0],), int(pos), device=x.device)
            os.append(_ring_cached_attention(q, rb, li, q_pos,
                                             cfg.attn_window))
        else:
            fits = q_range[1] < rb["k"].shape[2]
            for n, c in _kv_writes(rb, k, v).items():
                _write_kv_chunk(rb[n], c, li, pos, fits, window)
            os.append(_cached_attention(q, rb, li, pos,
                                        cfg.attn_window or None, q_range))
    return _finish_block(x, os, ps, cfg, ranks)


def _blocks_forward(params, tokens, cache: dict, pos,
                    cfg: T.TransformerConfig, pos_range=None, window=None):
    """Run the decoder blocks over a K-token chunk at ``pos``, writing its
    K/V into the cache. Returns (block output ``[B, K, D]``, cache with
    the frontier advanced by K) — the body of :func:`extend_step`, and
    the head-free K/V write of the speculative rounds. ``params`` may be
    a :class:`ShardedParams` (every rank it runs, in turn, a layer at a
    time)."""
    sp = _ranked(params, cfg)
    b, n_q = tokens.shape
    if _ring_capacity(cfg) and n_q > 1:
        raise ValueError(
            "rolling KV cache (kv_cache_capacity) supports single-token "
            "decode steps only — chunked verify (speculative decoding) "
            "needs the linear cache")
    x = _embed(sp, tokens, cfg)
    rope = T.rope_tables(_q_positions(pos, b, n_q, tokens.device),
                         cfg.head_dim)
    if pos_range is None:
        q_range = _pos_range(pos, n_q)
    else:
        q_range = (pos_range[0], pos_range[1] + n_q - 1)
    bufs = _kv_bufs(cache)
    for li in range(cfg.n_layers):
        x = _decode_block(x, [_layer_params(p, li) for p in sp.shards],
                          bufs, li, pos, cfg, rope, q_range, window,
                          sp.ranks)
    return x, dict(bufs, length=pos + n_q)


@torch.no_grad()
def extend_step(params, tokens, cache: dict, pos,
                cfg: T.TransformerConfig, pos_range=None, window=None,
                mesh=None):
    """Extend the cache with a K-token chunk at positions pos..pos+K-1.
    tokens: ``[B, K]``; returns (logits ``[B, K, V]`` in
    ``cfg.logits_storage_dtype`` — logits[:, i] is the next-token
    distribution after tokens[:, :i+1] — and the cache). ``pos``: int or
    ``[B]`` tensor; ``pos_range``: (min, max) of ``pos`` over rows as
    host ints (read back from ``pos`` when absent); ``window`` routes
    per-row writes through the bounded-window positions. The chunked
    verify of speculative decoding; K=1 is the plain decode step. With a
    ``mesh`` (or a :class:`ShardedParams`) the step runs tensor-parallel
    on the cache of :func:`init_kv_cache` for that mesh, and returns the
    full logits."""
    sp = _ranked(params, cfg, mesh)
    x, cache = _blocks_forward(sp, tokens, cache, pos, cfg, pos_range,
                               window)
    return _head(sp, x, cfg), cache


@torch.no_grad()
def extend_rows(params, tokens, cache: dict, pos: int, lengths,
                cfg: T.TransformerConfig):
    """:func:`extend_step` of K right-padded chunks ``[K, S]`` at one
    host position ``pos``, keeping only each row's last REAL position:
    returns (logits ``[K, V]`` at positions ``lengths - 1`` of the
    chunks, ``lengths`` a ``[K]`` tensor; the cache). The head runs on
    those K rows alone, as :func:`prefill_rows`' does."""
    sp = _ranked(params, cfg)
    x, cache = _blocks_forward(sp, tokens, cache, pos, cfg)
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    return _head(sp, x, cfg, lambda h: h[rows, lengths.long() - 1]), cache


@torch.no_grad()
def decode_step(params, token, cache: dict, pos,
                cfg: T.TransformerConfig, pos_range=None, window=None,
                mesh=None):
    """One decode step. token: ``[B]``; returns (logits ``[B, V]``, the
    cache). ``pos`` is the position being written; ``mesh`` as in
    :func:`extend_step` (a step-by-step caller on a ``DeviceMesh`` lays
    the params out once with :func:`shard_params` and passes that)."""
    logits, cache = extend_step(params, token[:, None], cache, pos, cfg,
                                pos_range, window, mesh)
    return logits[:, 0], cache


def _prompt_forward(sp: ShardedParams, tokens, cfg, bufs):
    """The prompt forward shared by :func:`prefill` and
    :func:`prefill_rows`: the layer loop over ``tokens [B, s]``, writing
    K/V into ``bufs`` in place — positions [0, s), or for a rolling
    cache only the last ``min(s, capacity)`` positions, each at its ring
    row ``position % capacity`` (older ones lie outside every later
    query's window); an int8 cache quantizes at the write. Each rank
    runs attention (K1 on the card) on its query heads and kv heads.
    Returns the blocks' output ``[B, s, D]`` (before the final norm). No
    padding to kernel-friendly lengths: the CUDA kernel masks ragged
    edges itself."""
    b, s = tokens.shape
    x = _embed(sp, tokens, cfg)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    rope = T.rope_tables(positions, cfg.head_dim)
    cap = _ring_capacity(cfg)
    n = len(sp.shards)
    for li in range(cfg.n_layers):
        ps = [_layer_params(p, li) for p in sp.shards]
        os = []
        for i, p in enumerate(ps):
            q, k, v = _project_qkv(x, p, rope)
            os.append(T._attention(q, k, v, window=cfg.attn_window or None))
            rb = _rank_bufs(bufs, i, n)
            if cap:
                s0 = max(s - cap, 0)
                idx = torch.arange(s0, s, device=tokens.device) % cap
                for name, c in _kv_writes(rb, k[:, s0:], v[:, s0:]).items():
                    rb[name][li][:, idx] = c
            else:
                for name, c in _kv_writes(rb, k, v).items():
                    _write_kv_chunk(rb[name], c, li, 0)
        x = _finish_block(x, os, ps, cfg, sp.ranks)
    return x, bufs


@torch.no_grad()
def prefill(params, tokens, cfg: T.TransformerConfig, max_len: int,
            mesh=None):
    """Process the whole prompt in one forward, filling a fresh cache of
    ``max_len`` rows (the capacity, for a rolling cache). tokens: ``[B,
    S]``; returns (last-position logits ``[B, V]``, cache with frontier
    ``S``). With a ``mesh`` (or a :class:`ShardedParams`) the forward runs
    tensor-parallel and the cache holds the ranks' kv heads."""
    sp = _ranked(params, cfg, mesh)
    b, s = tokens.shape
    cache = _new_cache(cfg, b, max_len, tokens.device, sp.ranks)
    x, bufs = _prompt_forward(sp, tokens, cfg, _kv_bufs(cache))
    return _head(sp, x, cfg, lambda h: h[:, s - 1]), dict(bufs, length=s)


@torch.no_grad()
def prefill_rows(params, tokens, lengths, cfg: T.TransformerConfig,
                 mesh=None):
    """BUCKETED multi-prompt prefill: K prompts right-padded to one
    bucket length in one forward. tokens: ``[K, S_b]`` with each row's
    real prompt in its first ``lengths[k]`` positions (``lengths``: a
    ``[K]`` tensor on the tokens' device); returns (per-row last-REAL-
    position logits ``[K, V]``, a mini cache of S_b rows with per-row
    frontiers at the true lengths). Causal masking keeps every real
    position independent of the padding after it, and the padding's K/V
    lie beyond each frontier, unreachable by any later query. Rolling
    caches are rejected: a ring would wrap padding onto live rows.
    ``mesh`` as in :func:`prefill`."""
    _check_no_ring(cfg, "bucketed prefill")
    sp = _ranked(params, cfg, mesh)
    k_rows, s = tokens.shape
    cache = _new_cache(cfg, k_rows, s, tokens.device, sp.ranks)
    x, bufs = _prompt_forward(sp, tokens, cfg, _kv_bufs(cache))
    rows = torch.arange(k_rows, device=tokens.device)
    logits = _head(sp, x, cfg, lambda h: h[rows, lengths.long() - 1])
    return logits, dict(bufs, length=lengths.to(torch.int32))


def place_rows(cache: dict, mini: dict, rows, lengths) -> dict:
    """Land a K-row mini cache's buffers (k/v and an int8 cache's scales)
    into cache slots ``rows`` IN PLACE: positions [0, S_b) of every
    buffer, and the slots' frontiers set to their true ``lengths``
    (``[K]`` tensor). ``rows`` is a host sequence; entries outside [0,
    batch) are sentinels of a partial admission wave and are dropped
    (JAX's scatter drops them; torch indexing would raise, so they are
    filtered here)."""
    batch = cache["k"].shape[1]
    keep = [i for i, r in enumerate(rows) if 0 <= int(r) < batch]
    if not keep:
        return cache
    dev = cache["k"].device
    src = to_device(np.asarray(keep, np.int64), dev)
    dst = to_device(np.asarray([int(rows[i]) for i in keep], np.int64), dev)
    s_b = mini["k"].shape[2]
    for n in _kv_bufs(mini):
        cache[n][:, dst, :s_b] = mini[n][:, src]
    cache["length"][dst] = lengths.to(torch.int32)[src]
    return cache


def extract_kv_rows(mini: dict, widths) -> list[dict]:
    """Per-row HOST copies of a K-row mini cache's buffers — the
    extraction half of a disaggregated KV shipment (:func:`place_rows`
    and ``serve.land_kv_rows`` are the landing halves). Row ``i`` ships
    the first ``widths[i]`` positions of every buffer (k/v, and an int8
    cache's scales, quantized as stored): the true prompt length for a
    linear cache (the bucket padding past the frontier is unreachable),
    the whole capacity for a ring (whose positional wrap only a
    whole-slot landing keeps). Each row's buffers are packed side by
    side on the device and cross to the host in ONE copy. Returns one
    ``{name: CPU tensor [L, 1, w, KV, hd]}`` per row (a bf16 buffer
    stays ``torch.bfloat16``)."""
    bufs = _kv_bufs(mini)
    out = []
    for i, w in enumerate(widths):
        parts = {n: b[:, i:i + 1, :int(w)].contiguous()
                 for n, b in bufs.items()}
        flat = torch.cat([p.reshape(-1).view(torch.uint8)
                          for p in parts.values()]).cpu()
        row, off = {}, 0
        for n, p in parts.items():
            nbytes = p.numel() * p.element_size()
            row[n] = flat[off:off + nbytes].view(p.dtype).reshape(p.shape)
            off += nbytes
        out.append(row)
    return out


def greedy_tokens(logits) -> tuple[torch.Tensor, torch.Tensor]:
    """logits ``[B, V]`` → (argmax token ``[B]``, its model logprob
    ``[B]``), math in f32. Ties go to the first index, as in JAX."""
    lf = logits.float()
    token = lf.argmax(dim=-1)
    logp = torch.log_softmax(lf, dim=-1).gather(-1, token[:, None])[:, 0]
    return token, logp


def _filter_logits(logits, temperature: float, top_k: int,
                   top_p: float):
    """The sampling filter stack on ``[..., V]`` f32 logits, as the JAX
    package's: top-k mask (the k-th largest value is the cutoff; ties at
    it are kept) → temperature → top-p nucleus mask (keep the positions
    whose PRECEDING mass in the descending order is < ``top_p`` — the
    crossing token stays — and every logit tied with the last kept one).
    0 disables a filter. Returns unnormalized logits whose softmax is the
    sampling distribution; ``temperature`` must be > 0."""
    if top_k > 0:
        cutoff = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < cutoff, -torch.inf)
    scaled = logits / temperature
    if 0.0 < top_p < 1.0:
        desc = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        last = ((cum - probs) < top_p).sum(dim=-1, keepdim=True) - 1
        cut = torch.gather(desc, -1, last)
        scaled = scaled.masked_fill(scaled < cut, -torch.inf)
    return scaled


def _sample(logits, rng, temperature: float, top_k: int,
            top_p: float = 0.0):
    """logits ``[B, V]`` → (token ``[B]``, logprob ``[B]``), math in f32.
    Greedy at ``temperature == 0`` (``rng`` unused), else one categorical
    draw over the whole ``[B, V]`` from the single key ``rng``, as
    ``jax.random.categorical(rng, filtered)``. The logprob is the MODEL's
    log p(token), from the raw logits before any filter or temperature."""
    lf = logits.float()
    if temperature == 0.0:
        return greedy_tokens(lf)
    token = prng.categorical(rng, _filter_logits(lf, temperature, top_k,
                                                 top_p))
    logp = torch.log_softmax(lf, dim=-1).gather(-1, token[:, None])[:, 0]
    return token, logp


@torch.no_grad()
def generate(params, prompt, cfg: T.TransformerConfig,
             max_new_tokens: int, rng=None, temperature: float = 0.0,
             top_k: int = 0, top_p: float = 0.0,
             mesh=None) -> GenerateOutput:
    """Prefill + decode. prompt: ``[B, S]``. Greedy at ``temperature ==
    0``; otherwise step ``i`` samples with key ``split(rng,
    max_new_tokens)[i]`` through :func:`_sample`'s filters — the JAX
    package's stream, so the same ``rng`` (a
    :func:`~tony_tpu_torch.ops.prng.PRNGKey`) gives the same tokens.

    With a ``mesh`` (see :func:`shard_params`) it decodes
    tensor-parallel: every rank gathers the full logits and draws the
    same noise over the whole vocab, so every rank commits the same
    token and returns the full ``[B, ...]`` outputs, as the JAX package
    returns unsharded tokens from a replicated prompt."""
    if temperature != 0.0 and rng is None:
        raise ValueError("sampling (temperature > 0) needs an rng key")
    params = _ranked(params, cfg, mesh)
    b, s = prompt.shape
    logits, cache = prefill(params, prompt, cfg, s + max_new_tokens)
    keys = (prng.split(torch.as_tensor(rng).to(prompt.device),
                       max_new_tokens) if temperature != 0.0 else None)
    toks, logps = [], []
    for i in range(max_new_tokens):
        token, logp = _sample(logits, None if keys is None else keys[i],
                              temperature, top_k, top_p)
        logits, cache = decode_step(params, token, cache, cache["length"],
                                    cfg)
        toks.append(token)
        logps.append(logp)
    return GenerateOutput(
        tokens=torch.cat([prompt.long(), torch.stack(toks, dim=1)], dim=1),
        logprobs=torch.stack(logps, dim=1))


# ---------------------------------------------------------------------------
# Speculative decoding
# ---------------------------------------------------------------------------

def _check_draft_vocab(cfg, draft_cfg) -> None:
    """Speculation compares TOKEN IDS between draft and target, so the
    two models must share a vocabulary."""
    if draft_cfg.vocab_size != cfg.vocab_size:
        raise ValueError(
            f"draft vocab_size {draft_cfg.vocab_size} != target "
            f"vocab_size {cfg.vocab_size}: speculative decoding requires "
            f"a shared vocabulary (same tokenizer)")


def _shift(pos_range, i: int):
    return None if pos_range is None else (pos_range[0] + i,
                                           pos_range[1] + i)


def _propose_chunk(params, draft_params, t_cache, d_cache, pending, pos,
                   cfg, draft_cfg, k: int, win, propose, pos_range=None):
    """The draft-propose + target-verify scaffold of a speculative round:
    the draft runs ``k`` single steps following ``pending`` (``[B]``),
    ``propose(logits, i)`` picking each step's token from the draft's
    ``[B, V]`` logits and returning ``(token, aux)``; the LAST
    proposal's K/V is written through the head-free block body; then the
    target verifies the k+1-wide chunk in one :func:`extend_step`.
    ``pos`` is an int (a uniform frontier) or a ``[B]`` tensor;
    ``pos_range`` its (min, max) on the host; ``win`` routes per-row
    writes through the bounded-window positions. Returns ``(chunk [B,
    k+1], auxes, logits [B, k+1, V], t_cache, d_cache)`` with
    ``chunk[:, 0] == pending``."""
    toks, auxes = [pending], []
    tok = pending
    for i in range(k):
        logits, d_cache = decode_step(draft_params, tok, d_cache, pos + i,
                                      draft_cfg, _shift(pos_range, i), win)
        tok, aux = propose(logits, i)
        toks.append(tok)
        auxes.append(aux)
    _, d_cache = _blocks_forward(draft_params, tok[:, None], d_cache,
                                 pos + k, draft_cfg, _shift(pos_range, k),
                                 win)
    chunk = torch.stack(toks, dim=1)                            # [B, k+1]
    logits, t_cache = extend_step(params, chunk, t_cache, pos, cfg,
                                  pos_range, win)
    return chunk, auxes, logits, t_cache, d_cache


def _accepted(matches) -> torch.Tensor:
    """Per-row length of the leading run of ones of ``matches`` ``[B,
    k]`` (the accepted draft prefix): a cumulative product, summed."""
    return torch.cumprod(matches.long(), dim=1).sum(dim=1)


def _propose_and_verify(params, draft_params, t_cache, d_cache, pending,
                        pos, cfg, draft_cfg, k: int, win=None,
                        pos_range=None):
    """One GREEDY speculative round. Returns ``(chunk [B, k+1], argmaxes
    [B, k+1], acc [B], t_cache, d_cache)``: ``argmaxes`` are the target's
    greedy continuations after each chunk prefix and ``acc`` the
    per-row length of the longest draft prefix the target agreed with.
    The commit decision is the caller's."""
    chunk, _, logits, t_cache, d_cache = _propose_chunk(
        params, draft_params, t_cache, d_cache, pending, pos, cfg,
        draft_cfg, k, win, lambda lg, i: (lg.argmax(dim=-1), None),
        pos_range)
    argmaxes = logits.argmax(dim=-1)
    acc = _accepted(chunk[:, 1:] == argmaxes[:, :k])
    return chunk, argmaxes, acc, t_cache, d_cache


def _log_probs(p):
    """log of probabilities ``p`` as the JAX package's categorical over
    ``jnp.log(p)`` sees them: XLA's CPU logarithm (:func:`prng.xla_log`)
    and -inf at 0."""
    return torch.where(p > 0, prng.xla_log(p), -torch.inf)


def _propose_and_verify_sampled(params, draft_params, t_cache, d_cache,
                                pending, pos, cfg, draft_cfg, k: int, win,
                                rng, temperature: float, top_k: int,
                                top_p: float, pos_range=None):
    """One SPECULATIVE-SAMPLING round: the draft SAMPLES k tokens from its
    filtered distribution q, the target verifies the chunk once, and
    each proposal x_i is accepted with probability ``min(1,
    p_i(x_i)/q_i(x_i))`` (the test ``u * q(x) < p(x)``); the round's
    extra token is drawn from the residual ``normalize(max(p - q, 0))``
    at the first rejection, or from the bonus position's p on full
    acceptance. Both distributions run through the same filter stack.

    ``rng`` is one key ``[2]`` (a stream shared by the batch) or ``[B,
    2]`` per-row keys (the serving path). The draws follow the JAX
    package's: ``split(rng, 3)`` into draft, uniform and residual keys,
    the draft key split into k step keys. Returns ``(chunk [B, k+1],
    extra [B], acc [B], t_cache, d_cache)``."""
    b = pending.shape[0]
    rng = torch.as_tensor(rng, device=pending.device)
    per_row = rng.dim() == 2
    trip = prng.split(rng, 3)                       # [(B,) 3, 2]
    d_rng, u_rng, r_rng = trip[..., 0, :], trip[..., 1, :], trip[..., 2, :]
    d_keys = prng.split(d_rng, k)                   # [(B,) k, 2]
    vocab = cfg.vocab_size

    def propose(logits, i):
        f = _filter_logits(logits.float(), temperature, top_k, top_p)
        if per_row:
            tok = torch.argmax(prng.gumbel(d_keys[:, i], (vocab,)) + f,
                               dim=-1)
        else:
            tok = prng.categorical(d_keys[i], f)
        return tok, torch.softmax(f, dim=-1)

    chunk, qs, logits, t_cache, d_cache = _propose_chunk(
        params, draft_params, t_cache, d_cache, pending, pos, cfg,
        draft_cfg, k, win, propose, pos_range)
    p = torch.softmax(_filter_logits(logits.float(), temperature, top_k,
                                     top_p), dim=-1)         # [B, k+1, V]
    x = chunk[:, 1:].long()[..., None]                        # [B, k, 1]
    q_bkv = torch.stack(qs, dim=1)                            # [B, k, V]
    qx = q_bkv.gather(2, x)[..., 0]
    px = p[:, :k].gather(2, x)[..., 0]                        # [B, k]
    u = prng.uniform(u_rng, (k,) if per_row else (b, k))
    acc = _accepted(u * qx < px)                              # [B], 0..k
    # residual/bonus at the decision position: q rows padded with a zero
    # slab so acc == k selects the residual against 0, i.e. the bonus p
    sel = acc[:, None, None].expand(b, 1, vocab)
    p_sel = p.gather(1, sel)[:, 0]
    q_pad = torch.cat([q_bkv, torch.zeros_like(q_bkv[:, :1])], dim=1)
    q_sel = q_pad.gather(1, sel)[:, 0]
    res = torch.clamp_min(p_sel - q_sel, 0.0)
    # f32 cancellation can zero a residual that is positive in exact
    # arithmetic: fall back to p
    res = torch.where(res.sum(-1, keepdim=True) > 0, res, p_sel)
    if per_row:
        extra = torch.argmax(prng.gumbel(r_rng, (vocab,)) + _log_probs(res),
                             dim=-1)
    else:
        extra = prng.categorical(r_rng, _log_probs(res))
    return chunk, extra, acc, t_cache, d_cache


def _check_speculative(cfg, draft_cfg, num_speculative: int) -> None:
    if num_speculative < 1:
        raise ValueError("num_speculative must be >= 1 (use generate() for "
                         "plain greedy decoding)")
    _check_draft_vocab(cfg, draft_cfg)
    _check_no_ring(cfg, "speculative decoding")
    _check_no_ring(draft_cfg, "speculative decoding (draft)")


@torch.no_grad()
def speculative_generate(params: dict, draft_params: dict, prompt,
                         cfg: T.TransformerConfig,
                         draft_cfg: T.TransformerConfig,
                         max_new_tokens: int,
                         num_speculative: int = 4) -> torch.Tensor:
    """Greedy speculative decoding, host-driven, batch 1: the draft
    proposes ``num_speculative`` tokens per round, the target verifies
    the chunk in ONE :func:`extend_step` and commits the longest prefix
    matching its own argmax chain plus one corrected token — the
    target's greedy :func:`generate` tokens wherever chunked and
    single-step logits agree. Each round reads the acceptance back to
    the host. Returns tokens ``[1, prompt_len + max_new_tokens]``."""
    b, s = prompt.shape
    if b != 1:
        raise ValueError("speculative_generate supports batch size 1")
    _check_speculative(cfg, draft_cfg, num_speculative)
    k = num_speculative
    max_len = s + max_new_tokens + k + 1
    t_logits, t_cache = prefill(params, prompt, cfg, max_len)
    _, d_cache = prefill(draft_params, prompt, draft_cfg, max_len)
    dev = prompt.device

    out: list[int] = []
    # pending = committed token whose K/V is not yet in the target cache
    pending = int(t_logits.argmax(dim=-1)[0])
    pos = s
    while len(out) < max_new_tokens:
        drafts = []
        tok = torch.tensor([pending], device=dev)
        for i in range(k):
            d_logits, d_cache = decode_step(draft_params, tok, d_cache,
                                            pos + i, draft_cfg)
            tok = d_logits.argmax(dim=-1)
            drafts.append(int(tok[0]))
        chunk = torch.tensor([[pending] + drafts], device=dev)
        logits, t_cache = extend_step(params, chunk, t_cache, pos, cfg)
        argmaxes = logits[0].argmax(dim=-1).tolist()      # [k+1]
        out.append(pending)
        accepted = 0
        for i in range(k):
            if len(out) >= max_new_tokens or drafts[i] != argmaxes[i]:
                break
            out.append(drafts[i])
            accepted += 1
        if accepted == k:
            # full acceptance: the draft never wrote d_k's K/V (it
            # produced d_k as output only); backfill it
            _, d_cache = decode_step(draft_params,
                                     torch.tensor([drafts[-1]], device=dev),
                                     d_cache, pos + k, draft_cfg)
        # roll both caches back to the committed frontier: the next
        # round's k+1-wide chunk rewrites every stale entry before any
        # query can reach it
        pending = argmaxes[accepted]
        pos += 1 + accepted
        t_cache["length"] = pos
        d_cache["length"] = pos
    tokens = torch.tensor([out[:max_new_tokens]], device=dev)
    return torch.cat([prompt.long(), tokens], dim=1)


_INT_MAX = torch.iinfo(torch.int64).max


@torch.no_grad()
def speculative_generate_device(params: dict, draft_params: dict, prompt,
                                cfg: T.TransformerConfig,
                                draft_cfg: T.TransformerConfig,
                                max_new_tokens: int,
                                num_speculative: int = 4,
                                commit: str = "window", window: int = 0,
                                temperature: float = 0.0, top_k: int = 0,
                                top_p: float = 0.0, rng=None,
                                return_rounds: bool = False):
    """Speculative decoding at any batch size — greedy (the target's
    greedy tokens wherever chunked and single-step logits agree) by
    default, rejection-SAMPLED (distributed as target-only sampling
    through the same filter stack, for any draft) at ``temperature >
    0`` with ``rng`` a :func:`~tony_tpu_torch.ops.prng.PRNGKey`.

    The JAX package runs the rounds in a ``lax.while_loop``; here they
    are a Python loop whose accept and commit arithmetic stays on the
    device, with one host read per round (the stop test, and the
    frontiers' range that bounds the blockwise walk).

    Per-row frontiers: each row commits its OWN ``acc + 1`` tokens per
    round, clamped so a row that reaches ``max_new_tokens`` freezes.
    ``commit="per_row"`` writes each row's K/V at its own frontier;
    ``"window"`` (the default) keeps rows within ``window - (k+1)``
    positions of the slowest active row, so each round's writes land in
    one ``window``-wide slice (default ``4*(k+1)``; at least ``k+2``);
    ``"min"`` commits the batch minimum. A frozen row in window mode is
    fed a surrogate position clipped into the active window: its writes
    land in its own dead rows. ``return_rounds`` also returns the number
    of rounds run. Returns tokens ``[B, prompt_len + max_new_tokens]``."""
    b, s = prompt.shape
    k = num_speculative
    if k < 1:
        raise ValueError("num_speculative must be >= 1")
    if commit not in ("per_row", "min", "window"):
        raise ValueError(f"unknown commit policy {commit!r}")
    if temperature > 0.0 and rng is None:
        raise ValueError("speculative sampling (temperature > 0) "
                         "requires an rng key")
    _check_speculative(cfg, draft_cfg, k)
    if commit == "window":
        window = window or 4 * (k + 1)
        if window < k + 2:
            raise ValueError(f"window must be >= num_speculative + 2 "
                             f"(chunk width k+1 plus >= 1 slack), got "
                             f"{window}")
    if commit == "window" and b > 1:
        # the target-chunk write's base (the slowest active row) never
        # clamps; the draft writes' base (+i <= +k) clamps by at most k-1
        # rows, which keeps every K=1 offset inside the window
        max_len = s + max_new_tokens + window
    else:
        max_len = s + max_new_tokens + k + 2
    slack = window - (k + 1)
    t_logits, t_cache = prefill(params, prompt, cfg, max_len)
    _, d_cache = prefill(draft_params, prompt, draft_cfg, max_len)
    dev = prompt.device
    t_cache["length"] = torch.full((b,), s, dtype=torch.int32, device=dev)
    d_cache["length"] = torch.full((b,), s, dtype=torch.int32, device=dev)

    # new tokens land here; k+1 slack for the final round's overshoot
    buf = torch.zeros((b, max_new_tokens + k + 1), dtype=torch.long,
                      device=dev)
    if temperature > 0.0:
        rng, p0_rng = prng.split(torch.as_tensor(rng).to(dev), 2)
        pending = prng.categorical(p0_rng, _filter_logits(
            t_logits.float(), temperature, top_k, top_p))
    else:
        pending = t_logits.argmax(dim=-1)
    # bounded-window writes only for genuinely per-row positions
    win = window if (commit == "window" and b > 1) else None
    n_gen = torch.zeros((b,), dtype=torch.long, device=dev)
    pos = torch.full((b,), s, dtype=torch.long, device=dev)
    rows = torch.arange(b, device=dev)[:, None]
    rounds = 0
    while True:
        host = torch.stack([n_gen, pos]).cpu()          # the round's sync
        if int(host[0].min()) >= max_new_tokens:
            break
        pos_range = (int(host[1].min()), int(host[1].max()))
        if temperature > 0.0:
            rng, round_rng = prng.split(rng, 2)
        active = n_gen < max_new_tokens
        if win is not None:
            amin = torch.where(active, pos, _INT_MAX).min()
            pos_fed = torch.where(active, pos,
                                  torch.clamp(pos, amin, amin + slack))
        else:
            pos_fed = pos
        # at batch 1 the scalar frontier takes the contiguous writes
        pos_arg = pos_range[0] if b == 1 else pos_fed
        if temperature > 0.0:
            chunk, extra, acc, t_cache, d_cache = (
                _propose_and_verify_sampled(
                    params, draft_params, t_cache, d_cache, pending,
                    pos_arg, cfg, draft_cfg, k, win, round_rng,
                    temperature, top_k, top_p, pos_range))
        else:
            chunk, argmaxes, acc, t_cache, d_cache = _propose_and_verify(
                params, draft_params, t_cache, d_cache, pending, pos_arg,
                cfg, draft_cfg, k, win, pos_range)
        committed = acc.min() if commit == "min" else acc
        count = torch.minimum(committed + 1, max_new_tokens - n_gen)
        if win is not None:
            # no row ends the round more than `slack` past the slowest
            # still-active row; the slowest is never clamped, so every
            # active row still advances
            amin_next = torch.where(active, pos + count, _INT_MAX).min()
            count = torch.clamp_min(
                torch.minimum(count, amin_next + slack - pos), 0)
        buf[rows, n_gen[:, None] + torch.arange(k + 1, device=dev)] = chunk
        if temperature > 0.0:
            # committed in full: the residual/bonus sample continues the
            # stream; clamped below acc+1: the accepted draft token at
            # the cut is itself a faithful sample there
            cont = chunk.gather(1, torch.clamp(count, 0, k)[:, None])[:, 0]
            new_pending = torch.where(
                count > 0, torch.where(count == acc + 1, extra, cont),
                pending)
        else:
            sel = torch.clamp(count - 1, 0, k)
            corr = argmaxes.gather(1, sel[:, None])[:, 0]
            new_pending = torch.where(count > 0, corr, pending)
        pending = new_pending
        n_gen = n_gen + count
        pos = pos + count
        # rollback: stale entries past each row's frontier are rewritten
        # by the next round's chunk before any query reaches them
        t_cache["length"] = pos.to(torch.int32)
        d_cache["length"] = pos.to(torch.int32)
        rounds += 1
    tokens = torch.cat([prompt.long(), buf[:, :max_new_tokens]], dim=1)
    return (tokens, rounds) if return_rounds else tokens


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------

@torch.no_grad()
def beam_search(params, prompt, cfg: T.TransformerConfig,
                max_new_tokens: int, beam_width: int = 4,
                length_penalty: float = 0.0,
                eos_id: int | None = None, mesh=None) -> BeamSearchOutput:
    """KV-cache beam search: keep the ``beam_width`` highest-logprob
    continuations per prompt, expanding all beams in one batched decode
    step per token. The prompt prefills once per row and its cache tiles
    across beams; each step feeds every beam's last token, takes the top
    W of the ``[B, W·V]`` successor scores and GATHERS the cache along
    the beam axis by parent index. Finished beams (``eos``) reproduce
    themselves with frozen scores. Beams come back sorted by ``score /
    length**length_penalty``, best first, with the RAW logprob sums in
    ``scores`` and per-beam generated lengths (eos included) in
    ``lengths``; tokens after a beam's eos repeat the eos. With a
    ``mesh`` (see :func:`shard_params`) the steps run tensor-parallel and
    each rank gathers its own cache (its kv heads) by parent index."""
    b, s = prompt.shape
    w = beam_width
    if w < 1:
        raise ValueError("beam_width must be >= 1")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    _check_no_ring(cfg, "beam search")
    params = _ranked(params, cfg, mesh)
    v = cfg.vocab_size
    dev = prompt.device
    logits, cache = prefill(params, prompt, cfg, s + max_new_tokens)
    # tile across beams: [L, B, ...] -> [L, B*W, ...] (every buffer)
    cache = dict({n: x.repeat_interleave(w, dim=1)
                  for n, x in _kv_bufs(cache).items()},
                 length=cache["length"])
    logp0 = torch.log_softmax(logits.float(), dim=-1)
    scores, first = torch.topk(logp0, w, dim=-1)              # [B, W]
    alive = (torch.ones((b, w), dtype=torch.bool, device=dev)
             if eos_id is None else first != eos_id)
    tok_buf = torch.zeros((b, w, max_new_tokens), dtype=torch.long,
                          device=dev)
    tok_buf[:, :, 0] = first
    lens = torch.ones((b, w), dtype=torch.long, device=dev)
    last = first
    if eos_id is not None:
        # finished beams emit ONLY eos at no score cost
        eos_only = torch.full((v,), -torch.inf, device=dev)
        eos_only[eos_id] = 0.0
    for i in range(1, max_new_tokens):
        logits, cache = decode_step(params, last.reshape(b * w), cache,
                                    cache["length"], cfg)
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(b, w, v)
        if eos_id is not None:
            logp = torch.where(alive[..., None], logp, eos_only)
        cand = scores[..., None] + logp                       # [B, W, V]
        scores, idx = torch.topk(cand.reshape(b, w * v), w, dim=-1)
        parent = idx // v                                     # [B, W]
        token = idx % v
        gidx = (torch.arange(b, device=dev)[:, None] * w
                + parent).reshape(-1)
        cache = dict({n: x[:, gidx] for n, x in _kv_bufs(cache).items()},
                     length=cache["length"])
        alive = alive.gather(1, parent)
        lens = lens.gather(1, parent)
        tok_buf = tok_buf.gather(1, parent[..., None].expand(b, w,
                                                             max_new_tokens))
        tok_buf[:, :, i] = token
        lens = torch.where(alive, lens + 1, lens)
        if eos_id is not None:
            alive = alive & (token != eos_id)
        last = token
    key = scores if length_penalty == 0.0 else (
        scores / lens.float() ** length_penalty)
    order = torch.argsort(-key, dim=1, stable=True)
    scores = scores.gather(1, order)
    lens = lens.gather(1, order)
    tok_buf = tok_buf.gather(1, order[..., None].expand(b, w,
                                                        max_new_tokens))
    prompts = prompt.long()[:, None].expand(b, w, s)
    return BeamSearchOutput(tokens=torch.cat([prompts, tok_buf], dim=2),
                            scores=scores, lengths=lens)
