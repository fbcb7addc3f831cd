"""Autoregressive decoding with a KV cache for the flagship transformer.

Port of ``tony_tpu/models/decode.py`` for the linear, model-dtype cache,
greedy decoding and sampling (top-k → temperature → nucleus, drawn from
the JAX package's threefry streams through
:mod:`tony_tpu_torch.ops.prng`, so a seed gives JAX's tokens). The
layouts are the JAX package's: the cache is a
``[L, B, max_len, KV, hd]`` buffer pair, prefill runs the whole prompt
through the model (attention through the CUDA flash kernel on the card)
and writes its K/V, and each decode step attends its query positions
over the cache.

Where the JAX package donated buffers to a jitted program, the port
writes the cache IN PLACE (:func:`_write_kv_chunk`, :func:`place_rows`),
so a decode step never copies the cache.

Frontiers: ``cache["length"]`` is a Python int when every row sits at
the same position (:func:`prefill`, :func:`generate`) and a ``[B]`` int32
tensor when rows sit at their own positions (:func:`prefill_rows`, the
serving batcher). The length-aware blockwise walk over large caches
needs the highest query position to bound its loop; the JAX package
traced it on the device, the port takes it from the caller's host-side
bookkeeping (``pos_range``) so a serving step never waits on the card.

Not ported yet (they raise ``NotImplementedError``): int8 KV caches and
int8 weights, rolling caches, MoE, speculative decoding and beam search.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tony_tpu_torch import resolve_device
from tony_tpu_torch.models import transformer as T
from tony_tpu_torch.ops import prng
from tony_tpu_torch.ops.norms import rms_norm


class GenerateOutput(NamedTuple):
    tokens: torch.Tensor     # [B, prompt_len + max_new_tokens]
    logprobs: torch.Tensor   # [B, max_new_tokens] logprob of each token


# Length-aware decode attention: caches at or above this many positions
# take the block-wise path whose cost follows the LIVE length; below it
# the dense path is cheaper and matches the training forward exactly.
DECODE_BLOCK = 256
_BLOCKWISE_MIN_LEN = 2 * DECODE_BLOCK

#: cache keys that hold per-position buffers ("length" is the frontier)
_KV_BUFS = ("k", "v")


def to_device(a, device) -> torch.Tensor:
    """Host array → tensor on ``device``. To the card it goes through
    pinned memory without blocking: a pageable copy would wait for every
    kernel already queued, which would stall the serving pipeline."""
    t = torch.as_tensor(np.asarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _check_cache_cfg(cfg: T.TransformerConfig) -> None:
    T._check_dense(cfg)
    if cfg.kv_quant:
        raise NotImplementedError("int8 KV caches are not ported yet")
    if cfg.kv_cache_capacity:
        raise NotImplementedError("rolling KV caches are not ported yet")


def init_kv_cache(cfg: T.TransformerConfig, batch: int, max_len: int,
                  device=None) -> dict:
    """Zeroed cache: k/v of shape ``[L, B, max_len, KV, hd]`` in
    ``cfg.dtype`` on ``device`` (the card unless the caller passes
    ``"cpu"``), frontier 0."""
    _check_cache_cfg(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "length": 0}


def _kv_bufs(cache: dict) -> dict:
    return {n: cache[n] for n in _KV_BUFS if n in cache}


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


def _cached_attention_blockwise(q, bufs, li, q_start, q_range,
                                block: int = DECODE_BLOCK,
                                attn_window: int | None = None):
    """Online-softmax cached attention over the ACTIVE cache blocks only:
    blocks ``lo .. n_active-1`` where ``n_active = (max_qpos + block) //
    block`` (capped at the cache's block count — blocks past the end are
    fully masked and change nothing) and ``lo`` is the window's first
    block. ``q_range`` carries (min, max) query position from the host.
    Same contract as the dense path; numerics are flash-style, so logits
    agree with it to flash tolerance, not bitwise. A trailing partial
    block re-reads from ``max_len - block`` and masks the re-read rows."""
    k_all, v_all = bufs["k"], bufs["v"]
    b, n_q, h, d = q.shape
    max_len, kv = k_all.shape[2], k_all.shape[3]
    group = h // kv
    scale = d ** -0.5
    q_pos = _q_positions(q_start, b, n_q, q.device)           # [B, Q]
    lo_pos, hi_pos = q_range
    n_active = min((hi_pos + block) // block, -(-max_len // block))
    lo = (max(lo_pos - attn_window + 1, 0) // block
          if attn_window is not None else 0)
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
        s = s.masked_fill(~mask[:, None, None], -torch.inf)
        new_m = torch.maximum(m, s.amax(dim=-1))
        # all-masked (query, block) pairs keep m = -inf; subtract 0 there
        safe_m = torch.where(torch.isneginf(new_m), 0.0, new_m)
        alpha = torch.exp(m - safe_m)
        p = torch.exp(s - safe_m[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(vb.dtype).float(),
                          vb.float())
        acc = acc * alpha[..., None] + pv
        m = new_m
    o = acc / l[..., None]          # l > 0: every query attends itself
    o = o.permute(0, 3, 1, 2, 4).reshape(b, n_q, h, d)
    return o.to(q.dtype)


def _cached_attention(q, bufs, li, q_start, attn_window=None,
                      q_range=None):
    """q: ``[B, K, H, hd]`` at positions q_start..q_start+K-1; ``bufs``:
    the stacked ``[L, B, max_len, KV, hd]`` k/v buffers, ``li`` this
    layer. Query i attends cache positions <= q_start+i (and within the
    window). GQA queries read their shared K/V head unexpanded. Scores,
    softmax and the value product accumulate in f32 from cache-dtype
    operands. Caches of ``_BLOCKWISE_MIN_LEN`` positions or more take the
    length-aware blockwise path."""
    b, n_q, h, d = q.shape
    max_len = bufs["k"].shape[2]
    if max_len >= _BLOCKWISE_MIN_LEN:
        if q_range is None:
            q_range = _pos_range(q_start, n_q)
        return _cached_attention_blockwise(q, bufs, li, q_start, q_range,
                                           attn_window=attn_window)
    k_cache, v_cache = bufs["k"][li], bufs["v"][li]
    kv = k_cache.shape[2]
    group = h // kv
    q_pos = _q_positions(q_start, b, n_q, q.device)           # [B, Q]
    k_pos = torch.arange(max_len, device=q.device)
    mask = k_pos[None, None, :] <= q_pos[:, :, None]          # [B, Q, S]
    if attn_window is not None:
        mask = mask & (q_pos[:, :, None] - k_pos[None, None, :]
                       < attn_window)
    qg = q.reshape(b, n_q, kv, group, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                          k_cache.float()) * (d ** -0.5)
    scores = scores.masked_fill(~mask[:, None, None], -torch.inf)
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(b, n_q, h, d).to(q.dtype)


def _write_kv_chunk(buf, chunk, li, pos, fits: bool = True) -> None:
    """Write a K-token chunk ``[B, K, KV, d]`` into the stacked buffer
    ``[L, B, max_len, KV, d]`` at layer ``li`` IN PLACE (the JAX package
    donated the buffer). ``pos``: an int (one contiguous slice) or a
    ``[B]`` tensor (per-row positions). Per-row positions past the cache
    end are dropped, as JAX's scatter drops them — only finished rows
    still decoding garbage reach there; ``fits`` (from the caller's host
    bookkeeping) says none can, which skips that masking."""
    n_k = chunk.shape[1]
    if not (isinstance(pos, torch.Tensor) and pos.dim() == 1):
        p = int(pos)
        buf[li, :, p:p + n_k] = chunk
        return
    max_len = buf.shape[2]
    b_idx = torch.arange(chunk.shape[0], device=buf.device)[:, None]
    s_idx = pos.long()[:, None] + torch.arange(n_k, device=buf.device)
    if not fits:
        # a dropped write rewrites the value already there; only garbage
        # rows straddle the end, so a clamped duplicate hits only them
        valid = (s_idx < max_len)[..., None, None]
        s_idx = s_idx.clamp(max=max_len - 1)
        chunk = torch.where(valid, chunk, buf[li, b_idx, s_idx])
    buf[li, b_idx, s_idx] = chunk


def _decode_block(x, p, bufs, li, pos, cfg, rope, q_range):
    """Chunked decoder block. x: ``[B, K, D]`` at positions pos..pos+K-1;
    writes the chunk's K/V into the stacked cache in place, then attends
    over it."""
    q, k, v = T._project_qkv(x, p, rope)
    fits = q_range[1] < bufs["k"].shape[2]
    _write_kv_chunk(bufs["k"], k, li, pos, fits)
    _write_kv_chunk(bufs["v"], v, li, pos, fits)
    o = _cached_attention(q, bufs, li, pos, cfg.attn_window or None,
                          q_range)
    return T._finish_block(x, o, p)


def _blocks_forward(params: dict, tokens, cache: dict, pos,
                    cfg: T.TransformerConfig, pos_range=None):
    """Run the decoder blocks over a K-token chunk at ``pos``, writing its
    K/V into the cache. Returns (block output ``[B, K, D]``, cache with
    the frontier advanced by K)."""
    _check_cache_cfg(cfg)
    b, n_q = tokens.shape
    x = params["embed"][tokens.long()].to(cfg.dtype)
    rope = T.rope_tables(_q_positions(pos, b, n_q, tokens.device),
                         cfg.head_dim)
    if pos_range is None:
        q_range = _pos_range(pos, n_q)
    else:
        q_range = (pos_range[0], pos_range[1] + n_q - 1)
    bufs = _kv_bufs(cache)
    for li in range(cfg.n_layers):
        x = _decode_block(x, T.layer_params(params, li), bufs, li, pos, cfg,
                          rope, q_range)
    return x, dict(bufs, length=pos + n_q)


@torch.no_grad()
def extend_step(params: dict, tokens, cache: dict, pos,
                cfg: T.TransformerConfig, pos_range=None):
    """Extend the cache with a K-token chunk at positions pos..pos+K-1.
    tokens: ``[B, K]``; returns (logits ``[B, K, V]`` in
    ``cfg.logits_storage_dtype``, the cache). ``pos``: int or ``[B]``
    tensor; ``pos_range``: (min, max) of ``pos`` over rows as host ints
    (read back from ``pos`` when absent)."""
    x, cache = _blocks_forward(params, tokens, cache, pos, cfg, pos_range)
    x = rms_norm(x, params["final_norm"])
    return T.lm_head_logits(x, params["lm_head"], cfg), cache


@torch.no_grad()
def decode_step(params: dict, token, cache: dict, pos,
                cfg: T.TransformerConfig, pos_range=None):
    """One decode step. token: ``[B]``; returns (logits ``[B, V]``, the
    cache). ``pos`` is the position being written."""
    logits, cache = extend_step(params, token[:, None], cache, pos, cfg,
                                pos_range)
    return logits[:, 0], cache


def _prompt_forward(params, tokens, cfg, bufs):
    """The prompt forward shared by :func:`prefill` and
    :func:`prefill_rows`: the layer loop over ``tokens [B, s]``, writing
    positions [0, s) of K/V into ``bufs`` in place; returns the final-
    norm'd activations ``[B, s, D]``. No padding to kernel-friendly
    lengths: the CUDA kernel masks ragged edges itself."""
    b, s = tokens.shape
    x = params["embed"][tokens.long()].to(cfg.dtype)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    rope = T.rope_tables(positions, cfg.head_dim)
    for li in range(cfg.n_layers):
        p = T.layer_params(params, li)
        q, k, v = T._project_qkv(x, p, rope)
        o = T._attention(q, k, v, window=cfg.attn_window or None)
        x = T._finish_block(x, o, p)
        _write_kv_chunk(bufs["k"], k, li, 0)
        _write_kv_chunk(bufs["v"], v, li, 0)
    return rms_norm(x, params["final_norm"]), bufs


@torch.no_grad()
def prefill(params: dict, tokens, cfg: T.TransformerConfig, max_len: int):
    """Process the whole prompt in one forward, filling a fresh cache of
    ``max_len`` rows. tokens: ``[B, S]``; returns (last-position logits
    ``[B, V]``, cache with frontier ``S``)."""
    b, s = tokens.shape
    cache = init_kv_cache(cfg, b, max_len, device=tokens.device)
    x, bufs = _prompt_forward(params, tokens, cfg, _kv_bufs(cache))
    logits = T.lm_head_logits(x[:, s - 1], params["lm_head"], cfg)
    return logits, dict(bufs, length=s)


@torch.no_grad()
def prefill_rows(params: dict, tokens, lengths, cfg: T.TransformerConfig):
    """BUCKETED multi-prompt prefill: K prompts right-padded to one
    bucket length in one forward. tokens: ``[K, S_b]`` with each row's
    real prompt in its first ``lengths[k]`` positions (``lengths``: a
    ``[K]`` tensor on the tokens' device); returns (per-row last-REAL-
    position logits ``[K, V]``, a mini cache of S_b rows with per-row
    frontiers at the true lengths). Causal masking keeps every real
    position independent of the padding after it, and the padding's K/V
    lie beyond each frontier, unreachable by any later query."""
    k_rows, s = tokens.shape
    cache = init_kv_cache(cfg, k_rows, s, device=tokens.device)
    x, bufs = _prompt_forward(params, tokens, cfg, _kv_bufs(cache))
    rows = torch.arange(k_rows, device=tokens.device)
    xl = x[rows, lengths.long() - 1]                          # [K, D]
    logits = T.lm_head_logits(xl, params["lm_head"], cfg)
    return logits, dict(bufs, length=lengths.to(torch.int32))


def place_rows(cache: dict, mini: dict, rows, lengths) -> dict:
    """Land a K-row mini cache's K/V into cache slots ``rows`` IN PLACE:
    positions [0, S_b) of every buffer, and the slots' frontiers set to
    their true ``lengths`` (``[K]`` tensor). ``rows`` is a host sequence;
    entries outside [0, batch) are sentinels of a partial admission wave
    and are dropped (JAX's scatter drops them; torch indexing would raise,
    so they are filtered here)."""
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
def generate(params: dict, prompt, cfg: T.TransformerConfig,
             max_new_tokens: int, rng=None, temperature: float = 0.0,
             top_k: int = 0, top_p: float = 0.0) -> GenerateOutput:
    """Prefill + decode. prompt: ``[B, S]``. Greedy at ``temperature ==
    0``; otherwise step ``i`` samples with key ``split(rng,
    max_new_tokens)[i]`` through :func:`_sample`'s filters — the JAX
    package's stream, so the same ``rng`` (a
    :func:`~tony_tpu_torch.ops.prng.PRNGKey`) gives the same tokens."""
    if temperature != 0.0 and rng is None:
        raise ValueError("sampling (temperature > 0) needs an rng key")
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
