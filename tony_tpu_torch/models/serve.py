"""Continuous batching for the serving path, in PyTorch.

Port of ``tony_tpu/models/serve.py``. A fixed batch of cache slots
decodes together; a row retires the chunk it completes and the next
queued request is admitted into its slot while the other rows keep
decoding. The device programs:

- :func:`admit_rows` — BUCKETED, BATCHED admission: K prompts padded to
  one power-of-two length bucket prefill in one forward (attention
  through the CUDA flash kernel on the card) and land in their slots;
- :func:`admit_row` — the single-slot admission (the
  ``bucketed_admission=False`` arm), padded to the same buckets; rolling
  (ring) caches, whose wrapped writes cannot take padded prompts, admit
  at the exact length through :func:`admit_row_ring`;
- :func:`step_rows` — ``n`` decode steps of every row at its own
  frontier, greedy or sampled from PER-REQUEST key streams;
- :func:`retire_rows` — zero freed rows' frontiers.

Slot reuse is safe for the JAX package's reason: a row's queries attend
positions ``<= pos_r`` only, and a new occupant rewrites [0, S_prompt)
at admission and writes each position before reading it, so stale K/V
beyond the frontier (a previous occupant's, or bucket padding) is never
reached.

:class:`ContinuousBatcher` drives those programs from the host and
:class:`ServeEngine` is its open-loop issue/fetch/consume/settle cycle
against a live admission queue, PIPELINED by default: chunk N+1 is
enqueued on the card before chunk N's tokens are copied back, so host
bookkeeping overlaps device work. PyTorch runs eagerly, so "issue"
enqueues the chunk's kernels and returns without waiting; only
``_fetch`` copies tokens to the host. The batcher keeps a host mirror of
every row's frontier, which bounds the blockwise cache walk without
reading the card.

Sampling uses the JAX package's per-request streams, bit for bit
(:mod:`tony_tpu_torch.ops.prng`): request ``q``'s draw at its ``t``-th
generated token comes from ``fold_in(fold_in(PRNGKey(seed), q), t)``, so
a request's samples depend on the seed, its index and its prompt alone —
not on admission timing or what shares the batch — and the pipelined and
sequential loops and any slot count give the same tokens. A preempted
request resumes at its stream offset, so it gives the same tokens too
where the re-prefill of its history computes what its decode steps did
(f32); in bf16 that arithmetic differs and the stream may depart after
the resume point. A chunk's Gumbel noise for every row and step
is drawn in one batch before its steps run (it does not depend on the
logits); each step then filters (top-k → temperature → nucleus) and
takes the argmax of noise plus filtered logits.

:class:`ServeEngine` carries the JAX engine's QoS: three request classes
(``interactive`` / ``standard`` / ``batch``) with a queue each and
per-class slot floors, interactive-over-batch row preemption with a
resume at the preempted stream's offset, and an explicit overload shed
(:class:`EngineBusy` past ``max_queue_depth``).

:class:`SpeculativeContinuousBatcher` composes continuous batching with
speculative decoding: every slot runs draft-propose / target-verify
rounds at its own frontier (:func:`spec_step_rows`, on the rounds of
:mod:`~tony_tpu_torch.models.decode`), admission prefills both models'
caches (:func:`spec_admit_rows`), and each request's tokens are the
target's greedy tokens, or in sampled mode the JAX batcher's, from the
same per-request streams (the admission seed draw takes stream position
0, round ``r`` position ``1 + r``).

Every batcher takes an int8 weight snapshot, an int8 KV cache and (the
greedy and sampled one) a rolling cache, from the params and the config.

Shared prefixes: a prefix every request continues from (a system
prompt) prefills ONCE into a K/V template (:func:`prefix_template`);
admission copies it into the slot and runs only the request's suffix
through the model — :func:`prefix_admit_rows`, a chunked extend against
the copied history on the cached attention (the blockwise walk from 512
rows up), token-identical to serving prefix + suffix in full wherever
the two attention paths' f32 sums agree. Templates live in a resident
store (:meth:`ContinuousBatcher.install_prefix`), land from a peer's
shipped blob with zero prefix forwards, and pack for shipping
(:meth:`ContinuousBatcher.export_prefix_blob`); the serving host's
prefix lane moves them between replicas.

Disaggregated serving splits the two device workloads across a prefill
tier and a decode tier: the prefill tier runs :func:`prefill_ship_rows`
(the same program and row count as colocated admission) and ships each
row's K/V, last-real logits and rng stream state as a
:class:`KVPackage` (``serving/kvship.py`` is the wire codec,
``serving/disagg.py`` the servers); the decode tier's engine adopts it
through :meth:`ServeEngine.submit_prefilled` and lands it with
:func:`land_kv_rows` — host-to-device copies of the real rows, no model
forward — inside its own admission sweep, on the thread and stream that
own the cache.

The engine's driving thread feeds the process's goodput ledger
(``runtime/goodput.py``): its wall is ``step`` (producing tokens) but
for its blocks on the admission condition, which are ``idle``.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Sequence

import numpy as np
import torch

from tony_tpu_torch.models import transformer as T
from tony_tpu_torch.models.decode import (_check_draft_vocab, _check_no_ring,
                                          _filter_logits, _kv_bufs,
                                          _propose_and_verify,
                                          _propose_and_verify_sampled,
                                          decode_step, extend_rows,
                                          init_kv_cache, place_rows,
                                          prefill, prefill_rows,
                                          to_device)
from tony_tpu_torch.models.weights import params_from_numpy
from tony_tpu_torch.ops import prng
from tony_tpu_torch.runtime import goodput as goodput_mod
from tony_tpu_torch.runtime import metrics as metrics_mod
from tony_tpu_torch.runtime import tracing
from tony_tpu_torch.runtime.profiler import PhaseTimes

#: Per-call program counters keyed by (program name, shape): one entry
#: per CALL of a device program (eager torch has no trace to count).
CALL_COUNTS: collections.Counter = collections.Counter()

#: smallest bucketed-admission pad length
_MIN_ADMIT_BUCKET = 16

#: rng-stream id for rows with no occupant (their draws are garbage the
#: host discards; any fixed stream works)
_IDLE_STREAM = 0x7FFFFFFF

#: the QoS classes, best SLO first (``serving.protocol.QOS_CLASSES``)
QOS_CLASSES = ("interactive", "standard", "batch")


def _count_call(name: str, shape) -> None:
    CALL_COUNTS[(name, tuple(shape))] += 1


def bucket_for(n: int, cap: int,
               ladder: Sequence[int] | None = None) -> int:
    """Padded admission length for an ``n``-token prompt: the smallest
    power-of-two (or custom ``ladder``) bucket >= n, clamped to ``cap``
    (the cache's admissible length)."""
    if ladder is not None:
        for b in ladder:
            if b >= n:
                return min(b, cap)
        return cap
    b = _MIN_ADMIT_BUCKET
    while b < n:
        b <<= 1
    return min(b, cap)


def _scatter_rows(dst, rows, values) -> None:
    """``dst[rows[i]] = values[i]`` in place for the in-range rows (the
    sentinel rows of a partial wave are dropped)."""
    batch = dst.shape[0]
    keep = [i for i, r in enumerate(rows) if 0 <= int(r) < batch]
    if keep:
        src = to_device(np.asarray(keep, np.int64), dst.device)
        idx = to_device(np.asarray([int(rows[i]) for i in keep], np.int64),
                        dst.device)
        dst[idx] = values[src].to(dst.dtype)


def _place_prefill(cache, mini, row: int, s_p: int) -> None:
    """Land a batch-1 prefill's buffers (k/v and an int8 cache's scales)
    into cache slot ``row`` in place and set its frontier to ``s_p``."""
    for n in _kv_bufs(mini):
        cache[n][:, row:row + 1, :mini[n].shape[2]] = mini[n]
    cache["length"][row] = s_p


@torch.no_grad()
def admit_row(params, cache, logits, row: int, prompt, length: int, cfg):
    """Admit ONE request into cache slot ``row``: prompt ``[1, S_b]``
    right-padded to a :func:`bucket_for` rung, ``length`` its true
    length. Cache and logits are updated in place and returned."""
    _count_call("admit_row", prompt.shape)
    lengths = torch.full((1,), int(length), dtype=torch.int32,
                         device=prompt.device)
    lg, mini = prefill_rows(params, prompt, lengths, cfg)
    place_rows(cache, mini, [row], lengths)
    logits[row] = lg[0].to(logits.dtype)
    return cache, logits


@torch.no_grad()
def admit_row_ring(params, cache, logits, row: int, prompt, cfg):
    """Admit a request into cache slot ``row`` of a rolling (ring) cache
    at its EXACT length: padding at position p would land on ring row
    ``p % capacity``, clobbering real history. prompt: ``[1, S_p]``; a
    prompt longer than the capacity keeps its last ``capacity`` rows.
    Cache and logits are updated in place and returned."""
    _count_call("admit_row_ring", prompt.shape)
    lg, mini = prefill(params, prompt, cfg, max_len=prompt.shape[1])
    _place_prefill(cache, mini, row, prompt.shape[1])
    logits[row] = lg[0].to(logits.dtype)
    return cache, logits


@torch.no_grad()
def admit_rows(params, cache, logits, rows, prompts, lengths, cfg):
    """BUCKETED, BATCHED admission: land K prompts (one length bucket)
    into their cache slots with one prefill forward. prompts: ``[K,
    S_bucket]`` right-padded; lengths: ``[K]`` true lengths (tensor);
    rows: host sequence of K target slots, unused entries set to
    out-of-range sentinels (dropped). Each slot's K/V land in place, its
    frontier is set, and its next-step logits seed from its true last
    prompt position. Returns (cache, logits), updated in place."""
    _count_call("admit_rows", prompts.shape)
    lg, mini = prefill_rows(params, prompts, lengths, cfg)
    place_rows(cache, mini, rows, lengths)
    _scatter_rows(logits, rows, lg)
    return cache, logits


@torch.no_grad()
def prefix_template(params, prefix, cfg):
    """Prefill a SHARED PREFIX once (a system prompt every request
    continues from); returns the ``[L, 1, P, KV, hd]`` K/V template
    (and an int8 cache's scales) :func:`prefix_admit_rows` copies into
    each admitted slot. prefix: ``[P]`` ints. Rolling caches are
    rejected up front: a ring buffer's rows are the capacity, which a
    template consumer would misread as the prefix length."""
    _check_no_ring(cfg, "prefix templates")
    _count_call("prefix_template", (len(prefix),))
    toks = to_device(np.asarray(prefix, np.int64)[None],
                     params["embed"].device)
    _, mini = prefill(params, toks, cfg, max_len=len(prefix))
    return _kv_bufs(mini)


class PrefixEntry:
    """One RESIDENT shared prefix in a batcher's prefix store: the token
    sequence (for matching and suffix splitting) plus its K/V
    ``template`` (:func:`prefix_template`'s shape, on the batcher's
    device). ``draft_template`` is the speculative batcher's draft-model
    template (computed locally at install — template ships carry only
    the target's K/V). Complete before it enters the store, immutable
    after."""

    __slots__ = ("id", "tokens", "template", "draft_template")

    def __init__(self, prefix_id: str, tokens: list, template: dict,
                 draft_template: dict | None = None) -> None:
        self.id = prefix_id
        self.tokens = tokens
        self.template = template
        self.draft_template = draft_template


class _PrefixHit:
    """Engine-side admission payload for a request that matched a
    resident prefix: only ``suffix`` runs a forward; the prefix K/V come
    from ``entry.template``."""

    __slots__ = ("entry", "suffix")

    def __init__(self, entry: PrefixEntry, suffix: list) -> None:
        self.entry = entry
        self.suffix = suffix


def _host_tensor(a) -> torch.Tensor:
    """A shipped buffer (a template's or a KV package's: a numpy array —
    bfloat16 by dtype name — or a tensor) as a tensor, raising
    ``ValueError`` for a dtype the port cannot hold."""
    if isinstance(a, torch.Tensor):
        return a
    try:
        return params_from_numpy(np.asarray(a), device="cpu")
    except TypeError as e:
        raise ValueError(f"template buffer: {e}") from None


def _pinned_to(a, device) -> torch.Tensor:
    """A host buffer (numpy or CPU tensor) as a tensor on ``device``: to
    the card through pinned memory without blocking (a pageable copy
    would wait for the chunks already queued)."""
    t = _host_tensor(a)
    if torch.device(device).type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def validate_template_bufs(proto: dict, tokens, bufs: dict) -> dict:
    """Validate a (possibly shipped) prefix template against a reference
    cache's buffer layout ``proto`` (``_kv_bufs`` of a cache built from
    the serving config): buffer-name set, dtypes, layer count and
    trailing head dims must match, and the sequence extent must equal
    the prefix length. Raises ``ValueError`` naming the mismatch —
    request-scoped at the install path. Returns the buffers on
    ``proto``'s device."""
    p_len = len(tokens)
    if set(bufs) != set(proto):
        raise ValueError(
            f"template buffers {sorted(bufs)} do not match this cache's "
            f"layout {sorted(proto)} (quantization mismatch?)")
    out = {}
    for n, c in proto.items():
        a = _host_tensor(bufs[n])
        if a.dtype != c.dtype:
            raise ValueError(f"template buffer {n!r} dtype {a.dtype} "
                             f"!= cache dtype {c.dtype}")
        if a.dim() != c.dim() or a.shape[0] != c.shape[0]:
            layers = a.shape[0] if a.dim() else 0
            raise ValueError(
                f"template buffer {n!r} carries {layers} layers; this "
                f"model has {c.shape[0]} (layer mismatch between "
                f"producer and installer?)")
        if a.shape[1] != 1 or a.shape[3:] != c.shape[3:]:
            raise ValueError(f"template buffer {n!r} shape "
                             f"{list(a.shape)} does not fit cache "
                             f"{list(c.shape)}")
        if a.shape[2] != p_len:
            raise ValueError(f"template buffer {n!r} holds {a.shape[2]} "
                             f"positions for a {p_len}-token prefix")
        out[n] = _pinned_to(a, c.device)
    return out


def _extend_rows_from_template(model_params, template, suffixes, lengths,
                               model_cfg):
    """Tile the prefix ``template`` across K rows and run all K
    right-padded suffixes ``[K, S_b]`` through the model against it in
    one chunked :func:`~tony_tpu_torch.models.decode.extend_rows`:
    suffix queries attend the full prefix history exactly as a prefill
    of prefix + suffix would. Each row's padding-tail K/V land beyond
    its frontier (unreachable — the bucketed-admission argument).
    Returns (per-row last-REAL-suffix-position logits ``[K, V]``, the
    ``[L, K, P + S_b]``-row mini cache, per-row totals ``P +
    lengths``)."""
    p_len = template["k"].shape[2]
    k_rows, s_len = suffixes.shape
    mini = {n: torch.cat([x.expand(x.shape[0], k_rows, *x.shape[2:]),
                          x.new_zeros((x.shape[0], k_rows, s_len)
                                      + tuple(x.shape[3:]))], dim=2)
            for n, x in template.items()}
    lg, mini = extend_rows(model_params, suffixes, mini, p_len, lengths,
                           model_cfg)
    return lg, mini, (p_len + lengths).to(torch.int32)


def _extend_from_template(model_params, template, suffix, model_cfg):
    """:func:`_extend_rows_from_template` of ONE suffix ``[1, S]`` at its
    exact length: (its last-position logits ``[1, V]``, the mini cache,
    the total length P + S as an int)."""
    s_len = suffix.shape[1]
    lengths = torch.full((1,), s_len, dtype=torch.int32,
                         device=suffix.device)
    lg, mini, _ = _extend_rows_from_template(model_params, template,
                                             suffix, lengths, model_cfg)
    return lg, mini, template["k"].shape[2] + s_len


@torch.no_grad()
def prefix_admit_row(params, cache, logits, row: int, template, suffix,
                     cfg):
    """Admit a request that CONTINUES a shared prefix: its K/V come from
    the precomputed ``template`` and only the request's ``suffix`` ``[1,
    S]`` runs a forward (:func:`_extend_from_template`) — O(S) admission
    compute instead of O(P + S). The exact-length arm; the batcher's
    default is the bucketed :func:`prefix_admit_rows`."""
    _count_call("prefix_admit_row", suffix.shape)
    lg, mini, total = _extend_from_template(params, template, suffix, cfg)
    _place_prefill(cache, mini, row, total)
    logits[row] = lg[0].to(logits.dtype)
    return cache, logits


@torch.no_grad()
def prefix_admit_rows(params, cache, logits, rows, template, suffixes,
                      lengths, cfg):
    """Bucketed, batched shared-prefix admission: K suffixes (one length
    bucket, right-padded) continue the ``template`` and land in their
    slots in one forward — the :func:`admit_rows` contract (sentinel
    ``rows``, true ``lengths``) at O(suffix) cost."""
    _count_call("prefix_admit_rows", suffixes.shape)
    lg, mini, totals = _extend_rows_from_template(params, template,
                                                  suffixes, lengths, cfg)
    place_rows(cache, mini, rows, totals)
    _scatter_rows(logits, rows, lg)
    return cache, logits


# ---------------------------------------------------------------------------
# Disaggregated prefill/decode: the KV-shipping device programs
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill_ship_rows(params, prompts, lengths, cfg):
    """Prefill one admission bucket of prompts FOR SHIPMENT: the exact
    :func:`~tony_tpu_torch.models.decode.prefill_rows` program the
    colocated :func:`admit_rows` runs, minus the landing — the prefill
    tier has no persistent cache; each row's K/V, last-real logits and
    frontier ship to a decode tier instead (``serving/disagg.py``). Both
    sides run the same bucket ladder and the same program at the same
    row count, so the shipped buffers are what colocated admission would
    have written. prompts: ``[K, S_b]`` right-padded; lengths: ``[K]``.
    Returns (logits ``[K, V]``, the mini cache)."""
    _count_call("prefill_ship_rows", prompts.shape)
    return prefill_rows(params, prompts, lengths, cfg)


@torch.no_grad()
def prefill_ship_row(params, prompt, cfg):
    """Exact-length batch-1 prefill for shipment — the rolling (ring)
    cache path, whose wrapped writes cannot take padded prompts; the
    whole capacity ring ships (landing is a whole-slot write). prompt:
    ``[1, S_p]``."""
    _count_call("prefill_ship_row", prompt.shape)
    return prefill(params, prompt, cfg, max_len=prompt.shape[1])


@torch.no_grad()
def prefix_ship_rows(params, template, suffixes, lengths, cfg):
    """Prefill one bucket of SUFFIXES for shipment against a resident
    prefix ``template`` — the disaggregated counterpart of
    :func:`prefix_admit_rows`: only the suffixes run a forward and the
    prefix + suffix mini cache ships like a full-prefill row. Returns
    (per-row last-real-suffix logits ``[K, V]``, the ``[L, K, P +
    S_b]``-row mini cache)."""
    _count_call("prefix_ship_rows", suffixes.shape)
    lg, mini, _ = _extend_rows_from_template(params, template, suffixes,
                                             lengths, cfg)
    return lg, mini


@torch.no_grad()
def land_kv_rows(cache, logits, rows, minis, lengths, row_logits, keys,
                 row_keys):
    """Land K shipped KV rows into cache slots ``rows`` in place: each
    row's buffers (``minis[i]``: ``{name: [L, 1, w_i, KV, hd]}``, host or
    device) copy into positions [0, w_i) of their slot — one indexed
    copy per buffer, only the real rows, no padding — then the slots'
    frontiers (``lengths``), next-step logits (``row_logits``, K ``[V]``)
    and rng stream keys (``row_keys``, K ``[2]`` into the host key table
    ``keys``) are set. No model forward: adopting a row never stalls the
    in-flight decode chunk behind a prefill. Returns (cache, logits,
    keys)."""
    _count_call("land_kv_rows", (len(rows),))
    dev = cache["k"].device
    for row, mini in zip(rows, minis):
        for n, a in mini.items():
            src = _pinned_to(a, dev)
            cache[n][:, row:row + 1, :src.shape[2]].copy_(src)
    idx = to_device(np.asarray(rows, np.int64), dev)
    cache["length"][idx] = to_device(np.asarray(lengths, np.int32), dev)
    lg = torch.stack([_host_tensor(x).to(logits.dtype)
                      for x in row_logits])
    logits[idx] = _pinned_to(lg, dev)
    for row, k in zip(rows, row_keys):
        keys[row] = torch.as_tensor(np.asarray(k, np.uint32).astype(
            np.int64))
    return cache, logits, keys


class KVPackage:
    """One prefilled request's state, shipped from a prefill tier to a
    decode tier (disaggregated serving), as the decode side lands it
    (:meth:`ServeEngine.submit_prefilled`):

    - ``bufs``: host copies of the row's cache buffers (``k``/``v``, and
      ``k_scale``/``v_scale`` of an int8 cache, shipped quantized), each
      ``[L, 1, S, KV, hd]``: the true prompt length of a linear cache,
      the whole capacity of a ring;
    - ``length``: the row's frontier (a ring's absolute position may
      exceed its capacity);
    - ``logits``: ``[V]`` last-real-position logits seeding the first
      decode step;
    - ``rng_key``: ``[2]`` uint32 per-request stream key and ``rng_off``
      its stream position — what makes a SAMPLED disaggregated stream
      the colocated one.

    The wire form is :mod:`tony_tpu_torch.serving.kvship`'s."""

    __slots__ = ("bufs", "length", "logits", "rng_key", "rng_off")

    def __init__(self, bufs: dict, length: int, logits, rng_key,
                 rng_off: int = 0) -> None:
        self.bufs = bufs
        self.length = int(length)
        self.logits = logits
        self.rng_key = rng_key
        self.rng_off = int(rng_off)

    @property
    def width(self) -> int:
        """Shipped cache positions per layer (the buffers' S extent)."""
        return self.bufs["k"].shape[2]


def _row_samples(logits, noise, temperature, top_k, top_p):
    """One sampling decision per row: the argmax at ``temperature == 0``
    (``noise`` unused; pass None), otherwise the argmax of ``noise`` (the
    row's own Gumbel draw, ``[B, V]``) plus the filtered logits — the
    JAX batcher's vmapped per-row ``categorical`` through the same
    filter stack as :func:`~tony_tpu_torch.models.decode.generate`."""
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    f = _filter_logits(logits.float(), temperature, top_k, top_p)
    return torch.argmax(noise + f, dim=-1)


def chunk_noise(keys, offsets, n: int, vocab: int) -> torch.Tensor:
    """Gumbel noise ``[B, n, V]`` of an ``n``-step chunk: row ``r`` at
    step ``j`` draws from ``fold_in(keys[r], offsets[r] + j)`` (``keys``
    ``[B, 2]``, ``offsets`` ``[B]``, on the logits' device)."""
    steps = offsets.long()[:, None] + torch.arange(n, device=keys.device)
    return prng.gumbel(prng.fold_in(keys[:, None, :], steps), (vocab,))


@torch.no_grad()
def step_rows(params, cache, logits, keys, offsets, n: int, cfg,
              temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
              lengths=None):
    """``n`` decode steps for every row at its OWN frontier — greedy at
    ``temperature == 0`` (``keys``/``offsets`` unused; pass None),
    otherwise sampled per row: ``keys`` ``[B, 2]`` are the rows'
    occupant streams and ``offsets`` ``[B]`` the draws each has already
    taken, so step ``j`` of row ``r`` samples from ``fold_in(keys[r],
    offsets[r] + j)`` (:func:`chunk_noise`). ``lengths``: the host's copy
    of the rows' frontiers before the chunk (bounds the blockwise cache
    walk without reading the card; read back from the cache when
    absent). Returns (tokens ``[B, n]`` on the device, cache, logits).
    Idle rows decode garbage the host discards."""
    _count_call("step_rows", (tuple(cache["k"].shape), n))
    noise = (chunk_noise(keys, offsets, n, logits.shape[-1])
             if temperature > 0.0 else None)
    toks = []
    for j in range(n):
        tok = _row_samples(logits, None if noise is None else noise[:, j],
                           temperature, top_k, top_p)
        rng = None if lengths is None else (min(lengths) + j,
                                            max(lengths) + j)
        logits, cache = decode_step(params, tok, cache, cache["length"],
                                    cfg, rng)
        toks.append(tok)
    return torch.stack(toks, dim=1), cache, logits


def _seed_tokens(logits, keys, temperature, top_k, top_p):
    """The speculative admission's pending token per row: the argmax, or
    a draw from each row's seed key ``[K, 2]`` through the filter
    stack."""
    noise = (prng.gumbel(keys.to(logits.device), (logits.shape[-1],))
             if temperature > 0.0 else None)
    return _row_samples(logits, noise, temperature, top_k, top_p)


@torch.no_grad()
def spec_admit_row(params, draft_params, t_cache, d_cache, pending,
                   row: int, prompt, key, cfg, draft_cfg,
                   temperature: float = 0.0, top_k: int = 0,
                   top_p: float = 0.0):
    """Speculative admission at the EXACT prompt length ``[1, S_p]``:
    prefill BOTH models into cache slot ``row`` (the draft keeps its own
    per-slot K/V history) and seed the row's ``pending`` token from the
    target's last-position logits — the argmax, or a draw with ``key``
    (the request's stream position 0) through the filter stack. The
    batcher's default is the bucketed :func:`spec_admit_rows`."""
    _count_call("spec_admit_row", prompt.shape)
    s_p = prompt.shape[1]
    lg, mini_t = prefill(params, prompt, cfg, max_len=s_p)
    _, mini_d = prefill(draft_params, prompt, draft_cfg, max_len=s_p)
    _place_prefill(t_cache, mini_t, row, s_p)
    _place_prefill(d_cache, mini_d, row, s_p)
    keys = None if key is None else torch.as_tensor(key)[None]
    pending[row] = _seed_tokens(lg, keys, temperature, top_k, top_p)[0]
    return t_cache, d_cache, pending


@torch.no_grad()
def spec_admit_rows(params, draft_params, t_cache, d_cache, pending, rows,
                    prompts, lengths, keys, cfg, draft_cfg,
                    temperature: float = 0.0, top_k: int = 0,
                    top_p: float = 0.0):
    """Bucketed, batched speculative admission: K prompts (one length
    bucket) prefill BOTH models in one forward each and land in their
    slots — the :func:`admit_rows` contract on the speculative batcher's
    two caches. ``keys``: ``[K, 2]`` per-request seed-draw keys (stream
    position 0 of each request; the rounds take positions 1 on), used
    only at ``temperature > 0``."""
    _count_call("spec_admit_rows", prompts.shape)
    lg, mini_t = prefill_rows(params, prompts, lengths, cfg)
    _, mini_d = prefill_rows(draft_params, prompts, lengths, draft_cfg)
    place_rows(t_cache, mini_t, rows, lengths)
    place_rows(d_cache, mini_d, rows, lengths)
    _scatter_rows(pending, rows,
                  _seed_tokens(lg, keys, temperature, top_k, top_p))
    return t_cache, d_cache, pending


@torch.no_grad()
def spec_prefix_admit_row(params, draft_params, t_cache, d_cache, pending,
                          row: int, t_template, d_template, suffix, key,
                          cfg, draft_cfg, temperature: float = 0.0,
                          top_k: int = 0, top_p: float = 0.0):
    """Shared-prefix admission for the speculative batcher at the EXACT
    suffix length ``[1, S]``: both models' prefix K/V come from their
    templates and only the suffix runs a forward through each
    (:func:`_extend_from_template`); the pending seed comes from the
    target's last suffix position, the argmax or a draw with ``key``,
    as in :func:`spec_admit_row`. The batcher's default is the bucketed
    :func:`spec_prefix_admit_rows`."""
    _count_call("spec_prefix_admit_row", suffix.shape)
    lg, mini_t, total = _extend_from_template(params, t_template, suffix,
                                              cfg)
    _, mini_d, _ = _extend_from_template(draft_params, d_template, suffix,
                                         draft_cfg)
    _place_prefill(t_cache, mini_t, row, total)
    _place_prefill(d_cache, mini_d, row, total)
    keys = None if key is None else torch.as_tensor(key)[None]
    pending[row] = _seed_tokens(lg, keys, temperature, top_k, top_p)[0]
    return t_cache, d_cache, pending


@torch.no_grad()
def spec_prefix_admit_rows(params, draft_params, t_cache, d_cache, pending,
                           rows, t_template, d_template, suffixes, lengths,
                           keys, cfg, draft_cfg, temperature: float = 0.0,
                           top_k: int = 0, top_p: float = 0.0):
    """Bucketed, batched shared-prefix speculative admission: K suffixes
    (one length bucket) continue both models' templates in one chunked
    extend each (:func:`_extend_rows_from_template`) and land in their
    slots, each slot's pending seeded from its true last suffix
    position."""
    _count_call("spec_prefix_admit_rows", suffixes.shape)
    lg, mini_t, totals = _extend_rows_from_template(params, t_template,
                                                    suffixes, lengths, cfg)
    _, mini_d, _ = _extend_rows_from_template(draft_params, d_template,
                                              suffixes, lengths, draft_cfg)
    place_rows(t_cache, mini_t, rows, totals)
    place_rows(d_cache, mini_d, rows, totals)
    _scatter_rows(pending, rows,
                  _seed_tokens(lg, keys, temperature, top_k, top_p))
    return t_cache, d_cache, pending


@torch.no_grad()
def spec_step_rows(params, draft_params, t_cache, d_cache, pending, keys,
                   offsets, n: int, cfg, draft_cfg, k: int,
                   temperature: float = 0.0, top_k: int = 0,
                   top_p: float = 0.0, lengths=None):
    """``n`` speculative rounds for every row at its OWN frontier, each
    row committing its full acceptance ``acc + 1`` per round (the host
    truncates at each request's budget or eos and discards idle rows'
    garbage). Greedy at ``temperature == 0``; otherwise sampled rounds
    with per-row round keys ``fold_in(keys[r], offsets[r] + i)``.
    ``lengths``: host bounds (lowest, highest) of the rows' frontiers
    before the first round, which bound the blockwise walk (round ``i``
    moves them by at least ``i`` and at most ``i * (k+1)``). Returns
    ``(packed [n, B, k+2], t_cache, d_cache, pending)``: ``packed[i, r,
    0]`` is round i's commit count of row r and ``packed[i, r, 1:]`` its
    chunk — ONE tensor, so the host fetches a sync's tokens in one
    copy."""
    _count_call("spec_step_rows", (tuple(t_cache["k"].shape), n, k))
    packed = []
    for i in range(n):
        pos = t_cache["length"]                                  # [B]
        rng = None if lengths is None else (lengths[0] + i,
                                            lengths[1] + i * (k + 1))
        if temperature == 0.0:
            chunk, argmaxes, acc, t_cache, d_cache = _propose_and_verify(
                params, draft_params, t_cache, d_cache, pending, pos, cfg,
                draft_cfg, k, None, rng)
            pending = argmaxes.gather(1, acc[:, None])[:, 0]
        else:
            round_keys = prng.fold_in(keys, offsets + i)
            chunk, pending, acc, t_cache, d_cache = (
                _propose_and_verify_sampled(
                    params, draft_params, t_cache, d_cache, pending, pos,
                    cfg, draft_cfg, k, None, round_keys, temperature,
                    top_k, top_p, rng))
        count = acc + 1
        new_len = (pos + count).to(torch.int32)
        t_cache["length"] = new_len
        d_cache["length"] = new_len
        packed.append(torch.cat([count[:, None], chunk.long()], dim=1))
    return torch.stack(packed), t_cache, d_cache, pending


def retire_rows(cache, mask):
    """Reset retired rows' frontiers to 0 in place (mask: host sequence
    of bools), keeping idle slots from marching off the cache end."""
    mask_t = to_device(np.asarray(mask, bool), cache["length"].device)
    cache["length"].masked_fill_(mask_t, 0)
    return cache


class ContinuousBatcher:
    """Host-side admission loop over the device programs above.

    ``serve(prompts, max_new_tokens)`` runs every request to completion
    (``max_new_tokens`` or ``eos_id``) through ``batch`` cache slots,
    admitting the next queued request the moment a slot frees. At the
    default ``temperature=0`` outputs are the greedy tokens
    :func:`~tony_tpu_torch.models.decode.generate` gives each request
    alone; with ``temperature``/``top_k``/``top_p`` set, slots sample
    through the same filter stack from per-request streams of ``seed``.
    Either way they match the JAX batcher's tokens and
    ``steps_executed``.

    ``pipeline=True`` (default) enqueues chunk N+1 before fetching chunk
    N; ``pipeline=False`` is the sequential equivalence baseline. Both
    give identical outputs. Admission is bucketed and batched by default
    (``bucketed_admission=False`` admits one row per forward). A rolling
    cache (``cfg.kv_cache_capacity``) admits each request at its exact
    length (:func:`admit_row_ring`) and lifts the ``max_len`` ceiling on
    prompt + budget.

    Shared prefixes: ``install_prefix`` makes a prefix RESIDENT (its K/V
    template computed here, or landed from a peer's shipped template
    with zero prefix forwards), and a request whose prompt properly
    continues a resident prefix admits only its suffix through the model
    (:func:`prefix_admit_rows` against the template). The legacy
    ``shared_prefix=`` mode interprets EVERY prompt as a continuation of
    one prefix. A rolling cache cannot host positional templates: it
    serves prefix-blind (``install_prefix`` returns False, with one
    warning); ``shared_prefix=`` on it raises.
    """

    #: first per-request stream position consumed by step_rows sampling
    #: (the speculative batcher's admission seed draw takes position 0,
    #: so its rounds start at 1)
    _off0 = 0

    def __init__(self, params, cfg: T.TransformerConfig, batch: int,
                 max_len: int, eos_id: int | None = None, chunk: int = 8,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, seed: int = 0, shared_prefix=None,
                 pipeline: bool = True,
                 bucketed_admission: bool = True) -> None:
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        self.params = params
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.device = params["embed"].device
        #: rolling KV cache: slots hold a ring of O(window) rows and
        #: requests may run past max_len (HELLO and STATS report it)
        self._ring = bool(cfg.kv_cache_capacity)
        #: legacy shared-prefix mode: every prompt continues this prefix
        #: (a suffix); its template prefills once, here
        self.shared_prefix = (None if shared_prefix is None
                              else [int(t) for t in shared_prefix])
        if self.shared_prefix is not None:
            if not self.shared_prefix:
                raise ValueError("shared_prefix must be non-empty when "
                                 "given")
            # templates are positional; they do not survive wraparound
            _check_no_ring(cfg, "shared-prefix caching")
        self._prefix_template = (
            prefix_template(params, self.shared_prefix, cfg)
            if self.shared_prefix else None)
        #: RESIDENT prefix templates: id -> PrefixEntry, only ever
        #: grown, each entry complete before it is published
        self._prefix_store: dict = {}
        self._ring_prefix_warned = False
        #: serializes a template's landing (install threads) with the
        #: engine's admissions, which read the store and the counters
        self._store_lock = threading.Lock()
        #: sampling controls (greedy by default); streams are per request
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed)
        #: device steps per host round trip
        self.chunk = max(1, chunk)
        self.pipeline = bool(pipeline)
        #: wrapped ring writes cannot take padded prompts: a ring admits
        #: one request per forward at its exact length
        self.bucketed_admission = bool(bucketed_admission) and not self._ring
        self.cache = init_kv_cache(cfg, batch, max_len, device=self.device)
        self.cache["length"] = torch.zeros((batch,), dtype=torch.int32,
                                           device=self.device)
        #: host mirror of cache["length"], kept by every admit/step/retire
        self._host_len = [0] * batch
        self.logits = torch.zeros((batch, cfg.vocab_size),
                                  dtype=cfg.logits_storage_dtype,
                                  device=self.device)
        self.steps_executed = 0
        #: speculative rounds run (0 for this batcher)
        self.rounds_executed = 0
        self.phase_times = PhaseTimes()
        #: true prompt/suffix tokens run through a prefill or extend
        #: forward (a locally computed template included) vs prefix
        #: positions satisfied by a template COPY, and the admissions
        #: that took a resident template
        self.prefill_forward_tokens = 0
        self.prefix_copied_tokens = 0
        self.prefix_admits = 0
        self._reset_streams()

    # --- per-request rng streams ---

    @property
    def sampled(self) -> bool:
        return self.temperature > 0.0

    def _reset_streams(self) -> None:
        self._base_key = prng.PRNGKey(self.seed)
        idle = prng.fold_in(self._base_key, _IDLE_STREAM)
        #: [B, 2] per-row keys on the host: each row carries its occupant
        #: REQUEST's stream key; idle rows draw from a fixed idle stream
        self._row_keys = idle[None].repeat(self.batch, 1)
        #: per-row stream positions consumed so far (host ints)
        self._row_off = [self._off0] * self.batch
        #: stream index -> positions ALREADY consumed elsewhere (a
        #: preempted request re-admitting with its streamed tokens folded
        #: into its prompt): the row's first sample is drawn at this
        #: offset. Consumed at admission.
        self._stream_skip: dict[int, int] = {}

    def _req_key(self, req):
        """The stream key of request index ``req`` (an int or a tensor of
        them): ``fold_in(PRNGKey(seed), req)``."""
        return prng.fold_in(self._base_key, req)

    # --- resident prefix templates (prefix-aware serving) ---

    def install_prefix(self, prefix_id: str, tokens,
                       template: dict | None = None) -> bool:
        """Make a shared prefix RESIDENT: admissions whose prompt
        continues ``tokens`` run only their suffix through the model
        (:func:`prefix_admit_rows` against the stored template).
        ``template`` None computes the prefill here (ONE forward); a
        template shipped from a peer replica installs with ZERO prefix
        forwards (:func:`validate_template_bufs` guards the layout). A
        rolling cache degrades to prefix-blind serving with one warning
        and returns False. Raises ``ValueError`` for empty tokens, no
        room for a suffix, legacy ``shared_prefix`` mode, or a
        mismatched template. Callable from any thread: the entry is
        complete (the speculative batcher's draft template included)
        before it enters the store, under the lock admissions take."""
        tokens = [int(t) for t in tokens]
        if not tokens:
            raise ValueError("prefix tokens must be non-empty")
        if self.shared_prefix is not None:
            raise ValueError(
                "legacy shared_prefix mode already interprets every "
                "prompt as a continuation; per-request prefix "
                "templates compose with plain batchers only")
        if self._ring:
            self._warn_ring("rolling (ring) caches cannot host prefix "
                            "templates (positional K/V do not survive "
                            "wraparound); serving prefix-blind")
            return False
        if len(tokens) + 2 > self.max_len:
            raise ValueError(
                f"prefix of {len(tokens)} tokens leaves no room for a "
                f"suffix + generation under max_len {self.max_len}")
        with self._store_lock:
            if template is None:
                template = prefix_template(self.params, tokens, self.cfg)
                self.prefill_forward_tokens += len(tokens)
            else:
                template = validate_template_bufs(_kv_bufs(self.cache),
                                                  tokens, template)
            self._prefix_store[str(prefix_id)] = self._build_entry(
                str(prefix_id), tokens, template)
        return True

    def _warn_ring(self, msg: str) -> None:
        if not self._ring_prefix_warned:
            self._ring_prefix_warned = True
            logging.getLogger(__name__).warning(msg)

    def _build_entry(self, prefix_id: str, tokens: list,
                     template: dict) -> PrefixEntry:
        """Entry construction hook: the speculative batcher adds the
        draft-model template before the entry is published."""
        return PrefixEntry(prefix_id, tokens, template)

    def install_prefix_template(self, meta: dict, bufs: dict) -> str:
        """Land an unpacked SHIPPED template (``kvship.unpack_template``
        output): the vocab is checked against this model up front, so a
        template of a differently-shaped model is a request-scoped
        ``ValueError``, never garbage K/V. Returns the prefix id."""
        if int(meta["vocab"]) != self.cfg.vocab_size:
            raise ValueError(
                f"template vocab {meta['vocab']} != this model's "
                f"{self.cfg.vocab_size} (shipped from a different "
                f"model?)")
        if not self.install_prefix(meta["id"], meta["tokens"],
                                   template=bufs):
            raise ValueError("rolling-cache layout cannot host prefix "
                             "templates (degraded prefix-blind)")
        return str(meta["id"])

    def resident_prefixes(self) -> list:
        """Ids of the installed prefix templates (advertised in HELLO and
        STATS)."""
        return sorted(self._prefix_store)

    def export_prefix_blob(self, prefix_id: str) -> bytes:
        """Pack the resident ``prefix_id`` for publication to a peer
        replica (one device-to-host copy per buffer); raises
        ``ValueError`` when not resident."""
        from tony_tpu_torch.serving import kvship
        entry = self._prefix_store.get(str(prefix_id))
        if entry is None:
            raise ValueError(f"prefix {prefix_id!r} is not resident")
        return kvship.pack_template(entry.id, entry.tokens, entry.template,
                                    self.cfg.vocab_size)

    def _resolve_prefix(self, prefix_id, prompt) -> PrefixEntry | None:
        """Resolve a submission against the resident store: the named
        entry when ``prefix_id`` is given and the prompt properly
        continues its tokens, else the LONGEST resident proper-prefix
        match. None = serve prefix-blind (a miss is never an error)."""
        if self._ring:
            if prefix_id is not None:
                self._warn_ring("prefix-id admission on a rolling (ring) "
                                "cache; serving prefix-blind")
            return None
        if not self._prefix_store or self.shared_prefix is not None:
            return None
        if prefix_id is not None:
            entry = self._prefix_store.get(prefix_id)
            if (entry is not None and len(entry.tokens) < len(prompt)
                    and prompt[:len(entry.tokens)] == entry.tokens):
                return entry
        from tony_tpu_torch.serving.prefix import match_prefix
        entries = list(self._prefix_store.values())
        pid = match_prefix(prompt, ((e.id, e.tokens) for e in entries))
        return next((e for e in entries if e.id == pid), None) \
            if pid is not None else None

    # --- admission (bucketed/batched with a per-row fallback) ---

    def _bucket_for(self, n: int) -> int:
        """Padded admission length of an n-token prompt (a suffix in the
        legacy shared-prefix mode) against the cache's admissible
        length."""
        cap = self.max_len - (len(self.shared_prefix)
                              if self.shared_prefix else 0)
        return bucket_for(n, cap)

    @staticmethod
    def _seq_of(payload):
        """The tokens an admission payload runs through the model: the
        whole prompt, or only the suffix of a prefix hit."""
        return payload.suffix if isinstance(payload, _PrefixHit) \
            else payload

    def _marshal_wave(self, pairs):
        """([batch] row targets, [batch, 2] stream keys or None) for
        admitted (row, request) pairs, padded with DISTINCT out-of-range
        row sentinels (their writes drop) and the idle stream. Keys are
        computed on the host only when sampling."""
        rows = self.batch + np.arange(self.batch, dtype=np.int64)
        req_ids = [_IDLE_STREAM] * self.batch
        for i, (row, req) in enumerate(pairs):
            rows[i] = row
            req_ids[i] = req
        keys = (self._req_key(torch.tensor(req_ids, dtype=torch.int64))
                if self.sampled else None)
        return rows, keys

    def _rebind_streams(self, pairs, rows, keys) -> None:
        """Rebind the admitted rows' streams to their new occupants: the
        wave's keys (sentinel rows dropped) and the stream positions."""
        if keys is not None:
            for i, row in enumerate(rows):
                if row < self.batch:
                    self._row_keys[row] = keys[i]
        for row, req in pairs:
            self._row_off[row] = self._off0 + self._stream_skip.pop(req, 0)

    def _pad_prompts_to(self, grp, prompts, bucket):
        """[batch, bucket] right-padded prompts and [batch] true lengths
        for one bucket group (entries past the group are inert); a
        prefix hit pads its SUFFIX."""
        toks = np.zeros((self.batch, bucket), np.int64)
        lens = np.ones((self.batch,), np.int32)
        for i, (_, req) in enumerate(grp):
            p = self._seq_of(prompts[req])
            toks[i, :len(p)] = p
            lens[i] = len(p)
        return toks, lens

    def _admit_batch(self, pairs, prompts) -> None:
        """Admit (row, request-index) pairs. ``prompts`` maps each
        request index to a token sequence or prefix hit (prefilled here)
        or a :class:`KVPackage` (prefilled on a prefill tier: landing is
        a copy). The engine's admission sweep feeds both through this
        one seam."""
        pkg, toks = [], []
        for pair in pairs:
            (pkg if isinstance(prompts[pair[1]], KVPackage)
             else toks).append(pair)
        if pkg:
            self._admit_packages(pkg, prompts)
        if toks:
            self._admit_prompts(toks, prompts)

    def _admit_packages(self, pairs, pkgs) -> None:
        """Land shipped-KV admissions (:meth:`_land_group`)."""
        with self.phase_times.phase("admit"):
            self._land_group(pairs, pkgs)

    def _land_group(self, grp, pkgs) -> None:
        """Land packages into their slots with :func:`land_kv_rows`, on
        the thread and stream that own the cache: the real rows only,
        each buffer one host-to-device copy of its shipped width."""
        rows = [row for row, _ in grp]
        got = [pkgs[req] for _, req in grp]
        self.cache, self.logits, self._row_keys = land_kv_rows(
            self.cache, self.logits, rows, [p.bufs for p in got],
            [p.length for p in got], [p.logits for p in got],
            self._row_keys, [p.rng_key for p in got])
        for row, p in zip(rows, got):
            self._row_off[row] = self._off0 + p.rng_off
        self._set_host_len(rows, [p.length for p in got])

    def _validate_package(self, pkg, max_new: int) -> None:
        """Reject a shipped-KV admission this batcher could not land:
        wrong buffer set, dtypes or trailing dims against this cache, a
        width past the cache extent, or frontier + budget past
        ``max_len`` (linear caches). Raises ``ValueError`` naming the
        mismatch — request-scoped at the decode server. The buffers and
        logits become CPU tensors in place."""
        if not isinstance(pkg, KVPackage):
            raise ValueError(f"expected a KVPackage, got {type(pkg)}")
        if max_new <= 0:
            raise ValueError(f"max_new_tokens must be positive, "
                             f"got {max_new}")
        if pkg.length < 1:
            raise ValueError(f"package frontier must be >= 1, "
                             f"got {pkg.length}")
        lg = _host_tensor(pkg.logits)
        if lg.dim() != 1 or lg.shape[0] != self.cfg.vocab_size:
            raise ValueError(
                f"package logits shape {list(lg.shape)} != "
                f"[{self.cfg.vocab_size}] (vocab mismatch between the "
                f"prefill and decode gangs?)")
        want = _kv_bufs(self.cache)
        if set(pkg.bufs) != set(want):
            raise ValueError(
                f"package buffers {sorted(pkg.bufs)} do not match this "
                f"cache's layout {sorted(want)} (quantization mismatch "
                f"between the prefill and decode gangs?)")
        rows = self.cache["k"].shape[2]
        bufs = {}
        for n, a in pkg.bufs.items():
            a = _host_tensor(a)
            c = want[n]
            if a.dtype != c.dtype:
                raise ValueError(f"package buffer {n!r} dtype {a.dtype} "
                                 f"!= cache dtype {c.dtype}")
            if (a.dim() != c.dim() or a.shape[0] != c.shape[0]
                    or a.shape[1] != 1 or a.shape[3:] != c.shape[3:]):
                raise ValueError(f"package buffer {n!r} shape "
                                 f"{tuple(a.shape)} does not fit cache "
                                 f"{tuple(c.shape)}")
            if a.shape[2] > rows:
                raise ValueError(f"package width {a.shape[2]} exceeds "
                                 f"the cache's {rows} rows")
            bufs[n] = a
        if len({a.shape[2] for a in bufs.values()}) != 1:
            raise ValueError("package buffers disagree on their width")
        pkg.bufs, pkg.logits = bufs, lg
        if self._ring:
            if pkg.width != rows:
                raise ValueError(
                    f"ring landings must ship the full {rows}-row "
                    f"capacity, got {pkg.width}")
        elif pkg.length + max_new > self.max_len:
            raise ValueError(f"frontier {pkg.length} + {max_new} new "
                             f"tokens exceeds max_len {self.max_len}")
        if pkg.length > pkg.width and not self._ring:
            raise ValueError(f"frontier {pkg.length} exceeds shipped "
                             f"width {pkg.width}")

    def _admit_prompts(self, pairs, prompts) -> None:
        """Admit prompt (row, request-index) pairs: group by (resident
        prefix, length bucket) and land each group with one
        :func:`admit_rows` — :func:`prefix_admit_rows` for a prefix-hit
        group, which runs only its suffixes (one admission per pair
        when bucketing is off) — then rebind the rows' rng streams."""
        with self.phase_times.phase("admit"), self._store_lock:
            if self.bucketed_admission:
                groups: dict[tuple, list] = {}
                for row, req in pairs:
                    p = prompts[req]
                    if isinstance(p, _PrefixHit):
                        key = (p.entry.id, bucket_for(
                            len(p.suffix),
                            self.max_len - len(p.entry.tokens)))
                    else:
                        key = (None, self._bucket_for(len(p)))
                    groups.setdefault(key, []).append((row, req))
                for pid, bucket in sorted(groups, key=lambda k: (k[0] or "",
                                                                 k[1])):
                    grp = groups[(pid, bucket)]
                    entry = (prompts[grp[0][1]].entry if pid is not None
                             else None)
                    rows, keys = self._marshal_wave(grp)
                    toks, lens = self._pad_prompts_to(grp, prompts, bucket)
                    self._admit_rows(rows, toks, lens, keys, entry=entry)
                    self._rebind_streams(grp, rows, keys)
            else:
                for row, req in pairs:
                    self._admit_row(row, req, prompts[req])
                rows, keys = self._marshal_wave(pairs)
                self._rebind_streams(pairs, rows, keys)
            self._count_admission(pairs, prompts)

    def _count_admission(self, pairs, prompts) -> None:
        """Fold admitted pairs into the prefill accounting: forward
        tokens vs template-copied prefix positions (the legacy
        shared-prefix mode's copies count too)."""
        shared_p = len(self.shared_prefix) if self.shared_prefix else 0
        for _, req in pairs:
            p = prompts[req]
            self.prefill_forward_tokens += len(self._seq_of(p))
            if isinstance(p, _PrefixHit):
                self.prefix_copied_tokens += len(p.entry.tokens)
                self.prefix_admits += 1
            elif shared_p:
                self.prefix_copied_tokens += shared_p

    def _template_of(self, entry):
        """(target template, prefix length) of a group: the resident
        entry's, the legacy shared prefix's, or (None, 0)."""
        if entry is not None:
            return entry.template, len(entry.tokens)
        if self._prefix_template is not None:
            return self._prefix_template, len(self.shared_prefix)
        return None, 0

    def _admit_rows(self, rows, toks, lens, keys, entry=None) -> None:
        """Land one bucket group (``keys``: the wave's stream keys, used
        by the speculative batcher's seed draws)."""
        template, p_len = self._template_of(entry)
        toks_d = to_device(toks, self.device)
        lens_d = to_device(lens, self.device)
        if template is not None:
            self.cache, self.logits = prefix_admit_rows(
                self.params, self.cache, self.logits, rows, template,
                toks_d, lens_d, self.cfg)
        else:
            self.cache, self.logits = admit_rows(
                self.params, self.cache, self.logits, rows, toks_d, lens_d,
                self.cfg)
        self._set_host_len(rows, lens + p_len)

    def _set_host_len(self, rows, lens) -> None:
        for row, n in zip(rows, lens):
            if row < self.batch:
                self._host_len[row] = int(n)

    def _admit_row(self, row: int, req: int, prompt) -> None:
        """Admit request ``req`` alone into slot ``row``: a prefix hit's
        (or the legacy mode's) suffix at its exact length against the
        template, else padded to its bucket, or at its exact length into
        a rolling cache."""
        entry = prompt.entry if isinstance(prompt, _PrefixHit) else None
        seq = self._seq_of(prompt)
        n = len(seq)
        template, p_len = self._template_of(entry)
        if template is not None:
            self.cache, self.logits = prefix_admit_row(
                self.params, self.cache, self.logits, row, template,
                to_device(np.asarray([seq], np.int64), self.device),
                self.cfg)
        elif self._ring:
            self.cache, self.logits = admit_row_ring(
                self.params, self.cache, self.logits, row,
                to_device(np.asarray([seq], np.int64), self.device),
                self.cfg)
        else:
            padded = np.zeros((1, self._bucket_for(n)), np.int64)
            padded[0, :n] = seq
            self.cache, self.logits = admit_row(
                self.params, self.cache, self.logits, row,
                to_device(padded, self.device), n, self.cfg)
        self._host_len[row] = p_len + n

    # --- dispatch / fetch ---

    def _chunk_tokens_max(self) -> int:
        """Most tokens one chunk can commit per row (one per step here;
        the speculative batcher overrides)."""
        return self.chunk

    def _issue(self):
        """Enqueue one chunk WITHOUT waiting for it; returns the device
        tokens. The pipelined loop issues chunk N+1 here before fetching
        chunk N."""
        with self.phase_times.phase("dispatch"):
            keys = offs = None
            if self.sampled:
                keys = to_device(self._row_keys.numpy(), self.device)
                offs = to_device(np.asarray(self._row_off, np.int64),
                                 self.device)
            toks, self.cache, self.logits = step_rows(
                self.params, self.cache, self.logits, keys, offs,
                self.chunk, self.cfg, self.temperature, self.top_k,
                self.top_p, lengths=self._host_len)
        self.steps_executed += self.chunk
        self._host_len = [n + self.chunk for n in self._host_len]
        self._row_off = [o + self.chunk for o in self._row_off]
        return toks

    def _fetch(self, handle):
        """Block on an issued chunk and copy its tokens to the host."""
        with self.phase_times.phase("fetch"):
            return handle.cpu().numpy()

    def _retire(self, mask) -> None:
        self.cache = retire_rows(self.cache, mask)
        for r, m in enumerate(mask):
            if m:
                self._host_len[r] = 0

    def _validate_request(self, prompt, max_new: int) -> None:
        """Reject an empty prompt, a non-positive budget, or (linear
        caches — a rolling cache has no length ceiling) shared prefix +
        prompt + budget past ``max_len``."""
        p_len = len(self.shared_prefix) if self.shared_prefix else 0
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if max_new <= 0:
            raise ValueError(f"max_new_tokens must be positive, "
                             f"got {max_new}")
        if not self._ring and p_len + len(prompt) + max_new > self.max_len:
            raise ValueError(
                (f"shared prefix {p_len} + " if p_len else "")
                + f"prompt {len(prompt)} + {max_new} new tokens exceeds "
                  f"max_len {self.max_len}")

    def _validate_prefix_hit(self, hit: _PrefixHit, max_new: int) -> None:
        """Validate a prefix-hit admission (resident template + suffix)
        against the cache geometry (the suffix is non-empty by the
        proper-prefix match)."""
        total = len(hit.entry.tokens) + len(hit.suffix)
        if max_new <= 0:
            raise ValueError(f"max_new_tokens must be positive, "
                             f"got {max_new}")
        if total + max_new > self.max_len:
            raise ValueError(
                f"prefix {len(hit.entry.tokens)} + suffix "
                f"{len(hit.suffix)} + {max_new} new tokens exceeds "
                f"max_len {self.max_len}")

    def serve(self, prompts: Sequence, max_new_tokens):
        """Run all ``prompts`` (each a token sequence) to completion;
        returns per-request generated-token lists in input order.
        ``max_new_tokens``: one int or a per-request sequence. Request
        ``i`` samples from stream ``i``. ``self.steps_executed`` counts
        decode steps run; ``phase_times`` holds per-phase host wall
        clock. A thin closed-batch wrapper over :class:`ServeEngine`:
        submit everything, drain, run."""
        if isinstance(max_new_tokens, int):
            budget = [max_new_tokens] * len(prompts)
        else:
            budget = list(max_new_tokens)
            if len(budget) != len(prompts):
                raise ValueError("per-request max_new_tokens length "
                                 "must match prompts")
        outputs: list[list[int]] = [[] for _ in prompts]
        engine = ServeEngine(
            self, on_delta=lambda rid, toks: outputs[rid].extend(toks),
            on_retired=lambda rid, reason, n, final:
                outputs[rid].extend(final))
        for req, (p, b) in enumerate(zip(prompts, budget)):
            try:
                engine.submit(req, p, b)
            except ValueError as e:
                engine._abort_outstanding("stopped")
                raise ValueError(f"request {req}: {e}") from None
        engine.drain()
        engine.run()
        return outputs


class SpeculativeContinuousBatcher(ContinuousBatcher):
    """Continuous batching with speculative decoding per slot. A draft
    model proposes ``num_speculative`` tokens per round for EVERY slot
    at its own frontier; the target verifies each slot's chunk in one
    wide ``extend_step``; each slot commits its own acceptance
    (:func:`spec_step_rows`). Admission prefills BOTH caches (bucketed
    and batched by default, :func:`spec_admit_rows`), retirement frees
    the slot, and idle rows decode garbage the host discards; the
    engine's pipelined loop is unchanged — one packed tensor per sync.

    Greedy rounds give each request's greedy ``generate`` tokens wherever
    chunked and single-step logits agree; ``temperature > 0`` runs
    speculative SAMPLING, distributed as target-only sampling through
    the same filter stack, from per-request streams (the admission seed
    takes stream position 0, round ``r`` position ``1 + r``) — the JAX
    batcher's tokens.

    ``chunk`` counts ROUNDS per host sync: one round commits 1 to k+1
    tokens per live slot. ``rounds_executed`` counts rounds;
    ``steps_executed`` counts target positions verified per slot,
    ``rounds * (k+1)``. The host keeps bounds of each row's frontier
    (the lowest and the highest it can have reached), which bound the
    blockwise cache walk without reading the card.

    Shared prefixes admit through :func:`spec_prefix_admit_rows`: the
    draft keeps its own per-slot K/V, so each resident prefix carries a
    draft template too, computed locally at install (a shipped template
    carries the target's K/V only). A rolling cache is rejected (the
    verify is a chunk)."""

    #: stream position 0 is the admission seed draw; rounds start at 1
    _off0 = 1

    def __init__(self, params, cfg: T.TransformerConfig, draft_params,
                 draft_cfg: T.TransformerConfig, batch: int, max_len: int,
                 num_speculative: int = 4, eos_id: int | None = None,
                 chunk: int = 4, temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, seed: int = 0, shared_prefix=None,
                 pipeline: bool = True,
                 bucketed_admission: bool = True) -> None:
        if num_speculative < 1:
            raise ValueError("num_speculative must be >= 1")
        _check_draft_vocab(cfg, draft_cfg)
        _check_no_ring(cfg, "speculative serving (chunked verify)")
        _check_no_ring(draft_cfg, "speculative serving (draft)")
        super().__init__(params, cfg, batch, max_len, eos_id=eos_id,
                         chunk=chunk, temperature=temperature, top_k=top_k,
                         top_p=top_p, seed=seed,
                         shared_prefix=shared_prefix, pipeline=pipeline,
                         bucketed_admission=bucketed_admission)
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        # the draft needs its own prefix template (its K/V dims differ)
        self._draft_prefix_template = (
            prefix_template(draft_params, self.shared_prefix, draft_cfg)
            if self.shared_prefix else None)
        self.k = num_speculative
        self.d_cache = init_kv_cache(draft_cfg, batch, max_len,
                                     device=self.device)
        self.d_cache["length"] = torch.zeros((batch,), dtype=torch.int32,
                                             device=self.device)
        #: per slot, the committed token whose K/V is not yet written
        #: (replaces the greedy batcher's per-slot logits)
        self.pending = torch.zeros((batch,), dtype=torch.long,
                                   device=self.device)
        #: upper bounds of the rows' frontiers (``_host_len`` holds the
        #: lower bounds)
        self._host_hi = [0] * batch

    def _chunk_tokens_max(self) -> int:
        # one sync = chunk rounds x up to k+1 commits per row
        return self.chunk * (self.k + 1)

    def _set_host_len(self, rows, lens) -> None:
        super()._set_host_len(rows, lens)
        for row, n in zip(rows, lens):
            if row < self.batch:
                self._host_hi[row] = int(n)

    def _build_entry(self, prefix_id: str, tokens: list,
                     template: dict) -> PrefixEntry:
        # the draft template is computed here, before the entry is
        # published: a half-built entry must never be resolvable
        return PrefixEntry(
            prefix_id, tokens, template,
            draft_template=prefix_template(self.draft_params, tokens,
                                           self.draft_cfg))

    def _draft_template_of(self, entry):
        if entry is not None:
            return entry.draft_template
        return self._draft_prefix_template

    def _admit_rows(self, rows, toks, lens, keys, entry=None) -> None:
        seed_keys = (None if keys is None
                     else to_device(prng.fold_in(keys, 0).numpy(),
                                    self.device))
        template, p_len = self._template_of(entry)
        toks_d = to_device(toks, self.device)
        lens_d = to_device(lens, self.device)
        if template is not None:
            self.cache, self.d_cache, self.pending = spec_prefix_admit_rows(
                self.params, self.draft_params, self.cache, self.d_cache,
                self.pending, rows, template,
                self._draft_template_of(entry), toks_d, lens_d, seed_keys,
                self.cfg, self.draft_cfg, self.temperature, self.top_k,
                self.top_p)
        else:
            self.cache, self.d_cache, self.pending = spec_admit_rows(
                self.params, self.draft_params, self.cache, self.d_cache,
                self.pending, rows, toks_d, lens_d, seed_keys, self.cfg,
                self.draft_cfg, self.temperature, self.top_k, self.top_p)
        self._set_host_len(rows, lens + p_len)

    def _admit_packages(self, pairs, pkgs) -> None:
        # refused on purpose: a speculative slot needs the DRAFT model's
        # per-slot K/V history too, which a KV shipment does not carry
        raise NotImplementedError(
            "speculative serving is not supported in disaggregated "
            "mode (the shipment carries no draft-model cache)")

    def _validate_package(self, pkg, max_new: int) -> None:
        self._admit_packages(None, None)

    def _admit_row(self, row: int, req: int, prompt) -> None:
        key = (to_device(prng.fold_in(self._req_key(req), 0).numpy(),
                         self.device) if self.sampled else None)
        entry = prompt.entry if isinstance(prompt, _PrefixHit) else None
        seq = to_device(np.asarray([self._seq_of(prompt)], np.int64),
                        self.device)
        template, p_len = self._template_of(entry)
        if template is not None:
            self.cache, self.d_cache, self.pending = spec_prefix_admit_row(
                self.params, self.draft_params, self.cache, self.d_cache,
                self.pending, row, template,
                self._draft_template_of(entry), seq, key, self.cfg,
                self.draft_cfg, self.temperature, self.top_k, self.top_p)
        else:
            self.cache, self.d_cache, self.pending = spec_admit_row(
                self.params, self.draft_params, self.cache, self.d_cache,
                self.pending, row, seq, key, self.cfg, self.draft_cfg,
                self.temperature, self.top_k, self.top_p)
        self._set_host_len([row], [p_len + seq.shape[1]])

    def _issue(self):
        with self.phase_times.phase("dispatch"):
            keys = offs = None
            if self.sampled:
                keys = to_device(self._row_keys.numpy(), self.device)
                offs = to_device(np.asarray(self._row_off, np.int64),
                                 self.device)
            packed, self.cache, self.d_cache, self.pending = spec_step_rows(
                self.params, self.draft_params, self.cache, self.d_cache,
                self.pending, keys, offs, self.chunk, self.cfg,
                self.draft_cfg, self.k, self.temperature, self.top_k,
                self.top_p, lengths=(min(self._host_len),
                                     max(self._host_hi)))
        self.rounds_executed += self.chunk
        self.steps_executed += self.chunk * (self.k + 1)
        self._host_len = [n + self.chunk for n in self._host_len]
        self._host_hi = [n + self.chunk * (self.k + 1)
                         for n in self._host_hi]
        self._row_off = [o + self.chunk for o in self._row_off]
        return packed

    def _fetch(self, handle):
        with self.phase_times.phase("fetch"):
            packed = handle.cpu().numpy()              # [n, B, k+2]
        return [[int(t) for i in range(packed.shape[0])
                 for t in packed[i, row, 1:1 + packed[i, row, 0]]]
                for row in range(self.batch)]

    def _retire(self, mask) -> None:
        super()._retire(mask)
        self.d_cache = retire_rows(self.d_cache, mask)
        for r, m in enumerate(mask):
            if m:
                self._host_hi[r] = 0


class EngineBusy(RuntimeError):
    """Explicit overload shed: the engine refused to QUEUE a
    standard/batch submission past its bounded queue depth. A statement
    about load, not about the request — the same submit is expected to
    succeed once pressure clears; ``retry_after_ms`` is the backoff hint
    (the BUSY frame's payload)."""

    def __init__(self, retry_after_ms: int) -> None:
        super().__init__(
            f"engine overloaded; retry after {retry_after_ms} ms")
        self.retry_after_ms = int(retry_after_ms)


class _EngineRequest:
    """Engine-side record of one live request. ``stream`` is its rng
    stream index (submission order unless pinned); ``budget`` counts
    REMAINING tokens; ``rng_skip`` the stream positions a previous
    placement consumed; ``history`` every token an evictable
    (batch-class) request has emitted since its submission, which a
    preemption folds into ``base_prompt``, the prompt as submitted
    (``base_skip`` its submitted stream offset)."""

    __slots__ = ("rid", "prompt", "budget", "stream", "rng_skip",
                 "emitted", "done", "reason", "t_submit", "t_last",
                 "span", "queued_span", "first_span", "cls", "history",
                 "base_prompt", "base_skip")

    def __init__(self, rid, prompt, budget: int, stream: int,
                 t_submit: float, rng_skip: int = 0,
                 cls: str = "standard") -> None:
        self.rid = rid
        self.prompt = prompt
        self.budget = budget
        self.stream = stream
        self.rng_skip = rng_skip
        self.emitted = 0
        self.done = False
        self.reason: str | None = None
        self.t_submit = t_submit
        self.t_last = t_submit
        self.cls = cls
        self.history: list | None = None
        self.base_prompt = prompt
        self.base_skip = rng_skip
        # engine.request (submit→retire) with children engine.queued
        # (submit→slot admit) and engine.first_token (admit→first delta)
        self.span = tracing.NOOP_SPAN
        self.queued_span = tracing.NOOP_SPAN
        self.first_span = tracing.NOOP_SPAN


class ServeEngine:
    """Open-loop serving engine: the issue/fetch/consume/settle loop of a
    :class:`ContinuousBatcher` against LIVE admission queues.

    - :meth:`submit` / :meth:`cancel` are thread-safe and callable while
      :meth:`run` is live.
    - ``on_delta(rid, tokens)`` fires when a chunk's tokens for a request
      are consumed; TTFT and inter-token histograms observe there.
    - ``on_retired(rid, reason, n_tokens, final_tokens)`` fires once per
      request, reason ``"eos"``/``"budget"``/``"cancelled"``/
      ``"stopped"``; an eos/budget retirement carries its LAST delta in
      ``final_tokens`` instead of ``on_delta``. A preempted batch row
      does not retire: it is reincarnated under the same rid.
    - :meth:`drain` stops accepting and lets :meth:`run` return once
      every accepted request has retired; :meth:`stop` aborts.

    QoS, as the JAX engine's: every submission carries a class —
    ``interactive`` / ``standard`` / ``batch`` — with one queue per class
    (admission drains them in that order), per-class slot floors
    (``class_floors``, the ``tony.serve.slots.*`` keys: a class past its
    floor takes a free slot only while the remaining free slots cover
    every other class's unmet floor), interactive-over-batch preemption
    (the batch row with the fewest emitted tokens is evicted; its prompt
    plus emitted tokens re-queue at the front of the batch queue with the
    stream offset advanced, so it resumes where it stopped), and the
    BUSY shed (:class:`EngineBusy` for a standard/batch submit once
    ``max_queue_depth`` requests wait; 0 disables; interactive always
    queues). Classless callers land as ``standard``.

    A cancelled (or preempted) occupant is only marked done; its slot
    frees when the next consumed chunk crosses it. Deltas and eos/budget
    retirements fire on the thread driving :meth:`run`; a cancel's
    retirement fires on the cancelling thread. One engine run per
    batcher at a time; creating the engine resets the batcher's
    per-serve state (step count, phase times, rng streams).
    """

    def __init__(self, batcher: ContinuousBatcher, on_delta=None,
                 on_retired=None, registry=None,
                 class_floors: dict | None = None,
                 max_queue_depth: int = 128, busy_retry_ms: int = 250,
                 latency_buckets=None) -> None:
        if getattr(batcher, "_engine_running", False):
            raise RuntimeError("batcher is already driven by a live "
                               "engine")
        self.b = batcher
        self.on_delta = on_delta
        self.on_retired = on_retired
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        #: rids waiting for a slot, FIFO per class; a preemption
        #: reincarnation goes to the FRONT of the batch queue
        self._waitq: dict[str, collections.deque] = {
            c: collections.deque() for c in QOS_CLASSES}
        self._floors = {c: 0 for c in QOS_CLASSES}
        for c, n in (class_floors or {}).items():
            if c not in self._floors:
                raise ValueError(f"unknown QoS class in floors: {c!r}")
            self._floors[c] = max(0, min(int(n), batcher.batch))
        if sum(self._floors.values()) > batcher.batch:
            raise ValueError(f"class floors {self._floors} exceed "
                             f"{batcher.batch} decode slots")
        self._max_queue_depth = max(0, int(max_queue_depth))
        self._busy_retry_ms = max(0, int(busy_retry_ms))
        self._reqs: dict = {}                    # rid -> _EngineRequest
        self._occupant: list[_EngineRequest | None] = \
            [None] * batcher.batch
        self._draining = False
        self._stopped = False
        self._next_stream = 0
        #: host counts of this engine's preemptions and BUSY sheds
        self.preemptions = 0
        self.shed = 0
        batcher.steps_executed = 0
        batcher.rounds_executed = 0
        batcher.phase_times = PhaseTimes()
        batcher._reset_streams()
        reg = registry or metrics_mod.get_default()
        self._reg = reg
        buckets = (metrics_mod.TIME_BUCKETS_S if latency_buckets is None
                   else tuple(latency_buckets))
        self._admitted_c = reg.counter(
            "tony_serve_requests_admitted_total",
            help="requests admitted into cache slots")
        self._retired_c = reg.counter(
            "tony_serve_requests_retired_total",
            help="requests retired (eos or budget)")
        self._cancelled_c = reg.counter(
            "tony_serve_requests_cancelled_total",
            help="requests cancelled before completion")
        self._tokens_c = reg.counter("tony_serve_tokens_total",
                                     help="useful generated tokens")
        self._qdepth_g = reg.gauge("tony_serve_queue_depth",
                                   help="requests waiting for a free slot")
        self._ttft_h = reg.histogram(
            "tony_serve_ttft_seconds",
            help="submit -> first consumed token delta (time to first "
                 "token, engine-side)", buckets=buckets)
        self._itl_h = reg.histogram(
            "tony_serve_intertoken_seconds",
            help="mean per-token gap of each consumed delta after a "
                 "request's first (inter-token latency, engine-side)",
            buckets=buckets)
        self._qdepth_by_cls = {
            c: reg.gauge("tony_serve_queue_depth",
                         help="requests waiting for a free slot",
                         **{"class": c}) for c in QOS_CLASSES}
        self._ttft_by_cls = {
            c: reg.histogram("tony_serve_ttft_seconds", buckets=buckets,
                             **{"class": c}) for c in QOS_CLASSES}
        self._itl_by_cls = {
            c: reg.histogram("tony_serve_intertoken_seconds",
                             buckets=buckets, **{"class": c})
            for c in QOS_CLASSES}
        self._preempt_c = reg.counter(
            "tony_serve_preemptions_total",
            help="batch rows evicted-to-queue for an interactive "
                 "admission (the stream resumes token-identically)")
        self._shed_c = {
            c: reg.counter("tony_serve_shed_total",
                           help="submissions refused with BUSY past the "
                                "bounded queue depth", **{"class": c})
            for c in QOS_CLASSES}
        self._prefill_tok_c = reg.counter(
            "tony_serve_prefill_tokens_total",
            help="true prompt/suffix tokens run through a prefill or "
                 "extend forward at admission (the prefill-FLOPs proxy "
                 "the prefix fast path shrinks)")
        self._prefix_tok_c = reg.counter(
            "tony_serve_prefix_tokens_total",
            help="prefix positions satisfied by a resident-template "
                 "COPY instead of a forward (prefix-aware serving)")
        self._prefix_admits_c = reg.counter(
            "tony_serve_prefix_admits_total",
            help="admissions that went through a resident prefix "
                 "template (only suffix tokens ran the model)")
        self._qdepth_g.set(0)
        for g in self._qdepth_by_cls.values():
            g.set(0)

    # --- thread-safe control surface ---

    def submit(self, rid, prompt, max_new_tokens: int,
               trace_ctx: dict | None = None,
               prefix_id: str | None = None, rng: tuple | None = None,
               request_class: str = "standard") -> None:
        """Enqueue a request under caller-chosen id ``rid`` (must not
        collide with a LIVE request's). Raises ``ValueError`` for an
        un-servable request or an unknown class, ``RuntimeError`` once
        draining, and :class:`EngineBusy` past the queue bound.
        ``prefix_id`` optionally names a resident prefix the prompt
        continues (the ADMIT frame's ``prefix``); the engine also
        auto-matches the prompt against its resident store. A hit
        admits only the SUFFIX through the model; a miss serves
        prefix-blind, never an error. ``trace_ctx`` (``{"tid",
        "sid"}``) joins the engine's spans to the submitter's trace;
        ``rng = (stream, off)`` pins the request's stream index with
        ``off`` positions already consumed."""
        prompt = [int(t) for t in prompt]
        max_new_tokens = int(max_new_tokens)
        if request_class not in QOS_CLASSES:
            raise ValueError(
                f"unknown request class {request_class!r} (expected "
                f"one of {', '.join(QOS_CLASSES)})")
        entry = self.b._resolve_prefix(prefix_id, prompt)
        if entry is None:
            self.b._validate_request(prompt, max_new_tokens)
            payload, attrs = prompt, {}
        else:
            payload = _PrefixHit(entry, prompt[len(entry.tokens):])
            self.b._validate_prefix_hit(payload, max_new_tokens)
            attrs = {"prefix": entry.id}
        self._enqueue(rid, payload, max_new_tokens, trace_ctx, rng=rng,
                      cls=request_class, prompt_tokens=len(prompt),
                      **attrs)

    def submit_prefilled(self, rid, package: KVPackage,
                         max_new_tokens: int,
                         trace_ctx: dict | None = None,
                         request_class: str = "standard") -> None:
        """Enqueue an ALREADY-PREFILLED request (disaggregated serving):
        ``package`` is the :class:`KVPackage` a prefill tier shipped;
        admission lands it with :func:`land_kv_rows` (copies, no model
        forward), so adopting a row never stalls the in-flight decode
        chunk behind a prefill. Otherwise :meth:`submit`'s contract:
        caller-chosen ``rid``, up-front validation
        (:meth:`ContinuousBatcher._validate_package`), ``RuntimeError``
        once draining. The shipped rng stream state rides the package,
        so a sampled stream is the colocated engine's. The class orders
        the decode tier's queue and floors, but a package is never shed
        with BUSY: its prefill is already paid (the prefill tier sheds
        before prefilling)."""
        max_new_tokens = int(max_new_tokens)
        if request_class not in QOS_CLASSES:
            raise ValueError(
                f"unknown request class {request_class!r} (expected "
                f"one of {', '.join(QOS_CLASSES)})")
        self.b._validate_package(package, max_new_tokens)
        self._enqueue(rid, package, max_new_tokens, trace_ctx,
                      cls=request_class, prompt_tokens=package.length,
                      prefilled=True)

    def _enqueue(self, rid, payload, max_new_tokens: int,
                 trace_ctx: dict | None, *, prompt_tokens: int,
                 rng: tuple | None = None, cls: str = "standard",
                 prefilled: bool = False, **span_attrs) -> None:
        """The admission-queue push behind :meth:`submit` and
        :meth:`submit_prefilled`: the drain and duplicate checks, the
        BUSY shed (never for a prefilled package), the request record,
        its span pair and the wakeup — one place, so the two paths
        cannot drift."""
        shed = False
        with self._work:
            if self._draining or self._stopped:
                raise RuntimeError(
                    "engine is draining; not accepting new requests")
            if rid in self._reqs:
                raise ValueError(f"request id {rid!r} is already active")
            if (self._max_queue_depth and cls != "interactive"
                    and not prefilled
                    and self._wait_total_locked() >= self._max_queue_depth):
                shed = True
                self.shed += 1
            else:
                stream = self._next_stream if rng is None else int(rng[0])
                req = _EngineRequest(
                    rid, payload, max_new_tokens, stream,
                    time.perf_counter(),
                    rng_skip=0 if rng is None else int(rng[1]), cls=cls)
                if cls == "batch" and not prefilled:
                    req.history = []       # evictable: folds on eviction
                tr = tracing.get_tracer()
                req.span = tr.start_span("engine.request", ctx=trace_ctx,
                                         prompt_tokens=prompt_tokens,
                                         budget=max_new_tokens,
                                         request_class=cls,
                                         prefilled=prefilled, **span_attrs)
                req.queued_span = tr.start_span("engine.queued",
                                                parent=req.span)
                if rng is None:
                    self._next_stream += 1
                self._reqs[rid] = req
                self._waitq[cls].append(rid)
                self._set_qdepth_locked()
                self._work.notify_all()
        if shed:
            self._shed_c[cls].inc()
            raise EngineBusy(self._busy_retry_ms)

    def _wait_total_locked(self) -> int:
        return sum(len(q) for q in self._waitq.values())

    def _set_qdepth_locked(self) -> None:
        self._qdepth_g.set(self._wait_total_locked())
        for c, q in self._waitq.items():
            self._qdepth_by_cls[c].set(len(q))

    def cancel(self, rid) -> None:
        """Cancel ``rid``; unknown or already-retired ids are no-ops. A
        waiting request retires now; an admitted one is marked done and
        its slot frees at the next consumed chunk."""
        with self._work:
            req = self._reqs.pop(rid, None)
            if req is None or req.done:
                return
            req.done = True
            req.reason = "cancelled"
            try:
                self._waitq[req.cls].remove(rid)
            except ValueError:
                pass          # admitted: the loop's consume frees it
            self._set_qdepth_locked()
            self._work.notify_all()
        self._cancelled_c.inc()
        req.queued_span.end()
        req.first_span.end()
        req.span.end(reason="cancelled", tokens=req.emitted)
        self._emit_retired(req)

    def drain(self) -> None:
        """Reject further submits; :meth:`run` returns once every
        accepted request has retired."""
        with self._work:
            self._draining = True
            self._work.notify_all()

    def stop(self) -> None:
        """Abort: run() returns after at most the in-flight chunk, and
        every outstanding request retires as ``"stopped"``."""
        with self._work:
            self._draining = True
            self._stopped = True
            self._work.notify_all()

    def live_requests(self) -> list:
        """rids accepted and not yet retired (waiting or admitted)."""
        with self._lock:
            return [rid for rid, r in self._reqs.items() if not r.done]

    def stats(self) -> dict:
        """Live occupancy snapshot (the server's STATS payload): the JAX
        engine's keys, plus this engine's preemption and shed counts."""
        with self._lock:
            return {
                "queue_depth": self._wait_total_locked(),
                "queue_depths": {c: len(q)
                                 for c, q in self._waitq.items()},
                "active": sum(1 for r in self._occupant
                              if r is not None and not r.done),
                "slots": self.b.batch,
                "class_floors": dict(self._floors),
                "draining": self._draining,
                "prefill_tokens": self.b.prefill_forward_tokens,
                "prefix_tokens": self.b.prefix_copied_tokens,
                "prefix_admits": self.b.prefix_admits,
                "preemptions": self.preemptions,
                "shed": self.shed,
            }

    # --- the loop (one driving thread) ---

    def run(self) -> None:
        """Drive the engine on the CALLING thread until drained or
        stopped; an idle engine blocks on the admission condition."""
        if getattr(self.b, "_engine_running", False):
            raise RuntimeError("batcher is already driven by an engine")
        self.b._engine_running = True
        try:
            # goodput: the driving thread's wall is "step" but for the
            # blocks in _wait_for_work, which re-enter "idle"
            with goodput_mod.get_ledger().enter("step"):
                if self.b.pipeline:
                    self._run_pipelined()
                else:
                    self._run_sequential()
        finally:
            # seal the engine even on an abnormal exit: late submits must
            # raise rather than enqueue into a dead engine
            with self._work:
                self._draining = True
                self._stopped = True
            self.b._engine_running = False
            self._abort_outstanding("stopped")
            metrics_mod.observe_phase_times(self.b.phase_times, self._reg)

    def _emit_retired(self, req: _EngineRequest, final=()) -> None:
        if self.on_retired is not None:
            self.on_retired(req.rid, req.reason, req.emitted, list(final))

    def _abort_outstanding(self, reason: str) -> None:
        with self._lock:
            doomed = [r for r in self._reqs.values() if not r.done]
            for req in doomed:
                req.done = True
                req.reason = reason
            self._reqs.clear()
            for q in self._waitq.values():
                q.clear()
            self._occupant = [None] * self.b.batch
            self._set_qdepth_locked()
        for req in doomed:
            req.queued_span.end()
            req.first_span.end()
            req.span.end(reason=reason, tokens=req.emitted)
            self._emit_retired(req)

    def _wait_for_work(self) -> bool:
        """Block until there is runnable work (True) or the engine is
        drained-empty / stopped (False). Live occupants count as work."""
        with self._work:
            while True:
                if self._stopped:
                    return False
                if (self._wait_total_locked()
                        or any(r is not None and not r.done
                               for r in self._occupant)):
                    return True
                if self._draining:
                    return False
                with goodput_mod.get_ledger().enter("idle"):
                    self._work.wait()

    def _pop_admissible_locked(self, free: int, occ: dict):
        """The next admissible waiting request in class order under the
        floors. ``free`` counts free slots INCLUDING the one about to be
        granted; ``occ`` is live per-class occupancy including this
        round's admissions."""
        for cls in QOS_CLASSES:
            if occ[cls] >= self._floors[cls]:
                owed = sum(max(0, self._floors[o] - occ[o])
                           for o in QOS_CLASSES if o != cls)
                if free - 1 < owed:
                    continue
            q = self._waitq[cls]
            while q:
                req = self._reqs.get(q.popleft())
                if req is not None and not req.done:
                    return req
        return None

    def _preempt_locked(self) -> tuple[list, list]:
        """Evict batch rows for interactive requests still waiting after
        the fill: the victim (fewest emitted tokens — the cheapest
        re-prefill) is marked done like a cancel (its slot frees at the
        next consumed chunk) and REINCARNATED under the same rid at the
        front of the batch queue — prompt plus emitted tokens as the new
        prompt, stream offset advanced by the emitted count — so it
        resumes where it stopped (token-identically where the re-prefill
        reproduces the decode steps' arithmetic). Slots already vacating
        count against the need, and the batch floor is never evicted
        below. A KV-package victim (a decode tier's adopted row) has no
        prompt to fold: it retires as ``"preempted"`` and the router
        re-places it. Returns ``(requeued, evicted)``."""
        waiting = len(self._waitq["interactive"])
        requeued: list = []
        evicted: list = []
        if not waiting:
            return requeued, evicted
        vacating = sum(1 for r in self._occupant
                       if r is not None and r.done)
        need = waiting - vacating
        while need > 0:
            victims = [r for r in self._occupant
                       if r is not None and not r.done
                       and r.cls == "batch"]
            if len(victims) <= self._floors["batch"]:
                break
            old = min(victims, key=lambda r: r.emitted)
            old.done = True
            old.reason = "preempted"
            if old.history is None:
                self._reqs.pop(old.rid, None)
                evicted.append(old)
                need -= 1
                continue
            # fold the WHOLE history into the prompt as submitted: a
            # reincarnation's own prompt already holds its first history.
            # A prefix hit stays a hit on the same resident entry, so its
            # re-prefill stays suffix-only
            base = old.base_prompt
            if isinstance(base, _PrefixHit):
                payload = _PrefixHit(base.entry,
                                     list(base.suffix) + old.history)
            else:
                payload = list(base) + old.history
            new = _EngineRequest(old.rid, payload, old.budget, old.stream,
                                 old.t_submit,
                                 rng_skip=old.base_skip + old.emitted,
                                 cls="batch")
            new.emitted = old.emitted   # resumed deltas are inter-token
            new.t_last = old.t_last
            new.history = list(old.history)
            new.base_prompt = old.base_prompt
            new.base_skip = old.base_skip
            new.span = old.span         # the same logical request
            old.span = tracing.NOOP_SPAN
            self._reqs[old.rid] = new
            self._waitq["batch"].appendleft(old.rid)
            requeued.append(new)
            need -= 1
        if requeued:
            self._set_qdepth_locked()
        return requeued, evicted

    def _admit_free(self) -> None:
        """Admit waiting requests into every free slot (row order),
        draining the class queues in priority order under the floors,
        then preempt batch rows for interactive requests left waiting.
        The device dispatch runs outside the lock."""
        with self._lock:
            pairs, prompts, admitted = [], {}, []
            occ = {c: 0 for c in QOS_CLASSES}
            free = 0
            for r in self._occupant:
                if r is None:
                    free += 1
                elif not r.done:
                    occ[r.cls] += 1
            for row in range(self.b.batch):
                if self._occupant[row] is not None:
                    continue
                req = self._pop_admissible_locked(free, occ)
                if req is None:
                    break
                self._occupant[row] = req
                occ[req.cls] += 1
                free -= 1
                pairs.append((row, req.stream))
                prompts[req.stream] = req.prompt
                admitted.append(req)
            if admitted:
                self._set_qdepth_locked()
            requeued, evicted = self._preempt_locked()
            self.preemptions += len(requeued) + len(evicted)
        if requeued or evicted:
            self._preempt_c.inc(len(requeued) + len(evicted))
            tr = tracing.get_tracer()
            for new in requeued:
                if new.span.recording:
                    new.queued_span = tr.start_span(
                        "engine.queued", parent=new.span, preempted=True)
            for old in evicted:
                old.first_span.end()
                old.span.end(reason="preempted", tokens=old.emitted)
                self._emit_retired(old)
        if admitted:
            tr = tracing.get_tracer()
            for req in admitted:
                req.queued_span.end()
                if req.span.recording:
                    req.first_span = tr.start_span("engine.first_token",
                                                   parent=req.span)
            b = self.b
            before = (b.prefill_forward_tokens, b.prefix_copied_tokens,
                      b.prefix_admits)
            for req in admitted:
                if req.rng_skip:
                    # consumed by _rebind_streams at this admission
                    b._stream_skip[req.stream] = req.rng_skip
            b._admit_batch(pairs, prompts)
            self._admitted_c.inc(len(admitted))
            # fold the batcher's host accounting into the registry (a
            # concurrent local install's prefill counts here too)
            for c, was, now in zip(
                    (self._prefill_tok_c, self._prefix_tok_c,
                     self._prefix_admits_c), before,
                    (b.prefill_forward_tokens, b.prefix_copied_tokens,
                     b.prefix_admits)):
                if now > was:
                    c.inc(now - was)

    def _consume(self, host_toks, snap) -> None:
        """Apply one fetched chunk under the occupancy it was ISSUED
        with: emit per-request deltas and free completed or cancelled
        rows. Rows whose request already finished carry garbage and are
        discarded."""
        deltas, retired = [], []
        eos = self.b.eos_id
        with self._lock:
            for row, req in enumerate(snap):
                if req is None or req.done:
                    if req is not None and self._occupant[row] is req:
                        self._occupant[row] = None   # cancelled mid-flight
                    continue
                new = []
                for t in host_toks[row]:
                    t = int(t)
                    new.append(t)
                    req.emitted += 1
                    req.budget -= 1
                    if req.budget == 0 or (eos is not None and t == eos):
                        req.done = True
                        req.reason = ("eos" if eos is not None and t == eos
                                      else "budget")
                        self._reqs.pop(req.rid, None)
                        if self._occupant[row] is req:
                            self._occupant[row] = None
                        break
                if new:
                    if req.history is not None:
                        req.history.extend(new)
                    deltas.append((req, new))
                if req.done:
                    retired.append(req)
        now = time.perf_counter()
        appended = 0
        finals = {id(req): new for req, new in deltas if req in retired}
        for req, new in deltas:
            appended += len(new)
            if req.emitted == len(new):      # this is the first delta
                self._ttft_h.observe(now - req.t_submit)
                self._ttft_by_cls[req.cls].observe(now - req.t_submit)
                req.first_span.end()
            else:
                gap = (now - req.t_last) / len(new)
                self._itl_h.observe(gap)
                self._itl_by_cls[req.cls].observe(gap)
            req.t_last = now
            if id(req) not in finals and self.on_delta is not None:
                self.on_delta(req.rid, new)
        if appended:
            self._tokens_c.inc(appended)
        if retired:
            self._retired_c.inc(len(retired))
            for req in retired:
                req.first_span.end()
                req.span.end(reason=req.reason, tokens=req.emitted)
                self._emit_retired(req, finals.get(id(req), ()))

    def _settle(self) -> None:
        self._admit_free()
        # reset ALL unoccupied rows so idle slots never march their
        # garbage frontier off the cache end
        with self._lock:
            idle = [r is None for r in self._occupant]
        if any(idle):
            with self.b.phase_times.phase("retire"):
                self.b._retire(idle)

    def _sweep_done_occupants(self) -> bool:
        """Free slots held by done (cancelled, preempted) occupants when
        no chunk is in flight; returns True when any slot is LIVE."""
        with self._lock:
            live = False
            for row, req in enumerate(self._occupant):
                if req is None:
                    continue
                if req.done:
                    self._occupant[row] = None
                else:
                    live = True
            return live

    def _certainly_final(self) -> bool:
        """The chunk about to be issued provably retires every live
        request with nothing queued — issuing past it would be garbage."""
        with self._lock:
            if self._wait_total_locked():
                return False
            return all(req.budget <= self.b.chunk
                       for req in self._occupant
                       if req is not None and not req.done)

    def _defer_issue(self, snap) -> bool:
        """Process the in-flight chunk BEFORE issuing the next when a
        budget completion is predictable and requests are queued, so the
        admission lands as in the sequential loop."""
        with self._lock:
            return bool(self._wait_total_locked()) and any(
                req is not None and not req.done
                and req.budget <= self.b._chunk_tokens_max()
                for req in snap)

    def _run_pipelined(self) -> None:
        """Double-buffered dispatch: chunk N+1 is enqueued before chunk
        N's fetch blocks."""
        b = self.b
        while self._wait_for_work():
            self._admit_free()
            if not self._sweep_done_occupants():
                self._settle()          # everything cancelled pre-issue
                continue
            inflight = (b._issue(), list(self._occupant))
            while inflight is not None:
                handle, snap = inflight
                nxt = None
                if (not self._stopped and not self._certainly_final()
                        and not self._defer_issue(snap)):
                    nxt = (b._issue(), list(self._occupant))
                self._consume(b._fetch(handle), snap)
                self._settle()
                if self._stopped:
                    return               # drop any in-flight chunk
                with self._lock:
                    occupied = any(r is not None for r in self._occupant)
                if nxt is not None and not occupied:
                    nxt = None           # every row retired: all garbage
                if nxt is None and occupied:
                    nxt = (b._issue(), list(self._occupant))
                inflight = nxt

    def _run_sequential(self) -> None:
        """issue → fetch → bookkeep → admit; the equivalence baseline."""
        b = self.b
        while self._wait_for_work():
            self._admit_free()
            while not self._stopped:
                if not self._sweep_done_occupants():
                    self._settle()
                    break
                snap = list(self._occupant)
                self._consume(b._fetch(b._issue()), snap)
                self._settle()
