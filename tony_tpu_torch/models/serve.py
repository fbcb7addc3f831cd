"""Continuous batching for the serving path, in PyTorch.

Port of ``tony_tpu/models/serve.py``. A fixed batch of cache slots
decodes together; a row retires the chunk it completes and the next
queued request is admitted into its slot while the other rows keep
decoding. The device programs:

- :func:`admit_rows` — BUCKETED, BATCHED admission: K prompts padded to
  one power-of-two length bucket prefill in one forward (attention
  through the CUDA flash kernel on the card) and land in their slots;
- :func:`admit_row` — the single-slot admission (the
  ``bucketed_admission=False`` arm), padded to the same buckets;
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

Not ported yet: speculative decoding, shared-prefix templates (resident
prefixes and the prefix lane), disaggregated prefill/decode
(``submit_prefilled``, ``KVPackage``), rolling caches and the goodput
ledger.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Sequence

import numpy as np
import torch

from tony_tpu_torch.models import transformer as T
from tony_tpu_torch.models.decode import (_check_cache_cfg, _filter_logits,
                                          decode_step, init_kv_cache,
                                          place_rows, prefill_rows,
                                          to_device)
from tony_tpu_torch.ops import prng
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


def _scatter_logits(logits, rows, lg) -> None:
    """``logits[rows[i]] = lg[i]`` in place for the in-range rows (the
    sentinel rows of a partial wave are dropped)."""
    batch = logits.shape[0]
    keep = [i for i, r in enumerate(rows) if 0 <= int(r) < batch]
    if keep:
        src = to_device(np.asarray(keep, np.int64), logits.device)
        dst = to_device(np.asarray([int(rows[i]) for i in keep], np.int64),
                        logits.device)
        logits[dst] = lg[src].to(logits.dtype)


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
    _scatter_logits(logits, rows, lg)
    return cache, logits


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
    (``bucketed_admission=False`` admits one row per forward).
    ``shared_prefix`` is not ported yet and raises.
    """

    #: first per-request stream position consumed by step_rows sampling
    _off0 = 0
    #: rolling caches are not ported; HELLO and STATS report the layout
    _ring = False

    def __init__(self, params, cfg: T.TransformerConfig, batch: int,
                 max_len: int, eos_id: int | None = None, chunk: int = 8,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, seed: int = 0, shared_prefix=None,
                 pipeline: bool = True,
                 bucketed_admission: bool = True) -> None:
        _check_cache_cfg(cfg)
        if shared_prefix is not None:
            raise NotImplementedError(
                "shared-prefix templates are not ported yet")
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        self.params = params
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.device = params["embed"].device
        #: sampling controls (greedy by default); streams are per request
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed)
        #: device steps per host round trip
        self.chunk = max(1, chunk)
        self.pipeline = bool(pipeline)
        self.bucketed_admission = bool(bucketed_admission)
        self.cache = init_kv_cache(cfg, batch, max_len, device=self.device)
        self.cache["length"] = torch.zeros((batch,), dtype=torch.int32,
                                           device=self.device)
        #: host mirror of cache["length"], kept by every admit/step/retire
        self._host_len = [0] * batch
        self.logits = torch.zeros((batch, cfg.vocab_size),
                                  dtype=cfg.logits_storage_dtype,
                                  device=self.device)
        self.steps_executed = 0
        self.phase_times = PhaseTimes()
        #: true prompt tokens run through a prefill forward at admission
        self.prefill_forward_tokens = 0
        #: prefix-template accounting (no templates in the port: 0)
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

    def resident_prefixes(self) -> list:
        """Resident prefix templates: none (not ported)."""
        return []

    # --- admission (bucketed/batched with a per-row fallback) ---

    def _bucket_for(self, n: int) -> int:
        return bucket_for(n, self.max_len)

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
        for one bucket group (entries past the group are inert)."""
        toks = np.zeros((self.batch, bucket), np.int64)
        lens = np.ones((self.batch,), np.int32)
        for i, (_, req) in enumerate(grp):
            p = prompts[req]
            toks[i, :len(p)] = p
            lens[i] = len(p)
        return toks, lens

    def _admit_batch(self, pairs, prompts) -> None:
        """Admit (row, request-index) pairs: group by length bucket and
        land each group with one :func:`admit_rows` (one
        :func:`admit_row` per pair when bucketing is off), then rebind
        the rows' rng streams."""
        if not pairs:
            return
        with self.phase_times.phase("admit"):
            if self.bucketed_admission:
                groups: dict[int, list] = {}
                for row, req in pairs:
                    groups.setdefault(self._bucket_for(len(prompts[req])),
                                      []).append((row, req))
                for bucket in sorted(groups):
                    grp = groups[bucket]
                    rows, keys = self._marshal_wave(grp)
                    toks, lens = self._pad_prompts_to(grp, prompts, bucket)
                    self._admit_rows(rows, toks, lens)
                    self._rebind_streams(grp, rows, keys)
            else:
                for row, req in pairs:
                    self._admit_row(row, prompts[req])
                rows, keys = self._marshal_wave(pairs)
                self._rebind_streams(pairs, rows, keys)
            self.prefill_forward_tokens += sum(len(prompts[req])
                                               for _, req in pairs)

    def _admit_rows(self, rows, toks, lens) -> None:
        self.cache, self.logits = admit_rows(
            self.params, self.cache, self.logits, rows,
            to_device(toks, self.device), to_device(lens, self.device),
            self.cfg)
        for row, n in zip(rows, lens):
            if row < self.batch:
                self._host_len[row] = int(n)

    def _admit_row(self, row: int, prompt) -> None:
        n = len(prompt)
        padded = np.zeros((1, self._bucket_for(n)), np.int64)
        padded[0, :n] = prompt
        self.cache, self.logits = admit_row(
            self.params, self.cache, self.logits, row,
            to_device(padded, self.device), n, self.cfg)
        self._host_len[row] = n

    # --- dispatch / fetch ---

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
        """Reject an empty prompt, a non-positive budget, or prompt +
        budget past ``max_len``."""
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if max_new <= 0:
            raise ValueError(f"max_new_tokens must be positive, "
                             f"got {max_new}")
        if len(prompt) + max_new > self.max_len:
            raise ValueError(f"prompt {len(prompt)} + {max_new} new tokens "
                             f"exceeds max_len {self.max_len}")

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
            help="true prompt tokens run through a prefill forward at "
                 "admission")
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
        draining, :class:`EngineBusy` past the queue bound, and
        ``NotImplementedError`` for a ``prefix_id`` (resident prefixes
        are not ported). ``trace_ctx`` (``{"tid", "sid"}``) joins the
        engine's spans to the submitter's trace; ``rng = (stream, off)``
        pins the request's stream index with ``off`` positions already
        consumed."""
        prompt = [int(t) for t in prompt]
        max_new_tokens = int(max_new_tokens)
        if request_class not in QOS_CLASSES:
            raise ValueError(
                f"unknown request class {request_class!r} (expected "
                f"one of {', '.join(QOS_CLASSES)})")
        if prefix_id is not None:
            raise NotImplementedError(
                "resident prefix templates are not ported yet")
        self.b._validate_request(prompt, max_new_tokens)
        shed = False
        with self._work:
            if self._draining or self._stopped:
                raise RuntimeError(
                    "engine is draining; not accepting new requests")
            if rid in self._reqs:
                raise ValueError(f"request id {rid!r} is already active")
            if (self._max_queue_depth and request_class != "interactive"
                    and self._wait_total_locked() >= self._max_queue_depth):
                shed = True
                self.shed += 1
            else:
                stream = self._next_stream if rng is None else int(rng[0])
                req = _EngineRequest(
                    rid, prompt, max_new_tokens, stream, time.perf_counter(),
                    rng_skip=0 if rng is None else int(rng[1]),
                    cls=request_class)
                if request_class == "batch":
                    req.history = []       # evictable
                tr = tracing.get_tracer()
                req.span = tr.start_span("engine.request", ctx=trace_ctx,
                                         prompt_tokens=len(prompt),
                                         budget=max_new_tokens,
                                         request_class=request_class,
                                         prefilled=False)
                req.queued_span = tr.start_span("engine.queued",
                                                parent=req.span)
                if rng is None:
                    self._next_stream += 1
                self._reqs[rid] = req
                self._waitq[request_class].append(rid)
                self._set_qdepth_locked()
                self._work.notify_all()
        if shed:
            self._shed_c[request_class].inc()
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

    def _preempt_locked(self) -> list:
        """Evict batch rows for interactive requests still waiting after
        the fill: the victim (fewest emitted tokens — the cheapest
        re-prefill) is marked done like a cancel (its slot frees at the
        next consumed chunk) and REINCARNATED under the same rid at the
        front of the batch queue — prompt plus emitted tokens as the new
        prompt, stream offset advanced by the emitted count — so it
        resumes where it stopped (token-identically where the re-prefill
        reproduces the decode steps' arithmetic). Slots already vacating
        count against
        the need, and the batch floor is never evicted below. Returns
        the reincarnations."""
        waiting = len(self._waitq["interactive"])
        requeued: list = []
        if not waiting:
            return requeued
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
            # fold the WHOLE history into the prompt as submitted: a
            # reincarnation's own prompt already holds its first history
            new = _EngineRequest(old.rid,
                                 list(old.base_prompt) + old.history,
                                 old.budget, old.stream, old.t_submit,
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
        return requeued

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
            requeued = self._preempt_locked()
            self.preemptions += len(requeued)
        if requeued:
            self._preempt_c.inc(len(requeued))
            tr = tracing.get_tracer()
            for new in requeued:
                if new.span.recording:
                    new.queued_span = tr.start_span(
                        "engine.queued", parent=new.span, preempted=True)
        if admitted:
            tr = tracing.get_tracer()
            for req in admitted:
                req.queued_span.end()
                if req.span.recording:
                    req.first_span = tr.start_span("engine.first_token",
                                                   parent=req.span)
            b = self.b
            before = b.prefill_forward_tokens
            for req in admitted:
                if req.rng_skip:
                    # consumed by _rebind_streams at this admission
                    b._stream_skip[req.stream] = req.rng_skip
            b._admit_batch(pairs, prompts)
            self._admitted_c.inc(len(admitted))
            if b.prefill_forward_tokens > before:
                self._prefill_tok_c.inc(b.prefill_forward_tokens - before)

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
                and req.budget <= self.b.chunk
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
