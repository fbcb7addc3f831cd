"""Continuous batching for the serving path (greedy), in PyTorch.

Port of ``tony_tpu/models/serve.py``. A fixed batch of cache slots
decodes together; a row retires the chunk it completes and the next
queued request is admitted into its slot while the other rows keep
decoding. The device programs:

- :func:`admit_rows` — BUCKETED, BATCHED admission: K prompts padded to
  one power-of-two length bucket prefill in one forward (attention
  through the CUDA flash kernel on the card) and land in their slots;
- :func:`admit_row` — the single-slot admission (the
  ``bucketed_admission=False`` arm), padded to the same buckets;
- :func:`step_rows` — ``n`` greedy decode steps of every row at its own
  frontier;
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

Not ported yet: sampling, QoS classes with preemption and BUSY
shedding, speculative decoding, shared-prefix templates, disaggregated
prefill/decode, tracing spans and the goodput ledger.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Sequence

import numpy as np
import torch

from tony_tpu_torch.models import transformer as T
from tony_tpu_torch.models.decode import (_check_cache_cfg, decode_step,
                                          init_kv_cache, place_rows,
                                          prefill_rows, to_device)
from tony_tpu_torch.runtime import metrics as metrics_mod
from tony_tpu_torch.runtime.profiler import PhaseTimes

#: Per-call program counters keyed by (program name, shape): one entry
#: per CALL of a device program (eager torch has no trace to count).
CALL_COUNTS: collections.Counter = collections.Counter()

#: smallest bucketed-admission pad length
_MIN_ADMIT_BUCKET = 16


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


@torch.no_grad()
def step_rows(params, cache, logits, n: int, cfg, lengths=None):
    """``n`` greedy decode steps for every row at its OWN frontier.
    ``lengths``: the host's copy of the rows' frontiers before the
    chunk (bounds the blockwise cache walk without reading the card;
    read back from the cache when absent). Returns (tokens ``[B, n]`` on
    the device, cache, logits). Idle rows decode garbage the host
    discards."""
    _count_call("step_rows", (tuple(cache["k"].shape), n))
    toks = []
    for j in range(n):
        tok = logits.argmax(dim=-1)
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
    admitting the next queued request the moment a slot frees. Outputs
    are the greedy tokens :func:`~tony_tpu_torch.models.decode.generate`
    gives each request alone, and match the JAX batcher's tokens and
    ``steps_executed``.

    ``pipeline=True`` (default) enqueues chunk N+1 before fetching chunk
    N; ``pipeline=False`` is the sequential equivalence baseline. Both
    give identical outputs. Admission is bucketed and batched by default
    (``bucketed_admission=False`` admits one row per forward).
    """

    def __init__(self, params, cfg: T.TransformerConfig, batch: int,
                 max_len: int, eos_id: int | None = None, chunk: int = 8,
                 pipeline: bool = True,
                 bucketed_admission: bool = True) -> None:
        _check_cache_cfg(cfg)
        self.params = params
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.device = params["embed"].device
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

    # --- admission (bucketed/batched with a per-row fallback) ---

    def _bucket_for(self, n: int) -> int:
        return bucket_for(n, self.max_len)

    def _marshal_rows(self, pairs) -> np.ndarray:
        """[batch] row targets for admitted (row, request) pairs, padded
        with DISTINCT out-of-range sentinels (their writes drop)."""
        rows = self.batch + np.arange(self.batch, dtype=np.int64)
        for i, (row, _) in enumerate(pairs):
            rows[i] = row
        return rows

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
        :func:`admit_row` per pair when bucketing is off)."""
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
                    toks, lens = self._pad_prompts_to(grp, prompts, bucket)
                    self._admit_rows(self._marshal_rows(grp), toks, lens)
            else:
                for row, req in pairs:
                    self._admit_row(row, prompts[req])
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
            toks, self.cache, self.logits = step_rows(
                self.params, self.cache, self.logits, self.chunk, self.cfg,
                lengths=self._host_len)
        self.steps_executed += self.chunk
        self._host_len = [n + self.chunk for n in self._host_len]
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
        ``max_new_tokens``: one int or a per-request sequence.
        ``self.steps_executed`` counts decode steps run; ``phase_times``
        holds per-phase host wall clock. A thin closed-batch wrapper over
        :class:`ServeEngine`: submit everything, drain, run."""
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


class _EngineRequest:
    """Engine-side record of one live request. ``stream`` is its index in
    submission order (the key of its prompt in an admission wave);
    ``budget`` counts REMAINING tokens."""

    __slots__ = ("rid", "prompt", "budget", "stream", "emitted", "done",
                 "reason", "t_submit", "t_last")

    def __init__(self, rid, prompt, budget: int, stream: int,
                 t_submit: float) -> None:
        self.rid = rid
        self.prompt = prompt
        self.budget = budget
        self.stream = stream
        self.emitted = 0
        self.done = False
        self.reason: str | None = None
        self.t_submit = t_submit
        self.t_last = t_submit


class ServeEngine:
    """Open-loop serving engine: the issue/fetch/consume/settle loop of a
    :class:`ContinuousBatcher` against a LIVE admission queue (one FIFO;
    every submission is the JAX engine's ``standard`` class).

    - :meth:`submit` / :meth:`cancel` are thread-safe and callable while
      :meth:`run` is live.
    - ``on_delta(rid, tokens)`` fires when a chunk's tokens for a request
      are consumed; TTFT and inter-token histograms observe there.
    - ``on_retired(rid, reason, n_tokens, final_tokens)`` fires once per
      request, reason ``"eos"``/``"budget"``/``"cancelled"``/
      ``"stopped"``; an eos/budget retirement carries its LAST delta in
      ``final_tokens`` instead of ``on_delta``.
    - :meth:`drain` stops accepting and lets :meth:`run` return once
      every accepted request has retired; :meth:`stop` aborts.

    A cancelled occupant is only marked done; its slot frees when the
    next consumed chunk crosses it. One engine run per batcher at a time;
    creating the engine resets the batcher's per-serve state.
    """

    def __init__(self, batcher: ContinuousBatcher, on_delta=None,
                 on_retired=None, registry=None) -> None:
        if getattr(batcher, "_engine_running", False):
            raise RuntimeError("batcher is already driven by a live "
                               "engine")
        self.b = batcher
        self.on_delta = on_delta
        self.on_retired = on_retired
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        #: rids waiting for a slot, FIFO
        self._waitq: collections.deque = collections.deque()
        self._reqs: dict = {}                    # rid -> _EngineRequest
        self._occupant: list[_EngineRequest | None] = \
            [None] * batcher.batch
        self._draining = False
        self._stopped = False
        self._next_stream = 0
        batcher.steps_executed = 0
        batcher.phase_times = PhaseTimes()
        reg = registry or metrics_mod.get_default()
        self._reg = reg
        buckets = metrics_mod.TIME_BUCKETS_S
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
        self._prefill_tok_c = reg.counter(
            "tony_serve_prefill_tokens_total",
            help="true prompt tokens run through a prefill forward at "
                 "admission")
        self._qdepth_g.set(0)

    # --- thread-safe control surface ---

    def submit(self, rid, prompt, max_new_tokens: int) -> None:
        """Enqueue a request under caller-chosen id ``rid`` (must not
        collide with a LIVE request's). Raises ``ValueError`` for an
        un-servable request and ``RuntimeError`` once draining."""
        prompt = [int(t) for t in prompt]
        max_new_tokens = int(max_new_tokens)
        self.b._validate_request(prompt, max_new_tokens)
        with self._work:
            if self._draining or self._stopped:
                raise RuntimeError(
                    "engine is draining; not accepting new requests")
            if rid in self._reqs:
                raise ValueError(f"request id {rid!r} is already active")
            req = _EngineRequest(rid, prompt, max_new_tokens,
                                 self._next_stream, time.perf_counter())
            self._next_stream += 1
            self._reqs[rid] = req
            self._waitq.append(rid)
            self._qdepth_g.set(len(self._waitq))
            self._work.notify_all()

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
                self._waitq.remove(rid)
            except ValueError:
                pass          # admitted: the loop's consume frees it
            self._qdepth_g.set(len(self._waitq))
            self._work.notify_all()
        self._cancelled_c.inc()
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
            self._waitq.clear()
            self._occupant = [None] * self.b.batch
            self._qdepth_g.set(0)
        for req in doomed:
            self._emit_retired(req)

    def _wait_for_work(self) -> bool:
        """Block until there is runnable work (True) or the engine is
        drained-empty / stopped (False). Live occupants count as work."""
        with self._work:
            while True:
                if self._stopped:
                    return False
                if self._waitq or any(r is not None and not r.done
                                      for r in self._occupant):
                    return True
                if self._draining:
                    return False
                self._work.wait()

    def _pop_admissible_locked(self):
        while self._waitq:
            req = self._reqs.get(self._waitq.popleft())
            if req is not None and not req.done:
                return req
        return None

    def _admit_free(self) -> None:
        """Admit waiting requests into every free slot, in row order; the
        device dispatch runs outside the lock."""
        with self._lock:
            pairs, prompts, admitted = [], {}, []
            for row in range(self.b.batch):
                if self._occupant[row] is not None:
                    continue
                req = self._pop_admissible_locked()
                if req is None:
                    break
                self._occupant[row] = req
                pairs.append((row, req.stream))
                prompts[req.stream] = req.prompt
                admitted.append(req)
            if admitted:
                self._qdepth_g.set(len(self._waitq))
        if admitted:
            before = self.b.prefill_forward_tokens
            self.b._admit_batch(pairs, prompts)
            self._admitted_c.inc(len(admitted))
            if self.b.prefill_forward_tokens > before:
                self._prefill_tok_c.inc(self.b.prefill_forward_tokens
                                        - before)

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
            else:
                self._itl_h.observe((now - req.t_last) / len(new))
            req.t_last = now
            if id(req) not in finals and self.on_delta is not None:
                self.on_delta(req.rid, new)
        if appended:
            self._tokens_c.inc(appended)
        if retired:
            self._retired_c.inc(len(retired))
            for req in retired:
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
        """Free slots held by done (cancelled) occupants when no chunk is
        in flight; returns True when any slot is LIVE."""
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
            if self._waitq:
                return False
            return all(req.budget <= self.b.chunk
                       for req in self._occupant
                       if req is not None and not req.done)

    def _defer_issue(self, snap) -> bool:
        """Process the in-flight chunk BEFORE issuing the next when a
        budget completion is predictable and requests are queued, so the
        admission lands as in the sequential loop."""
        with self._lock:
            return bool(self._waitq) and any(
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
