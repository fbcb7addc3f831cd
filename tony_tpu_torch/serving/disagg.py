"""Disaggregated prefill/decode serving: KV-shipping prefill gangs
feeding decode gangs over tensor channels.

The port's copy of ``tony_tpu/serving/disagg.py``, on the same wire: a
port prefill tier feeds a JAX decode tier and the reverse, and either
tier serves behind either package's router.

A colocated :class:`~tony_tpu_torch.serving.server.ServingServer` interleaves
prefill and decode dispatches on ONE device queue, so every admission's
prefill stalls the in-flight decode chunk — inter-token latency spikes
with prompt length whenever admissions are concurrent (the TTFT/ITL
histograms can see it; nothing colocated can fix it). Disaggregation
specializes two gangs to the two workloads:

- :class:`PrefillServer` (the prefill tier, STATELESS per request):
  accepts ADMITs, runs the bucketed
  :func:`~tony_tpu_torch.models.serve.prefill_ship_rows` program on waves of
  queued prompts, and ships each row's K/V + last-real logits + rng
  stream state as one :mod:`~tony_tpu_torch.serving.kvship` blob over a
  TONYC1 tensor channel (CH_TENSOR byte-blob frames — bounded window,
  reconnect-with-resume) to the decode gang named in the ADMIT; a
  ``HANDOFF`` frame tells the submitter (the router) which gang adopted
  the row.
- :class:`DecodeServer` (the decode tier): a normal serving engine
  whose admissions arrive as KV packages through its
  :class:`~tony_tpu_torch.channels.channel.ChannelHub` — landing is
  host-to-device copies (:func:`~tony_tpu_torch.models.serve.land_kv_rows`,
  run inside the engine's own admission sweep), never a model forward,
  so decode chunks are NEVER preempted by prefill work. Token
  deltas push to the connection that declared itself the delta sink
  (``BIND`` — the router's link).

Deployed behind :class:`~tony_tpu_torch.serving.router.ServingRouter` in
disaggregated placement mode (``decode_replicas=``): ADMIT goes to the
prefill replica with the shallowest queue, TOKENS stream from the
decode replica that adopted the row, and a decode-replica loss re-
admits its streams through a surviving prefill replica with the
streamed prefix folded into the prompt (the router's failover path —
zero duplicated/dropped tokens, test-pinned).

Token identity (greedy AND sampled) vs the colocated engine is
test-pinned end-to-end across two real processes: both tiers run the
same bucket ladder and the same prefill program at the same row count
(a wave pads to ``max_batch``, the decode tier's slot count in
``serve_lm``), the shipment carries the exact buffers colocated
admission would have landed, and the per-request rng key ships with
them. Speculative serving is EXPLICITLY
not supported disaggregated (the shipment carries no draft-model
cache); shared-prefix templates likewise stay colocated.

Observability: ``tony_prefill_queue_depth`` /
``tony_prefill_requests_total`` (prefill tier),
``tony_kv_ship_seconds`` / ``tony_kv_ship_bytes_total`` (the KV
handoff wall, prefill side), ``tony_kv_land_seconds`` /
``tony_decode_idle_slots`` (decode side), plus the channel plane's
``tony_channel_*`` series. The port's tiers also carry their KV series
in STATS (``series``; the decode tier its ``steps`` and host ``phases``
too), so an operator reads the handoff cost off a remote tier — extra
keys, which the JAX package's clients and router ignore. The request
trace grows a ``kv.ship`` child under the prefill tier's
``engine.request`` span, and the decode tier's ``engine.request``
parents under it — the TTFT decomposition stays causal across the two
gangs.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict, deque

import numpy as np

from tony_tpu_torch.channels.channel import (ChannelClosed, ChannelError,
                                             ChannelHub, ChannelSender)
from tony_tpu_torch.runtime import metrics as metrics_mod
from tony_tpu_torch.runtime import tracing
from tony_tpu_torch.serving import kvship
from tony_tpu_torch.serving import protocol as P
from tony_tpu_torch.serving.prefix import (PrefixHost, fingerprint,
                                           match_prefix)
from tony_tpu_torch.serving.server import FrameConn, FrameServerBase
from tony_tpu_torch.serving.weightstore import (WeightHost, pack_weights,
                                                tree_digest)

log = logging.getLogger(__name__)

#: the channel every KV shipment rides (one hub port per decode task
#: multiplexes by name, so prefill replicas all share it)
KV_CHANNEL = "kvship"


class _PrefillItem:
    """One admitted prompt waiting for (or undergoing) prefill."""

    __slots__ = ("conn", "rid", "prompt", "budget", "decode", "stream",
                 "rng_off", "cancelled", "done", "span", "queued_span",
                 "prefix", "cls")

    def __init__(self, conn: FrameConn, rid: int, prompt: list[int],
                 budget: int, decode: str, stream: int,
                 trace_ctx: dict | None,
                 prefix: str | None = None, rng_off: int = 0,
                 cls: str = "standard") -> None:
        self.conn = conn
        self.rid = rid
        self.prompt = prompt
        self.budget = budget
        self.decode = decode
        self.stream = stream
        #: QoS class: orders the tier's waves (interactive prompts
        #: never wait a wave behind batch) and ships in the KV meta so
        #: the decode tier's class floors apply to the adopted row
        self.cls = cls
        #: stream positions already consumed by a previous placement
        #: (router-coordinated migration): shipped in the KV meta so the
        #: adopting decode row draws its first sample at this offset
        self.rng_off = rng_off
        #: the resident-prefix id this prompt continues (ADMIT's
        #: ``prefix`` field) — resolved against the tier's store at
        #: wave time; a miss just full-prefills
        self.prefix = prefix
        self.cancelled = False
        self.done = False       # a terminal frame (or conn loss) settled it
        tr = tracing.get_tracer()
        # the prefill tier's leg of the request trace: engine.request
        # (role=prefill) ▸ engine.queued ▸ kv.ship; the decode tier's
        # engine.request parents under this one via the shipped context
        self.span = tr.start_span("engine.request", ctx=trace_ctx,
                                  role="prefill",
                                  prompt_tokens=len(prompt),
                                  budget=budget)
        self.queued_span = tr.start_span("engine.queued",
                                         parent=self.span)


class PrefillServer(WeightHost, PrefixHost, FrameServerBase):
    """The prefill tier of disaggregated serving (see module
    docstring). Stateless per request — no persistent KV cache, no
    decode loop: ADMIT → bucketed prefill wave → KV shipment →
    HANDOFF.

    ``max_batch`` rows prefill per wave (padded to exactly that many:
    at the decode tier's slot count the wave runs colocated admission's
    program at its row count); requests are validated against
    ``max_len`` exactly as the decode tier's batcher will (the same
    power-of-two ladder, the same ceiling — a prompt the decode gang
    cannot land is rejected HERE, before any compute). Rolling (ring)
    cache configs take the exact-length
    :func:`~tony_tpu_torch.models.serve.prefill_ship_row` path and ship the
    full capacity ring.

    The tier is a :class:`~tony_tpu_torch.serving.prefix.PrefixHost` too
    (prefix reuse composes with disaggregation): a wave item whose
    prompt continues a resident prefix runs only its SUFFIX through
    the model (:func:`~tony_tpu_torch.models.serve.prefix_ship_rows` against
    the stored template) and ships the full prefix+suffix row — the
    decode gang needs no prefix knowledge. Templates arrive over the
    same install path as the colocated server's (PREFIX ops or a
    peer's template ship); ring configs degrade prefix-blind with one
    warning."""

    def __init__(self, params, cfg, *, max_len: int, seed: int = 0,
                 max_batch: int = 4,
                 bind_host: str = "127.0.0.1", port: int = 0,
                 channel_window: int = 8,
                 ship_timeout_s: float = 30.0, registry=None,
                 weights_version: str | None = None,
                 weights_digest: str | None = None,
                 max_queue_depth: int = 128,
                 busy_retry_ms: int = 250) -> None:
        super().__init__(bind_host, port)
        from tony_tpu_torch.ops import prng

        self.params = params
        #: the device the params (and every wave) live on
        self.device = params["embed"].device
        self.cfg = cfg
        #: the weights generation this tier serves (HELLO/STATS) — the
        #: router's version-pinned placement signal (rolling upgrades)
        self.weights_version = weights_version
        #: content digest of the served weight tree (computed at
        #: start() when not given) — the unversioned pinning fallback
        #: and the peer-pull artifact name (warm scale-up)
        self.weights_digest = weights_digest
        self.max_len = int(max_len)
        self.max_batch = int(max_batch)
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.ship_timeout_s = ship_timeout_s
        self.channel_window = channel_window
        #: overload bound on the tier's wait queue (0 disables): past
        #: it, non-interactive admissions shed with BUSY — prefill is
        #: where the work would be WASTED under overload, so the tier
        #: says no before computing anything
        self.max_queue_depth = int(max_queue_depth)
        self.busy_retry_ms = int(busy_retry_ms)
        self._ring = bool(cfg.kv_cache_capacity)
        self._base_key = prng.PRNGKey(seed)
        self._cv = threading.Condition()
        self._queue: deque[_PrefillItem] = deque()
        self._items: dict[tuple[int, int], _PrefillItem] = {}
        self._inflight = 0
        self._next_stream = 0
        self._senders: dict[str, ChannelSender] = {}
        self._senders_lock = threading.Lock()
        self._worker: threading.Thread | None = None
        reg = registry or metrics_mod.get_default()
        self._reg = reg
        self._qdepth_g = reg.gauge(
            "tony_prefill_queue_depth",
            help="prompts waiting for a prefill wave (the router's "
                 "prefill-tier placement signal)")
        self._reqs_c = reg.counter(
            "tony_prefill_requests_total",
            help="prompts prefilled and shipped by the prefill tier")
        self._ship_h = reg.histogram(
            "tony_kv_ship_seconds",
            help="KV handoff wall per request, prefill side: extract "
                 "+ serialize + channel send + the decode gang's ack")
        self._ship_bytes_c = reg.counter(
            "tony_kv_ship_bytes_total",
            help="KV shipment payload bytes sent to decode gangs")
        self._fwd_tok_c = reg.counter(
            "tony_prefill_forward_tokens_total",
            help="true prompt/suffix tokens run through a prefill or "
                 "extend forward at the prefill tier (the FLOPs proxy "
                 "the prefix fast path shrinks)")
        self._pref_tok_c = reg.counter(
            "tony_prefill_prefix_tokens_total",
            help="prefix positions served from a resident template "
                 "instead of a forward at the prefill tier")
        self._shed_c = {
            c: reg.counter(
                "tony_serve_shed_total",
                help="admissions refused with BUSY under overload",
                **{"class": c})
            for c in P.QOS_CLASSES}
        self._qdepth_g.set(0)
        #: resident prefix templates: id -> (tokens, template). Grown
        #: only; entries immutable — lock-free reads at wave time.
        self._prefix_store: dict[str, tuple] = {}
        self._ring_prefix_warned = False
        self._proto_bufs = None          # lazy layout prototype
        self._init_prefix_host(reg)
        # weights lane shares the prefix hub port (kind-tagged blobs)
        self._init_weight_host(
            reg, exporter=lambda: pack_weights(
                self.params, version=self.weights_version),
            hub=self._prefix_hub)

    # -- resident prefix templates (PrefixHost hooks) -----------------------
    def install_prefix(self, tokens, prefix_id: str | None = None):
        """Compute ``tokens``' K/V template on this tier and make it
        resident; None when degraded (ring layout)."""
        from tony_tpu_torch.models.serve import prefix_template

        tokens = [int(t) for t in tokens]
        if not tokens:
            raise ValueError("prefix tokens must be non-empty")
        if self._ring:
            if not self._ring_prefix_warned:
                self._ring_prefix_warned = True
                log.warning("prefill tier: rolling (ring) caches cannot "
                            "host prefix templates; serving prefix-blind")
            return None
        if len(tokens) + 2 > self.max_len:
            raise ValueError(
                f"prefix of {len(tokens)} tokens leaves no room for a "
                f"suffix + generation under max_len {self.max_len}")
        pid = prefix_id or fingerprint(tokens)
        template = prefix_template(self.params, tokens, self.cfg)
        self._prefix_store[str(pid)] = (tokens, template)
        return str(pid)

    def install_prefix_template(self, meta, bufs) -> str:
        from tony_tpu_torch.models.serve import validate_template_bufs

        if int(meta["vocab"]) != self.cfg.vocab_size:
            raise ValueError(
                f"template vocab {meta['vocab']} != this model's "
                f"{self.cfg.vocab_size} (shipped from a different "
                f"model?)")
        if self._ring:
            raise ValueError("rolling-cache layout cannot host prefix "
                             "templates (degraded prefix-blind)")
        tokens = [int(t) for t in meta["tokens"]]
        if len(tokens) + 2 > self.max_len:
            # same room check as the local install paths: a too-long
            # shipped template would otherwise install, get ADVERTISED
            # (steering the router's prefix placement here), yet never
            # serve a single admissible prompt
            raise ValueError(
                f"prefix of {len(tokens)} tokens leaves no room for a "
                f"suffix + generation under max_len {self.max_len}")
        if self._proto_bufs is None:
            from tony_tpu_torch.models.decode import (_kv_bufs,
                                                      init_kv_cache)
            self._proto_bufs = _kv_bufs(init_kv_cache(
                self.cfg, 1, 1, device=self.device))
        template = validate_template_bufs(self._proto_bufs, tokens, bufs)
        pid = str(meta["id"])
        self._prefix_store[pid] = (tokens, template)
        return pid

    def resident_prefixes(self) -> list:
        return sorted(self._prefix_store)

    def _prefix_blob(self, prefix_id: str) -> bytes:
        entry = self._prefix_store.get(str(prefix_id))
        if entry is None:
            raise ValueError(f"prefix {prefix_id!r} is not resident")
        tokens, template = entry
        return kvship.pack_template(str(prefix_id), tokens, template,
                                    self.cfg.vocab_size)

    def _resolve_item(self, item: _PrefillItem):
        """(tokens, template) the item's prompt continues, or None:
        the explicit ADMIT prefix id first, else the longest resident
        token-boundary match."""
        if self._ring or not self._prefix_store:
            return None
        if item.prefix is not None:
            ent = self._prefix_store.get(item.prefix)
            if (ent is not None and len(ent[0]) < len(item.prompt)
                    and item.prompt[:len(ent[0])] == ent[0]):
                return item.prefix, ent
        entries = list(self._prefix_store.items())
        pid = match_prefix(item.prompt,
                           ((p, e[0]) for p, e in entries))
        return next(((p, e) for p, e in entries if p == pid), None) \
            if pid is not None else None

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> int:
        if self.weights_digest is None:
            try:
                self.weights_digest = tree_digest(self.params)
            except Exception as e:          # noqa: BLE001 — advisory
                log.warning("weights digest not computed: %s", e)
        self._worker = threading.Thread(target=self._work_loop,
                                        name="tony-prefill-worker",
                                        daemon=True)
        self._worker.start()
        self._start_prefix_host()
        self._start_weight_host()
        port = super().start()
        log.info("prefill tier on %s:%s (%d-row waves; prefix lane on "
                 ":%s)", self.bind_host, port, self.max_batch,
                 self.prefix_port)
        return port

    def stop(self) -> None:
        self._stopping.set()
        self._close_listener()
        with self._cv:
            self._cv.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=60)
        self._stop_prefix_host()
        self._stop_weight_host()
        with self._senders_lock:
            senders, self._senders = list(self._senders.values()), {}
        for s in senders:
            s.close(drain=True, timeout=10.0)
        self._close_conns()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)

    # -- frame handling (reader threads) ------------------------------------
    def _hello_payload(self) -> dict:
        return {"v": 1, "role": "prefill", "slots": self.max_batch,
                "prefixes": self.resident_prefixes(),
                "ring": self._ring, "prefix_port": self.prefix_port,
                "weights_version": self.weights_version,
                "weights_digest": self.weights_digest,
                "weight_port": self.weight_port,
                "weights_resident": self.weight_store.resident_digests()}

    def _handle_frame(self, conn: FrameConn, ftype: int, rid: int,
                      payload: bytes) -> None:
        if ftype == P.ADMIT:
            self._admit(conn, rid, payload)
        elif ftype == P.CANCEL:
            self._cancel(conn, rid)
        elif ftype == P.STATS:
            conn.send(P.STATS, 0, P.pack_json(self.stats()))
        elif ftype == P.PREFIX:
            self._handle_prefix_frame(conn, rid, payload)
        elif ftype == P.WEIGHTS:
            self._handle_weights_frame(conn, rid, payload)
        else:
            raise P.ProtocolError(
                f"unexpected frame type {P.FRAME_NAMES.get(ftype, ftype)}"
                f" at the prefill tier")

    def stats(self) -> dict:
        with self._cv:
            depth, active = len(self._queue), self._inflight
            by_cls = {c: 0 for c in P.QOS_CLASSES}
            for it in self._queue:
                by_cls[it.cls] += 1
        return {"queue_depth": depth, "active": active,
                "queue_depths": by_cls,
                "slots": self.max_batch, "role": "prefill",
                "prefixes": self.resident_prefixes(),
                "ring": self._ring,
                "weights_version": self.weights_version,
                "weights_digest": self.weights_digest,
                "weights_resident": self.weight_store.resident_digests(),
                "series": {
                    "tony_kv_ship_seconds": {"count": self._ship_h.count,
                                             "sum": self._ship_h.sum},
                    "tony_kv_ship_bytes_total": self._ship_bytes_c.value,
                    "tony_prefill_requests_total": self._reqs_c.value}}

    def _admit(self, conn: FrameConn, rid: int, payload: bytes) -> None:
        prompt, max_new, _stream = P.parse_admit(payload)
        obj = P.unpack_json(payload)
        decode = P.parse_decode_target(obj)
        if rid == 0:
            raise P.ProtocolError("ADMIT rid must be nonzero")
        err = None
        if decode is None:
            err = ("disaggregated ADMIT must name its decode target "
                   "({'decode': 'host:port'})")
        elif not prompt:
            err = "empty prompt"
        elif max_new <= 0:
            err = f"max_new_tokens must be positive, got {max_new}"
        elif not self._ring and len(prompt) + max_new > self.max_len:
            err = (f"prompt {len(prompt)} + {max_new} new tokens "
                   f"exceeds max_len {self.max_len}")
        if err is not None:
            conn.send(P.ERROR, rid, P.pack_json({"message": err}))
            return
        try:
            cls = P.parse_class(obj)
        except ValueError as e:
            conn.send(P.ERROR, rid, P.pack_json({"message": str(e)}))
            return
        key = (conn.id, rid)
        rng = P.parse_rng(obj)
        # duplicate-rid/BUSY replies go out AFTER the condition is
        # dropped: the send can block on a slow client and every
        # prefill worker waits on this condition (TL001)
        shed = False
        with self._cv:
            duplicate = key in self._items
            if (not duplicate and self.max_queue_depth
                    and cls != "interactive"
                    and len(self._queue) >= self.max_queue_depth):
                # overload shed at the tier where refused work costs
                # nothing yet; interactive admissions ride through —
                # the wave order and the decode tier's preemption are
                # what they paid for
                shed = True
            elif not duplicate:
                item = _PrefillItem(conn, rid, prompt, max_new, decode,
                                    (self._next_stream if rng is None
                                     else int(rng[0])),
                                    P.parse_trace_ctx(obj),
                                    prefix=P.parse_prefix_id(obj),
                                    rng_off=0 if rng is None else int(rng[1]),
                                    cls=cls)
                if rng is None:
                    self._next_stream += 1
                self._items[key] = item
                self._queue.append(item)
                self._qdepth_g.set(len(self._queue))
                self._cv.notify_all()
        if duplicate:
            conn.send(P.ERROR, rid, P.pack_json(
                {"message": f"request id {rid} is already active"}))
            return
        if shed:
            self._shed_c[cls].inc()
            conn.send(P.BUSY, rid, P.pack_json(
                {"retry_after_ms": self.busy_retry_ms}))
            return

    def _cancel(self, conn: FrameConn, rid: int) -> None:
        """Cancel a QUEUED prompt (idempotent; an already-shipped
        request is the decode tier's to cancel — the router fans the
        CANCEL to both tiers)."""
        with self._cv:
            item = self._items.pop((conn.id, rid), None)
            if item is None or item.cancelled:
                return
            item.cancelled = True
            try:
                self._queue.remove(item)
            except ValueError:
                return      # already in a wave; _ship_item retires it
            item.done = True
            self._qdepth_g.set(len(self._queue))
        item.queued_span.end()
        item.span.end(reason="cancelled")
        item.conn.send(P.RETIRED, item.rid, P.pack_json(
            {"reason": "cancelled", "tokens": 0}))

    def _on_conn_closed(self, conn: FrameConn) -> None:
        with self._cv:
            doomed = [it for key, it in list(self._items.items())
                      if it.conn is conn]
            for it in doomed:
                self._items.pop((conn.id, it.rid), None)
                it.cancelled = True
                it.done = True      # conn gone: no terminal frame possible
                try:
                    self._queue.remove(it)
                except ValueError:
                    pass
            self._qdepth_g.set(len(self._queue))
        for it in doomed:
            it.queued_span.end()
            it.span.end(reason="disconnected")

    # -- the prefill worker -------------------------------------------------
    def _take_wave(self) -> list[_PrefillItem] | None:
        with self._cv:
            while not self._queue:
                if self._stopping.is_set():
                    return None
                self._cv.wait(timeout=0.25)
            # the wave takes classes in priority order, FIFO within a
            # class (stable sort): an interactive prompt admitted last
            # still prefills ahead of every waiting batch prompt
            order = {c: i for i, c in enumerate(P.QOS_CLASSES)}
            live = [it for it in self._queue if not it.cancelled]
            live.sort(key=lambda it: order.get(it.cls, len(order)))
            wave = live[:self.max_batch]
            taken = {id(it) for it in wave}
            self._queue = deque(it for it in self._queue
                                if not it.cancelled
                                and id(it) not in taken)
            self._inflight = len(wave)
            self._qdepth_g.set(len(self._queue))
            return wave

    def _work_loop(self) -> None:
        from tony_tpu_torch.models.serve import bucket_for

        while True:
            wave = self._take_wave()
            if wave is None:
                return
            try:
                if self._ring:
                    for item in wave:
                        self._prefill_group([item], 0)
                else:
                    # group by (resident prefix, bucket): a prefix-hit
                    # group pays only its suffixes' prefill compute
                    groups: dict[tuple, list] = {}
                    entries: dict = {None: None}
                    for item in wave:
                        hit = self._resolve_item(item)
                        if hit is None:
                            key = (None,
                                   bucket_for(len(item.prompt),
                                              self.max_len))
                        else:
                            pid, ent = hit
                            entries[pid] = ent
                            cap = self.max_len - len(ent[0])
                            key = (pid,
                                   bucket_for(len(item.prompt)
                                              - len(ent[0]), cap))
                        groups.setdefault(key, []).append(item)
                    for pid, bucket in sorted(
                            groups, key=lambda k: (k[0] or "", k[1])):
                        self._prefill_group(groups[(pid, bucket)],
                                            bucket, entries[pid])
            except Exception as e:  # noqa: BLE001 — thread survival
                # the tier's ONLY worker: an unexpected wave failure
                # must cost this wave, never the thread (a dead worker
                # queues every future admission forever)
                log.exception("prefill wave processing failed")
                # every wave item not yet settled by a terminal frame is
                # doomed — including one a mid-wave CANCEL popped from
                # self._items whose RETIRED was deferred to _ship_item
                # (membership in self._items would miss it)
                for item in [it for it in wave if not it.done]:
                    if item.cancelled:
                        with self._cv:
                            self._items.pop((item.conn.id, item.rid),
                                            None)
                            item.done = True
                        item.queued_span.end()
                        item.span.end(reason="cancelled")
                        item.conn.send(P.RETIRED, item.rid, P.pack_json(
                            {"reason": "cancelled", "tokens": 0}))
                    else:
                        self._fail_item(item,
                                        f"prefill wave failed: {e}")
            finally:
                with self._cv:
                    self._inflight = 0

    def _prefill_group(self, grp: list[_PrefillItem], bucket: int,
                       entry: tuple | None = None) -> None:
        """Prefill one bucket group (padded to ``max_batch`` rows) and
        ship each real row. ``entry`` is a resident-prefix ``(tokens,
        template)`` pair: the group then runs only its SUFFIXES through
        the model (:func:`~tony_tpu_torch.models.serve.prefix_ship_rows`)
        and ships prefix+suffix rows. The wave's logits and each row's
        buffers cross to the host once (one copy a row)."""
        from tony_tpu_torch.models.decode import extract_kv_rows, to_device
        from tony_tpu_torch.models.serve import (prefill_ship_row,
                                                 prefill_ship_rows,
                                                 prefix_ship_rows)

        for item in grp:
            item.queued_span.end()
        try:
            if self._ring:
                (item,) = grp
                lg, mini = prefill_ship_row(
                    self.params,
                    to_device(np.asarray([item.prompt], np.int64),
                              self.device), self.cfg)
                widths = [mini["k"].shape[2]]
                lengths = [len(item.prompt)]
                fwd = len(item.prompt)
            elif entry is not None:
                p_toks, template = entry
                p_len = len(p_toks)
                toks = np.zeros((self.max_batch, bucket), np.int64)
                lens = np.ones((self.max_batch,), np.int32)
                for i, item in enumerate(grp):
                    suffix = item.prompt[p_len:]
                    toks[i, :len(suffix)] = suffix
                    lens[i] = len(suffix)
                lg, mini = prefix_ship_rows(
                    self.params, template, to_device(toks, self.device),
                    to_device(lens, self.device), self.cfg)
                # the shipped row is the FULL prefix+suffix frontier —
                # the decode gang lands it like any other package
                widths = [len(item.prompt) for item in grp]
                lengths = widths
                fwd = sum(len(item.prompt) - p_len for item in grp)
                self._pref_tok_c.inc(p_len * len(grp))
            else:
                toks = np.zeros((self.max_batch, bucket), np.int64)
                lens = np.ones((self.max_batch,), np.int32)
                for i, item in enumerate(grp):
                    toks[i, :len(item.prompt)] = item.prompt
                    lens[i] = len(item.prompt)
                lg, mini = prefill_ship_rows(
                    self.params, to_device(toks, self.device),
                    to_device(lens, self.device), self.cfg)
                widths = [len(item.prompt) for item in grp]
                lengths = widths
                fwd = sum(widths)
            rows = extract_kv_rows(mini, widths)
            lg_host = lg.cpu()
            self._fwd_tok_c.inc(fwd)
        except Exception as e:            # device failure: request-scoped
            log.exception("prefill wave failed")
            for item in grp:
                self._fail_item(item, f"prefill failed: {e}")
            return
        for i, item in enumerate(grp):
            self._ship_item(item, rows[i], lg_host[i], lengths[i])

    def _ship_item(self, item: _PrefillItem, bufs: dict, logits,
                   length: int) -> None:
        from tony_tpu_torch.ops import prng

        if item.cancelled:
            # a CANCEL caught this prompt mid-wave: the prefill compute
            # is sunk, but the row must NOT ship — nothing downstream
            # would ever speak for the rid (the decode tier drops
            # tombstoned packages), so the terminal frame is ours
            with self._cv:
                self._items.pop((item.conn.id, item.rid), None)
                item.done = True
            item.span.end(reason="cancelled")
            item.conn.send(P.RETIRED, item.rid, P.pack_json(
                {"reason": "cancelled", "tokens": 0}))
            return
        t0 = time.perf_counter()
        ship_span = tracing.get_tracer().start_span("kv.ship",
                                                    parent=item.span,
                                                    decode=item.decode)
        key = prng.fold_in(self._base_key, item.stream).numpy().astype(
            np.uint32)
        ctx = item.span.context if item.span.recording else None
        meta = kvship.pack_kv_meta(item.rid, item.budget, length, key,
                                   rng_off=item.rng_off, cls=item.cls,
                                   trace=ctx)
        blob = kvship.pack_shipment(meta, dict(bufs, logits=logits))
        try:
            # sync: HANDOFF transfers the session's fate to the decode
            # gang, so it must not be sent until the gang ACKED the
            # package — an async "success" can be a frame parked in the
            # send window of a dying endpoint, lost with no owner
            self._sender_for(item.decode).send_bytes(
                blob, sync=True, timeout=self.ship_timeout_s)
        except ChannelError as e:
            # the decode gang is unreachable: evict the sender (its seq
            # state would mismatch a restarted hub) and fail the
            # request RETRYABLE — the router re-places it toward a
            # different decode replica instead of erroring the client
            with self._senders_lock:
                s = self._senders.pop(item.decode, None)
            if s is not None:
                s.close(drain=False)
            ship_span.end(error=str(e)[:200])
            self._fail_item(item, f"kv ship to {item.decode} failed: {e}",
                            retryable=True)
            return
        wall = time.perf_counter() - t0
        self._ship_h.observe(wall)
        self._ship_bytes_c.inc(len(blob))
        self._reqs_c.inc()
        ship_span.end(bytes=len(blob))
        item.span.end(reason="handed_off")
        with self._cv:
            self._items.pop((item.conn.id, item.rid), None)
            item.done = True
        item.conn.send(P.HANDOFF, item.rid, P.pack_json(
            {"decode": item.decode, "bytes": len(blob),
             "wall_s": round(wall, 6)}))

    def _fail_item(self, item: _PrefillItem, message: str,
                   retryable: bool = False) -> None:
        """Fail one request back to the submitter. ``retryable`` marks
        a placement fault (the named decode gang unreachable), not a
        request fault — the router re-places those on another decode
        replica instead of surfacing the error to the client."""
        with self._cv:
            self._items.pop((item.conn.id, item.rid), None)
            item.done = True
        item.span.end(reason="error")
        body = {"message": message}
        if retryable:
            body["retryable"] = True
        item.conn.send(P.ERROR, item.rid, P.pack_json(body))

    def _sender_for(self, addr: str) -> ChannelSender:
        with self._senders_lock:
            sender = self._senders.get(addr)
            if sender is None:
                sender = ChannelSender(addr, KV_CHANNEL,
                                       window=self.channel_window,
                                       registry=self._reg)
                self._senders[addr] = sender
            return sender


class DecodeServer(WeightHost, FrameServerBase):
    """The decode tier of disaggregated serving: a
    :class:`~tony_tpu_torch.models.serve.ServeEngine` whose admissions arrive
    as KV shipments through a :class:`ChannelHub` instead of as ADMIT
    prompts — landing is a copy, so decode chunks are never
    preempted by prefill compute (see module docstring).

    Wire surface: ``BIND`` declares the delta sink (the router's link;
    last BIND wins), ``CANCEL``/``STATS`` work as on a colocated
    server, and ``ADMIT`` is refused — prompts belong at the prefill
    tier. The HELLO advertises ``channel_port`` (or
    ``channel_advertise`` when the hub sits behind NAT/a proxy) so the
    router can hand prefill replicas this gang's shipment endpoint."""

    def __init__(self, batcher, *, bind_host: str = "127.0.0.1",
                 port: int = 0, channel_port: int = 0,
                 channel_capacity: int = 8,
                 channel_advertise: int | None = None,
                 registry=None,
                 weights_version: str | None = None,
                 weights_digest: str | None = None,
                 class_floors: dict | None = None,
                 latency_buckets=None) -> None:
        super().__init__(bind_host, port)
        from tony_tpu_torch.models.serve import ServeEngine

        self.weights_version = weights_version
        #: content digest of the served weight tree (computed at
        #: start() when not given) — see the colocated server
        self.weights_digest = weights_digest

        if getattr(batcher, "d_cache", None) is not None:
            raise ValueError(
                "speculative serving is not supported in disaggregated "
                "mode (the KV shipment carries no draft-model cache)")
        if batcher.shared_prefix is not None:
            raise ValueError(
                "shared-prefix serving stays colocated (prefix "
                "templates do not ride the KV shipment)")
        self.batcher = batcher
        self._reg = registry or metrics_mod.get_default()
        # no max_queue_depth here: the decode tier never sheds a
        # landed package — the prefill work is already paid; overload
        # is refused upstream where refusing is still free
        self.engine = ServeEngine(batcher, on_delta=self._on_delta,
                                  on_retired=self._on_retired,
                                  registry=registry,
                                  class_floors=class_floors,
                                  latency_buckets=latency_buckets)
        self.hub = ChannelHub(port=channel_port,
                              capacity=channel_capacity,
                              registry=self._reg)
        self.channel_advertise = channel_advertise
        self._lock = threading.Lock()
        self._sink: FrameConn | None = None
        #: rids cancelled before their shipment landed: a late-arriving
        #: package for one is DROPPED, not adopted into a slot that
        #: would generate into the void (bounded — old tombstones age
        #: out; a rid reused after 4096 later cancels is a router bug)
        self._tombstones: OrderedDict[int, bool] = OrderedDict()
        self._engine_thread: threading.Thread | None = None
        self._land_thread: threading.Thread | None = None
        self._land_h = self._reg.histogram(
            "tony_kv_land_seconds",
            help="KV handoff wall per request, decode side: unpack + "
                 "validate + engine adoption")
        self._idle_g = self._reg.gauge(
            "tony_decode_idle_slots",
            help="decode slots with no live occupant (awaiting KV "
                 "arrivals — the decode tier's headroom signal)")
        self._idle_g.set(batcher.batch)
        # weights lane multiplexes on the KV hub (kind-tagged blobs:
        # a shipment cannot be misread as an artifact or vice versa)
        self._init_weight_host(
            self._reg, exporter=lambda: pack_weights(
                self.batcher.params, version=self.weights_version),
            hub=self.hub)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> int:
        if self.weights_digest is None:
            try:
                self.weights_digest = tree_digest(self.batcher.params)
            except Exception as e:          # noqa: BLE001 — advisory
                log.warning("weights digest not computed: %s", e)
        self._engine_thread = threading.Thread(
            target=self.engine.run, name="tony-decode-engine",
            daemon=True)
        self._engine_thread.start()
        self.hub.start()
        self._start_weight_host()
        self._land_thread = threading.Thread(
            target=self._land_loop, name="tony-decode-land", daemon=True)
        self._land_thread.start()
        port = super().start()
        log.info("decode tier on %s:%s (%d slots; kv channel on :%s)",
                 self.bind_host, port, self.batcher.batch, self.hub.port)
        return port

    def stop(self, drain: bool = False,
             drain_timeout_s: float = 600.0) -> None:
        self._close_listener()
        if drain:
            self.engine.drain()
        else:
            self._stopping.set()
            self.engine.stop()
        if self._engine_thread is not None:
            self._engine_thread.join(
                timeout=drain_timeout_s if drain else 60)
            if self._engine_thread.is_alive():
                log.warning("decode tier: engine did not %s; aborting",
                            "drain" if drain else "stop")
                self.engine.stop()
                self._engine_thread.join(timeout=60)
        self._stopping.set()
        self.hub.stop()
        self._stop_weight_host()
        if self._land_thread is not None:
            self._land_thread.join(timeout=10)
        self._close_conns()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)

    def kill(self) -> None:
        """Abrupt replica loss: sever everything first (the router sees
        EOF immediately), then abort the engine — the disaggregated
        failover drill."""
        self._stopping.set()
        self._close_listener()
        self._close_conns()
        self.hub.stop()
        self._stop_weight_host()
        self.engine.stop()
        if self._engine_thread is not None:
            self._engine_thread.join(timeout=60)
        if self._land_thread is not None:
            self._land_thread.join(timeout=10)

    # -- frame handling (reader threads) ------------------------------------
    def _hello_payload(self) -> dict:
        return {"v": 1, "role": "decode", "slots": self.batcher.batch,
                "channel_port": (self.channel_advertise
                                 if self.channel_advertise is not None
                                 else self.hub.port),
                "weights_version": self.weights_version,
                "weights_digest": self.weights_digest,
                "weight_port": self.weight_port,
                "weights_resident": self.weight_store.resident_digests()}

    def _handle_frame(self, conn: FrameConn, ftype: int, rid: int,
                      payload: bytes) -> None:
        if ftype == P.BIND:
            with self._lock:
                self._sink = conn
        elif ftype == P.CANCEL:
            with self._lock:
                self._tombstones[rid] = True
                while len(self._tombstones) > 4096:
                    self._tombstones.popitem(last=False)
            self.engine.cancel(rid)
        elif ftype == P.STATS:
            st = dict(self.engine.stats(), role="decode",
                      channel_port=self.hub.port,
                      weights_version=self.weights_version,
                      weights_digest=self.weights_digest,
                      weights_resident=self.weight_store.resident_digests(),
                      steps=self.batcher.steps_executed,
                      phases=self.batcher.phase_times.summary(),
                      series={"tony_kv_land_seconds": {
                          "count": self._land_h.count,
                          "sum": self._land_h.sum}})
            conn.send(P.STATS, 0, P.pack_json(st))
        elif ftype == P.WEIGHTS:
            self._handle_weights_frame(conn, rid, payload)
        elif ftype in (P.ADMIT, P.POLL):
            conn.send(P.ERROR, rid, P.pack_json(
                {"message": "decode tier takes KV shipments, not "
                            "prompts — ADMIT at the prefill tier"}))
        else:
            raise P.ProtocolError(
                f"unexpected frame type {P.FRAME_NAMES.get(ftype, ftype)}"
                f" at the decode tier")

    def _on_conn_closed(self, conn: FrameConn) -> None:
        """Sink loss == our front door died: cancel every live adopted
        request so its slot frees (the router re-admits each stream
        through a surviving path; generating into a dead link helps
        no one)."""
        with self._lock:
            was_sink = self._sink is conn
            if was_sink:
                self._sink = None
        if was_sink:
            for rid in self.engine.live_requests():
                self.engine.cancel(rid)

    # -- the landing thread -------------------------------------------------
    def _land_loop(self) -> None:
        receiver = self.hub.receiver(KV_CHANNEL)
        while not self._stopping.is_set():
            try:
                blob = receiver.recv_bytes(timeout=0.25)
            except ChannelClosed:
                # hub stopped: nothing can EVER arrive again on this
                # receiver — exit, instead of hot-spinning on instant
                # failures and starving the engine + frame threads
                return
            except ChannelError:
                continue                    # timeout; re-check stopping
            except P.ProtocolError as e:
                log.warning("decode tier: non-shipment channel frame "
                            "dropped: %s", e)
                continue
            try:
                self._land(blob)
            except Exception as e:      # noqa: BLE001 — thread survival
                # a malformed shipment must cost only ITSELF, never the
                # landing thread (a dead lander silently starves every
                # future adoption)
                log.exception("decode tier: KV shipment landing failed; "
                              "dropped")
                tracing.get_flight().record("kv_shipment_rejected",
                                            error=str(e)[:500])

    def _land(self, blob: bytes) -> None:
        from tony_tpu_torch.models.serve import KVPackage

        t0 = time.perf_counter()
        try:
            meta, bufs = kvship.unpack_shipment(blob)
            meta = kvship.parse_kv_meta(meta)
            logits = bufs.pop("logits", None)
            if logits is None or len(logits.shape) != 1:
                raise P.ProtocolError("shipment carries no [V] logits")
        except (P.ProtocolError, ValueError) as e:
            log.warning("decode tier: malformed KV shipment dropped: %s",
                        e)
            tracing.get_flight().record("kv_shipment_rejected",
                                        error=str(e)[:500])
            return
        rid = meta["rid"]
        with self._lock:
            dropped = self._tombstones.pop(rid, None)
        if dropped:
            # cancelled before arrival: drop the package — but the
            # cancel still needs its terminal frame, and nothing else
            # will ever speak for this rid (the engine never saw it)
            self._push(rid, [(P.RETIRED, P.pack_json(
                {"reason": "cancelled", "tokens": 0}))])
            return
        pkg = KVPackage(bufs, meta["length"], logits, meta["rng"],
                        meta["rng_off"])
        trace_ctx = (P.parse_trace_ctx({"trace": meta["trace"]})
                     if "trace" in meta else None)
        try:
            self.engine.submit_prefilled(rid, pkg, meta["budget"],
                                         trace_ctx=trace_ctx,
                                         request_class=meta["class"])
        except (ValueError, RuntimeError) as e:
            log.warning("decode tier: shipment for rid %s rejected: %s",
                        rid, e)
            self._push(rid, [(P.ERROR,
                              P.pack_json({"message": str(e)}))])
            return
        with self._lock:
            # a CANCEL racing this landing can tombstone + engine-cancel
            # BETWEEN the tombstone check above and the submit — its
            # engine.cancel no-oped (the rid was not admitted yet), so
            # re-check now that it is: the cancel must win, not a full
            # budget streamed to a client that asked for death
            cancelled_late = self._tombstones.pop(rid, None)
        if cancelled_late:
            self.engine.cancel(rid)
            return
        self._land_h.observe(time.perf_counter() - t0)
        self._update_idle()

    # -- engine callbacks ---------------------------------------------------
    def _update_idle(self) -> None:
        st = self.engine.stats()
        self._idle_g.set(max(0, st["slots"] - st["active"]))

    def _push(self, rid: int, frames: list) -> None:
        with self._lock:
            sink = self._sink
        if sink is None:
            return
        if not sink.send_many([(t, rid, p) for t, p in frames]):
            # close WITHOUT clearing _sink: the conn's reader thread
            # fires _on_conn_closed, which must still see this conn AS
            # the sink to run its live-request cancel sweep — clearing
            # first would skip the sweep and leave every adopted row
            # generating into the void
            sink.close()

    def _on_delta(self, rid, toks) -> None:
        self._push(rid, [(P.TOKENS, P.pack_tokens(toks))])

    def _on_retired(self, rid, reason: str, n_tokens: int,
                    final_tokens) -> None:
        frames = []
        if final_tokens:
            # the final delta and the retirement share one kernel write
            # (the colocated server's atomic-final contract — what the
            # router's failover reads an unfinished stream off)
            frames.append((P.TOKENS, P.pack_tokens(final_tokens)))
        frames.append((P.RETIRED, P.pack_json(
            {"reason": reason, "tokens": n_tokens})))
        self._push(rid, frames)
        self._update_idle()
