"""Serving router: one front door, N replica serving hosts.

The port's copy of ``tony_tpu/serving/router.py``, on the same TONYS1
wire: it routes the port's replicas, the JAX package's, or both at once
(one weights digest, one fleet).

The router speaks the TONYS1 streaming protocol on BOTH sides — clients
connect to it exactly as they would to a single
:class:`~tony_tpu_torch.serving.server.ServingServer`, and it holds one
persistent link per replica. Per session it:

- **places** by load: the replica whose last-reported
  ``tony_serve_queue_depth`` gauge + busy slots (the STATS frame, read
  straight off the replica's metrics registry)
  is smallest, tie-broken by the router's own not-yet-reported
  assignment count so a burst of admissions spreads before the next
  stats refresh;
- **streams** replica deltas through to the client as they land,
  remembering every token it forwarded;
- **health-checks** replicas: a STATS ping per interval, with link EOF
  / errors marking a replica down immediately and 3 consecutive
  UNANSWERED pings marking a hung-but-connected one down (unanswered
  pings, not wall-clock staleness — the router's own scheduling stalls
  must not down healthy replicas);
- **fails over** on replica loss: every unfinished session re-admits on
  a surviving replica with the already-streamed prefix folded into the
  prompt (``prompt + streamed``) and the remaining budget — greedy
  continuations are token-identical, so the client sees no duplicated
  and no dropped tokens (test-enforced).

**Disaggregated placement mode** (``decode_replicas=``): the replica
set splits into a prefill tier and a decode tier — ADMIT goes to the
prefill replica with the shallowest queue (naming a decode replica's
channel endpoint as the KV shipment target), TOKENS stream from the
decode replica that adopted the row, and the failover contract above
extends across the split: a decode loss re-prefills unfinished streams
through a surviving prefill replica. See
:mod:`tony_tpu_torch.serving.disagg`.

**Fleet operations** (planned, not reactive — the drain/upgrade path):
:meth:`ServingRouter.drain` fences a replica against new placements
and LIVE-MIGRATES every session off it: each stream re-admits on a
survivor with the streamed prefix folded into the prompt and its rng
stream pinned (the ADMIT ``rng`` field), the OLD replica keeps
streaming until the new placement's first delta ACKs the takeover,
then a CANCEL tombstones the old half — zero duplicated and zero
dropped tokens, greedy AND sampled, colocated AND disaggregated
(test-pinned). Replicas advertise a ``weights_version`` in
HELLO/STATS; placement prefers a session's pinned version when any
same-version replica survives, which is what makes drain-by-drain
rolling weight upgrades session-transparent. :meth:`add_replicas` /
:meth:`remove_replica` change fleet membership live. The ``DRAIN`` and
``MIGRATE`` frames expose drain / single-session migration to remote
operator clients.

Router-side series (default registry): ``tony_router_replica_up`` /
``tony_router_replica_queue_depth`` (gauges, ``replica=host:port``),
``tony_router_sessions_total{replica=...}``,
``tony_router_failovers_total``, ``tony_router_handoffs_total``,
``tony_router_migrations_total``, ``tony_router_drains_total``,
``tony_router_place_seconds``.

The router never touches the model stack: it imports no ``torch`` at
module level, nor does anything it imports, so it is deployable on a
gateway host with no model stack.
"""

from __future__ import annotations

import itertools
import logging
import socket
import threading
import time

from tony_tpu_torch.conf.keys import (ROUTER_DEFAULTS,
                                      ROUTER_HEALTH_INTERVAL_MS_KEY,
                                      ROUTER_MAX_MISSED_PINGS_KEY)
from tony_tpu_torch.runtime import metrics as metrics_mod
from tony_tpu_torch.serving import protocol as P
from tony_tpu_torch.serving.prefix import fingerprint, match_prefix
from tony_tpu_torch.serving.server import FrameConn, FrameServerBase

log = logging.getLogger(__name__)

#: first rng stream index the router hands out — 0, matching what an
#: engine's own submission counter would assign the same admissions in
#: the same order. That keeps the serving identity contract (routed
#: sampled output == the colocated engine's, bit-for-bit, test-pinned)
#: while making streams unique FLEET-wide instead of per-replica. A
#: direct client bypassing a routed replica can share a stream index
#: with a routed session — a sampling correlation, never a correctness
#: issue, and no worse than the per-replica counters it replaces.
ROUTER_STREAM_BASE = 0

#: how many replica BUSY sheds one batch session rides out via router
#: re-queue before the shed propagates to the client. The cap exists to
#: end the game when EVERY replica is shedding — by then the fleet is
#: saying "come back later" and the client should hear it.
BUSY_REQUEUE_CAP = 3


class _ReplicaLink:
    """One persistent connection to a replica server, with a reader
    thread dispatching its pushed frames back into the router.
    ``role`` is the tier this link fronts: ``"engine"`` (a colocated
    ServingServer), ``"prefill"``, or ``"decode"`` (disaggregated
    mode)."""

    def __init__(self, addr: str, router: "ServingRouter",
                 role: str = "engine") -> None:
        self.addr = addr
        self.role = role
        self._router = router
        host, _, port = addr.rpartition(":")
        self._sock = socket.create_connection((host, int(port)),
                                              timeout=10)
        P.set_nodelay(self._sock)
        self._sock.settimeout(None)
        self._send_lock = threading.Lock()
        self.alive = True
        #: last STATS-reported load (queue_depth + active slots)
        self.reported_load = 0
        self.last_stats = time.monotonic()
        #: health pings sent without a reply since the last one. Health
        #: is judged on THIS, not on wall time since the last reply — a
        #: wall-clock threshold also counts the router's own scheduling
        #: stalls (GC, an in-process model build) and would down every
        #: healthy replica at once after one long stall.
        self.pings_unanswered = 0
        #: sessions assigned here and not yet retired (router-side)
        self.assigned = 0
        #: fenced against NEW placements (a drain in progress) — live
        #: sessions keep streaming until their migration ACKs
        self.draining = False
        self._sock.sendall(P.MAGIC)
        hello = P.recv_frame(self._sock)
        if hello is None or hello[0] != P.HELLO:
            self._sock.close()
            raise ConnectionError(f"replica {addr}: no HELLO")
        self.hello = P.unpack_json(hello[2])
        #: the decode tier's channel-hub endpoint port (what prefill
        #: replicas are told to ship this gang's KV packages to)
        self.channel_port = self.hello.get("channel_port")
        #: resident shared-prefix templates this replica advertised
        #: (HELLO at connect, refreshed by every STATS reply) — what
        #: prefix-aware placement reads
        self.prefixes = self._parse_prefixes(self.hello)
        #: rolling-cache layout: positional prefix templates cannot be
        #: resident here — the router places prefix traffic on it
        #: PREFIX-BLIND (one warning, never an error)
        self.ring = bool(self.hello.get("ring"))
        #: the weights generation this replica advertised (HELLO,
        #: refreshed by STATS) — version-pinned placement (rolling
        #: upgrades) keys on it; None = unversioned
        self.weights_version = self.hello.get("weights_version")
        #: the content digest of the served weight tree (HELLO,
        #: refreshed by STATS) — when the operator never named a
        #: version, the digest IS the generation: sessions pin on it,
        #: so an unversioned rolling upgrade still never mixes weight
        #: generations mid-stream
        self.weights_digest = self.hello.get("weights_digest")
        if self.weights_version is None and isinstance(
                self.weights_digest, str):
            self.weights_version = self.weights_digest
        self.slots = int(self.hello.get("slots", 0) or 0)
        #: decode slots with no live occupant per the last STATS — the
        #: equal-queue-depth placement tiebreak
        self.idle_slots = self.slots
        #: per-class waiting counts from the replica's last STATS
        #: (class-aware engines report ``queue_depths``); a classless
        #: replica never populates it and everything falls back to the
        #: aggregate load gauge
        self.queue_depths: dict[str, int] = {}
        got_role = self.hello.get("role")
        if role != "engine" and got_role != role:
            self._sock.close()
            raise ConnectionError(
                f"replica {addr} reports role {got_role!r}; the "
                f"disaggregated router expected a {role!r} tier there")
        self._reader = threading.Thread(
            target=self._read_loop, name=f"tony-router-link-{addr}",
            daemon=True)
        self._reader.start()

    def send(self, ftype: int, rid: int, payload: bytes = b"") -> bool:
        with self._send_lock:
            if not self.alive:
                return False
            try:
                P.send_frame(self._sock, ftype, rid, payload)
                return True
            except OSError:
                return False

    def _read_loop(self) -> None:
        router = self._router
        try:
            while True:
                frame = P.recv_frame(self._sock)
                if frame is None:
                    break
                ftype, rid, payload = frame
                if ftype == P.TOKENS:
                    router._replica_delta(self, rid,
                                          P.unpack_tokens(payload))
                elif ftype == P.RETIRED:
                    obj = P.unpack_json(payload)
                    router._replica_retired(
                        self, rid, obj.get("reason", "unknown"))
                elif ftype == P.ERROR:
                    obj = P.unpack_json(payload)
                    msg = obj.get("message", "error")
                    if rid == 0:
                        break               # replica dropped our link
                    router._replica_error(self, rid, msg,
                                          retryable=bool(
                                              obj.get("retryable")))
                elif ftype == P.HANDOFF:
                    router._replica_handoff(self, rid,
                                            P.unpack_json(payload))
                elif ftype == P.BUSY:
                    obj = P.unpack_json(payload)
                    router._replica_busy(
                        self, rid,
                        int(obj.get("retry_after_ms", 0) or 0))
                elif ftype == P.STATS:
                    obj = P.unpack_json(payload)
                    self.reported_load = (int(obj.get("queue_depth", 0))
                                          + int(obj.get("active", 0)))
                    if "slots" in obj:
                        self.slots = int(obj.get("slots", 0) or 0)
                    self.idle_slots = max(
                        0, self.slots - int(obj.get("active", 0)))
                    got_d = obj.get("queue_depths")
                    if isinstance(got_d, dict):
                        self.queue_depths = {
                            c: int(n) for c, n in got_d.items()
                            if c in P.QOS_CLASSES
                            and isinstance(n, int)
                            and not isinstance(n, bool)}
                    if "weights_digest" in obj:
                        self.weights_digest = obj.get("weights_digest")
                    if "weights_version" in obj:
                        got_v = obj.get("weights_version")
                        if got_v is None and isinstance(
                                self.weights_digest, str):
                            got_v = self.weights_digest
                        self.weights_version = got_v
                    if "prefixes" in obj:
                        got = self._parse_prefixes(obj)
                        if got != self.prefixes:
                            # residency gauges refresh only on an
                            # actual change, not every health ping
                            self.prefixes = got
                            router._refresh_prefix_residency()
                    self.last_stats = time.monotonic()
                    self.pings_unanswered = 0
                    router._note_stats(self)
        except (P.ProtocolError, OSError):
            pass
        router._replica_down(self)

    @staticmethod
    def _parse_prefixes(obj: dict) -> set:
        got = obj.get("prefixes")
        if not isinstance(got, list):
            return set()
        return {p for p in got if isinstance(p, str) and len(p) <= 128}

    def close(self) -> None:
        self.alive = False
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


class _Migration:
    """One in-flight coordinated migration: a SECOND placement of a
    live session, started while the old one keeps streaming. The first
    delta from the new placement is the ACK — ownership swaps there,
    the regenerated overlap (tokens the old side streamed after the
    snapshot) is discarded count-exactly (token-identical by the rng
    pin), and a CANCEL tombstones the old half."""

    __slots__ = ("snap_len", "new_link", "new_prefill", "new_rrid",
                 "acked", "discard", "handed_off")

    def __init__(self, snap_len: int, new_link, new_prefill,
                 new_rrid: int) -> None:
        #: len(streamed) at the snapshot the new ADMIT carried
        self.snap_len = snap_len
        self.new_link = new_link        # token link of the new placement
        self.new_prefill = new_prefill  # its prefill half (disagg)
        self.new_rrid = new_rrid
        self.acked = False
        #: regenerated overlap tokens still to drop from the new stream
        self.discard = 0
        #: the NEW placement's HANDOFF was observed pre-ACK (disagg)
        self.handed_off = False


class _RouterSession:
    __slots__ = ("conn", "crid", "prompt", "budget", "streamed", "link",
                 "prefill_link", "handed_off", "rrid", "cancelled",
                 "trace_ctx", "prefix_id", "stream", "pinned_version",
                 "migrating", "wlock", "cls", "t_submit", "t_last",
                 "busy_retries")

    def __init__(self, conn: FrameConn, crid: int, prompt: list[int],
                 budget: int, trace_ctx: dict | None = None,
                 prefix_id: str | None = None, stream: int = 0,
                 cls: str = "standard") -> None:
        self.conn = conn
        self.crid = crid
        self.prompt = prompt
        self.budget = budget
        #: the session's QoS class, forwarded on EVERY placement
        #: (initial, failover, migration) so replica-side floors and
        #: queue priority follow the session wherever it lands
        self.cls = cls
        #: admission wall-clock + last-delta wall-clock: the router's
        #: own per-class TTFT/intertoken series (0.0 = no delta yet).
        #: The router measures what the CLIENT experiences — replica
        #: queueing, placement retries, and BUSY re-queues included —
        #: which replica-side series by construction cannot see.
        self.t_submit = time.monotonic()
        self.t_last = 0.0
        #: replica BUSY sheds this session already rode out (batch
        #: re-queue is capped — past the cap the shed propagates)
        self.busy_retries = 0
        #: the fleet-unique rng stream this session is pinned to — every
        #: placement (initial, failover, migration) forwards it with the
        #: already-streamed count as the offset, so SAMPLED
        #: continuations are token-identical across replicas
        self.stream = stream
        #: weights_version of the first placement: later placements
        #: prefer same-version replicas while any survive (rolling
        #: upgrades migrate tier-by-tier without mixing generations
        #: mid-stream); continuity beats pinning when none do
        self.pinned_version = None
        #: the in-flight coordinated migration, if any
        self.migrating: _Migration | None = None
        #: per-session delta ORDER lock: the old and new placements'
        #: deltas forward from different link reader threads around the
        #: ACK swap — append+send must be atomic per delta or the client
        #: could see positions out of order. Lock order: wlock, then
        #: the router lock; never the reverse.
        self.wlock = threading.Lock()
        #: the shared prefix this session continues (ADMIT's prefix
        #: field, or the router's tokenized match): prefix-aware
        #: placement prefers replicas where it is resident, and the id
        #: is forwarded on every replica ADMIT — including failover
        #: re-placements (a cold survivor just full-prefills)
        self.prefix_id = prefix_id
        self.streamed: list[int] = []       # every token forwarded
        #: the link TOKENS flow from: the replica itself (colocated) or
        #: the DECODE link of a disaggregated placement pair
        self.link: _ReplicaLink | None = None
        #: disaggregated mode only: the prefill link the ADMIT went to;
        #: once ``handed_off`` (the HANDOFF frame), losing it no longer
        #: affects this session — the row lives on the decode gang
        self.prefill_link: _ReplicaLink | None = None
        self.handed_off = False
        self.rrid = 0
        #: the client asked for this session's death; a failover must
        #: finish it as cancelled, never resurrect it on a survivor
        self.cancelled = False
        #: the client's span context, forwarded on every replica ADMIT
        #: (including failover re-placements) so the engine's spans join
        #: the client's trace across the router hop
        self.trace_ctx = trace_ctx


class ServingRouter(FrameServerBase):
    """Front-door spreading streaming sessions across replica serving
    hosts. ``replicas``: ``["host:port", ...]`` of running
    :class:`~tony_tpu_torch.serving.server.ServingServer` instances.

    DISAGGREGATED placement mode (``decode_replicas=``): ``replicas``
    becomes the PREFILL tier
    (:class:`~tony_tpu_torch.serving.disagg.PrefillServer`) and
    ``decode_replicas`` the decode tier
    (:class:`~tony_tpu_torch.serving.disagg.DecodeServer`). A placement is
    then a PAIR — the ADMIT goes to the least-loaded prefill replica
    (queue depth, the STATS gauge) naming the least-loaded decode
    replica's channel endpoint as the KV shipment target; TOKENS stream
    back over the decode replica's link (the router BINDs itself as
    each decode replica's delta sink). A ``HANDOFF`` frame moves the
    session's fate off the prefill link; losing a DECODE replica
    re-admits its unfinished streams through a surviving prefill
    replica with the streamed prefix folded into the prompt — the same
    zero-dup/zero-drop failover contract as colocated replica loss
    (test-pinned)."""

    def __init__(self, replicas, bind_host: str = "127.0.0.1",
                 port: int = 0, health_interval_s: float | None = None,
                 decode_replicas=None, registry=None,
                 prefixes=None, max_missed_pings: int | None = None) -> None:
        super().__init__(bind_host, port)
        self._replica_addrs = list(replicas)
        self._decode_addrs = list(decode_replicas or [])
        self._disagg = bool(self._decode_addrs)
        if not self._replica_addrs:
            raise ValueError("router needs at least one replica")
        self._lock = threading.Lock()
        self._links: list[_ReplicaLink] = []
        self._sessions: dict[tuple[int, int], _RouterSession] = {}
        self._by_rrid: dict[int, _RouterSession] = {}
        self._next_rrid = itertools.count(1)
        self._next_stream = itertools.count(ROUTER_STREAM_BASE)
        self._downed: set[int] = set()      # id()s of links already torn
        # health knobs (tony.router.health-interval-ms /
        # tony.router.max-missed-pings): kwargs override the config
        # defaults — the sim harness runs hundreds of replicas at
        # millisecond cadence through exactly these
        if health_interval_s is None:
            health_interval_s = float(
                ROUTER_DEFAULTS[ROUTER_HEALTH_INTERVAL_MS_KEY]) / 1000.0
        self.health_interval_s = health_interval_s
        self.max_missed_pings = (
            int(ROUTER_DEFAULTS[ROUTER_MAX_MISSED_PINGS_KEY])
            if max_missed_pings is None else int(max_missed_pings))
        self._health_thread: threading.Thread | None = None
        self._stopped = False               # stop() ran (idempotence)
        #: the prefix-matching catalog: id -> token list. ADMITs naming
        #: no prefix are matched here (longest proper token-boundary
        #: prefix); residency still comes from the replicas' own
        #: advertisements, so a stale catalog can only cost fast-path
        #: hits, never correctness.
        self._prefix_catalog: dict[str, list[int]] = {}
        self._ring_warned: set[str] = set()
        reg = registry or metrics_mod.get_default()
        self._reg = reg
        self._failovers_c = reg.counter(
            "tony_router_failovers_total",
            help="sessions re-admitted after a replica loss")
        self._handoffs_c = reg.counter(
            "tony_router_handoffs_total",
            help="prefill->decode KV handoffs observed (disaggregated "
                 "placement mode)")
        self._prefix_hits_c = reg.counter(
            "tony_router_prefix_hits_total",
            help="prefix-naming sessions placed on a replica where the "
                 "prefix KV is already resident")
        self._prefix_misses_c = reg.counter(
            "tony_router_prefix_misses_total",
            help="prefix-naming sessions placed prefix-blind (no live "
                 "replica had the prefix resident)")
        self._migrations_c = reg.counter(
            "tony_router_migrations_total",
            help="planned session migrations completed (ownership "
                 "swapped to the new placement with zero dup/drop)")
        self._drains_c = reg.counter(
            "tony_router_drains_total",
            help="replica drains completed (fence + migrate-all; "
                 "zero-session drains count too)")
        self._busy_requeued_c = reg.counter(
            "tony_router_busy_requeues_total",
            help="batch sessions re-placed after a replica shed them "
                 "with BUSY (the client never saw the shed)")
        self._preempt_requeued_c = reg.counter(
            "tony_router_preempt_requeues_total",
            help="sessions re-placed after a decode-tier preemption "
                 "eviction (the row could not fold back replica-side)")
        # the router's own per-class latency series share the engine's
        # names: in a shared-registry process the series are literally
        # shared (get-or-create), and on a model-free gateway host the
        # router is the ONLY producer — the fleet dashboard reads one
        # name either way
        self._ttft_by_cls = {
            c: reg.histogram(
                "tony_serve_ttft_seconds",
                help="time to first streamed token",
                **{"class": c})
            for c in P.QOS_CLASSES}
        self._itl_by_cls = {
            c: reg.histogram(
                "tony_serve_intertoken_seconds",
                help="gap between consecutive streamed tokens",
                **{"class": c})
            for c in P.QOS_CLASSES}
        self._cls_depth_g = {
            c: reg.gauge(
                "tony_router_class_queue_depth",
                help="fleet-wide waiting requests of the class (sum of "
                     "the replicas' per-class STATS depths)",
                **{"class": c})
            for c in P.QOS_CLASSES}
        self._place_h = reg.histogram(
            "tony_router_place_seconds",
            help="wall time of one placement decision + forwarded "
                 "ADMIT (initial admissions; the router's tail-latency "
                 "signal under migration storms)")
        self._up_g = {}
        self._depth_g = {}
        self._placed_c = {}
        self._resident_g: dict[str, object] = {}
        if prefixes:
            # after the registry fields: register_prefix refreshes the
            # residency gauges
            for pid, toks in dict(prefixes).items():
                self.register_prefix(toks, prefix_id=pid)

    # -- lifecycle ----------------------------------------------------------
    def _connect(self, role: str, addr: str) -> _ReplicaLink:
        """Create one replica link (and its per-replica metric series).
        Gauges BEFORE the link: the link's reader thread may run
        _replica_down (instant replica death) the moment the link
        exists, and that path writes these gauges."""
        self._up_g[addr] = self._reg.gauge(
            "tony_router_replica_up",
            help="1 while the replica link is healthy", replica=addr)
        self._depth_g[addr] = self._reg.gauge(
            "tony_router_replica_queue_depth",
            help="replica's last-reported tony_serve_queue_depth "
                 "+ busy slots", replica=addr)
        self._placed_c[addr] = self._reg.counter(
            "tony_router_sessions_total",
            help="sessions placed on the replica", replica=addr)
        self._up_g[addr].set(1)
        link = _ReplicaLink(addr, self, role=role)
        self._warn_if_ring(link)
        if role == "decode":
            if link.channel_port is None:
                link.close()
                raise ConnectionError(
                    f"decode replica {addr} advertised no "
                    f"channel_port — not a DecodeServer?")
            # we are this gang's delta sink: every KV-adopted row's
            # TOKENS/RETIRED frames push down this link
            link.send(P.BIND, 0)
        return link

    def start(self) -> int:
        roles = ([("prefill" if self._disagg else "engine", a)
                  for a in self._replica_addrs]
                 + [("decode", a) for a in self._decode_addrs])
        for role, addr in roles:
            self._links.append(self._connect(role, addr))
        self._refresh_prefix_residency()
        port = super().start()
        self._health_thread = threading.Thread(
            target=self._health_loop, name="tony-router-health",
            daemon=True)
        self._health_thread.start()
        log.info("router on %s:%s over %d replicas", self.bind_host,
                 port, len(self._links))
        return port

    # -- prefix catalog -----------------------------------------------------
    def register_prefix(self, tokens, prefix_id: str | None = None) -> str:
        """Add a shared prefix to the matching catalog (callable before
        or after :meth:`start`, and remotely via the ``PREFIX``
        ``register`` op); returns its id — the content fingerprint
        unless given, so it names the same prefix the replicas
        installed. Bounded like the template wire codec: ids cap at
        128 chars and token lists at ``kvship.MAX_TEMPLATE_TOKENS``
        (the register op is remote-reachable; an unbounded catalog
        would grow router memory AND every unnamed ADMIT's match
        cost)."""
        from tony_tpu_torch.serving.kvship import MAX_TEMPLATE_TOKENS

        tokens = [int(t) for t in tokens]
        if not tokens:
            raise ValueError("prefix tokens must be non-empty")
        if len(tokens) > MAX_TEMPLATE_TOKENS:
            raise ValueError(
                f"prefix of {len(tokens)} tokens exceeds the "
                f"{MAX_TEMPLATE_TOKENS}-token cap — a prefix is a "
                f"system prompt, not a corpus")
        if prefix_id is not None and (
                not isinstance(prefix_id, str)
                or not 0 < len(prefix_id) <= 128):
            raise ValueError(f"prefix id must be a 1..128-char string, "
                             f"got {prefix_id!r}")
        pid = prefix_id if prefix_id else fingerprint(tokens)
        self._prefix_catalog[pid] = tokens
        self._refresh_prefix_residency()
        return pid

    def _warn_if_ring(self, link: _ReplicaLink) -> None:
        """A rolling-cache replica can never host a resident prefix —
        say so ONCE and keep placing on it prefix-blind (graceful
        degradation, never an error)."""
        if link.ring and link.addr not in self._ring_warned:
            self._ring_warned.add(link.addr)
            log.warning(
                "router: replica %s serves a rolling (ring) cache; "
                "prefix-aware placement is disabled for it "
                "(prefix-blind)", link.addr)

    def _refresh_prefix_residency(self) -> None:
        """Recompute the per-prefix residency gauges
        (``tony_router_prefix_resident_replicas{prefix=...}``) over
        the LIVE links' advertisements."""
        links = list(self._links)       # snapshot vs concurrent callers
        pids = set(self._prefix_catalog)
        for link in links:
            pids |= link.prefixes
        for pid in pids:
            g = self._resident_g.get(pid)
            if g is None:
                g = self._resident_g[pid] = self._reg.gauge(
                    "tony_router_prefix_resident_replicas",
                    help="live replicas advertising this prefix's KV "
                         "template as resident", prefix=pid)
            g.set(sum(1 for l in links
                      if l.alive and pid in l.prefixes))

    # -- fleet membership (rolling upgrades) --------------------------------
    def add_replicas(self, addrs, role: str | None = None) -> None:
        """Connect new replicas into a RUNNING fleet (the rolling
        upgrade's first step: stand the new-version tier up next to the
        old one). ``role`` defaults to the fleet's token tier
        (``engine`` colocated, ``prefill`` disaggregated); pass
        ``"decode"`` to grow that tier. A replica that refuses the
        handshake raises — nothing is half-added."""
        role = role or ("prefill" if self._disagg else "engine")
        for addr in addrs:
            link = self._connect(role, addr)
            with self._lock:
                self._links.append(link)
            target = (self._decode_addrs if role == "decode"
                      else self._replica_addrs)
            if addr not in target:
                target.append(addr)
        self._refresh_prefix_residency()

    def remove_replica(self, addr: str) -> int:
        """Disconnect ``addr`` from the fleet (the rolling upgrade's
        last step, after :meth:`drain` emptied it). Sessions still on
        it — a drain skipped or timed out — go through the
        crash-failover re-placement, so removal is never worse than the
        replica dying. Returns the number of links removed."""
        with self._lock:
            victims = [l for l in self._links if l.addr == addr]
            for l in victims:
                self._links.remove(l)
        for l in victims:
            l.close()
            self._replica_down(l)
        for addrs in (self._replica_addrs, self._decode_addrs):
            while addr in addrs:
                addrs.remove(addr)
        self._refresh_prefix_residency()
        return len(victims)

    def stop(self) -> None:
        """Stop the router. Idempotent — a second stop is a no-op. Any
        session still live (including mid-migration) is swept into a
        terminal client ERROR before its connection closes: a stop
        racing an in-flight migration must never strand a stream
        without exactly one terminal frame."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
        self._stopping.set()
        self._close_listener()
        for link in list(self._links):
            link.close()
        with self._lock:
            doomed = list(self._sessions.values())
            self._sessions.clear()
            self._by_rrid.clear()
        for s in doomed:
            s.conn.send(P.ERROR, s.crid,
                        P.pack_json({"message": "router stopping"}))
        self._close_conns()
        if self._health_thread is not None:
            self._health_thread.join(timeout=5)
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)

    # -- placement ----------------------------------------------------------
    @staticmethod
    def _load_key(link: _ReplicaLink):
        """Placement order: the load gauge first (the metrics-plane
        signal), then — at EQUAL queue depths — the link with more
        idle decode slots (headroom that admits without queueing),
        then the router's own not-yet-reported assignment count
        (spreads a burst between stats refreshes)."""
        return (link.reported_load, -link.idle_slots, link.assigned)

    def _pick_link(self, exclude=None, role: str | None = None,
                   prefer_prefix: str | None = None,
                   prefer_version=None, cls: str = "standard"):
        """Least-loaded live, non-draining link of ``role``.
        ``exclude`` is one link or an iterable of links (a migration
        storm / multi-replica failure excludes a SET). Preference
        order: ``prefer_version`` first (a version-pinned session stays
        on its weights generation while any same-version replica
        survives — continuity beats pinning when none do), then
        ``prefer_prefix`` restricts to replicas advertising that prefix
        as RESIDENT when any exist (sessions go where the prefix KV
        already lives), falling back to the full pool on a cold
        fleet. An ``interactive`` session further narrows to links with
        an idle decode slot whenever any exist — the queue is exactly
        what the class is paying to skip."""
        if exclude is None:
            ex = ()
        elif isinstance(exclude, _ReplicaLink):
            ex = (exclude,)
        else:
            ex = tuple(exclude)
        with self._lock:
            live = [l for l in self._links
                    if l.alive and not l.draining
                    and all(l is not e for e in ex)
                    and (role is None or l.role == role)]
            if not live:
                return None
            if prefer_version is not None:
                same = [l for l in live
                        if l.weights_version == prefer_version]
                if same:
                    live = same
            if prefer_prefix is not None:
                resident = [l for l in live
                            if prefer_prefix in l.prefixes]
                if resident:
                    live = resident
            if cls == "interactive":
                idle = [l for l in live if l.idle_slots > 0]
                if idle:
                    live = idle
            return min(live, key=self._load_key)

    def _release_locked(self, sess: _RouterSession) -> bool:
        """Take ``sess`` out of the live sessions (the lock held). True
        when this call removed it: the caller then owns the stream's one
        terminal frame. False when another path (stop's sweep, a client
        disconnect, a racing failover) removed it first and owns it."""
        return self._sessions.pop((sess.conn.id, sess.crid), None) is sess

    def _release(self, sess: _RouterSession) -> bool:
        """:meth:`_release_locked` under the lock."""
        with self._lock:
            return self._release_locked(sess)

    def _unassign_locked(self, sess: _RouterSession) -> None:
        """Release a session's assignment counts (BOTH halves of a
        disaggregated pair). Call exactly once per removal from
        ``_by_rrid`` — the pairing invariant the load tiebreak rests
        on."""
        for link in {sess.link, sess.prefill_link}:
            if link is not None:
                link.assigned -= 1

    def _health_loop(self) -> None:
        while not self._stopping.wait(self.health_interval_s):
            for link in list(self._links):
                if not link.alive:
                    continue
                if link.pings_unanswered >= self.max_missed_pings:
                    log.warning("router: replica %s unresponsive (%d "
                                "unanswered stats pings); marking down",
                                link.addr, link.pings_unanswered)
                    link.close()            # reader EOF -> _replica_down
                    continue
                link.pings_unanswered += 1
                if not link.send(P.STATS, 0):
                    link.close()

    def _note_stats(self, link: _ReplicaLink) -> None:
        self._depth_g[link.addr].set(link.reported_load)
        if link.queue_depths:
            # fleet-wide per-class backlog: the autoscaler's signal
            # (FleetController reads interactive pressure, never the
            # batch backlog). list() copy — no lock on a reader thread.
            totals = {c: 0 for c in P.QOS_CLASSES}
            for l in list(self._links):
                if l.alive:
                    for c, n in l.queue_depths.items():
                        totals[c] = totals.get(c, 0) + n
            for c, g in self._cls_depth_g.items():
                g.set(totals.get(c, 0))

    # -- client side (reader threads) ---------------------------------------
    def _hello_payload(self) -> dict:
        return {"v": 1, "router": True,
                "replicas": len(self._replica_addrs)}

    def _handle_frame(self, conn: FrameConn, ftype: int, rid: int,
                      payload: bytes) -> None:
        if ftype == P.ADMIT:
            self._admit(conn, rid, payload)
        elif ftype == P.CANCEL:
            # capture (links, rrid) under the SAME lock that marks the
            # cancel: a failover re-placement assigns them as a pair,
            # and an unlocked read could pair the new link with the old
            # rrid — a CANCEL the surviving replica would no-op. In
            # disaggregated mode the CANCEL fans to BOTH tiers: the
            # prefill tier drops a still-queued prompt, the decode tier
            # tombstones the rid so a late-arriving shipment is never
            # adopted into a slot generating into the void.
            targets = []
            with self._lock:
                sess = self._sessions.get((conn.id, rid))
                if sess is not None:
                    sess.cancelled = True
                    targets = [(l, sess.rrid)
                               for l in (sess.link, sess.prefill_link)
                               if l is not None]
                    mig = sess.migrating
                    if mig is not None:
                        # mid-migration: the NEW placement dies too —
                        # its pre-ACK retirement is swallowed (the old
                        # side owns the terminal frame), so the client
                        # still sees exactly one
                        targets += [(l, mig.new_rrid)
                                    for l in (mig.new_link,
                                              mig.new_prefill)
                                    if l is not None]
            for link, rrid_t in targets:
                link.send(P.CANCEL, rrid_t)
        elif ftype == P.STATS:
            conn.send(P.STATS, 0, P.pack_json(self.stats()))
        elif ftype == P.PREFIX:
            self._handle_prefix_op(conn, rid, payload)
        elif ftype == P.DRAIN:
            obj = P.unpack_json(payload)
            replica = obj.get("replica")
            if not isinstance(replica, str) or not replica:
                conn.send(P.ERROR, rid, P.pack_json(
                    {"message": "DRAIN needs {'replica': 'host:port'}"}))
                return
            timeout = obj.get("timeout_s")
            timeout = float(timeout) if isinstance(
                timeout, (int, float)) and not isinstance(
                timeout, bool) else 120.0
            # a drain blocks until every session left the replica —
            # never on the operator connection's reader thread
            threading.Thread(
                target=self._drain_and_reply,
                args=(conn, rid, replica, timeout),
                name=f"tony-router-drain-{replica}", daemon=True).start()
        elif ftype == P.MIGRATE:
            with self._lock:
                sess = self._sessions.get((conn.id, rid))
            ok = sess is not None and self._migrate_session(sess)
            conn.send(P.MIGRATE, rid, P.pack_json({"ok": bool(ok)}))
        elif ftype == P.POLL:
            conn.send(P.ERROR, rid, P.pack_json(
                {"message": "router supports streaming requests only"}))
        else:
            raise P.ProtocolError(
                f"unexpected frame type {P.FRAME_NAMES.get(ftype, ftype)}")

    def _handle_prefix_op(self, conn: FrameConn, rid: int,
                          payload: bytes) -> None:
        """Router-side ``PREFIX`` ops: ``register`` (grow the matching
        catalog) and ``list`` (catalog + fleet residency). Failures are
        request-scoped replies, never connection deaths."""
        obj = P.unpack_json(payload)
        op = obj.get("op")
        try:
            if op == "register":
                tokens = obj.get("tokens")
                if (not isinstance(tokens, list) or not tokens
                        or not all(isinstance(t, int)
                                   and not isinstance(t, bool)
                                   for t in tokens)):
                    raise ValueError("register needs a non-empty token "
                                     "list")
                pid = self.register_prefix(tokens,
                                           prefix_id=obj.get("id"))
                body = {"ok": True, "id": pid,
                        "catalog": sorted(self._prefix_catalog)}
            elif op == "list":
                body = {"ok": True,
                        "catalog": sorted(self._prefix_catalog),
                        "resident": {
                            l.addr: sorted(l.prefixes)
                            for l in self._links if l.alive}}
            else:
                body = {"ok": False,
                        "error": f"unknown router prefix op {op!r} "
                                 f"(install/publish go to replicas)"}
        except ValueError as e:
            body = {"ok": False, "error": str(e)}
        conn.send(P.PREFIX, rid, P.pack_json(body))

    def _admit(self, conn: FrameConn, rid: int, payload: bytes) -> None:
        prompt, max_new, stream = P.parse_admit(payload)
        if rid == 0:
            raise P.ProtocolError("ADMIT rid must be nonzero")
        if not stream:
            conn.send(P.ERROR, rid, P.pack_json(
                {"message": "router supports streaming requests only"}))
            return
        if max_new <= 0:
            conn.send(P.ERROR, rid, P.pack_json(
                {"message": f"max_new_tokens must be positive, "
                            f"got {max_new}"}))
            return
        # the session's prefix identity: the ADMIT's explicit id, or
        # the router's tokenized longest-match against the catalog (the
        # fallback for clients that know nothing about prefixes)
        prefix_id = P.parse_prefix_id(payload)
        if prefix_id is None and self._prefix_catalog:
            prefix_id = match_prefix(prompt, self._prefix_catalog)
        try:
            # absent = "standard" (old wires unchanged); an unknown
            # class is a request-scoped error, not a silent downgrade
            cls = P.parse_class(payload)
        except ValueError as e:
            conn.send(P.ERROR, rid, P.pack_json({"message": str(e)}))
            return
        key = (conn.id, rid)
        # duplicate-rid reply goes out AFTER the lock is dropped: the
        # send can block on a slow client and this lock is the router's
        # whole control plane (TL001)
        with self._lock:
            duplicate = key in self._sessions
            if not duplicate:
                sess = _RouterSession(conn, rid, prompt, max_new,
                                      trace_ctx=P.parse_trace_ctx(payload),
                                      prefix_id=prefix_id,
                                      stream=next(self._next_stream),
                                      cls=cls)
                self._sessions[key] = sess
        if duplicate:
            conn.send(P.ERROR, rid, P.pack_json(
                {"message": f"request id {rid} is already active"}))
            return
        t0 = time.perf_counter()
        placed = self._place(sess, exclude=None)
        self._place_h.observe(time.perf_counter() - t0)
        if not placed and self._release(sess):
            conn.send(P.ERROR, rid, P.pack_json(
                {"message": "no live replicas"}))

    def _place(self, sess: _RouterSession, exclude) -> bool:
        """Assign (or re-assign) a session to the least-loaded replica;
        the replica prompt carries the already-streamed prefix so a
        failover continues exactly where the stream left off, and the
        session's pinned rng stream rides the ADMIT with the streamed
        count as its offset — SAMPLED continuations are token-identical
        too. In disaggregated mode the placement is a PAIR: the ADMIT
        goes to a prefill link naming a decode link's channel endpoint,
        and TOKENS will flow back over the decode link. A failed ADMIT
        send is handled HERE (tear the link down, retry on the next
        replica): the link's reader thread may already have run its
        one-shot ``_replica_down`` sweep before this session was
        registered, so relying on it would strand the session."""
        if self._disagg:
            plink = self._pick_link(exclude=exclude, role="prefill",
                                    prefer_prefix=sess.prefix_id,
                                    prefer_version=sess.pinned_version)
            dlink = self._pick_link(exclude=exclude, role="decode",
                                    prefer_version=sess.pinned_version,
                                    cls=sess.cls)
            if plink is None or dlink is None:
                return False
            admit_link, token_link = plink, dlink
        else:
            plink = None
            admit_link = token_link = self._pick_link(
                exclude=exclude, prefer_prefix=sess.prefix_id,
                prefer_version=sess.pinned_version, cls=sess.cls)
            if admit_link is None:
                return False
        if sess.prefix_id is not None:
            # the placement's prefix outcome: resident (the prefill
            # pays only the suffix) or blind (a cold/ring fleet)
            if sess.prefix_id in admit_link.prefixes:
                self._prefix_hits_c.inc()
            else:
                self._prefix_misses_c.inc()
        rrid = next(self._next_rrid)
        with self._lock:
            # the session may have died while it was between homes: a
            # client disconnect removed it from _sessions (re-admitting
            # would burn a survivor's slot generating into a closed
            # connection), or a CANCEL raced the failover
            if self._sessions.get((sess.conn.id, sess.crid)) is not sess:
                return True
            if sess.cancelled:
                doomed = self._release_locked(sess)
                if not doomed:
                    return True
            else:
                doomed = False
                sess.link = token_link
                sess.prefill_link = plink
                sess.handed_off = False
                sess.rrid = rrid
                if sess.pinned_version is None:
                    sess.pinned_version = token_link.weights_version
                self._by_rrid[rrid] = sess
                token_link.assigned += 1
                if plink is not None:
                    plink.assigned += 1
        if doomed:
            sess.conn.send(P.RETIRED, sess.crid, P.pack_json(
                {"reason": "cancelled", "tokens": len(sess.streamed)}))
            return True
        self._placed_c[admit_link.addr].inc()
        if plink is not None:
            self._placed_c[token_link.addr].inc()
        # the router's hop in the request trace: placement decision +
        # forwarded ADMIT, as a child of the client's span (only traced
        # requests — an orphan root per placement would be noise)
        if sess.trace_ctx is not None:
            from tony_tpu_torch.runtime import tracing
            attrs = {"replica": admit_link.addr,
                     "failover": bool(sess.streamed)}
            if plink is not None:
                attrs["decode"] = token_link.addr
            tracing.get_tracer().record_span(
                "router.place", 0.0, ctx=sess.trace_ctx, **attrs)
        body = {"prompt": sess.prompt + sess.streamed,
                "max_new_tokens": sess.budget - len(sess.streamed),
                "stream": True,
                # the session's rng pin: same stream index on every
                # placement, offset = tokens already delivered — a
                # SAMPLED continuation regenerates the identical
                # sequence on any replica sharing the fleet seed
                "rng": {"stream": sess.stream,
                        "off": len(sess.streamed)}}
        if sess.cls != "standard":
            # old wires unchanged: the class field rides only when it
            # says something non-default
            body["class"] = sess.cls
        if sess.prefix_id is not None:
            # forwarded on failover re-placements too: the streamed
            # prefix folds in AFTER the shared prefix, so the re-placed
            # prompt still continues it (replicas verify the tokens
            # before taking the fast path regardless)
            body["prefix"] = sess.prefix_id
        if plink is not None:
            # the KV shipment target: the decode gang's channel hub
            host = token_link.addr.rpartition(":")[0]
            body["decode"] = f"{host}:{token_link.channel_port}"
        if sess.trace_ctx is not None:
            body["trace"] = sess.trace_ctx
        ok = admit_link.send(P.ADMIT, rrid, P.pack_json(body))
        if not ok:
            # re-place ONLY if this placement still owns the session:
            # the link's down-sweep may have re-placed it already (it
            # can run between our registration and the failed send),
            # and a second placement would double-serve the request
            with self._lock:
                still_mine = (self._by_rrid.get(rrid) is sess
                              and sess.link is token_link)
                if still_mine:
                    self._by_rrid.pop(rrid, None)
                    self._unassign_locked(sess)
            admit_link.alive = False
            admit_link.close()
            self._replica_down(admit_link)  # idempotent; sweeps others
            if not still_mine:
                return True                 # the sweep owns it now
            return self._place(sess, exclude=admit_link)
        return True

    # -- planned migration (drain / upgrade) ---------------------------------
    def _migrate_session(self, sess: _RouterSession, exclude=()) -> bool:
        """Start a coordinated live migration of one session: place it
        a SECOND time on a surviving replica (prompt + streamed prefix,
        rng pinned at the snapshot offset) while the old placement
        keeps streaming. The new placement's first delta is the
        takeover ACK (see :meth:`_replica_delta`); until then the
        session cannot stall — the old side never stopped. Returns True
        when a migration is in flight (started here or already),
        False when the session has nothing to migrate (retired,
        cancelled, budget-complete, or a disaggregated session still
        pre-handoff — the handoff lands in milliseconds and the drain
        loop's next tick catches it) or no eligible replica exists."""
        with self._lock:
            if self._sessions.get((sess.conn.id, sess.crid)) is not sess:
                return False                # already terminal
            if sess.cancelled:
                return False
            if sess.migrating is not None:
                return True                 # already on its way
            if sess.link is None:
                return False                # between homes; sweep owns it
            if self._disagg and not sess.handed_off:
                return False                # prompt still on the prefill tier
            if len(sess.streamed) >= sess.budget:
                return False                # retirement already due
            old_token = sess.link
            # the snapshot the new ADMIT carries: tokens the old side
            # streams AFTER this become the regenerated overlap the ACK
            # discards count-exactly
            snap_len = len(sess.streamed)
            prompt = sess.prompt + sess.streamed
            prefix_id = sess.prefix_id
            trace_ctx = sess.trace_ctx
            stream = sess.stream
            pinned = sess.pinned_version
            budget = sess.budget
            cls = sess.cls
        ex = set(exclude)
        ex.add(old_token)
        if self._disagg:
            plink = self._pick_link(exclude=ex, role="prefill",
                                    prefer_prefix=prefix_id,
                                    prefer_version=pinned)
            dlink = self._pick_link(exclude=ex, role="decode",
                                    prefer_version=pinned, cls=cls)
            if plink is None or dlink is None:
                return False
            admit_link, token_link = plink, dlink
        else:
            plink = None
            admit_link = token_link = self._pick_link(
                exclude=ex, prefer_prefix=prefix_id,
                prefer_version=pinned, cls=cls)
            if admit_link is None:
                return False
        new_rrid = next(self._next_rrid)
        mig = _Migration(snap_len, token_link, plink, new_rrid)
        with self._lock:
            # re-validate: the session may have retired, cancelled, or
            # crash-failed-over to a DIFFERENT link while we were
            # picking — a stale snapshot must not admit
            if (self._sessions.get((sess.conn.id, sess.crid)) is not sess
                    or sess.cancelled or sess.migrating is not None
                    or sess.link is not old_token):
                return False
            # the picked links may have died between the pick and here
            # (their down-sweep could have run before we registered, so
            # it would never see this migration)
            if not token_link.alive or (
                    plink is not None and not plink.alive):
                return False
            sess.migrating = mig
            self._by_rrid[new_rrid] = sess
            token_link.assigned += 1
            if plink is not None:
                plink.assigned += 1
        self._placed_c[admit_link.addr].inc()
        if plink is not None:
            self._placed_c[token_link.addr].inc()
        if trace_ctx is not None:
            from tony_tpu_torch.runtime import tracing
            attrs = {"replica": admit_link.addr, "snap_len": snap_len}
            if plink is not None:
                attrs["decode"] = token_link.addr
            tracing.get_tracer().record_span(
                "router.migrate", 0.0, ctx=trace_ctx, **attrs)
        body = {"prompt": prompt,
                "max_new_tokens": budget - snap_len,
                "stream": True,
                "rng": {"stream": stream, "off": snap_len}}
        if cls != "standard":
            body["class"] = cls
        if prefix_id is not None:
            body["prefix"] = prefix_id
        if plink is not None:
            host = token_link.addr.rpartition(":")[0]
            body["decode"] = f"{host}:{token_link.channel_port}"
        if trace_ctx is not None:
            body["trace"] = trace_ctx
        if not admit_link.send(P.ADMIT, new_rrid, P.pack_json(body)):
            # roll the second placement back (guarded: the link's
            # down-sweep may have abandoned it for us already) and let
            # the drain loop retry on whatever survives
            with self._lock:
                if self._by_rrid.get(new_rrid) is sess:
                    self._by_rrid.pop(new_rrid, None)
                    for l in {token_link, plink}:
                        if l is not None:
                            l.assigned -= 1
                    if sess.migrating is mig:
                        sess.migrating = None
            admit_link.alive = False
            admit_link.close()
            self._replica_down(admit_link)
            return False
        return True

    def drain(self, replica: str, timeout_s: float = 120.0,
              poll_interval_s: float = 0.05) -> dict:
        """Fence ``replica`` against new placements and live-migrate
        every session off it (planned maintenance / rolling upgrade —
        the zero-dup/zero-drop counterpart of crash failover). Blocks
        until the replica holds no sessions or ``timeout_s`` passes;
        a replica with no sessions drains immediately. The fence stays
        after the drain — lift it with :meth:`remove_replica` (retire)
        or :meth:`undrain` (maintenance cancelled). Returns a summary:
        ``{"replica", "drained", "migrated", "wall_s"}`` plus
        ``"sessions_left"`` on timeout. A session whose migration is
        abandoned (its target died mid-flight) is retried on the next
        poll tick; one that cannot be placed anywhere keeps streaming
        on the draining replica — a drain never degrades a live
        stream."""
        t0 = time.perf_counter()
        with self._lock:
            targets = [l for l in self._links if l.addr == replica]
            for l in targets:
                l.draining = True
        if not targets:
            return {"replica": replica, "drained": False, "migrated": 0,
                    "wall_s": 0.0, "error": "unknown replica"}
        tset = {id(l) for l in targets}
        migrated = 0
        deadline = t0 + timeout_s
        while True:
            with self._lock:
                pending = [
                    s for s in self._sessions.values()
                    if (s.link is not None and id(s.link) in tset)
                    or (s.prefill_link is not None
                        and id(s.prefill_link) in tset
                        and not s.handed_off)]
                busy = {id(s) for s in pending
                        if s.migrating is not None}
            if not pending:
                break
            for s in pending:
                if id(s) in busy:
                    continue
                if self._migrate_session(s):
                    migrated += 1
            if time.perf_counter() >= deadline:
                self._drains_c.inc()
                return {"replica": replica, "drained": False,
                        "migrated": migrated,
                        "sessions_left": len(pending),
                        "wall_s": round(time.perf_counter() - t0, 4)}
            if self._stopping.wait(poll_interval_s):
                # router stopping under the drain: stop() sweeps every
                # session to a terminal ERROR; report honestly
                return {"replica": replica, "drained": False,
                        "migrated": migrated,
                        "sessions_left": len(pending),
                        "wall_s": round(time.perf_counter() - t0, 4),
                        "error": "router stopping"}
        self._drains_c.inc()
        return {"replica": replica, "drained": True,
                "migrated": migrated,
                "wall_s": round(time.perf_counter() - t0, 4)}

    def undrain(self, replica: str) -> None:
        """Lift a drain fence (maintenance cancelled): the replica
        takes new placements again."""
        with self._lock:
            for l in self._links:
                if l.addr == replica:
                    l.draining = False

    def _drain_and_reply(self, conn: FrameConn, rid: int, replica: str,
                         timeout_s: float) -> None:
        """Run a remote-requested drain and reply on its rid (its own
        thread: a drain blocks for its wall time, and the operator
        connection's reader must keep serving other frames)."""
        try:
            result = self.drain(replica, timeout_s=timeout_s)
        except Exception as e:           # noqa: BLE001 - reply, don't die
            log.warning("remote-requested drain of %s failed: %s",
                        replica, e)
            conn.send(P.ERROR, rid,
                      P.pack_json({"message": f"drain failed: {e}"}))
            return
        result["ok"] = bool(result.get("drained"))
        conn.send(P.DRAIN, rid, P.pack_json(result))

    def _on_conn_closed(self, conn: FrameConn) -> None:
        cancels = []
        with self._lock:
            doomed = [s for k, s in list(self._sessions.items())
                      if s.conn is conn]
            for s in doomed:
                self._sessions.pop((conn.id, s.crid), None)
                self._by_rrid.pop(s.rrid, None)
                self._unassign_locked(s)
                cancels += [(l, s.rrid)
                            for l in {s.link, s.prefill_link}
                            if l is not None]
                mig = s.migrating
                if mig is not None and not mig.acked:
                    # the second placement of an in-flight migration
                    # dies with the client too
                    self._by_rrid.pop(mig.new_rrid, None)
                    for l in {mig.new_link, mig.new_prefill}:
                        if l is not None:
                            l.assigned -= 1
                    cancels += [(l, mig.new_rrid)
                                for l in {mig.new_link, mig.new_prefill}
                                if l is not None]
        for link, rrid in cancels:
            link.send(P.CANCEL, rrid)

    # -- replica side (link reader threads) ---------------------------------
    def _replica_delta(self, link: _ReplicaLink, rrid: int,
                       toks: list[int]) -> None:
        """Forward a replica delta. During a migration the session's
        tokens arrive on TWO links from two reader threads — the
        session's ``wlock`` serializes append+send per delta so the
        client never sees positions out of order, and the FIRST delta
        from the new placement is the takeover ACK: ownership swaps to
        the new links, the old half gets a tombstoning CANCEL, and the
        regenerated overlap (tokens the old side streamed after the
        migration snapshot — token-identical by the rng pin) is dropped
        count-exactly."""
        with self._lock:
            sess = self._by_rrid.get(rrid)
        if sess is None:
            return
        send = None
        cancels = []
        completed = False
        with sess.wlock:
            with self._lock:
                if self._by_rrid.get(rrid) is not sess:
                    return                  # swept under us
                mig = sess.migrating
                if mig is not None and rrid == mig.new_rrid:
                    if link is not mig.new_link:
                        return              # not the new token link
                    if not mig.acked:
                        # the ACK: the new placement is live — swap
                        # ownership, release the old placement's
                        # assignment counts (BOTH halves,
                        # unconditionally: a stateless prefill link can
                        # serve both placements and was counted twice)
                        mig.acked = True
                        mig.discard = len(sess.streamed) - mig.snap_len
                        old_rrid = sess.rrid
                        cancels = [(l, old_rrid)
                                   for l in {sess.link, sess.prefill_link}
                                   if l is not None]
                        self._by_rrid.pop(old_rrid, None)
                        for l in {sess.link, sess.prefill_link}:
                            if l is not None:
                                l.assigned -= 1
                        sess.link = mig.new_link
                        sess.prefill_link = mig.new_prefill
                        sess.handed_off = mig.handed_off
                        sess.rrid = mig.new_rrid
                        completed = True
                    # drop the regenerated overlap — the client already
                    # has those exact tokens from the old side
                    if mig.discard:
                        drop = min(mig.discard, len(toks))
                        mig.discard -= drop
                        toks = toks[drop:]
                    if mig.discard == 0:
                        sess.migrating = None
                    if toks:
                        sess.streamed.extend(toks)
                        send = toks
                else:
                    if sess.link is not link or rrid != sess.rrid:
                        return              # stale delta after failover
                    sess.streamed.extend(toks)
                    send = toks
            # still under wlock (delta order), outside the router lock
            for l, r in cancels:
                l.send(P.CANCEL, r)
            if send:
                # the class's latency series, observed BEFORE the
                # client send so a slow client socket never pollutes
                # the serving-plane signal (wlock makes t_last safe)
                now = time.monotonic()
                if sess.t_last == 0.0:
                    self._ttft_by_cls[sess.cls].observe(
                        now - sess.t_submit)
                else:
                    self._itl_by_cls[sess.cls].observe(
                        (now - sess.t_last) / len(send))
                sess.t_last = now
                sess.conn.send(P.TOKENS, sess.crid, P.pack_tokens(send))
        if completed:
            self._migrations_c.inc()

    def _replica_retired(self, link: _ReplicaLink, rrid: int,
                         reason: str) -> None:
        tombstones = []
        requeue = False
        with self._lock:
            sess = self._by_rrid.pop(rrid, None)
            if sess is None:
                return
            mig = sess.migrating
            if mig is not None and not mig.acked and rrid == mig.new_rrid:
                # the NEW placement of an in-flight migration retired
                # before its first delta (a client CANCEL fanned to it,
                # or an instant eos): abandon the migration SILENTLY —
                # the old placement never stopped streaming and still
                # owns the one terminal frame the client will see
                owns = (mig.new_link is link
                        or (mig.new_prefill is link
                            and not mig.handed_off))
                if not owns or reason == "stopped":
                    self._by_rrid[rrid] = sess
                    return
                for l in {mig.new_link, mig.new_prefill}:
                    if l is not None:
                        l.assigned -= 1
                sess.migrating = None
                return
            # the prefill link speaks for a session it still owns (a
            # CANCEL caught the prompt queued or mid-wave, pre-HANDOFF);
            # after the handoff its frames for this rrid are stale
            owns = (sess.link is link
                    or (sess.prefill_link is link and not sess.handed_off))
            if not owns:
                self._by_rrid[rrid] = sess
                return
            if reason == "preempted" and not sess.cancelled:
                # the replica evicted this row to seat an interactive
                # admission and could NOT fold it into its own queue (a
                # KV-adopted decode row — the prompt lives with the
                # router, not the replica): the ROUTER re-queues.
                # Re-place like a failover — prompt + streamed prefix,
                # rng pinned at the delivered count — so the stream
                # resumes token-identically wherever a slot exists; the
                # evicting replica stays eligible (a fresh placement
                # enters its batch queue and waits its turn).
                self._unassign_locked(sess)
                if mig is not None and not mig.acked:
                    self._by_rrid.pop(mig.new_rrid, None)
                    for l in {mig.new_link, mig.new_prefill}:
                        if l is not None:
                            l.assigned -= 1
                    tombstones = [(l, mig.new_rrid)
                                  for l in {mig.new_link, mig.new_prefill}
                                  if l is not None and l.alive]
                sess.migrating = None
                requeue = True
            elif reason == "stopped":
                # replica is draining/dying under us: keep the session,
                # the link-down path re-places it with the prefix trim
                self._by_rrid[rrid] = sess
                return
            else:
                owned = self._release_locked(sess)
                self._unassign_locked(sess)
                if mig is not None and not mig.acked:
                    # the OLD side finished the stream (eos/budget/
                    # cancel) before the migration ACKed: the takeover
                    # is moot — tombstone the pending second placement
                    self._by_rrid.pop(mig.new_rrid, None)
                    for l in {mig.new_link, mig.new_prefill}:
                        if l is not None:
                            l.assigned -= 1
                    tombstones = [(l, mig.new_rrid)
                                  for l in {mig.new_link, mig.new_prefill}
                                  if l is not None and l.alive]
                    sess.migrating = None
        for l, r in tombstones:
            l.send(P.CANCEL, r)
        if requeue:
            self._preempt_requeued_c.inc()
            if self._place(sess, exclude=None):
                return
            if self._release(sess):
                sess.conn.send(P.ERROR, sess.crid, P.pack_json(
                    {"message": "no live replicas"}))
            return
        if owned:
            sess.conn.send(P.RETIRED, sess.crid, P.pack_json(
                {"reason": reason, "tokens": len(sess.streamed)}))

    def _replica_handoff(self, link: _ReplicaLink, rrid: int,
                         obj: dict) -> None:
        """The prefill tier shipped this session's KV package: its fate
        now rides the decode link alone — a prefill replica dying after
        this frame costs the session nothing."""
        with self._lock:
            sess = self._by_rrid.get(rrid)
            if sess is None:
                return
            mig = sess.migrating
            if mig is not None and not mig.acked and rrid == mig.new_rrid:
                # the migration's second placement handed off — ITS
                # prefill half is out of the fate path (recorded on the
                # migration; the ACK swap copies it onto the session)
                if mig.new_prefill is not link:
                    return
                mig.handed_off = True
            else:
                if sess.prefill_link is not link or rrid != sess.rrid:
                    return                  # stale (failover re-placed)
                sess.handed_off = True
        self._handoffs_c.inc()

    def _replica_error(self, link: _ReplicaLink, rrid: int, msg: str,
                       retryable: bool = False) -> None:
        """A replica failed this session. ``retryable`` (the prefill
        tier's kv-ship-failure marker) means the fault is the session's
        PLACEMENT, not the request: re-place it away from the decode
        link the shipment could not reach — the same contract as losing
        that decode link outright, just noticed by the prefill tier
        first."""
        tombstones = []
        with self._lock:
            sess = self._by_rrid.pop(rrid, None)
            if sess is None:
                return
            mig = sess.migrating
            if mig is not None and not mig.acked and rrid == mig.new_rrid:
                # the migration's second placement failed before taking
                # over: abandon it silently — the old half never
                # stopped streaming; the drain loop just retries
                for l in {mig.new_link, mig.new_prefill}:
                    if l is not None:
                        l.assigned -= 1
                sess.migrating = None
                return
            self._unassign_locked(sess)
            if mig is not None and not mig.acked:
                # the OWNING placement failed mid-migration: the
                # pending takeover is torn down with it — the failover
                # re-placement below restarts from the full streamed
                # prefix (never from the stale migration snapshot)
                self._by_rrid.pop(mig.new_rrid, None)
                for l in {mig.new_link, mig.new_prefill}:
                    if l is not None:
                        l.assigned -= 1
                tombstones = [(l, mig.new_rrid)
                              for l in {mig.new_link, mig.new_prefill}
                              if l is not None and l.alive]
            # any residual migration state (including a post-ACK
            # discard countdown) dies with the placement: the failover
            # re-placement below restarts from the full streamed prefix
            sess.migrating = None
            old_link = sess.link
            retry = retryable and not sess.cancelled
            owned = not retry and self._release_locked(sess)
        for l, r in tombstones:
            l.send(P.CANCEL, r)
        if retry:
            # tombstone the old rrid on the decode link the shipment
            # could not (verifiably) reach: "unreachable" may be a
            # delivered frame whose ack timed out, and without the
            # CANCEL a late adoption would burn a decode slot streaming
            # into a stale rrid (same contract as _replica_down's sweep
            # of the surviving half)
            if (old_link is not None and old_link is not link
                    and old_link.alive):
                old_link.send(P.CANCEL, rrid)
            self._failovers_c.inc()
            if self._place(sess, exclude=old_link):
                return
            owned = self._release(sess)
            msg = "no live replicas"
        if owned:
            sess.conn.send(P.ERROR, sess.crid,
                           P.pack_json({"message": msg}))

    def _replica_busy(self, link: _ReplicaLink, rrid: int,
                      retry_after_ms: int) -> None:
        """A replica shed this session's admission (its wait queue is
        past the overload bound). BATCH sessions are the router's to
        re-queue: re-place away from the shedding replica, capped at
        :data:`BUSY_REQUEUE_CAP` sheds per session — when every replica
        is saying "come back later", the client should hear it. For
        every other class the shed PROPAGATES: BUSY is terminal for the
        rid and the retry hint rides through untouched."""
        with self._lock:
            sess = self._by_rrid.pop(rrid, None)
            if sess is None:
                return
            mig = sess.migrating
            if mig is not None and not mig.acked and rrid == mig.new_rrid:
                # the migration's second placement was shed: abandon it
                # silently — the old half never stopped streaming; the
                # drain loop just retries a less-loaded target
                for l in {mig.new_link, mig.new_prefill}:
                    if l is not None:
                        l.assigned -= 1
                sess.migrating = None
                return
            self._unassign_locked(sess)
            sess.migrating = None
            sess.busy_retries += 1
            retry = (sess.cls == "batch" and not sess.cancelled
                     and sess.busy_retries <= BUSY_REQUEUE_CAP)
            owned = not retry and self._release_locked(sess)
        if retry:
            self._busy_requeued_c.inc()
            if self._place(sess, exclude=link):
                return
            owned = self._release(sess)
        if owned:
            sess.conn.send(P.BUSY, sess.crid, P.pack_json(
                {"retry_after_ms": retry_after_ms}))

    def _replica_down(self, link: _ReplicaLink) -> None:
        """Replica loss: drain its sessions onto survivors, streamed
        prefix trimmed into the prompt, remaining budget only. In
        disaggregated mode a DECODE loss orphans every session
        streaming from it (they re-prefill — prompt + streamed prefix —
        through a surviving prefill replica toward a surviving decode
        replica); a PREFILL loss orphans only sessions it had NOT yet
        handed off (post-HANDOFF sessions live on the decode gang and
        keep streaming)."""
        with self._lock:
            if id(link) in self._downed:
                return
            self._downed.add(id(link))
        link.alive = False
        link.close()
        self._up_g[link.addr].set(0)
        self._refresh_prefix_residency()
        abandoned = []  # (surviving links, new_rrid): dead migrations
        promoted = []   # (sess, old_rrid, surviving old links): forced ACKs
        orphans = []
        with self._lock:
            seen = set()
            for s in list(self._by_rrid.values()):
                if id(s) in seen:
                    continue                # mapped twice mid-migration
                seen.add(id(s))
                mig = s.migrating
                if (mig is not None and not mig.acked
                        and (mig.new_link is link
                             or (mig.new_prefill is link
                                 and not mig.handed_off))):
                    # a pending migration TARGETED the dead replica:
                    # abandon it — the old placement never stopped
                    # streaming; the drain loop just retries
                    self._by_rrid.pop(mig.new_rrid, None)
                    for l in {mig.new_link, mig.new_prefill}:
                        if l is not None:
                            l.assigned -= 1
                    abandoned.append((
                        [l for l in {mig.new_link, mig.new_prefill}
                         if l is not None and l is not link and l.alive],
                        mig.new_rrid))
                    s.migrating = None
                    mig = None
                hit = (s.link is link
                       or (s.prefill_link is link and not s.handed_off))
                if not hit:
                    continue
                if (mig is not None and not mig.acked
                        and mig.new_link.alive
                        and (mig.new_prefill is None or mig.handed_off
                             or mig.new_prefill.alive)):
                    # the OLD half died while a migration toward a
                    # healthy target was pending: PROMOTE it — a forced
                    # ACK. No re-placement, no re-prefill: the new side
                    # is already computing, its deltas just haven't
                    # landed yet; the discard countdown drops the
                    # overlap exactly as a delta-ACK would.
                    old_rrid = s.rrid
                    survivors = [l for l in {s.link, s.prefill_link}
                                 if l is not None and l is not link
                                 and l.alive]
                    mig.acked = True
                    mig.discard = len(s.streamed) - mig.snap_len
                    self._by_rrid.pop(old_rrid, None)
                    for l in {s.link, s.prefill_link}:
                        if l is not None:
                            l.assigned -= 1
                    s.link = mig.new_link
                    s.prefill_link = mig.new_prefill
                    s.handed_off = mig.handed_off
                    s.rrid = mig.new_rrid
                    if mig.discard == 0:
                        s.migrating = None
                    promoted.append((s, old_rrid, survivors))
                    continue
                if mig is not None and not mig.acked:
                    # pending migration whose target ALSO already died:
                    # tear both placements down, re-place fresh below
                    self._by_rrid.pop(mig.new_rrid, None)
                    for l in {mig.new_link, mig.new_prefill}:
                        if l is not None:
                            l.assigned -= 1
                    abandoned.append((
                        [l for l in {mig.new_link, mig.new_prefill}
                         if l is not None and l is not link and l.alive],
                        mig.new_rrid))
                s.migrating = None
                self._by_rrid.pop(s.rrid, None)
                self._unassign_locked(s)
                orphans.append(s)
        for links_, new_rrid in abandoned:
            # tombstone the surviving half of a torn-down second
            # placement (a queued prompt / a pre-adoption rid)
            for l in links_:
                l.send(P.CANCEL, new_rrid)
        for s, old_rrid, survivors in promoted:
            for l in survivors:
                l.send(P.CANCEL, old_rrid)
            self._migrations_c.inc()
        if promoted:
            log.warning("router: replica %s (%s) down; promoted %d "
                        "in-flight migrations", link.addr, link.role,
                        len(promoted))
        if orphans:
            log.warning("router: replica %s (%s) down; re-admitting %d "
                        "sessions", link.addr, link.role, len(orphans))
        for sess in orphans:
            # the surviving half of a split placement holds stale work
            # for the old rrid: tell it to drop (the prefill tier
            # unqueues the prompt; the decode tier tombstones the rid
            # so a late shipment is never adopted)
            for other in {sess.link, sess.prefill_link}:
                if (other is not None and other is not link
                        and other.alive):
                    other.send(P.CANCEL, sess.rrid)
            if sess.cancelled:
                # the client already asked for this session's death —
                # finishing it as cancelled beats resurrecting it on a
                # survivor with full remaining budget
                if self._release(sess):
                    sess.conn.send(P.RETIRED, sess.crid, P.pack_json(
                        {"reason": "cancelled",
                         "tokens": len(sess.streamed)}))
                continue
            if len(sess.streamed) >= sess.budget:
                # fully streamed; only the RETIRED frame was lost
                if self._release(sess):
                    sess.conn.send(P.RETIRED, sess.crid, P.pack_json(
                        {"reason": "budget",
                         "tokens": len(sess.streamed)}))
                continue
            self._failovers_c.inc()
            if not self._place(sess, exclude=link) and self._release(sess):
                sess.conn.send(P.ERROR, sess.crid, P.pack_json(
                    {"message": "no live replicas"}))

    # -- introspection -------------------------------------------------------
    def stats(self) -> dict:
        """Router stats snapshot. Carries the protocol-mandated STATS
        fields (``queue_depth``/``active``/``slots``, here the fleet
        aggregates — a router can front another router) plus the
        per-replica detail."""
        with self._lock:
            live = [l for l in self._links if l.alive]
            return {
                "queue_depth": sum(l.reported_load for l in live),
                "active": len(self._sessions),
                # in disaggregated mode only decode slots hold rows —
                # prefill "slots" are wave widths, not capacity
                "slots": sum(int(l.hello.get("slots", 0))
                             for l in live
                             if not self._disagg or l.role == "decode"),
                "sessions": len(self._sessions),
                # fleet-aggregated per-class backlog (classless
                # replicas contribute nothing — they never report it)
                "queue_depths": {
                    c: sum(l.queue_depths.get(c, 0) for l in live)
                    for c in P.QOS_CLASSES},
                "disaggregated": self._disagg,
                "prefixes": sorted(self._prefix_catalog),
                "replicas": {
                    l.addr: {"up": int(l.alive),
                             "reported_load": l.reported_load,
                             "queue_depths": dict(l.queue_depths),
                             "assigned": l.assigned,
                             "role": l.role,
                             "draining": bool(l.draining),
                             "weights_version": l.weights_version,
                             "weights_digest": l.weights_digest,
                             "prefixes": sorted(l.prefixes),
                             "ring": l.ring}
                    for l in self._links},
            }
