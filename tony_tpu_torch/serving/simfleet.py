"""Deterministic simulated serving fleet: the chaos harness's model.

A :class:`SimReplica` speaks the full TONYS1 replica surface (HELLO
with slots/weights_version, ADMIT honoring the router's ``rng`` pin,
streamed TOKENS at an injected inter-token compute floor, atomic
TOKENS+RETIRED finals, CANCEL, STATS pings) with NO model stack — the
"generation" is a pure position-indexed token oracle,
:func:`sim_token`. That makes fleet-scale behavior testable exactly:

- any observer who knows a session's prompt can compute the ONE
  correct token sequence, so zero-dup/zero-drop across any number of
  migrations, failovers, and crashes is a strict equality check —
  the oracle keys on the prompt's first token and the ABSOLUTE
  position (the rng offset plus tokens emitted), which is precisely
  the contract the router's rng pin promises a real sampled engine
  reproduces;
- a 100-replica fleet runs in one process in milliseconds of wall
  time per token, so migration storms (drain 30 replicas at once) and
  seeded crash/drain chaos mixes are tier-1-affordable at small scale
  and @slow at full scale (tests/test_fleet.py);
- :class:`SimFleet` wires N replicas behind a real
  :class:`~tony_tpu_torch.serving.router.ServingRouter` (real sockets, real
  frames — only the model is simulated) and exposes kill/spawn/reap
  for chaos and autoscale (:class:`SimProvider` plugs into
  :class:`~tony_tpu_torch.serving.fleet.FleetController`).

The port's copy of ``tony_tpu/serving/simfleet.py``: the same
:func:`sim_token` oracle, HELLO and STATS keys, on the port's
:class:`~tony_tpu_torch.serving.server.FrameServerBase`, router, client
and :func:`~tony_tpu_torch.serving.weightstore.warm_fanout`. It imports
no torch, so a simulated fleet of either package's router runs with no
model stack loaded.
"""

from __future__ import annotations

import collections
import threading
import time

from tony_tpu_torch.serving import protocol as P
from tony_tpu_torch.serving.server import FrameConn, FrameServerBase


def sim_token(seed: int, pos: int) -> int:
    """The simulated model: token at absolute position ``pos`` of the
    stream seeded by ``seed`` (a session's first prompt token). Pure,
    stateless, collision-scrambled — any two (seed, pos) pairs disagree
    enough that a dup/drop/cross-session mixup cannot pass the equality
    check by accident. Values stay under 2**30 (engine token range)."""
    x = (seed & 0x3FFFFF) * 1315423911 + pos * 2654435761 + 97531
    x ^= x >> 13
    return x & 0x3FFFFFFF


class _SimSession:
    __slots__ = ("conn", "rid", "seed", "off", "emitted", "max_new",
                 "ready_at", "cls")

    def __init__(self, conn: FrameConn, rid: int, seed: int, off: int,
                 max_new: int, ready_at: float,
                 cls: str = "standard") -> None:
        self.conn = conn
        self.rid = rid
        self.seed = seed
        self.off = off                      # rng offset: tokens already
        self.emitted = 0                    # delivered by PRIOR placements
        self.max_new = max_new
        self.ready_at = ready_at
        self.cls = cls


class SimReplica(FrameServerBase):
    """One simulated serving replica. ``itl_s`` is the injected
    inter-token compute floor (one pump tick emits one token per live
    session); ``ttft_s`` the injected prefill floor before a session's
    first token. ``kill()`` is a crash: listener and every connection
    sever mid-stream, no goodbye frames."""

    def __init__(self, bind_host: str = "127.0.0.1", port: int = 0,
                 itl_s: float = 0.002, ttft_s: float = 0.0,
                 slots: int = 16, weights_version: str | None = None,
                 max_queue_depth: int = 128,
                 busy_retry_ms: int = 50) -> None:
        super().__init__(bind_host, port)
        self.itl_s = itl_s
        self.ttft_s = ttft_s
        self.slots = slots
        self.weights_version = weights_version
        # overload discipline mirrors the real engine: admissions past
        # ``slots`` wait in per-class queues, interactive waiters may
        # preempt a decoding batch row (demoted back to its queue, oracle
        # positions intact), and non-interactive admissions past
        # ``max_queue_depth`` waiting sessions are shed with BUSY
        self.max_queue_depth = max_queue_depth
        self.busy_retry_ms = busy_retry_ms
        self._slock = threading.Lock()
        self._sessions: dict = {}           # (conn.id, rid) -> _SimSession
        # waiting (not-yet-decoding) sessions per class, FIFO within one
        self._waitq: dict = {c: collections.deque() for c in P.QOS_CLASSES}
        self.preemptions = 0                # batch rows evicted-to-queue
        self._pump_thread: threading.Thread | None = None
        self.addr = ""

    def start(self) -> int:
        port = super().start()
        self.addr = f"{self.bind_host}:{port}"
        self._pump_thread = threading.Thread(
            target=self._pump_loop, name=f"tony-sim-pump-{port}",
            daemon=True)
        self._pump_thread.start()
        return port

    # -- replica protocol surface --------------------------------------------
    def _hello_payload(self) -> dict:
        return {"v": 1, "role": "engine", "slots": self.slots,
                "weights_version": self.weights_version, "sim": True}

    def _stats_payload(self) -> dict:
        with self._slock:
            active = len(self._sessions)
            depths = {c: len(q) for c, q in self._waitq.items()}
        return {"queue_depth": sum(depths.values()), "active": active,
                "slots": self.slots, "queue_depths": depths,
                "weights_version": self.weights_version}

    def _handle_frame(self, conn: FrameConn, ftype: int, rid: int,
                      payload: bytes) -> None:
        if ftype == P.ADMIT:
            prompt, max_new, stream = P.parse_admit(payload)
            if rid == 0 or not stream or max_new <= 0 or not prompt:
                conn.send(P.ERROR, rid, P.pack_json(
                    {"message": "sim replica: bad ADMIT"}))
                return
            try:
                cls = P.parse_class(P.unpack_json(payload))
            except ValueError as e:
                conn.send(P.ERROR, rid, P.pack_json({"message": str(e)}))
                return
            rng = P.parse_rng(payload)
            off = rng[1] if rng is not None else 0
            # the oracle seed is the ORIGINAL prompt's first token:
            # folded-in streamed prefixes append, so it survives every
            # re-placement of the session
            sess = _SimSession(conn, rid, seed=prompt[0], off=off,
                               max_new=max_new, ready_at=0.0, cls=cls)
            shed = False
            with self._slock:
                waiting = sum(len(q) for q in self._waitq.values())
                if (self.max_queue_depth and cls != "interactive"
                        and waiting >= self.max_queue_depth):
                    shed = True
                else:
                    # all admissions queue; the pump grants slots in
                    # class order, so ready_at is stamped at grant time
                    self._waitq[cls].append(((conn.id, rid), sess))
            if shed:
                conn.send(P.BUSY, rid, P.pack_json(
                    {"retry_after_ms": self.busy_retry_ms}))
        elif ftype == P.CANCEL:
            with self._slock:
                sess = self._sessions.pop((conn.id, rid), None)
                if sess is None:
                    for q in self._waitq.values():
                        for i, (key, s) in enumerate(q):
                            if key == (conn.id, rid):
                                sess = s
                                del q[i]
                                break
                        if sess is not None:
                            break
            if sess is not None:
                conn.send(P.RETIRED, rid, P.pack_json(
                    {"reason": "cancelled", "tokens": sess.emitted}))
        elif ftype == P.STATS:
            conn.send(P.STATS, 0, P.pack_json(self._stats_payload()))
        else:
            raise P.ProtocolError(
                f"sim replica: unexpected frame "
                f"{P.FRAME_NAMES.get(ftype, ftype)}")

    def _on_conn_closed(self, conn: FrameConn) -> None:
        with self._slock:
            for key in [k for k in self._sessions if k[0] == conn.id]:
                self._sessions.pop(key, None)
            for q in self._waitq.values():
                kept = [(k, s) for (k, s) in q if k[0] != conn.id]
                q.clear()
                q.extend(kept)

    # -- the simulated engine ------------------------------------------------
    def _grant_locked(self, now: float) -> None:
        """Fill free decode slots from the wait queues in class-priority
        order; if interactive work still waits once every slot is held,
        evict the least-advanced decoding batch row back to the FRONT of
        its queue (emitted count intact — on re-grant the stream resumes
        at ``sim_token(seed, off + emitted)``: zero dup/drop by
        construction, exactly the engine's evict-to-queue semantics)."""
        for cls in P.QOS_CLASSES:
            q = self._waitq[cls]
            while q and len(self._sessions) < self.slots:
                key, sess = q.popleft()
                # prefill floor is paid at grant time (and paid AGAIN on
                # re-grant after a preemption, like a real re-prefill)
                sess.ready_at = now + self.ttft_s
                self._sessions[key] = sess
        iq = self._waitq["interactive"]
        while iq:
            batch = [(k, s) for k, s in self._sessions.items()
                     if s.cls == "batch"]
            if not batch:
                break
            key, victim = min(batch, key=lambda kv: kv[1].emitted)
            self._sessions.pop(key)
            self._waitq["batch"].appendleft((key, victim))
            self.preemptions += 1
            nk, ns = iq.popleft()
            ns.ready_at = now + self.ttft_s
            self._sessions[nk] = ns

    def _pump_loop(self) -> None:
        while not self._stopping.wait(self.itl_s):
            now = time.monotonic()
            with self._slock:
                self._grant_locked(now)
                items = list(self._sessions.items())
            for key, s in items:
                if now < s.ready_at:
                    continue
                tok = sim_token(s.seed, s.off + s.emitted)
                s.emitted += 1
                if s.emitted >= s.max_new:
                    with self._slock:
                        self._sessions.pop(key, None)
                    # final delta + retirement share one kernel write:
                    # a crash cannot deliver one without the other
                    s.conn.send_many([
                        (P.TOKENS, s.rid, P.pack_tokens([tok])),
                        (P.RETIRED, s.rid, P.pack_json(
                            {"reason": "budget", "tokens": s.emitted}))])
                else:
                    if not s.conn.send(P.TOKENS, s.rid,
                                       P.pack_tokens([tok])):
                        with self._slock:
                            self._sessions.pop(key, None)

    # -- lifecycle -----------------------------------------------------------
    def stop(self) -> None:
        self._stopping.set()
        self._close_listener()
        self._close_conns()
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=5)
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)

    def kill(self) -> None:
        """Crash, not shutdown: sever everything mid-stream."""
        self.stop()


class SimFleet:
    """N simulated replicas behind a real router. ``start`` returns the
    router's client port. Chaos surface: :meth:`kill` (crash replica
    i), :meth:`spawn` (stand up a new replica and return its address —
    NOT yet routed; pair with ``router.add_replicas`` or use
    :class:`SimProvider`), :meth:`reap` (stop a spawned replica)."""

    def __init__(self, n: int, itl_s: float = 0.002,
                 ttft_s: float = 0.0, slots: int = 16,
                 weights_version: str | None = None,
                 health_interval_s: float = 0.1,
                 max_missed_pings: int = 3, registry=None,
                 max_queue_depth: int = 128,
                 busy_retry_ms: int = 50) -> None:
        self.n = n
        self.itl_s = itl_s
        self.ttft_s = ttft_s
        self.slots = slots
        self.weights_version = weights_version
        self.health_interval_s = health_interval_s
        self.max_missed_pings = max_missed_pings
        self.registry = registry
        self.max_queue_depth = max_queue_depth
        self.busy_retry_ms = busy_retry_ms
        self.replicas: dict = {}            # addr -> SimReplica
        self.router = None

    def start(self) -> int:
        from tony_tpu_torch.serving.router import ServingRouter

        for _ in range(self.n):
            self.spawn()
        self.router = ServingRouter(
            list(self.replicas), health_interval_s=self.health_interval_s,
            max_missed_pings=self.max_missed_pings,
            registry=self.registry)
        return self.router.start()

    def spawn(self, weights_version: str | None = None,
              itl_s: float | None = None) -> str:
        rep = SimReplica(
            itl_s=self.itl_s if itl_s is None else itl_s,
            ttft_s=self.ttft_s, slots=self.slots,
            weights_version=(self.weights_version
                             if weights_version is None
                             else weights_version),
            max_queue_depth=self.max_queue_depth,
            busy_retry_ms=self.busy_retry_ms)
        rep.start()
        self.replicas[rep.addr] = rep
        return rep.addr

    def kill(self, addr: str) -> None:
        rep = self.replicas.get(addr)
        if rep is not None:
            rep.kill()

    def reap(self, addr: str) -> None:
        rep = self.replicas.pop(addr, None)
        if rep is not None:
            rep.stop()

    def addrs(self) -> list:
        return list(self.replicas)

    def stop(self) -> None:
        if self.router is not None:
            self.router.stop()
        for rep in self.replicas.values():
            rep.stop()
        self.replicas.clear()


class SimWarmer:
    """:class:`~tony_tpu_torch.serving.weightstore.FleetWarmer` over a
    :class:`SimFleet` — deterministic twin of ``ChannelWarmer`` for
    chaos and bench runs. A peer ship takes ``ship_s`` of injected
    wall time, a storage load ``load_s`` (typically >> ship_s: that
    gap IS the cold-start the warm path kills). ``ship`` raises when
    the seeder replica was killed (crash mid-ship chaos), which
    :func:`~tony_tpu_torch.serving.weightstore.warm_fanout` absorbs by
    condemning the seeder and (with ``fallback``) minting a fresh one
    off storage — the fleet never wedges. Warmed replicas get
    ``version`` stamped as their weights_version, so the router pins
    sessions to the new generation exactly as with real replicas."""

    def __init__(self, fleet: SimFleet, version: str,
                 seeders=(), ship_s: float = 0.0, load_s: float = 0.0,
                 fallback: bool = True) -> None:
        self.fleet = fleet
        self.version = version
        self.seeders = list(seeders)
        self.ship_s = ship_s
        self.load_s = load_s
        self.fallback = fallback
        self.loads = 0                      # storage loads consumed
        self.last: dict | None = None       # last warm_fanout summary

    def warm(self, targets) -> dict:
        from tony_tpu_torch.serving.weightstore import warm_fanout

        self.last = warm_fanout(
            list(targets), self._ship, seeders=list(self.seeders),
            fallback=self._load if self.fallback else None)
        # freshly-warmed replicas stay seeders for the NEXT pass too
        for addr in self.last["warmed"] + self.last["fallback"]:
            if addr not in self.seeders:
                self.seeders.append(addr)
        return self.last

    def _alive(self, addr: str):
        rep = self.fleet.replicas.get(addr)
        if rep is None or rep._stopping.is_set():
            return None
        return rep

    def _ship(self, src: str, dst: str) -> None:
        if self._alive(src) is None:
            raise RuntimeError(f"seeder {src} crashed mid-ship")
        if self.ship_s:
            time.sleep(self.ship_s)
        if self._alive(src) is None:        # crashed DURING the ship
            raise RuntimeError(f"seeder {src} crashed mid-ship")
        self._mark(dst)

    def _load(self, dst: str) -> None:
        if self.load_s:
            time.sleep(self.load_s)
        self.loads += 1
        self._mark(dst)

    def _mark(self, dst: str) -> None:
        rep = self.fleet.replicas.get(dst)
        if rep is not None:
            rep.weights_version = self.version


class SimProvider:
    """:class:`~tony_tpu_torch.serving.fleet.CapacityProvider` over a
    :class:`SimFleet` — what the autoscale tests grow and shrink."""

    def __init__(self, fleet: SimFleet,
                 weights_version: str | None = None) -> None:
        self.fleet = fleet
        self.weights_version = weights_version

    def grow(self, n: int) -> list:
        return [self.fleet.spawn(weights_version=self.weights_version)
                for _ in range(n)]

    def release(self, addrs) -> None:
        for addr in addrs:
            self.fleet.reap(addr)


def open_loop_load(port: int, classes, *, interval_s: float = 0.0,
                   max_new: int = 8, prompt_len: int = 4,
                   retries: int = 0, seed_base: int = 1000,
                   host: str = "127.0.0.1",
                   event_timeout: float = 30.0) -> list:
    """Open-loop multi-class load generator: one submission every
    ``interval_s`` seconds REGARDLESS of completions (overload does not
    self-throttle — that is the point of open-loop), one request per
    entry of ``classes`` (a class name, or ``""``/``None`` for a
    classless ADMIT). Each request drains on its own thread and yields
    a record::

        {"cls", "ttft_s", "tokens", "shed", "retry_after_ms",
         "error", "ok"}

    where ``ok`` means the stream passed the oracle token-identity
    check — exactly ``max_new`` tokens equal to
    ``sim_token(seed_base + i, pos)`` for every position, across every
    preemption/requeue/failover the request survived. ``ttft_s`` counts
    from submit, so queueing and shedding delay show up in it."""
    from tony_tpu_torch.serving.client import (ServerBusy,
                                         ServingConnectionError,
                                         StreamingClient)

    records = [{"cls": c or "standard", "ttft_s": None, "tokens": [],
                "shed": False, "retry_after_ms": 0, "error": None,
                "ok": False} for c in classes]

    with StreamingClient(host, port) as client:
        def drain(i: int, rid: int, t_submit: float) -> None:
            rec = records[i]
            try:
                for delta in client.deltas(rid, timeout=event_timeout):
                    if rec["ttft_s"] is None:
                        rec["ttft_s"] = time.monotonic() - t_submit
                    rec["tokens"].extend(delta)
            except ServerBusy as e:
                rec["shed"] = True
                rec["retry_after_ms"] = e.retry_after_ms
                return
            except ServingConnectionError as e:
                rec["error"] = str(e)
                return
            seed = seed_base + i
            want = [sim_token(seed, p) for p in range(max_new)]
            rec["ok"] = rec["tokens"] == want

        threads = []
        t0 = time.monotonic()
        for i, cls in enumerate(classes):
            wait = t0 + i * interval_s - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            prompt = [seed_base + i] * prompt_len
            rid = client.submit(prompt, max_new,
                                request_class=cls or None,
                                retries=retries)
            th = threading.Thread(
                target=drain, name=f"tony-sim-load-{i}",
                args=(i, rid, time.monotonic()), daemon=True)
            th.start()
            threads.append(th)
        for th in threads:
            th.join(timeout=event_timeout + 5.0)
    return records
