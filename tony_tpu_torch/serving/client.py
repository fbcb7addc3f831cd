"""Streaming serving client: one persistent connection, many in-flight
requests, server-pushed token deltas.

The port's copy of ``tony_tpu/serving/client.py`` (stdlib only): it
speaks TONYS1 to the port's server and to the JAX package's alike.

The client is transport-only (stdlib, no jax) — a gateway process or a
test can drive a remote serving host (or the router front-door, which
speaks the same protocol) without the model stack installed.

Usage::

    with StreamingClient("10.0.0.5", 7070) as c:
        rid = c.submit(prompt, max_new_tokens=64)
        for delta in c.deltas(rid):        # lists of ints, as pushed
            emit(delta)
        tokens, reason = c.result(rid)     # or: collect in one call

A reader thread demultiplexes frames by request id into per-request
event queues, so any number of threads can stream different requests
concurrently. ``submit(stream=False)`` + ``poll()`` is the long-poll
(request/response-per-chunk) mode — kept as the streaming bench's
contrast arm and for dumb clients.
"""

from __future__ import annotations

import itertools
import queue
import random
import socket
import threading

from tony_tpu_torch.runtime import tracing
from tony_tpu_torch.serving import protocol as P

#: ceiling on one busy-retry backoff sleep — the hint grows
#: exponentially per attempt but never past this (milliseconds)
BUSY_BACKOFF_CAP_MS = 5000


class ServingConnectionError(ConnectionError):
    """The serving connection failed (handshake, mid-stream loss, or a
    connection-scoped server ERROR)."""


class ServerBusy(ServingConnectionError):
    """The server shed this request under overload (the BUSY terminal
    frame): nothing was computed, nothing streamed — re-admit after
    ``retry_after_ms``. Raised only once any ``submit(retries=)``
    budget is exhausted; transparent re-admissions never surface."""

    def __init__(self, retry_after_ms: int) -> None:
        super().__init__(
            f"server busy; retry after {int(retry_after_ms)}ms")
        self.retry_after_ms = int(retry_after_ms)


class StreamingClient:
    def __init__(self, host: str, port: int,
                 connect_timeout: float = 10.0) -> None:
        self._sock = socket.create_connection((host, port),
                                              timeout=connect_timeout)
        P.set_nodelay(self._sock)
        self._sock.settimeout(None)
        self._send_lock = threading.Lock()
        self._lock = threading.Lock()
        self._queues: dict[int, queue.Queue] = {}
        #: rid -> (client.request span, client.ttft span) — the
        #: client-side leg of the end-to-end request trace; the span
        #: context rides the ADMIT frame so the router's and engine's
        #: spans join the same trace
        self._spans: dict[int, tuple] = {}
        self._stats_q: queue.Queue = queue.Queue()
        #: rid -> [admit body, retries left, attempts made] — consulted
        #: by the reader thread when a BUSY lands; re-admission rides a
        #: one-shot timer thread so the reader never sleeps
        self._retries: dict[int, list] = {}
        self._next_rid = itertools.count(1)
        self._closed = False
        self._conn_error: str | None = None
        try:
            self._sock.sendall(P.MAGIC)
            hello = P.recv_frame(self._sock)
        except (OSError, P.ProtocolError) as e:
            self._sock.close()
            raise ServingConnectionError(f"handshake failed: {e}") from e
        if hello is None or hello[0] != P.HELLO:
            self._sock.close()
            raise ServingConnectionError("no HELLO from server")
        self.hello = P.unpack_json(hello[2])
        self._reader = threading.Thread(target=self._read_loop,
                                        name="tony-serve-client-reader",
                                        daemon=True)
        self._reader.start()

    # -- wire ---------------------------------------------------------------
    def _send(self, ftype: int, rid: int, payload: bytes = b"") -> None:
        with self._send_lock:
            if self._closed:
                raise ServingConnectionError(
                    self._conn_error or "client is closed")
            try:
                P.send_frame(self._sock, ftype, rid, payload)
            except OSError as e:
                raise ServingConnectionError(str(e)) from e

    def _read_loop(self) -> None:
        error = "connection closed by server"
        try:
            while True:
                frame = P.recv_frame(self._sock)
                if frame is None:
                    break
                ftype, rid, payload = frame
                if ftype == P.TOKENS:
                    self._end_span(rid, ttft_only=True)
                    self._dispatch(rid, ("tokens",
                                         P.unpack_tokens(payload)))
                elif ftype == P.RETIRED:
                    obj = P.unpack_json(payload)
                    self._end_span(rid,
                                   reason=obj.get("reason", "unknown"),
                                   tokens=obj.get("tokens", 0))
                    self._dispatch(rid, ("retired",
                                         obj.get("reason", "unknown"),
                                         obj.get("tokens", 0)))
                elif ftype == P.ERROR:
                    msg = P.unpack_json(payload).get("message", "error")
                    if rid == 0:
                        error = f"server error: {msg}"
                        break               # connection-scoped: fatal
                    self._end_span(rid, reason="error")
                    self._dispatch(rid, ("error", msg))
                elif ftype == P.BUSY:
                    obj = P.unpack_json(payload)
                    hint = int(obj.get("retry_after_ms", 0) or 0)
                    if not self._retry_busy(rid, hint):
                        self._end_span(rid, reason="busy")
                        self._dispatch(rid, ("busy", hint))
                elif ftype == P.STATS:
                    self._stats_q.put(P.unpack_json(payload))
                elif ftype == P.PREFIX:
                    self._dispatch(rid, ("prefix",
                                         P.unpack_json(payload)))
                elif ftype == P.DRAIN:
                    self._dispatch(rid, ("drain",
                                         P.unpack_json(payload)))
                # unknown server frames are ignored (forward compat) —
                # including MIGRATE acks: migrate() is fire-and-forget
                # (the migrated stream itself just keeps delivering on
                # its own rid)
        except (P.ProtocolError, OSError) as e:
            error = str(e)
        with self._lock:
            self._closed = True
            self._conn_error = error
            queues = list(self._queues.values())
        fatal = ("error", error)
        for q in queues:
            q.put(fatal)
        self._stats_q.put({"error": error})
        with self._lock:
            spans = list(self._spans)
        for rid in spans:
            self._end_span(rid, reason="connection_lost")

    def _end_span(self, rid: int, ttft_only: bool = False,
                  **attrs) -> None:
        with self._lock:
            pair = self._spans.get(rid)
            if pair is None:
                return
            if not ttft_only:
                del self._spans[rid]
        pair[1].end()                      # first TOKENS frame = TTFT
        if not ttft_only:
            pair[0].end(**attrs)

    def _dispatch(self, rid: int, event: tuple) -> None:
        with self._lock:
            q = self._queues.get(rid)
        if q is not None:
            q.put(event)

    def _retry_busy(self, rid: int, hint_ms: int) -> bool:
        """A BUSY landed for ``rid``: consume one retry if any remain.
        The re-admission is TRANSPARENT — same rid, same event queue,
        same spans (TTFT keeps counting from the original submit, which
        is what the caller experiences) — and rides a one-shot timer
        thread so the reader loop never sleeps through other streams'
        deltas. Returns False when the budget is spent (the BUSY
        surfaces to the consumer)."""
        with self._lock:
            st = self._retries.get(rid)
            if st is None or st[1] <= 0:
                return False
            st[1] -= 1
            attempt, body = st[2], st[0]
            st[2] += 1
        # capped exponential backoff on the server's hint, jittered
        # +/-25% so a shed burst does not re-arrive as a burst
        base = max(int(hint_ms), 1) * (2 ** attempt)
        delay = min(base, BUSY_BACKOFF_CAP_MS) / 1000.0
        delay *= 0.75 + 0.5 * random.random()

        def _readmit() -> None:
            try:
                self._send(P.ADMIT, rid, P.pack_json(body))
            except ServingConnectionError as e:
                self._end_span(rid, reason="send_failed")
                self._dispatch(rid, ("error", str(e)))

        t = threading.Timer(delay, _readmit)
        t.name = f"tony-client-retry-{rid}"
        t.daemon = True
        t.start()
        return True

    # -- request surface ----------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, stream: bool = True,
               rid: int | None = None,
               prefix_id: str | None = None,
               request_class: str | None = None,
               retries: int = 0) -> int:
        """Admit a request; returns its (client-chosen or auto) rid.
        ``prefix_id`` optionally names the shared prefix the prompt
        continues (prefix-aware routing/admission); routers also
        token-match unnamed prompts against their catalog, so it is
        never required. ``request_class`` names the QoS tier
        (``interactive``/``standard``/``batch``; None omits the field —
        old servers see the old wire and new servers default it to
        ``standard``). ``retries`` is the BUSY budget: that many
        transparent re-admissions with capped jittered backoff on the
        server's hint before :class:`ServerBusy` surfaces."""
        if rid is None:
            rid = next(self._next_rid)
        tr = tracing.get_tracer()
        sp = tr.start_span("client.request", rid=rid,
                           prompt_tokens=len(prompt))
        body = {"prompt": [int(t) for t in prompt],
                "max_new_tokens": int(max_new_tokens), "stream": stream}
        if prefix_id is not None:
            body["prefix"] = str(prefix_id)
        if request_class is not None:
            # pass-through, not validated here: the server owns the
            # class vocabulary and answers an unknown one with a
            # request-scoped ERROR
            body["class"] = str(request_class)
        if sp.recording:
            # propagate the client's span context so the router's and
            # engine's spans join this trace (the end-to-end TTFT
            # decomposition)
            body["trace"] = sp.context
        with self._lock:
            if self._closed:
                sp.end(reason="closed")
                raise ServingConnectionError(
                    self._conn_error or "client is closed")
            self._queues[rid] = queue.Queue()
            if retries > 0:
                self._retries[rid] = [body, int(retries), 0]
            self._spans[rid] = (sp, tr.start_span("client.ttft",
                                                  parent=sp))
        try:
            self._send(P.ADMIT, rid, P.pack_json(body))
        except ServingConnectionError:
            self._end_span(rid, reason="send_failed")
            raise
        return rid

    def cancel(self, rid: int) -> None:
        self._send(P.CANCEL, rid)

    def next_event(self, rid: int, timeout: float | None = None):
        """Next event for ``rid``: ``("tokens", [ints])``,
        ``("retired", reason, n)``, or ``("error", message)``. Raises
        ``queue.Empty`` on timeout."""
        with self._lock:
            q = self._queues.get(rid)
        if q is None:
            raise KeyError(f"unknown request id {rid}")
        return q.get(timeout=timeout)

    def _abandon(self, rid: int) -> None:
        """A consumer walked away from a live request (timeout, early
        generator exit): best-effort CANCEL so the server frees the
        slot instead of generating into the void, then release the
        local queue."""
        try:
            self.cancel(rid)
        except ServingConnectionError:
            pass
        self._forget(rid)

    def _event_or_raise(self, rid: int, timeout: float | None):
        """next_event with the documented failure surface: a timeout
        (the stream went silent — ``timeout`` is the per-EVENT bound,
        not the whole request's) cancels the abandoned request and
        raises ``ServingConnectionError``, never a raw
        ``queue.Empty``."""
        try:
            return self.next_event(rid, timeout=timeout)
        except queue.Empty:
            self._abandon(rid)
            raise ServingConnectionError(
                f"no event for request {rid} within {timeout}s") from None

    def deltas(self, rid: int, timeout: float | None = 120.0):
        """Yield token deltas (lists of ints) as the server pushes them;
        returns on retirement, raises ``ServingConnectionError`` on
        error or on ``timeout`` seconds without any event. Abandoning
        the generator early (``break``/close) CANCELs the request. The
        terminal reason is left for :meth:`result` callers — this
        generator is the 'emit tokens to the user as they land'
        surface."""
        finished = False
        try:
            while True:
                ev = self._event_or_raise(rid, timeout)
                if ev[0] == "tokens":
                    yield ev[1]
                elif ev[0] == "retired":
                    finished = True
                    self._forget(rid)
                    return
                elif ev[0] == "busy":
                    finished = True         # terminal: nothing to cancel
                    self._forget(rid)
                    raise ServerBusy(ev[1])
                else:
                    finished = True
                    self._forget(rid)
                    raise ServingConnectionError(ev[1])
        finally:
            if not finished:
                self._abandon(rid)

    def result(self, rid: int, timeout: float | None = 120.0):
        """Block until ``rid`` retires; returns ``(tokens, reason)``.
        ``timeout`` bounds the wait per EVENT, not the whole request."""
        tokens: list[int] = []
        while True:
            ev = self._event_or_raise(rid, timeout)
            if ev[0] == "tokens":
                tokens.extend(ev[1])
            elif ev[0] == "retired":
                self._forget(rid)
                return tokens, ev[1]
            elif ev[0] == "busy":
                self._forget(rid)
                raise ServerBusy(ev[1])
            else:
                self._forget(rid)
                raise ServingConnectionError(ev[1])

    def poll(self, rid: int, timeout: float | None = 120.0):
        """Long-poll a ``stream=False`` request: one request/response
        round trip per call (the per-chunk baseline the streaming wire
        replaces). Returns ``(tokens, None)`` while live and
        ``([], reason)`` once retired."""
        self._send(P.POLL, rid)
        ev = self._event_or_raise(rid, timeout)
        if ev[0] == "tokens":
            return ev[1], None
        if ev[0] == "retired":
            self._forget(rid)
            return [], ev[1]
        self._forget(rid)
        if ev[0] == "busy":
            raise ServerBusy(ev[1])
        raise ServingConnectionError(ev[1])

    def prefix_op(self, op: str, timeout: float | None = 60.0,
                  **fields) -> dict:
        """One PREFIX-frame round trip (prefix-aware serving): replica
        ops ``install`` (``tokens=``, optional ``id=``), ``publish``
        (``id=``, ``target=`` — the peer's ``host:prefix_port``
        template lane) and ``list``; router ops ``register``
        (``tokens=``) and ``list``. Returns the reply object
        (``{"ok": bool, ...}`` — op failures are returned, not
        raised); raises ``ServingConnectionError`` only on transport
        loss."""
        rid = next(self._next_rid)
        with self._lock:
            if self._closed:
                raise ServingConnectionError(
                    self._conn_error or "client is closed")
            self._queues[rid] = queue.Queue()
        try:
            self._send(P.PREFIX, rid,
                       P.pack_json(dict(fields, op=op)))
            ev = self._event_or_raise(rid, timeout)
        finally:
            self._forget(rid)
        if ev[0] == "prefix":
            return ev[1]
        raise ServingConnectionError(
            ev[1] if ev[0] == "error" else f"unexpected reply {ev[0]}")

    def drain_replica(self, replica: str, timeout_s: float = 120.0,
                      timeout: float | None = None) -> dict:
        """Operator op against a ROUTER: fence ``replica`` and
        live-migrate every session off it (planned maintenance /
        rolling upgrades — see docs/serving.md §Operating the fleet).
        Blocks until the router reports the drain finished; returns its
        summary ``{"ok", "replica", "drained", "migrated", "wall_s",
        ...}``. ``timeout_s`` is the ROUTER's drain deadline;
        ``timeout`` (default ``timeout_s + 30``) is this call's local
        reply wait. Raises ``ServingConnectionError`` on transport loss
        or a rejected request (unknown frame on a plain replica, bad
        replica name)."""
        rid = next(self._next_rid)
        with self._lock:
            if self._closed:
                raise ServingConnectionError(
                    self._conn_error or "client is closed")
            self._queues[rid] = queue.Queue()
        if timeout is None:
            timeout = timeout_s + 30.0
        try:
            self._send(P.DRAIN, rid, P.pack_json(
                {"replica": replica, "timeout_s": timeout_s}))
            ev = self._event_or_raise(rid, timeout)
        finally:
            self._forget(rid)
        if ev[0] == "drain":
            return ev[1]
        raise ServingConnectionError(
            ev[1] if ev[0] == "error" else f"unexpected reply {ev[0]}")

    def migrate(self, rid: int) -> None:
        """Ask the router to live-migrate one of this client's OWN
        streams (``rid`` from :meth:`submit`) onto another replica —
        the single-session form of :meth:`drain_replica`.
        Fire-and-forget: on success the stream just continues on its
        rid with no duplicated or dropped tokens; if the session cannot
        move (already finishing, no eligible replica) it continues
        where it is."""
        self._send(P.MIGRATE, rid)

    def stats(self, timeout: float | None = 30.0) -> dict:
        """Server stats snapshot (the ``tony_serve_queue_depth`` gauge
        et al. — what the router places by)."""
        self._send(P.STATS, 0)
        out = self._stats_q.get(timeout=timeout)
        if "error" in out:
            raise ServingConnectionError(out["error"])
        return out

    def _forget(self, rid: int) -> None:
        with self._lock:
            self._queues.pop(rid, None)
            self._retries.pop(rid, None)

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        with self._lock:
            self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self._reader.is_alive():
            self._reader.join(timeout=5)

    def __enter__(self) -> "StreamingClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
