"""Distributed tracing plane + crash flight recorder.

The port's copy of ``tony_tpu/runtime/tracing.py`` (stdlib only; the
port imports nothing of ``tony_tpu``), so the serving client's
``client.request``/``client.ttft`` spans and the engine's request spans
keep the JAX package's names, wire form and sampling.

The metrics plane (``runtime/metrics.py``) answers "how much / how fast
on average"; this module answers "WHY was this one slow" — the causal
chain of a single request, step, or incident across processes. It rides
the same proven transports: producers record spans into a process-local
ring, the executor batches them onto heartbeats, the coordinator folds
them into ``TRACE_SPAN`` jhist events (with a per-task clock-offset
estimate applied at export), and the history server renders the job's
spans as Chrome-trace JSON (``GET /api/jobs/<id>/trace``,
Perfetto-loadable).

Design constraints (mirrors metrics.py):

- **dependency-free** — stdlib only; importable from the jax-free
  serving client, the executor, and user training processes alike;
- **cheap when off** — an unsampled span is one RNG draw and a constant
  return; a recorded span is one dict build + two deque appends. The
  bench's trace-overhead arm pins the sampled-on cost under 1 % of a
  serve chunk's wall;
- **never load-bearing** — a tracing failure (spool IO, malformed batch,
  dump error) is logged and dropped; it must never cost a heartbeat, a
  request, or a step.

Span model: 128-bit trace ids (32 hex chars), 64-bit span ids, parent
links, wall-clock start (``time.time()`` so cross-process spans align
after clock-offset correction) with ``perf_counter``-derived durations.
Head sampling: the decision is made ONCE at the trace root
(``tony.trace.sample-rate``); children — including remote children
created from a propagated context — inherit it. ``coarse=True`` roots
(job lifecycle, bring-up, incidents) bypass sampling and are always
recorded.

The flight recorder is the second leg: every process keeps a bounded
ring of recent spans + structured events; on an incident (abnormal child
exit, ``GangLostError``, a connection-scoped ``ProtocolError``) the ring
dumps to a JSON file under the job dir — a postmortem artifact instead
of only an exit code — and the executor ships the tail of its ring on
its final heartbeat so the coordinator can attach it to the incident's
jhist event.
"""

from __future__ import annotations

import contextlib
import contextvars
import hashlib
import json
import logging
import math
import os
import random
import re
import tempfile
import threading
import time
from collections import deque

log = logging.getLogger(__name__)

# Env plumbing (exported by the coordinator/executor; see constants.py
# for the canonical names — duplicated literally here so this module
# stays importable without the tony_tpu package root).
ENV_SPOOL = "TONY_TRACE_SPOOL"
ENV_PROC = "TONY_TRACE_PROC"
ENV_CTX = "TONY_TRACE_CTX"
ENV_SAMPLE_RATE = "TONY_TRACE_SAMPLE_RATE"
ENV_RING = "TONY_TRACE_RING"
ENV_FLIGHT_DIR = "TONY_FLIGHT_DIR"
ENV_FLIGHT_RING = "TONY_FLIGHT_RING"

#: spans shipped per heartbeat batch at most; the rest wait for the next
#: beat (the pending deque is bounded separately, so a stalled transport
#: degrades to dropped-oldest, never unbounded memory)
MAX_SPANS_PER_BATCH = 256
#: pending-ship buffer bound (per process)
DEFAULT_RING = 2048
DEFAULT_FLIGHT_RING = 256
#: flight dumps are incident artifacts, not a log stream: a flood of
#: malformed connections must not turn into a flood of files. The quota
#: is PER REASON — externally-triggerable dumps (a port scanner hitting
#: a serving port raises protocol_error repeatedly) must never starve a
#: later genuine incident's dump (gang_lost, child_exit) — with a
#: process-wide backstop.
MAX_DUMPS_PER_REASON = 4
MAX_DUMPS_PER_PROCESS = 32

_HEX_RE = re.compile(r"^[0-9a-f]{1,64}$")

_current_span: contextvars.ContextVar["Span | None"] = \
    contextvars.ContextVar("trace_current_span", default=None)

#: serializes end()'s ended-flag transition: the serve engine ends a
#: request's spans from the cancelling thread AND the engine thread in
#: the supported CANCEL-races-retirement case — a bare check-then-set
#: could record the span twice. One uncontended module lock (~100 ns)
#: beats a lock object per span.
_end_lock = threading.Lock()


# Id generation must NOT ride the global `random` module: training
# scripts routinely `random.seed(fixed)` identically on every worker,
# which would make every task emit the SAME trace/span ids and corrupt
# the folded cross-process trace. SystemRandom is urandom-backed —
# stateless, thread-safe, immune to user seeding.
_id_rng = random.SystemRandom()
# Sampling draws are cheap-path: a private auto-seeded (urandom)
# instance — unaffected by user seeding; a theoretical thread race only
# skews one sampling decision, never an id.
_sample_rng = random.Random()


def new_trace_id() -> str:
    return f"{_id_rng.getrandbits(128):032x}"


def new_span_id() -> str:
    return f"{_id_rng.getrandbits(64):016x}"


def deterministic_trace_id(seed: str) -> str:
    """128-bit trace id every party can derive from shared knowledge —
    how pipeline stage gangs agree on a per-step trace id without any
    new channel frames (seed = job trace id + step ordinal)."""
    return hashlib.sha256(seed.encode("utf-8")).hexdigest()[:32]


def deterministic_span_id(seed: str) -> str:
    return hashlib.sha256(seed.encode("utf-8")).hexdigest()[32:48]


def deterministic_sample(key: str, rate: float) -> bool:
    """Head-sampling decision every party reaches independently from
    shared knowledge — so all stages of one pipeline step record (or
    skip) the same step under partial sampling."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    h = int(hashlib.sha256(key.encode("utf-8")).hexdigest()[:8], 16)
    return h / float(0xFFFFFFFF) < rate


class Span:
    """One live span. End it exactly once (``end()`` or the tracer's
    context manager); attrs set after end are lost."""

    __slots__ = ("tracer", "trace_id", "span_id", "parent_id", "name",
                 "ts", "_t0", "attrs", "_ended")

    recording = True

    def __init__(self, tracer: "Tracer", trace_id: str, span_id: str,
                 parent_id: str, name: str, attrs: dict) -> None:
        self.tracer = tracer
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.ts = time.time()
        self._t0 = time.perf_counter()
        self.attrs = attrs
        self._ended = False

    @property
    def context(self) -> dict:
        """Wire context for cross-process propagation (the ADMIT
        ``trace`` field / the ``TONY_TRACE_CTX`` env shape)."""
        return {"tid": self.trace_id, "sid": self.span_id}

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def end(self, **attrs) -> None:
        with _end_lock:
            if self._ended:
                return
            self._ended = True
        if attrs:
            self.attrs.update(attrs)
        self.tracer._finish(self, time.perf_counter() - self._t0)


class _NoopSpan:
    """Unsampled/disabled span: absorbs the API at near-zero cost and
    propagates 'not recording' to children."""

    __slots__ = ()
    recording = False
    trace_id = ""
    span_id = ""
    parent_id = ""
    context = None

    def set(self, **attrs) -> None: ...
    def end(self, **attrs) -> None: ...


NOOP_SPAN = _NoopSpan()


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def parse_env_ctx(value: str | None = None) -> dict | None:
    """Parse a ``tid:sid`` env context (``TONY_TRACE_CTX``)."""
    value = value if value is not None else os.environ.get(ENV_CTX, "")
    if not value or ":" not in value:
        return None
    tid, _, sid = value.partition(":")
    if _HEX_RE.match(tid) and _HEX_RE.match(sid):
        return {"tid": tid, "sid": sid}
    return None


def format_env_ctx(ctx: dict) -> str:
    return f"{ctx['tid']}:{ctx['sid']}"


class Tracer:
    """Process-local span factory + bounded storage.

    Two deques per tracer: ``_pending`` holds finished spans awaiting
    shipment (drained onto heartbeats / jhist), ``_ring`` keeps the most
    recent spans regardless of shipment — the flight recorder's view.
    Overflowing ``_pending`` drops the OLDEST spans and counts them
    (``tony_trace_dropped_total``): under a stalled transport, recent
    causality beats ancient completeness.
    """

    def __init__(self, proc: str | None = None,
                 sample_rate: float | None = None,
                 ring_size: int | None = None,
                 spool_path: str | None = None,
                 enabled: bool = True) -> None:
        self.proc = proc if proc is not None else (
            os.environ.get(ENV_PROC) or f"pid:{os.getpid()}")
        self.sample_rate = (sample_rate if sample_rate is not None
                            else _env_float(ENV_SAMPLE_RATE, 1.0))
        self.enabled = enabled
        size = ring_size if ring_size is not None \
            else _env_int(ENV_RING, DEFAULT_RING)
        self._lock = threading.Lock()
        self._pending: deque[dict] = deque()
        self._pending_cap = max(16, size)
        self._ring: deque[dict] = deque(maxlen=max(16, size))
        self.dropped = 0
        self.recorded = 0
        self.spool_path = (spool_path if spool_path is not None
                           else os.environ.get(ENV_SPOOL) or None)
        self._spool_file = None
        self._spool_failed = False
        self._counters = None

    # -- span surface -------------------------------------------------------
    def _sampled_root(self, coarse: bool) -> bool:
        if not self.enabled:
            return False
        if coarse:
            return True
        r = self.sample_rate
        return r > 0 and (r >= 1.0 or _sample_rng.random() < r)

    def start_span(self, name: str, *, ctx: dict | None = None,
                   parent: "Span | _NoopSpan | None" = None,
                   coarse: bool = False, **attrs) -> "Span | _NoopSpan":
        """Start a span. Parent precedence: explicit ``parent`` >
        propagated wire ``ctx`` > the contextvar set by :meth:`span`.
        A remote ctx means the HEAD already sampled this trace — it is
        always recorded (head sampling)."""
        if not self.enabled:
            return NOOP_SPAN
        if parent is None and ctx is None:
            parent = _current_span.get()
        if parent is not None:
            if not parent.recording:
                return NOOP_SPAN
            return Span(self, parent.trace_id, new_span_id(),
                        parent.span_id, name, attrs)
        if ctx is not None:
            tid, sid = str(ctx.get("tid", "")), str(ctx.get("sid", ""))
            if not (_HEX_RE.match(tid) and _HEX_RE.match(sid)):
                ctx = None
            else:
                return Span(self, tid, new_span_id(), sid, name, attrs)
        if not self._sampled_root(coarse):
            return NOOP_SPAN
        return Span(self, new_trace_id(), new_span_id(), "", name, attrs)

    @contextlib.contextmanager
    def span(self, name: str, *, ctx: dict | None = None,
             coarse: bool = False, **attrs):
        """Context-manager span, parented on (and installed as) the
        ambient current span for the duration."""
        # the span itself (recording or NOOP) becomes the ambient
        # parent: an UNSAMPLED span must suppress its children too (a
        # None here would let nested spans re-roll the sampling dice as
        # orphan roots — breaking head sampling's one-decision-per-trace
        # invariant)
        sp = self.start_span(name, ctx=ctx, coarse=coarse, **attrs)
        token = _current_span.set(sp)
        try:
            yield sp
        finally:
            _current_span.reset(token)
            sp.end()

    def record_span(self, name: str, duration_s: float, *,
                    end_time: float | None = None,
                    trace_id: str | None = None,
                    span_id: str | None = None,
                    parent_id: str = "",
                    parent: "Span | _NoopSpan | None" = None,
                    ctx: dict | None = None,
                    coarse: bool = True, **attrs) -> None:
        """Record an already-finished span (bring-up timings measured by
        the backend, data-wait intervals, deterministic pipeline spans).
        Explicit ids win over ``parent``/``ctx``; with neither, the span
        roots its own trace subject to ``coarse``/sampling."""
        if not self.enabled:
            return
        if trace_id is None:
            if parent is None and ctx is None:
                parent = _current_span.get()
            if parent is not None:
                if not parent.recording:
                    return
                trace_id, parent_id = parent.trace_id, parent.span_id
            elif ctx is not None and _HEX_RE.match(str(ctx.get("tid", ""))):
                trace_id, parent_id = ctx["tid"], str(ctx.get("sid", ""))
            elif self._sampled_root(coarse):
                trace_id = new_trace_id()
            else:
                return
        end_time = time.time() if end_time is None else end_time
        self._store({
            "tid": trace_id, "sid": span_id or new_span_id(),
            "pid": parent_id, "n": name, "proc": self.proc,
            "ts": end_time - max(0.0, duration_s),
            "d": max(0.0, duration_s), "a": attrs})

    def current_context(self) -> dict | None:
        sp = _current_span.get()
        return sp.context if sp is not None and sp.recording else None

    # -- storage ------------------------------------------------------------
    def _metrics(self):
        if self._counters is None:
            from tony_tpu_torch.runtime import metrics as metrics_mod
            reg = metrics_mod.get_default()
            self._counters = (
                reg.counter("tony_trace_spans_total",
                            help="spans recorded by this process"),
                reg.counter("tony_trace_dropped_total",
                            help="spans dropped on pending-buffer "
                                 "overflow"))
        return self._counters

    def _finish(self, span: Span, duration_s: float) -> None:
        self._store({
            "tid": span.trace_id, "sid": span.span_id,
            "pid": span.parent_id, "n": span.name, "proc": self.proc,
            "ts": span.ts, "d": duration_s, "a": span.attrs})

    def _store(self, wire: dict) -> None:
        spans_c, dropped_c = self._metrics()
        with self._lock:
            self.recorded += 1
            self._ring.append(wire)
            self._pending.append(wire)
            overflow = len(self._pending) - self._pending_cap
            for _ in range(overflow):
                self._pending.popleft()
                self.dropped += 1
        spans_c.inc()
        if overflow > 0:
            dropped_c.inc(overflow)
        if self.spool_path:
            self._spool(wire)

    def _spool(self, wire: dict) -> None:
        """Mirror finished spans to the per-task spool file the executor
        tails onto heartbeats — the bridge from the fork-exec'd user
        process to the coordinator. Best-effort: a spool error disables
        the spool (once, loudly), never the caller."""
        if self._spool_failed:
            return
        try:
            with self._lock:
                if self._spool_file is None:
                    self._spool_file = open(self.spool_path, "a",
                                            encoding="utf-8")
                self._spool_file.write(
                    json.dumps(wire, separators=(",", ":")) + "\n")
                self._spool_file.flush()
        except OSError:
            self._spool_failed = True
            log.warning("trace spool %s failed; spooling disabled",
                        self.spool_path, exc_info=True)

    def drain(self, max_spans: int = MAX_SPANS_PER_BATCH) -> list[dict]:
        """Pop up to ``max_spans`` pending spans (oldest first)."""
        out = []
        with self._lock:
            while self._pending and len(out) < max_spans:
                out.append(self._pending.popleft())
        return out

    def recent(self, n: int | None = None) -> list[dict]:
        """Most recent spans (the flight recorder's span view)."""
        with self._lock:
            spans = list(self._ring)
        return spans if n is None else spans[-n:]

    def close(self) -> None:
        with self._lock:
            if self._spool_file is not None:
                try:
                    self._spool_file.close()
                except OSError:
                    pass
                self._spool_file = None


# ---------------------------------------------------------------------------
# Wire codec + validation (heartbeat batch / jhist span payloads)
# ---------------------------------------------------------------------------
def encode_batch(spans: list[dict], flight: dict | None = None) -> str:
    """Compact heartbeat payload: ``{"s": [span...], "b": batch id,
    "f": tail?}``. The batch id lets the receiver drop a RE-DELIVERED
    batch (the heartbeat RPC retries on lost acks; span batches append
    coordinator-side, so unlike the last-snapshot metrics table a
    duplicate delivery would duplicate every span)."""
    obj: dict = {"s": spans, "b": new_span_id()}
    if flight:
        obj["f"] = flight
    return json.dumps(obj, separators=(",", ":"))


def _check_num(v, what: str) -> None:
    if isinstance(v, bool) or not isinstance(v, (int, float)) \
            or not math.isfinite(v):
        raise ValueError(f"non-finite or non-numeric {what}: {v!r}")


def validate_span(d: dict) -> dict:
    """Structural validation of one wire span; raises ValueError."""
    if not isinstance(d, dict):
        raise ValueError(f"span is not an object: {d!r}")
    for key in ("tid", "sid"):
        v = d.get(key)
        if not isinstance(v, str) or not _HEX_RE.match(v):
            raise ValueError(f"bad span {key}: {v!r}")
    pid = d.get("pid", "")
    if not isinstance(pid, str) or (pid and not _HEX_RE.match(pid)):
        raise ValueError(f"bad span pid: {pid!r}")
    if not isinstance(d.get("n"), str) or not d["n"]:
        raise ValueError(f"bad span name: {d.get('n')!r}")
    if not isinstance(d.get("proc", ""), str):
        raise ValueError(f"bad span proc: {d.get('proc')!r}")
    _check_num(d.get("ts"), "span ts")
    _check_num(d.get("d"), "span duration")
    attrs = d.get("a", {})
    if not isinstance(attrs, dict):
        raise ValueError(f"span attrs not an object: {attrs!r}")
    for k, v in attrs.items():
        if not isinstance(k, str) \
                or not isinstance(v, (str, int, float, bool)) \
                or (isinstance(v, float) and not math.isfinite(v)):
            raise ValueError(f"bad span attr {k!r}: {v!r}")
    return d


def validate_batch(obj: dict) -> dict:
    """Validate a heartbeat span batch. Raises ValueError on anything
    malformed — the coordinator drops the batch without costing the
    ping (the metrics-piggyback discipline)."""
    if not isinstance(obj, dict):
        raise ValueError("span batch is not an object")
    spans = obj.get("s", [])
    if not isinstance(spans, list) or len(spans) > 4 * MAX_SPANS_PER_BATCH:
        raise ValueError("span batch 's' is not a bounded list")
    for s in spans:
        validate_span(s)
    bid = obj.get("b", "")
    if not isinstance(bid, str) or (bid and not _HEX_RE.match(bid)):
        raise ValueError(f"span batch 'b' is not a hex id: {bid!r}")
    flight = obj.get("f")
    if flight is not None:
        if not isinstance(flight, dict) \
                or not isinstance(flight.get("events", []), list):
            raise ValueError("span batch 'f' is not a flight tail")
    return obj


def parse_batch_json(payload: str) -> dict:
    try:
        obj = json.loads(payload)
    except json.JSONDecodeError as e:
        raise ValueError(f"span batch is not JSON: {e}") from e
    return validate_batch(obj)


class SpoolReader:
    """Incremental reader over a span spool file (JSON lines appended by
    the user process's tracer). Tracks its offset, tolerates a partial
    trailing line (re-read next time) and skips malformed lines.
    :meth:`maybe_rotate` keeps the FILE bounded — the writer appends
    forever otherwise."""

    #: unread-backlog bound: past this the reader skips to EOF (recent
    #: causality beats ancient completeness) so a producer outpacing the
    #: heartbeat drain can never grow the file without bound
    MAX_BACKLOG_BYTES = 8 << 20

    def __init__(self, path: str) -> None:
        self.path = path
        self._offset = 0
        # the executor's FINAL beat (main thread) can race a still
        # in-flight periodic beat (heartbeater thread) on this reader —
        # an unsynchronized shared offset would ship spans twice or
        # rotate mid-read
        self._lock = threading.Lock()

    def maybe_rotate(self) -> None:
        """Bound the spool: fully consumed → truncate to zero (the
        writer's O_APPEND handle lands correctly at the new EOF); over
        the backlog bound → skip to EOF first, dropping the middle. A
        span appended in the tiny check-to-truncate window is lost —
        telemetry, not accounting."""
        with self._lock:
            try:
                size = os.path.getsize(self.path)
            except OSError:
                return
            if size - self._offset > self.MAX_BACKLOG_BYTES:
                log.warning("trace spool %s backlog %d bytes — skipping "
                            "to EOF", self.path, size - self._offset)
                self._offset = size
            if self._offset and self._offset >= size:
                try:
                    os.truncate(self.path, 0)
                except OSError:
                    return
                self._offset = 0

    def read_new(self, max_spans: int = MAX_SPANS_PER_BATCH) -> list[dict]:
        with self._lock:
            try:
                with open(self.path, "rb") as f:
                    f.seek(self._offset)
                    data = f.read()
            except OSError:
                return []
            if not data:
                return []
            end = data.rfind(b"\n")
            if end < 0:
                return []                  # partial first line; wait
            chunk, consumed = data[:end], end + 1
            out = []
            taken_bytes = 0
            for line in chunk.split(b"\n"):
                if len(out) >= max_spans:
                    break
                taken_bytes += len(line) + 1
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(validate_span(
                        json.loads(line.decode("utf-8"))))
                except (ValueError, UnicodeDecodeError):
                    continue               # one bad line never stalls
            self._offset += taken_bytes if len(out) >= max_spans \
                else consumed
            return out


# ---------------------------------------------------------------------------
# Clock alignment
# ---------------------------------------------------------------------------
def clock_offset(client_unix_time: float, client_rtt: float,
                 server_unix_time: float | None = None) -> float:
    """Heartbeat-RTT-midpoint skew estimate: the beat carries the
    sender's wall clock at send plus its last measured heartbeat RTT;
    under symmetric delay the send happened ``rtt/2`` before receipt,
    so ``server_now - (client_send + rtt/2)`` estimates
    ``server_clock - client_clock``. Add the offset to a task's span
    timestamps to express them on the coordinator's clock."""
    now = time.time() if server_unix_time is None else server_unix_time
    return now - (client_unix_time + max(0.0, client_rtt) / 2.0)


def apply_offset(spans: list[dict], offset_s: float) -> list[dict]:
    if not offset_s:
        return spans
    return [{**s, "ts": s["ts"] + offset_s} for s in spans]


# ---------------------------------------------------------------------------
# Chrome trace renderer (Perfetto / chrome://tracing loadable)
# ---------------------------------------------------------------------------
def to_chrome(spans: list[dict]) -> dict:
    """Render wire spans as Chrome Trace Event JSON: one ``pid`` per
    process label, one ``tid`` per (process, trace) pair — so every
    request/step gets its own track — with ``M`` metadata events naming
    both. Complete ``X`` events; timestamps in µs."""
    events: list[dict] = []
    pids: dict[str, int] = {}
    tids: dict[tuple[int, str], int] = {}
    for s in sorted(spans, key=lambda x: x.get("ts", 0.0)):
        proc = s.get("proc") or "?"
        pid = pids.get(proc)
        if pid is None:
            pid = pids[proc] = len(pids) + 1
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": proc}})
        tkey = (pid, s["tid"])
        tid = tids.get(tkey)
        if tid is None:
            tid = tids[tkey] = len(tids) + 1
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid,
                           "args": {"name": f"trace {s['tid'][:8]}"}})
        args = {str(k): v for k, v in (s.get("a") or {}).items()}
        args["trace_id"] = s["tid"]
        args["span_id"] = s["sid"]
        if s.get("pid"):
            args["parent_span_id"] = s["pid"]
        events.append({
            "ph": "X", "name": s["n"],
            "cat": s["n"].split(".", 1)[0],
            "ts": round(s["ts"] * 1e6, 3),
            "dur": round(max(0.0, s["d"]) * 1e6, 3),
            "pid": pid, "tid": tid, "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------
class FlightRecorder:
    """Bounded ring of structured events + (via the tracer) recent
    spans; ``dump()`` writes the postmortem JSON artifact. Everything is
    best-effort by contract — recording and dumping must never raise
    into the caller."""

    def __init__(self, proc: str | None = None,
                 ring_size: int | None = None,
                 dir_path: str | None = None) -> None:
        self.proc = proc if proc is not None else (
            os.environ.get(ENV_PROC) or f"pid:{os.getpid()}")
        size = ring_size if ring_size is not None \
            else _env_int(ENV_FLIGHT_RING, DEFAULT_FLIGHT_RING)
        # default dir: explicit env (the executor exports the job dir),
        # else the system temp dir — NOT the cwd, which for bare
        # processes (tests, notebooks) is often a source tree
        self.dir_path = dir_path or os.environ.get(ENV_FLIGHT_DIR) \
            or tempfile.gettempdir()
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=max(8, size))
        self._dumps = 0
        self._dumps_by_reason: dict[str, int] = {}
        self._counter = None

    def record(self, kind: str, **data) -> None:
        try:
            entry = {"ts": round(time.time(), 6), "kind": str(kind)}
            for k, v in data.items():
                if isinstance(v, (str, int, float, bool)) or v is None:
                    entry[k] = v
                else:
                    entry[k] = repr(v)[:500]
            with self._lock:
                self._ring.append(entry)
        except Exception:
            log.debug("flight record failed", exc_info=True)

    def tail(self, n: int = 32) -> list[dict]:
        with self._lock:
            entries = list(self._ring)
        return entries[-n:]

    def dump(self, reason: str, tracer: Tracer | None = None,
             path: str | None = None, **attrs) -> str | None:
        """Write the ring (+ the tracer's recent spans) as one JSON
        file; returns the path, or None on failure/over-quota. The
        final entry of every dump records the incident itself, so a
        parser can read the last entries to see what happened."""
        self.record("flight_dump", reason=reason, **attrs)
        tr = tracer if tracer is not None else get_tracer()
        with self._lock:
            by_reason = self._dumps_by_reason.get(reason, 0)
            if path is None and (self._dumps >= MAX_DUMPS_PER_PROCESS
                                 or by_reason >= MAX_DUMPS_PER_REASON):
                return None
            self._dumps += 1
            self._dumps_by_reason[reason] = by_reason + 1
            seq = self._dumps
            events = list(self._ring)
        doc = {
            "v": 1,
            "proc": self.proc,
            "reason": reason,
            "attrs": {k: v for k, v in attrs.items()
                      if isinstance(v, (str, int, float, bool))},
            "dumped_at": round(time.time(), 6),
            "pid": os.getpid(),
            "events": events,
            "spans": tr.recent(),
        }
        if path is None:
            safe = re.sub(r"[^A-Za-z0-9_.-]", "-", self.proc)
            path = os.path.join(
                self.dir_path,
                f"flight-{safe}-{os.getpid()}-{seq}.json")
        try:
            tmp = f"{path}.tmp-{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        except OSError:
            log.warning("flight dump to %s failed", path, exc_info=True)
            return None
        if self._counter is None:
            from tony_tpu_torch.runtime import metrics as metrics_mod
            self._counter = metrics_mod.get_default().counter(
                "tony_flight_dumps_total",
                help="flight-recorder postmortem dumps written")
        self._counter.inc()
        log.warning("flight recorder dumped to %s (reason: %s)",
                    path, reason)
        return path

    def ship_tail(self, reason: str, dump_path: str | None = None,
                  n: int = 32) -> dict:
        """The heartbeat-shippable tail: what the executor attaches to
        its final beat so the incident's jhist event carries the last
        moments even when nobody can read the host's disk."""
        return {"proc": self.proc, "reason": reason,
                "dump": dump_path or "", "events": self.tail(n)}


# ---------------------------------------------------------------------------
# Process-wide defaults
# ---------------------------------------------------------------------------
_default_tracer: Tracer | None = None
_default_flight: FlightRecorder | None = None
_default_lock = threading.Lock()


def get_tracer() -> Tracer:
    global _default_tracer
    if _default_tracer is None:
        with _default_lock:
            if _default_tracer is None:
                _default_tracer = Tracer()
    return _default_tracer


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process tracer (tests, bench contrast arms)."""
    global _default_tracer
    with _default_lock:
        prev, _default_tracer = _default_tracer, tracer
    return prev if prev is not None else tracer


def get_flight() -> FlightRecorder:
    global _default_flight
    if _default_flight is None:
        with _default_lock:
            if _default_flight is None:
                _default_flight = FlightRecorder()
    return _default_flight


def set_flight(flight: FlightRecorder) -> FlightRecorder:
    global _default_flight
    with _default_lock:
        prev, _default_flight = _default_flight, flight
    return prev if prev is not None else flight


def configure(proc: str | None = None, sample_rate: float | None = None,
              ring_size: int | None = None, spool_path: str | None = None,
              flight_dir: str | None = None,
              flight_ring: int | None = None) -> Tracer:
    """(Re)build the process tracer + flight recorder — the coordinator
    and executor call this once their config is loaded; everyone else
    inherits the env-driven defaults."""
    tracer = Tracer(proc=proc, sample_rate=sample_rate,
                    ring_size=ring_size, spool_path=spool_path)
    set_tracer(tracer)
    set_flight(FlightRecorder(proc=proc, ring_size=flight_ring,
                              dir_path=flight_dir))
    return tracer
