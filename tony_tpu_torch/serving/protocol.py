"""TONYS1 streaming serving protocol: the persistent token-push wire.

The port's copy of ``tony_tpu/serving/protocol.py``, byte for byte on
the wire: a client or server of either package talks to one of the
other.

One persistent TCP connection multiplexes many in-flight requests in
BOTH directions — the client pushes admissions and cancels, the server
pushes token deltas the moment the engine consumes them — replacing a
request/response round trip per chunk (the pre-streaming tunnel paid
~70-100 ms of transport per chunk AND per admission; see
docs/serving.md "Streaming serving"). The framing keeps the
self-describing discipline of the TONY1 record format
(``tony_tpu/io/framed.py``): a magic preamble so a stray peer fails
fast, an explicit length prefix so a reader can never lose sync, and a
JSON HELLO carrying the server's shape so clients need no out-of-band
schema.

Connection handshake::

    client -> server   magic  b"TONYS1\\0"
    server -> client   HELLO frame, JSON payload {"v": 1, "slots": N}

Frame layout (everything little-endian)::

    length   4 bytes  u32   bytes that FOLLOW (type + rid + payload)
    type     1 byte   u8    frame type (below)
    rid      8 bytes  u64   request id (0 = connection-scoped)
    payload  length-9 bytes

Frame types:

====== ============ ========= =====================================
 type   direction    payload   meaning
====== ============ ========= =====================================
ADMIT   c -> s       JSON      ``{"prompt": [ints], "max_new_tokens":
                               n, "stream": bool}`` — submit request
                               ``rid``. ``stream=false`` buffers
                               deltas server-side for POLL (the
                               request/response contrast arm).
CANCEL  c -> s       (empty)   cancel ``rid`` (idempotent).
POLL    c -> s       (empty)   long-poll ``rid``: the server answers
                               with one TOKENS frame as soon as it
                               has buffered deltas, or RETIRED once
                               the request is done and drained.
TOKENS  s -> c       u32[]     a token DELTA for ``rid`` (packed
                               little-endian u32s, in order).
RETIRED s -> c       JSON      ``{"reason": "eos"|"budget"|
                               "cancelled"|"stopped", "tokens": n}``
                               — terminal, exactly once per request.
ERROR   s -> c       JSON      ``{"message": str}``. ``rid != 0``:
                               that request failed (terminal for it).
                               ``rid == 0``: connection-scoped — the
                               server closes the connection after
                               sending it (a protocol violation never
                               kills the server, only the offending
                               connection).
STATS   c -> s       (empty)   request a stats snapshot;
        s -> c       JSON      answered with a STATS frame carrying
                               at least ``queue_depth`` (the
                               ``tony_serve_queue_depth`` gauge),
                               ``active``, ``slots`` — the router's
                               placement + health signal.
HELLO   s -> c       JSON      connection preamble (see above).
====== ============ ========= =====================================

Everything here is transport-only (stdlib, no jax): importable by thin
clients, the router, and tests alike.
"""

from __future__ import annotations

import json
import socket
import struct

MAGIC = b"TONYS1\0"

ADMIT = 1
CANCEL = 2
POLL = 3
TOKENS = 4
RETIRED = 5
ERROR = 6
STATS = 7
HELLO = 8
#: s -> c (prefill tier, disaggregated serving): request ``rid``'s
#: prefill finished and its KV package shipped to the decode gang named
#: in the JSON payload ({"decode": "host:port", ...}); the router moves
#: the session's ownership from the prefill link to the decode link on
#: this frame (a prefill replica dying AFTER it no longer affects the
#: stream).
HANDOFF = 9
#: c -> s (decode tier, disaggregated serving): this connection is the
#: DELTA SINK — the decode server pushes every KV-adopted row's TOKENS/
#: RETIRED frames here (rids are the shipper's, globally unique per
#: router). Last BIND wins; empty payload.
BIND = 10
#: c -> s then s -> c (prefix-aware serving): a JSON prefix-catalog op
#: and its reply on the same rid. Replica-side ops: ``install`` (make a
#: prefix resident by computing its K/V template locally), ``publish``
#: (ship a resident template to a peer replica's template lane — the
#: warm path), ``list``. Router-side ops: ``register`` (add a prefix to
#: the matching catalog), ``list``. Replies are
#: ``{"ok": bool, ...}`` — op failures are request-scoped, never
#: connection-scoped.
PREFIX = 11
#: c -> router then router -> c (fleet operations): ask the router to
#: DRAIN one replica — ``{"replica": "host:port", "timeout_s": n?}``
#: fences new placements there and live-migrates every session off it
#: (see :meth:`ServingRouter.drain`). The reply rides the same rid once
#: the drain settles: ``{"ok": bool, "replica": ..., "migrated": n,
#: "wall_s": s}``. Runs on a background thread — a drain never blocks
#: the operator connection's other frames.
DRAIN = 12
#: c -> router then router -> c (fleet operations): migrate ONE of the
#: caller's own sessions (``rid``) off its current replica. Reply is
#: ``{"ok": bool}`` on the same rid; the session's token stream is
#: unaffected either way (zero dup/drop — the coordinated-migration
#: contract).
MIGRATE = 13
#: c -> replica then replica -> c (warm scale-up, tony_tpu/serving/
#: weightstore.py): content-addressed weight / compiled-program
#: artifact ops — ``{"op": "publish", "digest", "target"}`` commands
#: this replica to ship a resident artifact to a peer's weights lane;
#: ``{"op": "list"}`` returns the resident digests. Replies are
#: ``{"ok": bool, ...}`` — op failures are request-scoped, never
#: connection-scoped.
WEIGHTS = 14
#: s -> c (QoS-tiered serving): explicit overload shed — the server
#: refuses to queue request ``rid`` and the client should retry after
#: the JSON payload's ``retry_after_ms`` hint. Terminal for ``rid``
#: (exactly one of TOKENS.../RETIRED, ERROR, or BUSY ends a request),
#: and a statement about LOAD, not about the request: the identical
#: ADMIT is expected to succeed once pressure clears, which is why it
#: is a distinct frame rather than an ERROR. Only ``standard``/
#: ``batch`` admissions are shed; ``interactive`` ones queue.
BUSY = 15

FRAME_NAMES = {ADMIT: "ADMIT", CANCEL: "CANCEL", POLL: "POLL",
               TOKENS: "TOKENS", RETIRED: "RETIRED", ERROR: "ERROR",
               STATS: "STATS", HELLO: "HELLO", HANDOFF: "HANDOFF",
               BIND: "BIND", PREFIX: "PREFIX", DRAIN: "DRAIN",
               MIGRATE: "MIGRATE", WEIGHTS: "WEIGHTS", BUSY: "BUSY"}

#: the serving plane's request classes, best SLO first: ``interactive``
#: jumps queues and may preempt batch rows, ``standard`` is the classic
#: FIFO tier (and what a class-less ADMIT means), ``batch`` yields to
#: everyone and absorbs preemption/shedding under overload.
QOS_CLASSES = ("interactive", "standard", "batch")

#: sanity bound on one frame's body (type + rid + payload). A prompt of
#: a million tokens is ~4 MB; anything past this is a corrupt length
#: prefix, not a request.
MAX_FRAME_BYTES = 1 << 24

_LEN = struct.Struct("<I")
_HDR = struct.Struct("<BQ")          # type, rid
_TOK = struct.Struct("<I")

#: bytes of (type, rid) header inside every frame body — what
#: :func:`frame_header` adds to a payload length before checking its
#: limit; exported so other planes' size guards can mirror the check.
BODY_HEADER_BYTES = _HDR.size


class ProtocolError(ValueError):
    """Malformed wire data. Connection-scoped by convention: handlers
    report it (an ERROR frame where possible) and close THAT connection;
    it must never propagate out of a server's per-connection handler."""


def set_nodelay(sock: socket.socket) -> None:
    """Disable Nagle batching. Token-delta frames are tens of bytes;
    coalescing them behind an unacked segment adds up to ~40 ms of
    artificial inter-token latency per delta."""
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass                       # non-TCP transports (tests, AF_UNIX)


def recv_exact(sock: socket.socket, n: int) -> bytes | None:
    """Read exactly ``n`` bytes. Returns None on clean EOF at a frame
    boundary (byte 0); raises ProtocolError on EOF mid-read (a peer
    that died mid-frame).

    Accumulates via ``recv_into`` on one preallocated buffer: the old
    ``bytes``-list + join path copied every chunk twice, which starts to
    matter once frames carry megabyte tensor payloads (the inter-gang
    channel plane reuses this reader)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        try:
            k = sock.recv_into(view[got:])
        except OSError as e:
            if got:
                raise ProtocolError(f"connection lost mid-frame: {e}")
            return None
        if not k:
            if got:
                raise ProtocolError("truncated frame (EOF mid-frame)")
            return None
        got += k
    return bytes(buf)


#: payloads at or above this many bytes skip the concatenated-copy encode
#: and go out as header + payload writes (two sendalls). Below it, one
#: sendall keeps small control frames in a single segment under
#: TCP_NODELAY (framing on the wire is unchanged either way).
LARGE_PAYLOAD_BYTES = 1 << 16


def frame_header(ftype: int, rid: int, payload_len: int,
                 limit: int = MAX_FRAME_BYTES) -> bytes:
    """Length prefix + (type, rid) header for a frame whose payload will
    be written separately — the zero-copy send path and the channel
    plane's TENSOR frames build on this. ``limit`` lets a plane with
    legitimately bigger frames (tensor microbatches) raise the sanity
    cap without loosening the serving wire's."""
    body_len = _HDR.size + payload_len
    if body_len > limit:
        raise ProtocolError(f"frame too large: {body_len} bytes")
    return _LEN.pack(body_len) + _HDR.pack(ftype, rid)


def _payload_nbytes(payload) -> int:
    """Byte length of a frame payload. ``len()`` on a non-byte
    memoryview counts ELEMENTS (a float32 view would understate by 4x
    and corrupt the length prefix) — nbytes is the wire truth."""
    return payload.nbytes if isinstance(payload, memoryview) \
        else len(payload)


def encode_frame(ftype: int, rid: int,
                 payload: bytes | memoryview = b"") -> bytes:
    return frame_header(ftype, rid, _payload_nbytes(payload)) \
        + bytes(payload)


def send_frame(sock: socket.socket, ftype: int, rid: int,
               payload: bytes | memoryview = b"") -> None:
    """Write one frame. Large payloads (tensor-sized) are sent as
    header-then-payload without an intermediate concatenated copy —
    ``payload`` may be a ``memoryview`` straight over a device buffer's
    host copy (any element format; byte length is taken from
    ``nbytes``); small control frames keep the single-sendall
    behavior."""
    n = _payload_nbytes(payload)
    if n >= LARGE_PAYLOAD_BYTES:
        sock.sendall(frame_header(ftype, rid, n))
        sock.sendall(payload)
    else:
        sock.sendall(encode_frame(ftype, rid, payload))


def recv_frame(sock: socket.socket, max_bytes: int = MAX_FRAME_BYTES):
    """Read one frame; returns ``(type, rid, payload)`` or None on clean
    EOF. Raises ProtocolError on truncation or an implausible length
    prefix — the reader can then close without ever losing sync.
    ``max_bytes`` mirrors :func:`frame_header`'s ``limit``.

    The (type, rid) header and the payload are read separately so the
    payload is handed back exactly as received — no full-body slice
    copy for megabyte tensor frames."""
    head = recv_exact(sock, _LEN.size)
    if head is None:
        return None
    (length,) = _LEN.unpack(head)
    if length < _HDR.size or length > max_bytes:
        raise ProtocolError(f"implausible frame length {length}")
    hdr = recv_exact(sock, _HDR.size)
    if hdr is None:
        raise ProtocolError("truncated frame (EOF after length prefix)")
    ftype, rid = _HDR.unpack(hdr)
    if length == _HDR.size:
        return ftype, rid, b""
    payload = recv_exact(sock, length - _HDR.size)
    if payload is None:
        raise ProtocolError("truncated frame (EOF after length prefix)")
    return ftype, rid, payload


def read_magic(sock: socket.socket) -> bool:
    """Consume and verify the connection preamble; False on anything
    else (including clean EOF)."""
    try:
        got = recv_exact(sock, len(MAGIC))
    except ProtocolError:
        return False
    return got == MAGIC


def pack_json(obj) -> bytes:
    return json.dumps(obj, separators=(",", ":")).encode("utf-8")


def unpack_json(payload: bytes) -> dict:
    try:
        obj = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"malformed JSON payload: {e}") from e
    if not isinstance(obj, dict):
        raise ProtocolError(f"payload is not an object: {obj!r}")
    return obj


def pack_tokens(tokens) -> bytes:
    return b"".join(_TOK.pack(int(t) & 0xFFFFFFFF) for t in tokens)


def unpack_tokens(payload: bytes) -> list[int]:
    if len(payload) % _TOK.size:
        raise ProtocolError(
            f"TOKENS payload of {len(payload)} bytes is not a whole "
            f"number of u32s")
    return [t[0] for t in _TOK.iter_unpack(payload)]


def parse_trace_ctx(payload_or_obj) -> dict | None:
    """Extract the OPTIONAL ``trace`` context from an ADMIT payload:
    ``{"trace": {"tid": <hex>, "sid": <hex>}}`` — the client's (or the
    router's forwarded) span context, so a request's engine-side spans
    join the submitter's trace. Tracing is never load-bearing: anything
    missing or malformed is simply ``None`` (the request still serves;
    the engine head-samples a fresh trace instead)."""
    try:
        obj = payload_or_obj if isinstance(payload_or_obj, dict) \
            else unpack_json(payload_or_obj)
        ctx = obj.get("trace")
        if (isinstance(ctx, dict)
                and isinstance(ctx.get("tid"), str)
                and isinstance(ctx.get("sid"), str)
                and 0 < len(ctx["tid"]) <= 64
                and 0 < len(ctx["sid"]) <= 64):
            return {"tid": ctx["tid"], "sid": ctx["sid"]}
    except ProtocolError:
        pass
    return None


def parse_decode_target(obj: dict) -> str | None:
    """Extract the OPTIONAL disaggregated-serving ``decode`` target
    from a parsed ADMIT object: ``{"decode": "host:port"}`` names the
    decode gang's channel-hub endpoint the prefill tier must ship this
    request's KV package to. None when absent/malformed — a prefill
    server treats a target-less ADMIT as request-scoped error, a
    colocated server ignores the field entirely."""
    addr = obj.get("decode")
    if isinstance(addr, str) and 0 < len(addr) <= 256:
        host, _, port = addr.rpartition(":")
        # a target that cannot dial (no host, non-numeric port) must be
        # rejected HERE as malformed — downstream it would detonate in
        # the channel sender on the prefill tier's worker thread
        if host and port.isdigit() and 0 < int(port) < 65536:
            return addr
    return None


def parse_prefix_id(payload_or_obj) -> str | None:
    """Extract the OPTIONAL ``prefix`` id from an ADMIT payload:
    ``{"prefix": "<id>"}`` names the shared-prefix template the prompt
    continues, so the router can place the session where that prefix's
    KV is already resident and the engine can admit only the suffix
    through the model. Never load-bearing: absent/malformed is simply
    ``None`` (the request still serves, prefix-blind), and a replica
    that does not hold the named template falls back to a full
    prefill — outputs are token-identical either way."""
    try:
        obj = payload_or_obj if isinstance(payload_or_obj, dict) \
            else unpack_json(payload_or_obj)
        pid = obj.get("prefix")
        if isinstance(pid, str) and 0 < len(pid) <= 128:
            return pid
    except ProtocolError:
        pass
    return None


def parse_rng(payload_or_obj) -> tuple[int, int] | None:
    """Extract the OPTIONAL ``rng`` pin from an ADMIT payload:
    ``{"rng": {"stream": s, "off": k}}`` fixes the request's rng STREAM
    index (instead of the engine's local submission counter) and marks
    ``k`` stream positions as already consumed. This is what makes a
    planned migration token-identical under SAMPLING: the router pins
    every session to a fleet-unique stream, and a re-placement that
    folds ``k`` already-streamed tokens into the prompt tells the new
    replica to draw its first sample from position ``k`` — the same
    key, the same offset, the same token the old replica would have
    drawn. Never load-bearing for plain clients: absent/malformed is
    ``None`` (the engine assigns its own stream, off 0)."""
    try:
        obj = payload_or_obj if isinstance(payload_or_obj, dict) \
            else unpack_json(payload_or_obj)
        rng = obj.get("rng")
        if isinstance(rng, dict):
            stream, off = rng.get("stream"), rng.get("off", 0)
            if (isinstance(stream, int) and not isinstance(stream, bool)
                    and isinstance(off, int)
                    and not isinstance(off, bool) and off >= 0):
                return stream, off
    except ProtocolError:
        pass
    return None


def parse_class(payload_or_obj) -> str:
    """Extract the OPTIONAL ``class`` field from an ADMIT payload:
    ``{"class": "interactive"|"standard"|"batch"}`` names the request's
    QoS tier. ABSENT means ``standard`` — an old class-less wire
    behaves exactly as before — but unlike the other optional-field
    helpers a PRESENT-but-invalid value raises ``ValueError``: a client
    that asked for a class it misspelled must hear "no" (request-scoped
    error), not silently serve at a different tier than it believes it
    bought."""
    obj = payload_or_obj if isinstance(payload_or_obj, dict) \
        else unpack_json(payload_or_obj)
    cls = obj.get("class")
    if cls is None:
        return "standard"
    if cls not in QOS_CLASSES:
        raise ValueError(
            f"unknown request class {cls!r} (expected one of "
            f"{', '.join(QOS_CLASSES)})")
    return cls


def parse_admit(payload: bytes) -> tuple[list[int], int, bool]:
    """Validate an ADMIT payload -> (prompt, max_new_tokens, stream).
    Anything structurally off is a ProtocolError (connection-scoped),
    NOT a crash in the engine. The optional ``trace`` context rides
    alongside (see :func:`parse_trace_ctx`)."""
    obj = unpack_json(payload)
    prompt = obj.get("prompt")
    max_new = obj.get("max_new_tokens")
    stream = obj.get("stream", True)
    if (not isinstance(prompt, list)
            or not all(isinstance(t, int) and not isinstance(t, bool)
                       for t in prompt)):
        raise ProtocolError("ADMIT prompt must be a list of ints")
    if isinstance(max_new, bool) or not isinstance(max_new, int):
        raise ProtocolError("ADMIT max_new_tokens must be an int")
    if not isinstance(stream, bool):
        raise ProtocolError("ADMIT stream must be a bool")
    return prompt, max_new, stream
