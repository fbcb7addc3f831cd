"""Typed inter-gang tensor channels: persistent point-to-point transport
over DCN — the port's copy of ``tony_tpu/channels/channel.py``, on the
same TONYC1 wire: a JAX sender reaches a port hub and back, byte for
byte. bfloat16 payloads are ``torch.bfloat16`` tensors here (numpy has
no such type without ``ml_dtypes``), carried as their 16-bit payload
under the dtype name ``bfloat16`` exactly as the JAX package writes
them; every other dtype is a numpy array.

The data path that lets two gangs cooperate on ONE model: a pipeline
stage gang streams activations forward (and cotangents backward) to its
neighbor stage's gang without the coordinator in the loop. The wire
reuses the TONYS1 length-prefixed framing discipline from
``tony_tpu/serving/protocol.py`` (magic preamble, explicit length
prefix, JSON handshake) with its own magic and frame set — this is a
tensor plane, not a token plane, and a stray cross-plane connection must
fail at the first byte.

Connection handshake (the SENDER dials the receiving task's hub)::

    sender   -> receiver   magic  b"TONYC1\\0"
    sender   -> receiver   HELLO frame, JSON {"v": 1, "channel": name}
    receiver -> sender     HELLO frame, JSON {"v": 1, "resume": seq}

``resume`` is the receiver's next expected sequence number — on a fresh
channel it is 0; after a transient socket loss the sender reconnects,
learns where the receiver actually is, drops everything already
delivered and resends the rest. Sequence numbers ride the frame's
``rid`` field, so TENSOR frames need no extra header field for them.

Frame types (framing itself is protocol.py's: u32 length, u8 type,
u64 rid):

======== ============ =========================================
 type     direction    payload
======== ============ =========================================
CH_HELLO  both         JSON (see handshake above)
CH_TENSOR s -> r       u32 header_len + JSON header
                       ``{"dtype": str, "shape": [ints]}`` + raw
                       C-contiguous buffer bytes
CH_ACK    r -> s       (empty) — ``rid`` = highest in-order seq
                       consumed; advances the sender's window
CH_ERROR  r -> s       JSON ``{"message": str}`` — the receiver is
                       closing THIS connection (garbage frame, seq
                       gap); channel state survives, the sender
                       reconnects and resumes
======== ============ =========================================

Wire compression (``codec`` = ``"bf16"`` | ``"int8"``): a channel may
negotiate an on-the-wire codec at the handshake — the sender's HELLO
carries ``"codec"`` and the hub refuses (CH_ERROR, permanent: the
sender raises ChannelError instead of retrying into garbled math) when
it disagrees with what the consumer declared. Tensor headers on a codec
channel are KIND-TAGGED with the same ``"codec"`` field, so a
compressed frame on a raw channel — or a raw frame on a codec channel —
is a ProtocolError at decode, never a silently misread buffer (the
``TEMPLATE_KIND`` discipline of serving/kvship.py). f32/bf16 payloads
ship as bf16 halves or int8+per-tensor-scale (~quarter of f32); every
other dtype passes through raw under the tag. The codec runs BEFORE the
send window, so the resend buffer holds only the encoded bytes — window
host memory shrinks with the wire.

Reliability/backpressure contract:

- **Bounded send window**: at most ``window`` unacked TENSOR frames in
  flight; ``send`` blocks past that instead of buffering unboundedly —
  a stalled consumer stage backpressures its producer stage through
  TCP + the window, never through host memory.
- **Exactly-once delivery to the consumer**: the receiver acks in
  order and drops duplicates below its resume point, so a reconnect
  never duplicates or drops a microbatch.
- **Channel-scoped failure**: a truncated or garbage frame costs only
  the offending connection (best-effort CH_ERROR, close); the hub
  keeps serving its other channels and the peer reconnects with seq
  resume.

Everything here is transport-only (stdlib, numpy and torch's CPU
tensors for bfloat16): the serving host's prefix and weights lanes ride
it.
"""

from __future__ import annotations

import json
import math
import os
import socket
import struct
import threading
import time
from collections import OrderedDict, deque

import numpy as np

from tony_tpu_torch.runtime import metrics as metrics_mod
from tony_tpu_torch.serving.blobcodec import (BF16, from_wire, is_tensor,
                                              np_dtype, wire_array)
from tony_tpu_torch.serving.protocol import (BODY_HEADER_BYTES, ProtocolError,
                                       frame_header, pack_json, recv_exact,
                                       recv_frame, send_frame, set_nodelay,
                                       unpack_json)

CH_MAGIC = b"TONYC1\0"

CH_HELLO = 1
CH_TENSOR = 2
CH_ACK = 3
CH_ERROR = 4

_HLEN = struct.Struct("<I")     # tensor-header length prefix

#: the tensor plane's own frame cap — far above the serving plane's
#: MAX_FRAME_BYTES (16 MiB of tokens is corruption; 16 MiB of
#: activations is a small microbatch). One frame = one microbatch
#: tensor; past this the SENDER fails fast with ChannelError rather
#: than shipping something the peer will reject.
MAX_TENSOR_BYTES = 1 << 31

#: magic prefix of every chunked byte-blob frame (see
#: :meth:`ChannelSender.send_bytes`): a blob larger than the chunk
#: budget ships as one MANIFEST frame — this magic + a u32-length-
#: prefixed JSON header ``{"v":2,"kind":"manifest","chunks":N,
#: "total":T,"blob":id}`` — followed by N bounded CHUNK frames, each
#: the same magic + header ``{"v":2,"kind":"chunk","blob":id,"i":i}``
#: + payload bytes. Each frame is an ordinary seq-numbered tensor
#: frame, so a disconnect mid-blob resumes at the first unacked CHUNK,
#: not the whole blob (zero duplicated / dropped bytes — test-pinned).
#: The per-frame kind tag + per-blob id are what let a receiver that
#: ABORTED a reassembly (chunk timeout, seeder death) re-synchronize:
#: a stale chunk of the dead blob is identified and discarded, never
#: misparsed as a standalone blob. A raw blob that happens to START
#: with this magic is escaped into a single-chunk envelope so the
#: receiver can never misparse it.
BLOB_CHUNK_MAGIC = b"TONYB1\0"

#: per-chunk recv deadline while reassembling a chunked blob (see
#: :meth:`ChannelReceiver.recv_bytes`): once a manifest has arrived
#: the receiver is committed to the blob, so each chunk gets its own
#: generous deadline instead of whatever sliver remains of the
#: caller's first-frame timeout — a multi-GB artifact backpressured
#: through a small hub must never be aborted mid-reassembly by an
#: idle-poll timeout. Transient disconnects are invisible here (the
#: sender reconnects and seq-resumes); only a truly dead sender makes
#: a chunk wait this long.
BLOB_CHUNK_TIMEOUT_S = 60.0

#: default chunk budget for :meth:`ChannelSender.send_bytes` (the
#: ``tony.weights.chunk-bytes`` config key feeds callers that override
#: it). 8 MiB keeps resend-on-reconnect work bounded while staying far
#: above per-frame overhead.
DEFAULT_BLOB_CHUNK_BYTES = 8 << 20

#: sanity cap on a chunked blob's manifest (an envelope promising
#: billions of chunks is a corrupt or adversarial frame, refused
#: before the receiver commits to gathering them).
MAX_BLOB_CHUNKS = 1 << 20

#: send/recv wait buckets: DCN one-way latencies are milliseconds, a
#: window stall can reach seconds — finer than the generic time ladder
#: at the low end.
CHANNEL_WAIT_BUCKETS_S: tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0)


class ChannelError(ConnectionError):
    """The channel is unusable from this endpoint's point of view:
    closed, past its reconnect budget, or a wait timed out. Transient
    socket loss is NOT surfaced as this — senders reconnect and resume
    internally."""


class ChannelClosed(ChannelError):
    """The receiving hub has STOPPED: no delivery can ever succeed on
    this endpoint again — distinct from a recv timeout, so a consumer
    loop can exit instead of hot-spinning on instant failures."""


#: valid per-channel wire codecs (tony.channel.compression values).
CODECS = ("none", "bf16", "int8")

#: dtypes a codec actually compresses; everything else passes through
#: raw under the codec kind-tag (ints/bools must stay exact).
_COMPRESSIBLE = ("float32", "bfloat16")

_SCALE = struct.Struct("<f")    # int8 per-tensor scale, payload prefix

#: exactness-guard flag (see :func:`forbid_codecs`).
_CODECS_FORBIDDEN = False


def forbid_codecs(on: bool) -> None:
    """Arm (or disarm) the bit-exactness guard: while armed, building a
    sender or receiver with a non-"none" codec raises RuntimeError. The
    test harness arms this inside bit-identity-pinned tests (pytest
    marker ``exact``), so a stray quantized channel in an exactness pin
    fails loudly instead of flaking the comparison."""
    global _CODECS_FORBIDDEN
    _CODECS_FORBIDDEN = on


def _check_codec(codec: str, what: str) -> str:
    if codec not in CODECS:
        raise ValueError(f"unknown channel codec {codec!r} for {what}; "
                         f"expected one of {CODECS}")
    if codec != "none" and _CODECS_FORBIDDEN:
        raise RuntimeError(
            f"quantized channel codec {codec!r} constructed for {what} "
            f"inside a bit-exactness-pinned context (channels."
            f"forbid_codecs) — exactness tests must run uncompressed")
    return codec


def _f32_to_bf16_bits(a: np.ndarray) -> np.ndarray:
    """float32 -> the int16 payload of its bfloat16 rounding (to nearest
    even, as ``ml_dtypes``' cast rounds)."""
    import torch
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy()


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """The int16 payload of bfloat16 values -> float32 (exact)."""
    import torch
    t = torch.from_numpy(np.array(bits, np.int16, copy=True))
    return t.view(torch.bfloat16).float().numpy()


def _restore(f32: np.ndarray, dtype: str):
    """A float32 decode cast to the frame's original ``dtype``: a
    ``torch.bfloat16`` tensor for bfloat16, else a numpy array."""
    if dtype == BF16:
        import torch
        return torch.from_numpy(np.ascontiguousarray(f32)).to(
            torch.bfloat16)
    return f32.astype(np_dtype(dtype))


def encode_tensor(arr, codec: str = "none") -> tuple[bytes, bytes]:
    """-> (tensor header bytes, encoded payload bytes). The payload is
    what the wire carries AND what the sender's resend window retains —
    the codec runs here, before windowing, so a compressed channel's
    window holds the small encoded buffer, never the f32 original.

    ``arr``: a numpy array or a torch tensor; a ``torch.bfloat16``
    tensor travels as its 16-bit payload under the dtype name
    ``bfloat16`` (:func:`~tony_tpu_torch.serving.blobcodec.wire_array`),
    the bytes the JAX package writes for an ``ml_dtypes`` array.

    codec "none" keeps the original wire format (header
    ``{"dtype", "shape"}``, raw C-contiguous bytes). A real codec
    kind-tags the header with ``"codec"`` plus the on-wire layout
    (``"wire"``: "bf16" / "int8" / "raw" passthrough) while ``"dtype"``
    stays the ORIGINAL dtype the receiver must restore."""
    dtype, shape, arr = wire_array(arr)
    if codec == "none":
        head = pack_json({"dtype": dtype, "shape": shape})
        return _HLEN.pack(len(head)) + head, arr.tobytes()
    if codec == "bf16":
        if dtype in _COMPRESSIBLE:
            bits = arr if dtype == BF16 else _f32_to_bf16_bits(arr)
            wire, raw = "bf16", bits.tobytes()
        else:
            wire, raw = "raw", arr.tobytes()
    elif codec == "int8":
        if dtype in _COMPRESSIBLE:
            a = (_bf16_bits_to_f32(arr) if dtype == BF16
                 else arr.astype(np.float32, copy=False))
            amax = float(np.max(np.abs(a))) if a.size else 0.0
            scale = amax / 127.0 if amax > 0.0 else 1.0
            q = np.clip(np.rint(a / scale), -127, 127).astype(np.int8)
            wire, raw = "int8", _SCALE.pack(scale) + q.tobytes()
        else:
            wire, raw = "raw", arr.tobytes()
    else:
        raise ValueError(f"unknown channel codec {codec!r}")
    head = pack_json({"codec": codec, "wire": wire,
                      "dtype": dtype, "shape": shape})
    return _HLEN.pack(len(head)) + head, raw


def decode_tensor(payload: bytes, codec: str = "none"):
    """Parse a CH_TENSOR payload back into an ndarray (a ``torch.
    bfloat16`` tensor for a bfloat16 frame) under the channel's
    negotiated ``codec``. Anything structurally off is a ProtocolError
    (channel-scoped) — including a KIND-TAG mismatch: a compressed frame
    on a raw channel, a raw frame on a codec channel, or a frame tagged
    with a different codec than negotiated can never silently misread
    each other's bytes."""
    if len(payload) < _HLEN.size:
        raise ProtocolError("TENSOR frame shorter than its header prefix")
    (hlen,) = _HLEN.unpack_from(payload, 0)
    if _HLEN.size + hlen > len(payload):
        raise ProtocolError(f"TENSOR header length {hlen} exceeds frame")
    head = unpack_json(payload[_HLEN.size:_HLEN.size + hlen])
    tag = head.get("codec")
    if codec == "none":
        if tag is not None:
            raise ProtocolError(
                f"compressed frame (codec {tag!r}) on a raw channel")
    elif tag != codec:
        raise ProtocolError(
            f"frame kind-tag {tag!r} on a channel negotiated for "
            f"codec {codec!r}"
            + (" (raw frame on a codec channel)" if tag is None else ""))
    shape = head.get("shape")
    dtype = head.get("dtype")
    if not isinstance(shape, list) or not all(
            isinstance(d, int) and not isinstance(d, bool) and d >= 0
            for d in shape) or not isinstance(dtype, str):
        raise ProtocolError(f"malformed TENSOR header: {head!r}")
    dt = np_dtype(dtype)
    raw = payload[_HLEN.size + hlen:]
    # python-int math: np.prod wraps on adversarial shapes, letting a
    # bogus length claim past the check into a reshape crash
    count = math.prod(shape)
    if codec == "none":
        wire = "raw"
    else:
        wire = head.get("wire")
        if wire not in ("raw", "bf16", "int8"):
            raise ProtocolError(f"malformed TENSOR wire layout {wire!r}")
        if wire != "raw" and dtype not in _COMPRESSIBLE:
            raise ProtocolError(
                f"codec wire {wire!r} cannot restore dtype {dtype!r}")
    if wire == "raw":
        want = count * dt.itemsize
        if len(raw) != want:
            raise ProtocolError(
                f"TENSOR payload {len(raw)} bytes, header promises {want}")
        return from_wire(dtype, raw, count, 0, shape)
    if wire == "bf16":
        want = count * 2
        if len(raw) != want:
            raise ProtocolError(
                f"bf16 payload {len(raw)} bytes, header promises {want}")
        if dtype == BF16:
            return from_wire(dtype, raw, count, 0, shape)
        return _restore(_bf16_bits_to_f32(
            np.frombuffer(raw, dtype=np.int16)).reshape(shape), dtype)
    # wire == "int8": per-tensor f32 scale prefix + int8 values — a
    # truncated scale (or a length off by even one value byte) must
    # fail structurally, never decode shifted garbage
    want = _SCALE.size + count
    if len(raw) != want:
        raise ProtocolError(
            f"int8 payload {len(raw)} bytes, header promises {want} "
            f"(scale prefix + values)")
    (scale,) = _SCALE.unpack_from(raw, 0)
    if not math.isfinite(scale):
        raise ProtocolError(f"non-finite int8 scale {scale!r}")
    q = np.frombuffer(raw, dtype=np.int8, offset=_SCALE.size)
    return _restore((q.astype(np.float32) * np.float32(scale))
                    .reshape(shape), dtype)


def _blob_frame(head: dict, payload: bytes = b"") -> bytes:
    """Serialize one chunked-blob frame: magic + u32 header length +
    compact-JSON header + payload bytes."""
    h = json.dumps(head, separators=(",", ":")).encode("utf-8")
    return BLOB_CHUNK_MAGIC + _HLEN.pack(len(h)) + h + payload


def _parse_blob_frame(buf: bytes) -> tuple[dict, bytes]:
    """Split a magic-prefixed chunked-blob frame into (header dict,
    payload bytes); structurally-off frames are ProtocolError."""
    off = len(BLOB_CHUNK_MAGIC)
    if len(buf) < off + _HLEN.size:
        raise ProtocolError(
            "chunked-blob frame shorter than its header prefix")
    (hlen,) = _HLEN.unpack_from(buf, off)
    if off + _HLEN.size + hlen > len(buf):
        raise ProtocolError(
            f"chunked-blob header length {hlen} exceeds frame")
    try:
        head = json.loads(
            buf[off + _HLEN.size:off + _HLEN.size + hlen]
            .decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"malformed chunked-blob header: {e}") from e
    if not isinstance(head, dict):
        raise ProtocolError(f"malformed chunked-blob header: {head!r}")
    return head, buf[off + _HLEN.size + hlen:]


def _check_manifest(head: dict, payload: bytes) -> tuple[int, int, str]:
    """Validate a manifest header -> (chunks, total, blob id)."""
    chunks = head.get("chunks")
    total = head.get("total")
    blob_id = head.get("blob")
    if (isinstance(chunks, bool) or not isinstance(chunks, int)
            or isinstance(total, bool) or not isinstance(total, int)
            or not 1 <= chunks <= MAX_BLOB_CHUNKS or total < 0
            or not isinstance(blob_id, str)):
        raise ProtocolError(
            f"implausible chunked-blob manifest: {head!r}")
    if payload:
        raise ProtocolError(
            f"chunked-blob manifest carries {len(payload)} payload "
            f"bytes (chunks carry the data, the manifest never does)")
    return chunks, total, blob_id


def _send_tensor_frame(sock: socket.socket, seq: int, head: bytes,
                       raw: bytes) -> None:
    """Frame header + tensor header in one small write, the raw buffer
    in a second — the zero-copy discipline of protocol.send_frame's
    large path, without concatenating megabytes per microbatch."""
    sock.sendall(frame_header(CH_TENSOR, seq, len(head) + len(raw),
                              limit=MAX_TENSOR_BYTES) + head)
    sock.sendall(raw)


# ---------------------------------------------------------------------------
# Sender
# ---------------------------------------------------------------------------
class ChannelSender:
    """Dial a peer task's :class:`ChannelHub` and stream tensors with a
    bounded in-flight window and reconnect-with-seq-resume.

    One producer thread calls :meth:`send`; a background reader thread
    consumes acks. ``send`` hands the frame to the OS send buffer and
    returns — the window (not the call) is what overlaps DCN transport
    with the caller's device compute. ``sync=True`` additionally blocks
    until the peer acked the frame (the serialized-baseline mode the
    bench contrasts against)."""

    def __init__(self, address: str, channel: str, *, window: int = 8,
                 codec: str = "none",
                 connect_timeout_s: float = 10.0, max_retries: int = 30,
                 backoff_s: float = 0.05, max_backoff_s: float = 2.0,
                 registry: metrics_mod.MetricsRegistry | None = None) -> None:
        if window < 1:
            raise ValueError(f"channel window must be >= 1, got {window}")
        host, _, port = address.rpartition(":")
        self.address = (host, int(port))
        self.channel = channel
        self.codec = _check_codec(codec, f"sender channel {channel!r}")
        self.window = window
        self.connect_timeout_s = connect_timeout_s
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self._cv = threading.Condition()
        self._sock: socket.socket | None = None
        self._reader: threading.Thread | None = None
        self._broken = True             # no connection yet
        self._closed = False
        self._next_seq = 0
        self._acked_through = -1
        self._unacked: OrderedDict[int, tuple[bytes, bytes]] = OrderedDict()
        self._connected_once = False
        reg = registry or metrics_mod.get_default()
        self._send_hist = reg.histogram(
            "tony_channel_send_seconds",
            help="host wall a channel send spent blocked (serialize + "
                 "window backpressure + socket write)",
            buckets=CHANNEL_WAIT_BUCKETS_S, channel=channel)
        self._depth_gauge = reg.gauge(
            "tony_channel_send_queue_depth",
            help="unacked tensor frames in the sender's window",
            channel=channel)
        self._reconnects = reg.counter(
            "tony_channel_reconnects_total",
            help="sender reconnects after transient socket loss",
            channel=channel)
        self._bytes = reg.counter(
            "tony_channel_bytes_total",
            help="logical (decoded) tensor bytes moved", channel=channel,
            direction="send")
        #: wire bytes actually shipped on a codec channel (header +
        #: encoded payload): bytes_total / compressed_bytes_total is the
        #: live bytes-on-wire compression ratio. Only registered when a
        #: codec is negotiated — raw channels keep their series set.
        self._wire_bytes = None if self.codec == "none" else reg.counter(
            "tony_channel_compressed_bytes_total",
            help="encoded bytes on the wire (codec channels only)",
            channel=channel, direction="send")

    # -- connection management ---------------------------------------------
    def _teardown_locked(self) -> None:
        sock, self._sock = self._sock, None
        self._broken = True
        if sock is not None:
            # shutdown BEFORE close: the ack-reader thread blocked in
            # recv on this fd holds the kernel socket alive, so a bare
            # close() would never send the FIN — the receiver's
            # delivery loop would keep its per-channel conn lock and
            # every later sender's handshake would hang (seen with the
            # short-lived one-ship senders of the prefix template lane)
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    def _reconnect(self, deadline: float | None = None) -> None:
        """(Re)dial, handshake, fold the receiver's resume point into the
        ack state, resend what it has not seen. Runs on the producer
        thread (the only writer); raises ChannelError past the budget —
        or past ``deadline`` (monotonic), so a caller's send timeout
        bounds the repair attempt too instead of stacking 30 connect
        timeouts on top of it."""
        backoff = self.backoff_s
        last_err: Exception | None = None
        for attempt in range(self.max_retries):
            if deadline is not None and time.monotonic() >= deadline:
                raise ChannelError(
                    f"channel {self.channel!r} reconnect to "
                    f"{self.address} timed out: {last_err}")
            with self._cv:
                if self._closed:
                    raise ChannelError(f"channel {self.channel!r} closed")
                if not self._broken:    # another path already fixed it
                    return
            try:
                sock = socket.create_connection(
                    self.address, timeout=self.connect_timeout_s)
            except OSError as e:
                last_err = e
                time.sleep(backoff)
                backoff = min(backoff * 2, self.max_backoff_s)
                continue
            try:
                set_nodelay(sock)
                sock.sendall(CH_MAGIC)
                hello = {"v": 1, "channel": self.channel}
                if self.codec != "none":    # wire-compat: raw peers
                    hello["codec"] = self.codec     # omit the field
                send_frame(sock, CH_HELLO, 0, pack_json(hello))
                fr = recv_frame(sock)
                if fr is not None and fr[0] == CH_ERROR:
                    # an explicit handshake refusal (codec mismatch) is
                    # PERMANENT: retrying would never converge, and
                    # falling through to raw frames would garble math —
                    # fail channel-scoped right here
                    try:
                        msg = unpack_json(fr[2]).get("message", "")
                    except ProtocolError:
                        msg = ""
                    try:
                        sock.close()
                    except OSError:
                        pass
                    raise ChannelError(
                        f"channel {self.channel!r} handshake refused by "
                        f"{self.address}: {msg}")
                if fr is None or fr[0] != CH_HELLO:
                    raise ProtocolError("channel handshake refused")
                resume = unpack_json(fr[2]).get("resume")
                if not isinstance(resume, int) or resume < 0:
                    raise ProtocolError(f"bad resume seq {resume!r}")
                sock.settimeout(None)
            except ChannelError:
                raise               # permanent refusal: not a retry case
            except (OSError, ProtocolError) as e:
                last_err = e
                try:
                    sock.close()
                except OSError:
                    pass
                time.sleep(backoff)
                backoff = min(backoff * 2, self.max_backoff_s)
                continue
            with self._cv:
                if not self._connected_once and not self._unacked:
                    # a fresh sender adopts the lane's resume point:
                    # nothing of ours can be below it, so seqs start
                    # where the receiver expects them
                    self._next_seq = max(self._next_seq, resume)
                # everything below the resume point was delivered before
                # the cut — retire it; the rest goes out again below
                self._acked_through = max(self._acked_through, resume - 1)
                for seq in [s for s in self._unacked if s < resume]:
                    del self._unacked[seq]
                to_resend = list(self._unacked.items())
                self._sock = sock
                self._broken = False
                if self._connected_once:
                    self._reconnects.inc()
                self._connected_once = True
                self._depth_gauge.set(len(self._unacked))
                self._cv.notify_all()
            try:
                for seq, (head, raw) in to_resend:
                    _send_tensor_frame(sock, seq, head, raw)
            except OSError:
                with self._cv:
                    self._teardown_locked()
                continue
            reader = threading.Thread(
                target=self._reader_loop, args=(sock,),
                name=f"tony-channel-ack-{self.channel}", daemon=True)
            reader.start()
            self._reader = reader
            return
        raise ChannelError(
            f"channel {self.channel!r} to {self.address} unreachable "
            f"after {self.max_retries} attempts: {last_err}")

    def _reader_loop(self, sock: socket.socket) -> None:
        """Consume acks until this connection dies; advancing the ack
        watermark is what releases blocked senders."""
        while True:
            try:
                fr = recv_frame(sock)
            except (ProtocolError, OSError):
                fr = None
            with self._cv:
                if fr is None:
                    if self._sock is sock:      # not already superseded
                        self._teardown_locked()
                    self._cv.notify_all()
                    return
                ftype, seq, payload = fr
                if ftype == CH_ACK:
                    if seq > self._acked_through:
                        self._acked_through = seq
                        for s in [k for k in self._unacked if k <= seq]:
                            del self._unacked[s]
                        self._depth_gauge.set(len(self._unacked))
                        self._cv.notify_all()
                elif ftype == CH_ERROR:
                    # receiver-scoped close (seq gap, decode error): drop
                    # this connection; the producer reconnects + resumes
                    if self._sock is sock:
                        self._teardown_locked()
                    self._cv.notify_all()
                    return

    def _wait(self, pred, timeout: float | None) -> None:
        """Wait under the cv for ``pred``; transparently reconnects when
        the link is down (acks cannot arrive on a dead socket)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while not pred():
                if self._closed:
                    raise ChannelError(f"channel {self.channel!r} closed")
                if self._broken:
                    self._cv.release()
                    try:
                        self._reconnect(deadline)
                    finally:
                        self._cv.acquire()
                    continue
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise ChannelError(
                        f"channel {self.channel!r} send wait timed out")
                self._cv.wait(timeout=remaining)

    # -- the producer API ---------------------------------------------------
    def send(self, arr, *, sync: bool = False,
             timeout: float | None = None) -> int:
        """Queue one tensor; returns its sequence number. Blocks while
        the in-flight window is full (backpressure), and — with
        ``sync=True`` — until the peer acked this frame."""
        t0 = time.perf_counter()
        deadline = None if timeout is None else time.monotonic() + timeout
        if not is_tensor(arr):
            arr = np.asarray(arr)
        logical_bytes = arr.nbytes
        # encode BEFORE the window: _unacked retains only the encoded
        # (post-codec) buffer, so resend-window host memory shrinks with
        # the wire instead of pinning window × f32-tensor bytes
        head, raw = encode_tensor(arr, self.codec)
        # mirrors frame_header's limit check exactly (incl. the frame's
        # own header bytes): an oversize frame must fail HERE, before a
        # seq exists — once in _unacked it would poison every reconnect
        if BODY_HEADER_BYTES + len(head) + len(raw) > MAX_TENSOR_BYTES:
            raise ChannelError(
                f"tensor of {len(raw)} bytes exceeds the "
                f"{MAX_TENSOR_BYTES}-byte frame cap — split the "
                f"microbatch")
        # the FIRST connect also happens before a sequence number
        # exists: the handshake's resume point fast-forwards _next_seq
        # (see _reconnect), so a fresh sender joining a lane whose
        # receive state already advanced — short-lived one-ship senders
        # sharing a template lane — numbers its payloads as NEW frames
        # instead of the resume dedup retiring them unsent
        with self._cv:
            never_connected = not self._connected_once
        if never_connected:
            self._reconnect(deadline)
        # window backpressure BEFORE a sequence number exists: a wait
        # that times out here leaves no hole in the seq space (a burned
        # seq would wedge the channel in a permanent gap/reconnect loop)
        self._wait(lambda: len(self._unacked) < self.window, timeout)
        with self._cv:
            if self._closed:
                raise ChannelError(f"channel {self.channel!r} closed")
            seq = self._next_seq
            self._next_seq += 1
            self._unacked[seq] = (head, raw)
            self._depth_gauge.set(len(self._unacked))
            sock = self._sock if not self._broken else None
        if sock is not None:
            try:
                _send_tensor_frame(sock, seq, head, raw)
            except OSError:
                with self._cv:
                    if self._sock is sock:
                        self._teardown_locked()
                # delivery now rides the reconnect resend path — for an
                # async send that is enough; sync waits below
                if not sync:
                    self._reconnect(deadline)
        else:
            # resends the queued frame post-handshake; the caller's
            # timeout bounds the dial too — without the deadline a dead
            # endpoint holds this send for the full retry budget
            self._reconnect(deadline)
        if sync:
            self._wait(lambda: self._acked_through >= seq, timeout)
        self._bytes.inc(logical_bytes)
        if self._wire_bytes is not None:
            self._wire_bytes.inc(len(head) + len(raw))
        self._send_hist.observe(time.perf_counter() - t0)
        return seq

    def send_bytes(self, data, *, sync: bool = False,
                   timeout: float | None = None,
                   chunk_bytes: int | None = None) -> int:
        """Ship an opaque byte blob — the lane structured multi-buffer
        payloads (the serving KV shipment, ``tony_tpu/serving/
        kvship.py``; weight artifacts, ``tony_tpu/serving/
        weightstore.py``) ride without teaching the tensor plane their
        schema. A blob within ``chunk_bytes`` ships as ONE 1-D uint8
        tensor frame; a larger one ships as an envelope frame
        (:data:`BLOB_CHUNK_MAGIC` + manifest) followed by bounded chunk
        frames, each an ordinary seq-numbered frame — so a multi-GB
        blob inherits the window's backpressure and, on disconnect,
        resumes at the first unacked CHUNK instead of resending (or
        worse, dropping) the whole blob. Chunk frames are kind-tagged
        with a per-blob id, so a receiver that aborted a reassembly
        can identify and discard the dead blob's stragglers. Same
        window/reconnect/ordering contract as :meth:`send`; pair with
        :meth:`ChannelReceiver.recv_bytes`. Returns the seq of the
        blob's LAST frame (what ``sync=True`` waits on)."""
        data = bytes(data) if not isinstance(data, (bytes, bytearray,
                                                    memoryview)) else data
        view = memoryview(data)
        limit = chunk_bytes if chunk_bytes is not None \
            else DEFAULT_BLOB_CHUNK_BYTES
        if limit < 1:
            raise ValueError(f"chunk_bytes must be >= 1, got {limit}")
        magic_collision = view[:len(BLOB_CHUNK_MAGIC)] == BLOB_CHUNK_MAGIC
        if len(view) <= limit and not magic_collision:
            return self.send(np.frombuffer(view, dtype=np.uint8),
                             sync=sync, timeout=timeout)
        # chunked path: manifest first, then the chunks. Only the LAST
        # frame honours sync — in-order exactly-once delivery means the
        # last ack implies every earlier chunk landed.
        chunks = max(1, -(-len(view) // limit))
        blob_id = os.urandom(8).hex()   # names THIS transfer: a stale
        # chunk surviving an aborted reassembly can never be mistaken
        # for part of a later blob (even a byte-identical re-ship)
        envelope = _blob_frame({"v": 2, "kind": "manifest",
                                "chunks": chunks, "total": len(view),
                                "blob": blob_id})
        deadline = None if timeout is None else time.monotonic() + timeout
        def left() -> float | None:
            return None if deadline is None \
                else max(0.0, deadline - time.monotonic())
        self.send(np.frombuffer(envelope, dtype=np.uint8), sync=False,
                  timeout=left())
        seq = -1
        for i in range(chunks):
            frame = _blob_frame({"v": 2, "kind": "chunk",
                                 "blob": blob_id, "i": i},
                                bytes(view[i * limit:(i + 1) * limit]))
            last = i == chunks - 1
            seq = self.send(np.frombuffer(frame, dtype=np.uint8),
                            sync=sync and last, timeout=left())
        return seq

    def drain(self, timeout: float | None = None) -> None:
        """Block until every sent frame is acked."""
        with self._cv:
            last = self._next_seq - 1
        if last >= 0:
            self._wait(lambda: self._acked_through >= last, timeout)

    def unacked(self) -> int:
        with self._cv:
            return len(self._unacked)

    def window_bytes(self) -> int:
        """Host bytes the resend window currently retains (encoded
        header + payload per in-flight frame) — what a codec ≈ halves;
        pinned by the window-memory test."""
        with self._cv:
            return sum(len(h) + len(r) for h, r in self._unacked.values())

    def close(self, drain: bool = True,
              timeout: float | None = 30.0) -> None:
        if drain and not self._closed:
            try:
                self.drain(timeout)
            except ChannelError:
                pass            # best-effort: closing anyway
        with self._cv:
            self._closed = True
            self._teardown_locked()
            self._cv.notify_all()


# ---------------------------------------------------------------------------
# Receiver hub
# ---------------------------------------------------------------------------
class _RecvState:
    """Per-channel receive state: survives connections, so a reconnecting
    sender resumes exactly where the consumer is."""

    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        #: the channel's negotiated wire codec: None until the consumer
        #: (hub.receiver) or the first sender HELLO declares one; every
        #: later declarer must MATCH or is refused channel-scoped.
        self.codec: str | None = None
        self.next_seq = 0
        self.queue: deque[np.ndarray] = deque()
        self.cv = threading.Condition()
        self.closed = False
        #: ONE delivering connection at a time (held from the resume
        #: reply through the read loop): a predecessor connection still
        #: blocked mid-``put`` must finish — settling ``next_seq`` —
        #: before a reconnecting sender is told where to resume, or its
        #: seq would be delivered twice and the following one dropped.
        self.conn_lock = threading.Lock()
        #: the connection currently entitled to deliver. A NEW
        #: connection for the channel PREEMPTS the old one (closes its
        #: socket so a half-open predecessor's blocked read errors out
        #: and releases conn_lock) instead of queueing behind it forever.
        self.active_sock: object = None
        self.active_lock = threading.Lock()

    def put(self, arr: np.ndarray) -> bool:
        """Enqueue one in-order tensor; blocks while the consumer is
        ``capacity`` behind (the ack is withheld too, so the sender's
        window backpressures through here). False once closed."""
        with self.cv:
            while len(self.queue) >= self.capacity and not self.closed:
                self.cv.wait()
            if self.closed:
                return False
            self.queue.append(arr)
            self.next_seq += 1
            self.cv.notify_all()
            return True

    def get(self, timeout: float | None) -> np.ndarray:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self.cv:
            while not self.queue:
                if self.closed:
                    raise ChannelClosed("channel hub stopped")
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise ChannelError("channel recv timed out")
                self.cv.wait(timeout=remaining)
            arr = self.queue.popleft()
            self.cv.notify_all()
            return arr

    def close(self) -> None:
        with self.cv:
            self.closed = True
            self.cv.notify_all()


class ChannelReceiver:
    """Consumer facade over one named channel of a :class:`ChannelHub`."""

    def __init__(self, hub: "ChannelHub", name: str,
                 state: _RecvState) -> None:
        self._hub = hub
        self.name = name
        self._state = state
        #: seq of the most recently consumed tensor, derived from the
        #: SHARED channel state at recv time (next_seq counts delivered-
        #: to-queue; minus what is still queued = consumed) — the same
        #: number the sender's ``send`` returned for that tensor, which
        #: is what lets both ends tag one microbatch's trace spans with
        #: one shared seq without any extra frames. Derived, not a
        #: per-facade counter: a second facade over the same channel
        #: state stays correct.
        self._last_seq = -1
        reg = hub._registry
        self._wait_hist = reg.histogram(
            "tony_channel_recv_wait_seconds",
            help="host wall a channel recv spent blocked on the wire",
            buckets=CHANNEL_WAIT_BUCKETS_S, channel=name)
        self._depth_gauge = reg.gauge(
            "tony_channel_recv_queue_depth",
            help="tensors buffered ahead of the consumer", channel=name)

    def recv(self, timeout: float | None = None) -> np.ndarray:
        t0 = time.perf_counter()
        arr = self._state.get(timeout)
        self._wait_hist.observe(time.perf_counter() - t0)
        with self._state.cv:
            self._depth_gauge.set(len(self._state.queue))
            # consumed = delivered-to-queue minus still-queued; -1 for
            # "seq of the one just popped"
            self._last_seq = self._state.next_seq \
                - len(self._state.queue) - 1
        return arr

    def recv_bytes(self, timeout: float | None = None,
                   chunk_timeout: float | None = None) -> bytes:
        """Consume one opaque byte blob (the :meth:`ChannelSender.
        send_bytes` counterpart) — reassembling a chunked blob
        (:data:`BLOB_CHUNK_MAGIC` manifest + tagged chunk frames) back
        into the exact sent bytes.

        ``timeout`` bounds the wait for the blob's FIRST frame only —
        the idle-poll budget. Once a manifest arrives the reassembly
        is committed, and each chunk frame gets its own
        ``chunk_timeout`` (default :data:`BLOB_CHUNK_TIMEOUT_S`)
        instead of whatever remains of the caller's budget: an install
        loop polling at 250 ms must never abort a multi-GB transfer
        that takes seconds to backpressure through the hub. A chunk
        that truly never arrives (seeder death — transient disconnects
        seq-resume invisibly) raises ChannelError mid-reassembly;
        stale chunks the dead blob already queued are identified by
        their blob id and DISCARDED on the next call, so the lane
        re-synchronizes instead of misparsing them as standalone
        blobs. A fresh manifest arriving mid-reassembly restarts the
        reassembly on the new blob (the sender gave up and re-shipped).

        A frame that is not a 1-D uint8 tensor is a peer speaking the
        wrong sub-protocol — surfaced as ProtocolError so the consumer
        can scope it, never silently reinterpreted bytes."""
        deadline = None if timeout is None else time.monotonic() + timeout
        def left() -> float | None:
            return None if deadline is None \
                else max(0.0, deadline - time.monotonic())
        per_chunk = BLOB_CHUNK_TIMEOUT_S if chunk_timeout is None \
            else chunk_timeout

        def byte_frame(waiting: float | None, what: str) -> bytes:
            arr = self.recv(waiting)
            if arr.dtype != np.uint8 or arr.ndim != 1:
                raise ProtocolError(
                    f"expected {what} (1-D uint8), got "
                    f"{arr.dtype}{list(arr.shape)}")
            return arr.tobytes()

        # wait for the blob to START (the only wait the caller's
        # timeout bounds), discarding stragglers of any aborted blob
        while True:
            first = byte_frame(left(), "a byte-blob frame")
            if not first.startswith(BLOB_CHUNK_MAGIC):
                return first
            head, payload = _parse_blob_frame(first)
            kind = head.get("kind")
            if kind == "chunk":
                continue    # orphan of an aborted reassembly: discard
            if kind != "manifest":
                raise ProtocolError(
                    f"unknown chunked-blob frame kind {kind!r}")
            break
        while True:     # one iteration per manifest (restart on a new one)
            chunks, total, blob_id = _check_manifest(head, payload)
            parts: list[bytes] = []
            got = 0
            restarted = False
            while len(parts) < chunks:
                b = byte_frame(per_chunk,
                               f"chunk {len(parts)}/{chunks} of blob "
                               f"{blob_id}")
                if not b.startswith(BLOB_CHUNK_MAGIC):
                    raise ProtocolError(
                        f"untagged frame interleaved mid-reassembly of "
                        f"blob {blob_id} ({len(parts)}/{chunks} chunks "
                        f"landed)")
                chead, cpayload = _parse_blob_frame(b)
                ckind = chead.get("kind")
                if ckind == "manifest":
                    # the sender abandoned this blob and started over
                    head, payload = chead, cpayload
                    restarted = True
                    break
                if ckind != "chunk":
                    raise ProtocolError(
                        f"unknown chunked-blob frame kind {ckind!r}")
                if chead.get("blob") != blob_id:
                    continue    # stale chunk of an aborted blob
                if chead.get("i") != len(parts):
                    raise ProtocolError(
                        f"blob {blob_id} chunk out of order: got "
                        f"{chead.get('i')!r}, expected {len(parts)}")
                got += len(cpayload)
                if got > total:
                    raise ProtocolError(
                        f"chunked blob overflows its manifest: chunk "
                        f"{len(parts)} brings {got} bytes past the "
                        f"promised {total}")
                parts.append(cpayload)
            if restarted:
                continue
            if got != total:
                raise ProtocolError(
                    f"chunked blob reassembled to {got} bytes, manifest "
                    f"promised {total}")
            return b"".join(parts)

    @property
    def last_seq(self) -> int:
        """Seq of the most recently consumed tensor (-1 before any)."""
        return self._last_seq

    def qsize(self) -> int:
        with self._state.cv:
            return len(self._state.queue)


class ChannelHub:
    """One listening endpoint per task, multiplexing every inbound
    channel by name. Senders dial it; a connection's HELLO names the
    channel it carries. Connection loss (or a garbage frame) never
    touches channel state — the reconnecting sender's handshake learns
    ``next_seq`` and resumes."""

    def __init__(self, port: int = 0, *, capacity: int = 8,
                 bind_host: str = "",
                 registry: metrics_mod.MetricsRegistry | None = None) -> None:
        self.port = port
        self.capacity = capacity
        self.bind_host = bind_host
        self._registry = registry or metrics_mod.get_default()
        self._server: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None
        self._states: dict[str, _RecvState] = {}
        self._states_lock = threading.Lock()
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        self._stopping = threading.Event()

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> int:
        server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        server.bind((self.bind_host, self.port))
        server.listen(16)
        self.port = server.getsockname()[1]
        self._server = server
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="tony-channel-hub", daemon=True)
        self._accept_thread.start()
        return self.port

    def stop(self) -> None:
        self._stopping.set()
        if self._server is not None:
            # shutdown wakes an accept() blocked in another thread —
            # a bare close() does not (the blocked syscall pins the
            # fd), which left stop() burning the accept-thread join
            # timeout (the FrameServerBase listener does the same)
            try:
                self._server.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._server.close()
            except OSError:
                pass
        self.disconnect_all()
        with self._states_lock:
            for state in self._states.values():
                state.close()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)

    def disconnect_all(self) -> None:
        """Sever every live connection WITHOUT touching channel state —
        the fault-injection hook behind the reconnect/resume tests (and
        a chaos lever for drills): senders see a socket error, reconnect
        and resume at the receiver's seq."""
        with self._conns_lock:
            conns = list(self._conns)
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    def receiver(self, name: str, codec: str = "none") -> ChannelReceiver:
        _check_codec(codec, f"receiver channel {name!r}")
        state = self._state_for(name)
        with self._states_lock:
            if state.codec is None:
                state.codec = codec
            elif state.codec != codec:
                raise ValueError(
                    f"channel {name!r} already negotiated codec "
                    f"{state.codec!r}, receiver asked for {codec!r}")
        return ChannelReceiver(self, name, state)

    def _state_for(self, name: str) -> _RecvState:
        with self._states_lock:
            state = self._states.get(name)
            if state is None:
                state = self._states[name] = _RecvState(self.capacity)
            return state

    # -- connection plumbing ------------------------------------------------
    def _accept_loop(self) -> None:
        assert self._server is not None
        while not self._stopping.is_set():
            try:
                sock, _ = self._server.accept()
            except OSError:
                return
            if self._stopping.is_set():
                # accept can still return a queued connection while the
                # listener is being torn down — a handshake served now
                # would let a sender "deliver" into a dead hub
                try:
                    sock.close()
                except OSError:
                    pass
                return
            set_nodelay(sock)
            with self._conns_lock:
                self._conns.add(sock)
            threading.Thread(target=self._serve_conn, args=(sock,),
                             name="tony-channel-conn", daemon=True).start()

    def _serve_conn(self, sock: socket.socket) -> None:
        try:
            self._handle_conn(sock)
        finally:
            with self._conns_lock:
                self._conns.discard(sock)
            try:
                sock.close()
            except OSError:
                pass

    def _handle_conn(self, sock: socket.socket) -> None:
        try:
            got = recv_exact(sock, len(CH_MAGIC))
        except ProtocolError:
            return
        if got != CH_MAGIC:
            return                          # stray peer: fail at byte 0
        try:
            fr = recv_frame(sock)
            if fr is None or fr[0] != CH_HELLO:
                raise ProtocolError("expected channel HELLO")
            hello = unpack_json(fr[2])
            name = hello.get("channel")
            if not isinstance(name, str) or not name:
                raise ProtocolError(f"bad channel name {name!r}")
            peer_codec = hello.get("codec", "none")
            if peer_codec not in CODECS:
                raise ProtocolError(f"unknown codec {peer_codec!r}")
        except ProtocolError:
            self._best_effort_error(sock, "malformed channel handshake")
            return
        state = self._state_for(name)
        # codec negotiation, BEFORE this connection may preempt the
        # active one: a mismatched dialer is refused channel-scoped
        # (permanent CH_ERROR the sender surfaces as ChannelError) and
        # must not cost the healthy connection its socket
        with self._states_lock:
            if state.codec is None:
                state.codec = peer_codec
            elif state.codec != peer_codec:
                self._best_effort_error(
                    sock, f"codec mismatch: channel {name!r} negotiated "
                          f"{state.codec!r}, sender speaks {peer_codec!r}")
                return
        recv_bytes = self._registry.counter(
            "tony_channel_bytes_total",
            help="logical (decoded) tensor bytes moved", channel=name,
            direction="recv")
        wire_counter = None if state.codec == "none" \
            else self._registry.counter(
                "tony_channel_compressed_bytes_total",
                help="encoded bytes on the wire (codec channels only)",
                channel=name, direction="recv")
        # preempt the predecessor: shutting down its socket makes a
        # half-open connection's blocked read fail NOW, so conn_lock
        # frees instead of this handshake queueing behind a dead peer
        # forever (shutdown, not just close — the delivery thread
        # blocked in recv holds the fd alive, and a bare close() from
        # this thread would not wake it)
        with state.active_lock:
            old, state.active_sock = state.active_sock, sock
        if old is not None and old is not sock:
            try:
                old.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                old.close()
            except OSError:
                pass
        with state.conn_lock:
            with state.active_lock:
                if state.active_sock is not sock:
                    return          # superseded while waiting our turn
            self._deliver(sock, state, recv_bytes, wire_counter)

    def _deliver(self, sock: socket.socket, state: _RecvState,
                 recv_bytes, wire_counter=None) -> None:
        """One connection's delivery loop, serialized per channel by
        ``state.conn_lock`` — the resume value below is only correct
        once no predecessor connection can still advance next_seq."""
        try:
            send_frame(sock, CH_HELLO, 0,
                       pack_json({"v": 1, "resume": state.next_seq}))
        except OSError:
            return
        while not self._stopping.is_set():
            try:
                fr = recv_frame(sock, max_bytes=MAX_TENSOR_BYTES)
            except ProtocolError as e:
                # truncated/garbage frame: channel-SCOPED — this
                # connection dies, the hub keeps serving, the channel
                # state is intact for the sender's resume. The flight
                # recorder dumps a postmortem scoped to THIS connection
                # (healthy channels on the same hub dump nothing).
                self._flight_incident(sock, str(e))
                self._best_effort_error(sock, "malformed tensor frame")
                return
            if fr is None:
                return                      # clean close
            ftype, seq, payload = fr
            if ftype != CH_TENSOR:
                self._best_effort_error(sock, f"unexpected frame {ftype}")
                return
            if seq < state.next_seq:
                # duplicate of something already consumed (resend racing
                # the ack): re-ack so the sender's window advances
                self._best_effort_ack(sock, state.next_seq - 1)
                continue
            if seq > state.next_seq:
                self._best_effort_error(
                    sock, f"seq gap: got {seq}, expected {state.next_seq}")
                return
            try:
                arr = decode_tensor(payload, codec=state.codec or "none")
            except ProtocolError as e:
                self._flight_incident(sock, str(e))
                self._best_effort_error(sock, "undecodable tensor payload")
                return
            if not state.put(arr):
                return                      # hub stopping
            recv_bytes.inc(arr.nbytes)
            if wire_counter is not None:
                wire_counter.inc(len(payload))
            try:
                send_frame(sock, CH_ACK, seq)
            except OSError:
                return

    def _flight_incident(self, sock: socket.socket, error: str) -> None:
        """Torn/garbage channel frame: record + dump the flight ring,
        scoped to the offending connection (its peer address names it).
        Best-effort by the recorder's own contract."""
        from tony_tpu_torch.runtime import tracing
        try:
            peer = str(sock.getpeername())
        except OSError:
            peer = "?"
        flight = tracing.get_flight()
        flight.record("channel_protocol_error", peer=peer,
                      port=self.port, error=error[:500])
        flight.dump("channel_protocol_error", peer=peer)

    @staticmethod
    def _best_effort_error(sock: socket.socket, message: str) -> None:
        try:
            send_frame(sock, CH_ERROR, 0, pack_json({"message": message}))
        except OSError:
            pass

    @staticmethod
    def _best_effort_ack(sock: socket.socket, seq: int) -> None:
        if seq < 0:
            return
        try:
            send_frame(sock, CH_ACK, seq)
        except OSError:
            pass
