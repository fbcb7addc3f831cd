"""Content-addressed weight distribution: the warm boot path.

The port's copy of ``tony_tpu/serving/weightstore.py``'s weight lane, on
the same wire: a replica of either package seeds a cold replica of the
other, peer to peer over a TONYC1 byte-blob lane (``WEIGHT_CHANNEL``)
instead of a storage load.

- **Identity**: :func:`tree_digest` — sha256 over the canonical
  serialized weight tree (sorted flattened paths, ``buf\\0path\\0
  dtype\\0shape\\0payload`` entry framing): content only. A tree
  converted between the packages digests the same; the landing side
  recomputes the digest and REFUSES a mismatch.
- **Wire shape**: the kind-tagged blob codec
  (:mod:`tony_tpu_torch.serving.blobcodec`, kind ``weights``) riding
  :meth:`~tony_tpu_torch.channels.channel.ChannelSender.send_bytes`, so
  an artifact ships as bounded chunks with seq-resume.
- **Optional int8 wire quantization**: float leaves ship as int8 + a
  per-tensor scale; the digest names the DEQUANTIZED tree, the values
  the receiver will serve.

Leaves are torch tensors (on any device: one host copy each when
packed) or numpy arrays; a bfloat16 leaf packs as its 16-bit payload
under the dtype name ``bfloat16`` and lands as a CPU ``torch.bfloat16``
tensor, every other leaf lands as a numpy array —
:func:`~tony_tpu_torch.models.weights.params_from_numpy` turns the
landed tree into the port's params on a device.

Hosting mirrors the prefix lane: :class:`WeightHost` is the mixin a
serving server uses to hold a :class:`WeightStore`, land shipped
artifacts, advertise resident digests in HELLO/STATS, and publish an
artifact to a peer on command (the ``WEIGHTS`` frame ops).
:func:`pull_weights` is the cold replica's side.

Not ported: the compile-cache artifacts (the JAX package ships its XLA
compilation cache; a ``compile_cache`` artifact landing here is refused
and costs only itself) and the fleet fan-out (``warm_fanout``,
``FleetWarmer``, ``ChannelWarmer``), which belongs with the router.
"""

from __future__ import annotations

import hashlib
import logging
import socket
import threading
import time

import numpy as np

from tony_tpu_torch.channels.channel import (ChannelClosed, ChannelError,
                                             ChannelHub, ChannelSender)
from tony_tpu_torch.serving import blobcodec
from tony_tpu_torch.serving import protocol as P
from tony_tpu_torch.serving.protocol import ProtocolError

log = logging.getLogger(__name__)

#: the channel lane weight artifacts ride (multiplexed by name on the
#: host's blob hub beside the prefix lane)
WEIGHT_CHANNEL = "weights"

#: the defaults of the JAX package's ``tony.weights.chunk-bytes`` (the
#: chunk an artifact ships in) and ``tony.weights.quantize-wire`` keys
CHUNK_BYTES_DEFAULT = 8 << 20
QUANTIZE_WIRE_DEFAULT = False

#: path separator in flattened tree names; list indices are marked ``#i``
_SEP = "/"
_IDX = "#"


# ---------------------------------------------------------------------------
# Canonical tree form + content digest
# ---------------------------------------------------------------------------
def flatten_tree(tree, prefix: str = "") -> dict:
    """Flatten a nested params tree (dicts / lists / tuples of tensors or
    array-likes) to ``{path: leaf}`` with deterministic ``/``-joined
    paths (``#i`` for sequence indices). The inverse is
    :func:`unflatten_tree`."""
    out: dict = {}
    if isinstance(tree, dict):
        for k in tree:
            if not isinstance(k, str) or _SEP in k or k.startswith(_IDX):
                raise ValueError(
                    f"weight tree key {k!r} is not flattenable (string "
                    f"keys without {_SEP!r}, not starting with {_IDX!r})")
            sub = prefix + _SEP + k if prefix else k
            out.update(flatten_tree(tree[k], sub))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            sub = f"{prefix}{_SEP}{_IDX}{i}" if prefix else f"{_IDX}{i}"
            out.update(flatten_tree(v, sub))
    else:
        out[prefix or _IDX + "0"] = tree
    return out


def unflatten_tree(flat: dict):
    """Rebuild the nested tree :func:`flatten_tree` serialized.
    Sequences come back as lists."""
    root: dict = {}
    for path, arr in flat.items():
        parts = path.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def build(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith(_IDX) for k in node):
            idx = sorted(node, key=lambda k: int(k[len(_IDX):]))
            if [int(k[len(_IDX):]) for k in idx] != list(range(len(idx))):
                raise ProtocolError(
                    f"weight tree has a gapped sequence: {sorted(node)}")
            return [build(node[k]) for k in idx]
        return {k: build(v) for k, v in node.items()}

    out = build(root)
    if isinstance(out, list) and len(out) == 1 and list(flat) == [
            _IDX + "0"]:
        return out[0]                       # bare-leaf round trip
    return out


def _is_leaf(v) -> bool:
    return isinstance(v, np.ndarray) or blobcodec.is_tensor(v)


def tree_digest(tree) -> str:
    """sha256 hex over the canonical serialized weight tree: entries in
    sorted flattened-path order, each framed ``buf\\0path\\0dtype\\0
    shape\\0`` + C-contiguous payload + ``\\0`` — content only. Accepts
    a nested tree or an already-flat ``{path: leaf}`` dict; a bfloat16
    tensor hashes its 16-bit payload under the dtype name
    ``bfloat16``."""
    flat = tree if (isinstance(tree, dict) and tree and all(
        _is_leaf(v) for v in tree.values())) else flatten_tree(tree)
    h = hashlib.sha256()
    for path in sorted(flat):
        dtype, shape, a = blobcodec.wire_array(flat[path])
        dims = ",".join(str(d) for d in shape)
        h.update(f"buf\0{path}\0{dtype}\0{dims}\0".encode("utf-8"))
        h.update(a.tobytes())
        h.update(b"\0")
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Artifact pack / unpack (digest-gated)
# ---------------------------------------------------------------------------
def _f32(a) -> np.ndarray:
    """A float leaf (tensor or array) as a host float32 array."""
    if blobcodec.is_tensor(a):
        return a.detach().float().cpu().numpy()
    dtype, _, bits = blobcodec.wire_array(a)
    if dtype == blobcodec.BF16:
        import torch
        return torch.from_numpy(bits.copy()).view(torch.bfloat16) \
            .float().numpy()
    return np.asarray(a, np.float32)


def _is_float(a) -> bool:
    if blobcodec.is_tensor(a):
        return a.is_floating_point()
    a = np.asarray(a)
    return a.dtype.kind == "f" or a.dtype.name == blobcodec.BF16


def _quantize(a) -> tuple:
    """Symmetric per-tensor int8: -> (q int8 array, scale as exact
    python float)."""
    f = _f32(a)
    amax = float(np.max(np.abs(f))) if f.size else 0.0
    scale = np.float32(amax / 127.0) if amax > 0 else np.float32(0.0)
    if scale == 0:
        q = np.zeros(f.shape, np.int8)
    else:
        q = np.clip(np.rint(f / scale), -127, 127).astype(np.int8)
    return q, float(scale)


def _dequantize(q: np.ndarray, scale: float, dtype_name: str):
    f = q.astype(np.float32) * np.float32(scale)
    if dtype_name == blobcodec.BF16:
        import torch
        return torch.from_numpy(f).to(torch.bfloat16)
    return f.astype(blobcodec.np_dtype(dtype_name))


def pack_weights(params, *, version: str | None = None,
                 quantize: bool | None = None) -> bytes:
    """Pack a params tree into ONE content-addressed weight artifact.
    The meta's ``digest`` names the AS-SERVED tree: the tree itself when
    unquantized, the dequantized tree when ``quantize=True``.
    ``quantize=None`` takes :data:`QUANTIZE_WIRE_DEFAULT`.
    Each leaf is copied to the host once."""
    if quantize is None:
        quantize = QUANTIZE_WIRE_DEFAULT
    flat = {path: leaf.detach().cpu() if blobcodec.is_tensor(leaf)
            else leaf for path, leaf in flatten_tree(params).items()}
    scales: dict = {}
    wire: dict = {}
    for path, a in flat.items():
        if quantize and _is_float(a):
            q, scale = _quantize(a)
            scales[path] = [scale, blobcodec.wire_array(a)[0]]
            wire[path] = q
        else:
            wire[path] = a
    if quantize:
        served = {p: (_dequantize(wire[p], *scales[p])
                      if p in scales else wire[p]) for p in wire}
    else:
        served = flat
    meta = {"part": "weights", "digest": tree_digest(served),
            "quantized": bool(scales)}
    if version is not None:
        meta["version"] = str(version)
    if scales:
        meta["scales"] = scales
    return blobcodec.WEIGHTS.pack(meta, wire)


def peek_weights_meta(blob: bytes) -> dict:
    """Parse just the artifact meta (no digest verification — use for
    advertising / routing, never for landing)."""
    meta, _ = blobcodec.WEIGHTS.unpack(blob)
    return meta


def unpack_weights(blob: bytes) -> tuple:
    """Land a weight artifact -> (meta, params tree), REFUSING any blob
    whose recomputed as-served digest mismatches its claimed one (a
    flipped byte is a ProtocolError here, never silently served).
    Quantized artifacts are dequantized first; the returned tree is
    exactly the tree the digest names."""
    meta, bufs = blobcodec.WEIGHTS.unpack(blob)
    if meta.get("part") != "weights":
        raise ProtocolError(
            f"not a weight artifact (part={meta.get('part')!r})")
    claimed = meta.get("digest")
    if not isinstance(claimed, str) or len(claimed) != 64:
        raise ProtocolError(f"malformed weight digest: {claimed!r}")
    scales = meta.get("scales") or {}
    if not isinstance(scales, dict):
        raise ProtocolError(f"malformed scale table: {scales!r}")
    served: dict = {}
    for path, a in bufs.items():
        sc = scales.get(path)
        if sc is not None:
            if (not isinstance(sc, list) or len(sc) != 2
                    or not isinstance(sc[1], str)):
                raise ProtocolError(f"malformed scale entry: {sc!r}")
            if not isinstance(a, np.ndarray) or a.dtype != np.int8:
                raise ProtocolError(
                    f"scaled leaf {path!r} is {a.dtype}, expected int8")
            served[path] = _dequantize(a, float(sc[0]), sc[1])
        else:
            served[path] = a
    got = tree_digest(served)
    if got != claimed:
        raise ProtocolError(
            f"weight artifact REFUSED: landed digest {got[:12]}… != "
            f"claimed {claimed[:12]}… (corrupt or tampered transfer)")
    return meta, unflatten_tree(served)


# ---------------------------------------------------------------------------
# The resident store
# ---------------------------------------------------------------------------
class WeightStore:
    """Resident content-addressed artifacts, keyed by digest. Holds the
    PACKED blobs (what ships — no re-serialization per publish) plus
    their metas; an ``exporter`` callable lazily packs this host's own
    live params the first time someone asks for them."""

    def __init__(self, registry=None, exporter=None) -> None:
        from tony_tpu_torch.runtime import metrics as metrics_mod
        reg = registry or metrics_mod.get_default()
        self._lock = threading.Lock()
        self._artifacts: dict = {}          # digest -> (meta, blob)
        self._exporter = exporter
        self._exported = False
        self._installs_c = reg.counter(
            "tony_weight_installs_total",
            help="weight artifacts landed resident (digest-verified)")

    def put(self, blob: bytes) -> str:
        """Make a packed weight artifact resident after the full
        as-served digest gate; returns the digest. A corrupt blob can
        never land resident and be re-seeded peer to peer."""
        meta = peek_weights_meta(blob)
        if meta.get("part") != "weights":
            raise ProtocolError(
                f"{meta.get('part')!r} artifacts are not ported to this "
                f"replica (weights only)")
        meta, _tree = unpack_weights(blob)
        digest = meta["digest"]
        with self._lock:
            self._artifacts[digest] = (meta, bytes(blob))
        self._installs_c.inc()
        return digest

    def get(self, digest: str) -> bytes:
        """The packed blob for ``digest`` (ValueError when not
        resident)."""
        with self._lock:
            self._ensure_exported_locked()
            entry = self._artifacts.get(digest)
        if entry is None:
            raise ValueError(f"artifact {digest[:12]}… is not resident")
        return entry[1]

    def meta(self, digest: str) -> dict:
        with self._lock:
            self._ensure_exported_locked()
            entry = self._artifacts.get(digest)
        if entry is None:
            raise ValueError(f"artifact {digest[:12]}… is not resident")
        return dict(entry[0])

    def digests(self) -> list:
        """Every artifact this host can SEED — triggers the lazy
        self-export (packing the live params) the first time."""
        with self._lock:
            self._ensure_exported_locked()
            return sorted(self._artifacts)

    def resident_digests(self) -> list:
        """Digests already resident, WITHOUT triggering the lazy
        self-export (what HELLO/STATS advertise: a handshake must never
        pack the params)."""
        with self._lock:
            return sorted(self._artifacts)

    def _ensure_exported_locked(self) -> None:
        if self._exported or self._exporter is None:
            return
        self._exported = True               # once, even on failure
        try:
            blob = self._exporter()
        except Exception as e:              # noqa: BLE001 — advisory
            log.warning("weight export failed; serving without a "
                        "seedable artifact: %s", e)
            return
        if blob is None:
            return
        meta = peek_weights_meta(blob)
        digest = meta.get("digest")
        if isinstance(digest, str) and len(digest) == 64:
            self._artifacts[digest] = (meta, bytes(blob))


# ---------------------------------------------------------------------------
# Hosting: the weights lane + WEIGHTS frame ops (mirrors PrefixHost)
# ---------------------------------------------------------------------------
class WeightHost:
    """Mixin: a serving server that holds a :class:`WeightStore` and can
    be WARMED over the weights lane. Call ``_init_weight_host(registry,
    exporter=, hub=)`` in ``__init__`` (pass the prefix hub to share one
    blob port), ``_start_weight_host()`` / ``_stop_weight_host()``
    around the serving lifecycle, and route ``WEIGHTS`` frames to
    :meth:`_handle_weights_frame`."""

    def _init_weight_host(self, registry, exporter=None,
                          hub: ChannelHub | None = None) -> None:
        self._weight_reg = registry
        self._weight_hub_owned = hub is None
        self._weight_hub = hub if hub is not None else ChannelHub(
            port=0, capacity=4, registry=registry)
        self.weight_store = WeightStore(registry, exporter=exporter)
        self._weight_install_thread: threading.Thread | None = None
        self._weight_ship_h = registry.histogram(
            "tony_weight_ship_seconds",
            help="weight artifact publication wall per ship (pack lookup "
                 "+ chunked channel send + the peer's ack)")
        self._weight_ship_bytes_c = registry.counter(
            "tony_weight_ship_bytes_total",
            help="weight artifact payload bytes published to peer "
                 "replicas")

    @property
    def weight_port(self) -> int:
        """The weights lane's bound port (HELLO-advertised)."""
        return self._weight_hub.port

    def _start_weight_host(self) -> None:
        if self._weight_hub_owned:
            self._weight_hub.start()
        self._weight_install_thread = threading.Thread(
            target=self._weight_install_loop, name="tony-weight-install",
            daemon=True)
        self._weight_install_thread.start()

    def _stop_weight_host(self) -> None:
        if self._weight_hub_owned:
            self._weight_hub.stop()
        if self._weight_install_thread is not None:
            self._weight_install_thread.join(timeout=10)

    # -- the install thread (artifact ships land here) ----------------------
    def _weight_install_loop(self) -> None:
        receiver = self._weight_hub.receiver(WEIGHT_CHANNEL)
        while True:
            try:
                # 0.25 s bounds only the idle poll for a blob to START;
                # reassembly runs under recv_bytes' per-chunk deadline
                blob = receiver.recv_bytes(timeout=0.25)
            except ChannelClosed:
                return                  # hub stopped: lane is dead
            except ChannelError:
                continue                # idle poll; re-check liveness
            except ProtocolError as e:
                log.warning("weights lane: non-artifact frame dropped: "
                            "%s", e)
                continue
            try:
                digest = self.weight_store.put(blob)
                log.info("weight artifact %s… resident via ship "
                         "(%d bytes)", digest[:12], len(blob))
            except Exception as e:      # noqa: BLE001 — thread survival
                # a bad artifact costs only itself
                log.warning("weights lane: artifact refused: %s", e)
                from tony_tpu_torch.runtime import tracing
                tracing.get_flight().record("weight_artifact_refused",
                                            error=str(e)[:500])

    # -- publication --------------------------------------------------------
    def publish_weights(self, digest: str, target: str,
                        timeout_s: float = 120.0,
                        chunk_bytes: int | None = None) -> int:
        """Ship the resident artifact ``digest`` to ``target`` (a peer's
        ``host:weight_port`` weights lane) as chunked, delivery-confirmed,
        seq-resumable channel frames; returns the blob size. Raises
        ``ValueError`` (not resident) or
        :class:`~tony_tpu_torch.channels.channel.ChannelError` (peer
        unreachable)."""
        if chunk_bytes is None:
            chunk_bytes = CHUNK_BYTES_DEFAULT
        blob = self.weight_store.get(digest)
        t0 = time.perf_counter()
        sender = ChannelSender(target, WEIGHT_CHANNEL, window=8,
                               registry=self._weight_reg)
        try:
            sender.send_bytes(blob, sync=True, timeout=timeout_s,
                              chunk_bytes=chunk_bytes)
        finally:
            sender.close(drain=False)
        self._weight_ship_h.observe(time.perf_counter() - t0)
        self._weight_ship_bytes_c.inc(len(blob))
        return len(blob)

    # -- the WEIGHTS frame ops (conn reader threads) ------------------------
    def _handle_weights_frame(self, conn, rid: int,
                              payload: bytes) -> None:
        """``WEIGHTS`` op dispatch. Op failures are REQUEST-scoped."""
        obj = P.unpack_json(payload)    # structural garbage: conn-scoped
        op = obj.get("op")
        try:
            if op == "publish":
                digest = obj.get("digest")
                target = obj.get("target")
                if not isinstance(digest, str) \
                        or not isinstance(target, str):
                    raise ValueError("publish needs 'digest' and "
                                     "'target'")
                n = self.publish_weights(
                    digest, target,
                    timeout_s=float(obj.get("timeout_s", 120.0)))
                body = {"ok": True, "digest": digest, "bytes": n}
            elif op == "list":
                # seed intent: triggers the lazy self-export
                body = {"ok": True,
                        "resident": self.weight_store.digests()}
            elif op == "resident":
                # residency poll: never triggers the export
                body = {"ok": True,
                        "resident":
                            self.weight_store.resident_digests()}
            else:
                body = {"ok": False,
                        "error": f"unknown weights op {op!r}"}
        except (ValueError, KeyError, ChannelError, ProtocolError) as e:
            body = {"ok": False, "error": str(e)}
        conn.send(P.WEIGHTS, rid, P.pack_json(body))


# ---------------------------------------------------------------------------
# Peer-to-peer pull (the cold replica's boot path)
# ---------------------------------------------------------------------------
def weights_rpc(addr: str, body: dict, timeout_s: float = 30.0) -> dict:
    """One WEIGHTS control round-trip against a replica's serving port:
    handshake, send the op, return the reply body (and the replica's
    HELLO under ``"_hello"``)."""
    host, port = addr.rsplit(":", 1)
    with socket.create_connection((host, int(port)),
                                  timeout=timeout_s) as sock:
        sock.sendall(P.MAGIC)
        hello = P.recv_frame(sock)
        if hello is None or hello[0] != P.HELLO:
            raise ChannelError(f"replica {addr}: no HELLO")
        hello_body = P.unpack_json(hello[2])
        P.send_frame(sock, P.WEIGHTS, 1, P.pack_json(body))
        deadline = time.monotonic() + timeout_s
        while True:
            sock.settimeout(max(0.1, deadline - time.monotonic()))
            frame = P.recv_frame(sock)
            if frame is None:
                raise ChannelError(f"replica {addr} closed mid-op")
            if frame[0] == P.WEIGHTS:
                out = P.unpack_json(frame[2])
                out["_hello"] = hello_body
                return out


def _reachable_host(peer: str, default: str = "127.0.0.1") -> str:
    """The local address the kernel routes TOWARD ``peer`` from — what a
    puller must advertise as its weights-lane host. The UDP connect
    picks the outbound interface without sending a packet; on failure
    fall back to ``default``."""
    host, _, port = peer.rpartition(":")
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect((host or peer, int(port) if port.isdigit() else 1))
        return s.getsockname()[0]
    except OSError:
        return default
    finally:
        s.close()


def pull_weights(seeder: str, digest: str | None = None,
                 timeout_s: float = 120.0, registry=None,
                 advertise_host: str | None = None) -> tuple:
    """The cold replica's warm boot path: stand up a one-shot weights
    lane, ask ``seeder`` (a warm replica's serving address, of either
    package) to publish its artifact here, land it digest-verified, and
    return ``(meta, params tree)`` — numpy leaves, bfloat16 ones as CPU
    ``torch.bfloat16`` tensors. ``digest=None`` takes the seeder's first
    advertised artifact. Raises ChannelError (seeder unreachable /
    refused / timed out) or ProtocolError (artifact refused at the
    digest gate) — callers fall back to a storage load."""
    from tony_tpu_torch.runtime import metrics as metrics_mod
    reg = registry or metrics_mod.MetricsRegistry()
    hub = ChannelHub(port=0, capacity=4, registry=reg)
    hub.start()
    landed: dict = {}

    def land():
        try:
            landed["blob"] = receiver.recv_bytes(timeout=timeout_s)
        except (ChannelError, ProtocolError) as e:
            landed["error"] = e

    try:
        receiver = hub.receiver(WEIGHT_CHANNEL)
        if digest is None:
            listed = weights_rpc(seeder, {"op": "list"},
                                 timeout_s=min(30.0, timeout_s))
            resident = listed.get("resident") or []
            if not resident:
                raise ChannelError(
                    f"seeder {seeder} has no resident artifact")
            digest = resident[0]
        if advertise_host is None:
            advertise_host = _reachable_host(seeder)
        target = f"{advertise_host}:{hub.port}"
        # the artifact is consumed WHILE it ships: the seeder's publish
        # returns only once its last chunk is acked, and the hub acks no
        # more than its capacity of frames nobody consumes
        lander = threading.Thread(target=land, name="tony-weight-pull",
                                  daemon=True)
        lander.start()
        res = weights_rpc(seeder, {"op": "publish", "digest": digest,
                                   "target": target,
                                   "timeout_s": timeout_s},
                          timeout_s=timeout_s)
        if not res.get("ok"):
            raise ChannelError(
                f"seeder {seeder} refused publish: {res.get('error')}")
        lander.join(timeout=timeout_s)
        if "blob" not in landed:
            raise landed.get("error") or ChannelError(
                f"no artifact landed from {seeder} in {timeout_s}s")
        meta, tree = unpack_weights(landed["blob"])
        if meta.get("digest") != digest:
            raise ProtocolError(
                f"seeder shipped {meta.get('digest')!r}, asked for "
                f"{digest!r}")
        return meta, tree
    finally:
        hub.stop()
