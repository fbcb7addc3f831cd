"""The ONE JSON-header+raw-buffers blob codec every byte-blob lane
shares, kind-tagged so no lane can silently misread another's blobs.

The port's copy of ``tony_tpu/serving/blobcodec.py``, on the same wire:
a blob packed by either package unpacks in the other, byte for byte.
Three kinds ride it: KV row shipments (``kv_row``), shared-prefix
templates (``prefix_template``) and weight artifacts (``weights``).
Each lane holds a :class:`BlobCodec` bound to its kind:
:meth:`BlobCodec.pack` stamps the kind into the header,
:meth:`BlobCodec.unpack` parses the blob STRUCTURALLY first (so
truncation / corrupt lengths / unknown dtypes surface as their own
precise errors) and refuses a parse-clean blob whose kind belongs to
another lane.

Wire layout (little-endian)::

    head_len   4 bytes  u32    JSON header length
    header     head_len bytes  {"v": 1, "meta": {..., "kind": ...},
                                "bufs": [{"name", "dtype", "shape"}...]}
    payload    concatenated C-contiguous buffer bytes, in header order

Buffers serialize in sorted-name order — deterministic wire bytes for
identical inputs.

bfloat16 without ``ml_dtypes``: numpy cannot name the type, so the port
carries a bfloat16 buffer as a ``torch.bfloat16`` tensor. Packing writes
its 16-bit payload (an ``int16`` view on the host) under the dtype name
``bfloat16`` — the bytes and header the JAX package writes for an
``ml_dtypes.bfloat16`` array; unpacking a ``bfloat16`` buffer gives a
CPU ``torch.bfloat16`` tensor. Every other dtype is a numpy array both
ways. A torch tensor of another dtype packs as its numpy form, and a
tensor on the card is copied to the host once, by :func:`wire_array`.

Anything structurally off raises the serving wire's
:class:`~tony_tpu_torch.serving.protocol.ProtocolError`.
"""

from __future__ import annotations

import json
import math
import struct
import sys

import numpy as np

from tony_tpu_torch.serving.protocol import ProtocolError

_HLEN = struct.Struct("<I")

#: sanity cap on the JSON header alone (buffer entries are dozens of
#: bytes each; megabytes of "header" is a corrupt length prefix)
MAX_HEADER_BYTES = 1 << 20

#: the registered lane kinds (an UNREGISTERED kind is refused
#: everywhere, so a typo'd producer cannot mint a kind no consumer owns)
KV_ROW_KIND = "kv_row"
TEMPLATE_KIND = "prefix_template"
WEIGHTS_KIND = "weights"
KINDS = (KV_ROW_KIND, TEMPLATE_KIND, WEIGHTS_KIND)

#: the dtype name bfloat16 buffers carry on the wire (``ml_dtypes``'s)
BF16 = "bfloat16"


def np_dtype(name: str) -> np.dtype:
    """Resolve a wire dtype string to the numpy dtype of its payload:
    plain numpy names as themselves, ``bfloat16`` as ``int16`` (its
    16-bit payload; :func:`from_wire` turns it into a torch tensor)."""
    if name == BF16:
        return np.dtype(np.int16)
    try:
        return np.dtype(name)
    except TypeError as e:
        raise ProtocolError(f"unknown shipment dtype {name!r}") from e


def is_tensor(a) -> bool:
    """Whether ``a`` is a torch tensor, without importing torch: a host
    with no model stack (a router) never loads it, and a tensor exists
    only where torch is loaded already."""
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(a, torch.Tensor)


def wire_array(a) -> tuple[str, list, np.ndarray]:
    """(wire dtype name, shape, C-contiguous numpy payload) of a numpy
    array or a torch tensor (a tensor on the card is copied to the host
    once). bfloat16 — a torch tensor, or a numpy array whose dtype is
    named ``bfloat16`` — ships as its ``int16`` view."""
    if is_tensor(a):
        import torch
        t = a.detach()
        if hasattr(t, "full_tensor"):
            t = t.full_tensor()
        t = t.cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return BF16, list(t.shape), t.view(torch.int16).numpy()
        a = t.numpy()
    a = np.asarray(a)
    shape = list(a.shape)       # before ascontiguousarray: it promotes
    if not a.flags["C_CONTIGUOUS"]:     # 0-d to 1-d
        a = np.ascontiguousarray(a)
    if a.dtype.name == BF16:
        return BF16, shape, a.view(np.int16)
    return str(a.dtype), shape, a


def from_wire(name: str, buf, count: int, offset: int, shape):
    """The buffer of ``count`` elements of wire dtype ``name`` at byte
    ``offset`` of ``buf``, shaped ``shape``: a numpy view of ``buf``, or
    for ``bfloat16`` a CPU ``torch.bfloat16`` tensor (a copy)."""
    a = np.frombuffer(buf, dtype=np_dtype(name), count=count,
                      offset=offset).reshape(shape)
    if name == BF16:
        import torch
        return torch.from_numpy(a.copy()).view(torch.bfloat16)
    return a


def pack_blob(meta: dict, bufs: dict) -> bytes:
    """-> one blob (header + raw buffers). ``bufs``: {name: ndarray or
    tensor}; buffers are serialized C-contiguous in sorted-name order
    (deterministic wire bytes for identical inputs)."""
    entries, blobs = [], []
    for name in sorted(bufs):
        dtype, shape, a = wire_array(bufs[name])
        entries.append({"name": name, "dtype": dtype, "shape": shape})
        blobs.append(a.tobytes())
    head = json.dumps({"v": 1, "meta": meta, "bufs": entries},
                      separators=(",", ":")).encode("utf-8")
    return _HLEN.pack(len(head)) + head + b"".join(blobs)


def unpack_blob(blob: bytes) -> tuple[dict, dict]:
    """Parse a blob -> (meta, {name: buffer}), structural validation
    only (kind gating is the codec's job). numpy buffers view the blob's
    memory (no copy); bfloat16 buffers are torch tensors."""
    if len(blob) < _HLEN.size:
        raise ProtocolError("shipment shorter than its header prefix")
    (hlen,) = _HLEN.unpack_from(blob, 0)
    if hlen > MAX_HEADER_BYTES or _HLEN.size + hlen > len(blob):
        raise ProtocolError(f"implausible shipment header length {hlen}")
    try:
        head = json.loads(blob[_HLEN.size:_HLEN.size + hlen]
                          .decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"malformed shipment header: {e}") from e
    if not isinstance(head, dict) or not isinstance(head.get("meta"),
                                                    dict):
        raise ProtocolError(f"shipment header is not an object: {head!r}")
    entries = head.get("bufs")
    if not isinstance(entries, list):
        raise ProtocolError("shipment header missing buffer table")
    bufs: dict = {}
    off = _HLEN.size + hlen
    for e in entries:
        if (not isinstance(e, dict) or not isinstance(e.get("name"), str)
                or not isinstance(e.get("dtype"), str)
                or not isinstance(e.get("shape"), list)
                or not all(isinstance(d, int) and not isinstance(d, bool)
                           and d >= 0 for d in e["shape"])):
            raise ProtocolError(f"malformed buffer entry: {e!r}")
        dt = np_dtype(e["dtype"])
        # python-int math: np.prod would WRAP on adversarial shapes
        count = math.prod(e["shape"])
        n = count * dt.itemsize
        if off + n > len(blob):
            raise ProtocolError(
                f"shipment truncated: buffer {e['name']!r} promises "
                f"{n} bytes past the blob end")
        bufs[e["name"]] = from_wire(e["dtype"], blob, count, off,
                                    e["shape"])
        off += n
    if off != len(blob):
        raise ProtocolError(
            f"shipment carries {len(blob) - off} trailing bytes beyond "
            f"its buffer table")
    return head["meta"], bufs


class BlobCodec:
    """One lane's binding to the shared wire shape: packs with the
    lane's kind stamped into the meta, unpacks with the kind gated.

    ``allow_untagged`` grandfathers blobs whose meta carries NO kind
    (the pre-kind kv-row wire shape) — a blob tagged with a DIFFERENT
    kind is always refused, tagged or not."""

    def __init__(self, kind: str, *, allow_untagged: bool = False) -> None:
        if kind not in KINDS:
            raise ValueError(f"unregistered blob kind {kind!r}; "
                             f"expected one of {KINDS}")
        self.kind = kind
        self.allow_untagged = allow_untagged

    def pack(self, meta: dict, bufs: dict) -> bytes:
        out = dict(meta)
        out["kind"] = self.kind
        return pack_blob(out, bufs)

    def unpack(self, blob: bytes) -> tuple[dict, dict]:
        meta, bufs = unpack_blob(blob)
        kind = meta.get("kind")
        if kind != self.kind and not (kind is None and
                                      self.allow_untagged):
            raise ProtocolError(
                f"blob kind {kind!r} does not belong on the "
                f"{self.kind!r} lane")
        return meta, bufs


#: the three lane bindings (kv rows tolerate untagged legacy metas;
#: the newer lanes never shipped untagged and do not)
KV_ROW = BlobCodec(KV_ROW_KIND, allow_untagged=True)
PREFIX_TEMPLATE = BlobCodec(TEMPLATE_KIND)
WEIGHTS = BlobCodec(WEIGHTS_KIND)
