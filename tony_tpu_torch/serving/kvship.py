"""KV shipment wire codec: how a prefilled row travels prefill gang →
decode gang (disaggregated serving), and how a shared-prefix template
travels between replicas.

The port's copy of ``tony_tpu/serving/kvship.py``, on the same wire: a
template packed by either package unpacks in the other, bit for bit.
The port serves templates today; the KV row metas come along for the
disaggregated slice.

A shipment is ONE opaque blob — JSON metadata plus the row's named
cache buffers concatenated raw — that rides the TONYC1 tensor plane as
byte-blob frames (:meth:`ChannelSender.send_bytes`), so the channel
plane needs no knowledge of cache layouts and the shipment inherits
the channel's bounded-window backpressure, reconnect-with-resume, and
exactly-once delivery for free.

The wire shape itself (header + raw buffers, kind-tagged) lives in
:mod:`tony_tpu_torch.serving.blobcodec` — ONE codec shared by the three blob
lanes (KV rows here, prefix templates below, weight artifacts in
:mod:`tony_tpu_torch.serving.weightstore`); this module binds the serving
semantics: the KV adoption record, the template identity checks.

``meta`` carries the adoption record: ``rid`` (the router's request
id), ``budget`` (remaining new tokens), ``length`` (the row's
frontier), ``rng`` (two u32 words of the per-request stream key) +
``rng_off`` (stream position — the state that makes SAMPLED
disaggregated output identical to colocated serving), and an optional
``trace`` span context so the decode gang's engine spans join the
request's trace.

Buffers ship in their STORAGE dtype: an int8-quantized cache ships
int8 values + f32 scales (~half the bytes of dequantizing to bf16 —
test-pinned), bf16 ships bf16 — in the port a ``torch.bfloat16``
tensor, carried as its 16-bit payload (see
:mod:`tony_tpu_torch.serving.blobcodec`).

Anything structurally off raises the serving wire's
:class:`~tony_tpu_torch.serving.protocol.ProtocolError` (channel-scoped at
the hub, request-scoped at the decode server's landing thread).
"""

from __future__ import annotations

import numpy as np

from tony_tpu_torch.serving import blobcodec
from tony_tpu_torch.serving.protocol import QOS_CLASSES, ProtocolError

#: the ``kind`` tags distinguishing the three blob lanes sharing one
#: wire shape (a template arriving on the kvship lane fails
#: ``unpack_shipment``'s kind gate; a row shipment arriving on the
#: prefix lane fails ``unpack_template`` — neither can be silently
#: misread as the other). The codec itself lives in
#: :mod:`tony_tpu_torch.serving.blobcodec`.
KV_ROW_KIND = blobcodec.KV_ROW_KIND
TEMPLATE_KIND = blobcodec.TEMPLATE_KIND

#: sanity cap on a template's token list (a prefix is a system prompt /
#: few-shot header, not a corpus; a million-token "prefix" is a corrupt
#: or adversarial header)
MAX_TEMPLATE_TOKENS = 1 << 20


def pack_shipment(meta: dict, bufs: dict) -> bytes:
    """-> one KV row shipment blob (kind-tagged ``kv_row``). ``bufs``:
    {name: ndarray}; arrays are serialized C-contiguous in sorted-name
    order (deterministic wire bytes for identical inputs)."""
    return blobcodec.KV_ROW.pack(meta, bufs)


def unpack_shipment(blob: bytes) -> tuple[dict, dict]:
    """Parse a KV row shipment blob -> (meta, {name: ndarray}). Arrays
    view the blob's memory (frombuffer — no copy). A parse-clean blob
    belonging to ANOTHER lane (a prefix template, a weight artifact)
    is refused at the kind gate."""
    return blobcodec.KV_ROW.unpack(blob)


def pack_kv_meta(rid: int, budget: int, length: int, rng_key,
                 rng_off: int = 0, cls: str = "standard",
                 trace: dict | None = None) -> dict:
    """The adoption-record meta for one prefilled row (see module
    docstring); ``rng_key`` is the [2] uint32 per-request stream key.
    ``cls`` is the request's QoS class — shipped only when non-default
    (old wires unchanged) so the decode tier's class floors and
    preemption apply to the adopted row."""
    k = np.asarray(rng_key, np.uint32).reshape(-1)
    meta = {"rid": int(rid), "budget": int(budget),
            "length": int(length),
            "rng": [int(k[0]), int(k[1])], "rng_off": int(rng_off)}
    if cls != "standard":
        meta["class"] = str(cls)
    if trace is not None:
        meta["trace"] = trace
    return meta


def pack_template(prefix_id: str, tokens, bufs: dict, vocab: int) -> bytes:
    """Pack a shared-prefix K/V template for publication to a peer
    replica: the shared blob wire shape (:mod:`~tony_tpu_torch.serving.
    blobcodec`), with the meta carrying the template's identity —
    ``id``, the prefix ``tokens`` (the installer registers them for
    prompt matching and suffix splitting), and the producing model's
    ``vocab`` (a template from a differently-shaped model must be
    rejected at install, not discovered as garbage logits mid-serve).
    ``bufs`` ship in their STORAGE dtype exactly like row shipments —
    an int8-quantized cache's template is int8 values + f32 scales,
    bf16 stays bf16 (bit-identical round trip, test-pinned)."""
    meta = {"id": str(prefix_id),
            "tokens": [int(t) for t in tokens], "vocab": int(vocab)}
    return blobcodec.PREFIX_TEMPLATE.pack(meta, bufs)


def unpack_template(blob: bytes) -> tuple[dict, dict]:
    """Parse + validate a template blob -> (meta, {name: ndarray}).
    Anything structurally off — including a KV row shipment or weight
    artifact routed onto the template lane — raises ProtocolError; the
    install thread drops the blob and keeps serving."""
    try:
        meta, bufs = blobcodec.PREFIX_TEMPLATE.unpack(blob)
    except ProtocolError as e:
        if "lane" in str(e):
            raise ProtocolError(
                f"not a prefix template "
                f"(kind={blobcodec.unpack_blob(blob)[0].get('kind')!r})"
            ) from e
        raise
    pid = meta.get("id")
    tokens = meta.get("tokens")
    vocab = meta.get("vocab")
    if not isinstance(pid, str) or not 0 < len(pid) <= 128:
        raise ProtocolError(f"malformed template id: {pid!r}")
    if (not isinstance(tokens, list) or not tokens
            or len(tokens) > MAX_TEMPLATE_TOKENS
            or not all(isinstance(t, int) and not isinstance(t, bool)
                       and t >= 0 for t in tokens)):
        raise ProtocolError("malformed template token list")
    if isinstance(vocab, bool) or not isinstance(vocab, int) or vocab < 1:
        raise ProtocolError(f"malformed template vocab: {vocab!r}")
    if not bufs:
        raise ProtocolError("template carries no buffers")
    return meta, bufs


def parse_kv_meta(meta: dict) -> dict:
    """Validate an adoption record (the decode server's landing thread
    calls this before touching the engine); returns the meta with
    ``rng`` normalized to a [2] uint32 array. Malformed -> ProtocolError
    (the shipment is dropped; the channel keeps delivering)."""
    rid = meta.get("rid")
    budget = meta.get("budget")
    length = meta.get("length")
    rng = meta.get("rng")
    off = meta.get("rng_off", 0)
    if (isinstance(rid, bool) or not isinstance(rid, int)
            or isinstance(budget, bool) or not isinstance(budget, int)
            or isinstance(length, bool) or not isinstance(length, int)
            or isinstance(off, bool) or not isinstance(off, int)):
        raise ProtocolError(f"malformed shipment meta: {meta!r}")
    if (not isinstance(rng, list) or len(rng) != 2
            or not all(isinstance(w, int) and not isinstance(w, bool)
                       and 0 <= w < (1 << 32) for w in rng)):
        raise ProtocolError(f"malformed shipment rng state: {rng!r}")
    cls = meta.get("class", "standard")
    if cls not in QOS_CLASSES:
        raise ProtocolError(f"malformed shipment class: {cls!r}")
    out = dict(meta)
    out["rng"] = np.asarray(rng, np.uint32)
    out["class"] = cls
    return out
