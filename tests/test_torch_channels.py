"""tony_tpu_torch's TONYC1 channel transport against the JAX package's.

The port's copy of ``tony_tpu/channels/channel.py`` carries the serving
host's prefix and weights lanes. Covered, as a subset of
``tests/test_channels.py`` run against the copy:

- the tensor codecs: every frame the port encodes is byte-identical to
  the JAX package's (raw, bf16 and int8 wire codecs; f32, f16, int32
  and bfloat16 — a ``torch.bfloat16`` tensor on the port's side, an
  ``ml_dtypes`` array on JAX's), each package decodes the other's, and
  the kind-tag discipline refuses a mistagged or truncated frame;
- the transport: ordered delivery, the bounded send window blocking
  instead of buffering, reconnect-with-seq-resume after a dropped
  socket (tensor frames and chunked byte blobs), exactly once;
- the wire between the packages: a JAX sender to a port hub and a port
  sender to a JAX hub, tensors and chunked blobs, byte for byte.
"""

import json
import struct
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from tony_tpu.channels import channel as JCH
from tony_tpu.runtime.metrics import MetricsRegistry as JReg
from tony_tpu.serving.protocol import ProtocolError as JProtocolError
from tony_tpu_torch.channels import channel as CH
from tony_tpu_torch.runtime.metrics import MetricsRegistry
from tony_tpu_torch.serving.protocol import ProtocolError

torch.set_num_threads(2)


def _mk_hub(mod=CH, reg_cls=MetricsRegistry, capacity=8):
    reg = reg_cls()
    hub = mod.ChannelHub(capacity=capacity, registry=reg)
    return hub, hub.start(), reg


def _mk_sender(port, mod=CH, reg_cls=MetricsRegistry, name="t", window=8,
               reg=None):
    return mod.ChannelSender(f"127.0.0.1:{port}", name, window=window,
                             registry=reg or reg_cls())


def _bf16_pair(seed=3):
    """The same bfloat16 values as a torch tensor and an ml_dtypes
    array."""
    f = np.random.RandomState(seed).randn(6, 5).astype(np.float32) * 3
    t = torch.from_numpy(f).to(torch.bfloat16)
    return t, t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def _arrays():
    rs = np.random.RandomState(0)
    return {"f32": rs.randn(16, 8).astype(np.float32) * 3,
            "f16": rs.randn(2, 3, 4).astype(np.float16),
            "i32": np.arange(10, dtype=np.int32),
            "scalar": np.float32(2.5).reshape(()),
            "empty": np.zeros((0, 3), np.float32),
            "strided": np.arange(24, dtype=np.float32).reshape(4, 6)[:, ::2]}


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_codec_frames_byte_identical_to_jax(codec):
    """Each frame the port encodes equals the JAX package's, and each
    package decodes the other's to the same values (bfloat16 included:
    a torch tensor here, an ml_dtypes array there, the same bits)."""
    cases = [(a, a) for a in _arrays().values()] + [_bf16_pair()]
    for ours, theirs in cases:
        h, r = CH.encode_tensor(ours, codec)
        jh, jr = JCH.encode_tensor(theirs, codec)
        assert h + r == jh + jr
        got = CH.decode_tensor(jh + jr, codec)
        want = JCH.decode_tensor(h + r, codec)
        assert tuple(got.shape) == want.shape
        if isinstance(got, torch.Tensor):
            assert got.dtype == torch.bfloat16
            assert want.dtype == ml_dtypes.bfloat16
        else:
            assert got.dtype == want.dtype
        assert _bits(got) == _bits(want)


def test_wire_codec_precision():
    a = _arrays()["f32"]
    head, raw = CH.encode_tensor(a, "int8")
    out = CH.decode_tensor(head + raw, "int8")
    assert out.dtype == a.dtype and len(raw) == 4 + a.size
    assert np.max(np.abs(out - a)) <= np.abs(a).max() / 127
    head, raw = CH.encode_tensor(a, "bf16")
    out = CH.decode_tensor(head + raw, "bf16")
    assert np.array_equal(out, a.astype(ml_dtypes.bfloat16)
                          .astype(np.float32))
    for codec in ("int8", "bf16"):
        head, raw = CH.encode_tensor(np.arange(10, dtype=np.int32), codec)
        assert json.loads(head[4:].decode())["wire"] == "raw"


def _craft(header: dict, payload: bytes) -> bytes:
    head = json.dumps(header).encode()
    return struct.pack("<I", len(head)) + head + payload


_F32 = {"dtype": "float32", "shape": [4]}
_BAD_FRAMES = {
    "empty": (b"", "none"),
    "header past frame": (b"\x05\x00\x00\x00ab", "none"),
    "no dtype/shape": (b"\x02\x00\x00\x00{}", "none"),
    "short payload": (_craft(_F32, bytes(15)), "none"),
    "int8 frame on raw channel": (
        _craft(dict(_F32, codec="int8", wire="int8"),
               struct.pack("<f", 1.0) + bytes(4)), "none"),
    "raw frame on int8 channel": (_craft(_F32, bytes(16)), "int8"),
    "bf16 frame on int8 channel": (
        _craft(dict(_F32, codec="bf16", wire="bf16"), bytes(8)), "int8"),
    "truncated scale": (
        _craft(dict(_F32, codec="int8", wire="int8"), b"\x01\x02"), "int8"),
    "non-finite scale": (
        _craft(dict(_F32, codec="int8", wire="int8"),
               struct.pack("<f", float("nan")) + bytes(4)), "int8"),
    "unknown dtype": (
        _craft({"dtype": "float99", "shape": [4], "codec": "int8",
                "wire": "int8"}, struct.pack("<f", 1.0) + bytes(4)),
        "int8"),
    "unknown wire": (
        _craft(dict(_F32, codec="int8", wire="zstd"), bytes(4)), "int8"),
    "int8 wire for int32": (
        _craft({"dtype": "int32", "shape": [4], "codec": "int8",
                "wire": "int8"}, struct.pack("<f", 1.0) + bytes(4)),
        "int8"),
}


@pytest.mark.parametrize("case", sorted(_BAD_FRAMES))
def test_malformed_or_mistagged_frames_are_protocol_errors(case):
    frame, codec = _BAD_FRAMES[case]
    with pytest.raises(ProtocolError):
        CH.decode_tensor(frame, codec)
    with pytest.raises(JProtocolError):         # the JAX package agrees
        JCH.decode_tensor(frame, codec)


def test_ordered_delivery_and_bounded_window():
    """Twenty frames arrive in order; with the consumer stalled the
    sender parks after its window plus the hub's capacity instead of
    buffering the backlog."""
    hub, port, reg = _mk_hub(capacity=1)
    sender = _mk_sender(port, window=2, reg=reg)
    recv = hub.receiver("t")
    done = []

    def producer():
        for i in range(20):
            sender.send(np.full((4,), i, np.float32), timeout=30)
            done.append(i)

    t = threading.Thread(target=producer, daemon=True)
    try:
        t.start()
        time.sleep(0.5)
        assert len(done) <= 4, done
        got = [recv.recv(timeout=10) for _ in range(20)]
        t.join(timeout=10)
        assert not t.is_alive() and len(done) == 20
        assert [int(a[0]) for a in got] == list(range(20))
    finally:
        sender.close(drain=False)
        hub.stop()


def test_reconnect_resumes_tensors_and_chunked_blobs():
    """Severing every socket mid-stream loses nothing: tensor frames and
    a chunked blob (small chunk budget) arrive exactly once, and the
    sender counts its reconnects."""
    hub, port, reg = _mk_hub()
    sender = _mk_sender(port, reg=reg)
    recv = hub.receiver("t")
    blob = bytes(np.random.RandomState(1).randint(0, 256, 5000)
                 .astype(np.uint8))
    got = []

    def consumer():
        for _ in range(12):
            got.append(int(recv.recv(timeout=30)[0]))
        got.append(recv.recv_bytes(timeout=30))

    t = threading.Thread(target=consumer, daemon=True)
    try:
        t.start()
        for i in range(12):
            sender.send(np.full((3,), i, np.float32), timeout=30)
            if i in (3, 8):
                hub.disconnect_all()
        sent = threading.Thread(target=sender.send_bytes, args=(blob,),
                                kwargs=dict(sync=True, timeout=30,
                                            chunk_bytes=600))
        sent.start()
        time.sleep(0.05)
        hub.disconnect_all()
        sent.join(timeout=30)
        t.join(timeout=30)
        assert got[:12] == list(range(12))
        assert got[12] == blob
        assert reg.counter("tony_channel_reconnects_total",
                           channel="t").value >= 1
    finally:
        sender.close(drain=False)
        hub.stop()


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_wire_between_the_packages(direction):
    """A JAX sender reaches a port hub, and a port sender a JAX hub:
    tensors (bfloat16 included), a small blob and a chunked blob arrive
    byte for byte."""
    if direction == "jax-to-port":
        hub, port, _ = _mk_hub(capacity=32)
        sender = _mk_sender(port, mod=JCH, reg_cls=JReg)
    else:
        hub, port, _ = _mk_hub(mod=JCH, reg_cls=JReg, capacity=32)
        sender = _mk_sender(port)
    recv = hub.receiver("t")
    t16, j16 = _bf16_pair(5)
    ours_bf16 = j16 if direction == "jax-to-port" else t16
    f32 = _arrays()["f32"]
    big = bytes(np.random.RandomState(2).randint(0, 256, 3000)
                .astype(np.uint8))
    try:
        sender.send(f32, timeout=30)
        sender.send(ours_bf16, timeout=30)
        sender.send_bytes(b"a small blob", timeout=30)
        sender.send_bytes(big, sync=True, timeout=30, chunk_bytes=512)
        assert np.array_equal(recv.recv(timeout=30), f32)
        assert _bits(recv.recv(timeout=30)) == _bits(t16)
        assert recv.recv_bytes(timeout=30) == b"a small blob"
        assert recv.recv_bytes(timeout=30) == big
    finally:
        sender.close(drain=False)
        hub.stop()
