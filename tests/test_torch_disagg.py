"""tony_tpu_torch's disaggregated prefill/decode serving against the JAX
package's (``tests/test_disagg.py``'s port).

``tiny`` in f32 with the JAX weights converted to torch. Covered:

- the KV codec: every cache layout (f32, bf16, int8, window, ring) ships
  through a real socket pair and lands bit-identical to the port's own
  colocated admission (buffers over [0, length), frontier, logits, rng
  key); int8 ships quantized, linear caches ship the true length only;
  malformed shipments and decode targets are refused;
- a shipment crosses packages: the KV-row header bytes are the JAX
  package's, a JAX blob lands in the port's batcher and the port's blob
  through JAX's ``land_kv_rows`` byte for byte, and the two packages'
  f32 buffers agree within 1e-5;
- a stack of the port's router, prefill tier and decode tier streams the
  JAX colocated engine's tokens, greedy and sampled, int8 and ring (the
  port's own colocated streams exactly; JAX's token for token but for a
  first difference at a near-tie within 1e-4);
- mixed stacks: a JAX prefill tier feeds a port decode tier behind the
  port's router, and a port prefill tier a JAX decode tier behind the
  JAX router, greedy and sampled;
- speculative and prefix-on-decode batchers and a role mismatch are
  refused; the decode tier refuses prompts;
- decode loss and a KV-ship failure fail over with no token duplicated
  or dropped; a planned decode drain, greedy and sampled;
- cancels queued, mid-wave, in a failing wave, racing the landing, a
  tombstoned package, a malformed one, and sink loss: one terminal frame
  each;
- the ``kv.ship`` span parents the decode tier's ``engine.request``; the
  metric series are the JAX package's;
- ``serve_lm --role prefill`` / ``--role decode`` behind a ``--route
  --route_decode`` router as three CPU processes.
"""

import json
import os
import re
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import decode as JD
from tony_tpu.models import serve as JS
from tony_tpu.models import transformer as JT
from tony_tpu.runtime import metrics as JM
from tony_tpu.serving import disagg as JDG
from tony_tpu.serving import kvship as JK
from tony_tpu.serving import router as JR
from tony_tpu_torch import serve_lm
from tony_tpu_torch.channels.channel import ChannelSender
from tony_tpu_torch.models import decode as TD
from tony_tpu_torch.models import serve as TS
from tony_tpu_torch.models import transformer as TT
from tony_tpu_torch.models.weights import params_from_numpy
from tony_tpu_torch.ops import prng
from tony_tpu_torch.runtime import metrics as M
from tony_tpu_torch.runtime import tracing
from tony_tpu_torch.serving import kvship
from tony_tpu_torch.serving import protocol as P
from tony_tpu_torch.serving.client import (ServingConnectionError,
                                           StreamingClient)
from tony_tpu_torch.serving.disagg import DecodeServer, PrefillServer
from tony_tpu_torch.serving.router import ServingRouter

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = JT.PRESETS["tiny"].scaled(dtype=jnp.float32, remat=False)
TCFG = TT.PRESETS["tiny"].scaled(dtype=torch.float32, remat=False)
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9, seed=7)


def _pair(**extra):
    jcfg, tcfg = JCFG.scaled(**extra), TCFG.scaled(**extra)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax.device_get(jp),
                                             device="cpu")


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _prompts(seed, sizes):
    rs = np.random.RandomState(seed)
    return [[int(t) for t in rs.randint(0, TCFG.vocab_size, size=n)]
            for n in sizes]


def _reference(tp, prompt, n, cfg=TCFG):
    out = TD.generate(tp, torch.tensor([prompt]), cfg, n)
    return out.tokens[0, len(prompt):].tolist()


def _near_tie_diffs(tp, prompts, got, want, cfg=TCFG, limit=1e-4):
    """Every stream of ``got`` equals ``want``'s, or first differs where
    the two tokens' logits (after the prompt and ``want``'s tokens so
    far) lie within ``limit``. Returns the differences."""
    diffs = []
    for i, (p, g, w) in enumerate(zip(prompts, got, want)):
        if g == w:
            continue
        j = next(t for t, (a, b) in enumerate(zip(g, w)) if a != b)
        lg, _ = TD.prefill(tp, torch.tensor([p + w[:j]]), cfg,
                           max_len=len(p) + j)
        gap = abs(float(lg[0, w[j]] - lg[0, g[j]]))
        assert gap <= limit, (i, j, gap)
        diffs.append((i, j, gap))
    return diffs


class _SlowFetch(TS.ContinuousBatcher):
    def _fetch(self, handle):
        time.sleep(0.05)                  # keep streams mid-flight
        return super()._fetch(handle)


class _Stack:
    """One in-process disaggregated deployment of the port: prefill +
    decode tiers + router, with a registry each, torn down in reverse."""

    def __init__(self, tp, cfg=TCFG, *, slots=2, max_len=48, chunk=3,
                 seed=0, decode_batchers=None, max_batch=2,
                 prefill_cls=PrefillServer, **prefill_kw):
        self.regp, self.regd, self.regr = (M.MetricsRegistry(),
                                           M.MetricsRegistry(),
                                           M.MetricsRegistry())
        self.prefill = prefill_cls(tp, cfg, max_len=max_len,
                                   max_batch=max_batch, seed=seed,
                                   registry=self.regp, **prefill_kw)
        if decode_batchers is None:
            decode_batchers = [TS.ContinuousBatcher(
                tp, cfg, batch=slots, max_len=max_len, chunk=chunk,
                seed=seed)]
        self.decodes = [DecodeServer(b, registry=self.regd)
                        for b in decode_batchers]
        self.router = ServingRouter(
            [f"127.0.0.1:{self.prefill.start()}"],
            decode_replicas=[f"127.0.0.1:{d.start()}"
                             for d in self.decodes],
            health_interval_s=0.2, registry=self.regr)
        self.port = self.router.start()

    def close(self):
        self.router.stop()
        self.prefill.stop()
        for d in self.decodes:
            d.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _serve(port, prompts, budget):
    with StreamingClient("127.0.0.1", port) as c:
        rids = [c.submit(p, budget) for p in prompts]
        return [c.result(r, timeout=120) for r in rids]


# ---------------------------------------------------------------------------
# The KV codec: every layout round-trips a real socket and lands as the
# port's colocated admission does
# ---------------------------------------------------------------------------
LAYOUTS = {"f32": {}, "bf16": dict(dtype=torch.bfloat16),
           "int8": dict(kv_cache_dtype="int8"),
           "window": dict(attn_window=8),
           "ring": dict(attn_window=8, kv_cache_capacity=8)}


def _ship_row(tp, cfg, prompt, batch):
    """Prefill ``prompt`` for shipment as the prefill tier does (row 0 of
    a ``batch``-row wave, or the exact-length ring row); returns (bufs,
    logits [V], width, mini)."""
    if cfg.kv_cache_capacity:
        lg, mini = TS.prefill_ship_row(tp, torch.tensor([prompt]), cfg)
        width = mini["k"].shape[2]
    else:
        toks = np.zeros((batch, 16), np.int64)
        toks[0, :len(prompt)] = prompt
        lens = np.ones((batch,), np.int32)
        lens[0] = len(prompt)
        lg, mini = TS.prefill_ship_rows(tp, torch.tensor(toks),
                                        torch.tensor(lens), cfg)
        width = len(prompt)
    return TD.extract_kv_rows(mini, [width])[0], lg[0], width, mini


def _through_socket(blob: bytes) -> bytes:
    a, b = socket.socketpair()
    got = {}
    try:
        t = threading.Thread(target=lambda: got.update(
            frame=P.recv_frame(b, max_bytes=1 << 31)))
        t.start()                     # a blob can exceed the socket buffer
        P.send_frame(a, P.TOKENS, 1, memoryview(blob))
        t.join(timeout=30)
    finally:
        a.close()
        b.close()
    return got["frame"][2]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_socket_round_trip_lands_as_colocated_admission(layout):
    """prefill_ship_rows → extract_kv_rows → pack → a real socket →
    unpack → _validate_package → land_kv_rows into slot 1 of a fresh
    3-slot batcher: the slot's buffers over [0, length), its frontier,
    logits and rng key equal colocated admission's bit for bit."""
    cfg = TCFG.scaled(**LAYOUTS[layout])
    tp = TT.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    prompt, batch, slot = [3, 1, 4, 1, 5], 3, 1
    bufs, lg, width, _ = _ship_row(tp, cfg, prompt, batch)
    key = prng.fold_in(prng.PRNGKey(7), 3).numpy().astype(np.uint32)
    meta = kvship.pack_kv_meta(9, 4, len(prompt), key, rng_off=2)
    blob = kvship.pack_shipment(meta, dict(bufs, logits=lg))
    payload = _through_socket(blob)
    assert payload == blob
    meta2, bufs2 = kvship.unpack_shipment(payload)
    meta2 = kvship.parse_kv_meta(meta2)
    pkg = TS.KVPackage(bufs2, meta2["length"], bufs2.pop("logits"),
                       meta2["rng"], meta2["rng_off"])
    shipped = TS.ContinuousBatcher(tp, cfg, batch=batch, max_len=32)
    shipped._validate_package(pkg, 4)
    shipped._land_group([(slot, 0)], {0: pkg})
    colo = TS.ContinuousBatcher(tp, cfg, batch=batch, max_len=32)
    colo._admit_prompts([(slot, 0)], {0: prompt})
    n = width if cfg.kv_cache_capacity else len(prompt)
    for name in bufs:
        got = shipped.cache[name][:, slot, :n]
        want = colo.cache[name][:, slot, :n]
        assert got.dtype == want.dtype, name
        assert torch.equal(got.view(torch.uint8) if got.dtype ==
                           torch.bfloat16 else got,
                           want.view(torch.uint8) if want.dtype ==
                           torch.bfloat16 else want), name
    assert int(shipped.cache["length"][slot]) == len(prompt) == \
        int(colo.cache["length"][slot])
    assert torch.equal(shipped.logits[slot], colo.logits[slot])
    assert shipped._row_keys[slot].tolist() == [int(k) for k in key]
    assert shipped._row_off[slot] == 2 and shipped._host_len[slot] == 5


def test_int8_ships_quantized_and_linear_caches_ship_true_length():
    """An int8 cache ships int8 values + f32 scales, about half the f32
    layout's bytes; a 5-token prompt in a 16 bucket ships 5 positions."""
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    q = TCFG.scaled(kv_cache_dtype="int8")
    tq = TT.init_params(torch.Generator().manual_seed(0), q, device="cpu")
    tf = TT.init_params(torch.Generator().manual_seed(0), TCFG,
                        device="cpu")
    q_bufs = _ship_row(tq, q, prompt, 2)[0]
    f_bufs, _, width, mini = _ship_row(tf, TCFG, prompt[:5], 2)
    assert q_bufs["k"].dtype == torch.int8
    assert q_bufs["k_scale"].dtype == torch.float32
    nbytes = lambda bs, *ns: sum(bs[n].numel() * bs[n].element_size()
                                 for n in ns)
    f8 = _ship_row(tf, TCFG, prompt, 2)[0]
    assert nbytes(q_bufs, "k") * 4 == nbytes(f8, "k")
    assert nbytes(q_bufs, "k", "v", "k_scale", "v_scale") \
        < 0.6 * nbytes(f8, "k", "v")
    assert width == 5 and f_bufs["k"].shape[2] == 5
    assert mini["k"].shape[2] == 16        # the compute ran padded


def test_malformed_shipments_are_protocol_errors():
    with pytest.raises(P.ProtocolError, match="header"):
        kvship.unpack_shipment(b"\x01")
    with pytest.raises(P.ProtocolError, match="implausible"):
        kvship.unpack_shipment(b"\xff\xff\xff\xff" + b"x" * 32)
    blob = kvship.pack_shipment({"rid": 1}, {"k": np.zeros((2, 2))})
    with pytest.raises(P.ProtocolError, match="truncated"):
        kvship.unpack_shipment(blob[:-8])
    with pytest.raises(P.ProtocolError, match="trailing"):
        kvship.unpack_shipment(blob + b"xx")
    with pytest.raises(P.ProtocolError, match="rng"):
        kvship.parse_kv_meta({"rid": 1, "budget": 2, "length": 3,
                              "rng": [1]})
    head = json.dumps({"v": 1, "meta": {}, "bufs": [
        {"name": "k", "dtype": "nope", "shape": [1]}]}).encode()
    with pytest.raises(P.ProtocolError, match="dtype"):
        kvship.unpack_shipment(struct.pack("<I", len(head)) + head
                               + b"\x00" * 8)
    head = json.dumps({"v": 1, "meta": {"rid": 1}, "bufs": [
        {"name": "k", "dtype": "float32",
         "shape": [1 << 32, 1 << 32]}]}).encode()
    with pytest.raises(P.ProtocolError, match="truncated"):
        kvship.unpack_shipment(struct.pack("<I", len(head)) + head)


def test_malformed_decode_targets_rejected():
    assert P.parse_decode_target({"decode": "10.0.0.1:7072"}) == \
        "10.0.0.1:7072"
    for bad in ("host:abc", "host:", ":7072", "nohost", "h:0", "h:70000",
                "h:7.2", 7072, "", None):
        assert P.parse_decode_target({"decode": bad}) is None, bad


def test_packages_the_batcher_cannot_land_are_refused(pair):
    """_validate_package names the mismatch: vocab (the JAX package's
    message, byte for byte), buffer set, dtype, width past the cache,
    frontier + budget past max_len, frontier past the shipped width."""
    _, _, jp, tp = pair
    b = TS.ContinuousBatcher(tp, TCFG, batch=2, max_len=16)
    bufs, lg, _, _ = _ship_row(tp, TCFG, [3, 1, 4, 1, 5], 2)
    pkg = lambda **kw: TS.KVPackage(**dict(
        dict(bufs=dict(bufs), length=5, logits=lg, rng_key=[0, 0]), **kw))
    jb = JS.ContinuousBatcher(jp, JCFG, batch=2, max_len=16)
    with pytest.raises(ValueError) as te:
        b._validate_package(pkg(logits=np.zeros(7, np.float32)), 4)
    with pytest.raises(ValueError) as je:
        jb._validate_package(JS.KVPackage(
            {n: np.asarray(a) for n, a in bufs.items()}, 5,
            np.zeros(7, np.float32), np.zeros(2, np.uint32)), 4)
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="layout"):
        b._validate_package(pkg(bufs={"k": bufs["k"]}), 4)
    with pytest.raises(ValueError, match="dtype"):
        b._validate_package(pkg(bufs={n: a.double()
                                      for n, a in bufs.items()}), 4)
    with pytest.raises(ValueError, match="max_len"):
        b._validate_package(pkg(), 12)
    with pytest.raises(ValueError, match="exceeds shipped width"):
        b._validate_package(pkg(length=6), 4)
    with pytest.raises(ValueError, match="positive"):
        b._validate_package(pkg(), 0)
    spec = TS.SpeculativeContinuousBatcher(tp, TCFG, tp, TCFG, batch=2,
                                           max_len=16)
    with pytest.raises(NotImplementedError, match="draft-model cache"):
        spec._validate_package(pkg(), 4)


# ---------------------------------------------------------------------------
# A shipment crosses packages
# ---------------------------------------------------------------------------
def _header(blob: bytes) -> bytes:
    return blob[:4 + struct.unpack("<I", blob[:4])[0]]


def _jax_land(jcfg, meta, bufs, lg, batch=3, slot=1):
    """JAX's land_kv_rows of one unpacked shipment into slot ``slot``
    (the JAX tests' staging); returns the landed cache and logits."""
    s_b = bufs["k"].shape[2]
    cache = dict(JD.init_kv_cache(jcfg, batch, 32),
                 length=jnp.zeros((batch,), jnp.int32))
    logits = jnp.zeros((batch, jcfg.vocab_size), jcfg.logits_storage_dtype)
    mini = {n: np.zeros((a.shape[0], batch, s_b) + a.shape[3:], a.dtype)
            for n, a in bufs.items()}
    for n, a in bufs.items():
        mini[n][:, 0:1] = a
    lgs = np.zeros((batch, jcfg.vocab_size), lg.dtype)
    lgs[0] = lg
    kmat = np.zeros((batch, 2), np.uint32)
    kmat[0] = np.asarray(meta["rng"], np.uint32)
    cache, logits, _ = JS.land_kv_rows(
        cache, logits, jnp.asarray([slot, batch, batch + 1], np.int32),
        {n: jnp.asarray(a) for n, a in mini.items()},
        jnp.asarray([meta["length"], 0, 0], np.int32), jnp.asarray(lgs),
        jnp.zeros((batch, 2), jnp.uint32), jnp.asarray(kmat))
    return cache, logits


@pytest.mark.parametrize("layout", ["f32", "bf16"])
def test_shipment_crosses_packages(layout):
    """The same prompt shipped by each package: the KV-row headers
    (meta, buffer names, dtypes, shapes) are byte-identical; the JAX blob
    lands in the port's batcher and the port's blob through JAX's
    land_kv_rows with the blob's bytes intact; in f32 the two packages'
    buffers and logits agree within 1e-5."""
    extra = {} if layout == "f32" else dict(dtype=jnp.bfloat16)
    jcfg = JCFG.scaled(**extra)
    tcfg = TCFG.scaled(**({} if layout == "f32"
                          else dict(dtype=torch.bfloat16)))
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    prompt = [3, 1, 4, 1, 5]
    toks = np.zeros((2, 16), np.int64)
    toks[0, :5] = prompt
    lens = np.asarray([5, 1], np.int32)
    jlg, jmini = JS.prefill_ship_rows(jp, jnp.asarray(toks, jnp.int32),
                                      jnp.asarray(lens), jcfg)
    jbufs = JD.extract_kv_rows(jmini, [5])[0]
    tbufs, tlg, _, _ = _ship_row(tp, tcfg, prompt, 2)
    jkey = np.asarray(jax.random.fold_in(jax.random.PRNGKey(7), 3),
                      np.uint32)
    tkey = prng.fold_in(prng.PRNGKey(7), 3).numpy().astype(np.uint32)
    assert (jkey == tkey).all()
    trace = {"tid": "ab" * 8, "sid": "cd" * 4}
    jmeta = JK.pack_kv_meta(9, 4, 5, jkey, rng_off=2, cls="batch",
                            trace=trace)
    tmeta = kvship.pack_kv_meta(9, 4, 5, tkey, rng_off=2, cls="batch",
                                trace=trace)
    jblob = JK.pack_shipment(jmeta, dict(jbufs, logits=np.asarray(jlg)[0]))
    tblob = kvship.pack_shipment(tmeta, dict(tbufs, logits=tlg))
    assert _header(jblob) == _header(tblob)
    assert len(jblob) == len(tblob)

    # the JAX blob lands in the port's batcher
    m, bufs = kvship.unpack_shipment(jblob)
    m = kvship.parse_kv_meta(m)
    pkg = TS.KVPackage(bufs, m["length"], bufs.pop("logits"), m["rng"],
                       m["rng_off"])
    b = TS.ContinuousBatcher(tp, tcfg, batch=3, max_len=32)
    b._validate_package(pkg, 4)
    b._land_group([(1, 0)], {0: pkg})
    _, jraw = JK.unpack_shipment(jblob)
    for n, a in jbufs.items():
        landed = b.cache[n][:, 1:2, :5].contiguous()
        if landed.dtype == torch.bfloat16:
            landed = landed.view(torch.int16)
        assert landed.numpy().tobytes() == np.asarray(a).tobytes(), n

    # the port's blob lands through JAX's land_kv_rows
    m, bufs = JK.unpack_shipment(tblob)
    m = JK.parse_kv_meta(m)
    lg = bufs.pop("logits")
    cache, logits = _jax_land(jcfg, m, bufs, lg)
    for n, a in bufs.items():
        assert np.asarray(cache[n][:, 1:2, :5]).tobytes() == a.tobytes(), n
    assert np.asarray(logits[1]).tobytes() == lg.tobytes()

    if layout == "f32":
        for n, a in jbufs.items():
            np.testing.assert_allclose(tbufs[n].numpy(), np.asarray(a),
                                       atol=1e-5, rtol=0)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg)[0],
                                   atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# The port's stack against the JAX colocated engine
# ---------------------------------------------------------------------------
def test_greedy_streams_equal_jax_colocated_and_metrics(pair):
    _, _, jp, tp = pair
    prompts = _prompts(0, (5, 3, 7, 4))
    want = JS.ContinuousBatcher(jp, JCFG, batch=2, max_len=48,
                                chunk=3).serve(prompts, 6)
    colo = TS.ContinuousBatcher(tp, TCFG, batch=2, max_len=48,
                                chunk=3).serve(prompts, 6)
    with _Stack(tp) as st:
        outs = _serve(st.port, prompts, 6)
        assert [r for _, r in outs] == ["budget"] * 4
        got = [t for t, _ in outs]
        assert got == colo
        _near_tie_diffs(tp, prompts, got, want)
        assert st.regp.histogram("tony_kv_ship_seconds").count == 4
        assert st.regp.counter("tony_kv_ship_bytes_total").value > 0
        assert st.regp.counter("tony_prefill_requests_total").value == 4
        assert st.regd.histogram("tony_kv_land_seconds").count == 4
        assert st.regr.counter("tony_router_handoffs_total").value == 4
        assert st.regd.gauge("tony_decode_idle_slots").value == 2
        assert st.regp.gauge("tony_prefill_queue_depth").value == 0
        # landing runs no model forward: the decode tier prefilled nothing
        assert st.decodes[0].engine.stats()["prefill_tokens"] == 0
        # the tiers' STATS carry their KV series (an operator's view)
        with StreamingClient("127.0.0.1", st.prefill.port) as c:
            ps = c.stats()["series"]
        with StreamingClient("127.0.0.1", st.decodes[0].port) as c:
            ds = c.stats()
        assert ps["tony_kv_ship_seconds"]["count"] == 4
        assert ps["tony_kv_ship_bytes_total"] == st.regp.counter(
            "tony_kv_ship_bytes_total").value
        assert ps["tony_prefill_requests_total"] == 4
        assert ds["series"]["tony_kv_land_seconds"]["count"] == 4
        assert ds["steps"] == st.decodes[0].batcher.steps_executed > 0
        assert "dispatch" in ds["phases"]


def test_sampled_streams_equal_jax_colocated(pair):
    """The per-request rng stream state rides the shipment."""
    _, _, jp, tp = pair
    prompts = _prompts(1, (5, 3, 7, 4))
    kw = dict(batch=2, max_len=48, chunk=3, **SAMPLED)
    want = JS.ContinuousBatcher(jp, JCFG, **kw).serve(prompts, 6)
    colo = TS.ContinuousBatcher(tp, TCFG, **kw).serve(prompts, 6)
    with _Stack(tp, seed=7, decode_batchers=[
            TS.ContinuousBatcher(tp, TCFG, **kw)]) as st:
        got = [t for t, _ in _serve(st.port, prompts, 6)]
    assert got == colo
    _near_tie_diffs(tp, prompts, got, want)


@pytest.mark.parametrize("layout", ["int8", "ring"])
def test_int8_and_ring_stacks_equal_jax_colocated(layout):
    """int8 ships quantized, a ring ships its whole capacity; both serve
    the JAX colocated engine's streams."""
    extra = (dict(kv_cache_dtype="int8") if layout == "int8"
             else dict(attn_window=8, kv_cache_capacity=8))
    jcfg, tcfg, jp, tp = _pair(**extra)
    prompts = _prompts(6, (5, 3))
    want = JS.ContinuousBatcher(jp, jcfg, batch=2, max_len=32,
                                chunk=3).serve(prompts, 4)
    colo = TS.ContinuousBatcher(tp, tcfg, batch=2, max_len=32,
                                chunk=3).serve(prompts, 4)
    with _Stack(tp, tcfg, max_len=32, decode_batchers=[
            TS.ContinuousBatcher(tp, tcfg, batch=2, max_len=32,
                                 chunk=3)]) as st:
        got = [t for t, _ in _serve(st.port, prompts, 4)]
    assert got == colo
    _near_tie_diffs(tp, prompts, got, want, cfg=tcfg)


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_jax_prefill_tier_feeds_port_decode_tier(pair, mode):
    _, _, jp, tp = pair
    kw = dict(batch=2, max_len=48, chunk=3, **(SAMPLED if mode == "sampled"
                                               else {}))
    prompts = _prompts(2, (5, 3, 7, 4))
    want = JS.ContinuousBatcher(jp, JCFG, **kw).serve(prompts, 6)
    pre = JDG.PrefillServer(jp, JCFG, max_len=48, max_batch=2,
                            seed=kw.get("seed", 0),
                            registry=JM.MetricsRegistry())
    dec = DecodeServer(TS.ContinuousBatcher(tp, TCFG, **kw),
                       registry=M.MetricsRegistry())
    router = ServingRouter([f"127.0.0.1:{pre.start()}"],
                           decode_replicas=[f"127.0.0.1:{dec.start()}"],
                           registry=M.MetricsRegistry())
    try:
        got = [t for t, _ in _serve(router.start(), prompts, 6)]
    finally:
        router.stop()
        pre.stop()
        dec.stop()
    _near_tie_diffs(tp, prompts, got, want)


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_port_prefill_tier_feeds_jax_decode_tier(pair, mode):
    _, _, jp, tp = pair
    kw = dict(batch=2, max_len=48, chunk=3, **(SAMPLED if mode == "sampled"
                                               else {}))
    prompts = _prompts(3, (5, 3, 7, 4))
    want = JS.ContinuousBatcher(jp, JCFG, **kw).serve(prompts, 6)
    pre = PrefillServer(tp, TCFG, max_len=48, max_batch=2,
                        seed=kw.get("seed", 0), registry=M.MetricsRegistry())
    dec = JDG.DecodeServer(JS.ContinuousBatcher(jp, JCFG, **kw),
                           registry=JM.MetricsRegistry())
    router = JR.ServingRouter([f"127.0.0.1:{pre.start()}"],
                              decode_replicas=[f"127.0.0.1:{dec.start()}"],
                              registry=JM.MetricsRegistry())
    try:
        got = [t for t, _ in _serve(router.start(), prompts, 6)]
    finally:
        router.stop()
        pre.stop()
        dec.stop()
    _near_tie_diffs(tp, prompts, got, want)


def test_prefix_ship_rows_matches_jax(pair):
    """The prefill tier's prefix fast path: K suffixes against a resident
    template, the same rows and logits as the JAX package's (1e-5 on the
    K/V over each row's prefix + suffix, 1e-4 on the logits)."""
    _, _, jp, tp = pair
    prefix = _prompts(20, (9,))[0]
    sfx = _prompts(21, (3, 5))
    toks = np.zeros((2, 16), np.int64)
    lens = np.asarray([len(x) for x in sfx], np.int32)
    for i, x in enumerate(sfx):
        toks[i, :len(x)] = x
    jt = JS.prefix_template(jp, jnp.asarray(prefix, jnp.int32), JCFG)
    jlg, jmini = JS.prefix_ship_rows(jp, jt, jnp.asarray(toks, jnp.int32),
                                     jnp.asarray(lens), JCFG)
    tt = TS.prefix_template(tp, prefix, TCFG)
    tlg, tmini = TS.prefix_ship_rows(tp, tt, torch.tensor(toks),
                                     torch.tensor(lens), TCFG)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=1e-4,
                               rtol=0)
    widths = [len(prefix) + n for n in lens]
    for got, want in zip(TD.extract_kv_rows(tmini, widths),
                         JD.extract_kv_rows(jmini, widths)):
        for n in want:
            np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                       atol=1e-5, rtol=0)


def test_prefix_resident_at_the_prefill_tier(pair):
    """A prefill tier with the prefix resident runs only the suffixes and
    ships prefix + suffix rows; the decode tier needs no prefix, and the
    streams equal the colocated prefix-blind serve (near-tie rule)."""
    _, _, _, tp = pair
    prefix = _prompts(22, (12,))[0]
    prompts = [prefix + x for x in _prompts(23, (3, 5, 4, 6))]
    want = TS.ContinuousBatcher(tp, TCFG, batch=2, max_len=48,
                                chunk=3).serve(prompts, 6)
    with _Stack(tp) as st:
        pid = st.prefill.install_prefix(prefix)
        assert st.prefill.resident_prefixes() == [pid]
        got = [t for t, _ in _serve(st.port, prompts, 6)]
        assert st.regp.counter(
            "tony_prefill_prefix_tokens_total").value == 12 * 4
        assert st.regp.counter(
            "tony_prefill_forward_tokens_total").value == 3 + 5 + 4 + 6
    _near_tie_diffs(tp, prompts, got, want)


def test_speculative_prefix_and_role_mismatch_are_refused(pair):
    _, _, _, tp = pair
    spec = TS.SpeculativeContinuousBatcher(tp, TCFG, tp, TCFG, batch=2,
                                           max_len=32)
    with pytest.raises(ValueError, match="draft-model cache"):
        DecodeServer(spec)
    pref = TS.ContinuousBatcher(tp, TCFG, batch=2, max_len=32,
                                shared_prefix=[1, 2])
    with pytest.raises(ValueError, match="colocated"):
        DecodeServer(pref)
    from tony_tpu_torch.serving.server import ServingServer
    srv = ServingServer(TS.ContinuousBatcher(tp, TCFG, batch=1, max_len=32),
                        registry=M.MetricsRegistry())
    dec = DecodeServer(TS.ContinuousBatcher(tp, TCFG, batch=1, max_len=32),
                       registry=M.MetricsRegistry())
    router = ServingRouter([f"127.0.0.1:{srv.start()}"],
                           decode_replicas=[f"127.0.0.1:{dec.start()}"],
                           registry=M.MetricsRegistry())
    try:
        with pytest.raises(ConnectionError, match="role"):
            router.start()
    finally:
        router.stop()
        srv.stop()
        dec.stop()


def test_decode_tier_refuses_prompts(pair):
    _, _, _, tp = pair
    dec = DecodeServer(TS.ContinuousBatcher(tp, TCFG, batch=1, max_len=32),
                       registry=M.MetricsRegistry())
    port = dec.start()
    try:
        with StreamingClient("127.0.0.1", port) as c:
            assert c.hello["role"] == "decode"
            assert c.hello["channel_port"] == dec.hub.port
            ev = c.next_event(c.submit([1, 2, 3], 4), timeout=30)
            assert ev[0] == "error" and "prefill tier" in ev[1]
    finally:
        dec.stop()


def test_kv_ship_span_parents_the_decode_request():
    """client.request roots the trace; the prefill tier's engine.request
    (role=prefill) parents kv.ship; the decode tier's engine.request
    (prefilled) parents under the prefill tier's — one trace id."""
    _, _, _, tp = _pair()
    tr = tracing.Tracer(proc="test:disagg", sample_rate=1.0, ring_size=512)
    saved = tracing.set_tracer(tr)
    try:
        with _Stack(tp) as st:
            _serve(st.port, _prompts(2, (5,)), 4)
    finally:
        tracing.set_tracer(saved)
    spans = {s["sid"]: s for s in tr.recent()}
    roots = [s for s in spans.values() if s["n"] == "client.request"]
    assert roots, sorted({s["n"] for s in spans.values()})
    trace = [s for s in spans.values() if s["tid"] == roots[0]["tid"]]
    names = {s["n"] for s in trace}
    assert {"client.request", "router.place", "engine.request", "kv.ship",
            "engine.first_token"} <= names, names
    ship = next(s for s in trace if s["n"] == "kv.ship")
    pre_req = spans[ship["pid"]]
    assert pre_req["n"] == "engine.request"
    assert pre_req["a"].get("role") == "prefill"
    dec_reqs = [s for s in trace if s["n"] == "engine.request"
                and s["a"].get("prefilled")]
    assert dec_reqs and dec_reqs[0]["pid"] == pre_req["sid"]


def test_metric_series_are_the_jax_packages(pair):
    """Each tier registers the JAX tier's series: names and kinds (but
    the compile-cache artifacts' counter: the port ships no compile
    cache, ROADMAP queue 1 item 8)."""
    jp = pair[2]
    tp = pair[3]
    kinds = lambda reg: {n: km[0] for n, km in reg.to_wire()["m"].items()
                         if not n.startswith("tony_compile_cache")}
    jr, tr = JM.MetricsRegistry(), M.MetricsRegistry()
    JDG.PrefillServer(jp, JCFG, max_len=32, registry=jr)
    PrefillServer(tp, TCFG, max_len=32, registry=tr)
    assert kinds(tr) == kinds(jr)
    jr, tr = JM.MetricsRegistry(), M.MetricsRegistry()
    JDG.DecodeServer(JS.ContinuousBatcher(jp, JCFG, batch=1, max_len=32),
                     registry=jr)
    DecodeServer(TS.ContinuousBatcher(tp, TCFG, batch=1, max_len=32),
                 registry=tr)
    want = kinds(jr)
    for n in ("tony_kv_land_seconds", "tony_decode_idle_slots"):
        assert kinds(tr)[n] == want[n]
    assert set(want) <= set(kinds(tr)), set(want) - set(kinds(tr))
    jr, tr = JM.MetricsRegistry(), M.MetricsRegistry()
    JR.ServingRouter(["127.0.0.1:1"], registry=jr)
    ServingRouter(["127.0.0.1:1"], registry=tr)
    assert kinds(tr) == kinds(jr)


# ---------------------------------------------------------------------------
# Failover and drain across the split
# ---------------------------------------------------------------------------
def _start_streams(c, prompts, budget):
    rids = [c.submit(p, budget) for p in prompts]
    got = {r: [] for r in rids}
    started = set()
    deadline = time.time() + 90
    while len(started) < len(rids) and time.time() < deadline:
        for r in rids:
            if r in started:
                continue
            try:
                ev = c.next_event(r, timeout=0.05)
            except Exception:
                continue
            assert ev[0] == "tokens", ev
            got[r].extend(ev[1])
            started.add(r)
    assert len(started) == len(rids), "streams never started"
    return rids, got


def _collect(c, rids, got):
    for r in rids:
        while True:
            ev = c.next_event(r, timeout=90)
            if ev[0] == "tokens":
                got[r].extend(ev[1])
            elif ev[0] == "retired":
                break
            else:
                raise AssertionError(ev)


def test_decode_loss_no_dup_no_drop(pair):
    """Kill a decode replica mid-stream: every stream it carried
    completes with exactly its reference tokens, re-prefilled through
    the prefill tier onto the survivor with the streamed prefix folded
    into the prompt."""
    _, _, _, tp = pair
    batchers = [_SlowFetch(tp, TCFG, batch=2, max_len=64, chunk=2)
                for _ in range(2)]
    prompts = _prompts(4, (5, 5, 5, 5))
    budget = 36                        # streams outlive a loaded host
    with _Stack(tp, max_len=64, decode_batchers=batchers) as st:
        with StreamingClient("127.0.0.1", st.port) as c:
            rids, got = _start_streams(c, prompts, budget)
            actives = [d.engine.stats()["active"] for d in st.decodes]
            assert all(a > 0 for a in actives), actives
            st.decodes[0].kill()
            _collect(c, rids, got)
            for i, r in enumerate(rids):
                assert got[r] == _reference(tp, prompts[i], budget), i
        assert st.regr.counter("tony_router_failovers_total").value >= 1
        assert st.regr.counter(
            "tony_router_handoffs_total").value >= len(rids)


def test_kv_ship_failure_fails_over_not_errors(pair):
    """A decode tier's CHANNEL endpoint dies while its serving link
    stays up: the ship fails RETRYABLE, the router re-places the session
    on the other decode replica, the client sees its tokens, and the old
    rrid is tombstoned on the unreachable tier."""
    _, _, _, tp = pair
    batchers = [TS.ContinuousBatcher(tp, TCFG, batch=2, max_len=48,
                                     chunk=3) for _ in range(2)]
    with _Stack(tp, decode_batchers=batchers, ship_timeout_s=1.0) as st:
        st.decodes[0].hub.stop()
        p = _prompts(11, (5,))[0]
        with StreamingClient("127.0.0.1", st.port) as c:
            toks, reason = c.result(c.submit(p, 6), timeout=60)
        assert toks == _reference(tp, p, 6) and reason == "budget"
        assert st.regr.counter("tony_router_failovers_total").value >= 1
        deadline = time.time() + 15
        while not st.decodes[0]._tombstones and time.time() < deadline:
            time.sleep(0.01)
        assert st.decodes[0]._tombstones


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_decode_drain_zero_dup_drop(pair, mode):
    """A planned decode drain: the router fences the replica and
    re-prefills each of its sessions onto the survivor (streamed prefix
    folded in, rng stream and offset pinned); the old placement streams
    until the new one ACKs — nothing duplicated or dropped."""
    _, _, _, tp = pair
    kw = dict(batch=4, max_len=64, chunk=2,
              **(SAMPLED if mode == "sampled" else {}))
    prompts = _prompts(44, (5, 5, 4, 6))
    budget = 40                        # streams outlive a loaded host
    ref = TS.ContinuousBatcher(tp, TCFG, **kw).serve(prompts, budget)
    batchers = [_SlowFetch(tp, TCFG, **kw) for _ in range(2)]
    with _Stack(tp, max_len=64, seed=kw.get("seed", 0),
                decode_batchers=batchers) as st:
        with StreamingClient("127.0.0.1", st.port) as c:
            rids, got = _start_streams(c, prompts, budget)
            reps = st.router.stats()["replicas"]
            decode = {a: v for a, v in reps.items()
                      if v["role"] == "decode"}
            assert all(v["assigned"] > 0 for v in decode.values())
            victim = max(decode, key=lambda a: decode[a]["assigned"])
            res = c.drain_replica(victim)
            assert res.get("drained") and res["migrated"] >= 1, res
            _collect(c, rids, got)
            for i, r in enumerate(rids):
                assert got[r] == ref[i], f"stream {i}: dup/drop"
            post = st.router.stats()["replicas"]
            assert post[victim]["draining"]
            assert post[victim]["assigned"] == 0
        assert st.regr.counter("tony_router_failovers_total").value == 0
        assert st.regr.counter("tony_router_drains_total").value == 1


def test_preempted_package_retires_and_the_router_replaces_it(pair):
    """An interactive admission on a full decode tier evicts a batch
    package: it has no prompt to fold, so it retires ``"preempted"``
    and the router re-places it through the prefill tier — the client
    still gets its exact tokens, one terminal frame."""
    _, _, _, tp = pair
    kw = dict(batch=1, max_len=64, chunk=2)
    prompts = _prompts(45, (5, 4))
    with _Stack(tp, max_len=64, max_batch=1, decode_batchers=[
            _SlowFetch(tp, TCFG, **kw)]) as st:
        with StreamingClient("127.0.0.1", st.port) as c:
            rb = c.submit(prompts[0], 24, request_class="batch")
            ev = c.next_event(rb, timeout=60)
            assert ev[0] == "tokens"
            got = list(ev[1])
            ri = c.submit(prompts[1], 4, request_class="interactive")
            toks_i, reason_i = c.result(ri, timeout=90)
            _collect(c, [rb], {rb: got})
        assert toks_i == _reference(tp, prompts[1], 4)
        assert got == _reference(tp, prompts[0], 24)
        assert st.decodes[0].engine.stats()["preemptions"] >= 1
        assert st.regr.counter(
            "tony_router_preempt_requeues_total").value >= 1


# ---------------------------------------------------------------------------
# Cancels across the split: one terminal frame wherever a CANCEL lands
# ---------------------------------------------------------------------------
class _GatedPrefill(PrefillServer):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.gate = threading.Event()

    def _prefill_group(self, grp, bucket, entry=None):
        self.gate.wait(timeout=60)
        super()._prefill_group(grp, bucket, entry)


class _BoomWavePrefill(PrefillServer):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.take_gate = threading.Event()
        self.in_wave = threading.Event()
        self.resume = threading.Event()
        self._boomed = False

    def _take_wave(self):
        self.take_gate.wait(timeout=60)
        return super()._take_wave()

    def _prefill_group(self, grp, bucket, entry=None):
        if not self._boomed:
            self._boomed = True
            self.in_wave.set()
            self.resume.wait(timeout=60)
            raise RuntimeError("injected wave failure")
        super()._prefill_group(grp, bucket, entry)


def _package_blob(tp, rid, budget, prompt=(3, 1, 4, 1, 5), logits_len=None):
    bufs, lg, _, _ = _ship_row(tp, TCFG, list(prompt), 2)
    key = prng.fold_in(prng.PRNGKey(0), 0).numpy().astype(np.uint32)
    meta = kvship.pack_kv_meta(rid, budget, len(prompt), key)
    if logits_len is not None:
        lg = np.zeros((logits_len,), np.float32)
    return kvship.pack_shipment(meta, dict(bufs, logits=lg))


def _sink(port):
    sock = socket.create_connection(("127.0.0.1", port), timeout=10)
    sock.sendall(P.MAGIC)
    assert P.recv_frame(sock)[0] == P.HELLO
    P.send_frame(sock, P.BIND, 0)          # we are the delta sink
    return sock


def test_cancel_queued_and_mid_wave_both_retire(pair):
    _, _, _, tp = pair
    with _Stack(tp, max_batch=1, prefill_cls=_GatedPrefill) as st:
        with StreamingClient("127.0.0.1", st.port) as c:
            ra = c.submit(_prompts(7, (5,))[0], 6)
            deadline = time.time() + 30
            while (st.prefill.stats()["active"] != 1
                   and time.time() < deadline):
                time.sleep(0.01)
            assert st.prefill.stats()["active"] == 1      # A mid-wave
            rb = c.submit(_prompts(8, (4,))[0], 6)
            while (st.prefill.stats()["queue_depth"] != 1
                   and time.time() < deadline):
                time.sleep(0.01)
            c.cancel(rb)                                  # still queued
            assert c.result(rb, timeout=30) == ([], "cancelled")
            c.cancel(ra)                                  # mid-wave
            while st.prefill._items and time.time() < deadline:
                time.sleep(0.01)
            st.prefill.gate.set()
            assert c.result(ra, timeout=30) == ([], "cancelled")
            assert st.regp.counter(
                "tony_prefill_requests_total").value == 0  # no ship
            p = _prompts(9, (5,))[0]
            assert c.result(c.submit(p, 4), timeout=60) == (
                _reference(tp, p, 4), "budget")
        assert not st.router._sessions and not st.router._by_rrid


def test_wave_failure_settles_a_mid_wave_cancel(pair):
    _, _, _, tp = pair
    with _Stack(tp, max_batch=2, prefill_cls=_BoomWavePrefill) as st:
        with StreamingClient("127.0.0.1", st.port) as c:
            pa, pb = _prompts(11, (5, 5))
            ra, rb = c.submit(pa, 4), c.submit(pb, 4)
            deadline = time.time() + 30
            while (st.prefill.stats()["queue_depth"] != 2
                   and time.time() < deadline):
                time.sleep(0.01)
            assert st.prefill.stats()["queue_depth"] == 2
            st.prefill.take_gate.set()
            assert st.prefill.in_wave.wait(timeout=30)
            c.cancel(rb)
            while len(st.prefill._items) > 1 and time.time() < deadline:
                time.sleep(0.01)
            assert len(st.prefill._items) == 1
            st.prefill.resume.set()                       # the wave dies
            assert c.result(rb, timeout=30) == ([], "cancelled")
            with pytest.raises(ServingConnectionError):
                c.result(ra, timeout=30)
            p = _prompts(12, (5,))[0]
            assert c.result(c.submit(p, 4), timeout=60) == (
                _reference(tp, p, 4), "budget")
        assert not st.router._sessions and not st.router._by_rrid


def test_tombstone_drop_and_bad_shipments_cost_only_themselves(pair):
    """Over a raw sink link: a package cancelled before arrival is
    dropped with its RETIRED pushed; a malformed shipment is dropped and
    the lander lives; a vocab-mismatched one gets a request-scoped
    ERROR; a healthy package then streams."""
    _, _, _, tp = pair
    dec = DecodeServer(TS.ContinuousBatcher(tp, TCFG, batch=1, max_len=32,
                                            chunk=2),
                       registry=M.MetricsRegistry())
    port = dec.start()
    sender = sock = None
    try:
        sock = _sink(port)
        P.send_frame(sock, P.CANCEL, 7)                  # tombstone rid 7
        deadline = time.time() + 15
        while 7 not in dec._tombstones and time.time() < deadline:
            time.sleep(0.01)
        assert 7 in dec._tombstones
        sender = ChannelSender(f"127.0.0.1:{dec.hub.port}", "kvship",
                               registry=M.MetricsRegistry())
        sender.send_bytes(_package_blob(tp, 7, 4), sync=True, timeout=30)
        fr = P.recv_frame(sock)
        assert fr[0] == P.RETIRED and fr[1] == 7, fr
        assert P.unpack_json(fr[2])["reason"] == "cancelled"
        head = json.dumps({"v": 1, "meta": {"rid": 9}, "bufs": [
            {"name": "k", "dtype": "float32",
             "shape": [1 << 32, 1 << 32]}]}).encode("utf-8")
        sender.send_bytes(struct.pack("<I", len(head)) + head, sync=True,
                          timeout=30)
        sender.send_bytes(_package_blob(tp, 11, 3, logits_len=7),
                          sync=True, timeout=30)
        fr = P.recv_frame(sock)
        assert fr[0] == P.ERROR and fr[1] == 11, fr
        assert "logits" in P.unpack_json(fr[2])["message"]
        sender.send_bytes(_package_blob(tp, 8, 3), sync=True, timeout=30)
        got = []
        while True:
            fr = P.recv_frame(sock)
            assert fr is not None and fr[1] == 8, fr
            if fr[0] == P.TOKENS:
                got.extend(P.unpack_tokens(fr[2]))
            elif fr[0] == P.RETIRED:
                assert P.unpack_json(fr[2])["reason"] == "budget"
                break
        assert got == _reference(tp, [3, 1, 4, 1, 5], 3)
    finally:
        if sender is not None:
            sender.close(drain=False)
        if sock is not None:
            sock.close()
        dec.stop()


def test_cancel_racing_the_landing_still_cancels(pair):
    _, _, _, tp = pair
    dec = DecodeServer(TS.ContinuousBatcher(tp, TCFG, batch=1, max_len=48,
                                            chunk=2),
                       registry=M.MetricsRegistry())
    port = dec.start()
    real_submit = dec.engine.submit_prefilled

    def racing_submit(rid, pkg, budget, trace_ctx=None, **kw):
        real_submit(rid, pkg, budget, trace_ctx=trace_ctx, **kw)
        with dec._lock:                  # the CANCEL lands mid-submit
            dec._tombstones[rid] = True

    dec.engine.submit_prefilled = racing_submit
    sender = sock = None
    try:
        sock = _sink(port)
        sender = ChannelSender(f"127.0.0.1:{dec.hub.port}", "kvship",
                               registry=M.MetricsRegistry())
        sender.send_bytes(_package_blob(tp, 5, 30), sync=True, timeout=30)
        while True:
            fr = P.recv_frame(sock)
            assert fr is not None and fr[1] == 5, fr
            if fr[0] == P.RETIRED:
                assert P.unpack_json(fr[2])["reason"] == "cancelled"
                break
            assert fr[0] == P.TOKENS
        assert not dec._tombstones
    finally:
        if sender is not None:
            sender.close(drain=False)
        if sock is not None:
            sock.close()
        dec.stop()


def test_sink_loss_frees_every_adopted_slot(pair):
    _, _, _, tp = pair
    dec = DecodeServer(TS.ContinuousBatcher(tp, TCFG, batch=2, max_len=64,
                                            chunk=2),
                       registry=M.MetricsRegistry())
    port = dec.start()
    sender = None
    sock = _sink(port)
    try:
        sender = ChannelSender(f"127.0.0.1:{dec.hub.port}", "kvship",
                               registry=M.MetricsRegistry())
        sender.send_bytes(_package_blob(tp, 3, 50), sync=True, timeout=30)
        deadline = time.time() + 60
        while (dec.engine.stats()["active"] != 1
               and time.time() < deadline):
            time.sleep(0.02)
        assert dec.engine.stats()["active"] == 1
        sock.close()                       # the sink dies mid-stream
        while (dec.engine.stats()["active"] != 0
               and time.time() < deadline):
            time.sleep(0.02)
        assert dec.engine.stats()["active"] == 0
    finally:
        if sender is not None:
            sender.close(drain=False)
        dec.stop()


@pytest.mark.cuda
def test_card_stack_launches_no_k1_at_the_decode_tier():
    """On the card (``tiny`` bf16): the stack's streams equal the
    colocated batcher's, K1 ran n_layers times per prefill wave — all of
    them at the prefill tier, none at the decode tier, whose admissions
    land copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from tony_tpu_torch.ops import attention as A
    cfg = TCFG.scaled(dtype=torch.bfloat16)
    tp = TT.init_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    prompts = _prompts(5, (5, 3, 7, 4))
    want = TS.ContinuousBatcher(tp, cfg, batch=2, max_len=48,
                                chunk=3).serve(prompts, 6)
    with _Stack(tp, cfg) as st:
        A.reset_launches()
        TS.CALL_COUNTS.clear()
        got = [t for t, _ in _serve(st.port, prompts, 6)]
        torch.cuda.synchronize()
        waves = sum(c for (n, _), c in TS.CALL_COUNTS.items()
                    if n == "prefill_ship_rows")
        assert A.flash_forward.launches == cfg.n_layers * waves > 0
        assert not any(n in ("admit_rows", "admit_row")
                       for n, _ in TS.CALL_COUNTS)
    assert got == want


# ---------------------------------------------------------------------------
# serve_lm's tiers and router as processes
# ---------------------------------------------------------------------------
def _serve_lm(*args):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return subprocess.Popen(
        [sys.executable, "-m", "tony_tpu_torch.serve_lm", *args], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _addr_of(proc, pattern):
    lines = []
    while True:
        line = proc.stdout.readline()
        if not line:
            raise AssertionError("serve_lm exited: " + "".join(lines))
        lines.append(line)
        m = re.search(pattern, line)
        if m:
            return m.group(1)


def test_serve_lm_tiers_and_router_as_processes():
    """``--role prefill`` and ``--role decode`` (sampled, on the CPU)
    behind a ``--listen --route --route_decode`` router, three
    processes: the streams are the in-process colocated batcher's."""
    cfg, tp = serve_lm.build("tiny", "cpu")
    prompts, budgets = serve_lm.make_workload(0, 4, 16, 32, cfg.vocab_size)
    sampling = ["--temperature", "0.8", "--top_k", "20", "--top_p", "0.9"]
    want = TS.ContinuousBatcher(tp, cfg, batch=2, max_len=48, seed=0,
                                temperature=0.8, top_k=20,
                                top_p=0.9).serve(prompts, budgets)
    tier = ["--device", "cpu", "--preset", "tiny", "--slots", "2",
            "--listen", "127.0.0.1:0", *sampling]
    procs = [_serve_lm(*tier, "--role", "prefill"),
             _serve_lm(*tier, "--role", "decode")]
    try:
        pre = _addr_of(procs[0], r"prefill tier \(tiny\) on "
                                 r"(127\.0\.0\.1:\d+) \(2-row waves\)")
        dec = _addr_of(procs[1], r"decode tier \(tiny, sampled\) on "
                                 r"(127\.0\.0\.1:\d+) with 2 slots")
        procs.append(_serve_lm("--listen", "127.0.0.1:0", "--route", pre,
                               "--route_decode", dec))
        host, port = _addr_of(
            procs[2], r"routing on (127\.0\.0\.1:\d+) over 1 prefill \+ "
                      r"1 decode replicas").split(":")
        with StreamingClient(host, int(port)) as c:
            rids = [c.submit(p, n) for p, n in zip(prompts, budgets)]
            got = [c.result(r, timeout=120) for r in rids]
        assert [t for t, _ in got] == want
        assert {r for _, r in got} == {"budget"}
    finally:
        for p in reversed(procs):
            p.send_signal(signal.SIGTERM)
        rest = [p.communicate(timeout=120)[0] for p in reversed(procs)]
    assert [p.returncode for p in procs] == [0, 0, 0], rest
