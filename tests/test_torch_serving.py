"""tony_tpu_torch's serving host: the TONYS1 server and client, against
the JAX package's.

``tiny`` f32 with the JAX parameters converted to torch. Covered:

- the protocol copy: byte-identical frames and the same constants;
- the open-loop engine's contract (incremental submission equals the
  closed batch, deltas before retirement, cancel waiting and in flight,
  the queue-depth gauge, stop, validation);
- the server end to end and every rule of the robustness contract of
  ``tony_tpu/serving/server.py`` (malformed or truncated frame →
  connection-scoped ERROR and close, the server keeps serving; an
  un-servable or duplicate ADMIT → request-scoped ERROR; a disconnect
  cancels the client's requests and their slots readmit; CANCEL is
  idempotent; ``stop(drain=True)`` finishes in-flight requests;
  ``kill()`` severs clients at once), plus the PREFIX / WEIGHTS lanes
  answering their ops on one advertised hub port;
- QoS on the wire: a classless ADMIT lands ``standard``, an unknown
  class is request-scoped, BUSY surfaces as ``ServerBusy`` and a retry
  budget recovers;
- wire compatibility both ways: the JAX ``StreamingClient`` against the
  port's server and the port's client against the JAX server stream the
  same greedy (and sampled) tokens; HELLO carries every key the JAX
  server's does, and its ``weights_digest`` equals the JAX
  ``tree_digest`` of the same weights.

Tokens are compared exactly (tolerance 0) with the port's own
``generate`` and with the JAX package's.
"""

import queue
import socket
import struct
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import serve as JS
from tony_tpu.models import transformer as JT
from tony_tpu.serving import client as JC
from tony_tpu.serving import protocol as JP
from tony_tpu.serving import server as JSRV
from tony_tpu.serving.weightstore import tree_digest as jax_tree_digest
from tony_tpu_torch.models import decode as TD
from tony_tpu_torch.models import serve as TS
from tony_tpu_torch.models import transformer as TT
from tony_tpu_torch.models.weights import params_from_numpy
from tony_tpu_torch.runtime import metrics as M
from tony_tpu_torch.serving import protocol as P
from tony_tpu_torch.serving.client import (ServerBusy,
                                           ServingConnectionError,
                                           StreamingClient)
from tony_tpu_torch.serving.server import ServingServer
from tony_tpu_torch.serving.weightstore import tree_digest

torch.set_num_threads(2)

JCFG = JT.PRESETS["tiny"].scaled(dtype=jnp.float32, remat=False)
TCFG = TT.PRESETS["tiny"].scaled(dtype=torch.float32, remat=False)


@pytest.fixture(scope="module")
def params():
    jp = JT.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_numpy(jax.device_get(jp), device="cpu")


@pytest.fixture(scope="module")
def tp(params):
    return params[1]


def _reference(tp, prompt, max_new):
    out = TD.generate(tp, torch.tensor([prompt]), TCFG, max_new)
    return out.tokens[0, len(prompt):].tolist()


def _prompts(seed, sizes):
    rs = np.random.RandomState(seed)
    return [[int(t) for t in rs.randint(0, 1024, size=n)] for n in sizes]


def _batcher(tp, cls=TS.ContinuousBatcher, **kw):
    kw.setdefault("batch", 2)
    kw.setdefault("max_len", 32)
    kw.setdefault("chunk", 3)
    return cls(tp, TCFG, **kw)


class _SlowFetch(TS.ContinuousBatcher):
    def _fetch(self, handle):
        time.sleep(0.05)
        return super()._fetch(handle)


class _EngineHarness:
    def __init__(self, batcher, registry=None):
        self.got: dict = {}
        self.retired: dict = {}

        def on_retired(rid, reason, n, final):
            self.got.setdefault(rid, []).extend(final)
            self.retired.setdefault(rid, (reason, n))

        self.engine = TS.ServeEngine(
            batcher,
            on_delta=lambda rid, t: self.got.setdefault(rid, []).extend(t),
            on_retired=on_retired, registry=registry or M.MetricsRegistry())
        self.thread = threading.Thread(target=self.engine.run, daemon=True)
        self.thread.start()

    def finish(self, timeout=120):
        self.engine.drain()
        self.thread.join(timeout=timeout)
        assert not self.thread.is_alive(), "engine did not drain"


# --- the protocol copy --------------------------------------------------

def test_protocol_copy_is_byte_identical():
    for name in ("MAGIC", "ADMIT", "CANCEL", "POLL", "TOKENS", "RETIRED",
                 "ERROR", "STATS", "HELLO", "PREFIX", "WEIGHTS", "BUSY",
                 "QOS_CLASSES", "MAX_FRAME_BYTES"):
        assert getattr(P, name) == getattr(JP, name), name
    body = {"prompt": [1, 2, 3], "max_new_tokens": 4, "stream": True,
            "class": "batch", "rng": {"stream": 5, "off": 2}}
    for ftype, rid, payload in ((P.ADMIT, 7, P.pack_json(body)),
                                (P.TOKENS, 2**40, P.pack_tokens([1, 9])),
                                (P.CANCEL, 3, b"")):
        assert P.encode_frame(ftype, rid, payload) == \
            JP.encode_frame(ftype, rid, payload)
    assert P.parse_admit(P.pack_json(body)) == ([1, 2, 3], 4, True)
    assert P.parse_rng(body) == (5, 2) and P.parse_class(body) == "batch"


def test_serving_keys_equal_the_jax_package_keys():
    from tony_tpu.conf import keys as JK
    from tony_tpu_torch.conf import keys as TK
    names = [n for n in dir(TK) if n.endswith("_KEY")]
    assert len(names) == 8
    defaults = dict(TK.SERVE_DEFAULTS, **TK.ROUTER_DEFAULTS)
    for n in names:
        assert getattr(TK, n) == getattr(JK, n), n
        assert defaults[getattr(TK, n)] == JK.DEFAULTS[getattr(JK, n)]
    assert set(defaults) == {getattr(TK, n) for n in names}
    assert not set(TK.SERVE_DEFAULTS) & set(TK.ROUTER_DEFAULTS)


def test_engine_defaults_are_the_serving_keys_defaults(tp):
    """The QoS knobs a replica runs with when nothing sets them (serve_lm
    builds its ServingServer with the defaults, as the JAX script does)
    are the JAX package's key defaults."""
    from tony_tpu_torch.conf import keys as TK
    from tony_tpu_torch.serving.server import ServingServer
    server = ServingServer(_batcher(tp), port=0,
                           registry=M.MetricsRegistry())
    eng = server.engine
    assert eng._max_queue_depth == int(
        TK.SERVE_DEFAULTS[TK.SERVE_MAX_QUEUE_DEPTH_KEY])
    assert eng._busy_retry_ms == int(
        TK.SERVE_DEFAULTS[TK.SERVE_BUSY_RETRY_MS_KEY])
    assert eng.stats()["class_floors"] == {
        "interactive": int(TK.SERVE_DEFAULTS[TK.SERVE_SLOTS_INTERACTIVE_KEY]),
        "standard": int(TK.SERVE_DEFAULTS[TK.SERVE_SLOTS_STANDARD_KEY]),
        "batch": int(TK.SERVE_DEFAULTS[TK.SERVE_SLOTS_BATCH_KEY])}
    assert TK.SERVE_DEFAULTS[TK.METRICS_LATENCY_BUCKETS_KEY] == ""
    assert eng._ttft_h.buckets == M.TIME_BUCKETS_S


# --- the open-loop engine -----------------------------------------------

def test_incremental_submission_matches_closed_batch(tp):
    prompts = _prompts(0, (5, 3, 7, 4))
    closed = _batcher(tp).serve(prompts, 6)
    h = _EngineHarness(_batcher(tp))
    h.engine.submit(0, prompts[0], 6)
    h.engine.submit(1, prompts[1], 6)
    t0 = time.time()
    while not h.got and time.time() - t0 < 60:
        time.sleep(0.005)
    assert h.got, "no deltas streamed"
    h.engine.submit(2, prompts[2], 6)
    h.engine.submit(3, prompts[3], 6)
    h.finish()
    for i in range(4):
        assert h.got[i] == closed[i], i
        assert h.retired[i] == ("budget", 6)


def test_deltas_stream_before_retirement(tp):
    prompts = _prompts(1, (4,))
    b = _batcher(tp, batch=1, chunk=2)
    deltas = []
    eng = TS.ServeEngine(
        b, on_delta=lambda rid, t: deltas.append(list(t)),
        on_retired=lambda rid, r, n, final: deltas.append(list(final)),
        registry=M.MetricsRegistry())
    eng.submit(0, prompts[0], 10)
    eng.drain()
    eng.run()
    assert len(deltas) >= 4
    assert all(d for d in deltas[:-1])
    assert deltas[-1], "final delta must ride the retirement"
    assert [t for d in deltas for t in d] == _reference(tp, prompts[0], 10)


def test_cancel_waiting_and_inflight(tp):
    prompts = _prompts(2, (5, 4, 6, 3))
    h = _EngineHarness(_batcher(tp, cls=_SlowFetch, batch=1, chunk=2,
                                max_len=64))
    h.engine.submit("run", prompts[0], 4)
    h.engine.submit("doomed", prompts[1], 59)
    h.engine.submit("waiting", prompts[2], 4)
    h.engine.submit("last", prompts[3], 4)
    h.engine.cancel("waiting")
    t0 = time.time()
    while "doomed" not in h.got and time.time() - t0 < 60:
        time.sleep(0.005)
    h.engine.cancel("doomed")
    h.engine.cancel("doomed")                     # idempotent
    h.finish()
    assert h.retired["waiting"] == ("cancelled", 0)
    assert h.got.get("waiting", []) == []
    assert h.retired["doomed"][0] == "cancelled"
    assert len(h.got["doomed"]) < 59
    ref = _reference(tp, prompts[1], 59)
    assert h.got["doomed"] == ref[:len(h.got["doomed"])]
    assert h.got["run"] == _reference(tp, prompts[0], 4)
    assert h.got["last"] == _reference(tp, prompts[3], 4)
    h.engine.cancel("last")                       # after retirement
    assert h.retired["last"] == ("budget", 4)


def test_queue_depth_gauge_stop_and_validation(tp):
    reg = M.MetricsRegistry()
    eng = TS.ServeEngine(_batcher(tp, batch=1, chunk=2), registry=reg)
    g = reg.gauge("tony_serve_queue_depth")
    prompts = _prompts(3, (4, 4, 4))
    for i in range(3):
        eng.submit(i, prompts[i], 4,
                   request_class=("standard", "batch", "interactive")[i])
    assert g.value == 3
    assert reg.gauge("tony_serve_queue_depth",
                     **{"class": "batch"}).value == 1
    eng.cancel(1)
    assert g.value == 2
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(5, [], 4)
    with pytest.raises(ValueError, match="positive"):
        eng.submit(5, [1, 2], 0)
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(5, [1] * 30, 8)
    with pytest.raises(ValueError, match="already active"):
        eng.submit(0, [1, 2], 4)
    eng.drain()
    eng.run()
    assert g.value == 0
    h = _EngineHarness(_batcher(tp, batch=1, chunk=2, max_len=64))
    h.engine.submit(0, prompts[0], 40)
    h.engine.submit(1, prompts[1], 8)
    t0 = time.time()
    while 0 not in h.got and time.time() - t0 < 60:
        time.sleep(0.005)
    h.engine.stop()
    h.thread.join(timeout=60)
    assert not h.thread.is_alive()
    assert h.retired[0][0] == "stopped" and h.retired[1][0] == "stopped"
    with pytest.raises(RuntimeError, match="draining"):
        h.engine.submit(2, prompts[0], 4)


def test_failed_validation_leaves_no_phantom_queue_depth(tp):
    reg = M.MetricsRegistry()
    saved = M.set_default(reg)
    try:
        b = _batcher(tp, batch=1)
        with pytest.raises(ValueError, match="request 1"):
            b.serve([[1, 2], [1] * 40], 8)
        assert reg.gauge("tony_serve_queue_depth").value == 0
        assert b.serve([[1, 2]], 4)
    finally:
        M.set_default(saved)


# --- the server end to end ----------------------------------------------

def test_streamed_tokens_match_reference(tp):
    prompts = _prompts(0, (5, 3, 7, 4))
    reg = M.MetricsRegistry()
    srv = ServingServer(_batcher(tp), registry=reg)
    port = srv.start()
    try:
        with StreamingClient("127.0.0.1", port) as c:
            assert c.hello["slots"] == 2
            rids = [c.submit(p, 6) for p in prompts]
            for i, rid in enumerate(rids):
                toks, reason = c.result(rid)
                assert toks == _reference(tp, prompts[i], 6), i
                assert reason == "budget"
        assert reg.histogram("tony_serve_ttft_seconds").count >= 4
        assert reg.histogram("tony_serve_intertoken_seconds").count > 0
    finally:
        srv.stop(drain=True)


def test_poll_mode_stats_and_unported_lanes(tp):
    """Poll mode and STATS, and the prefix and weights lanes the server
    now carries: PREFIX ``list`` and WEIGHTS ``list`` answer on their
    rids, and HELLO advertises both lanes on one hub port. (The name
    dates from when both lanes answered ERROR.)"""
    from tony_tpu_torch.serving.weightstore import weights_rpc
    prompts = _prompts(5, (4, 4))
    srv = ServingServer(_batcher(tp), registry=M.MetricsRegistry())
    port = srv.start()
    try:
        with StreamingClient("127.0.0.1", port) as c:
            rid = c.submit(prompts[0], 6, stream=False)
            got, polls = [], 0
            while True:
                toks, reason = c.poll(rid)
                polls += 1
                got.extend(toks)
                if reason is not None:
                    break
            assert got == _reference(tp, prompts[0], 6)
            assert reason == "budget" and polls >= 2
            st = c.stats()
            assert st["slots"] == 2 and st["queue_depth"] == 0
            assert st["prefixes"] == [] and st["weights_resident"] == []
            # both lanes on one hub port, advertised in HELLO
            lane = c.hello["prefix_port"]
            assert isinstance(lane, int) and lane > 0
            assert c.hello["weight_port"] == lane == srv.prefix_port
            assert c.prefix_op("list") == {"ok": True, "resident": []}
            bad = c.prefix_op("frobnicate")
            assert bad["ok"] is False and "unknown prefix op" in bad["error"]
            toks, _ = c.result(c.submit(prompts[1], 5))
            assert toks == _reference(tp, prompts[1], 5)
        listed = weights_rpc(f"127.0.0.1:{port}", {"op": "list"})
        assert listed["ok"] and listed["resident"] == [st["weights_digest"]]
        assert listed["_hello"]["weight_port"] == lane
        res = weights_rpc(f"127.0.0.1:{port}", {"op": "resident"})
        assert res["resident"] == [st["weights_digest"]]
    finally:
        srv.stop(drain=True)


def test_cancel_over_the_wire(tp):
    prompts = _prompts(6, (4, 4))
    srv = ServingServer(_batcher(tp, cls=_SlowFetch, batch=1, chunk=2),
                        registry=M.MetricsRegistry())
    port = srv.start()
    try:
        with StreamingClient("127.0.0.1", port) as c:
            rid = c.submit(prompts[0], 25)
            ev = c.next_event(rid, timeout=60)
            assert ev[0] == "tokens"
            c.cancel(rid)
            c.cancel(rid)                         # idempotent on the wire
            toks = list(ev[1])
            while True:
                ev = c.next_event(rid, timeout=60)
                if ev[0] == "retired":
                    assert ev[1] == "cancelled"
                    break
                toks.extend(ev[1])
            ref = _reference(tp, prompts[0], 25)
            assert toks == ref[:len(toks)] and len(toks) < 25
            toks2, _ = c.result(c.submit(prompts[1], 6))
            assert toks2 == _reference(tp, prompts[1], 6)
    finally:
        srv.stop(drain=True)


def test_graceful_drain_and_kill(tp):
    prompts = _prompts(7, (4, 4))
    srv = ServingServer(_batcher(tp, cls=_SlowFetch, batch=1, chunk=2),
                        registry=M.MetricsRegistry())
    port = srv.start()
    c = StreamingClient("127.0.0.1", port)
    try:
        rid = c.submit(prompts[0], 12)
        ev = c.next_event(rid, timeout=60)
        assert ev[0] == "tokens"
        stopper = threading.Thread(target=srv.stop, kwargs={"drain": True})
        stopper.start()
        toks = list(ev[1])
        while True:
            ev = c.next_event(rid, timeout=60)
            if ev[0] == "retired":
                break
            toks.extend(ev[1])
        assert toks == _reference(tp, prompts[0], 12)
        stopper.join(timeout=60)
        assert not stopper.is_alive()
    finally:
        c.close()
    # kill(): peers see the connection drop at once, mid-stream
    srv = ServingServer(_batcher(tp, cls=_SlowFetch, batch=1, chunk=2,
                                 max_len=64), registry=M.MetricsRegistry())
    port = srv.start()
    c = StreamingClient("127.0.0.1", port)
    try:
        rid = c.submit(prompts[1], 50)
        assert c.next_event(rid, timeout=60)[0] == "tokens"
        srv.kill()
        while True:
            ev = c.next_event(rid, timeout=30)
            if ev[0] != "tokens":
                break
        assert ev[0] == "error"
        assert not srv._engine_thread.is_alive()
    finally:
        c.close()


def test_request_spans_join_one_trace(tp):
    """The client's ``client.request``/``client.ttft`` spans and the
    engine's ``engine.request``/``engine.queued``/``engine.first_token``
    spans of one request share a trace id (the context rides the ADMIT
    frame), and the engine's span ends with the retirement reason."""
    from tony_tpu_torch.runtime import tracing
    saved = tracing.set_tracer(tracing.Tracer(proc="test", sample_rate=1.0))
    try:
        srv = ServingServer(_batcher(tp), registry=M.MetricsRegistry())
        port = srv.start()
        try:
            with StreamingClient("127.0.0.1", port) as c:
                toks, _ = c.result(c.submit(_prompts(30, (5,))[0], 4))
        finally:
            srv.stop(drain=True)
        spans = tracing.get_tracer().recent()
    finally:
        tracing.set_tracer(saved)
    names = {sp["n"]: sp for sp in spans}
    for n in ("client.request", "client.ttft", "engine.request",
              "engine.queued", "engine.first_token"):
        assert n in names, (n, sorted(names))
    assert len({names[n]["tid"] for n in names}) == 1
    assert names["engine.request"]["a"]["reason"] == "budget"
    assert names["engine.request"]["a"]["tokens"] == len(toks) == 4
    assert names["engine.queued"]["pid"] == names["engine.request"]["sid"]


class TestProtocolRobustness:
    """Malformed/truncated frames never kill the server; disconnects free
    slots; errors are scoped correctly."""

    @pytest.fixture()
    def server(self, tp):
        srv = ServingServer(_batcher(tp), registry=M.MetricsRegistry())
        srv.start()
        yield srv
        srv.stop()

    def _assert_still_serving(self, tp, port):
        prompts = _prompts(9, (4,))
        with StreamingClient("127.0.0.1", port) as c:
            toks, _ = c.result(c.submit(prompts[0], 5))
            assert toks == _reference(tp, prompts[0], 5)

    def _hello(self, server):
        s = socket.create_connection(("127.0.0.1", server.port))
        s.sendall(P.MAGIC)
        assert P.recv_frame(s)[0] == P.HELLO
        return s

    def test_garbage_magic_closed(self, tp, server):
        s = socket.create_connection(("127.0.0.1", server.port))
        s.sendall(b"GET / HTTP/1.1\r\n\r\n")
        assert s.recv(4096) == b""
        s.close()
        self._assert_still_serving(tp, server.port)

    def test_implausible_frame_is_connection_scoped(self, tp, server):
        s = self._hello(server)
        s.sendall(struct.pack("<I", P.MAX_FRAME_BYTES + 5))
        frame = P.recv_frame(s)
        assert frame is not None and frame[0] == P.ERROR and frame[1] == 0
        assert "implausible" in P.unpack_json(frame[2])["message"]
        assert P.recv_frame(s) is None
        s.close()
        self._assert_still_serving(tp, server.port)

    def test_truncated_frame_never_kills_server(self, tp, server):
        s = self._hello(server)
        s.sendall(struct.pack("<I", 64) + b"\x01partial")
        s.close()
        self._assert_still_serving(tp, server.port)

    def test_unknown_frame_type_is_connection_scoped(self, tp, server):
        s = self._hello(server)
        P.send_frame(s, 250, 1)
        frame = P.recv_frame(s)
        assert frame[0] == P.ERROR and frame[1] == 0
        assert P.recv_frame(s) is None
        s.close()
        self._assert_still_serving(tp, server.port)

    def test_malformed_admit_payload_is_connection_scoped(self, tp, server):
        s = self._hello(server)
        P.send_frame(s, P.ADMIT, 1, b"\xff\xfenot json")
        frame = P.recv_frame(s)
        assert frame[0] == P.ERROR and frame[1] == 0
        s.close()
        self._assert_still_serving(tp, server.port)

    def test_unservable_admit_is_request_scoped(self, tp, server):
        with StreamingClient("127.0.0.1", server.port) as c:
            rid = c.submit([1] * 40, 8)
            ev = c.next_event(rid, timeout=60)
            assert ev[0] == "error" and "exceeds max_len" in ev[1]
            rid = c.submit([1, 2], 4, request_class="gold")
            ev = c.next_event(rid, timeout=60)
            assert ev[0] == "error" and "request class" in ev[1]
            prompts = _prompts(10, (4,))
            toks, _ = c.result(c.submit(prompts[0], 5,
                                        request_class="interactive"))
            assert toks == _reference(tp, prompts[0], 5)

    def test_duplicate_rid_is_request_scoped(self, tp, server):
        with StreamingClient("127.0.0.1", server.port) as c:
            prompt = _prompts(14, (4,))[0]
            c.submit(prompt, 6, rid=777)
            c.submit(prompt, 6, rid=777)
            saw_error = saw_retired = False
            deadline = time.time() + 60
            while not (saw_error and saw_retired) and time.time() < deadline:
                ev = c.next_event(777, timeout=60)
                if ev[0] == "error":
                    assert "already active" in ev[1]
                    saw_error = True
                elif ev[0] == "retired":
                    saw_retired = True
            assert saw_error and saw_retired
            toks, _ = c.result(c.submit(prompt, 5))
            assert toks == _reference(tp, prompt, 5)

    def test_disconnect_mid_stream_frees_slots(self, tp, server):
        c1 = StreamingClient("127.0.0.1", server.port)
        r1 = c1.submit(_prompts(11, (4,))[0], 25)
        c1.submit(_prompts(12, (4,))[0], 25)
        assert c1.next_event(r1, timeout=60)[0] == "tokens"
        c1.close()
        self._assert_still_serving(tp, server.port)
        t0 = time.time()
        while time.time() - t0 < 30:
            st = server.engine.stats()
            if st["active"] == 0 and st["queue_depth"] == 0:
                break
            time.sleep(0.01)
        assert st["active"] == 0, st


def test_classless_admit_lands_standard_and_busy_retry(tp):
    srv = ServingServer(_batcher(tp, cls=_SlowFetch),
                        registry=M.MetricsRegistry(), max_queue_depth=1,
                        busy_retry_ms=40)
    port = srv.start()
    prompts = _prompts(45, (4, 5, 4, 6))
    budget = 20
    try:
        with StreamingClient("127.0.0.1", port) as c:
            rids = []
            for i, want in enumerate(((1, 0), (2, 0), (2, 1))):
                rids.append(c.submit(prompts[i], budget,
                                     request_class=None if i == 2
                                     else "batch"))
                deadline = time.time() + 30
                while time.time() < deadline:
                    st = c.stats()
                    if (st["active"], st["queue_depth"]) == want:
                        break
                    time.sleep(0.01)
                else:
                    pytest.fail(f"fill {i} never settled: {st}")
            assert st["queue_depths"]["standard"] == 1   # classless
            with pytest.raises(ServerBusy) as ei:
                c.result(c.submit(prompts[3], 6, request_class="batch"))
            assert ei.value.retry_after_ms == 40
            toks, reason = c.result(
                c.submit(prompts[3], 6, request_class="batch", retries=8),
                timeout=120)
            assert toks == _reference(tp, prompts[3], 6)
            assert reason == "budget"
            for i, r in enumerate(rids):
                toks, _ = c.result(r, timeout=120)
                assert toks == _reference(tp, prompts[i], budget)
            assert c.stats()["shed"] >= 1
    finally:
        srv.stop()


# --- wire compatibility with the JAX package ----------------------------

@pytest.mark.parametrize("sampling", [
    {}, {"temperature": 0.8, "top_k": 50, "top_p": 0.95, "seed": 0}],
    ids=["greedy", "sampled"])
def test_wire_compatible_both_ways(params, sampling):
    jp, tp = params
    prompts = _prompts(20, (5, 9, 3))
    budgets = [6, 4, 7]
    want = JS.ContinuousBatcher(jp, JCFG, batch=2, max_len=32, chunk=3,
                                **sampling).serve(prompts, budgets)
    # the JAX client against the port's server
    srv = ServingServer(_batcher(tp, **sampling),
                        registry=M.MetricsRegistry())
    port = srv.start()
    try:
        with JC.StreamingClient("127.0.0.1", port) as c:
            rids = [c.submit(p, n) for p, n in zip(prompts, budgets)]
            got = [c.result(r)[0] for r in rids]
            hello = c.hello
    finally:
        srv.stop(drain=True)
    assert got == want
    # the port's client against the JAX server
    jsrv = JSRV.ServingServer(JS.ContinuousBatcher(
        jp, JCFG, batch=2, max_len=32, chunk=3, **sampling))
    jport = jsrv.start()
    try:
        with StreamingClient("127.0.0.1", jport) as c:
            rids = [c.submit(p, n) for p, n in zip(prompts, budgets)]
            got = [c.result(r)[0] for r in rids]
            jhello = c.hello
            jstats = c.stats()
    finally:
        jsrv.stop(drain=True)
    assert got == want
    assert set(hello) == set(jhello)
    # both lanes advertised on one hub port, as the JAX server does
    assert hello["prefixes"] == [] and hello["prefix_port"] > 0
    assert hello["weight_port"] == hello["prefix_port"]
    assert jhello["weight_port"] == jhello["prefix_port"] > 0
    assert hello["weights_resident"] == []
    assert hello["weights_digest"] == jax_tree_digest(jp)
    assert hello["weights_digest"] == tree_digest(tp)
    assert set(jstats) <= set(srv.engine.stats()) | set(hello)
