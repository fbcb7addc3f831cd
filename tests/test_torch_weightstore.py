"""tony_tpu_torch's weights lane against the JAX package's.

``tiny`` with the JAX weights converted to torch. Covered:

- ``pack_weights``: one tree packs to the same bytes in either package,
  f32, bf16 (torch tensors here, ``ml_dtypes`` arrays there) and int8
  on the wire; each package lands the other's artifact with the
  seeder's ``tree_digest``; a flipped byte, a foreign artifact part or a
  gapped tree is refused (``ProtocolError``), and the store keeps only
  digest-verified artifacts;
- ``pull_weights`` across the packages over a real weights lane: a JAX
  replica seeds the port and the port seeds JAX, the landed tree's
  digest equal to the seeder's, and the port's pulled params serve the
  seeder's tokens;
- the WEIGHTS ops (list, resident, publish, an unknown op) on the port's
  server;
- ``serve_lm --listen --warm_from`` as a process: it advertises the
  seeder's digest and streams the seeder's tokens; a failed pull falls
  back to the storage load and says so;
- the fleet's fan-out: ``warm_fanout`` against the JAX package's on the
  same ships and fallbacks (log2 waves, a crashed seeder, failing
  fallbacks), and ``ChannelWarmer`` ships between live servers — port to
  port in waves, with a dead seeder's fallback, and each way across the
  packages through either package's warmer, landing the seeder's digest.
"""

import os
import re
import signal
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tony_tpu.models import serve as JS
from tony_tpu.models import transformer as JT
from tony_tpu.serving import server as JSRV
from tony_tpu.serving import weightstore as JW
from tony_tpu_torch import serve_lm
from tony_tpu_torch.models import serve as TS
from tony_tpu_torch.models import transformer as TT
from tony_tpu_torch.models.weights import params_from_numpy
from tony_tpu_torch.runtime import metrics as M
from tony_tpu_torch.serving import blobcodec
from tony_tpu_torch.serving import weightstore as W
from tony_tpu_torch.serving.client import StreamingClient
from tony_tpu_torch.serving.protocol import ProtocolError
from tony_tpu_torch.serving.server import ServingServer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = JT.PRESETS["tiny"].scaled(dtype=jnp.float32, remat=False)
TCFG = TT.PRESETS["tiny"].scaled(dtype=torch.float32, remat=False)


@pytest.fixture(scope="module")
def params():
    jp = JT.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_numpy(jax.device_get(jp), device="cpu")


def _host(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("arm", ["f32", "bf16", "int8-wire"])
def test_pack_weights_byte_identical_between_packages(params, arm):
    jp, tp = params
    if arm == "bf16":
        jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
        tp = params_from_numpy(jax.device_get(jp), device="cpu")
        assert tp["embed"].dtype == torch.bfloat16
    quant = arm == "int8-wire"
    jblob = JW.pack_weights(_host(jp), version="v7", quantize=quant)
    tblob = W.pack_weights(tp, version="v7", quantize=quant)
    assert jblob == tblob
    jmeta, jtree = JW.unpack_weights(tblob)
    tmeta, ttree = W.unpack_weights(jblob)
    assert tmeta == jmeta and tmeta["version"] == "v7"
    assert tmeta["quantized"] is quant
    assert tmeta["digest"] == W.tree_digest(ttree) == JW.tree_digest(jtree)
    if not quant:
        assert tmeta["digest"] == W.tree_digest(tp) == JW.tree_digest(
            _host(jp))
    emb = ttree["embed"]
    if arm == "bf16":
        assert emb.dtype == torch.bfloat16
        assert jtree["embed"].dtype == ml_dtypes.bfloat16
    # the landed tree becomes the port's params, digest unchanged
    back = params_from_numpy(ttree, device="cpu")
    assert W.tree_digest(back) == tmeta["digest"]
    assert W.peek_weights_meta(tblob) == tmeta


def test_corrupt_and_foreign_artifacts_are_refused(params):
    _, tp = params
    blob = bytearray(W.pack_weights(tp))
    blob[-5] ^= 0x40
    with pytest.raises(ProtocolError, match="REFUSED"):
        W.unpack_weights(bytes(blob))
    store = W.WeightStore(M.MetricsRegistry())
    with pytest.raises(ProtocolError):
        store.put(bytes(blob))
    cc = blobcodec.WEIGHTS.pack({"part": "compile_cache",
                                 "digest": "0" * 64}, {})
    with pytest.raises(ProtocolError, match="not ported"):
        store.put(cc)
    with pytest.raises(ProtocolError, match="not a weight"):
        W.unpack_weights(cc)
    with pytest.raises(ProtocolError, match="gapped"):
        W.unflatten_tree({"a/#0": 1, "a/#2": 2})
    good = W.pack_weights(tp)
    digest = store.put(good)
    assert store.resident_digests() == [digest] == store.digests()
    assert store.get(digest) == good
    with pytest.raises(ValueError, match="not resident"):
        store.get("f" * 64)


def _serve_tokens(addr_port, prompts):
    with StreamingClient("127.0.0.1", addr_port) as c:
        rids = [c.submit(p, 5) for p in prompts]
        return [c.result(r)[0] for r in rids]


@pytest.mark.parametrize("seeder", ["jax", "port"])
def test_pull_weights_between_packages(params, seeder):
    """A replica of one package seeds the other's pull over the weights
    lane; the landed tree digests as the seeder advertises, and (a port
    pull) serves the seeder's tokens."""
    jp, tp = params
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6]]
    if seeder == "jax":
        srv = JSRV.ServingServer(JS.ContinuousBatcher(jp, JCFG, batch=2,
                                                      max_len=32))
    else:
        srv = ServingServer(TS.ContinuousBatcher(tp, TCFG, batch=2,
                                                 max_len=32),
                            registry=M.MetricsRegistry())
    try:
        port = srv.start()
        addr = f"127.0.0.1:{port}"
        with StreamingClient("127.0.0.1", port) as c:
            advertised = c.hello["weights_digest"]
            assert c.hello["weights_resident"] == []
        assert advertised == W.tree_digest(tp)
        if seeder == "jax":
            meta, tree = W.pull_weights(addr, timeout_s=60)
            assert W.tree_digest(tree) == advertised
            pulled = params_from_numpy(tree, device="cpu")
            assert W.tree_digest(pulled) == advertised
            b = TS.ContinuousBatcher(pulled, TCFG, batch=2, max_len=32)
            assert b.serve(prompts, 5) == _serve_tokens(port, prompts)
        else:
            meta, tree = JW.pull_weights(addr, timeout_s=60)
            assert JW.tree_digest(tree) == advertised
        assert meta["digest"] == advertised
        # the seeder's export is resident now; the ops say so
        listed = W.weights_rpc(addr, {"op": "resident"})
        assert listed["ok"] and listed["resident"] == [advertised]
        bad = W.weights_rpc(addr, {"op": "frobnicate"})
        assert not bad["ok"] and "unknown weights op" in bad["error"]
        bad = W.weights_rpc(addr, {"op": "publish", "digest": "0" * 64,
                                   "target": "127.0.0.1:1"})
        assert not bad["ok"]
    finally:
        srv.kill()


def test_pull_of_an_artifact_larger_than_the_lane_window(params,
                                                        monkeypatch):
    """An artifact of more chunks than the puller's hub holds plus the
    seeder's send window (here 64 KiB chunks of the 3 MB tiny tree)
    lands: the port's pull consumes while the seeder publishes. The
    JAX package's pull waits for the publish to finish first and times
    out on the same artifact (ROADMAP queue 3)."""
    _, tp = params
    monkeypatch.setattr(W, "CHUNK_BYTES_DEFAULT", 1 << 16)
    srv = ServingServer(TS.ContinuousBatcher(tp, TCFG, batch=1,
                                             max_len=16),
                        registry=M.MetricsRegistry())
    try:
        addr = f"127.0.0.1:{srv.start()}"
        meta, tree = W.pull_weights(addr, timeout_s=30)
        assert meta["digest"] == W.tree_digest(tree) == srv.weights_digest
        blob = srv.weight_store.get(meta["digest"])
        assert len(blob) > 12 * (1 << 16)
        with pytest.raises(OSError):        # ChannelError or a timeout
            JW.pull_weights(addr, timeout_s=3)
    finally:
        srv.kill()


def test_warm_boot_falls_back_when_the_pull_fails(capsys):
    import socket
    with socket.socket() as s:       # a port nobody serves
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    assert serve_lm.warm_boot(f"127.0.0.1:{dead}", "cpu") is None
    assert "falling back to a storage load" in capsys.readouterr().out


def test_serve_lm_warm_from_process(params):
    """``serve_lm --listen --warm_from A`` boots from A's weights lane:
    its HELLO carries A's digest and it streams A's tokens, though its
    own seed-0 build would give other weights (A serves seed 7's)."""
    _, tp = params
    cfg = TT.PRESETS["tiny"].scaled(dtype=torch.float32, remat=False)
    seeded = TT.init_params(torch.Generator().manual_seed(7), cfg,
                            device="cpu")
    srv = ServingServer(TS.ContinuousBatcher(seeded, cfg, batch=2,
                                             max_len=32),
                        registry=M.MetricsRegistry())
    proc = None
    try:
        aport = srv.start()
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
        proc = subprocess.Popen(
            [sys.executable, "-m", "tony_tpu_torch.serve_lm", "--device",
             "cpu", "--preset", "tiny", "--slots", "2", "--prompt_len",
             "16", "--max_new_tokens", "16", "--listen", "127.0.0.1:0",
             "--warm_from", f"127.0.0.1:{aport}"],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        lines, cport = [], None
        while cport is None:
            line = proc.stdout.readline()
            assert line, "".join(lines)
            lines.append(line)
            m = re.search(r"serving tiny \(greedy\) on 127\.0\.0\.1:(\d+)",
                          line)
            cport = int(m.group(1)) if m else None
        assert any("warm boot: pulled weights" in x for x in lines), lines
        with StreamingClient("127.0.0.1", cport) as c:
            assert c.hello["weights_digest"] == srv.weights_digest
        assert srv.weights_digest != W.tree_digest(
            serve_lm.build("tiny", "cpu")[1])
        prompts = [[3, 1, 4, 1, 5], [9, 2, 6, 5]]
        assert _serve_tokens(cport, prompts) == _serve_tokens(aport, prompts)
    finally:
        if proc is not None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
        srv.kill()


# ---------------------------------------------------------------------------
# Self-organizing fan-out (tests/test_weightstore.py::TestWarmFanout),
# each case run through both packages' warm_fanout
# ---------------------------------------------------------------------------
def _both_fanouts(targets, make_ship, **kw):
    """The port's summary, after checking it equals the JAX package's on
    the same ship/fallback behaviour (fresh callables for each run)."""
    runs = []
    for fanout in (W.warm_fanout, JW.warm_fanout):
        ship, extra = make_ship()
        runs.append((fanout(list(targets), ship, **kw, **extra), extra))
    assert runs[0][0] == runs[1][0]
    return runs[0]


class TestWarmFanout:
    def test_log2_waves_from_one_seed(self):
        res, _ = _both_fanouts([f"t{i}" for i in range(8)],
                               lambda: (lambda src, dst: None, {}),
                               seeders=["seed"])
        assert not res["failed"] and not res["fallback"]
        assert len(res["warmed"]) == 8 and res["ships"] == 8
        assert res["waves"] == 4               # 1 -> 2 -> 4 -> 8 seeders

    def test_cold_start_mints_seed_then_fans_out(self):
        def make():
            loads = []
            return (lambda src, dst: None), {"fallback": loads.append}
        res, extra = _both_fanouts([f"t{i}" for i in range(8)], make)
        assert res["waves"] == 4 and res["ships"] == 7
        assert res["fallback"] == ["t0"] and len(res["warmed"]) == 7

    def test_crashed_seeder_condemned_target_retries(self):
        calls, loads = [], []

        def make():
            del calls[:], loads[:]

            def ship(src, dst):
                calls.append((src, dst))
                if src == "dead":
                    raise RuntimeError("seeder crashed mid-ship")
            return ship, {"fallback": loads.append}

        res, _ = _both_fanouts(["t0", "t1"], make, seeders=["dead"])
        assert not res["failed"]
        assert loads == ["t0"]
        assert ("dead", "t0") in calls
        assert sorted(res["warmed"] + res["fallback"]) == ["t0", "t1"]

    def test_no_fallback_reports_failed_without_wedging(self):
        def ship(src, dst):
            raise RuntimeError("boom")
        res, _ = _both_fanouts(["t0", "t1"], lambda: (ship, {}),
                               seeders=["dead"])
        assert res["failed"] == ["t0", "t1"] and not res["warmed"]

    def test_failing_fallback_reports_failed_never_raises(self):
        attempts = []

        def make():
            del attempts[:]

            def fallback(dst):
                attempts.append(dst)
                if len(attempts) == 1:
                    raise OSError("storage load failed")
            return (lambda src, dst: None), {"fallback": fallback}

        res, _ = _both_fanouts(["t0", "t1", "t2"], make)
        assert res["failed"] == ["t0"]
        assert res["fallback"] == ["t1"]
        assert res["warmed"] == ["t2"]
        assert attempts == ["t0", "t1"]

    def test_fallback_always_failing_terminates(self):
        def fallback(dst):
            raise OSError("storage down")
        res, _ = _both_fanouts(["t0", "t1"],
                               lambda: ((lambda s, d: None),
                                        {"fallback": fallback}))
        assert res["failed"] == ["t0", "t1"]
        assert not res["warmed"] and not res["fallback"]


# ---------------------------------------------------------------------------
# ChannelWarmer: peer ships between live replicas
# ---------------------------------------------------------------------------
def _server(pkg, jp, tp):
    if pkg == "jax":
        return JSRV.ServingServer(JS.ContinuousBatcher(jp, JCFG, batch=1,
                                                       max_len=16))
    return ServingServer(TS.ContinuousBatcher(tp, TCFG, batch=1,
                                              max_len=16),
                         registry=M.MetricsRegistry())


def test_channel_warmer_ships_between_port_servers(params):
    """A port seeder warms two port targets in two waves (the first
    warmed target seeds the second); each target's store then holds the
    seeder's digest, which it advertised as not resident before, and a
    second pass finds them warm without shipping again."""
    jp, tp = params
    servers = [_server("port", jp, tp) for _ in range(3)]
    try:
        seeder, *targets = [f"127.0.0.1:{s.start()}" for s in servers]
        digest = servers[0].weights_digest
        for t in targets:
            assert W.weights_rpc(t, {"op": "resident"})["resident"] == []
        warmer = W.ChannelWarmer(digest, [seeder], timeout_s=60)
        res = warmer.warm(targets)
        assert res == {"waves": 2, "warmed": targets, "fallback": [],
                       "failed": [], "ships": 2}
        for s in servers[1:]:
            assert s.weight_store.resident_digests() == [digest]
            with StreamingClient("127.0.0.1", s.port) as c:
                assert c.hello["weights_resident"] == [digest]
        shipped = sum(s._weight_ship_bytes_c.value for s in servers)
        assert shipped == 2 * len(servers[0].weight_store.get(digest))
        again = W.ChannelWarmer(digest, [seeder], timeout_s=60).warm(
            targets)
        assert again["warmed"] == targets
        assert sum(s._weight_ship_bytes_c.value for s in servers) == shipped
    finally:
        for s in servers:
            s.kill()


def test_channel_warmer_without_a_seeder_uses_the_fallback(params):
    """The only seeder is gone: the target is loaded by the fallback,
    never admitted cold, and a target that cannot be loaded is failed."""
    jp, tp = params
    srv = _server("port", jp, tp)
    try:
        target = f"127.0.0.1:{srv.start()}"
        with socket.socket() as s:        # a port nobody serves
            s.bind(("127.0.0.1", 0))
            dead = f"127.0.0.1:{s.getsockname()[1]}"
        loads = []
        res = W.ChannelWarmer(srv.weights_digest, [dead],
                              fallback=loads.append,
                              timeout_s=5).warm([target])
        assert loads == [target] and res["fallback"] == [target]
        res = W.ChannelWarmer(srv.weights_digest, [dead],
                              timeout_s=5).warm([target])
        assert res["failed"] == [target] and not res["warmed"]
    finally:
        srv.kill()


@pytest.mark.parametrize("warmer_pkg", ["port", "jax"])
@pytest.mark.parametrize("seeder_pkg", ["jax", "port"])
def test_channel_warmer_across_packages(params, seeder_pkg, warmer_pkg):
    """A replica of one package warms the other's through either
    package's ChannelWarmer: the landed artifact is resident under the
    seeder's digest, the one ``tree_digest`` of both packages' params."""
    jp, tp = params
    target_pkg = "port" if seeder_pkg == "jax" else "jax"
    seed_srv = _server(seeder_pkg, jp, tp)
    target_srv = _server(target_pkg, jp, tp)
    try:
        seeder = f"127.0.0.1:{seed_srv.start()}"
        target = f"127.0.0.1:{target_srv.start()}"
        digest = W.tree_digest(tp)
        assert seed_srv.weights_digest == target_srv.weights_digest == digest
        warmer_cls = (W.ChannelWarmer if warmer_pkg == "port"
                      else JW.ChannelWarmer)
        res = warmer_cls(digest, [seeder], timeout_s=60).warm([target])
        assert res["warmed"] == [target] and res["ships"] == 1, res
        assert target_srv.weight_store.resident_digests() == [digest]
        meta = target_srv.weight_store.meta(digest)
        assert meta["digest"] == digest
    finally:
        seed_srv.kill()
        target_srv.kill()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_residency_reads_do_not_wait_for_the_lazy_export(params, pkg):
    """The first seed op packs the params (the lazy self-export). The
    port packs outside the store's lock, so ``resident_digests`` — what
    HELLO and STATS read — answers at once while a pack runs; the JAX
    package's waits for the whole pack (a router pinging a seeder
    mid-warm sees it unresponsive)."""
    import threading
    import time
    _, tp = params
    blob = W.pack_weights(tp)
    started = threading.Event()

    def slow_export():
        started.set()
        time.sleep(1.0)
        return blob

    store = (W.WeightStore(M.MetricsRegistry(), exporter=slow_export)
             if pkg == "port" else JW.WeightStore(exporter=slow_export))
    seeding = threading.Thread(target=store.digests, daemon=True)
    seeding.start()
    assert started.wait(10)
    t0 = time.monotonic()
    assert store.resident_digests() in ([], [W.tree_digest(tp)])
    waited = time.monotonic() - t0
    seeding.join(10)
    if pkg == "port":
        assert waited < 0.5, waited
    else:
        assert waited >= 0.5, waited
    assert store.digests() == [W.tree_digest(tp)]
    assert store.get(W.tree_digest(tp)) == blob
