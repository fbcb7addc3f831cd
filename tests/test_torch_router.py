"""tony_tpu_torch's ServingRouter on real port replicas, and one fleet of
a JAX replica and a port replica.

Mirrors ``tests/test_serving.py::TestRouter`` and
``::TestFleetOperations``, the router cases of ``tests/test_prefix.py``
and ``tests/test_fleet.py::TestDrainUnderLoad`` (there on simulated
replicas, here on ``tiny`` f32 port ``ServingServer`` replicas):
placement by queue depth, replica loss and planned drains (greedy and
sampled) and a rolling upgrade by ``weights_version`` with no token
duplicated or dropped, drains of several replicas at once, a drain
racing its target's crash, a cancel mid-migration, a stop racing a
drain, ring replicas placed prefix-blind with one warning, residency-
aware placement, DRAIN and MIGRATE from a remote client, replicas added
and removed live. Then one JAX ``ServingServer`` and one port
``ServingServer`` with one ``tree_digest`` behind the port's router and
behind the JAX router: equal streams, and a failover from one package
to the other that drops and duplicates nothing.
"""

import logging
import queue
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import serve as JS
from tony_tpu.models import transformer as JT
from tony_tpu.runtime import metrics as JM
from tony_tpu.serving import router as JR
from tony_tpu.serving import server as JSRV
from tony_tpu_torch.models import decode as TD
from tony_tpu_torch.models import serve as TS
from tony_tpu_torch.models import transformer as TT
from tony_tpu_torch.models.weights import params_from_numpy
from tony_tpu_torch.runtime import metrics as M
from tony_tpu_torch.serving.client import StreamingClient
from tony_tpu_torch.serving.router import ServingRouter
from tony_tpu_torch.serving.server import ServingServer

torch.set_num_threads(2)

JCFG = JT.PRESETS["tiny"].scaled(dtype=jnp.float32, remat=False)
TCFG = TT.PRESETS["tiny"].scaled(dtype=torch.float32, remat=False)
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9, seed=7)


@pytest.fixture(scope="module")
def pair():
    jp = JT.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_numpy(jax.device_get(jp), device="cpu")


@pytest.fixture(scope="module")
def tp(pair):
    return pair[1]


def _prompts(seed, sizes):
    rs = np.random.RandomState(seed)
    return [[int(t) for t in rs.randint(0, TCFG.vocab_size, size=n)]
            for n in sizes]


def _reference(tp, prompt, n):
    out = TD.generate(tp, torch.tensor([prompt]), TCFG, n)
    return out.tokens[0, len(prompt):].tolist()


class _SlowFetch(TS.ContinuousBatcher):
    fetch_s = 0.05

    def _fetch(self, handle):
        time.sleep(self.fetch_s)          # keep streams mid-flight
        return super()._fetch(handle)


def _servers(tp, n=2, slow=True, weights_version=None, **kw):
    kw.setdefault("batch", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("chunk", 2)
    cls = _SlowFetch if slow else TS.ContinuousBatcher
    servers = [ServingServer(cls(tp, TCFG, **kw),
                             registry=M.MetricsRegistry(),
                             weights_version=weights_version)
               for _ in range(n)]
    return servers, [f"127.0.0.1:{s.start()}" for s in servers]


def _stop(router, servers):
    if router is not None:
        router.stop()
    for s in servers:
        s.stop()


def _start_streams(c, prompts, budget):
    """Submit, and block until every stream has produced a token (so a
    drain or a loss lands genuinely mid-flight)."""
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
            except queue.Empty:
                continue
            assert ev[0] == "tokens", ev
            got[r].extend(ev[1])
            started.add(r)
    assert len(started) == len(rids), "streams never started"
    return rids, got


def _collect(c, rids, got):
    """Read every stream to its ONE terminal frame."""
    for r in rids:
        while True:
            ev = c.next_event(r, timeout=90)
            if ev[0] == "tokens":
                got[r].extend(ev[1])
            elif ev[0] == "retired":
                break
            else:
                raise AssertionError(ev)


# ---------------------------------------------------------------------------
# TestRouter
# ---------------------------------------------------------------------------
def test_sessions_spread_by_queue_depth(tp):
    servers, addrs = _servers(tp, slow=False)
    router = ServingRouter(addrs, registry=M.MetricsRegistry())
    try:
        rport = router.start()
        prompts = _prompts(13, (5, 3, 7, 4, 6, 3))
        with StreamingClient("127.0.0.1", rport) as c:
            assert c.hello["router"] is True
            rids = [c.submit(p, 6) for p in prompts]
            outs = [c.result(r, timeout=90) for r in rids]
        for i, (toks, reason) in enumerate(outs):
            assert toks == _reference(tp, prompts[i], 6), i
        assert all(s.engine.b.steps_executed > 0 for s in servers)
    finally:
        _stop(router, servers)


def test_placement_prefers_less_loaded_replica(tp):
    servers, addrs = _servers(tp, slow=False)
    router = ServingRouter(addrs, health_interval_s=0.1,
                           registry=M.MetricsRegistry())
    try:
        rport = router.start()
        host_a, port_a = addrs[0].rsplit(":", 1)
        ca = StreamingClient(host_a, int(port_a))
        fillers = [ca.submit(p, 56) for p in _prompts(14, (3, 3, 3, 3))]
        deadline = time.time() + 10
        while time.time() < deadline:
            load = router.stats()["replicas"][addrs[0]]
            if load["reported_load"] >= 3:
                break
            time.sleep(0.02)
        assert load["reported_load"] >= 3, load
        b_before = servers[1].engine.b.steps_executed
        with StreamingClient("127.0.0.1", rport) as c:
            prompts = _prompts(15, (4, 4))
            rids = [c.submit(p, 4) for p in prompts]
            for i, r in enumerate(rids):
                assert c.result(r, timeout=90)[0] == _reference(
                    tp, prompts[i], 4)
        assert servers[1].engine.b.steps_executed > b_before
        for f in fillers:
            ca.cancel(f)
        ca.close()
    finally:
        _stop(router, servers)


def test_replica_loss_no_dup_no_drop(tp):
    servers, addrs = _servers(tp)
    reg = M.MetricsRegistry()
    router = ServingRouter(addrs, health_interval_s=0.2, registry=reg)
    prompts = _prompts(16, (5, 5, 5, 5))
    budget = 36
    try:
        rport = router.start()
        with StreamingClient("127.0.0.1", rport) as c:
            rids, got = _start_streams(c, prompts, budget)
            pre = router.stats()["replicas"]
            assert all(v["assigned"] > 0 for v in pre.values()), pre
            servers[0].kill()
            _collect(c, rids, got)
            for i, r in enumerate(rids):
                assert got[r] == _reference(tp, prompts[i], budget), i
        assert reg.counter("tony_router_failovers_total").value >= 1
        assert reg.gauge("tony_router_replica_up",
                         replica=addrs[0]).value == 0
        assert reg.gauge("tony_router_replica_up",
                         replica=addrs[1]).value == 1
    finally:
        _stop(router, servers)


# ---------------------------------------------------------------------------
# TestFleetOperations
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_planned_drain_zero_dup_drop(tp, mode):
    """Drain a replica carrying live streams (a DRAIN frame from a
    remote client): every session completes with its reference tokens
    (the sampled ones through their pinned rng stream and offset), the
    drained replica ends fenced and empty, and the drain is planned,
    not a failover."""
    kw = dict(batch=4, max_len=64, chunk=2,
              **(SAMPLED if mode == "sampled" else {}))
    prompts = _prompts(31, (5, 5, 4, 6))
    budget = 40
    ref = TS.ContinuousBatcher(tp, TCFG, **kw).serve(prompts, budget)
    servers, addrs = _servers(tp, **kw)
    reg = M.MetricsRegistry()
    router = ServingRouter(addrs, health_interval_s=0.2, registry=reg)
    try:
        rport = router.start()
        with StreamingClient("127.0.0.1", rport) as c:
            rids, got = _start_streams(c, prompts, budget)
            pre = router.stats()["replicas"]
            assert all(v["assigned"] > 0 for v in pre.values()), pre
            victim = max(pre, key=lambda a: pre[a]["assigned"])
            res = c.drain_replica(victim)
            assert res.get("drained") and res["migrated"] >= 1, res
            _collect(c, rids, got)
            for i, r in enumerate(rids):
                assert got[r] == ref[i], f"stream {i}: dup/drop"
            post = router.stats()["replicas"]
            assert post[victim]["draining"]
            assert post[victim]["assigned"] == 0
        migs = reg.counter("tony_router_migrations_total").value
        assert 1 <= migs <= res["migrated"], (migs, res)
        assert reg.counter("tony_router_drains_total").value == 1
        assert reg.counter("tony_router_failovers_total").value == 0
    finally:
        _stop(router, servers)


def test_rolling_upgrade_by_weights_version(tp):
    """Stand a v2 tier up beside v1 (``add_replicas``), drain and remove
    v1 replica by replica while sessions stream: every session keeps
    exact token continuity, the fleet ends all-v2, and a fresh session
    serves on it."""
    old, old_addrs = _servers(tp, weights_version="v1")
    new, new_addrs = _servers(tp, weights_version="v2")
    reg = M.MetricsRegistry()
    router = ServingRouter(old_addrs, health_interval_s=0.2, registry=reg)
    prompts = _prompts(33, (5, 5, 4, 6))
    budget = 36
    try:
        rport = router.start()
        with StreamingClient("127.0.0.1", rport) as c:
            rids, got = _start_streams(c, prompts, budget)
            router.add_replicas(new_addrs)
            for addr in old_addrs:
                assert router.drain(addr).get("drained")
                assert router.remove_replica(addr) == 1
            _collect(c, rids, got)
            for i, r in enumerate(rids):
                assert got[r] == _reference(tp, prompts[i], budget), i
            post = router.stats()["replicas"]
            assert set(post) == set(new_addrs), post
            assert {v["weights_version"] for v in post.values()} == {"v2"}
            p = _prompts(34, (5,))[0]
            assert c.result(c.submit(p, 6), timeout=90) == (
                _reference(tp, p, 6), "budget")
        assert reg.counter("tony_router_drains_total").value == 2
    finally:
        _stop(router, old + new)


# ---------------------------------------------------------------------------
# TestDrainUnderLoad, on real replicas
# ---------------------------------------------------------------------------
def test_drain_storm_zero_dup_drop(tp):
    """Drain 2 of 4 replicas AT ONCE while 8 sessions stream: each
    session retires with its reference tokens and one terminal frame;
    the drained replicas end fenced and empty."""
    servers, addrs = _servers(tp, n=4, batch=4)
    reg = M.MetricsRegistry()
    router = ServingRouter(addrs, health_interval_s=0.2, registry=reg)
    prompts = _prompts(35, (5, 4, 6, 5, 3, 5, 4, 6))
    budget = 40
    try:
        rport = router.start()
        with StreamingClient("127.0.0.1", rport) as c:
            rids, got = _start_streams(c, prompts, budget)
            reps = router.stats()["replicas"]
            victims = sorted(reps, key=lambda a: -reps[a]["assigned"])[:2]
            results = {}
            drains = [threading.Thread(
                target=lambda a=a: results.update(
                    {a: c.drain_replica(a)}), daemon=True)
                for a in victims]
            for d in drains:
                d.start()
            for d in drains:
                d.join(timeout=90)
            for addr, res in results.items():
                assert res.get("drained"), f"{addr}: {res}"
            _collect(c, rids, got)
            for i, r in enumerate(rids):
                assert got[r] == _reference(tp, prompts[i], budget), i
            reps = c.stats()["replicas"]
            for addr in victims:
                assert reps[addr]["draining"] and \
                    reps[addr]["assigned"] == 0, addr
        assert sum(r["migrated"] for r in results.values()) > 0
        assert reg.counter("tony_router_drains_total").value == 2
    finally:
        _stop(router, servers)


def test_zero_session_drain_and_undrain(tp):
    servers, addrs = _servers(tp, slow=False)
    router = ServingRouter(addrs, registry=M.MetricsRegistry())
    try:
        router.start()
        t0 = time.monotonic()
        res = router.drain(addrs[0])
        assert res["drained"] and res["migrated"] == 0
        assert time.monotonic() - t0 < 2.0
        assert router.stats()["replicas"][addrs[0]]["draining"]
        # the fence holds: a new session lands on the other replica
        with StreamingClient("127.0.0.1", router.port) as c:
            p = _prompts(36, (4,))[0]
            c.result(c.submit(p, 3), timeout=90)
        assert servers[0].engine.b.steps_executed == 0
        router.undrain(addrs[0])
        assert not router.stats()["replicas"][addrs[0]]["draining"]
    finally:
        _stop(router, servers)


def test_drain_racing_target_crash(tp):
    """The drain's target crashes mid-drain: its sessions fall back to
    the crash failover and still retire with their reference tokens."""
    servers, addrs = _servers(tp, n=2, batch=4)
    router = ServingRouter(addrs, health_interval_s=0.2,
                           registry=M.MetricsRegistry())
    prompts = _prompts(37, (5, 5, 4, 6))
    budget = 40
    try:
        rport = router.start()
        with StreamingClient("127.0.0.1", rport) as c:
            rids, got = _start_streams(c, prompts, budget)
            reps = router.stats()["replicas"]
            victim = max(reps, key=lambda a: reps[a]["assigned"])
            box = {}
            d = threading.Thread(target=lambda: box.update(
                res=router.drain(victim)), daemon=True)
            d.start()
            servers[addrs.index(victim)].kill()
            d.join(timeout=90)
            _collect(c, rids, got)
            for i, r in enumerate(rids):
                assert got[r] == _reference(tp, prompts[i], budget), i
    finally:
        _stop(router, servers)


def test_cancel_mid_migration_single_terminal(tp):
    """A client MIGRATE then CANCEL while the migration is in flight:
    exactly one terminal frame, nothing after it."""
    servers, addrs = _servers(tp, n=2, batch=2)
    router = ServingRouter(addrs, health_interval_s=0.2,
                           registry=M.MetricsRegistry())
    try:
        rport = router.start()
        with StreamingClient("127.0.0.1", rport) as c:
            rid = c.submit(_prompts(38, (4,))[0], 56)
            assert c.next_event(rid, timeout=60)[0] == "tokens"
            c.migrate(rid)
            c.cancel(rid)
            terminals = []
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                try:
                    ev = c.next_event(rid, timeout=1.0)
                except queue.Empty:
                    if terminals:
                        break
                    continue
                if ev[0] != "tokens":
                    terminals.append(ev)
                else:
                    assert not terminals, ev
            assert len(terminals) == 1, terminals
            assert terminals[0][:2] == ("retired", "cancelled")
    finally:
        _stop(router, servers)


def test_remote_migrate_continues_token_identically(tp):
    """MIGRATE from a remote client moves one live session to the other
    replica; the stream continues with its reference tokens."""
    servers, addrs = _servers(tp, n=2, batch=2)
    reg = M.MetricsRegistry()
    router = ServingRouter(addrs, health_interval_s=0.2, registry=reg)
    p = _prompts(39, (5,))[0]
    try:
        rport = router.start()
        with StreamingClient("127.0.0.1", rport) as c:
            rid = c.submit(p, 40)
            ev = c.next_event(rid, timeout=60)
            assert ev[0] == "tokens"
            got = {rid: list(ev[1])}
            c.migrate(rid)
            _collect(c, [rid], got)
        assert got[rid] == _reference(tp, p, 40)
        assert reg.counter("tony_router_migrations_total").value >= 1
    finally:
        _stop(router, servers)


def test_stop_racing_drain_sweeps_sessions(tp):
    """router.stop() while a drain migrates live sessions: every session
    gets exactly one terminal frame, and a second stop is a no-op."""
    servers, addrs = _servers(tp, n=2, batch=4)
    router = ServingRouter(addrs, health_interval_s=0.2,
                           registry=M.MetricsRegistry())
    try:
        rport = router.start()
        c = StreamingClient("127.0.0.1", rport)
        rids, _ = _start_streams(c, _prompts(40, (5, 4, 6, 5)), 56)
        reps = router.stats()["replicas"]
        victim = max(reps, key=lambda a: reps[a]["assigned"])
        d = threading.Thread(target=lambda: router.drain(victim),
                             daemon=True)
        d.start()
        router.stop()
        router.stop()
        d.join(timeout=60)
        for r in rids:
            terminals = []
            while True:
                try:
                    ev = c.next_event(r, timeout=5)
                except Exception:
                    break
                if ev[0] != "tokens":
                    terminals.append(ev)
                    break
            assert len(terminals) == 1, (r, terminals)
        c.close()
    finally:
        _stop(None, servers)


def test_add_and_remove_replicas_live(tp):
    servers, addrs = _servers(tp, n=2, slow=False)
    router = ServingRouter(addrs[:1], registry=M.MetricsRegistry())
    try:
        rport = router.start()
        router.add_replicas(addrs[1:])
        assert set(router.stats()["replicas"]) == set(addrs)
        assert router.remove_replica(addrs[0]) == 1
        assert set(router.stats()["replicas"]) == set(addrs[1:])
        with StreamingClient("127.0.0.1", rport) as c:
            p = _prompts(41, (5,))[0]
            assert c.result(c.submit(p, 4), timeout=90)[0] == \
                _reference(tp, p, 4)
        assert servers[0].engine.b.steps_executed == 0
        assert servers[1].engine.b.steps_executed > 0
    finally:
        _stop(router, servers)


# ---------------------------------------------------------------------------
# Prefix-aware placement
# ---------------------------------------------------------------------------
def test_router_places_on_ring_replicas_prefix_blind(caplog):
    """A ring replica advertises ``ring``; the router warns ONCE, keeps
    placing on it (a prefix miss) and the session serves."""
    cfg = TCFG.scaled(attn_window=8, kv_cache_capacity=8)
    p = TT.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    server = ServingServer(TS.ContinuousBatcher(p, cfg, batch=2, max_len=32),
                           registry=M.MetricsRegistry())
    reg = M.MetricsRegistry()
    router = None
    try:
        addr = f"127.0.0.1:{server.start()}"
        router = ServingRouter([addr], registry=reg, health_interval_s=0.2)
        prefix = [1, 2, 3, 4]
        router.register_prefix(prefix, prefix_id="sys")
        with caplog.at_level(logging.WARNING,
                             "tony_tpu_torch.serving.router"):
            router.start()
        assert sum("ring" in r.getMessage() for r in caplog.records) == 1
        with StreamingClient("127.0.0.1", router.port) as c:
            out, reason = c.result(c.submit(prefix + [9, 9], 3),
                                   timeout=90)
        assert reason in ("eos", "budget") and len(out) == 3
        assert reg.counter("tony_router_prefix_misses_total").value == 1
        assert reg.counter("tony_router_prefix_hits_total").value == 0
    finally:
        if router is not None:
            router.stop()
        server.kill()


def test_sessions_go_where_the_prefix_is_resident(tp):
    """With the prefix resident on replica B only, every session that
    continues it lands on B (a prefix hit, suffix-only admission) even
    though A is as idle."""
    servers, addrs = _servers(tp, n=2, slow=False)
    reg = M.MetricsRegistry()
    router = ServingRouter(addrs, registry=reg, health_interval_s=0.1)
    prefix = _prompts(42, (12,))[0]
    try:
        pid = servers[1].install_prefix(prefix)
        router.register_prefix(prefix, prefix_id=pid)
        rport = router.start()
        with StreamingClient("127.0.0.1", rport) as c:
            sfx = _prompts(43, (3, 4, 5))
            outs = [c.result(c.submit(prefix + s, 4), timeout=90)[0]
                    for s in sfx]
        assert servers[0].engine.b.steps_executed == 0
        assert servers[1].engine.stats()["prefix_admits"] == 3
        assert reg.counter("tony_router_prefix_hits_total").value == 3
        for s, o in zip(sfx, outs):
            assert o == _reference(tp, prefix + s, 4)
    finally:
        _stop(router, servers)


def _fake_link(load, idle, assigned=0, prefixes=(), addr="x"):
    return types.SimpleNamespace(
        alive=True, role="engine", reported_load=load, idle_slots=idle,
        assigned=assigned, prefixes=set(prefixes), addr=addr,
        draining=False, weights_version=None)


def test_placement_order_residency_and_exclusion():
    """(TestRouterPlacement) load first, then idle slots, then the
    router's assignments; residency narrows the pool and falls back on
    a cold fleet; ``exclude`` takes a set; a draining link is fenced."""
    r = ServingRouter(["127.0.0.1:1"], registry=M.MetricsRegistry())
    busy = _fake_link(1, 4, addr="busy")
    few, many = _fake_link(0, 1, addr="few"), _fake_link(0, 3, addr="many")
    r._links = [busy, few, many]
    assert r._pick_link() is many
    busy.reported_load, busy.idle_slots = 0, 9
    assert r._pick_link() is busy
    r._links = [_fake_link(0, 2, 3, addr="a"), _fake_link(0, 2, 1, addr="b")]
    assert r._pick_link().addr == "b"
    cold = _fake_link(0, 4, addr="cold")
    warm = _fake_link(2, 1, prefixes={"sys"}, addr="warm")
    r._links = [cold, warm]
    assert r._pick_link(prefer_prefix="sys") is warm
    assert r._pick_link(prefer_prefix="nope") is cold
    a, b, c = (_fake_link(0, 4, addr="a"), _fake_link(0, 3, addr="b"),
               _fake_link(0, 2, addr="c"))
    r._links = [a, b, c]
    assert r._pick_link(exclude=(a, b)) is c
    assert r._pick_link(exclude=(a, b, c)) is None
    b.draining = True
    assert r._pick_link(exclude=(a,)) is c


def test_serving_package_exports_the_fleet_classes():
    from tony_tpu_torch import serving
    from tony_tpu_torch.serving import disagg
    assert serving.ServingRouter is ServingRouter
    assert serving.PrefillServer is disagg.PrefillServer
    assert serving.DecodeServer is disagg.DecodeServer
    assert serving.ServingServer is ServingServer
    with pytest.raises(AttributeError):
        serving.FleetController          # the next slice's


def test_router_keys_equal_the_jax_package_keys():
    from tony_tpu.conf import keys as JK
    from tony_tpu_torch.conf import keys as TK
    for n in ("ROUTER_HEALTH_INTERVAL_MS_KEY", "ROUTER_MAX_MISSED_PINGS_KEY"):
        assert getattr(TK, n) == getattr(JK, n)
        assert TK.ROUTER_DEFAULTS[getattr(TK, n)] == \
            JK.DEFAULTS[getattr(JK, n)]
    r = ServingRouter(["127.0.0.1:1"], registry=M.MetricsRegistry())
    j = JR.ServingRouter(["127.0.0.1:1"], registry=JM.MetricsRegistry())
    assert (r.health_interval_s, r.max_missed_pings) == \
        (j.health_interval_s, j.max_missed_pings)


# ---------------------------------------------------------------------------
# One fleet, two packages
# ---------------------------------------------------------------------------
class _JaxSlowFetch(JS.ContinuousBatcher):
    def _fetch(self, handle):
        time.sleep(0.05)
        return super()._fetch(handle)


@pytest.mark.parametrize("router_pkg", ["port", "jax"])
def test_jax_and_port_replicas_serve_one_fleet(pair, router_pkg):
    """A JAX ServingServer and a port ServingServer of the same weights
    (one ``tree_digest``) behind one router: both carry streams, every
    stream equals the JAX colocated engine's, and when one package's
    replica dies mid-stream (the port's behind the port router, the
    JAX's behind the JAX router) its sessions finish on the other
    package's with nothing duplicated or dropped."""
    jp, tp = pair
    kw = dict(batch=2, max_len=64, chunk=2)
    jsrv = JSRV.ServingServer(_JaxSlowFetch(jp, JCFG, **kw),
                              registry=JM.MetricsRegistry())
    tsrv = ServingServer(_SlowFetch(tp, TCFG, **kw),
                         registry=M.MetricsRegistry())
    addrs = [f"127.0.0.1:{jsrv.start()}", f"127.0.0.1:{tsrv.start()}"]
    if router_pkg == "port":
        router = ServingRouter(addrs, health_interval_s=0.2,
                               registry=M.MetricsRegistry())
        victim = tsrv
    else:
        router = JR.ServingRouter(addrs, health_interval_s=0.2,
                                  registry=JM.MetricsRegistry())
        victim = jsrv
    prompts = _prompts(50, (5, 5, 4, 6))
    budget = 36
    want = JS.ContinuousBatcher(jp, JCFG, **kw).serve(prompts, budget)
    try:
        rport = router.start()
        with StreamingClient("127.0.0.1", rport) as c:
            reps = c.stats()["replicas"]
            assert len({v["weights_digest"] for v in reps.values()}) == 1
            rids, got = _start_streams(c, prompts, budget)
            pre = router.stats()["replicas"]
            assert all(v["assigned"] > 0 for v in pre.values()), pre
            victim.kill()
            _collect(c, rids, got)
        outs = [got[r] for r in rids]
        for i, (o, w) in enumerate(zip(outs, want)):
            assert len(o) == budget, i          # nothing dropped or doubled
            if o != w:                          # a near-tie, 1e-4
                j = next(t for t, (a, b) in enumerate(zip(o, w)) if a != b)
                lg, _ = TD.prefill(tp, torch.tensor([prompts[i] + w[:j]]),
                                   TCFG, max_len=len(prompts[i]) + j)
                assert abs(float(lg[0, w[j]] - lg[0, o[j]])) <= 1e-4, (i, j)
    finally:
        router.stop()
        jsrv.stop()
        tsrv.stop()
