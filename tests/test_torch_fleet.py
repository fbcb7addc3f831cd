"""tony_tpu_torch's fleet operations against the JAX package's.

Port twins of ``tests/test_fleet.py`` on the port's ``SimFleet`` (a real
port ``ServingRouter`` and real sockets in front of ``sim_token``-oracle
replicas, no model stack):

- planned drains under live load, one at a time and three at once, a
  drain racing its target's crash, a cancel mid-migration and a stop
  racing a drain: no token duplicated or dropped, exactly one terminal
  frame per stream;
- a rolling upgrade by ``weights_version`` and the warm path with its
  only seeder killed mid-ship (one storage load, then peer fan-out);
- the controller's hysteresis, cooldown and scale-down by drain, and
  autoscale against the simulated fleet; the 100-replica storm is slow,
  as in the reference.

Then what only a port beside the JAX package can show: ``sim_token`` and
the simulated replica's HELLO and STATS equal the JAX package's; one
scripted load through the JAX and the port ``FleetController`` gives the
same actions and gauges tick for tick; a JAX ``ServingServer`` and a port
``ServingServer`` of one digest under either package's controller, one
drained by a scale-down and its streams finished on the other, equal to
the JAX colocated engine's; and ``SubprocessProvider`` reading a chatty
child to its end (the JAX package's stops reading at the address, so a
replica that logs more than the pipe holds blocks in its next write).
"""

import queue
import random
import sys
import threading
import time

import numpy as np
import pytest

from tony_tpu.serving import fleet as JF
from tony_tpu.serving import simfleet as JSIM
from tony_tpu.runtime import metrics as JM
from tony_tpu_torch.runtime import metrics as M
from tony_tpu_torch.runtime.metrics import MetricsRegistry
from tony_tpu_torch.serving.client import StreamingClient
from tony_tpu_torch.serving.fleet import (CapacityProvider, FleetController,
                                          SubprocessProvider)
from tony_tpu_torch.serving.simfleet import (SimFleet, SimProvider,
                                             SimReplica, sim_token)

pytestmark = pytest.mark.fleet_sim


def _oracle(seed, n):
    return [sim_token(seed, p) for p in range(n)]


def _pump(client, rid, out, timeout=60.0):
    """Collect every event for ``rid`` until its FIRST terminal frame,
    then linger briefly to catch any duplicate terminal (there must be
    none). Stores ``(tokens, terminals)``."""
    toks, terminals = [], []
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            ev = client.next_event(rid, timeout=5.0)
        except queue.Empty:
            continue
        if ev[0] == "tokens":
            toks.extend(ev[1])
        else:
            terminals.append(ev)
            break
    try:
        terminals.append(client.next_event(rid, timeout=0.2))
    except queue.Empty:
        pass
    out[rid] = (toks, terminals)


def _launch_streams(client, n, max_new, out, prompt_len=4):
    seeds, threads = {}, []
    for i in range(n):
        seed = 1000 + 17 * i
        rid = client.submit([seed] + list(range(1, prompt_len)), max_new)
        seeds[rid] = seed
        t = threading.Thread(target=_pump, args=(client, rid, out),
                             daemon=True)
        t.start()
        threads.append(t)
    return seeds, threads


def _wait_spread(client, deadline_s=30.0):
    """Block until every replica holds at least one session."""
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        reps = client.stats()["replicas"]
        if reps and all(r["assigned"] > 0 for r in reps.values()):
            return reps
        time.sleep(0.01)
    raise AssertionError("streams never spread across the fleet")


def _assert_exact(out, seeds, max_new, reason="budget"):
    for rid, (toks, terminals) in out.items():
        assert len(terminals) == 1, \
            f"rid {rid}: expected exactly one terminal, got {terminals}"
        assert terminals[0][0] == "retired" and terminals[0][1] == reason, \
            f"rid {rid}: unexpected terminal {terminals[0]}"
        assert toks == _oracle(seeds[rid], max_new), \
            f"rid {rid}: token dup/drop across migration"


# ---------------------------------------------------------------------------
# The simulated replica equals the JAX package's
# ---------------------------------------------------------------------------
def test_sim_token_equals_the_jax_package():
    rng = np.random.RandomState(18)
    seeds = [0, 1, 1000, 0x3FFFFF, 0x400000, 2**31 - 1]
    seeds += [int(s) for s in rng.randint(0, 2**31 - 1, size=40)]
    positions = list(range(0, 130)) + [int(p) for p in
                                       rng.randint(0, 1 << 20, size=40)]
    for s in seeds:
        for p in positions:
            assert sim_token(s, p) == JSIM.sim_token(s, p), (s, p)


@pytest.mark.parametrize("version", [None, "v2"])
def test_sim_replica_hello_and_stats_equal_the_jax_package(version):
    reps = [SimReplica(slots=3, weights_version=version),
            JSIM.SimReplica(slots=3, weights_version=version)]
    try:
        seen = []
        for rep in reps:
            port = rep.start()
            with StreamingClient("127.0.0.1", port) as c:
                rid = c.submit([77, 1, 2], 5)
                toks, reason = c.result(rid)
                seen.append((c.hello, c.stats(), toks, reason))
        assert seen[0] == seen[1]
        assert seen[0][2] == _oracle(77, 5) and seen[0][3] == "budget"
    finally:
        for rep in reps:
            rep.stop()


# ---------------------------------------------------------------------------
# Drains under live load (tests/test_fleet.py::TestDrainUnderLoad)
# ---------------------------------------------------------------------------
class TestDrainUnderLoad:
    def test_drain_storm_zero_dup_drop(self):
        """Drain 3 of 8 replicas AT ONCE while 16 sessions stream."""
        reg = MetricsRegistry()
        fleet = SimFleet(8, itl_s=0.002, slots=16, registry=reg)
        out = {}
        try:
            port = fleet.start()
            with StreamingClient("127.0.0.1", port) as client:
                seeds, threads = _launch_streams(client, 16, 80, out)
                reps = _wait_spread(client)
                victims = sorted(reps,
                                 key=lambda a: -reps[a]["assigned"])[:3]
                results = {}

                def do_drain(addr):
                    results[addr] = client.drain_replica(addr)

                drains = [threading.Thread(target=do_drain, args=(a,),
                                           daemon=True) for a in victims]
                for d in drains:
                    d.start()
                for d in drains:
                    d.join(timeout=60)
                for addr, res in results.items():
                    assert res.get("drained"), f"{addr}: {res}"
                for t in threads:
                    t.join(timeout=60)
                _assert_exact(out, seeds, 80)
                reps = client.stats()["replicas"]
                for addr in victims:
                    assert reps[addr]["draining"], addr
                    assert reps[addr]["assigned"] == 0, addr
            assert sum(r["migrated"] for r in results.values()) > 0
            assert reg.counter("tony_router_migrations_total").value > 0
            assert reg.counter("tony_router_drains_total").value == 3
        finally:
            fleet.stop()

    def test_zero_session_drain_immediate(self):
        fleet = SimFleet(2, registry=MetricsRegistry())
        try:
            fleet.start()
            addr = fleet.addrs()[0]
            t0 = time.monotonic()
            res = fleet.router.drain(addr)
            assert res["drained"] and res["migrated"] == 0
            assert time.monotonic() - t0 < 2.0
            assert fleet.router.stats()["replicas"][addr]["draining"]
            fleet.router.undrain(addr)
            assert not fleet.router.stats()["replicas"][addr]["draining"]
        finally:
            fleet.stop()

    def test_drain_racing_target_crash(self):
        """The drain target crashes mid-drain: its sessions fall back to
        crash failover and still retire with the exact oracle tokens."""
        fleet = SimFleet(4, itl_s=0.004, slots=16,
                         registry=MetricsRegistry())
        out = {}
        try:
            port = fleet.start()
            with StreamingClient("127.0.0.1", port) as client:
                seeds, threads = _launch_streams(client, 8, 60, out)
                reps = _wait_spread(client)
                victim = max(reps, key=lambda a: reps[a]["assigned"])
                res_box = {}

                def do_drain():
                    res_box["res"] = client.drain_replica(victim)

                d = threading.Thread(target=do_drain, daemon=True)
                d.start()
                fleet.kill(victim)
                d.join(timeout=60)
                for t in threads:
                    t.join(timeout=60)
                _assert_exact(out, seeds, 60)
        finally:
            fleet.stop()

    def test_cancel_mid_migration_single_terminal(self):
        fleet = SimFleet(3, itl_s=0.01, slots=8,
                         registry=MetricsRegistry())
        try:
            port = fleet.start()
            with StreamingClient("127.0.0.1", port) as client:
                rid = client.submit([4242, 1, 2, 3], 400)
                ev = client.next_event(rid, timeout=30)
                assert ev[0] == "tokens"
                client.migrate(rid)
                client.cancel(rid)
                terminals = []
                deadline = time.monotonic() + 30
                while time.monotonic() < deadline:
                    try:
                        ev = client.next_event(rid, timeout=1.0)
                    except queue.Empty:
                        if terminals:
                            break
                        continue
                    if ev[0] != "tokens":
                        terminals.append(ev)
                assert len(terminals) == 1, terminals
                assert terminals[0][:2] == ("retired", "cancelled")
        finally:
            fleet.stop()

    def test_stop_racing_drain_sweeps_sessions(self):
        fleet = SimFleet(4, itl_s=0.01, slots=8,
                         registry=MetricsRegistry())
        out = {}
        try:
            port = fleet.start()
            with StreamingClient("127.0.0.1", port) as client:
                seeds, threads = _launch_streams(client, 8, 400, out)
                reps = _wait_spread(client)
                victim = max(reps, key=lambda a: reps[a]["assigned"])
                res_box = {}

                def do_drain():
                    try:
                        res_box["res"] = fleet.router.drain(victim)
                    except Exception as e:   # noqa: BLE001
                        res_box["err"] = e

                d = threading.Thread(target=do_drain, daemon=True)
                d.start()
                time.sleep(0.05)
                fleet.router.stop()
                fleet.router.stop()          # idempotent double-stop
                d.join(timeout=30)
                assert "err" not in res_box, res_box
                for t in threads:
                    t.join(timeout=30)
                for rid, (_, terminals) in out.items():
                    assert terminals and terminals[0][0] == "error", \
                        (rid, terminals)
                    for extra in terminals[1:]:
                        assert extra == ("error",
                                         "connection closed by server"), \
                            (rid, terminals)
        finally:
            fleet.stop()


# ---------------------------------------------------------------------------
# Rolling upgrade and the warm path
# ---------------------------------------------------------------------------
class TestRollingUpgrade:
    def test_upgrade_token_continuity(self):
        reg = MetricsRegistry()
        fleet = SimFleet(2, itl_s=0.004, slots=16,
                         weights_version="v1", registry=reg)
        out = {}
        try:
            port = fleet.start()
            ctrl = FleetController(fleet.router, SimProvider(fleet),
                                   registry=reg)
            with StreamingClient("127.0.0.1", port) as client:
                seeds, threads = _launch_streams(client, 6, 80, out)
                _wait_spread(client)
                old = fleet.router.stats()["replicas"]
                new_addrs = [fleet.spawn(weights_version="v2")
                             for _ in range(2)]
                results = ctrl.rolling_upgrade(new_addrs)
                for addr, res in results.items():
                    assert res.get("drained"), (addr, res)
                for t in threads:
                    t.join(timeout=60)
                _assert_exact(out, seeds, 80)
                reps = client.stats()["replicas"]
                assert set(reps) == set(new_addrs)
                assert all(r["weights_version"] == "v2"
                           for r in reps.values())
                assert set(old).isdisjoint(reps)
                assert set(old).isdisjoint(fleet.addrs())   # released
                rid = client.submit([7, 1, 2, 3], 5)
                toks, reason = client.result(rid)
                assert reason == "budget" and toks == _oracle(7, 5)
            assert reg.counter("tony_fleet_upgrades_total").value == 1
        finally:
            fleet.stop()


class TestWarmScaleUp:
    def test_seeder_crash_mid_ship_falls_back_to_storage(self):
        """The upgrade's ONLY seeder is killed mid-ship: one storage
        load mints a fresh seeder, which fans out to the rest."""
        from tony_tpu_torch.serving.simfleet import SimWarmer

        reg = MetricsRegistry()
        fleet = SimFleet(2, itl_s=0.004, slots=16,
                         weights_version="v1", registry=reg)
        out = {}
        try:
            port = fleet.start()
            doomed = fleet.spawn(weights_version="v2")
            warmer = SimWarmer(fleet, "v2", seeders=[doomed],
                               ship_s=0.3, load_s=0.05)
            ctrl = FleetController(fleet.router, SimProvider(fleet),
                                   registry=reg, warmer=warmer)
            with StreamingClient("127.0.0.1", port) as client:
                seeds, threads = _launch_streams(client, 4, 60, out)
                _wait_spread(client)
                new_addrs = [fleet.spawn(weights_version=None)
                             for _ in range(4)]
                killer = threading.Timer(0.1, fleet.kill, args=(doomed,))
                killer.start()
                results = ctrl.rolling_upgrade(new_addrs)
                killer.join()
                for addr, res in results.items():
                    assert res.get("drained"), (addr, res)
                warm = ctrl.last_warm
                assert warm is not None and not warm["failed"], warm
                assert warmer.loads == 1
                assert len(warm["fallback"]) == 1
                assert len(warm["warmed"]) == 3
                for t in threads:
                    t.join(timeout=60)
                _assert_exact(out, seeds, 60)
                reps = client.stats()["replicas"]
                assert set(reps) == set(new_addrs)
                assert all(r["weights_version"] == "v2"
                           for r in reps.values())
                rid = client.submit([7, 1, 2, 3], 5)
                toks, reason = client.result(rid)
                assert reason == "budget" and toks == _oracle(7, 5)
        finally:
            fleet.stop()

    def test_unwarmable_targets_are_released_not_admitted(self):
        """A warm pass with no seeder and no fallback fails every target:
        the controller releases them and routes nothing at them."""
        from tony_tpu_torch.serving.simfleet import SimWarmer

        reg = MetricsRegistry()
        fleet = SimFleet(1, slots=4, registry=reg)
        try:
            fleet.start()
            warmer = SimWarmer(fleet, "v2", fallback=False)
            ctrl = FleetController(fleet.router, SimProvider(fleet),
                                   hysteresis_ticks=1, registry=reg,
                                   up_queue_per_replica=-1.0,
                                   warmer=warmer)
            assert ctrl.tick() == "up"
            assert ctrl.last_warm["failed"] and not ctrl.last_warm["warmed"]
            assert len(fleet.addrs()) == 1
            assert len(fleet.router.stats()["replicas"]) == 1
            assert reg.counter("tony_fleet_scale_ups_total").value == 1
        finally:
            fleet.stop()


# ---------------------------------------------------------------------------
# The controller (tests/test_fleet.py::TestFleetController)
# ---------------------------------------------------------------------------
class _ScriptedRouter:
    """stats()-only stand-in driving FleetController.tick()
    deterministically: each tick() observes the next scripted (load,
    active[, queue_depths]) entry over a fleet of 4 replicas of 16
    slots, plus whatever the controller added or removed."""

    def __init__(self, script):
        self._script = list(script)
        self._i = 0
        self.added, self.removed, self.drained = [], [], []

    def stats(self):
        entry = self._script[min(self._i, len(self._script) - 1)]
        load, active = entry[:2]
        self._i += 1
        n = 4 + len(self.added) - len(self.removed)
        rep = {"up": 1, "reported_load": load,
               "assigned": active // max(n, 1), "draining": False}
        if len(entry) > 2:
            rep["queue_depths"] = dict(entry[2])
        return {"active": active, "slots": 16 * n,
                "replicas": {f"r{i}": dict(rep) for i in range(n)}}

    def add_replicas(self, addrs, role=None):
        self.added.extend(addrs)

    def remove_replica(self, addr):
        self.removed.append(addr)

    def drain(self, addr, timeout_s=None):
        self.drained.append(addr)
        return {"drained": True, "migrated": 0}


class _CountingProvider(CapacityProvider):
    def __init__(self):
        self.grown, self.released = 0, []

    def grow(self, n):
        addrs = [f"new{self.grown + i}" for i in range(n)]
        self.grown += n
        return addrs

    def release(self, addrs):
        self.released.extend(addrs)


class TestFleetController:
    def test_no_flap_on_oscillating_load(self):
        script = [(8.0, 60) if i % 2 == 0 else (1.0, 30)
                  for i in range(40)]
        router = _ScriptedRouter(script)
        provider = _CountingProvider()
        ctrl = FleetController(router, provider, hysteresis_ticks=3,
                               cooldown_ticks=5,
                               registry=MetricsRegistry())
        actions = [ctrl.tick() for _ in range(40)]
        assert set(actions) == {"hold"}, actions
        assert provider.grown == 0 and not router.drained

    def test_sustained_pressure_scales_once_then_cools(self):
        router = _ScriptedRouter([(8.0, 60)] * 20)
        provider = _CountingProvider()
        reg = MetricsRegistry()
        ctrl = FleetController(router, provider, hysteresis_ticks=3,
                               cooldown_ticks=10, registry=reg)
        actions = [ctrl.tick() for _ in range(12)]
        assert actions.count("up") == 1, actions
        assert actions.index("up") == 2
        assert provider.grown == 1
        assert reg.counter("tony_fleet_scale_ups_total").value == 1

    def test_sustained_idle_scales_down_via_drain(self):
        router = _ScriptedRouter([(0.5, 2)] * 10)
        provider = _CountingProvider()
        reg = MetricsRegistry()
        ctrl = FleetController(router, provider, min_replicas=1,
                               hysteresis_ticks=3, cooldown_ticks=10,
                               down_utilization=0.3, registry=reg)
        actions = [ctrl.tick() for _ in range(4)]
        assert actions.count("down") == 1, actions
        assert len(router.drained) == 1
        assert router.removed == router.drained
        assert provider.released == router.drained
        assert reg.counter("tony_fleet_scale_downs_total").value == 1

    def test_autoscale_against_simfleet(self):
        reg = MetricsRegistry()
        fleet = SimFleet(2, itl_s=0.005, slots=4, registry=reg)
        try:
            port = fleet.start()
            ctrl = FleetController(
                fleet.router, SimProvider(fleet), min_replicas=2,
                max_replicas=3, up_queue_per_replica=2.0,
                down_utilization=0.3, hysteresis_ticks=2,
                cooldown_ticks=2, drain_timeout_s=30, registry=reg)
            with StreamingClient("127.0.0.1", port) as client:
                rids = [client.submit([50 + i, 1], 300) for i in range(8)]
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline:
                    if ctrl._observe()[1] > 2.0:
                        break
                    time.sleep(0.05)
                actions = [ctrl.tick() for _ in range(3)]
                assert "up" in actions, actions
                assert len(fleet.router.stats()["replicas"]) == 3
                assert len(fleet.addrs()) == 3
                for rid in rids:
                    client.cancel(rid)
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline:
                    n, load, util = ctrl._observe()
                    if util < 0.3 and load < 2.0:
                        break
                    time.sleep(0.05)
                actions = []
                for _ in range(8):
                    actions.append(ctrl.tick())
                    if "down" in actions:
                        break
                assert "down" in actions, actions
                assert len(fleet.router.stats()["replicas"]) == 2
                assert len(fleet.addrs()) == 2
            assert reg.gauge("tony_fleet_replicas").value == 3
        finally:
            fleet.stop()

    def test_timer_loop_ticks_until_stopped(self):
        router = _ScriptedRouter([(8.0, 60)] * 400)
        provider = _CountingProvider()
        reg = MetricsRegistry()
        ctrl = FleetController(router, provider, hysteresis_ticks=2,
                               cooldown_ticks=1000, interval_s=0.01,
                               registry=reg)
        ctrl.start()
        deadline = time.monotonic() + 10
        while provider.grown == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        ctrl.stop()
        assert not ctrl._thread.is_alive()
        assert provider.grown == 1 and router.added == ["new0"]
        assert reg.gauge("tony_fleet_load_per_replica").value == 8.0


# ---------------------------------------------------------------------------
# One script through both packages' controllers
# ---------------------------------------------------------------------------
_SCRIPTS = {
    "oscillating": [(8.0, 60) if i % 2 == 0 else (1.0, 30)
                    for i in range(30)],
    "spike-then-idle": ([(9.0, 64)] * 6 + [(0.5, 3)] * 24
                        + [(7.0, 60)] * 10),
    "classed": ([(52.0, 8, {"interactive": 0, "standard": 0,
                            "batch": 48})] * 8
                + [(52.0, 8, {"interactive": 40, "standard": 4,
                              "batch": 4})] * 8
                + [(1.0, 2, {"interactive": 0, "standard": 0,
                             "batch": 0})] * 20),
}

_GAUGES = ("tony_fleet_replicas", "tony_fleet_load_per_replica")
_COUNTERS = ("tony_fleet_scale_ups_total", "tony_fleet_scale_downs_total",
             "tony_fleet_upgrades_total")


def _drive(pkg, script):
    ctrl_cls, reg = ((FleetController, M.MetricsRegistry()) if pkg == "port"
                     else (JF.FleetController, JM.MetricsRegistry()))
    router, provider = _ScriptedRouter(script), _CountingProvider()
    ctrl = ctrl_cls(router, provider, min_replicas=2, max_replicas=6,
                    up_queue_per_replica=6.0, down_utilization=0.3,
                    hysteresis_ticks=3, cooldown_ticks=4, registry=reg)
    ticks = []
    for _ in range(len(script)):
        action = ctrl.tick()
        ticks.append((action,) + tuple(reg.gauge(g).value
                                       for g in _GAUGES))
    return dict(ticks=ticks,
                counters=[reg.counter(c).value for c in _COUNTERS],
                added=router.added, removed=router.removed,
                drained=router.drained, grown=provider.grown,
                released=provider.released)


@pytest.mark.parametrize("script", sorted(_SCRIPTS))
def test_scripted_load_gives_the_jax_controllers_actions(script):
    port = _drive("port", _SCRIPTS[script])
    jax_ = _drive("jax", _SCRIPTS[script])
    assert port == jax_
    actions = [t[0] for t in port["ticks"]]
    if script == "oscillating":
        assert set(actions) == {"hold"}
    else:
        assert "up" in actions and "down" in actions, actions


# ---------------------------------------------------------------------------
# One fleet, two packages, under either package's controller
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pair():
    import jax
    import torch
    from tony_tpu.models import transformer as JT
    from tony_tpu_torch.models.weights import params_from_numpy
    torch.set_num_threads(2)
    jcfg = JT.PRESETS["tiny"].scaled(dtype=jax.numpy.float32, remat=False)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_numpy(jax.device_get(jp), device="cpu")


class _InProcessProvider:
    """A provider over servers already running in this process: release
    stops the server behind the address."""

    def __init__(self, servers):
        self.servers = dict(servers)
        self.released = []

    def grow(self, n):
        raise AssertionError("this drill only scales down")

    def release(self, addrs):
        for addr in addrs:
            self.released.append(addr)
            self.servers.pop(addr).stop()


@pytest.mark.parametrize("ctrl_pkg", ["port", "jax"])
def test_jax_and_port_replicas_scale_down_under_one_controller(pair,
                                                              ctrl_pkg):
    """A JAX and a port ServingServer of one ``tree_digest`` behind one
    router (the controller's package's): a scale-down drains the
    least-loaded replica mid-stream, retires and releases it, and its
    streams finish on the other package's replica, every stream equal to
    the JAX colocated engine's (a near-tie within 1e-4 excepted)."""
    import jax.numpy as jnp
    import torch
    from tony_tpu.models import serve as JS
    from tony_tpu.models import transformer as JT
    from tony_tpu.serving import router as JR
    from tony_tpu.serving import server as JSRV
    from tony_tpu_torch.models import decode as TD
    from tony_tpu_torch.models import serve as TS
    from tony_tpu_torch.models import transformer as TT
    from tony_tpu_torch.serving.router import ServingRouter
    from tony_tpu_torch.serving.server import ServingServer

    jp, tp = pair
    jcfg = JT.PRESETS["tiny"].scaled(dtype=jnp.float32, remat=False)
    tcfg = TT.PRESETS["tiny"].scaled(dtype=torch.float32, remat=False)

    class JaxSlow(JS.ContinuousBatcher):
        def _fetch(self, handle):
            time.sleep(0.08)              # keep streams mid-flight
            return super()._fetch(handle)

    class PortSlow(TS.ContinuousBatcher):
        def _fetch(self, handle):
            time.sleep(0.08)
            return super()._fetch(handle)

    kw = dict(batch=2, max_len=64, chunk=2)
    jsrv = JSRV.ServingServer(JaxSlow(jp, jcfg, **kw),
                              registry=JM.MetricsRegistry())
    tsrv = ServingServer(PortSlow(tp, tcfg, **kw),
                         registry=M.MetricsRegistry())
    servers = {f"127.0.0.1:{jsrv.start()}": jsrv,
               f"127.0.0.1:{tsrv.start()}": tsrv}
    pkg_of = {a: ("jax" if s is jsrv else "port")
              for a, s in servers.items()}
    if ctrl_pkg == "port":
        reg = M.MetricsRegistry()
        router = ServingRouter(list(servers), health_interval_s=0.2,
                               registry=reg)
        ctrl_cls = FleetController
    else:
        reg = JM.MetricsRegistry()
        router = JR.ServingRouter(list(servers), health_interval_s=0.2,
                                  registry=reg)
        ctrl_cls = JF.FleetController
    provider = _InProcessProvider(servers)
    drains, plain_drain = [], router.drain

    def drain(addr, timeout_s=120.0):
        drains.append(plain_drain(addr, timeout_s=timeout_s))
        return drains[-1]

    router.drain = drain
    # down_utilization above 1: the drill scales down with streams live
    ctrl = ctrl_cls(router, provider, min_replicas=1, max_replicas=2,
                    up_queue_per_replica=1e9, down_utilization=2.0,
                    hysteresis_ticks=1, cooldown_ticks=0,
                    drain_timeout_s=60, registry=reg)
    rs = np.random.RandomState(50)
    prompts = [[int(t) for t in rs.randint(0, tcfg.vocab_size, size=n)]
               for n in (5, 5, 4, 6)]
    budget = 36
    want = JS.ContinuousBatcher(jp, jcfg, **kw).serve(prompts, budget)
    try:
        rport = router.start()
        with StreamingClient("127.0.0.1", rport) as c:
            reps = c.stats()["replicas"]
            assert len({v["weights_digest"] for v in reps.values()}) == 1
            rids = [c.submit(p, budget) for p in prompts]
            got = {r: [] for r in rids}
            deadline = time.monotonic() + 90
            while not all(got.values()) and time.monotonic() < deadline:
                for r in rids:              # every stream mid-flight
                    if not got[r]:
                        try:
                            ev = c.next_event(r, timeout=0.01)
                        except queue.Empty:
                            continue
                        assert ev[0] == "tokens", ev
                        got[r].extend(ev[1])
            while time.monotonic() < deadline:
                reps = router.stats()["replicas"]
                if all(v["assigned"] > 0 for v in reps.values()) and \
                        all(v["reported_load"] > 0 for v in reps.values()):
                    break
                time.sleep(0.02)
            assert ctrl.tick() == "down"
            (victim,) = provider.released
            survivor = next(a for a in pkg_of if a != victim)
            assert set(router.stats()["replicas"]) == {survivor}
            for r in rids:
                while True:
                    ev = c.next_event(r, timeout=90)
                    if ev[0] == "tokens":
                        got[r].extend(ev[1])
                    else:
                        assert ev[:2] == ("retired", "budget"), ev
                        break
            for r in rids:                # one terminal frame each
                with pytest.raises(queue.Empty):
                    c.next_event(r, timeout=0.2)
        assert reg.counter("tony_fleet_scale_downs_total").value == 1
        assert len(drains) == 1 and drains[0]["drained"], drains
        assert drains[0]["migrated"] >= 1, drains
        outs = [got[r] for r in rids]
        for i, (o, w) in enumerate(zip(outs, want)):
            assert len(o) == budget, i
            if o != w:                    # a near-tie, 1e-4
                j = next(t for t, (a, b) in enumerate(zip(o, w)) if a != b)
                lg, _ = TD.prefill(tp, torch.tensor([prompts[i] + w[:j]]),
                                   tcfg, max_len=len(prompts[i]) + j)
                assert abs(float(lg[0, w[j]] - lg[0, o[j]])) <= 1e-4, (i, j)
        assert {pkg_of[victim], pkg_of[survivor]} == {"jax", "port"}
    finally:
        router.stop()
        for srv in provider.servers.values():
            srv.stop()


# ---------------------------------------------------------------------------
# SubprocessProvider: a chatty child never blocks
# ---------------------------------------------------------------------------
_CHATTY = r"""
import socket, sys
s = socket.socket()
s.bind(("127.0.0.1", 0))
s.listen(4)
print(f"serving stub on 127.0.0.1:{s.getsockname()[1]}", flush=True)
line = "x" * 1023 + "\n"
for _ in range(256):                       # 256 KiB to each stream
    sys.stdout.write(line)
    sys.stderr.write(line)
sys.stdout.flush()
sys.stderr.flush()
print("done writing", flush=True)
while True:
    c, _ = s.accept()
    c.sendall(b"pong")
    c.close()
"""


def test_subprocess_provider_drains_a_chatty_replica():
    """The child prints its address, then 256 KiB to stdout and stderr
    (four times what a pipe holds), and must still answer a probe: the
    provider reads its output to the end on a thread of its own."""
    import socket
    provider = SubprocessProvider([sys.executable, "-c", _CHATTY],
                                  spawn_timeout_s=30)
    (addr,) = provider.grow(1)
    proc, out = provider._procs[addr]
    try:
        host, port = addr.rsplit(":", 1)
        with socket.create_connection((host, int(port)), timeout=10) as s:
            s.settimeout(10)
            assert s.recv(4) == b"pong"
        deadline = time.monotonic() + 10
        while "done writing" not in out.tail() \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert "done writing" in out.tail()
        assert proc.poll() is None
    finally:
        provider.release([addr])
    assert proc.poll() is not None
    assert not out.thread.is_alive()
    assert provider._procs == {}
    provider.release([addr])              # a second release is a no-op


@pytest.mark.parametrize("child", ["silent", "exits"])
def test_subprocess_provider_raises_without_an_address(child):
    code = ("import time; print('booting', flush=True); time.sleep(60)"
            if child == "silent" else
            "import sys; print('no card here', flush=True); sys.exit(3)")
    provider = SubprocessProvider([sys.executable, "-c", code],
                                  spawn_timeout_s=1.5)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="printed no address") as ei:
        provider.grow(1)
    assert time.monotonic() - t0 < 15
    assert ("booting" if child == "silent" else "no card here") \
        in str(ei.value)
    if child == "exits":
        assert "exit code 3" in str(ei.value)
    assert provider._procs == {}


# ---------------------------------------------------------------------------
# The 100-replica storm (slow, as in the reference)
# ---------------------------------------------------------------------------
@pytest.mark.slow
class TestStorm:
    def test_100_replica_drain_storm_with_chaos(self):
        rng = random.Random(0xF1EE7)
        reg = MetricsRegistry()
        fleet = SimFleet(100, itl_s=0.005, slots=8,
                         health_interval_s=0.2, registry=reg)
        out = {}
        try:
            port = fleet.start()
            with StreamingClient("127.0.0.1", port) as client:
                seeds, threads = _launch_streams(client, 150, 60, out)
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline:
                    reps = client.stats()["replicas"]
                    if sum(r["assigned"] for r in reps.values()) >= 150:
                        break
                    time.sleep(0.02)
                reps = client.stats()["replicas"]
                by_load = sorted(reps, key=lambda a: -reps[a]["assigned"])
                victims = by_load[:30]
                crash = rng.sample(by_load[30:], 5)
                results = {}

                def do_drain(addr):
                    results[addr] = client.drain_replica(addr,
                                                         timeout_s=120)

                drains = [threading.Thread(target=do_drain, args=(a,),
                                           daemon=True)
                          for a in victims]
                for d in drains:
                    d.start()
                for addr in crash:
                    time.sleep(rng.uniform(0.0, 0.05))
                    fleet.kill(addr)
                for d in drains:
                    d.join(timeout=180)
                assert all(r.get("drained") for r in results.values()), \
                    {a: r for a, r in results.items()
                     if not r.get("drained")}
                for t in threads:
                    t.join(timeout=180)
                assert len(out) == 150
                budget_done = 0
                for rid, (toks, terminals) in out.items():
                    assert len(terminals) == 1, (rid, terminals)
                    kind = terminals[0][0]
                    assert kind in ("retired", "error"), terminals[0]
                    if kind == "retired" and terminals[0][1] == "budget":
                        budget_done += 1
                        assert toks == _oracle(seeds[rid], 60), \
                            f"rid {rid}: dup/drop under storm"
                assert budget_done >= 140, budget_done
            h = reg.histogram("tony_router_place_seconds")
            assert h.count >= 150
            p99 = JM.histogram_quantile(h, 0.99)
            assert p99 <= 2.5, (p99, h.cumulative())
        finally:
            fleet.stop()
