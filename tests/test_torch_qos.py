"""tony_tpu_torch's QoS serving engine vs the JAX package's.

``tiny`` in f32 with the JAX parameters converted to torch. One
submission script (requests of every class arriving at fixed points of
the loop: the script submits from inside the batcher's fetch, on the
engine's own thread, so both engines see the same arrivals at the same
chunk) drives the JAX engine and the port's; they must make the same
admission waves (row, stream, prompt length — a preempted batch
request's stream is admitted twice, its prompt grown by the tokens it
had), the same number of preemptions and the same tokens, greedy and
sampled, pipelined and sequential, with and without class floors
(exact equality throughout).

Then the invariants of ``tests/test_qos.py`` that hold without the
prefix and weights lanes, on the port's engine alone: floor and class
validation, the BUSY shed past ``max_queue_depth`` with interactive
exempt, and a preempted batch stream resuming token-identically to its
uninterrupted run, greedy and sampled.

Last, the fleet cases: the port's router over the port's ``SimFleet``
(interactive placement on idle slots, the batch re-queue cap then BUSY,
a client's retries healing on one replica, the per-class series), and
the class-aware autoscale signal, where the port's ``FleetController``
and the JAX package's take the same actions on one script.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import serve as JS
from tony_tpu.models import transformer as JT
from tony_tpu_torch.models import decode as TD
from tony_tpu_torch.models import serve as TS
from tony_tpu_torch.models import transformer as TT
from tony_tpu_torch.models.weights import params_from_numpy
from tony_tpu_torch.runtime import metrics as M

torch.set_num_threads(2)

JCFG = JT.PRESETS["tiny"].scaled(dtype=jnp.float32, remat=False)
TCFG = TT.PRESETS["tiny"].scaled(dtype=torch.float32, remat=False)


@pytest.fixture(scope="module")
def params():
    jp = JT.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_numpy(jax.device_get(jp), device="cpu")


def _prompts(seed, sizes):
    rs = np.random.RandomState(seed)
    return [[int(t) for t in rs.randint(0, 1024, size=n)] for n in sizes]


# (fetch count after which they arrive, [(rid, class, prompt, budget)])
_P = _prompts(5, (6, 9, 4, 12, 5, 7, 3, 8, 10, 6))
SCRIPT = [
    (0, [(0, "batch", _P[0], 14), (1, "batch", _P[1], 12),
         (2, "standard", _P[2], 6), (3, "batch", _P[3], 9)]),
    (2, [(4, "interactive", _P[4], 5), (5, "interactive", _P[5], 7)]),
    (3, [(6, "standard", _P[6], 4), (7, "batch", _P[7], 8)]),
    (5, [(8, "interactive", _P[8], 6), (9, "standard", _P[9], 5)]),
]


def _scripted(base, pkg_engine, script=SCRIPT):
    """A batcher class of ``base`` that submits the script's arrivals
    from inside its fetch and records every admission wave."""

    class Scripted(base):
        engine = None

        def _fetch(self, handle):
            out = super()._fetch(handle)
            self.fetches += 1
            self._arrive(self.fetches)
            return out

        def _arrive(self, at):
            for when, reqs in script:
                if when == at:
                    for rid, cls, p, n in reqs:
                        self.engine.submit(rid, p, n, request_class=cls)
            if at >= script[-1][0]:
                self.engine.drain()

        def _admit_batch(self, pairs, prompts):
            self.waves.append(sorted((int(r), int(s), len(prompts[s]))
                                     for r, s in pairs))
            return super()._admit_batch(pairs, prompts)

    return Scripted


def _run_script(base, engine_cls, params, cfg, floors, script=SCRIPT,
                batch=3, max_len=40, chunk=3, **kw):
    b = _scripted(base, engine_cls, script)(params, cfg, batch=batch,
                                            max_len=max_len, chunk=chunk,
                                            **kw)
    b.fetches, b.waves = 0, []
    got = {}

    def on_retired(rid, reason, n, final):
        got.setdefault(rid, []).extend(final)
        assert reason == "budget", (rid, reason)

    reg = (M.MetricsRegistry() if engine_cls is TS.ServeEngine
           else None)
    eng = engine_cls(b, on_delta=lambda r, t: got.setdefault(r, [])
                     .extend(t), on_retired=on_retired,
                     class_floors=floors, registry=reg)
    b.engine = eng
    b._arrive(0)
    eng.run()
    preempted = [s for wave in b.waves for _, s, _ in wave]
    preempted = sorted({s for s in preempted if preempted.count(s) > 1})
    return got, b.waves, preempted


@pytest.mark.parametrize("floors", [None, {"batch": 1, "standard": 1}],
                         ids=["no-floors", "floors"])
@pytest.mark.parametrize("sampling", [
    {}, {"temperature": 0.8, "top_k": 50, "top_p": 0.95, "seed": 3}],
    ids=["greedy", "sampled"])
@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "sequential"])
def test_engine_script_matches_jax(params, floors, sampling, pipeline):
    """The port's engine against the JAX engine on SCRIPT, but for one
    known fault of the reference: a stream preempted a second time
    resumes from its first reincarnation's prompt plus its WHOLE history
    there, so its first history is fed twice and its stream offset
    skips it twice. The port folds the history into the prompt as
    submitted. So the JAX waves are corrected (an admission after the
    second holds the first prompt plus the tokens emitted so far, which
    is the JAX prompt less the one before it), and a stream admitted
    three or more times is held to the JAX batcher's run WITHOUT
    preemption (the tokens a correct resume gives) instead of the JAX
    engine's."""
    jp, tp = params
    want = _run_script(JS.ContinuousBatcher, JS.ServeEngine, jp, JCFG,
                       floors, pipeline=pipeline, **sampling)
    got = _run_script(TS.ContinuousBatcher, TS.ServeEngine, tp, TCFG,
                      floors, pipeline=pipeline, **sampling)
    assert got[1] == _corrected_waves(want[1])     # admission waves
    assert got[2] == want[2]                       # preempted streams
    twice = _admitted_thrice(want[1])
    reqs = sorted(r for _, rs in SCRIPT for r in rs)
    budgets = {rid: n for rid, _, _, n in reqs}
    if twice:
        alone = JS.ContinuousBatcher(
            jp, JCFG, batch=3, max_len=40, chunk=3, pipeline=pipeline,
            **sampling).serve([p for _, _, p, _ in reqs],
                              [n for _, _, _, n in reqs])
        for s in twice:
            want[0][s] = alone[s]
    assert got[0] == want[0]                       # tokens
    if floors is None:
        assert got[2], "the script must preempt a batch row"
        assert twice, "the script must preempt a batch row twice"
    assert {r: len(t) for r, t in got[0].items()} == budgets


def _admitted_thrice(waves) -> list:
    streams = [s for wave in waves for _, s, _ in wave]
    return sorted({s for s in streams if streams.count(s) > 2})


def _corrected_waves(waves) -> list:
    """JAX's admission waves with the double-preemption fault taken out:
    a stream's admission after its first holds its submitted prompt
    plus the h tokens emitted so far, where JAX's prompt is the one
    before it plus h (the same thing at the second admission)."""
    seen: dict = {}                  # stream -> [submitted, last JAX]
    out = []
    for wave in waves:
        fixed = []
        for row, s, n in wave:
            base, last = seen.setdefault(s, [n, n])
            fixed.append((row, s, base + n - last))
            seen[s][1] = n
        out.append(sorted(fixed))
    return out


# two batch streams on 2 slots; an interactive request at fetch 1
# evicts stream 0, which readmits and is evicted again at fetch 5
_D = _prompts(9, (5, 7, 4, 6))
TWICE = [
    (0, [(0, "batch", _D[0], 16), (1, "batch", _D[1], 24)]),
    (1, [(2, "interactive", _D[2], 2)]),
    (5, [(3, "interactive", _D[3], 2)]),
]


@pytest.mark.parametrize("sampling", [
    {}, {"temperature": 0.8, "top_k": 20, "top_p": 0.9, "seed": 7}],
    ids=["greedy", "sampled"])
@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "sequential"])
def test_preempted_twice_resumes_token_identically(params, sampling,
                                                   pipeline):
    """A batch stream preempted twice gives its tokens without preemption
    (exact, f32): each readmission holds the submitted prompt plus every
    token emitted so far, once. (The JAX engine feeds the first history
    twice here; see test_engine_script_matches_jax.)"""
    _, tp = params
    kw = dict(pipeline=pipeline, **sampling)
    got, waves, _ = _run_script(TS.ContinuousBatcher, TS.ServeEngine, tp,
                                TCFG, None, TWICE, batch=2, max_len=64,
                                chunk=2, **kw)
    lens = [n for wave in waves for _, s, n in wave if s == 0]
    assert len(lens) == 3, waves
    assert lens[0] == 5 and lens[1] < lens[2] < 5 + 16, lens
    reqs = [r for _, rs in TWICE for r in rs]
    ref = TS.ContinuousBatcher(tp, TCFG, batch=2, max_len=64, chunk=2,
                               **kw).serve([p for _, _, p, _ in reqs],
                                           [n for _, _, _, n in reqs])
    for rid in range(4):
        assert got[rid] == ref[rid], f"stream {rid} across preemptions"


# --- the invariants of tests/test_qos.py on the port's engine ---------

class _SlowFetch(TS.ContinuousBatcher):
    """Keeps streams mid-flight so admissions land on a full engine."""

    def _fetch(self, handle):
        time.sleep(0.05)
        return super()._fetch(handle)


class _Harness:
    def __init__(self, batcher, registry=None, **engine_kw):
        self.got: dict = {}
        self.retired: dict = {}

        def on_retired(rid, reason, n, final):
            self.got.setdefault(rid, []).extend(final)
            self.retired[rid] = (reason, n)

        self.engine = TS.ServeEngine(
            batcher,
            on_delta=lambda rid, t: self.got.setdefault(rid, []).extend(t),
            on_retired=on_retired, registry=registry, **engine_kw)
        self.thread = threading.Thread(target=self.engine.run, daemon=True)
        self.thread.start()

    def wait_first_tokens(self, rids, timeout=60):
        deadline = time.time() + timeout
        while time.time() < deadline:
            if all(self.got.get(r) for r in rids):
                return
            time.sleep(0.005)
        raise AssertionError(f"streams never started: {rids}")

    def finish(self, timeout=120):
        self.engine.drain()
        self.thread.join(timeout=timeout)
        assert not self.thread.is_alive(), "engine did not drain"


def _reference(tp, prompt, n):
    out = TD.generate(tp, torch.tensor([prompt]), TCFG, n)
    return out.tokens[0, len(prompt):].tolist()


def test_floor_and_class_validation(params):
    _, tp = params
    b = TS.ContinuousBatcher(tp, TCFG, batch=2, max_len=32, chunk=3)
    with pytest.raises(ValueError, match="exceed"):
        TS.ServeEngine(b, class_floors={"interactive": 2, "batch": 1})
    with pytest.raises(ValueError, match="unknown QoS class"):
        TS.ServeEngine(b, class_floors={"gold": 1})
    eng = TS.ServeEngine(b, registry=M.MetricsRegistry())
    with pytest.raises(ValueError, match="unknown request class"):
        eng.submit(1, [1, 2], 4, request_class="gold")
    # an unknown prefix id is no error: the request serves prefix-blind
    eng.submit(1, [1, 2], 4, prefix_id="abc")
    assert eng.stats()["queue_depth"] == 1
    assert eng.stats()["class_floors"] == {c: 0 for c in TS.QOS_CLASSES}
    with pytest.raises(ValueError, match="shared_prefix must be non-empty"):
        TS.ContinuousBatcher(tp, TCFG, batch=2, max_len=32,
                             shared_prefix=[])


def test_shed_past_queue_depth_interactive_exempt(params):
    _, tp = params
    reg = M.MetricsRegistry()
    h = _Harness(_SlowFetch(tp, TCFG, batch=2, max_len=32, chunk=3),
                 registry=reg, max_queue_depth=1, busy_retry_ms=123)
    prompts = _prompts(40, (4, 5, 4, 6))
    budget = 20
    try:
        h.engine.submit(0, prompts[0], budget, request_class="batch")
        h.wait_first_tokens([0])
        h.engine.submit(1, prompts[1], budget, request_class="batch")
        h.wait_first_tokens([1])
        h.engine.submit(2, prompts[2], budget, request_class="batch")
        with pytest.raises(TS.EngineBusy) as ei:
            h.engine.submit(9, prompts[3], budget, request_class="batch")
        assert ei.value.retry_after_ms == 123
        with pytest.raises(TS.EngineBusy):
            h.engine.submit(9, prompts[3], budget,
                            request_class="standard")
        h.engine.submit(3, prompts[3], 6, request_class="interactive")
    finally:
        h.finish()
    for rid in (0, 1, 2):
        assert h.got[rid] == _reference(tp, prompts[rid], budget), rid
    assert h.got[3] == _reference(tp, prompts[3], 6)
    shed = {c: reg.counter("tony_serve_shed_total", **{"class": c}).value
            for c in TS.QOS_CLASSES}
    assert shed == {"interactive": 0, "standard": 1, "batch": 1}
    assert reg.counter("tony_serve_preemptions_total").value >= 1
    assert h.engine.stats()["shed"] == 2


@pytest.mark.parametrize("sampling", [
    {}, {"temperature": 0.8, "top_k": 20, "top_p": 0.9, "seed": 7}],
    ids=["greedy", "sampled"])
def test_preempt_resume_token_identity(params, sampling):
    _, tp = params
    kw = dict(batch=2, max_len=64, chunk=2, **sampling)
    prompts = _prompts(42, (5, 4, 6))
    ref = TS.ContinuousBatcher(tp, TCFG, **kw).serve(prompts, 12)
    reg = M.MetricsRegistry()
    h = _Harness(_SlowFetch(tp, TCFG, **kw), registry=reg)
    try:
        h.engine.submit(0, prompts[0], 12, request_class="batch")
        h.engine.submit(1, prompts[1], 12, request_class="batch")
        h.wait_first_tokens([0, 1])
        h.engine.submit(2, prompts[2], 12, request_class="interactive")
    finally:
        h.finish()
    assert reg.counter("tony_serve_preemptions_total").value == 1
    assert h.engine.stats()["preemptions"] == 1
    for rid in (0, 1, 2):
        assert h.got[rid] == ref[rid], f"stream {rid} across preemption"
    assert {r for r, _ in h.retired.values()} == {"budget"}
    if not sampling:
        assert ref[0] == _reference(tp, prompts[0], 12)


# ---------------------------------------------------------------------------
# The port's router over the port's simulated fleet
# (tests/test_qos.py::TestRouterQoS): interactive placement, batch
# re-queue on BUSY, client retry, oracle continuity under preemption
# ---------------------------------------------------------------------------
@pytest.mark.fleet_sim
class TestRouterQoS:
    def _fill_direct(self, addr, n, budget, seed0):
        """Occupy a replica directly (bypassing the router) with batch
        streams: returns (client, seeds, results-dict, threads), each
        submission granted or queued before the next."""
        from tony_tpu_torch.serving.client import StreamingClient
        host, port = addr.split(":")
        c = StreamingClient(host, int(port))
        out, threads, seeds = {}, [], {}

        def pump(rid):
            toks = []
            for delta in c.deltas(rid, timeout=60):
                toks.extend(delta)
            out[rid] = toks

        for i in range(n):
            seed = seed0 + i
            rid = c.submit([seed, 1, 2], budget, request_class="batch")
            seeds[rid] = seed
            t = threading.Thread(target=pump, args=(rid,), daemon=True)
            t.start()
            threads.append(t)
            deadline = time.time() + 30
            while time.time() < deadline:
                st = c.stats()
                if st["active"] + st["queue_depth"] == i + 1 \
                        and st["queue_depth"] == max(
                            0, i + 1 - st["slots"]):
                    break
                time.sleep(0.005)
        return c, seeds, out, threads

    def test_interactive_lands_on_idle_slots(self):
        from tony_tpu_torch.serving.client import StreamingClient
        from tony_tpu_torch.serving.simfleet import SimFleet, sim_token
        fleet = SimFleet(2, itl_s=0.02, slots=2, health_interval_s=0.05,
                         registry=M.MetricsRegistry())
        try:
            port = fleet.start()
            a, b = fleet.addrs()
            c, seeds, out, threads = self._fill_direct(a, 2, 24, 500)
            try:
                deadline = time.time() + 30
                while time.time() < deadline:
                    reps = fleet.router.stats()["replicas"]
                    if reps[a]["reported_load"] >= 2:
                        break
                    time.sleep(0.01)
                with StreamingClient("127.0.0.1", port) as rc:
                    toks, reason = rc.result(rc.submit(
                        [900, 1, 2], 4, request_class="interactive"))
                assert toks == [sim_token(900, p) for p in range(4)]
                assert fleet.replicas[a].preemptions == 0
                for t in threads:
                    t.join(timeout=60)
                for rid, seed in seeds.items():
                    assert out[rid] == [sim_token(seed, p)
                                        for p in range(24)]
            finally:
                c.close()
        finally:
            fleet.stop()

    def test_batch_requeue_cap_then_busy_interactive_preempts(self):
        from tony_tpu_torch.serving.client import (ServerBusy,
                                                   StreamingClient)
        from tony_tpu_torch.serving.simfleet import SimFleet, sim_token
        reg = M.MetricsRegistry()
        fleet = SimFleet(2, itl_s=0.02, slots=1, max_queue_depth=1,
                         busy_retry_ms=60, health_interval_s=0.05,
                         registry=reg)
        try:
            port = fleet.start()
            a, b = fleet.addrs()
            ca, seeds_a, out_a, th_a = self._fill_direct(a, 2, 24, 600)
            cb, seeds_b, out_b, th_b = self._fill_direct(b, 2, 24, 700)
            try:
                with StreamingClient("127.0.0.1", port) as rc:
                    with pytest.raises(ServerBusy) as ei:
                        rc.result(rc.submit([910, 1, 2], 4,
                                            request_class="batch"))
                    assert ei.value.retry_after_ms == 60
                    assert reg.counter(
                        "tony_router_busy_requeues_total").value == 3
                    toks, _ = rc.result(rc.submit(
                        [920, 1, 2], 4, request_class="interactive"))
                    assert toks == [sim_token(920, p) for p in range(4)]
                for t in th_a + th_b:
                    t.join(timeout=60)
                for seeds, out in ((seeds_a, out_a), (seeds_b, out_b)):
                    for rid, seed in seeds.items():
                        assert out[rid] == [sim_token(seed, p)
                                            for p in range(24)], \
                            "dup/drop across sim preemption"
                assert sum(r.preemptions
                           for r in fleet.replicas.values()) >= 1
            finally:
                ca.close()
                cb.close()
        finally:
            fleet.stop()

    def test_client_retry_self_heals_on_single_replica(self):
        from tony_tpu_torch.serving.client import StreamingClient
        from tony_tpu_torch.serving.simfleet import SimFleet, sim_token
        fleet = SimFleet(1, itl_s=0.01, slots=1, max_queue_depth=1,
                         busy_retry_ms=30, health_interval_s=0.05,
                         registry=M.MetricsRegistry())
        try:
            port = fleet.start()
            (a,) = fleet.addrs()
            c, seeds, out, threads = self._fill_direct(a, 2, 10, 800)
            try:
                with StreamingClient("127.0.0.1", port) as rc:
                    toks, reason = rc.result(
                        rc.submit([930, 1, 2], 5, request_class="batch",
                                  retries=10), timeout=60)
                assert toks == [sim_token(930, p) for p in range(5)]
                assert reason == "budget"
                for t in threads:
                    t.join(timeout=60)
                for rid, seed in seeds.items():
                    assert out[rid] == [sim_token(seed, p)
                                        for p in range(10)]
            finally:
                c.close()
        finally:
            fleet.stop()

    def test_router_exports_per_class_series(self):
        from tony_tpu_torch.serving.client import StreamingClient
        from tony_tpu_torch.serving.simfleet import SimFleet, sim_token
        reg = M.MetricsRegistry()
        fleet = SimFleet(1, itl_s=0.005, slots=4, health_interval_s=0.05,
                         registry=reg)
        try:
            port = fleet.start()
            with StreamingClient("127.0.0.1", port) as rc:
                toks, _ = rc.result(rc.submit(
                    [940, 1, 2], 4, request_class="interactive"))
            assert toks == [sim_token(940, p) for p in range(4)]
            ttft = reg.histogram("tony_serve_ttft_seconds",
                                 **{"class": "interactive"})
            itl = reg.histogram("tony_serve_intertoken_seconds",
                                **{"class": "interactive"})
            assert ttft.count == 1
            assert itl.count >= 1
            assert reg.histogram("tony_serve_ttft_seconds",
                                 **{"class": "batch"}).count == 0
        finally:
            fleet.stop()


# ---------------------------------------------------------------------------
# Autoscale (tests/test_qos.py::TestAutoscaleQoS): interactive pressure
# pages capacity in, batch backlog alone never does — the port's
# controller and the JAX package's on one script
# ---------------------------------------------------------------------------
class _ClassedRouter:
    """stats()-only stand-in: a fixed 2-replica fleet whose per-replica
    reported_load/queue_depths are scripted per tick."""

    def __init__(self, script):
        self._script = list(script)
        self._i = 0
        self.added, self.removed, self.drained = [], [], []

    def stats(self):
        load, depths, active = self._script[min(
            self._i, len(self._script) - 1)]
        self._i += 1
        n = 2 + len(self.added) - len(self.removed)
        return {
            "active": active, "slots": 4 * n,
            "replicas": {f"r{i}": {"up": 1, "reported_load": load,
                                   "queue_depths": dict(depths),
                                   "assigned": active // max(n, 1),
                                   "draining": False}
                         for i in range(n)},
        }

    def add_replicas(self, addrs, role=None):
        self.added.extend(addrs)

    def remove_replica(self, addr):
        self.removed.append(addr)

    def drain(self, addr, timeout_s=None):
        self.drained.append(addr)
        return {"drained": True, "migrated": 0}


class _CountingProvider:
    def __init__(self):
        self.grown, self.released = 0, []

    def grow(self, n):
        addrs = [f"new{self.grown + i}" for i in range(n)]
        self.grown += n
        return addrs

    def release(self, addrs):
        self.released.extend(addrs)


def _autoscale(script, ticks, cooldown):
    """(actions, scale-ups, grown) of the port's controller, after
    checking that the JAX package's gives the same on the script."""
    from tony_tpu.runtime import metrics as JM
    from tony_tpu.serving import fleet as JF
    from tony_tpu_torch.serving import fleet as TF
    runs = []
    for ctrl_cls, reg in ((TF.FleetController, M.MetricsRegistry()),
                          (JF.FleetController, JM.MetricsRegistry())):
        router, provider = _ClassedRouter(script), _CountingProvider()
        ctrl = ctrl_cls(router, provider, hysteresis_ticks=3,
                        cooldown_ticks=cooldown, up_queue_per_replica=6.0,
                        registry=reg)
        actions = [ctrl.tick() for _ in range(ticks)]
        runs.append((actions,
                     reg.counter("tony_fleet_scale_ups_total").value,
                     provider.grown, router.drained,
                     reg.gauge("tony_fleet_load_per_replica").value))
    assert runs[0] == runs[1]
    return runs[0]


class TestAutoscaleQoS:
    def test_batch_backlog_alone_never_scales_up(self):
        script = [(52.0, {"interactive": 0, "standard": 0, "batch": 48},
                   8)] * 20
        actions, ups, grown, drained, load = _autoscale(script, 20, 5)
        assert set(actions) == {"hold"}, actions
        assert grown == 0 and not drained and load == 4.0

    def test_interactive_pressure_scales_up(self):
        script = [(52.0, {"interactive": 48, "standard": 0, "batch": 0},
                   8)] * 20
        actions, ups, grown, _, _ = _autoscale(script, 12, 10)
        assert actions.count("up") == 1, actions
        assert actions.index("up") == 2
        assert ups == 1 and grown == 1

    def test_classless_replicas_keep_aggregate_signal(self):
        script = [(8.0, {}, 8)] * 12
        actions, _, _, _, _ = _autoscale(script, 6, 10)
        assert actions.count("up") == 1, actions
