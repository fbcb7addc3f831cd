"""The port's goodput ledger and the orchestrator's view of its loops,
held against the JAX package: ``tony_tpu_torch/runtime/goodput.py``
against ``tony_tpu/runtime/goodput.py`` on one fake-clock script (the
same snapshots; the port's spool read by the JAX package's
``from_wire_json`` and ``merge_wires``, which the executor runs), the
port's ``run_training`` against the JAX package's on scripted
step/data/checkpoint/eval fakes (the same span tree, ledger categories
and counts, a ``gang_lost`` flight dump), and ``ServeEngine``'s
``step``/``idle`` split on a ``tiny`` CPU model."""

import glob
import json
import os
import threading
import time

import pytest
import torch

from tony_tpu.models import loop as jloop
from tony_tpu.runtime import goodput as JG
from tony_tpu.runtime import tracing as JT
from tony_tpu_torch.models import loop as tloop
from tony_tpu_torch.runtime import goodput as G
from tony_tpu_torch.runtime import metrics as M
from tony_tpu_torch.runtime import tracing as TT

torch.set_num_threads(2)


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def tick(self, dt):
        self.t += dt


def _nesting(led, clk):
    clk.tick(1.0)
    with led.enter("provision"):
        clk.tick(2.0)
    with led.enter("step"):
        clk.tick(3.0)
        with led.enter("checkpoint"):
            clk.tick(0.5)
        clk.tick(1.5)
    clk.tick(0.25)


def _out_of_order(led, clk):
    led._push("step")
    clk.tick(1.0)
    led._push("checkpoint")
    clk.tick(1.0)
    led._pop("step")                     # the outer frame exits first
    clk.tick(1.0)
    with led.enter("step"):
        clk.tick(0.75)


def _added(led, clk):
    with led.enter("data_wait"):
        clk.tick(0.125)
    led.add("compile", 4.0)              # not part of the wall invariant
    led.add("eval", 0.0)                 # ignored
    with led.enter("step"):
        clk.tick(2.0)
    led.add("step", 0.5)


@pytest.mark.parametrize("script", [_nesting, _out_of_order, _added])
def test_same_clock_script_gives_the_same_snapshot(script):
    snaps = []
    for mod in (G, JG):
        clk = FakeClock()
        led = mod.GoodputLedger(clock=clk, wall_clock=clk)
        script(led, clk)
        snaps.append(led.snapshot())
    assert snaps[0] == snaps[1]
    w = snaps[0]
    wall = w["now"] - w["t0"]
    added = {_added: 4.5}.get(script, 0.0)
    assert sum(w["cat"].values()) == pytest.approx(wall + added, abs=1e-9)


def test_spool_wire_passes_the_jax_readers(tmp_path):
    clk = FakeClock()
    led = G.GoodputLedger(clock=clk, wall_clock=clk,
                          spool_path=str(tmp_path / "spool.json"))
    _nesting(led, clk)
    led.publish()
    assert not os.path.exists(tmp_path / "spool.json.tmp")
    child = JG.from_wire_json((tmp_path / "spool.json").read_text())
    assert child is not None and child == led.snapshot()
    # the executor's host ledger: the user process ran the whole time
    hclk = FakeClock(99.0)
    host = JG.GoodputLedger(clock=hclk, wall_clock=hclk,
                            extra_categories=(JG.USER_CATEGORY,))
    with host.enter(JG.USER_CATEGORY):
        hclk.tick(10.0)
    merged = JG.merge_wires(host.snapshot(), child)
    assert JG.USER_CATEGORY not in merged["cat"]
    assert merged["cat"]["step"] == pytest.approx(4.5)
    # 10 s of user wall, 8.25 s of it the child's: the rest is overhead
    assert merged["cat"]["overhead"] == pytest.approx(1.25 + 1.75)
    assert merged["sw"] == {"c": 1, "s": pytest.approx(4.5)}


def test_unknown_category_raises():
    led = G.GoodputLedger(clock=FakeClock(), wall_clock=FakeClock())
    with pytest.raises(ValueError):
        led.enter("coffee")
    with pytest.raises(ValueError):
        led.add("coffee", 1.0)
    with pytest.raises(ValueError):
        led.enter(G.USER_CATEGORY)       # the executor's, never the port's
    assert led.snapshot()["cur"] == G.BASE_CATEGORY == "overhead"
    assert G.CATEGORIES == JG.CATEGORIES
    assert (G.USER_CATEGORY, G.WIRE_VERSION) == (JG.USER_CATEGORY,
                                                 JG.WIRE_VERSION)


def test_seconds_are_mirrored_into_the_ports_registry():
    clk = FakeClock()
    reg = M.MetricsRegistry()
    led = G.GoodputLedger(clock=clk, wall_clock=clk, registry=reg)
    with led.enter("step"):
        clk.tick(2.0)
    with led.enter("idle"):
        clk.tick(1.0)
    led.snapshot()
    with led.enter("step"):
        clk.tick(3.0)
    led.snapshot()
    totals = {(name, tuple(sorted(labels.items()))): value
              for name, labels, value in reg.to_wire()["c"]}
    key = ("tony_goodput_seconds_total", (("category", "step"),))
    assert totals[key] == pytest.approx(5.0)     # 2.0 then +3.0
    idle = ("tony_goodput_seconds_total", (("category", "idle"),))
    assert totals[idle] == pytest.approx(1.0)    # mirrored once


def test_get_ledger_follows_the_executors_spool(tmp_path, monkeypatch):
    spool = tmp_path / "goodput.json"
    monkeypatch.setenv("TONY_GOODPUT_SPOOL", str(spool))
    G.set_ledger(None)
    try:
        led = G.get_ledger()
        assert G.get_ledger() is led
        with led.enter("step"):
            pass
        led.publish()
        assert JG.from_wire_json(spool.read_text())["n"]["step"] == 1
    finally:
        G.set_ledger(None)


# ---------------------------------------------------------------------------
# run_training: the port's against the JAX package's on scripted fakes
# ---------------------------------------------------------------------------
class _Checkpoint:
    def __init__(self, clk, fail_wait=False):
        self.clk, self.fail_wait, self.saved = clk, fail_wait, []

    def save(self, step, state):
        self.clk.tick(0.02)
        self.saved.append(step)

    def wait_until_finished(self):
        self.clk.tick(0.05)
        if self.fail_wait:
            raise OSError("disk full")


def _run(pkg, tmp_path, steps=5, fail_at=None, fail_wait=False):
    """One ``run_training`` of ``pkg`` ("jax" or "torch") on fakes that
    advance a fake clock, under a fresh tracer, flight recorder and
    ledger (restored after); returns (result or the error, the ledger's
    snapshot, the tracer's spans, flight dumps, spool path)."""
    T, L, loop = ((JT, JG, jloop) if pkg == "jax" else (TT, G, tloop))
    clk = FakeClock()
    d = tmp_path / pkg
    d.mkdir()
    spool = str(d / "spool.json")
    prev_tr = T.set_tracer(T.Tracer(proc="worker:0", sample_rate=1.0,
                                    spool_path=""))
    prev_fl = T.set_flight(T.FlightRecorder(proc="worker:0",
                                            dir_path=str(d)))
    L.set_ledger(L.GoodputLedger(clock=clk, wall_clock=clk,
                                 spool_path=spool))

    def data():
        for i in range(steps):
            clk.tick(0.01)
            yield {"i": i}

    def step_fn(state, batch):
        clk.tick(0.1)
        if state == fail_at:
            raise RuntimeError("gloo: connection closed by peer")
        return state + 1, {"loss": 1.0}

    def eval_fn(state):
        clk.tick(0.03)
        return float(state)

    try:
        out = loop.run_training(
            step_fn, 0, data(), steps, checkpoint=_Checkpoint(clk,
                                                              fail_wait),
            eval_fn=eval_fn, eval_every=2, log_every=1,
            log_fn=lambda *a: clk.tick(0.005),
            step_hook=lambda s: clk.tick(0.001))
    except Exception as e:          # noqa: BLE001 - the case's outcome
        out = e
    try:
        snap = L.get_ledger().snapshot()
        spans = T.get_tracer().recent()
    finally:
        T.set_tracer(prev_tr)
        T.set_flight(prev_fl)
        L.set_ledger(None)
    dumps = [json.load(open(p)) for p in sorted(glob.glob(
        str(d / "flight-*.json")))]
    return out, snap, spans, dumps, spool


def _tree(spans):
    """(name, parent's name, step attribute) of each span, in the order
    they finished."""
    names = {s["sid"]: s["n"] for s in spans}
    return [(s["n"], names.get(s["pid"], ""), s["a"].get("step"))
            for s in spans]


def test_run_training_gives_the_jax_loops_spans_and_ledger(tmp_path):
    got = {pkg: _run(pkg, tmp_path) for pkg in ("jax", "torch")}
    (jout, jsnap, jspans, _, jspool) = got["jax"]
    (tout, tsnap, tspans, tdumps, tspool) = got["torch"]
    assert tout[0] == jout[0] == 5
    assert _tree(tspans) == _tree(jspans)
    roots = [t for t in _tree(tspans) if t[0] == "train.step"]
    assert roots == [("train.step", "", s) for s in range(5)]
    children = {t[0] for t in _tree(tspans) if t[1] == "train.step"}
    assert children == {"train.data_wait", "train.dispatch",
                        "train.checkpoint", "train.eval"}
    assert tsnap == jsnap
    assert set(tsnap["cat"]) == {"data_wait", "step", "checkpoint", "eval",
                                 "overhead"}
    assert tsnap["n"] == {"data_wait": 5, "step": 5, "checkpoint": 6,
                          "eval": 2}
    assert tsnap["sw"]["c"] == 5
    assert tsnap["sw"]["s"] == pytest.approx(0.5)
    assert sum(tsnap["cat"].values()) == pytest.approx(
        tsnap["now"] - tsnap["t0"], abs=1e-6)
    assert tsnap["cur"] == "overhead"
    assert tdumps == []
    # the exit publish: the spool holds the final snapshot, which the
    # JAX package's readers take as they take the JAX loop's
    wires = [JG.from_wire_json(open(p).read()) for p in (tspool, jspool)]
    assert wires[0] is not None and wires[0] == wires[1]


def test_gang_loss_dumps_the_flight_recorder_in_both(tmp_path):
    got = {pkg: _run(pkg, tmp_path, fail_at=2) for pkg in ("jax", "torch")}
    assert isinstance(got["jax"][0], jloop.GangLostError)
    assert isinstance(got["torch"][0], tloop.GangLostError)
    docs = {}
    for pkg, (_, snap, spans, dumps, _) in got.items():
        assert len(dumps) == 1, pkg
        doc = dumps[0]
        assert doc["reason"] == "gang_lost" and doc["attrs"] == {"step": 2}
        kinds = [e["kind"] for e in doc["events"]]
        assert kinds[-2:] == ["gang_lost", "flight_dump"], kinds
        assert "connection closed by peer" in doc["events"][-2]["error"]
        docs[pkg] = ([e["kind"] for e in doc["events"]], _tree(doc["spans"]))
    assert docs["torch"] == docs["jax"]
    assert got["torch"][1] == got["jax"][1]      # the same ledger
    assert got["torch"][1]["sw"]["c"] == 3       # the failed step closed


def test_a_failing_exit_join_keeps_the_loops_own_error(tmp_path):
    """The step fails because its gang did, and the exit join fails too:
    the loop's GangLostError surfaces, the ledger's checkpoint interval
    closes and the final breakdown is still published."""
    out, snap, _, dumps, spool = _run("torch", tmp_path, fail_at=1,
                                      fail_wait=True)
    assert isinstance(out, tloop.GangLostError)
    assert [d["reason"] for d in dumps] == ["gang_lost"]
    assert snap["cur"] == "overhead" and snap["n"]["checkpoint"] == 2
    assert sum(snap["cat"].values()) == pytest.approx(
        snap["now"] - snap["t0"], abs=1e-6)
    assert JG.from_wire_json(open(spool).read())["n"]["checkpoint"] == 2


# ---------------------------------------------------------------------------
# ServeEngine: step while it works, idle while it waits
# ---------------------------------------------------------------------------
def test_serve_engine_splits_step_and_idle():
    from tony_tpu_torch.models import serve as S
    from tony_tpu_torch.models import transformer as T
    cfg = T.PRESETS["tiny"].scaled(dtype=torch.float32)
    params = T.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    batcher = S.ContinuousBatcher(params, cfg, batch=2, max_len=32)
    done = threading.Event()
    retired = []

    def on_retired(rid, reason, emitted, final):
        retired.append(rid)
        if len(retired) == 3:
            done.set()

    led = G.GoodputLedger()
    G.set_ledger(led)
    try:
        eng = S.ServeEngine(batcher, on_retired=on_retired,
                            registry=M.MetricsRegistry())
        th = threading.Thread(target=eng.run, daemon=True)
        th.start()
        for i in range(3):
            eng.submit(f"r{i}", [1 + i, 2, 3, 4], 6)
        assert done.wait(120)
        time.sleep(0.5)                  # the engine waits for work
        eng.drain()
        th.join(60)
        assert not th.is_alive()
        snap = led.snapshot()
    finally:
        G.set_ledger(None)
    assert sorted(retired) == ["r0", "r1", "r2"]
    cat = snap["cat"]
    assert cat["step"] > 0 and cat["idle"] >= 0.4
    assert snap["n"]["step"] == 1 and snap["n"]["idle"] >= 1
    assert sum(cat.values()) == pytest.approx(snap["now"] - snap["t0"],
                                              abs=1e-6)


# ---------------------------------------------------------------------------
# train_lm: a gang loss inside the step trace's window
# ---------------------------------------------------------------------------
def test_gang_loss_in_the_trace_window_keeps_the_exit_code(tmp_path,
                                                           monkeypatch):
    """The gang dies at step 7, inside the StepTracer's [5, 8), and
    stopping the capture fails: the capture is stopped without waiting
    on the card, its error is logged, and ``train_lm`` still returns the
    gang-lost exit code the executor relaunches on."""
    import tony_tpu_torch.runtime as rt
    from tony_tpu_torch import train_lm
    from tony_tpu_torch.runtime import profiler as P
    monkeypatch.setenv("TONY_PROFILE_DIR", str(tmp_path))
    real_stop, stops = P._Capture.stop, []

    def stop(self, sync=True):
        stops.append(sync)
        real_stop(self, sync=sync)
        raise RuntimeError("CUDA error: unspecified launch failure")

    def run_training(step_fn, state, data, steps, step_hook, **kw):
        try:
            for s in range(8):
                step_hook(s)
            raise tloop.GangLostError("nccl: connection closed by peer")
        finally:
            data.close()

    monkeypatch.setattr(P._Capture, "stop", stop)
    monkeypatch.setattr(train_lm, "run_training", run_training)
    try:
        rc = train_lm.main(["--device", "cpu", "--preset", "tiny",
                            "--steps", "10", "--batch_size", "2",
                            "--seq_len", "32"])
    finally:
        rt.shutdown()
    assert rc == tloop.GangLostError.exit_code
    assert stops == [False]
    assert not P._capture_lock.locked()
