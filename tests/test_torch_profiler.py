"""The port's profiler hooks on ``torch.profiler``, case for case with
``tests/test_profiler.py`` (the JAX package's): the per-task trace
directory, ``maybe_start``'s liveness contract, ``trace`` and
``StepTracer`` writing Chrome traces (``*.pt.trace.json``), and their
no-op cases; then what only the port has: the live capture listener on
``TB_PORT``, its refusals, and ``runtime.initialize`` starting it. On
this CPU-only torch a capture records CPU activity only."""

import glob
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from tony_tpu import constants as jconst
from tony_tpu_torch import constants
from tony_tpu_torch.runtime import profiler

torch.set_num_threads(2)


def _traces(logdir):
    return sorted(glob.glob(os.path.join(logdir, "*.pt.trace.json")))


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _mm_shapes(path):
    """The operand shapes of every ``aten::mm`` the trace holds."""
    return [tuple(map(tuple, e["args"]["Input Dims"]))
            for e in _events(path) if e.get("name") == "aten::mm"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port, query):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/capture?{query}", timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture
def fresh_latch():
    profiler._reset_server_state_for_tests()
    yield
    profiler._reset_server_state_for_tests()


def test_profile_dir_off_by_default(monkeypatch):
    monkeypatch.delenv(constants.TONY_PROFILE_DIR, raising=False)
    assert profiler.profile_dir() is None


def test_profile_dir_per_task(monkeypatch):
    monkeypatch.setenv(constants.TONY_PROFILE_DIR, "/tmp/traces")
    monkeypatch.setenv(constants.JOB_NAME, "worker")
    monkeypatch.setenv(constants.TASK_INDEX, "3")
    assert profiler.profile_dir() == "/tmp/traces/worker-3"


def test_maybe_start_disabled(monkeypatch):
    monkeypatch.delenv(constants.TONY_PROFILE_ENABLED, raising=False)
    assert profiler.maybe_start() is False


@pytest.mark.usefixtures("fresh_latch")
class TestMaybeStartReportsLiveness:
    """maybe_start() returns whether the capture listener is LIVE, not
    merely that profiling was asked for."""

    def test_no_tb_port_returns_false(self, monkeypatch):
        monkeypatch.setenv(constants.TONY_PROFILE_ENABLED, "true")
        monkeypatch.delenv(constants.TB_PORT, raising=False)
        assert profiler.maybe_start() is False
        monkeypatch.setenv(constants.TB_PORT, "0")
        assert profiler.maybe_start() is False
        monkeypatch.setenv(constants.TB_PORT, "")     # exported but empty
        assert profiler.maybe_start() is False

    def test_server_start_failure_returns_false(self, monkeypatch):
        monkeypatch.setenv(constants.TONY_PROFILE_ENABLED, "true")
        monkeypatch.setenv(constants.TB_PORT, "12345")
        monkeypatch.setattr(
            profiler, "_start_server",
            lambda port: (_ for _ in ()).throw(RuntimeError("boom")))
        assert profiler.maybe_start() is False
        assert profiler._server_started is False      # retryable next call

    def test_a_failed_bind_returns_false(self, monkeypatch):
        with socket.socket() as taken:
            taken.bind(("", 0))
            taken.listen()
            monkeypatch.setenv(constants.TONY_PROFILE_ENABLED, "true")
            monkeypatch.setenv(constants.TB_PORT,
                               str(taken.getsockname()[1]))
            assert profiler.maybe_start() is False
        assert profiler._server_started is False

    def test_server_start_success_returns_true_and_latches(
            self, monkeypatch):
        started = []
        monkeypatch.setenv(constants.TONY_PROFILE_ENABLED, "true")
        monkeypatch.setenv(constants.TB_PORT, "12345")
        monkeypatch.setattr(profiler, "_start_server", started.append)
        assert profiler.maybe_start() is True
        assert profiler.maybe_start() is True         # idempotent
        assert started == [12345]                     # started exactly once


def test_trace_writes_capture(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiler.trace(logdir):
        torch.mm(torch.ones(64, 64), torch.ones(64, 64))
    (path,) = _traces(logdir)
    assert _mm_shapes(path) == [((64, 64), (64, 64))]


def test_trace_noop_when_unconfigured(monkeypatch, tmp_path):
    monkeypatch.delenv(constants.TONY_PROFILE_DIR, raising=False)
    monkeypatch.chdir(tmp_path)
    with profiler.trace():          # must not raise or start anything
        torch.ones(4).sum()
    assert os.listdir(tmp_path) == []
    assert not profiler._capture_lock.locked()


def test_step_tracer_bounded_capture(tmp_path):
    """Six steps, step i a product of shape [8 + i, 16] x [16, 4]: the
    trace of [2, 4) holds exactly steps 2 and 3's products, each inside
    its ``ProfilerStep#`` range."""
    logdir = str(tmp_path / "steps")
    tracer = profiler.StepTracer(start=2, stop=4, logdir=logdir)
    for step in range(6):
        tracer.step(step)
        torch.mm(torch.ones(8 + step, 16), torch.ones(16, 4))
    tracer.close()
    assert not tracer._active
    (path,) = _traces(logdir)
    assert tracer.path == path
    assert _mm_shapes(path) == [((10, 16), (16, 4)), ((11, 16), (16, 4))]
    events = _events(path)
    marks = {e["name"]: e for e in events
             if e.get("name", "").startswith("ProfilerStep#")}
    assert sorted(marks) == ["ProfilerStep#2", "ProfilerStep#3"]
    for e in events:
        if e.get("name") == "aten::mm":
            rows = e["args"]["Input Dims"][0][0]
            mark = marks[f"ProfilerStep#{rows - 8}"]
            assert mark["ts"] <= e["ts"] <= mark["ts"] + mark["dur"]


def test_step_tracer_closes_a_window_the_loop_left_open(tmp_path):
    logdir = str(tmp_path / "open")
    tracer = profiler.StepTracer(start=1, stop=10, logdir=logdir)
    for step in range(3):
        tracer.step(step)
    tracer.close()
    tracer.close()                  # a second close is a no-op
    (path,) = _traces(logdir)
    assert sorted(e["name"] for e in _events(path)
                  if e.get("name", "").startswith("ProfilerStep#")) == [
        "ProfilerStep#1", "ProfilerStep#2"]


def test_a_failing_loop_closes_its_window_without_waiting(tmp_path,
                                                         monkeypatch):
    """``close(failing=True)``: the capture stops without synchronising
    the device and still writes its trace; a stop that raises is logged
    and the capture lock is free again."""
    logdir = str(tmp_path / "failing")
    syncs = []
    monkeypatch.setattr(profiler._Capture, "_sync",
                        lambda self: syncs.append(self))
    tracer = profiler.StepTracer(start=0, stop=5, logdir=logdir)
    for step in range(2):
        tracer.step(step)
    del syncs[:]                    # the start's
    tracer.close(failing=True)
    assert syncs == []
    (path,) = _traces(logdir)
    assert tracer.path == path
    assert not profiler._capture_lock.locked()

    real_stop = profiler._Capture.stop

    def stop(self, sync=True):
        real_stop(self, sync=sync)
        raise RuntimeError("CUDA error: unspecified launch failure")

    monkeypatch.setattr(profiler._Capture, "stop", stop)
    tracer = profiler.StepTracer(start=0, stop=5, logdir=logdir)
    tracer.step(0)
    tracer.close(failing=True)      # logged, not raised
    assert not tracer._active and not profiler._capture_lock.locked()


def test_step_tracer_noop_without_dir(monkeypatch):
    monkeypatch.delenv(constants.TONY_PROFILE_DIR, raising=False)
    tracer = profiler.StepTracer(start=0, stop=2)
    for step in range(3):
        tracer.step(step)
    tracer.close()
    assert tracer.path is None and not profiler._capture_lock.locked()


def test_executor_exports_the_names_the_port_reads():
    """Conf keys → executor env (without running an executor): the port
    reads the env names the JAX package's executor exports."""
    from tony_tpu.conf import keys as K
    from tony_tpu.conf.config import TonyConfig

    for name in ("TB_PORT", "TONY_PROFILE_ENABLED", "TONY_PROFILE_DIR",
                 "TONY_GOODPUT_SPOOL"):
        assert getattr(constants, name) == getattr(jconst, name)
    conf = TonyConfig({K.TASK_PROFILE_ENABLED_KEY: "true",
                       K.TASK_PROFILE_DIR_KEY: "/tmp/prof"})
    assert conf.get_bool(K.TASK_PROFILE_ENABLED_KEY) is True
    assert TonyConfig().get_bool(K.TASK_PROFILE_ENABLED_KEY) is False


# ---------------------------------------------------------------------------
# the live capture listener
# ---------------------------------------------------------------------------
class _Steps:
    """A thread running products of shape [24, 32] x [32, 8] until
    stopped: the training thread of the live-capture cases."""

    def __init__(self, tracer=None):
        self.stop, self.steps, self.errors = False, 0, []
        self.tracer = tracer
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            while not self.stop:
                if self.tracer is not None:
                    self.tracer.step(self.steps)
                torch.mm(torch.ones(24, 32), torch.ones(32, 8))
                self.steps += 1
                time.sleep(0.002)
            if self.tracer is not None:
                self.tracer.close()
        except Exception as e:      # noqa: BLE001 - the test reads it
            self.errors.append(e)

    def join(self):
        self.stop = True
        self.thread.join(60)
        assert not self.thread.is_alive()
        assert self.errors == []


def _listen(monkeypatch, tmp_path):
    port = _free_port()
    monkeypatch.setenv(constants.TONY_PROFILE_ENABLED, "true")
    monkeypatch.setenv(constants.TB_PORT, str(port))
    monkeypatch.setenv(constants.TONY_PROFILE_DIR, str(tmp_path / "prof"))
    monkeypatch.setenv(constants.JOB_NAME, "worker")
    monkeypatch.setenv(constants.TASK_INDEX, "1")
    assert profiler.maybe_start() is True
    return port, str(tmp_path / "prof" / "worker-1")


@pytest.mark.usefixtures("fresh_latch")
def test_live_capture_records_the_training_thread(monkeypatch, tmp_path):
    """A capture asked for over the listener while another thread runs
    steps writes a trace under the task's directory holding that
    thread's products; a second, overlapping request is refused with
    409 and neither thread sees an error."""
    port, logdir = _listen(monkeypatch, tmp_path)
    steps = _Steps()
    answers = {}

    def ask(key, ms):
        answers[key] = _get(port, f"ms={ms}")

    first = threading.Thread(target=ask, args=("first", 2000))
    first.start()
    deadline = time.monotonic() + 30
    while not profiler._capture_lock.locked():
        assert time.monotonic() < deadline
        time.sleep(0.01)
    ask("second", 100)
    first.join(60)
    steps.join()
    code, body = answers["first"]
    assert code == 200 and body["ok"] and body["ms"] == 2000, body
    assert os.path.dirname(body["trace"]) == logdir
    assert _traces(logdir) == [body["trace"]]
    assert ((24, 32), (32, 8)) in _mm_shapes(body["trace"])
    code, body = answers["second"]
    assert code == 409 and not body["ok"], body
    assert "another capture is running" in body["error"]
    assert _get(port, "ms=50")[0] == 200       # free again


_FRESH_PROCESS = """
import json, os, sys, threading, time, urllib.request
import torch
from tony_tpu_torch.runtime import profiler
torch.set_num_threads(2)
assert profiler.maybe_start()
port = int(os.environ["TB_PORT"])
got = {}
asker = threading.Thread(target=lambda: got.update(json.loads(
    urllib.request.urlopen(f"http://127.0.0.1:{port}/capture?ms=300",
                           timeout=60).read())))
asker.start()
while asker.is_alive():
    torch.mm(torch.ones(24, 32), torch.ones(32, 8))
    time.sleep(0.002)
with open(got["trace"]) as f:
    events = json.load(f)["traceEvents"]
print(json.dumps(sum(1 for e in events if e.get("name") == "aten::mm"
                     and e.get("tid") == threading.get_native_id())))
"""


def test_a_fresh_process_live_capture_holds_the_main_threads_ops(
        tmp_path):
    """The first capture of a process runs on the listener's thread; the
    profiler's warm-up in maybe_start is what lets it record the main
    thread's ops."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, TONY_PROFILE_ENABLED="true",
               TB_PORT=str(_free_port()),
               TONY_PROFILE_DIR=str(tmp_path / "prof"))
    out = subprocess.run([sys.executable, "-c", _FRESH_PROCESS], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) > 10


@pytest.mark.usefixtures("fresh_latch")
def test_live_capture_and_a_step_window_never_overlap(monkeypatch,
                                                      tmp_path):
    """A live request during a StepTracer window is refused; a window
    that opens during a live capture waits for it (the loop never sees
    an error), and its trace starts at the first step after it."""
    port, logdir = _listen(monkeypatch, tmp_path)
    tracer = profiler.StepTracer(start=0, stop=10 ** 6,
                                 logdir=str(tmp_path / "window"))
    steps = _Steps(tracer)
    deadline = time.monotonic() + 30
    while not tracer._active:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    code, body = _get(port, "ms=50")
    assert code == 409 and "another capture is running" in body["error"]
    steps.join()
    assert tracer.path is not None and not profiler._capture_lock.locked()

    tracer = profiler.StepTracer(start=3, stop=10 ** 6,
                                 logdir=str(tmp_path / "late"))
    answers = []
    live = threading.Thread(target=lambda: answers.append(
        _get(port, "ms=2000")))
    live.start()
    while not profiler._capture_lock.locked():
        time.sleep(0.005)
    steps = _Steps(tracer)
    live.join(60)
    while not tracer._active:
        time.sleep(0.01)
    first = steps.steps
    while steps.steps < first + 5:
        time.sleep(0.01)
    steps.join()
    assert answers[0][0] == 200
    (path,) = _traces(str(tmp_path / "late"))
    marks = sorted(int(e["name"].split("#")[1]) for e in _events(path)
                   if e.get("name", "").startswith("ProfilerStep#"))
    assert 3 < marks[0] and marks == list(range(marks[0], steps.steps))


@pytest.mark.usefixtures("fresh_latch")
@pytest.mark.parametrize("query,code", [("ms=0", 400), ("ms=x", 400),
                                        ("ms=60001", 400)])
def test_live_capture_refuses_a_bad_duration(monkeypatch, tmp_path, query,
                                             code):
    port, _ = _listen(monkeypatch, tmp_path)
    got, body = _get(port, query)
    assert got == code and not body["ok"] and "ms must be" in body["error"]


@pytest.mark.usefixtures("fresh_latch")
def test_live_capture_without_a_directory_is_refused(monkeypatch, tmp_path):
    port, _ = _listen(monkeypatch, tmp_path)
    monkeypatch.delenv(constants.TONY_PROFILE_DIR)
    code, body = _get(port, "ms=10")
    assert code == 503 and "tony.task.profile.dir" in body["error"]
    assert not profiler._capture_lock.locked()


@pytest.mark.usefixtures("fresh_latch")
def test_initialize_starts_the_listener_on_both_paths(monkeypatch):
    """runtime.initialize calls maybe_start when it builds the group and
    when the group already exists."""
    import tony_tpu_torch.runtime as rt
    calls = []
    monkeypatch.setattr(profiler, "maybe_start",
                        lambda: calls.append(1) or False)
    for name in ("TONY_JAX_COORDINATOR_ADDRESS", "INIT_METHOD"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("TONY_JAX_NUM_PROCESSES", "1")
    try:
        rt.initialize("cpu")
        assert calls == [1]
        rt.initialize("cpu")
        assert calls == [1, 1]
    finally:
        rt.shutdown()
