"""The port's asynchronous checkpoint saves (tony_tpu_torch.models.
checkpoint), on the CPU: the read fence of tests/test_checkpoint.py
(``latest_step``, ``restore`` and ``restore_or_init`` wait for the save
in flight before they read), a save as a snapshot taken before ``save``
returns, a failed background save raised on the next save, wait or close
while reads stay on the last committed step, and ``run_training`` joining
the saves once, at exit; save offers decided from memory (an offer off the
interval joins nothing, lists nothing), and the same steps saved as the
JAX package's orbax manager saves for the same offers.

A background write is slowed by wrapping ``torch.save`` in the module, so
that reads, offers and mutations land while it is in flight."""

import os
import subprocess
import sys
import threading
import time

import jax.numpy as jnp
import pytest
import torch

from tony_tpu.models.checkpoint import CheckpointManager as JaxManager
from tony_tpu_torch.models import checkpoint as C
from tony_tpu_torch.models.checkpoint import CheckpointManager
from tony_tpu_torch.models.loop import GangLostError, run_training

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state(v: float) -> dict:
    return {"params": {"w": torch.full((4, 4), v)},
            "opt_state": {"count": int(v), "mu": {"w": torch.zeros(4, 4)}},
            "step": int(v)}


@pytest.fixture
def slow_writes(monkeypatch):
    """Each background write sleeps 0.2 s before it writes; returns the
    list of steps written, in order."""
    real, written = torch.save, []

    def save(obj, path, *a, **k):
        time.sleep(0.2)
        written.append(obj["step"])
        return real(obj, path, *a, **k)

    monkeypatch.setattr(C.torch, "save", save)
    return written


def _track(mgr, calls, names=("_fence", "_committed_steps")):
    """Record the order of the fence and the directory listing."""
    for name in names:
        real = getattr(mgr, name)

        def wrapped(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        setattr(mgr, name, wrapped)


class TestRestoreVsInFlightSaveFence:
    """Port twins of tests/test_checkpoint.py's fence tests: a read never
    observes a partially written asynchronous save."""

    def test_latest_step_fences_first(self, tmp_path, slow_writes):
        mgr = CheckpointManager(str(tmp_path / "c"))
        calls = []
        _track(mgr, calls)
        mgr.save(3, _state(5.0))         # asynchronous: commit in flight
        assert mgr._writer is not None and mgr._writer.is_alive()
        assert mgr.latest_step() == 3    # fenced: never a partial view
        assert calls.index("_fence") < calls.index("_committed_steps")
        mgr.close()

    def test_restore_during_in_flight_save_sees_committed_state(
            self, tmp_path, slow_writes):
        with CheckpointManager(str(tmp_path / "c"), max_to_keep=2) as mgr:
            for s in range(4):
                mgr.save(s, _state(float(s)))
                restored = mgr.restore(template=_state(0.0))
                assert restored["params"]["w"][0, 0] == float(s)
                assert mgr.latest_step() == s
        assert sorted(os.listdir(tmp_path / "c")) == ["step_2.pt",
                                                      "step_3.pt"]

    def test_restore_or_init_fences(self, tmp_path, slow_writes):
        mgr = CheckpointManager(str(tmp_path / "c"))
        calls = []
        _track(mgr, calls)
        mgr.save(1, _state(2.0))
        state = mgr.restore_or_init(lambda: _state(0.0))
        assert state["params"]["w"][0, 0] == 2.0
        assert calls.index("_fence") < calls.index("_committed_steps")
        mgr.close()


def test_an_off_interval_offer_decides_from_memory(tmp_path, slow_writes):
    """While a write is in flight, offers off the interval (and one at
    the saved step) return at once: no join, no fence, no directory
    listing, as orbax's ``should_save`` reads its in-memory list."""
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=5)
    assert mgr.save(1, _state(1.0))
    writer, calls = mgr._writer, []
    _track(mgr, calls, ("_fence", "_committed_steps", "_join"))
    for s in (2, 3, 4, 1):
        t0 = time.perf_counter()
        assert not mgr.save(s, _state(float(s)))
        assert time.perf_counter() - t0 < 0.05
    assert calls == [] and mgr._writer is writer
    assert slow_writes == []
    mgr.close()
    assert mgr.all_steps() == [1]


#: offers (step, force) with both a forced save of a saved step (orbax
#: raises StepAlreadyExistsError, a ValueError) and of an unsaved one
OFFERS = {
    "force_newest": [(s, False) for s in range(7)] + [(5, True), (6, True)]
    + [(s, False) for s in range(7, 13)],
    "force_older": [(s, False) for s in range(13)] + [(3, True), (13, False),
                                                      (15, False), (15, True)],
}


def _offer(mgr, step, state, force):
    try:
        return mgr.save(step, state, force=force)
    except ValueError:
        return "exists"


@pytest.mark.parametrize("offers", list(OFFERS), ids=list(OFFERS))
def test_save_offers_match_the_jax_package(tmp_path, offers):
    """Steps 0-12 offered at interval 5 with forced saves: each offer's
    answer and the steps kept (max_to_keep 3, the oldest saved pruned
    first) equal the JAX package's manager's (orbax, on the CPU)."""
    jmgr = JaxManager(str(tmp_path / "jax"), save_interval_steps=5)
    mgr = CheckpointManager(str(tmp_path / "port"), save_interval_steps=5)
    got, want = [], []
    for step, force in OFFERS[offers]:
        want.append(_offer(jmgr, step, {"w": jnp.full((2,), step)}, force))
        got.append(_offer(mgr, step, _state(float(step)), force))
    jmgr.close()
    mgr.close()
    assert got == want
    assert mgr.all_steps() == sorted(int(n) for n in
                                     os.listdir(tmp_path / "jax"))


def test_save_returns_before_the_write_and_snapshots_the_state(
        tmp_path, slow_writes):
    """The optimizers update params and moments in place: a step that
    writes into the state right after ``save`` returns leaves the
    checkpoint as it was when saved."""
    mgr = CheckpointManager(str(tmp_path))
    state = _state(1.0)
    t0 = time.perf_counter()
    assert mgr.save(1, state)
    assert time.perf_counter() - t0 < 0.15      # the write is in flight
    assert slow_writes == []
    state["params"]["w"].add_(100.0)             # the next step, in place
    state["opt_state"]["mu"]["w"].fill_(7.0)
    mgr.wait_until_finished()
    got = mgr.restore(template=_state(0.0))
    assert torch.equal(got["params"]["w"], torch.full((4, 4), 1.0))
    assert torch.equal(got["opt_state"]["mu"]["w"], torch.zeros(4, 4))
    assert got["step"] == 1


@pytest.mark.parametrize("surfaces_on", ["save", "wait_until_finished",
                                         "close"])
def test_a_failed_background_save_raises_later_and_reads_stay_committed(
        tmp_path, monkeypatch, surfaces_on):
    real = torch.save

    def save(obj, path, *a, **k):
        if obj["step"] == 2:
            with open(path, "wb") as f:
                f.write(b"half a checkpoint")
            raise OSError("disk full")
        return real(obj, path, *a, **k)

    monkeypatch.setattr(C.torch, "save", save)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save(1, _state(1.0))
    assert mgr.save(2, _state(2.0))      # returns: the write fails later
    assert mgr.latest_step() == 1        # reads do not raise
    assert mgr.restore(template=_state(0.0))["step"] == 1
    assert mgr.restore_or_init(lambda: _state(0.0))["step"] == 1
    assert os.listdir(tmp_path) == ["step_1.pt"]     # no temporary left
    with pytest.raises(OSError, match="disk full"):
        if surfaces_on == "save":
            mgr.save(3, _state(3.0))
        else:
            getattr(mgr, surfaces_on)()
    # raised once; the manager saves again
    assert mgr.save(4, _state(4.0))
    mgr.close()
    assert mgr.all_steps() == [1, 4]


def test_run_training_joins_the_saves_once_at_exit(tmp_path, slow_writes):
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=2)
    waits = []
    real_wait = mgr.wait_until_finished
    mgr.wait_until_finished = lambda: (waits.append(
        threading.active_count()), real_wait())[1]

    def step_fn(state, batch):
        assert waits == []
        new = {"params": {"w": state["params"]["w"] + 1},
               "opt_state": state["opt_state"], "step": state["step"] + 1}
        return new, {"loss": torch.tensor(0.0)}

    state, _ = run_training(step_fn, _state(0.0), None, 5, checkpoint=mgr)
    assert len(waits) == 1
    assert mgr._writer is None                   # joined
    assert mgr.all_steps() == [1, 2, 4]
    assert slow_writes == [1, 2, 4]
    got = mgr.restore(template=_state(0.0))
    assert torch.equal(got["params"]["w"], torch.full((4, 4), 4.0))


@pytest.mark.parametrize("fails", ["gang", "none"])
def test_a_failed_save_at_exit_leaves_the_loops_own_error(
        tmp_path, monkeypatch, fails):
    """Every write fails. A step that fails because its gang did still
    raises GangLostError from ``run_training`` (its exit code is what the
    executor reads), the save's error logged; a loop that ends cleanly
    raises the save's error at exit."""
    def save(obj, path, *a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(C.torch, "save", save)
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=1)

    def step_fn(state, batch):
        if fails == "gang" and state["step"] == 1:
            raise RuntimeError("gloo: connection closed by peer")
        return _state(state["step"] + 1.0), {"loss": torch.tensor(0.0)}

    # step 0's save fails in the background; the gang case fails step 1
    with pytest.raises(GangLostError if fails == "gang" else OSError):
        run_training(step_fn, _state(0.0), None,
                     2 if fails == "gang" else 1, checkpoint=mgr)
    assert mgr.all_steps() == []


def test_a_save_in_flight_commits_before_the_process_exits(tmp_path):
    code = ("import sys, time, torch\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "from tony_tpu_torch.models import checkpoint as C\n"
            "real = torch.save\n"
            "C.torch.save = lambda o, p: (time.sleep(0.5), real(o, p))\n"
            f"C.CheckpointManager({str(tmp_path)!r}).save(\n"
            "    7, {'w': torch.ones(3), 'step': 7})\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert os.listdir(tmp_path) == ["step_7.pt"]
    assert torch.equal(torch.load(tmp_path / "step_7.pt")["w"],
                       torch.ones(3))
