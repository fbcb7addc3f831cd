"""tony_tpu_torch training loop: run_training, the prefetcher, the
checkpoint manager and the train_lm entry point, on the CPU at ``tiny``
size (f32). The JAX package's contracts (tests/test_prefetch.py,
tests/test_checkpoint.py) held inside the port."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tony_tpu_torch import train_lm
from tony_tpu_torch.io.prefetch import (DevicePrefetcher, PrefetchShapeError,
                                        synchronous_batches)
from tony_tpu_torch.models import train as TR
from tony_tpu_torch.models import transformer as T
from tony_tpu_torch.models.checkpoint import (ATTEMPT_NUMBER,
                                              CheckpointManager)
from tony_tpu_torch.models.loop import (DATA_WAIT_BUCKETS_S, GangLostError,
                                        run_training)
from tony_tpu_torch import tree_leaves
from tony_tpu_torch.runtime import metrics as metrics_mod

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = T.PRESETS["tiny"].scaled(dtype=torch.float32)


def _fresh_state():
    params = T.init_params(torch.Generator().manual_seed(0), CFG,
                           device="cpu")
    opt = TR.default_optimizer(lr=1e-2, warmup_steps=1, total_steps=10)
    step = TR.make_train_step(lambda p, b: T.lm_loss(p, b, CFG), opt)
    return step, TR.init_state(params, opt), opt


def _source(skip=0):
    src = train_lm.synthetic_source(0, 2, 16, CFG.vocab_size)
    for _ in range(skip):
        next(src)
    return src


def _feed(skip=0):
    return synchronous_batches(_source(skip), device="cpu")


def _wait_count():
    return metrics_mod.get_default().histogram(
        "tony_data_wait_seconds", buckets=DATA_WAIT_BUCKETS_S).count


def test_prefetched_and_synchronous_feeds_train_the_same():
    losses = {}
    for name in ("prefetch", "sync"):
        step, state, _ = _fresh_state()
        data = (DevicePrefetcher(_source(), device="cpu", depth=2)
                if name == "prefetch"
                else synchronous_batches(_source(), device="cpu"))
        before = _wait_count()
        state, metrics = run_training(step, state, data, 4)
        assert _wait_count() - before == 4
        assert state["step"] == 4
        losses[name] = float(metrics["loss"])
    assert losses["prefetch"] == losses["sync"]


def test_checkpoint_resume_reaches_the_uninterrupted_params(tmp_path,
                                                            monkeypatch):
    step, state, _ = _fresh_state()
    straight, _ = run_training(step, state, _feed(), 6)

    mgr = CheckpointManager(str(tmp_path), save_interval_steps=4)
    step, state, _ = _fresh_state()
    run_training(step, state, _feed(), 4, checkpoint=mgr)
    assert mgr.latest_step() == 4
    assert not [f for f in os.listdir(tmp_path) if "tmp" in f]

    monkeypatch.setenv(ATTEMPT_NUMBER, "1")
    step, _, opt = _fresh_state()
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=4)
    state = mgr.restore_or_init(lambda: TR.init_state(
        T.init_params(torch.Generator().manual_seed(9), CFG, device="cpu"),
        opt))
    assert state["step"] == 4 and state["opt_state"]["count"] == 4
    resumed, _ = run_training(step, state, _feed(skip=4), 6,
                              start_step=4, checkpoint=mgr)
    for a, b in zip(tree_leaves(resumed["params"]),
                    tree_leaves(straight["params"])):
        assert torch.equal(a, b)
    assert mgr.all_steps() == [1, 4]     # the first offered save, then 4


def test_checkpoint_manager_keeps_the_last_and_refuses_remote_paths(
        tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for s in range(1, 5):
        assert mgr.save(s, {"step": s, "w": torch.full((2,), float(s))})
    assert mgr.all_steps() == [3, 4]
    assert not mgr.save(4, {"step": 4})              # not past the latest
    got = mgr.restore(template={"step": 0, "w": torch.zeros(2)})
    assert got["step"] == 4 and torch.equal(got["w"], torch.full((2,), 4.))
    with pytest.raises(NotImplementedError):
        CheckpointManager("gs://bucket/run")
    assert CheckpointManager(str(tmp_path / "empty")).restore_or_init(
        lambda: "fresh") == "fresh"


def test_gang_loss_raises_gang_lost_error():
    def step(state, batch):
        raise RuntimeError("NCCL communicator was aborted on rank 1")

    with pytest.raises(GangLostError) as e:
        run_training(step, {}, None, 3)
    assert e.value.exit_code == 76

    def user_bug(state, batch):
        raise ValueError("shape mismatch in user code")

    with pytest.raises(ValueError):
        run_training(user_bug, {}, None, 3)


def test_prefetcher_thread_stops_on_close_and_propagates_errors():
    pf = DevicePrefetcher(_source(), device="cpu", depth=2)
    next(pf)
    thread = pf._thread
    pf.close()
    assert not thread.is_alive()
    with pytest.raises(StopIteration):
        next(pf)

    def bad():
        yield {"x": np.zeros((2, 3))}
        raise OSError("decode failed")

    pf = DevicePrefetcher(bad(), device="cpu")
    assert next(pf)["x"].shape == (2, 3)
    with pytest.raises(OSError, match="decode failed"):
        next(pf)
    pf.close()

    pf = DevicePrefetcher(iter([{"x": np.zeros(2)}, {"x": np.zeros(3)}]),
                          device="cpu")
    next(pf)
    with pytest.raises(PrefetchShapeError):
        next(pf)
    pf.close()


def test_epochal_source_cycles_and_run_training_closes_the_feed():
    pf = DevicePrefetcher(lambda e: iter([{"e": np.full(1, e)}] * 2),
                          device="cpu", epochs=2)
    seen = [int(b["e"][0]) for b in pf]
    assert seen == [0, 0, 1, 1]
    step, state, _ = _fresh_state()
    pf = DevicePrefetcher(_source(), device="cpu")
    run_training(step, state, pf, 1)
    assert not pf._thread.is_alive()


def test_train_lm_without_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lm.main(["--preset", "tiny", "--steps", "1"])


def test_train_lm_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "tony_tpu_torch.train_lm", "--device", "cpu",
         "--preset", "tiny", "--steps", "3", "--batch_size", "2",
         "--seq_len", "32"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "step 0 loss" in out.stdout
    assert "done: final loss" in out.stdout
