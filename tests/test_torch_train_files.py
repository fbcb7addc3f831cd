"""File-fed training through the port's ``train_lm`` entry point on the
CPU (``--device cpu``, ``tiny``): ``--data_files`` runs to the JAX
script's ``done:`` line; an ``--elastic_data`` run stopped at step 4 and
resumed from its checkpoint feeds steps 4-7 the batches of an
uninterrupted run and ends on its loss; the port's first file batch is
the JAX script's ``file_source`` batch on the same files."""

import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tony_tpu.io.reader as JR
from tony_tpu_torch import train_lm
from tony_tpu_torch.io import native as pnative
from tony_tpu_torch.io import reader as PR

from datafeed_model import model_shuffle

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = 16

# train_lm's main with run_training wrapped to print, per step, the
# sha256 of the global batch's inputs as the step received it
_RECORDING = """
import hashlib, json, sys
sys.path.insert(0, {repo!r})
import tony_tpu_torch.runtime as rt
from tony_tpu_torch import train_lm
real = train_lm.run_training

def run_training(step_fn, state, data, steps, **kw):
    def recorded(state, batch):
        x = batch["inputs"]
        x = x.full_tensor() if hasattr(x, "full_tensor") else x
        print("BATCH " + json.dumps([int(state["step"]), hashlib.sha256(
            x.contiguous().numpy().tobytes()).hexdigest()]), flush=True)
        return step_fn(state, batch)
    return real(recorded, state, data, steps, **kw)

train_lm.run_training = run_training
try:
    rc = train_lm.main(sys.argv[1:])
finally:
    rt.shutdown()
sys.exit(rc)
"""


def _files(tmp_path, vocab=1024):
    rng = np.random.default_rng(0)
    paths = []
    for i, rows in enumerate((45, 38)):
        p = tmp_path / f"tokens{i}.bin"
        rng.integers(0, vocab, size=(rows, SEQ + 1), dtype=np.int32
                     ).tofile(p)
        paths.append(str(p))
    return paths


def _train(tmp_path, args, attempt=0):
    env = dict(os.environ, PYTHONPATH=REPO, ATTEMPT_NUMBER=str(attempt))
    out = subprocess.run(
        [sys.executable, "-c", _RECORDING.format(repo=REPO), "--device",
         "cpu", "--preset", "tiny", "--seq_len", str(SEQ), *args],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    batches = dict(json.loads(line[6:]) for line in out.stdout.splitlines()
                   if line.startswith("BATCH "))
    done = [line for line in out.stdout.splitlines()
            if line.startswith("done: final loss ")]
    assert len(done) == 1, out.stdout
    return batches, done[0], out.stdout


def test_train_lm_data_files_runs_on_the_cpu(tmp_path):
    paths = _files(tmp_path)
    batches, done, stdout = _train(tmp_path, [
        "--steps", "3", "--batch_size", "2", "--data_files", *paths])
    assert sorted(batches) == [0, 1, 2]
    assert "step 0 loss" in stdout and "step 2 loss" in stdout
    assert np.isfinite(float(done.split()[-1]))


def test_elastic_resume_feeds_the_uninterrupted_batches(tmp_path):
    paths = _files(tmp_path)
    common = ["--elastic_data", "4", "--ckpt_every", "2", "--data_files",
              *paths]
    straight, done, _ = _train(tmp_path, ["--steps", "8", "--ckpt_dir",
                                          "a", *common])
    first, _, _ = _train(tmp_path, ["--steps", "4", "--ckpt_dir", "b",
                                    *common])
    resumed, resumed_done, _ = _train(
        tmp_path, ["--steps", "8", "--ckpt_dir", "b", *common], attempt=1)
    assert sorted(straight) == list(range(8))
    assert sorted(first) == [0, 1, 2, 3] and sorted(resumed) == [4, 5, 6, 7]
    for s in range(8):
        assert (first if s < 4 else resumed)[s] == straight[s], s
    assert resumed_done == done        # f32 on the CPU: the same loss
    # 83 rows / global batch 4: 20 steps an epoch, none repeated in 8
    assert len(set(straight.values())) == 8


@pytest.mark.parametrize("engine", ["python", "native"])
def test_first_file_batch_equals_the_jax_scripts(tmp_path, monkeypatch,
                                                 engine):
    spec = importlib.util.spec_from_file_location(
        "jax_train_lm", os.path.join(REPO, "examples", "lm", "train_lm.py"))
    jax_train_lm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_train_lm)
    paths = _files(tmp_path)
    if engine == "python":
        monkeypatch.setattr(JR, "load_native", lambda: None)
        monkeypatch.setattr(PR, "load_native", lambda: None)
    elif pnative.load_native() is None:
        pytest.skip("no C++ toolchain (g++) on this host")
    for seed in (0, 1):
        got = next(iter(train_lm.file_source(paths, 4, SEQ, seed)(0)))
        want = next(iter(jax_train_lm.file_source(paths, 4, SEQ, seed)(0)))
        assert set(got) == set(want) == {"inputs", "targets"}
        if engine == "python":
            for k in got:
                assert got[k].tobytes() == want[k].tobytes()
            continue
        # the JAX package's C++ shuffle depends on its producer thread's
        # timing: hold the port's against the model of its draw
        with PR.FileSplitReader(paths, record_size=4 * (SEQ + 1),
                                use_native=False) as r:
            rows = model_shuffle(list(r), 1024, seed)[:4]
        tokens = np.frombuffer(b"".join(rows), np.int32).reshape(4, -1)
        assert got["inputs"].tobytes() == np.ascontiguousarray(
            tokens[:, :SEQ]).tobytes()
        assert got["targets"].tobytes() == np.ascontiguousarray(
            tokens[:, 1:]).tobytes()


def test_elastic_data_requires_data_files():
    with pytest.raises(SystemExit, match="requires --data_files"):
        train_lm.main(["--device", "cpu", "--elastic_data", "4"])
