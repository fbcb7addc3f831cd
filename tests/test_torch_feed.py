"""The port's batch sources over files (tony_tpu_torch.io.torch_feed and
the epochal sources of tony_tpu_torch.io.prefetch) against the JAX
package's: ``array_batches``, ``reader_epochs`` and ``elastic_epochs``
byte for byte with the same engine, for several process counts and
resume steps; ``elastic_epochs``' global batch at every world size; and,
in a gloo group of 2 processes, ``global_batches``/``to_global_tensor``
on a dp mesh and train_lm's file sources on a tp mesh, where the batch is
replicated over both processes.

Engines are compared as in tests/test_torch_io.py: the Python engines
(both packages forced onto them) and the unshuffled C++ engines byte for
byte; a shuffled stream of the JAX package's C++ engine depends on its
producer thread's timing, so there the port's stream is held against the
model of its draw (tests/datafeed_model.py) and the JAX package's as a
multiset."""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import tony_tpu.io as J
import tony_tpu.io.prefetch as JP
import tony_tpu.io.reader as JR
from tony_tpu.io import jax_feed as JF
from tony_tpu.io.reader import FileSplitReader as JReader
from tony_tpu_torch.io import native as pnative
from tony_tpu_torch.io import prefetch as PP
from tony_tpu_torch.io import reader as PR
from tony_tpu_torch.io import torch_feed as PF

from datafeed_model import model_shuffle

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_feed_worker.py")
ROW = (5,)                  # records of 5 int32
GROUP_TIMEOUT_S = 120


def _files(tmp_path, rows=(37, 0, 29, 11), tail=True):
    """int32 row files (row i holds i*10 .. i*10+4 across the files), the
    first with a short tail record."""
    paths, start = [], 0
    for k, n in enumerate(rows):
        arr = (np.arange(start, start + n, dtype=np.int32)[:, None] * 10
               + np.arange(5, dtype=np.int32))
        p = tmp_path / f"rows{k}.bin"
        p.write_bytes(arr.tobytes() + (b"\x01\x02" if tail and k == 0
                                       else b""))
        paths.append(str(p))
        start += n
    return paths


def _engine(monkeypatch, engine):
    """Force both packages onto the Python engine, or check the port's
    native one builds (the JAX package then takes its own)."""
    if engine == "python":
        monkeypatch.setattr(JR, "load_native", lambda: None)
        monkeypatch.setattr(PR, "load_native", lambda: None)
    elif pnative.load_native() is None:
        pytest.skip("no C++ toolchain (g++) on this host")


def _model_rows(paths, idx, n, seed, capacity=1024):
    """The full rows of split idx/n as the native engine shuffles them:
    the model over the split's records in file order (short tails hold
    a window slot; the batcher drops them after the draw)."""
    with PR.FileSplitReader(paths, idx, n, record_size=20,
                            use_native=False) as r:
        records = list(r)
    rows = [rec for rec in model_shuffle(records, capacity, seed)
            if len(rec) == 20]
    return np.frombuffer(b"".join(rows), np.int32).reshape(-1, *ROW)


@pytest.mark.parametrize("engine", ["python", "native"])
@pytest.mark.parametrize("batch", [1, 4, 7])
def test_array_batches_equal_the_jax_packages(tmp_path, monkeypatch, batch,
                                              engine):
    _engine(monkeypatch, engine)
    paths = _files(tmp_path)
    native = engine == "native"
    for n in (1, 2, 3):
        for idx in range(n):
            with PR.FileSplitReader(paths, idx, n, record_size=20,
                                    use_native=native) as r:
                got = list(PF.array_batches(r, batch, np.int32, ROW,
                                            drop_remainder=False))
                assert all(not g.flags.writeable for g in got)
            with JReader(paths, idx, n, record_size=20,
                         use_native=native) as r:
                want = list(JF.array_batches(r, batch, np.int32, ROW,
                                             drop_remainder=False))
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert PF.record_size_for(np.int32, ROW) == JF.record_size_for(
        np.int32, ROW) == 20


@pytest.mark.parametrize("engine", ["python", "native"])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("pcount", [1, 2, 4])
def test_reader_epochs_equal_the_jax_packages(tmp_path, monkeypatch, pcount,
                                              shuffle, engine):
    _engine(monkeypatch, engine)
    paths = _files(tmp_path)
    for pid in range(pcount):
        kw = dict(shuffle=shuffle, seed=3, process_index=pid,
                  process_count=pcount)
        got_fn, got_n = PP.reader_epochs(paths, 2, np.int32, ROW, **kw)
        want_fn, want_n = JP.reader_epochs(paths, 2, np.int32, ROW, **kw)
        assert got_n == want_n > 0
        for epoch in range(3):
            got = list(got_fn(epoch))
            want = list(want_fn(epoch))
            assert len(got) == len(want) == got_n
            g, w = np.concatenate(got), np.concatenate(want)
            if engine == "native" and shuffle:
                # fixed by the files and seed + epoch alone
                assert np.concatenate(list(got_fn(epoch))).tobytes() == \
                    g.tobytes()
                model = _model_rows(paths, pid, pcount, 3 + epoch)
                assert g.tobytes() == model[:len(g)].tobytes()
                # the JAX engine's shuffled order is timing-dependent:
                # its rows come from the same split
                split = {r.tobytes() for r in _model_rows(paths, pid,
                                                          pcount, 0)}
                assert all(r.tobytes() in split for r in w)
            else:
                assert g.tobytes() == w.tobytes()


def _elastic(mod, paths, steps, pid, pcount, start_step, shuffle=True,
             seed=3):
    it, per_epoch = mod.elastic_epochs(
        paths, 8, np.int32, ROW, shuffle=shuffle, seed=seed,
        start_step=start_step, process_index=pid, process_count=pcount)
    return [next(it) for _ in range(steps)], per_epoch


@pytest.mark.parametrize("engine", ["python", "native"])
@pytest.mark.parametrize("start_step", [0, 3, 10])
@pytest.mark.parametrize("pcount", [1, 2, 4])
def test_elastic_epochs_equal_the_jax_packages(tmp_path, monkeypatch,
                                               pcount, start_step, engine):
    _engine(monkeypatch, engine)
    paths = _files(tmp_path)
    for pid in range(pcount):
        got, got_n = _elastic(PP, paths, 12, pid, pcount, start_step)
        want, want_n = _elastic(JP, paths, 12, pid, pcount, start_step)
        assert got_n == want_n == 9     # 77 full rows / global batch 8
        if engine == "python":
            assert [g.tobytes() for g in got] == [w.tobytes() for w in want]
            continue
        # native: the canonical stream is the model's, epoch by epoch
        # (seed + epoch), sliced per process
        for k, g in enumerate(got):
            step = start_step + k
            epoch, pos = divmod(step, got_n)
            canon = _model_rows(paths, 0, 1, 3 + epoch)[pos * 8:pos * 8 + 8]
            lo = pid * (8 // pcount)
            assert g.tobytes() == canon[lo:lo + 8 // pcount].tobytes()
        unshuffled, _ = _elastic(PP, paths, 12, pid, pcount, start_step,
                                 shuffle=False)
        plain, _ = _elastic(JP, paths, 12, pid, pcount, start_step,
                            shuffle=False)
        assert [g.tobytes() for g in unshuffled] == \
            [w.tobytes() for w in plain]


@pytest.mark.parametrize("engine", ["python", "native"])
def test_elastic_global_batch_is_the_same_at_every_world_size(
        tmp_path, monkeypatch, engine):
    """The canonical stream at world 1, and every world size's slices
    concatenated, agree step for step (the engine's shuffle is fixed by
    the seed); a shrink from 2 processes to 1 at a checkpoint at step 2
    feeds every step's canonical batch once."""
    _engine(monkeypatch, engine)
    paths = _files(tmp_path)
    canon, _ = _elastic(PP, paths, 20, 0, 1, 0)
    for pcount in (2, 4, 8):
        slices = [_elastic(PP, paths, 20, p, pcount, 0)[0]
                  for p in range(pcount)]
        for step in range(20):
            got = np.concatenate([s[step] for s in slices])
            assert got.tobytes() == canon[step].tobytes()
    pre = [_elastic(PP, paths, 3, p, 2, 0)[0] for p in range(2)]
    post, _ = _elastic(PP, paths, 5, 0, 1, 2)
    fed = [np.concatenate([pre[0][s], pre[1][s]]) for s in range(2)] + post
    assert [f.tobytes() for f in fed] == [c.tobytes() for c in canon[:7]]


@pytest.mark.parametrize("case", ["indivisible", "too-small", "empty-split"])
def test_source_errors_equal_the_jax_packages(tmp_path, case):
    paths = _files(tmp_path, rows=(4,), tail=False)
    errs = []
    for mod in (PP, JP):
        with pytest.raises(ValueError) as e:
            if case == "indivisible":
                mod.elastic_epochs(paths, 8, np.int32, ROW,
                                   process_index=0, process_count=3)
            elif case == "too-small":
                mod.elastic_epochs(paths, 8, np.int32, ROW,
                                   process_index=0, process_count=1)
            else:
                epoch_fn, n = mod.reader_epochs(paths, 8, np.int32, ROW,
                                                process_index=0,
                                                process_count=1)
                assert n == 0
                with mod.DevicePrefetcher(
                        epoch_fn, **({"device": "cpu"} if mod is PP
                                     else {})) as it:
                    next(it)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_producer_copies_a_read_only_batch_once(tmp_path):
    """A file batch reaches the step as writable, contiguous tensors with
    the rows' values, without a warning about a non-writable array."""
    import warnings
    from tony_tpu_torch import train_lm
    paths = _files(tmp_path, rows=(40,), tail=False)
    rows = np.fromfile(paths[0], np.int32).reshape(-1, 5)
    source = train_lm.file_source(paths, 4, 4, seed=0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with PP.DevicePrefetcher(source, device="cpu", epochs=1) as it:
            batches = list(it)
    assert len(batches) == 10
    seen = set()
    for b in batches:
        for t in b.values():
            assert t.is_contiguous() and t.dtype == torch.int32
        x, y = b["inputs"].numpy(), b["targets"].numpy()
        assert np.array_equal(x[:, 1:], y[:, :-1])
        seen.update(map(tuple, np.concatenate([x, y[:, -1:]], axis=1)))
    assert seen == set(map(tuple, rows))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_group(out_dir, paths, world=2) -> list[dict]:
    env = dict(os.environ, PYTHONPATH=REPO,
               TONY_JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{_free_port()}",
               TONY_JAX_NUM_PROCESSES=str(world))
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(out_dir, f"log{r}.txt"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(out_dir), *paths],
            env=dict(env, TONY_JAX_PROCESS_ID=str(r)), stdout=log,
            stderr=subprocess.STDOUT))
    deadline = time.monotonic() + GROUP_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not failed, "\n".join(
        open(os.path.join(out_dir, f"log{r}.txt")).read()[-3000:]
        for r in failed)
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
            for r in range(world)]


def test_world_2_global_batches_and_replicated_batches(tmp_path):
    """In a gloo group of 2: on a dp mesh each global batch's full tensor
    is the two ranks' shards concatenated, and each shard is the JAX
    package's split of that process; on a tp mesh (the batch replicated
    over both processes) both ranks feed the same rows, where the JAX
    file sources (split by process index) would feed each process
    another split into one replicated batch."""
    import jax
    from jax.sharding import Mesh

    from tony_tpu.models.train import batch_sharding as jax_batch_sharding
    paths = _files(tmp_path, rows=(40, 23))
    out = _run_group(tmp_path, paths)

    n = sum(1 for k in out[0] if k.startswith("dp/local"))
    assert n == min(J.full_records_in_split(paths, r, 2, 20) // 3
                    for r in range(2))
    for i in range(n):
        full = out[0][f"dp/full{i}"]
        np.testing.assert_array_equal(full, out[1][f"dp/full{i}"])
        np.testing.assert_array_equal(full, np.concatenate(
            [out[0][f"dp/local{i}"], out[1][f"dp/local{i}"]]))
    for r in range(2):
        with JReader(paths, r, 2, record_size=20) as reader:
            want = list(JF.array_batches(reader, 3, np.int32, ROW))[:n]
        for i in range(n):
            np.testing.assert_array_equal(out[r][f"dp/local{i}"], want[i])

    for name in ("file", "elastic"):
        assert out[0][f"tp/{name}_replicated"] and \
            out[1][f"tp/{name}_replicated"]
        for i in range(3):
            np.testing.assert_array_equal(out[0][f"tp/{name}{i}"],
                                          out[1][f"tp/{name}{i}"])
    # the rows the tp pair fed are the single split's (data-parallel size
    # 1): the port's file source at rank 0 of 1
    from tony_tpu_torch import train_lm
    first = next(iter(train_lm.file_source(paths, 2, 4, seed=0)(0)))
    np.testing.assert_array_equal(out[0]["tp/file0"], first["inputs"])

    # the JAX package on the same mesh: the batch is replicated, but its
    # file source splits by process, so its two processes read other rows
    jmesh = Mesh(np.array(jax.devices()[:2]), ("tp",))
    spec = jax_batch_sharding(jmesh, logical=("batch", "seq")).spec
    assert all(ax is None for ax in spec)
    jax_rows = [next(iter(JP.reader_epochs(
        paths, 2, np.int32, ROW, seed=0, process_index=p,
        process_count=2)[0](0))) for p in range(2)]
    assert jax_rows[0].tobytes() != jax_rows[1].tobytes()

    with pytest.raises(ValueError) as e:
        JF.to_global_array(np.zeros((2, 5), np.int32), jmesh)
    assert str(out[0]["tp/error"]) == str(e.value)
