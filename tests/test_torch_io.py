"""The port's data-feed layer (tony_tpu_torch.io, tony_tpu_torch.storage)
against the JAX package's on the same files: the split math, the codecs,
FileSplitReader's record streams for every framing, split count, shuffle
setting and engine, spill delivery, gs:// inputs through a fake gsutil,
and the error messages.

Engines are compared like with like. The Python engines are equal record
for record, shuffled or not; so are the C++ engines unshuffled. A
shuffled stream of the JAX package's C++ engine depends on how far its
producer thread has read when the consumer draws (the window is drawn
from before it is refilled), so it is compared as a multiset, the only
thing that engine guarantees; the port's engine draws every record from a
full window, so its stream is fixed, and it is held record for record
against a model of its draw: ``std::mt19937_64`` and libstdc++'s
``uniform_int_distribution`` (Lemire's method for a 64-bit generator)
over the split's records in file order."""

import hashlib
import os
import random
import sys
import time

import numpy as np
import pytest
import torch

import tony_tpu.io as J
import tony_tpu_torch.io as P
from tony_tpu.io import avro as javro
from tony_tpu.io import framed as jframed
from tony_tpu.io import snappy as jsnappy
from tony_tpu.storage import GcsStorage as JGcs
from tony_tpu.storage import register_storage as jregister
from tony_tpu_torch.io import avro as pavro
from tony_tpu_torch.io import framed as pframed
from tony_tpu_torch.io import native as pnative
from tony_tpu_torch.io import snappy as psnappy
from tony_tpu_torch.storage import GcsStorage as PGcs
from tony_tpu_torch.storage import register_storage as pregister

from datafeed_model import MT19937_64, model_shuffle

torch.set_num_threads(2)

FAKE_GSUTIL = os.path.join(os.path.dirname(__file__), "fake_gsutil.py")
AVRO_SCHEMA = {
    "type": "record", "name": "Row", "namespace": "tony.test",
    "fields": [
        {"name": "id", "type": "long"},
        {"name": "payload", "type": "bytes"},
        {"name": "tag", "type": ["null", "string"]},
    ],
}
SYNC = bytes(range(16))
FRAMINGS = ["fixed", "lines", "framed", "avro-null", "avro-deflate",
            "avro-snappy"]
CAPACITY = 16       # a window much smaller than a split: the shuffle bites


def test_mt19937_64_model_is_the_standard_generator():
    gen = MT19937_64(5489)
    for _ in range(9999):
        gen()
    assert gen() == 9981545732273789042   # [rand.predef] of the C++ standard


# --- data --------------------------------------------------------------------
def _avro_rows(n, seed=7):
    rng = random.Random(seed)
    return [{"id": i,
             "payload": bytes(rng.randrange(256)
                              for _ in range(rng.randrange(0, 300))),
             "tag": None if i % 3 == 0 else f"t{i}"}
            for i in range(n)]


def _write(tmp_path, framing):
    """Two files of ``framing`` (written with the JAX package's writers);
    returns (paths, record_size) for the reader."""
    rng = random.Random(11)
    if framing == "fixed":
        paths = []
        for i, rows in enumerate((53, 71)):
            p = tmp_path / f"f{i}.bin"
            p.write_bytes(bytes(rng.randrange(256) for _ in range(rows * 24)
                                ) + b"tail")    # a short tail record
            paths.append(str(p))
        return paths, 24
    if framing == "lines":
        paths = []
        for i in range(2):
            p = tmp_path / f"l{i}.txt"
            p.write_bytes(b"".join(
                f"line-{i}-{j:04d}-{'x' * rng.randrange(40)}\n".encode()
                for j in range(90)))
            paths.append(str(p))
        return paths, 0
    if framing == "framed":
        paths = []
        for i in range(2):
            p = str(tmp_path / f"r{i}.tony1")
            with jframed.FramedWriter(p, schema={"k": i},
                                      block_bytes=300) as w:
                for j in range(80):
                    w.append(b"r%d-%03d-" % (i, j) + bytes(
                        rng.randrange(256) for _ in range(rng.randrange(60))))
            paths.append(p)
        return paths, None
    codec = framing.split("-")[1]
    rows = _avro_rows(97)
    paths = []
    for i, part in enumerate((rows[:50], rows[50:])):
        p = str(tmp_path / f"a{i}.avro")
        with javro.AvroWriter(p, AVRO_SCHEMA, codec=codec,
                              block_records=7) as w:
            for row in part:
                w.append(row)
        paths.append(p)
    return paths, None


def _read(pkg, paths, idx, n, record_size, **kw):
    with pkg.FileSplitReader(paths, idx, n, record_size=record_size,
                             capacity=CAPACITY, **kw) as r:
        return list(r), r.is_native, r.schema_json


def _need_native():
    if pnative.load_native() is None:
        pytest.skip("no C++ toolchain (g++) on this host")


@pytest.mark.parametrize("engine", ["python", "native"])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("framing", FRAMINGS)
def test_reader_streams_equal_the_jax_readers(tmp_path, framing, n, shuffle,
                                              engine):
    paths, rs = _write(tmp_path, framing)
    native = engine == "native"
    if native:
        _need_native()
    if native and framing.startswith("avro"):
        # Avro boundaries are schema-driven: neither C++ engine takes it
        errs = []
        for pkg in (J, P):
            with pytest.raises(pkg.DataFeedError) as e:
                pkg.FileSplitReader(paths, 0, n, use_native=True)
            errs.append(str(e.value))
        assert errs[0] == errs[1]
        return
    total = []
    for idx in range(n):
        kw = dict(shuffle=shuffle, seed=5 + idx, use_native=native)
        got, got_native, schema = _read(P, paths, idx, n, rs, **kw)
        want, want_native, want_schema = _read(J, paths, idx, n, rs, **kw)
        assert got_native == want_native == native
        assert schema == want_schema
        if shuffle and native:
            assert sorted(got) == sorted(want)
            fifo, _, _ = _read(P, paths, idx, n, rs, use_native=True)
            assert got == model_shuffle(fifo, CAPACITY, 5 + idx)
            assert got != fifo
        else:
            assert got == want
        total += got
    plain, _, _ = _read(J, paths, 0, 1, rs, use_native=False)
    assert sorted(total) == sorted(plain)      # every record exactly once


def test_default_engine_is_native_when_it_builds(tmp_path):
    _need_native()
    paths, rs = _write(tmp_path, "fixed")
    with P.FileSplitReader(paths, record_size=rs) as r:
        assert r.is_native
    avro, _ = _write(tmp_path, "avro-null")
    with P.FileSplitReader(avro) as r:
        assert not r.is_native


@pytest.mark.parametrize("slow", [False, True])
def test_native_shuffle_does_not_depend_on_the_consumers_pace(tmp_path,
                                                              slow):
    """A consumer that drains as fast as it can and one that sleeps
    between pulls get the same stream: the window is full at every draw,
    whatever the producer thread has read."""
    _need_native()
    p = tmp_path / "rows.bin"
    np.arange(4000 * 4, dtype=np.int32).tofile(p)

    def stream(pace):
        out = []
        with P.FileSplitReader([str(p)], record_size=16, shuffle=True,
                               seed=3, capacity=64, use_native=True) as r:
            while batch := r.next_batch(16):
                out += batch
                if pace:
                    time.sleep(0.0002)
        return hashlib.sha256(b"".join(out)).hexdigest()

    want = stream(False)
    assert all(stream(slow) == want for _ in range(3))


@pytest.mark.parametrize("how", ["close", "drop"])
def test_native_reader_releases_a_blocked_producer(tmp_path, how):
    """A reader closed (or dropped) mid-split, its producer blocked on a
    full read-ahead, lets the producer go: the close, which joins the
    engine's thread, returns at once."""
    import gc
    _need_native()
    p = tmp_path / "rows.bin"
    np.arange(20000 * 4, dtype=np.int32).tofile(p)
    for shuffle in (False, True):
        r = P.FileSplitReader([str(p)], record_size=16, shuffle=shuffle,
                              capacity=8, use_native=True)
        assert len(r.next_batch(4)) == 4
        time.sleep(0.05)               # the producer fills up and blocks
        t0 = time.perf_counter()
        if how == "close":
            r.close()
            assert r.next_batch(4) == []
        else:
            del r
            gc.collect()
        assert time.perf_counter() - t0 < 2.0


@pytest.mark.parametrize("case", range(6))
def test_split_math_equals_the_jax_packages(tmp_path, case):
    rng = np.random.default_rng(case)
    sizes = [int(s) for s in rng.integers(0, 5000, size=int(rng.integers(
        1, 6)))]
    paths = [f"/nonexistent/f{i}" for i in range(len(sizes))]
    total = sum(sizes)
    for n in (1, 2, 3, 7):
        for idx in range(n):
            assert P.split_start(total, idx, n) == J.split_start(total, idx, n)
            assert (P.split_length(total, idx, n)
                    == J.split_length(total, idx, n))
            got = P.compute_read_info(paths, idx, n, sizes=sizes)
            want = J.compute_read_info(paths, idx, n, sizes=sizes)
            assert [(s.path, s.offset, s.length) for s in got] == \
                [(s.path, s.offset, s.length) for s in want]
            for rs in (1, 13, 4100):
                assert (P.full_records_in_split(paths, idx, n, rs, sizes)
                        == J.full_records_in_split(paths, idx, n, rs, sizes))


@pytest.mark.parametrize("kind", ["snappy", "avro-null", "avro-deflate",
                                  "avro-snappy", "framed"])
def test_codecs_write_the_same_bytes_and_read_each_other(tmp_path, kind):
    if kind == "snappy":
        data = b"".join(bytes([i % 7]) * (i % 50) + os.urandom(i % 9)
                        for i in range(400))
        packed = psnappy.compress(data)
        assert packed == jsnappy.compress(data)
        assert psnappy.decompress(jsnappy.compress(data)) == data
        assert jsnappy.decompress(packed) == data
        return
    if kind == "framed":
        recs = [b"x" * (i % 37) + b"%d" % i for i in range(120)]
        files = {}
        for name, mod in (("port", pframed), ("jax", jframed)):
            files[name] = str(tmp_path / f"{name}.tony1")
            with mod.FramedWriter(files[name], schema={"s": 1},
                                  block_bytes=256, sync=SYNC) as w:
                for r in recs:
                    w.append(r)
        assert open(files["port"], "rb").read() == \
            open(files["jax"], "rb").read()
        assert list(pframed.iter_file_records(files["jax"])) == recs
        assert list(jframed.iter_file_records(files["port"])) == recs
        return
    codec = kind.split("-")[1]
    rows = _avro_rows(60)
    files = {}
    for name, mod in (("port", pavro), ("jax", javro)):
        files[name] = str(tmp_path / f"{name}.avro")
        with mod.AvroWriter(files[name], AVRO_SCHEMA, codec=codec,
                            block_records=9, sync=SYNC) as w:
            for row in rows:
                w.append(row)
    assert open(files["port"], "rb").read() == open(files["jax"], "rb").read()
    assert list(pavro.iter_file_values(files["jax"])) == rows
    assert list(javro.iter_file_values(files["port"])) == rows


@pytest.mark.parametrize("budget", [{"max_records": 17},
                                    {"max_bytes": 2048}])
def test_spill_mode_equals_the_jax_readers(tmp_path, budget):
    paths, _ = _write(tmp_path, "framed")
    spilled = {}
    for name, pkg, fr in (("port", P, pframed), ("jax", J, jframed)):
        out, files = [], 0
        with pkg.FileSplitReader(paths, use_native=False) as r:
            r.next_batch(5)        # mixing delivery modes skips nothing
            while (path := r.next_batch_spill(
                    str(tmp_path / f"spill-{name}"), **budget)) is not None:
                files += 1
                assert fr.read_path_header(path).schema == {"k": 0}
                out += list(fr.iter_file_records(path))
        spilled[name] = (out, files)
    assert spilled["port"] == spilled["jax"]
    assert spilled["port"][1] > 2


def _fake_gcs(tmp_path, monkeypatch):
    root = tmp_path / "gcs"
    root.mkdir(exist_ok=True)
    monkeypatch.setenv("FAKE_GCS_ROOT", str(root))
    shim = tmp_path / "gsutil"
    shim.write_text(
        f"#!/bin/bash\nexec {sys.executable} -S {FAKE_GSUTIL} \"$@\"\n")
    shim.chmod(0o755)
    pregister("gs", PGcs(gsutil=str(shim)))
    jregister("gs", JGcs(gsutil=str(shim)))
    return root


@pytest.mark.parametrize("framing", ["fixed", "lines", "framed",
                                     "avro-snappy"])
def test_gs_inputs_read_like_the_jax_readers(tmp_path, monkeypatch,
                                             framing):
    """gs:// inputs through tests/fake_gsutil.py: the port's reader (its
    storage seam's ranged reads, the Python engine with its prefetch
    thread) yields the JAX reader's records over the same objects, and
    the same records as the local files."""
    paths, rs = _write(tmp_path, framing)
    root = _fake_gcs(tmp_path, monkeypatch)
    try:
        bucket = root / "bucket" / "ds"
        bucket.mkdir(parents=True)
        for lp in paths:
            (bucket / os.path.basename(lp)).write_bytes(open(lp, "rb").read())
        gs = [f"gs://bucket/ds/{os.path.basename(lp)}" for lp in paths]
        for n in (1, 2):
            for idx in range(n):
                got, native, _ = _read(P, gs, idx, n, rs, shuffle=True,
                                       seed=idx)
                want, _, _ = _read(J, gs, idx, n, rs, shuffle=True, seed=idx)
                local, _, _ = _read(P, paths, idx, n, rs, shuffle=True,
                                    seed=idx, use_native=False)
                assert not native
                assert got == want == local
        why = "Avro" if framing.startswith("avro") else "local files only"
        with pytest.raises(P.DataFeedError, match=why):
            P.FileSplitReader(gs, record_size=rs, use_native=True)
    finally:
        pregister("gs", None)
        jregister("gs", None)


def _framed_file(tmp_path, name, recs, block_bytes=200, schema=None):
    p = str(tmp_path / name)
    with jframed.FramedWriter(p, schema=schema or {},
                              block_bytes=block_bytes) as w:
        for r in recs:
            w.append(r)
    return p


def _corrupt(path, offset, value=None, xor=0xFF):
    data = bytearray(open(path, "rb").read())
    data[offset] = value if value is not None else data[offset] ^ xor
    open(path, "wb").write(bytes(data))


def _case_framed_count(tmp_path):
    path = _framed_file(tmp_path, "x.tony1", [b"hello", b"world"])
    _corrupt(path, 47)                  # the first block's record count
    return [path], {"use_native": False}


def _case_framed_record_length(tmp_path, native):
    path = _framed_file(tmp_path, "cl.tony1", [b"A" * 10, b"B" * 10],
                        block_bytes=1 << 20)
    _corrupt(path, 28 + 24, value=200)  # the first record's length field
    return [path], {"use_native": native}


def _case_truncated_sync(tmp_path, native):
    path = _framed_file(tmp_path, "t.tony1", [b"A" * 10, b"B" * 10],
                        block_bytes=1 << 20)
    with open(path, "ab") as f:
        f.write(b"\x01\x02\x03\x04\x05")     # a torn trailing sync marker
    return [path], {"use_native": native}


def _case_mixed(tmp_path, kind):
    plain = tmp_path / "m.jsonl"
    plain.write_bytes(b"line\n")
    if kind == "framed":
        other = _framed_file(tmp_path, "m.tony1", [b"x"])
    else:
        other = str(tmp_path / "m.avro")
        with javro.AvroWriter(other, AVRO_SCHEMA) as w:
            w.append(_avro_rows(1)[0])
    return [other, str(plain)], {}


def _case_missing(tmp_path):
    path = _framed_file(tmp_path, "ok.tony1", [b"x"])
    return [path, str(tmp_path / "nope.tony1")], {}


def _case_avro_sync(tmp_path):
    path = str(tmp_path / "c.avro")
    with javro.AvroWriter(path, AVRO_SCHEMA, block_records=5) as w:
        for row in _avro_rows(40):
            w.append(row)
    data = bytearray(open(path, "rb").read())
    hdr = javro.read_path_header(path)
    at = bytes(data).find(hdr.sync, hdr.data_start)
    data[at:at + 4] = b"XXXX"            # the sync after the first block
    open(path, "wb").write(bytes(data))
    return [path], {}


def _case_avro_native(tmp_path):
    path = str(tmp_path / "n.avro")
    with javro.AvroWriter(path, AVRO_SCHEMA) as w:
        for row in _avro_rows(3):
            w.append(row)
    return [path], {"use_native": True}


ERROR_CASES = {
    "framed-count": _case_framed_count,
    "framed-record-length-python":
        lambda t: _case_framed_record_length(t, False),
    "framed-record-length-native":
        lambda t: _case_framed_record_length(t, True),
    "framed-truncated-sync-python": lambda t: _case_truncated_sync(t, False),
    "framed-truncated-sync-native": lambda t: _case_truncated_sync(t, True),
    "framed-mixed": lambda t: _case_mixed(t, "framed"),
    "avro-mixed": lambda t: _case_mixed(t, "avro"),
    "missing-path": _case_missing,
    "avro-corrupt-sync": _case_avro_sync,
    "avro-native-requested": _case_avro_native,
}


def _error_of(pkg, paths, kw):
    try:
        with pkg.FileSplitReader(paths, **kw) as r:
            list(r)
    except Exception as e:          # noqa: BLE001 — the error is the result
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_errors_equal_the_jax_readers(tmp_path, case):
    paths, kw = ERROR_CASES[case](tmp_path)
    if kw.get("use_native") and not case.startswith("avro"):
        _need_native()
    got, want = _error_of(P, paths, kw), _error_of(J, paths, kw)
    assert want is not None
    assert got == want
