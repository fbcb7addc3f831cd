"""Sharded file-split reader: the port's data-feed engine.

Rebuild of the reference's ``HdfsAvroFileSplitReader`` (reference: tony-core/
src/main/java/com/linkedin/tony/io/HdfsAvroFileSplitReader.java): the
executor is Python, so no py4j gateway is needed — the engine is a C++
shared library (``native/datafeed.cc``, built into the repository's
``build/`` at first use) reached over ctypes, with a pure-Python engine
carrying the same semantics when no toolchain is available. The native
engine is taken whenever it builds (``use_native=None``);
:attr:`FileSplitReader.is_native` says which one a reader runs.

Semantics kept from the reference:
  * contiguous global byte-range split across tasks
    (``split.compute_read_info``, reference :286-297)
  * record-boundary sync at split starts (reference :242 Avro block sync;
    here fixed-size, newline, or TONY1 framed-block framing)
  * a schema channel: framed files carry a JSON schema in their header,
    surfaced via :meth:`FileSplitReader.schema_json` (the analog of
    ``getSchemaJson`` :446)
  * bounded prefetch buffer, optionally shuffling — a streaming shuffle
    whose window is the buffer capacity (reference InternalBuffer :678).
    Each engine draws every shuffled record from a full window, so its
    stream is fixed by the files and the seed alone; the two engines
    draw with different generators (``std::mt19937_64`` and
    ``random.Random``), so their shuffled orders differ
  * three delivery modes: packed byte batches (``next_batch``), ndarray
    batches (``torch_feed``), and local-disk spill for batches larger than
    memory (``next_batch_spill``, the analog of
    ``nextBatchFileLocalSpill`` :525)

Usage::

    reader = FileSplitReader(paths, task_index=i, task_num=n,
                             shuffle=True, seed=epoch)   # framing auto
    print(reader.schema_json)   # "" unless the files are TONY1 framed
    for rec in reader:          # bytes objects
        ...
    reader.close()
"""

from __future__ import annotations

import collections
import ctypes
import itertools
import logging
import random
import weakref
from typing import Iterator

from tony_tpu_torch.io import avro as _avro
from tony_tpu_torch.io import framed as _framed
from tony_tpu_torch.io.native import load_native
from tony_tpu_torch.io.split import FileSegment, compute_read_info
from tony_tpu_torch.storage import is_remote, sopen

log = logging.getLogger(__name__)

_BATCH_BUF_CAP = 1 << 22          # 4 MiB packed-record buffer per pull
_DEFAULT_CAPACITY = 1024


class DataFeedError(RuntimeError):
    pass


class _NativeImpl:
    """ctypes wrapper over the C++ engine (producer thread lives in C++)."""

    def __init__(self, segments: list[FileSegment], record_size: int,
                 capacity: int, shuffle: bool, seed: int, lib) -> None:
        self._lib = lib
        n = len(segments)
        paths = (ctypes.c_char_p * n)(
            *[s.path.encode() for s in segments])
        offsets = (ctypes.c_int64 * n)(*[s.offset for s in segments])
        lengths = (ctypes.c_int64 * n)(*[s.length for s in segments])
        self._h = lib.tdf_open(paths, offsets, lengths, n, record_size,
                               capacity, 1 if shuffle else 0, seed)
        if not self._h:
            raise DataFeedError("tdf_open failed")
        self._buf = ctypes.create_string_buffer(_BATCH_BUF_CAP)
        self._lens = (ctypes.c_int64 * 4096)()
        # Guarantees tdf_close even when the reader is dropped without
        # close() — otherwise the C++ producer thread blocks in Push()
        # forever, pinning the thread, fd, and buffered records.
        self._finalizer = weakref.finalize(self, _close_native, lib, self._h)

    def next_batch(self, max_records: int) -> list[bytes]:
        if self._h is None:
            # Match the Python impl's post-close behavior instead of handing
            # a NULL handle to C++ (nullptr deref, interpreter crash).
            return []
        max_records = min(max_records, len(self._lens))
        n = self._lib.tdf_next_batch(self._h, self._buf, _BATCH_BUF_CAP,
                                     self._lens, max_records)
        if n == -1:
            raise DataFeedError(self._lib.tdf_error(self._h).decode())
        if n == -2:
            raise DataFeedError(
                f"record larger than {_BATCH_BUF_CAP} byte pull buffer")
        # Copy only the bytes actually used (Array.raw would materialize the
        # whole 4 MiB buffer per pull).
        ends = list(itertools.accumulate(self._lens[:n]))
        raw = ctypes.string_at(self._buf, ends[-1] if ends else 0)
        return [raw[a:b] for a, b in zip([0] + ends[:-1], ends)]

    def close(self) -> None:
        self._finalizer()
        self._h = None


def _close_native(lib, handle) -> None:
    lib.tdf_close(handle)


_SENTINEL = object()


def _prefetch_producer(records, q, stop, error_box) -> None:
    """Prefetch producer body (module-level: must not close over the
    reader). Decodes ahead of the training loop; a decode error lands in
    ``error_box`` and is re-raised by the consumer — never swallowed in a
    daemon thread. The trailing sentinel is best-effort with a bounded
    loop: consumers use timeout-gets that re-check ``stop``, so a missing
    sentinel cannot deadlock them."""
    import queue
    try:
        for rec in records:
            while not stop.is_set():
                try:
                    q.put(rec, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if stop.is_set():
                return
    except BaseException as e:
        error_box.append(e)
    finally:
        for _ in range(50):
            try:
                q.put(_SENTINEL, timeout=0.1)
                break
            except queue.Full:
                if stop.is_set():
                    break


def _stop_producer(stop, q) -> None:
    """Finalizer for dropped readers: release the producer thread (it
    exits its put loop once ``stop`` is set and the queue has room)."""
    stop.set()
    try:
        q.get_nowait()
    except Exception:
        pass


class _PythonImpl:
    """Pure-Python engine: same framing, sync, and windowed-shuffle
    semantics as the C++ engine, with an optional background PREFETCH
    thread (``prefetch=True``) that decodes ahead into a bounded queue —
    the DataFetcher-thread property (reference InternalBuffer:678) for
    the formats only this engine speaks (Avro). Without it the impl is
    fully synchronous (toolchain-less hosts, deterministic tests)."""

    def __init__(self, segments: list[FileSegment], record_size: int,
                 capacity: int, shuffle: bool, seed: int,
                 prefetch: bool = False) -> None:
        self._records = self._generate(segments, record_size)
        # list for shuffle (O(1) swap-remove at a random slot), deque for
        # FIFO (O(1) popleft; list.pop(0) would shift the whole window).
        self._pool: list[bytes] | collections.deque[bytes] = (
            [] if shuffle else collections.deque())
        self._capacity = max(1, capacity)
        self._shuffle = shuffle
        self._rng = random.Random(seed)
        self._exhausted = False
        self._queue = None
        self._producer = None
        #: one-slot box the producer stores a decode error into (read and
        #: re-raised by the consumer in _fill)
        self._error_box: list = []
        if prefetch:
            import queue
            import threading
            import weakref
            # queue depth is capacity/4, ON TOP of the capacity-sized
            # shuffle pool: enough decode-ahead overlap without silently
            # doubling the documented buffer residency
            self._queue = queue.Queue(maxsize=max(8, self._capacity // 4))
            self._stop = threading.Event()
            # The producer must NOT hold a reference to self (it would pin
            # the reader and the finalizer below could never fire): it
            # gets the generator/queue/flag directly.
            self._producer = threading.Thread(
                target=_prefetch_producer,
                args=(self._records, self._queue, self._stop,
                      self._error_box),
                name="tony-datafeed-prefetch", daemon=True)
            self._producer.start()
            # A reader dropped without close() must not leave the producer
            # spinning on a full queue forever (the native impl guards the
            # same hazard with its own finalizer).
            self._finalizer = weakref.finalize(
                self, _stop_producer, self._stop, self._queue)

    @staticmethod
    def _generate(segments: list[FileSegment],
                  record_size: int) -> Iterator[bytes]:
        for seg in segments:
            if record_size == -1:           # TONY1 framed blocks
                yield from _framed.iter_segment_records(
                    seg.path, seg.offset, seg.length)
                continue
            if record_size == -2:           # Avro object container
                yield from _avro.iter_segment_records(
                    seg.path, seg.offset, seg.length)
                continue
            with sopen(seg.path) as f:
                if record_size > 0:
                    first = -(-seg.offset // record_size)
                    end_excl = -(-(seg.offset + seg.length) // record_size)
                    f.seek(first * record_size)
                    for _ in range(first, end_excl):
                        data = f.read(record_size)
                        if not data:
                            break
                        yield data
                else:
                    # Hadoop line-split convention: a reader starting
                    # mid-file always discards through the first '\n' (even
                    # when the offset lands exactly on a line start), and
                    # reads lines while position-before-line <= end — so the
                    # line straddling/starting at a boundary belongs to
                    # exactly one split.
                    f.seek(seg.offset)
                    pos = seg.offset
                    if seg.offset > 0:
                        skipped = f.readline()
                        pos += len(skipped)
                    end = seg.offset + seg.length
                    while pos <= end:
                        line = f.readline()
                        if not line:
                            break
                        pos += len(line)
                        yield line.rstrip(b"\n")

    def _fill(self) -> None:
        if self._queue is not None:
            import queue
            while not self._exhausted and len(self._pool) < self._capacity:
                try:
                    # timeout + stop re-check: a cross-thread close() may
                    # retire the producer before its sentinel lands
                    item = self._queue.get(timeout=0.2)
                except queue.Empty:
                    if self._stop.is_set():
                        self._exhausted = True
                    continue
                if item is _SENTINEL:
                    self._exhausted = True
                    if self._error_box:
                        raise self._error_box.pop()
                else:
                    self._pool.append(item)
            return
        while not self._exhausted and len(self._pool) < self._capacity:
            try:
                self._pool.append(next(self._records))
            except StopIteration:
                self._exhausted = True

    def next_batch(self, max_records: int) -> list[bytes]:
        out: list[bytes] = []
        while len(out) < max_records:
            self._fill()
            if not self._pool:
                break
            if self._shuffle:
                idx = self._rng.randrange(len(self._pool))
                self._pool[idx], self._pool[-1] = (self._pool[-1],
                                                   self._pool[idx])
                out.append(self._pool.pop())        # swap-remove: O(1)
            else:
                out.append(self._pool.popleft())    # FIFO: O(1)
        return out

    def close(self) -> None:
        self._pool.clear()
        self._exhausted = True
        if self._producer is not None:
            # stop the producer FIRST: gen.close() on a generator another
            # thread is executing raises ValueError
            self._stop.set()
            while True:       # unblock a put() stuck on a full queue
                try:
                    self._queue.get_nowait()
                except Exception:
                    break
            self._producer.join(timeout=5)
            if self._producer.is_alive():
                # stuck inside the generator (hung IO): leave the daemon
                # thread to die with the process rather than raise from
                # closing a generator another thread is executing — but
                # drain and DROP the queue (and the finalizer's reference
                # to it) so already-decoded records are GC-able instead of
                # pinned behind a wedged thread. The producer keeps its own
                # queue reference; any residual puts it lands before dying
                # are bounded by the queue capacity.
                log.warning("datafeed prefetch thread did not exit; "
                            "leaving generator to the daemon thread")
                while True:
                    try:
                        self._queue.get_nowait()
                    except Exception:
                        break
                self._finalizer.detach()   # stop already set; queue drained
                self._queue = None
                return
        # Release the fd held by the suspended generator now, not at GC time
        # (the native impl guarantees this via its finalizer).
        self._records.close()


class FileSplitReader:
    """Task-sharded record reader over a list of files.

    Parameters mirror the reference's constructor (HdfsAvroFileSplitReader
    :347 — conf, paths, taskIndex, numTasks, shuffle), with ``record_size``
    selecting the framing (0 = newline-delimited, >0 = fixed-size records).
    """

    def __init__(self, paths: list[str], task_index: int = 0,
                 task_num: int = 1, record_size: int | None = None,
                 shuffle: bool = False, seed: int = 0,
                 capacity: int = _DEFAULT_CAPACITY,
                 use_native: bool | None = None,
                 sizes: list[int] | None = None) -> None:
        #: schema channel (reference getSchemaJson:446): the JSON schema
        #: from the first framed/Avro file's header, "" for unframed data.
        self.schema_json = ""
        # record_size None = auto: every path is classified (TONY1 framed /
        # Avro container / unframed) and the kinds must AGREE — parsing a
        # framed or Avro file as lines would silently yield garbage, so a
        # mixed list is rejected whatever the ordering. -1 forces framed,
        # -2 forces Avro (header read below raises on a mismatched file).
        if record_size is None:
            if paths:
                def _kind(p: str) -> int:
                    if _framed.is_framed_file(p):
                        return -1
                    return -2 if _avro.is_avro_file(p) else 0
                kinds = [_kind(p) for p in paths]
                if len(set(kinds)) > 1:
                    names = {-1: "TONY1 framed", -2: "Avro", 0: "unframed"}
                    detail = ", ".join(
                        f"{p} is {names[k]}" for p, k in zip(paths, kinds))
                    raise ValueError(f"mixed framings ({detail}); pass "
                                     f"record_size explicitly")
                record_size = kinds[0]
            else:
                record_size = 0
        if record_size < -2:
            raise ValueError("record_size must be -2 (avro), -1 (framed), "
                             "0 (lines), or a positive fixed size")
        self.record_size = record_size
        if paths and record_size == -1:
            self.schema_json = _framed.read_path_header(paths[0]).schema_json
        elif paths and record_size == -2:
            self.schema_json = _avro.read_path_header(paths[0]).schema_json
        self.segments = compute_read_info(paths, task_index, task_num,
                                          sizes=sizes)
        #: records pulled past a spill-call budget, served before new pulls
        self._spill_carry: list[bytes] = []
        # Avro record boundaries are schema-driven (skip_datum walks the
        # schema), so the Avro arm runs on the Python engine; the C++
        # engine speaks the byte-framed formats (fixed/lines/TONY1).
        if record_size == -2:
            if use_native is True:
                raise DataFeedError(
                    "the native engine does not decode Avro (record "
                    "boundaries are schema-driven); omit use_native")
            use_native = False
        # Remote (gs://) inputs stream through the storage seam's ranged
        # reader — the C++ engine only speaks local fds.
        if any(is_remote(p) for p in paths):
            if use_native is True:
                raise DataFeedError(
                    "the native engine reads local files only; remote "
                    "(gs://) inputs use the Python engine — omit use_native")
            use_native = False
        lib = load_native() if use_native in (None, True) else None
        if use_native is True and lib is None:
            raise DataFeedError("native data-feed requested but unavailable")
        if lib is not None:
            self._impl: _NativeImpl | _PythonImpl = _NativeImpl(
                self.segments, record_size, capacity, shuffle, seed, lib)
            self.is_native = True
        else:
            # Avro and remote (gs://) inputs are production-served by the
            # Python engine, so they get the background prefetch thread
            # (the C++ engine's DataFetcher property) — for remote inputs
            # it overlaps ranged fetches with training; the plain local
            # fallback stays synchronous. Window contents are identical
            # either way (single FIFO producer), so shuffle determinism
            # is unchanged.
            self._impl = _PythonImpl(
                self.segments, record_size, capacity, shuffle, seed,
                prefetch=(record_size == -2
                          or any(is_remote(p) for p in paths)))
            self.is_native = False

    def schema(self) -> dict:
        """Parsed schema from the framed-file header ({} when absent)."""
        import json
        return json.loads(self.schema_json) if self.schema_json else {}

    def next_batch(self, max_records: int = 256) -> list[bytes]:
        """Up to ``max_records`` records; [] at end of split (the analog of
        the reference's nextBatchBytes :598)."""
        if self._spill_carry:
            # records pulled past a spill-call budget are served first so
            # mixing delivery modes never skips data
            out = self._spill_carry[:max_records]
            self._spill_carry = self._spill_carry[max_records:]
            return out
        return self._impl.next_batch(max_records)

    def next_batch_spill(self, spill_dir: str, max_records: int = 1 << 62,
                         max_bytes: int = 1 << 62) -> str | None:
        """Local-spill delivery (reference nextBatchFileLocalSpill:525):
        stream up to ``max_records``/``max_bytes`` of records into a TONY1
        framed file under ``spill_dir`` and return its path — for batches
        too large to hold in memory. Returns None at end of split. Read
        back with :func:`tony_tpu_torch.io.framed.iter_file_records`; the
        caller owns deletion."""
        import os
        import uuid
        os.makedirs(spill_dir, exist_ok=True)
        path = os.path.join(spill_dir, f"spill-{uuid.uuid4().hex}.tony1")
        wrote = 0
        # Records pulled past a previous call's budget carry over — a pull
        # batch must never be dropped on the floor at a budget boundary.
        carry = self._spill_carry
        with _framed.FramedWriter(path, schema=self.schema_json or {}) as w:
            # budget applies only once a record is in: a header larger than
            # max_bytes must not masquerade as end-of-split (None)
            while wrote < max_records and (wrote == 0
                                           or w.total_bytes < max_bytes):
                batch = carry or self._impl.next_batch(
                    min(256, max_records - wrote))
                carry = []
                if not batch:
                    break
                for i, rec in enumerate(batch):
                    w.append(rec)
                    wrote += 1
                    if wrote >= max_records or w.total_bytes >= max_bytes:
                        carry = batch[i + 1:]
                        break
        self._spill_carry = carry
        if wrote == 0:
            os.remove(path)
            return None
        return path

    def __iter__(self) -> Iterator[bytes]:
        while True:
            batch = self.next_batch()
            if not batch:
                return
            yield from batch

    def close(self) -> None:
        self._impl.close()

    def __enter__(self) -> "FileSplitReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
