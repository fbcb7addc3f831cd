"""Device-prefetched training input: decode ahead, copy to the card in
the background.

Port of ``DevicePrefetcher`` and ``synchronous_batches`` from
``tony_tpu/io/prefetch.py``. A producer thread pulls host batches (nested
dicts of numpy arrays or tensors) from a source, copies them into pinned
host memory and starts the host-to-card copy on a side CUDA stream, then
parks the batch with an event recorded after the copy in a bounded
queue. The consumer makes its current stream wait on that event — the
copy of batch N+1 overlaps the compute of batch N, and the step never
reads a half-copied batch — and marks the tensors as used by its stream
so the allocator does not hand their memory back to the side stream
early. On the CPU the batch is handed over as tensors, unchanged.

With a ``sharding`` (the train step's batch layout,
``train.batch_sharding``) the producer also assembles each process's
LOCAL batch into the global batch — DTensors over the mesh, from the
local shards, with no communication (``train.global_batch``, the port's
``make_array_from_process_local_data``) — on the mesh's device, so the
assembly overlaps the step too.

The contract is the JAX package's: ``close()`` stops the producer,
drains the queue and joins the thread; a producer error re-raises in the
consumer with its traceback; an epochal source is called as
``source(0), source(1), …``; every batch must match the first batch's
structure, shapes and dtypes (:class:`PrefetchShapeError`).

The file sources are here too: :func:`reader_epochs` (each data-parallel
rank's byte-range split, reshuffled with ``seed + epoch``) and
:func:`elastic_epochs` (one canonical stream sliced per process, the same
global batch at every world size).
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
import weakref
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from tony_tpu_torch import resolve_device, tree_leaves, tree_map
from tony_tpu_torch.io.reader import FileSplitReader
from tony_tpu_torch.io.split import full_records_in_split
from tony_tpu_torch.io.torch_feed import (array_batches, feed_split,
                                          record_size_for)
from tony_tpu_torch.storage import ssize

log = logging.getLogger(__name__)

_SENTINEL = object()
_THREAD_SEQ = itertools.count()


class PrefetchShapeError(RuntimeError):
    """A produced batch's structure or leaf shapes/dtypes differ from the
    first batch's."""


def _tree_spec(tree: Any) -> tuple:
    def struct(t):
        if isinstance(t, dict):
            return tuple((k, struct(v)) for k, v in t.items())
        return "leaf"
    return (struct(tree), tuple((tuple(l.shape), str(l.dtype))
                                for l in tree_leaves(tree)))


def _host_tensor(a: np.ndarray, pinned: bool) -> torch.Tensor:
    """One numpy leaf as a tensor. A batch decoded from files is a
    read-only view (``records_to_array``), often strided (``tokens[:,
    :seq]``): it is copied once, into a contiguous buffer (pinned for the
    card), never viewed; a writable array is viewed on the CPU."""
    if not pinned and a.flags.writeable:
        return torch.as_tensor(a)
    dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
    out = torch.empty(a.shape, dtype=dtype, pin_memory=pinned)
    np.copyto(out.numpy(), a)
    return out


def _to_device(batch: Any, device: torch.device):
    """Host batch (nested dicts of numpy arrays or tensors) → tensors on
    ``device``; to the card through pinned host copies and non-blocking
    copies on the current stream."""
    def one(x):
        cuda = device.type == "cuda"
        if isinstance(x, torch.Tensor):
            return x.pin_memory().to(device, non_blocking=True) if cuda else x
        t = _host_tensor(np.asarray(x), pinned=cuda)
        return t.to(device, non_blocking=True) if cuda else t
    return tree_map(one, batch)


def _mesh_device(sharding, device) -> torch.device:
    """Where a batch lands: the mesh's device with a sharding (this
    process's card under NCCL), else :func:`resolve_device`."""
    if sharding is None:
        return resolve_device(device)
    if sharding.mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(sharding.mesh.device_type)


def _globalize(batch: Any, sharding):
    if sharding is None:
        return batch
    from tony_tpu_torch.models.train import global_batch
    return global_batch(sharding, batch)


def _assemble(batch: Any, device: torch.device, stream, sharding=None):
    """The producer's copy (and, with a ``sharding``, the global batch's
    assembly): on the card, queued on its side ``stream`` with an event
    recorded after it; returns (batch, event), the event None on the
    CPU."""
    if stream is None:
        return _globalize(_to_device(batch, device), sharding), None
    with torch.cuda.stream(stream):
        out = _globalize(_to_device(batch, device), sharding)
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


def _local_leaves(batch) -> list:
    """The batch's tensors; a DTensor's local shard."""
    return [t.to_local() if hasattr(t, "to_local") else t
            for t in tree_leaves(batch)]


def _hand_over(item):
    """Make the consumer's stream wait for the batch's copy and own its
    memory from here on."""
    batch, event = item
    if event is not None:
        leaves = _local_leaves(batch)
        cur = torch.cuda.current_stream(leaves[0].device)
        cur.wait_event(event)
        for t in leaves:
            t.record_stream(cur)
    return batch


def _iterate(source, epochs: int | None) -> Iterator[Any]:
    """A callable source is cycled ``source(0), source(1), …`` (bounded by
    ``epochs``), a plain iterable is one pass, and an empty epoch raises
    instead of spinning forever."""
    epochal = callable(source)
    epoch_iter: Iterable[int] = (
        (range(epochs) if epochs is not None else itertools.count())
        if epochal else (0,))
    for epoch in epoch_iter:
        produced = 0
        for host_batch in (source(epoch) if epochal else source):
            produced += 1
            yield host_batch
        if epochal and produced == 0:
            raise ValueError(
                f"prefetch source yielded no batches for epoch {epoch} "
                f"— nothing to train on")


def synchronous_batches(source, device=None, epochs: int | None = None,
                        sharding=None) -> Iterator[Any]:
    """The prefetcher's stream without the producer thread: conversion,
    the host-to-card copy and (with a ``sharding``) the global batch's
    assembly inline on the caller's stream (the ``--prefetch_depth 0``
    contrast arm)."""
    dev = _mesh_device(sharding, device)
    for host_batch in _iterate(source, epochs):
        yield _globalize(_to_device(host_batch, dev), sharding)


def _producer(source, epochs, device, sharding, q, stop,
              error_box) -> None:
    """Producer body (module-level: it must not reference the prefetcher,
    which would pin it against its finalizer)."""
    spec = None
    stream = (torch.cuda.Stream(device=device) if device.type == "cuda"
              else None)
    try:
        for host_batch in _iterate(source, epochs):
            if stop.is_set():
                return
            item = _assemble(host_batch, device, stream, sharding)
            got = _tree_spec(item[0])
            if spec is None:
                spec = got
            elif got != spec:
                raise PrefetchShapeError(
                    f"batch shape changed mid-stream: first batch was "
                    f"{spec}, got {got}; pad or drop the odd batch")
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if stop.is_set():
                return
    except BaseException as e:           # noqa: BLE001 — box everything;
        error_box.append(e)              # the consumer re-raises it
    finally:
        for _ in range(50):
            try:
                q.put(_SENTINEL, timeout=0.1)
                break
            except queue.Full:
                if stop.is_set():
                    break


def _release(stop, q) -> None:
    """Finalizer for prefetchers dropped without close()."""
    stop.set()
    try:
        q.get_nowait()
    except queue.Empty:
        pass


class DevicePrefetcher:
    """Iterator of batches on ``device``, prepared ``depth`` ahead.

    ``source`` is a plain iterable of host batches (one pass) or a
    callable ``epoch -> iterable`` (``epochs`` bounds the count, None
    cycles forever). ``device`` is where batches land: the card unless
    the caller passes ``"cpu"``. With a ``sharding`` each host batch is
    this process's local shard, the batches are the global DTensors of
    that layout, and they land on the mesh's device. Each queue slot
    holds one batch of device memory, so 2 (one consumed, one in
    flight) is right unless decode cost varies a lot.

    Usage::

        with DevicePrefetcher(source, depth=2) as batches:
            state, metrics = run_training(step_fn, state, batches, steps)
    """

    def __init__(self, source: Iterable | Callable[[int], Iterable],
                 device=None, depth: int = 2,
                 epochs: int | None = None, sharding=None) -> None:
        self.device = _mesh_device(sharding, device)
        self._q: queue.Queue | None = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._error_box: list = []
        self._done = False
        self._thread = threading.Thread(
            target=_producer,
            args=(source, epochs, self.device, sharding, self._q,
                  self._stop, self._error_box),
            name=f"tony-datafeed-device-{next(_THREAD_SEQ)}", daemon=True)
        self._thread.start()
        self._finalizer = weakref.finalize(
            self, _release, self._stop, self._q)

    def __iter__(self) -> Iterator[Any]:
        return self

    def _finish(self):
        self._done = True
        if self._error_box:
            # the exception object carries the producer's traceback
            raise self._error_box.pop()
        raise StopIteration

    def __next__(self) -> Any:
        if self._done:
            raise StopIteration
        if self._q is None:
            raise RuntimeError("DevicePrefetcher is closed")
        while True:
            try:
                # timeout + stop re-check: a cross-thread close() may
                # retire the producer before its sentinel lands
                item = self._q.get(timeout=0.2)
            except queue.Empty:
                if self._stop.is_set():
                    raise RuntimeError("DevicePrefetcher is closed")
                if self._thread.is_alive():
                    continue
                # the producer may have parked its last batches and its
                # sentinel and exited inside the timeout: drain first
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    self._finish()
            if item is _SENTINEL:
                self._finish()
            return _hand_over(item)

    def close(self) -> None:
        """Stop the producer and release what it parked. Never blocks on
        a full queue."""
        self._stop.set()
        q = self._q
        if q is not None:
            while True:                   # unblock a put() on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
        if self._thread.is_alive():
            self._thread.join(timeout=5)
            if self._thread.is_alive():
                log.warning("device-prefetch thread did not exit; dropping "
                            "its queue (daemon thread dies with the process)")
        if q is not None:
            while True:                   # items put between drain and exit
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
        self._finalizer.detach()
        self._q = None
        self._done = True

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _split(process_index, process_count) -> tuple[int, int]:
    """The split to read: the one given, else this process's rank and the
    world size of the process group (``torch_feed.feed_split``)."""
    pid, pcount = feed_split()
    return (pid if process_index is None else process_index,
            pcount if process_count is None else process_count)


def reader_epochs(paths: list[str], batch_size_per_process: int, dtype,
                  row_shape: tuple[int, ...], *, shuffle: bool = True,
                  seed: int = 0, process_index: int | None = None,
                  process_count: int | None = None,
                  ) -> tuple[Callable[[int], Iterator], int]:
    """Epochal host-batch source over the sharded data-feed layer.

    Returns ``(epoch_fn, batches_per_epoch)``: ``epoch_fn(epoch)`` yields
    this split's LOCAL ``[batch, *row_shape]`` ndarrays for one pass over
    its byte range, reshuffled deterministically per epoch (reader seed =
    ``seed + epoch`` — a resumed attempt replays the same stream). Every
    split yields the SAME ``batches_per_epoch`` — the minimum over all
    splits' full-batch counts, computed from file sizes with no
    communication — so the step loop cannot deadlock across processes.
    The split is ``process_index`` of ``process_count``; a sharded
    trainer passes its data-parallel rank and size (``torch_feed.
    feed_split(mesh)``), so processes that share a batch shard read the
    same rows.
    """
    pid, pcount = _split(process_index, process_count)
    record_size = record_size_for(dtype, row_shape)
    sizes = [ssize(p) for p in paths]
    per_epoch = min(
        full_records_in_split(paths, i, pcount, record_size, sizes=sizes)
        // batch_size_per_process
        for i in range(pcount))

    def epoch_fn(epoch: int) -> Iterator:
        reader = FileSplitReader(
            paths, task_index=pid, task_num=pcount,
            record_size=record_size, shuffle=shuffle, seed=seed + epoch,
            sizes=sizes)
        try:
            it = array_batches(reader, batch_size_per_process, dtype,
                               row_shape)
            for _ in range(per_epoch):
                yield next(it)
        finally:
            reader.close()

    return epoch_fn, per_epoch


def elastic_epochs(paths: list[str], global_batch: int, dtype,
                   row_shape: tuple[int, ...], *, shuffle: bool = True,
                   seed: int = 0, start_step: int = 0,
                   process_index: int | None = None,
                   process_count: int | None = None,
                   ) -> tuple[Iterator, int]:
    """World-size-invariant epochal stream for ELASTIC training.

    :func:`reader_epochs` partitions by byte range, so the per-process
    stream depends on the process COUNT — after an elastic shrink the
    survivors' splits change and a mid-epoch resume would drop some
    examples and feed others twice. This source fixes ONE canonical
    stream — the single-reader pass over all files (``task_num=1``),
    reshuffled with ``seed + epoch``, chunked into ``global_batch``-row
    global batches — and hands split ``p`` of ``P`` rows ``[p*B/P,
    (p+1)*B/P)`` of every global batch. The global batch at step ``s`` is
    therefore IDENTICAL at any world size.

    ``start_step`` aligns the stream with a restored checkpoint: the
    first yielded batch is the one for global step ``start_step``
    (``epoch = s // batches_per_epoch``, position ``s %
    batches_per_epoch``; the skipped prefix of the resume epoch is
    decoded and discarded — shuffled streams have no seek).

    Returns ``(iterator, batches_per_epoch)``; the iterator is infinite
    (cycles epochs) and yields this split's LOCAL ``[B/P, *row_shape]``
    ndarray slice. Every process reads the WHOLE dataset (the invariance
    cost).
    """
    pid, pcount = _split(process_index, process_count)
    if global_batch % pcount != 0:
        raise ValueError(
            f"elastic_epochs: global_batch={global_batch} must divide "
            f"evenly over {pcount} process(es) — choose a global batch "
            f"divisible by every world size the job can shrink to")
    local = global_batch // pcount
    record_size = record_size_for(dtype, row_shape)
    sizes = [ssize(p) for p in paths]
    per_epoch = (full_records_in_split(paths, 0, 1, record_size,
                                       sizes=sizes) // global_batch)
    if per_epoch == 0:
        raise ValueError(
            f"data files hold fewer than one global batch "
            f"(global_batch={global_batch}) — nothing to train on")

    def stream() -> Iterator:
        step = start_step
        for epoch in itertools.count(start_step // per_epoch):
            reader = FileSplitReader(
                paths, task_index=0, task_num=1, record_size=record_size,
                shuffle=shuffle, seed=seed + epoch, sizes=sizes)
            try:
                it = array_batches(reader, global_batch, dtype, row_shape)
                skip = step % per_epoch
                for pos in range(per_epoch):
                    g = next(it)
                    if pos < skip:
                        continue    # decoded + discarded resume prefix
                    step += 1
                    yield g[pid * local:(pid + 1) * local]
            finally:
                reader.close()

    return stream(), per_epoch
