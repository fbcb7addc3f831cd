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

The contract is the JAX package's: ``close()`` stops the producer,
drains the queue and joins the thread; a producer error re-raises in the
consumer with its traceback; an epochal source is called as
``source(0), source(1), …``; every batch must match the first batch's
structure, shapes and dtypes (:class:`PrefetchShapeError`). The file
sources (``reader_epochs``, ``elastic_epochs``) need the reader stack,
which is not ported yet.
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


def _to_device(batch: Any, device: torch.device):
    """Host batch (nested dicts of numpy arrays or tensors) → tensors on
    ``device``; to the card through pinned host copies and non-blocking
    copies on the current stream."""
    def one(x):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        if device.type != "cuda":
            return t
        return t.pin_memory().to(device, non_blocking=True)
    return tree_map(one, batch)


def _assemble(batch: Any, device: torch.device, stream):
    """The producer's copy: on the card, queued on its side ``stream``
    with an event recorded after it; returns (batch, event), the event
    None on the CPU."""
    if stream is None:
        return _to_device(batch, device), None
    with torch.cuda.stream(stream):
        out = _to_device(batch, device)
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


def _hand_over(item):
    """Make the consumer's stream wait for the batch's copy and own its
    memory from here on."""
    batch, event = item
    if event is not None:
        leaves = tree_leaves(batch)
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


def synchronous_batches(source, device=None,
                        epochs: int | None = None) -> Iterator[Any]:
    """The prefetcher's stream without the producer thread: conversion
    and the host-to-card copy inline on the caller's stream (the
    ``--prefetch_depth 0`` contrast arm)."""
    dev = resolve_device(device)
    for host_batch in _iterate(source, epochs):
        yield _to_device(host_batch, dev)


def _producer(source, epochs, device, q, stop, error_box) -> None:
    """Producer body (module-level: it must not reference the prefetcher,
    which would pin it against its finalizer)."""
    spec = None
    stream = (torch.cuda.Stream(device=device) if device.type == "cuda"
              else None)
    try:
        for host_batch in _iterate(source, epochs):
            if stop.is_set():
                return
            item = _assemble(host_batch, device, stream)
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
    the caller passes ``"cpu"``. Each queue slot holds one batch of
    device memory, so 2 (one consumed, one in flight) is right unless
    decode cost varies a lot.

    Usage::

        with DevicePrefetcher(source, depth=2) as batches:
            state, metrics = run_training(step_fn, state, batches, steps)
    """

    def __init__(self, source: Iterable | Callable[[int], Iterable],
                 device=None, depth: int = 2,
                 epochs: int | None = None) -> None:
        self.device = resolve_device(device)
        self._q: queue.Queue | None = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._error_box: list = []
        self._done = False
        self._thread = threading.Thread(
            target=_producer,
            args=(source, epochs, self.device, self._q, self._stop,
                  self._error_box),
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
