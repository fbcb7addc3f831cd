"""Bridge from the per-task data feed into global batches of DTensors.

The reference hands batches to user TF/PyTorch code over py4j and stops
there (reference: HdfsAvroFileSplitReader.java:103-133 — bytes / in-mem
file / local-spill delivery). Here each process reads only its split
(:class:`~tony_tpu_torch.io.reader.FileSplitReader`), decodes it into
numpy rows, and :func:`to_global_tensor` assembles every process's local
rows into one global batch: DTensors sharded along the mesh's data axes,
built from the local shards with no communication
(``train.global_batch``).

The split is by data-parallel rank, not by process: processes that share
a replicated batch (a mesh whose batch axes do not span them, pure tp)
read the same split, so they feed the same rows (:func:`feed_split`).
"""

from __future__ import annotations

import logging
from typing import Iterator

import numpy as np

from tony_tpu_torch.io.reader import FileSplitReader
from tony_tpu_torch.io.split import full_records_in_split
from tony_tpu_torch.storage import ssize

log = logging.getLogger(__name__)


def records_to_array(records: list[bytes], dtype,
                     row_shape: tuple[int, ...]) -> np.ndarray:
    """Decode fixed-size records into a [batch, *row_shape] ndarray
    (read-only: a view of the joined bytes)."""
    if not records:
        return np.empty((0, *row_shape), dtype=dtype)
    flat = np.frombuffer(b"".join(records), dtype=dtype)
    return flat.reshape(len(records), *row_shape)


def record_size_for(dtype, row_shape: tuple[int, ...]) -> int:
    """Bytes per fixed-size record holding one ``dtype``-typed row."""
    return int(np.dtype(dtype).itemsize * np.prod(row_shape, dtype=np.int64))


def array_batches(reader: FileSplitReader, batch_size: int, dtype,
                  row_shape: tuple[int, ...],
                  drop_remainder: bool = True) -> Iterator[np.ndarray]:
    """Iterate the reader's split as fixed-size [batch, *row_shape] arrays.

    Short tail records (a file whose size is not a record multiple) are
    dropped — they cannot form a full row. The drop warning fires once
    per READER (flagged on the reader object), not once per call site: a
    reader consumed through several ``array_batches`` calls still reports
    its short tails exactly once.
    """
    rec_bytes = record_size_for(dtype, row_shape)
    exhausted = False
    while not exhausted:
        # Keep pulling until we hold batch_size FULL records or the reader
        # is dry — a short tail record filtered mid-stream must not end
        # the iteration while later files still have data.
        full: list[bytes] = []
        while len(full) < batch_size:
            records = reader.next_batch(batch_size - len(full))
            if not records:
                exhausted = True
                break
            kept = [r for r in records if len(r) == rec_bytes]
            if len(kept) < len(records) and not getattr(
                    reader, "_short_tail_warned", False):
                reader._short_tail_warned = True
                log.warning("dropping %d short tail record(s) (< %d bytes)",
                            len(records) - len(kept), rec_bytes)
            full.extend(kept)
        if not full:
            return
        if len(full) < batch_size and drop_remainder:
            return
        yield records_to_array(full, dtype, row_shape)


def feed_split(mesh=None, axes: tuple[str, ...] = ("dp", "fsdp")
               ) -> tuple[int, int]:
    """``(index, count)`` of the split this process reads: its rank and
    the size of ``mesh`` along the batch ``axes`` (processes that share a
    batch shard share a split), or, with no mesh, its rank and the world
    size of the process group (0 and 1 without one)."""
    if mesh is not None:
        from tony_tpu_torch.models.train import (data_parallel_rank,
                                                 data_parallel_size)
        return (data_parallel_rank(mesh, axes),
                data_parallel_size(mesh, axes))
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def to_global_tensor(local_batch, mesh, batch_axes: tuple[str, ...] = ("dp",)):
    """Assemble each process's local batch (an ndarray or a tensor on the
    mesh's device) into one global DTensor sharded along the mesh's data
    axes on its leading dim, replicated elsewhere — from the local shards,
    with no communication. The global batch is the concatenation of the
    shards in data-parallel rank order."""
    import torch

    from tony_tpu_torch.models.train import global_batch
    from tony_tpu_torch.parallel.mesh import mesh_shape
    from tony_tpu_torch.parallel.sharding import Sharding

    names = tuple(mesh_shape(mesh))
    axes = tuple(a for a in names if a in batch_axes)
    if batch_axes and not axes:
        # Replicating per-process-distinct data would make garbage
        # "global" batches: demand an explicit batch_axes=() for it.
        raise ValueError(
            f"none of batch_axes {batch_axes} exist in mesh axes "
            f"{names}; pass batch_axes=() for replication")
    local = (local_batch if isinstance(local_batch, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(local_batch)))
    if mesh.device_type == "cuda":
        local = local.to(torch.device("cuda", torch.cuda.current_device()))
    return global_batch(Sharding(mesh, (axes or None,)), local)


def global_batches(paths: list[str], batch_size_per_process: int, dtype,
                   row_shape: tuple[int, ...], mesh,
                   batch_axes: tuple[str, ...] = ("dp",),
                   shuffle: bool = False, seed: int = 0,
                   process_index: int | None = None,
                   process_count: int | None = None):
    """End-to-end feed: split files across the data-parallel ranks, read
    and decode locally, assemble global sharded batches::

        for batch in global_batches(paths, 32, np.float32, (28, 28), mesh):
            state, metrics = train_step(state, batch)

    The split is this process's rank along ``mesh``'s ``batch_axes``
    unless ``process_index``/``process_count`` are given
    (:func:`feed_split`).
    Every process yields the SAME number of batches — the minimum over
    all splits' full-batch counts, computed from file sizes (no
    communication) — so the step loop cannot deadlock across processes
    when splits land unequal record counts.
    """
    pid, pcount = feed_split(mesh, batch_axes)
    pid = pid if process_index is None else process_index
    pcount = pcount if process_count is None else process_count
    record_size = record_size_for(dtype, row_shape)
    sizes = [ssize(p) for p in paths]
    num_batches = min(
        full_records_in_split(paths, i, pcount, record_size, sizes=sizes)
        // batch_size_per_process
        for i in range(pcount))
    reader = FileSplitReader(
        paths, task_index=pid, task_num=pcount, record_size=record_size,
        shuffle=shuffle, seed=seed, sizes=sizes)
    try:
        it = array_batches(reader, batch_size_per_process, dtype, row_shape)
        for _ in range(num_batches):
            yield to_global_tensor(next(it), mesh, batch_axes)
    finally:
        reader.close()
