"""Global byte-range split math for sharded file reading.

Rebuild of the reference's split algorithm (reference: tony-core/src/main/
java/com/linkedin/tony/io/HdfsAvroFileSplitReader.java:286-297
``computeReadSplitStart``/``computeReadSplitLength``): the byte ranges of all
input files are concatenated conceptually into one [0, total) range; task
``idx`` of ``n`` owns the contiguous range ``[idx*total/n, (idx+1)*total/n)``.
The splits tile the total exactly — no gaps, no overlap — which is the
property the reference's ``TestReader.java:42-60`` asserts and
``tests/test_io.py`` re-asserts here.

A record straddling a split boundary belongs to the split where it *starts*;
readers sync forward to the first record boundary at-or-after their offset
and read past their end to finish the final record (the reference does the
same with Avro block sync markers, ``:242``).
"""

from __future__ import annotations


from tony_tpu_torch.storage import ssize
from dataclasses import dataclass


def split_start(total: int, idx: int, n: int) -> int:
    """Start of split ``idx`` of ``n`` over ``total`` bytes
    (reference: computeReadSplitStart:286)."""
    if not 0 <= idx < n:
        raise ValueError(f"idx {idx} out of range for {n} splits")
    return idx * total // n

def split_length(total: int, idx: int, n: int) -> int:
    """Length of split ``idx`` (reference: computeReadSplitLength:292).
    Defined so that splits tile [0, total) exactly."""
    if not 0 <= idx < n:
        raise ValueError(f"idx {idx} out of range for {n} splits")
    return (idx + 1) * total // n - idx * total // n


@dataclass(frozen=True)
class FileSegment:
    """A per-file byte range owned by one task
    (reference: createReadInfo:379 builds the per-file (offset,len) list)."""
    path: str
    offset: int
    length: int


def compute_read_info(paths: list[str], idx: int, n: int,
                      sizes: list[int] | None = None) -> list[FileSegment]:
    """Map the global split of task ``idx``/``n`` onto per-file segments.

    ``sizes`` may be passed to avoid re-statting (e.g. remote listings);
    otherwise each path is statted through the storage seam (``ssize``),
    so ``gs://`` inputs split exactly like local ones.
    """
    if sizes is None:
        sizes = [ssize(p) for p in paths]
    if len(sizes) != len(paths):
        raise ValueError("paths and sizes length mismatch")
    total = sum(sizes)
    start = split_start(total, idx, n)
    length = split_length(total, idx, n)
    segments: list[FileSegment] = []
    file_start = 0
    for path, size in zip(paths, sizes):
        file_end = file_start + size
        seg_start = max(start, file_start)
        seg_end = min(start + length, file_end)
        if seg_start < seg_end:
            segments.append(FileSegment(path, seg_start - file_start,
                                        seg_end - seg_start))
        file_start = file_end
    return segments


def full_records_in_split(paths: list[str], idx: int, n: int,
                          record_size: int,
                          sizes: list[int] | None = None) -> int:
    """Number of FULL fixed-size records task ``idx`` of ``n`` will read.

    Deterministic from file sizes alone, so every process can compute every
    other process's count without communication — the basis for SPMD
    batch-count agreement in
    :func:`tony_tpu_torch.io.torch_feed.global_batches` (all processes
    must run the same number of steps or multi-host training deadlocks). Short tail records (file size not a multiple of
    ``record_size``) are excluded, matching the feed's filtering.
    """
    if record_size <= 0:
        raise ValueError("full_records_in_split requires fixed-size framing")
    if sizes is None:
        sizes = [ssize(p) for p in paths]
    size_of = dict(zip(paths, sizes))
    count = 0
    for seg in compute_read_info(paths, idx, n, sizes=sizes):
        first = -(-seg.offset // record_size)
        end_excl = -(-(seg.offset + seg.length) // record_size)
        full_end = min(end_excl, size_of[seg.path] // record_size)
        count += max(0, full_end - first)
    return count
