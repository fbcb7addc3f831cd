"""TONY1 framed records: self-describing, splittable, variable-length.

The reference's data feed is Avro-native: files carry their schema in a
header (served to Python over the ``getSchemaJson`` channel,
HdfsAvroFileSplitReader.java:446) and records live in blocks separated by
a per-file random 16-byte sync marker, which is what makes byte-range
splits safe — a reader landing mid-file scans forward to the next marker
(:242). TONY1 keeps exactly those load-bearing properties with a format
simple enough to write from any language:

```
file header:
    magic        6 bytes   b"TONY1\\0"
    sync         16 bytes  random per file
    schema_len   4 bytes   LE uint32
    schema       schema_len bytes of JSON (utf-8)
blocks, repeating until EOF:
    sync         16 bytes
    count        4 bytes   LE uint32  records in this block
    size         4 bytes   LE uint32  payload bytes
    payload      count x (4-byte LE uint32 length + record bytes)
```

Split semantics (identical to the Avro convention): a block belongs to
the split in which its sync marker STARTS; a reader whose offset lands
mid-block scans forward to the next marker and reads blocks whose start
position precedes its split end (possibly reading past the end).
"""

from __future__ import annotations

import json
import os
import secrets
import struct

from tony_tpu_torch.storage import sopen, ssize
from typing import BinaryIO, Iterator

MAGIC = b"TONY1\0"
SYNC_LEN = 16
_HDR_FIXED = len(MAGIC) + SYNC_LEN + 4       # magic + sync + schema_len
_U32 = struct.Struct("<I")
#: sanity bounds applied when validating a candidate block header
MAX_BLOCK_RECORDS = 1 << 24
MAX_BLOCK_BYTES = 1 << 30
DEFAULT_BLOCK_BYTES = 256 * 1024


class FramedFormatError(ValueError):
    pass


class FileHeader:
    __slots__ = ("sync", "schema_json", "data_start")

    def __init__(self, sync: bytes, schema_json: str, data_start: int):
        self.sync = sync
        self.schema_json = schema_json
        self.data_start = data_start

    @property
    def schema(self) -> dict:
        return json.loads(self.schema_json) if self.schema_json else {}


def is_framed_file(path: str) -> bool:
    """True when ``path`` starts with the TONY1 magic. A missing/unreadable
    file raises OSError — swallowing it here would misreport a typo'd path
    as "not framed" and send callers down a framing-mismatch rabbit hole."""
    # magic probe via a ranged read: a scan-sized buffered stream would
    # fetch MBs of a remote object to look at 6 bytes
    from tony_tpu_torch.storage import storage_for
    return storage_for(path).read_range(path, 0, len(MAGIC)) == MAGIC


def read_header(f: BinaryIO) -> FileHeader:
    f.seek(0)
    head = f.read(_HDR_FIXED)
    if len(head) < _HDR_FIXED or not head.startswith(MAGIC):
        raise FramedFormatError("not a TONY1 framed file")
    sync = head[len(MAGIC):len(MAGIC) + SYNC_LEN]
    (schema_len,) = _U32.unpack_from(head, len(MAGIC) + SYNC_LEN)
    schema = f.read(schema_len)
    if len(schema) < schema_len:
        raise FramedFormatError("truncated schema header")
    return FileHeader(sync, schema.decode("utf-8"),
                      _HDR_FIXED + schema_len)


def read_path_header(path: str) -> FileHeader:
    with sopen(path, buffer_size=1 << 16) as f:   # header-sized probe
        return read_header(f)


class FramedWriter:
    """Blocked writer (the DataFileWriter analog). ``schema`` is any JSON-
    serializable description of the records — the schema channel carries
    it verbatim to readers."""

    def __init__(self, path_or_file, schema: dict | str | None = None,
                 block_bytes: int = DEFAULT_BLOCK_BYTES,
                 sync: bytes | None = None) -> None:
        if isinstance(path_or_file, (str, os.PathLike)):
            self._f: BinaryIO = open(path_or_file, "wb")
            self._owns = True
        else:
            self._f = path_or_file
            self._owns = False
        self.sync = sync if sync is not None else secrets.token_bytes(SYNC_LEN)
        if len(self.sync) != SYNC_LEN:
            raise ValueError(f"sync marker must be {SYNC_LEN} bytes")
        schema_json = (schema if isinstance(schema, str)
                       else json.dumps(schema or {}))
        sj = schema_json.encode("utf-8")
        self._f.write(MAGIC + self.sync + _U32.pack(len(sj)) + sj)
        self._block: list[bytes] = []
        self._block_bytes = 0
        self._target = max(1, block_bytes)
        self.records_written = 0
        self.bytes_written = _HDR_FIXED + len(sj)

    @property
    def total_bytes(self) -> int:
        """Bytes written plus the still-buffered block (size accounting for
        callers chunking output, e.g. spill-mode max_bytes)."""
        pending = (SYNC_LEN + 8 + self._block_bytes) if self._block else 0
        return self.bytes_written + pending

    def append(self, record: bytes) -> None:
        self._block.append(record)
        self._block_bytes += 4 + len(record)
        self.records_written += 1
        if self._block_bytes >= self._target:
            self._flush_block()

    def _flush_block(self) -> None:
        if not self._block:
            return
        payload = b"".join(_U32.pack(len(r)) + r for r in self._block)
        self._f.write(self.sync + _U32.pack(len(self._block))
                      + _U32.pack(len(payload)) + payload)
        self.bytes_written += SYNC_LEN + 8 + len(payload)
        self._block.clear()
        self._block_bytes = 0

    def close(self) -> None:
        self._flush_block()
        self._f.flush()
        if self._owns:
            self._f.close()

    def __enter__(self) -> "FramedWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _find_sync(f: BinaryIO, sync: bytes, start: int,
               limit: int) -> int:
    """Position of the first sync marker starting at or after ``start`` and
    strictly before ``limit``, or -1. Reads in chunks, keeping a SYNC_LEN-1
    byte overlap so markers straddling chunk boundaries are found."""
    f.seek(start)
    buf = b""
    base = start                   # file position of buf[0]
    while base < limit:
        data = f.read(1 << 16)
        if not data:
            return -1
        buf += data
        idx = buf.find(sync)
        if idx != -1:
            found = base + idx
            return found if found < limit else -1
        keep = SYNC_LEN - 1
        base += len(buf) - keep
        buf = buf[-keep:]
    return -1


def iter_segment_records(path: str, offset: int,
                         length: int) -> Iterator[bytes]:
    """Records of every block whose sync starts inside [offset, offset+len)
    — the Python engine's framed arm (the C++ engine mirrors this)."""
    with sopen(path) as f:
        header = read_header(f)
        end = offset + length
        pos = max(offset, header.data_start)
        if pos >= end:
            return
        pos = _find_sync(f, header.sync, pos, end)
        while pos != -1 and pos < end:
            f.seek(pos)
            marker = f.read(SYNC_LEN)
            hdr = f.read(8)
            if marker != header.sync or len(hdr) < 8:
                raise FramedFormatError(
                    f"corrupt block header at {path}:{pos}")
            (count,) = _U32.unpack_from(hdr, 0)
            (size,) = _U32.unpack_from(hdr, 4)
            if count > MAX_BLOCK_RECORDS or size > MAX_BLOCK_BYTES:
                raise FramedFormatError(
                    f"implausible block at {path}:{pos} "
                    f"(count={count}, size={size})")
            payload = f.read(size)
            if len(payload) < size:
                raise FramedFormatError(f"truncated block at {path}:{pos}")
            view = memoryview(payload)
            p = 0
            for _ in range(count):
                if p + 4 > size:
                    raise FramedFormatError(
                        f"corrupt block payload at {path}:{pos}")
                (rlen,) = _U32.unpack_from(view, p)
                p += 4
                if p + rlen > size:
                    raise FramedFormatError(
                        f"corrupt record length at {path}:{pos}")
                yield bytes(view[p:p + rlen])
                p += rlen
            pos += SYNC_LEN + 8 + size    # blocks are back-to-back
            if pos >= end:
                break      # bytes past the split end belong to a later split
            # within our split, the next marker must start exactly here
            probe = f.read(SYNC_LEN)
            if not probe:
                break              # clean EOF after the previous block
            if len(probe) < SYNC_LEN:
                # a 1..15-byte tail is a writer that died mid-marker (or
                # mid-block) — fail loudly, exactly like the native engine
                raise FramedFormatError(
                    f"truncated sync marker at {path}:{pos}")
            if probe != header.sync:
                raise FramedFormatError(
                    f"lost sync after block at {path}:{pos}")


def iter_file_records(path: str) -> Iterator[bytes]:
    """All records of a framed file (spill-file consumption)."""
    size = ssize(path)
    yield from iter_segment_records(path, 0, size)
