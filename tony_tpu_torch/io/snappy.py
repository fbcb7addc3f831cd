"""Pure-Python snappy raw-format codec for Avro block (de)compression.

The reference reads whatever codec the Avro library decodes
(HdfsAvroFileSplitReader.java delegates block decode to ``DataFileReader``),
and real-world Avro datasets are very often snappy-compressed — so the
"read existing datasets in place" story needs snappy even though the Avro
spec lists it as optional. No snappy library is baked into the image; the
raw format (github.com/google/snappy/blob/main/format_description.txt) is
small enough to implement directly:

- preamble: uncompressed length, little-endian varint
- elements: tag byte, low 2 bits select the type —
  ``00`` literal (length in the upper 6 bits, or 60-63 → 1-4 extra
  little-endian length bytes, stored value = length - 1),
  ``01`` copy, 1-byte offset  (len 4-11 in bits 2-4, offset 11 bits),
  ``10`` copy, 2-byte offset  (len = upper 6 bits + 1, offset LE16),
  ``11`` copy, 4-byte offset  (len = upper 6 bits + 1, offset LE32)
- copies may overlap forward (offset < length ⇒ RLE-style repetition),
  which is why the decoder appends byte-ranges in a loop instead of one
  slice when the run overlaps.

The compressor is a greedy 4-byte-hash matcher — enough to emit real copy
elements (so round-trip tests exercise every decoder path, including
overlapping runs) and to shrink repetitive fixtures, not a performance
port. Avro's snappy codec frames each block as ``compressed bytes +
4-byte BIG-endian CRC32 of the uncompressed bytes``; that framing lives
in :mod:`tony_tpu_torch.io.avro`, not here — this module is format-pure.
"""

from __future__ import annotations


class SnappyError(ValueError):
    pass


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(data):
            raise SnappyError("truncated varint preamble")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 35:
            raise SnappyError("varint preamble overflow")


def _write_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decompress(data: bytes) -> bytes:
    """Decode one snappy raw-format stream."""
    expected, pos = _read_varint(data, 0)
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:                                   # literal
            ln = tag >> 2
            if ln >= 60:                                # 1-4 length bytes
                extra = ln - 59
                if pos + extra > n:
                    raise SnappyError("truncated literal length")
                ln = int.from_bytes(data[pos:pos + extra], "little")
                pos += extra
            ln += 1
            if pos + ln > n:
                raise SnappyError("literal overruns input")
            out += data[pos:pos + ln]
            pos += ln
            continue
        if kind == 1:                                   # copy, 1-byte offset
            if pos >= n:
                raise SnappyError("truncated copy-1")
            ln = ((tag >> 2) & 0x7) + 4
            off = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:                                 # copy, 2-byte offset
            if pos + 2 > n:
                raise SnappyError("truncated copy-2")
            ln = (tag >> 2) + 1
            off = int.from_bytes(data[pos:pos + 2], "little")
            pos += 2
        else:                                           # copy, 4-byte offset
            if pos + 4 > n:
                raise SnappyError("truncated copy-4")
            ln = (tag >> 2) + 1
            off = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        if off == 0 or off > len(out):
            raise SnappyError(f"copy offset {off} outside window")
        start = len(out) - off
        while ln > 0:                                   # overlap-safe
            chunk = out[start:start + min(ln, off)]
            out += chunk
            start += len(chunk)
            ln -= len(chunk)
    if len(out) != expected:
        raise SnappyError(
            f"decompressed {len(out)} bytes, preamble promised {expected}")
    return bytes(out)


def _emit_literal(out: bytearray, data: bytes, start: int, end: int) -> None:
    ln = end - start - 1
    if ln < 60:
        out.append(ln << 2)
    else:
        nbytes = (ln.bit_length() + 7) // 8
        out.append((59 + nbytes) << 2)
        out += ln.to_bytes(nbytes, "little")
    out += data[start:end]


def compress(data: bytes) -> bytes:
    """Greedy single-pass snappy encoder (correct, not tuned)."""
    out = bytearray(_write_varint(len(data)))
    n = len(data)
    if n == 0:
        return bytes(out)
    table: dict[bytes, int] = {}
    lit_start = 0
    i = 0
    while i + 4 <= n:
        key = data[i:i + 4]
        cand = table.get(key)
        table[key] = i
        if cand is None or i - cand > 0xFFFFFFFF:
            i += 1
            continue
        # extend the match
        ln = 4
        while i + ln < n and ln < 64 and data[cand + ln] == data[i + ln]:
            ln += 1
        if lit_start < i:
            _emit_literal(out, data, lit_start, i)
        off = i - cand
        if ln <= 11 and off < 2048:                     # copy-1
            out.append(1 | ((ln - 4) << 2) | ((off >> 8) << 5))
            out.append(off & 0xFF)
        elif off <= 0xFFFF:                             # copy-2
            out.append(2 | ((ln - 1) << 2))
            out += off.to_bytes(2, "little")
        else:                                           # copy-4
            out.append(3 | ((ln - 1) << 2))
            out += off.to_bytes(4, "little")
        i += ln
        lit_start = i
    if lit_start < n:
        _emit_literal(out, data, lit_start, n)
    return bytes(out)
