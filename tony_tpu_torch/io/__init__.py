"""Training input of the port: the data-feed layer and device-prefetched
batches.

  split       — global contiguous byte-range split math
  framed      — TONY1 self-describing splittable record format
  avro        — Avro object-container ingestion (null, deflate and
                snappy codecs; pure-Python snappy in ``snappy``)
  reader      — FileSplitReader: the C++ prefetch/shuffle engine
                (``native/datafeed.cc``, over ctypes) or the Python one;
                byte, ndarray and local-spill delivery
  torch_feed  — decode to ndarray, and assemble global batches of
                DTensors from each process's local rows
  prefetch    — DevicePrefetcher: decode, assembly and the host-to-card
                copy on a producer thread; the epochal file sources
                (``reader_epochs``, ``elastic_epochs``)
"""

from tony_tpu_torch.io.avro import (AvroFormatError, AvroWriter,
                                    is_avro_file, read_datum, write_datum)
from tony_tpu_torch.io.framed import (FramedFormatError, FramedWriter,
                                      is_framed_file, iter_file_records,
                                      read_path_header)
from tony_tpu_torch.io.prefetch import (DevicePrefetcher, PrefetchShapeError,
                                        elastic_epochs, reader_epochs,
                                        synchronous_batches)
from tony_tpu_torch.io.reader import DataFeedError, FileSplitReader
from tony_tpu_torch.io.split import (FileSegment, compute_read_info,
                                     full_records_in_split, split_length,
                                     split_start)
from tony_tpu_torch.io.torch_feed import (array_batches, global_batches,
                                          record_size_for, records_to_array,
                                          to_global_tensor)

__all__ = [
    "FileSegment", "compute_read_info", "full_records_in_split",
    "split_start", "split_length",
    "FramedWriter", "FramedFormatError", "is_framed_file",
    "iter_file_records", "read_path_header",
    "AvroWriter", "AvroFormatError", "is_avro_file",
    "read_datum", "write_datum",
    "FileSplitReader", "DataFeedError",
    "array_batches", "global_batches", "record_size_for",
    "records_to_array", "to_global_tensor",
    "DevicePrefetcher", "PrefetchShapeError", "elastic_epochs",
    "reader_epochs", "synchronous_batches",
]
