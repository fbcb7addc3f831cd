// Native data-feed engine: background-prefetched, bounded-buffer, optionally
// shuffling record reader over per-file byte-range segments.
//
// Analog of the reference's JVM data-feed engine (reference:
// tony-core/src/main/java/com/linkedin/tony/io/HdfsAvroFileSplitReader.java:
// DataFetcher thread :176, InternalBuffer bounded/shuffle buffer :678, record
// boundary sync :242). The reference runs this engine in the TaskExecutor JVM
// and ships batches to Python over py4j; here the engine is a C++ shared
// library the Python reader loads over ctypes — same producer/consumer
// design, no socket hop.
//
// Record framings:
//   record_size > 0  — fixed-size records (packed tensors); a record belongs
//                      to the segment where its start byte falls.
//   record_size == 0 — newline-delimited records (jsonl/text); a reader whose
//                      offset is mid-record syncs forward past the next '\n'
//                      (the straddling record belongs to the previous split,
//                      which reads past its end to finish it).
//   record_size == -1 — TONY1 framed blocks (self-describing, variable-
//                      length; see tony_tpu_torch/io/framed.py): the file header
//                      carries a 16-byte sync marker and a JSON schema; a
//                      block belongs to the split where its sync STARTS
//                      (the Avro block-sync convention, reference :242).
//
// Concurrency: one producer thread reads ahead into a bounded FIFO; the
// consumer moves records from it into the window (the pool) under a mutex.
// In shuffle mode each pop picks a uniformly random window slot
// (swap-remove), giving a streaming shuffle with window = capacity, matching
// the reference's InternalBuffer shuffle semantics. A shuffled pop waits
// until the window is full (or the split has no records left to read), so
// the window holds the same records at every draw however far the producer
// has got: a seed replays the same stream. (A pop from a partly filled
// window would make the order depend on thread timing.) The engine holds at
// most 2 x capacity records: the window and as many read ahead. The producer
// hands records over in chunks of up to 64, one lock and one wake-up a
// chunk, and a waiting producer is woken once a chunk of room is free: a
// lock and a wake-up per record would cost more than reading it.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC -pthread datafeed.cc -o lib.so
// (driven by tony_tpu_torch/io/native/__init__.py).

#include <condition_variable>
#include <deque>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Segment {
  std::string path;
  int64_t offset;
  int64_t length;
};

struct Record {
  std::vector<char> data;
};

class Reader {
 public:
  Reader(std::vector<Segment> segments, int64_t record_size, int capacity,
         bool shuffle, uint64_t seed)
      : segments_(std::move(segments)),
        record_size_(record_size),
        capacity_(capacity < 1 ? 1 : capacity),
        chunk_(capacity_ < kChunk ? capacity_ : kChunk),
        shuffle_(shuffle),
        rng_(seed) {
    producer_ = std::thread([this] { Produce(); });
  }

  ~Reader() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      closed_ = true;
    }
    cv_not_full_.notify_all();
    cv_not_empty_.notify_all();
    if (producer_.joinable()) producer_.join();
  }

  // Pops up to max_records records, packing bytes back-to-back into out and
  // per-record lengths into rec_lens. Returns the record count, 0 on EOF,
  // -1 on producer error, -2 if out_cap can't hold even one record.
  int64_t NextBatch(char* out, int64_t out_cap, int64_t* rec_lens,
                    int64_t max_records) {
    int64_t n = 0;
    int64_t used = 0;
    // a shuffled pop draws from a full window; a FIFO pop needs one record
    const size_t need = shuffle_ ? static_cast<size_t>(capacity_) : 1;
    std::unique_lock<std::mutex> lk(mu_);
    while (n < max_records) {
      // Return a partial FIFO batch rather than blocking for stragglers
      // once nothing is buffered: only block for the FIRST record.
      if (n > 0 && !shuffle_ && !Ready(need)) break;
      cv_not_empty_.wait(lk, [this, need] { return Ready(need); });
      if (!error_.empty()) return -1;
      if (pool_.empty()) break;  // done_ or closed_: drain finished
      size_t slot = 0;
      if (shuffle_ && pool_.size() > 1) {
        slot = std::uniform_int_distribution<size_t>(0, pool_.size() - 1)(rng_);
      }
      int64_t len = static_cast<int64_t>(pool_[slot].data.size());
      if (used + len > out_cap) {
        if (n == 0) return -2;
        break;  // batch full; leave record for the next call
      }
      std::memcpy(out + used, pool_[slot].data.data(), len);
      rec_lens[n++] = len;
      used += len;
      if (shuffle_) {
        pool_[slot] = std::move(pool_.back());
        pool_.pop_back();  // swap-remove: O(1), order irrelevant
      } else {
        pool_.pop_front();  // FIFO: preserve record order (slot == 0)
      }
    }
    return n;
  }

  const char* Error() {
    std::lock_guard<std::mutex> lk(mu_);
    return error_.c_str();
  }

 private:
  // Moves read-ahead records into the window, up to capacity (mu_ held).
  void TopUp() {
    bool moved = false;
    while (pool_.size() < static_cast<size_t>(capacity_) && !ahead_.empty()) {
      pool_.push_back(std::move(ahead_.front()));
      ahead_.pop_front();
      moved = true;
    }
    if (moved && ahead_.size() + chunk_ <= static_cast<size_t>(capacity_)) {
      cv_not_full_.notify_one();  // room for a chunk
    }
  }

  // Whether a pop may go ahead: the window holds `need` records, or no more
  // will come (mu_ held).
  bool Ready(size_t need) {
    TopUp();
    return pool_.size() >= need || done_ || closed_ || !error_.empty();
  }

  void Fail(const std::string& msg) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      error_ = msg;
    }
    cv_not_empty_.notify_all();
  }

  // Stages a record (producer thread only, no lock); hands the staged
  // records over a chunk at a time. Returns false when the reader is being
  // closed.
  bool Push(Record&& rec) {
    staged_.push_back(std::move(rec));
    return staged_.size() < chunk_ || Flush();
  }

  // Moves the staged records to the bounded read-ahead FIFO, blocking until
  // it has room for them. Returns false when the reader is being closed.
  bool Flush() {
    if (staged_.empty()) return true;
    std::unique_lock<std::mutex> lk(mu_);
    cv_not_full_.wait(lk, [this] {
      return ahead_.size() + staged_.size() <=
                 static_cast<size_t>(capacity_) ||
             closed_;
    });
    if (closed_) return false;
    for (Record& rec : staged_) ahead_.push_back(std::move(rec));
    staged_.clear();
    cv_not_empty_.notify_one();
    return true;
  }

  void Produce() {
    bool ok = true;
    for (const Segment& seg : segments_) {
      if (!(ok = ProduceSegment(seg))) break;
    }
    if (ok) Flush();  // the split's last, partial chunk
    {
      std::lock_guard<std::mutex> lk(mu_);
      done_ = true;
    }
    cv_not_empty_.notify_all();
  }

  bool ProduceSegment(const Segment& seg) {
    FILE* f = std::fopen(seg.path.c_str(), "rb");
    if (!f) {
      Fail("cannot open " + seg.path);
      return false;
    }
    std::setvbuf(f, nullptr, _IOFBF, 1 << 20);  // 1 MiB reads, not 4 KiB
    bool ok = record_size_ > 0   ? ProduceFixed(seg, f)
              : record_size_ == 0 ? ProduceLines(seg, f)
                                  : ProduceFramed(seg, f);
    std::fclose(f);
    return ok;
  }

  // --- TONY1 framed blocks (framed.py is the format's reference impl) ----
  static constexpr int64_t kSyncLen = 16;
  static constexpr uint32_t kMaxBlockRecords = 1u << 24;
  static constexpr uint32_t kMaxBlockBytes = 1u << 30;

  static uint32_t ReadU32(const unsigned char* p) {
    return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
           (static_cast<uint32_t>(p[2]) << 16) |
           (static_cast<uint32_t>(p[3]) << 24);
  }

  // First sync position >= start and < limit, or -1.
  static int64_t FindSync(FILE* f, const std::string& sync, int64_t start,
                          int64_t limit) {
    if (std::fseek(f, start, SEEK_SET) != 0) return -1;
    std::string buf;
    int64_t base = start;  // file position of buf[0]
    char chunk[1 << 16];
    while (base < limit) {
      size_t got = std::fread(chunk, 1, sizeof(chunk), f);
      if (got == 0) return -1;
      buf.append(chunk, got);
      size_t idx = buf.find(sync);
      if (idx != std::string::npos) {
        int64_t found = base + static_cast<int64_t>(idx);
        return found < limit ? found : -1;
      }
      size_t keep = sync.size() - 1;
      if (buf.size() > keep) {
        base += static_cast<int64_t>(buf.size() - keep);
        buf.erase(0, buf.size() - keep);
      }
    }
    return -1;
  }

  bool ProduceFramed(const Segment& seg, FILE* f) {
    // header: magic(6) + sync(16) + schema_len(4) + schema
    unsigned char head[6 + kSyncLen + 4];
    if (std::fread(head, 1, sizeof(head), f) != sizeof(head) ||
        std::memcmp(head, "TONY1\0", 6) != 0) {
      Fail("not a TONY1 framed file: " + seg.path);
      return false;
    }
    std::string sync(reinterpret_cast<char*>(head + 6), kSyncLen);
    uint32_t schema_len = ReadU32(head + 6 + kSyncLen);
    int64_t data_start = static_cast<int64_t>(sizeof(head)) + schema_len;
    // A corrupt schema_len must fail loudly (framed.py raises 'truncated
    // schema header'), not silently report an empty split.
    if (std::fseek(f, 0, SEEK_END) != 0) {
      Fail("seek failed in " + seg.path);
      return false;
    }
    int64_t file_size = std::ftell(f);
    if (data_start > file_size) {
      Fail("truncated schema header in " + seg.path);
      return false;
    }
    int64_t end = seg.offset + seg.length;
    int64_t pos = seg.offset > data_start ? seg.offset : data_start;
    if (pos >= end) return true;
    pos = FindSync(f, sync, pos, end);
    std::vector<char> payload;
    while (pos != -1 && pos < end) {
      if (std::fseek(f, pos, SEEK_SET) != 0) {
        Fail("seek failed in " + seg.path);
        return false;
      }
      unsigned char bh[kSyncLen + 8];
      size_t got = std::fread(bh, 1, sizeof(bh), f);
      if (got == 0) break;  // clean EOF after the previous block
      if (got != sizeof(bh) ||
          std::memcmp(bh, sync.data(), kSyncLen) != 0) {
        Fail("corrupt block header in " + seg.path);
        return false;
      }
      uint32_t count = ReadU32(bh + kSyncLen);
      uint32_t size = ReadU32(bh + kSyncLen + 4);
      if (count > kMaxBlockRecords || size > kMaxBlockBytes) {
        Fail("implausible block in " + seg.path);
        return false;
      }
      payload.resize(size);
      if (size > 0 && std::fread(payload.data(), 1, size, f) != size) {
        Fail("truncated block in " + seg.path);
        return false;
      }
      size_t p = 0;
      for (uint32_t i = 0; i < count; ++i) {
        if (p + 4 > size) {
          Fail("corrupt block payload in " + seg.path);
          return false;
        }
        uint32_t rlen =
            ReadU32(reinterpret_cast<unsigned char*>(payload.data()) + p);
        p += 4;
        if (p + rlen > size) {
          Fail("corrupt record length in " + seg.path);
          return false;
        }
        Record rec;
        rec.data.assign(payload.data() + p, payload.data() + p + rlen);
        p += rlen;
        if (!Push(std::move(rec))) return false;
      }
      pos += static_cast<int64_t>(sizeof(bh)) + size;  // blocks back-to-back
    }
    return true;
  }

  bool ProduceFixed(const Segment& seg, FILE* f) {
    // First record whose start byte is >= seg.offset; read records whose
    // start byte is < seg.offset + seg.length (may read past the end).
    int64_t first = (seg.offset + record_size_ - 1) / record_size_;
    int64_t end_excl = (seg.offset + seg.length + record_size_ - 1) / record_size_;
    if (std::fseek(f, first * record_size_, SEEK_SET) != 0) {
      Fail("seek failed in " + seg.path);
      return false;
    }
    for (int64_t i = first; i < end_excl; ++i) {
      Record rec;
      rec.data.resize(record_size_);
      size_t got = std::fread(rec.data.data(), 1, record_size_, f);
      if (got == 0) break;  // trailing partial file
      if (static_cast<int64_t>(got) < record_size_) {
        rec.data.resize(got);  // trailing short record: deliver as-is
      }
      if (!Push(std::move(rec))) return false;
    }
    return true;
  }

  bool ProduceLines(const Segment& seg, FILE* f) {
    if (std::fseek(f, seg.offset, SEEK_SET) != 0) {
      Fail("seek failed in " + seg.path);
      return false;
    }
    int64_t pos = seg.offset;
    // Hadoop line-split convention: a mid-file reader always discards
    // through the first '\n' (even when the offset lands exactly on a line
    // start — that line belongs to the previous split, which reads while
    // pos <= end). Offset 0 starts clean.
    if (seg.offset > 0) {
      int c;
      while ((c = std::fgetc(f)) != EOF) {
        ++pos;
        if (c == '\n') break;
      }
    }
    int64_t end = seg.offset + seg.length;
    std::vector<char> line;
    while (pos <= end) {  // line starting AT end is ours (next split skips it)
      line.clear();
      int c;
      while ((c = std::fgetc(f)) != EOF) {
        ++pos;
        if (c == '\n') break;
        line.push_back(static_cast<char>(c));
      }
      if (line.empty() && c == EOF) break;
      Record rec;
      rec.data = line;
      if (!Push(std::move(rec))) return false;
      if (c == EOF) break;
    }
    return true;
  }

  static constexpr size_t kChunk = 64;  // records handed over per wake-up

  std::vector<Segment> segments_;
  const int64_t record_size_;
  const int capacity_;
  const size_t chunk_;
  const bool shuffle_;
  std::mt19937_64 rng_;

  std::mutex mu_;
  std::condition_variable cv_not_empty_, cv_not_full_;
  std::deque<Record> pool_;   // the window
  std::deque<Record> ahead_;  // read ahead, in file order
  std::vector<Record> staged_;  // read, not yet handed over (producer's)
  bool done_ = false;
  bool closed_ = false;
  std::string error_;
  std::thread producer_;
};

}  // namespace

extern "C" {

void* tdf_open(const char** paths, const int64_t* offsets,
               const int64_t* lengths, int32_t nsegments, int64_t record_size,
               int32_t capacity, int32_t shuffle, uint64_t seed) {
  std::vector<Segment> segs;
  segs.reserve(nsegments);
  for (int32_t i = 0; i < nsegments; ++i) {
    segs.push_back(Segment{paths[i], offsets[i], lengths[i]});
  }
  return new Reader(std::move(segs), record_size, capacity, shuffle != 0, seed);
}

int64_t tdf_next_batch(void* h, char* out, int64_t out_cap, int64_t* rec_lens,
                       int64_t max_records) {
  return static_cast<Reader*>(h)->NextBatch(out, out_cap, rec_lens,
                                            max_records);
}

const char* tdf_error(void* h) { return static_cast<Reader*>(h)->Error(); }

void tdf_close(void* h) { delete static_cast<Reader*>(h); }

}  // extern "C"
