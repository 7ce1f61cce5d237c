// Async trajectory telemetry recorder (native host runtime).
//
// Role of the reference's SaveMixin HDF5 checkpointing and per-iteration
// file logging (reference src/aircraft/control/base.py:48-114,508-541) with
// the one design change that matters: observability NEVER blocks the control
// loop.  The reference ran plotting/logging synchronously inside the IPOPT
// callback — 411.5 s of one 423.6 s solve (SURVEY.md §6).  Here producers
// copy records into a bounded in-memory ring and return immediately; a
// dedicated writer thread drains the ring to disk in large chunks.  When the
// ring is full, records are DROPPED and counted — backpressure is never
// propagated to the solver.
//
// File format (little-endian):
//   bytes 0-7   magic "ATPTLOG1"
//   bytes 8-11  uint32 version (1)
//   bytes 12-15 uint32 rec_floats (doubles per record)
//   then        written_records * rec_floats float64
//
// C API (ctypes-bound from aircraft_tpu_torch/native/telemetry.py, which also
// carries a pure-Python fallback writing the identical format).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <new>
#include <thread>
#include <vector>

namespace {

constexpr char kMagic[8] = {'A', 'T', 'P', 'T', 'L', 'O', 'G', '1'};
constexpr uint32_t kVersion = 1;

struct Recorder {
  FILE* f = nullptr;
  int rec_floats = 0;
  size_t capacity = 0;  // ring capacity in records

  // ring buffer of capacity*rec_floats doubles; [tail, tail+count) live
  std::vector<double> ring;
  size_t tail = 0;      // oldest record index
  size_t count = 0;     // live records
  size_t inflight = 0;  // records copied out by the writer, fwrite pending

  std::atomic<uint64_t> written{0};
  std::atomic<uint64_t> dropped{0};

  std::mutex mu;
  std::condition_variable cv_data;   // signalled on push / close
  std::condition_variable cv_space;  // signalled when the ring drains
  bool closing = false;

  std::thread writer;
};

void writer_loop(Recorder* r) {
  // Drain in chunks: copy out under the lock, fwrite with the lock released
  // so producers never wait on disk.
  std::vector<double> chunk;
  chunk.reserve(4096 * static_cast<size_t>(r->rec_floats));
  for (;;) {
    size_t n = 0;
    {
      std::unique_lock<std::mutex> lk(r->mu);
      r->cv_data.wait(lk, [r] { return r->count > 0 || r->closing; });
      if (r->count == 0 && r->closing) break;
      n = r->count;
      chunk.clear();
      const size_t rf = static_cast<size_t>(r->rec_floats);
      for (size_t i = 0; i < n; ++i) {
        const size_t idx = (r->tail + i) % r->capacity;
        const double* src = r->ring.data() + idx * rf;
        chunk.insert(chunk.end(), src, src + rf);
      }
      // free the slots for producers immediately (the chunk is a copy),
      // but account the records as in-flight until fwrite completes so
      // tel_flush cannot return before the data reaches the FILE
      r->tail = (r->tail + n) % r->capacity;
      r->count = 0;
      r->inflight = n;
    }
    if (n > 0) {
      fwrite(chunk.data(), sizeof(double),
             n * static_cast<size_t>(r->rec_floats), r->f);
      r->written.fetch_add(n, std::memory_order_relaxed);
    }
    {
      std::lock_guard<std::mutex> lk(r->mu);
      r->inflight = 0;
    }
    r->cv_space.notify_all();
  }
  fflush(r->f);
}

}  // namespace

extern "C" {

// Returns an opaque handle, or nullptr on failure.
void* tel_open(const char* path, int rec_floats, long capacity) {
  if (rec_floats <= 0 || capacity <= 0) return nullptr;
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  auto* r = new (std::nothrow) Recorder();
  if (!r) {
    fclose(f);
    return nullptr;
  }
  r->f = f;
  r->rec_floats = rec_floats;
  r->capacity = static_cast<size_t>(capacity);
  r->ring.resize(r->capacity * static_cast<size_t>(rec_floats));
  fwrite(kMagic, 1, 8, f);
  fwrite(&kVersion, sizeof(uint32_t), 1, f);
  const uint32_t rf = static_cast<uint32_t>(rec_floats);
  fwrite(&rf, sizeof(uint32_t), 1, f);
  r->writer = std::thread(writer_loop, r);
  return r;
}

// Non-blocking push of n records (n * rec_floats doubles, row-major).
// Returns the number of records accepted; the rest are counted as dropped.
long tel_push(void* h, const double* recs, long n) {
  auto* r = static_cast<Recorder*>(h);
  if (!r || n <= 0) return 0;
  const size_t rf = static_cast<size_t>(r->rec_floats);
  size_t accepted = 0;
  {
    std::lock_guard<std::mutex> lk(r->mu);
    if (r->closing) return 0;
    const size_t space = r->capacity - r->count;
    accepted = std::min(static_cast<size_t>(n), space);
    for (size_t i = 0; i < accepted; ++i) {
      const size_t idx = (r->tail + r->count + i) % r->capacity;
      std::memcpy(r->ring.data() + idx * rf, recs + i * rf,
                  rf * sizeof(double));
    }
    r->count += accepted;
  }
  if (accepted > 0) r->cv_data.notify_one();
  const size_t lost = static_cast<size_t>(n) - accepted;
  if (lost > 0) r->dropped.fetch_add(lost, std::memory_order_relaxed);
  return static_cast<long>(accepted);
}

// Block until everything pushed so far is on disk (ring drained, pending
// fwrite completed, fflush).
void tel_flush(void* h) {
  auto* r = static_cast<Recorder*>(h);
  if (!r) return;
  {
    std::unique_lock<std::mutex> lk(r->mu);
    r->cv_space.wait(lk, [r] { return r->count == 0 && r->inflight == 0; });
  }
  fflush(r->f);
}

void tel_stats(void* h, long* written, long* dropped) {
  auto* r = static_cast<Recorder*>(h);
  if (!r) return;
  if (written) *written = static_cast<long>(r->written.load());
  if (dropped) *dropped = static_cast<long>(r->dropped.load());
}

void tel_close(void* h) {
  auto* r = static_cast<Recorder*>(h);
  if (!r) return;
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->closing = true;
  }
  r->cv_data.notify_all();
  r->writer.join();
  fclose(r->f);
  delete r;
}

}  // extern "C"
