// Native sample-log storage engine (host C++, no CUDA).
//
// The runtime-side complement of the Python storage layer: an append-only,
// memory-mapped binary log of per-level sample results with a background
// prefetch thread for the out-of-core estimation read path. Where the HDF5
// storage delegates persistence to the HDF5 C library through h5py, this
// engine owns the hot IO path natively:
//
//   * writer: O_APPEND writes of fixed-size records ([2, M] float64 per
//     sample), fdatasync on flush; a small header carries (magic, version,
//     M).
//   * reader: mmap + MADV_SEQUENTIAL; chunk fetches memcpy into
//     caller-provided numpy buffers (which the estimators wrap with
//     torch.as_tensor and copy to the CUDA device chunk by chunk), while a
//     prefetcher thread touches pages ahead of the read cursor so
//     page-cache misses never stall the device feed.
//
// The format is the one mlmc_tpu/native/sample_log.cpp writes: a log made by
// either package is read by the other.
//
// Exposed as a C ABI consumed via ctypes.
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x4d4c4d435f42494eULL;  // "MLMC_BIN"
constexpr uint32_t kVersion = 1;

struct Header {
  uint64_t magic;
  uint32_t version;
  uint32_t m;  // flattened result vector length
};

struct Writer {
  int fd = -1;
  uint32_t m = 0;
};

struct Reader {
  int fd = -1;
  uint8_t* map = nullptr;
  size_t map_size = 0;
  uint32_t m = 0;
  uint64_t n_records = 0;
  // prefetcher
  std::thread prefetch_thread;
  std::atomic<uint64_t> cursor{0};   // record index the consumer reached
  std::atomic<bool> stop{false};
  uint64_t prefetch_ahead = 0;       // records to touch ahead of cursor
};

inline size_t record_bytes(uint32_t m) { return 2ull * m * sizeof(double); }

}  // namespace

extern "C" {

// ------------------------------ writer ------------------------------- //
void* mlmc_writer_open(const char* path, uint32_t m) {
  int fd = ::open(path, O_CREAT | O_RDWR | O_APPEND, 0644);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); return nullptr; }
  if (st.st_size == 0) {
    Header h{kMagic, kVersion, m};
    if (::write(fd, &h, sizeof(h)) != sizeof(h)) { ::close(fd); return nullptr; }
  } else {
    Header h;
    if (pread(fd, &h, sizeof(h), 0) != sizeof(h) || h.magic != kMagic ||
        h.m != m) {
      ::close(fd);
      return nullptr;
    }
  }
  auto* w = new Writer;
  w->fd = fd;
  w->m = m;
  return w;
}

// values: [n, 2, m] float64
int64_t mlmc_writer_append(void* handle, const double* values, uint64_t n) {
  auto* w = static_cast<Writer*>(handle);
  size_t bytes = n * record_bytes(w->m);
  const uint8_t* p = reinterpret_cast<const uint8_t*>(values);
  size_t done = 0;
  while (done < bytes) {
    ssize_t r = ::write(w->fd, p + done, bytes - done);
    if (r < 0) return -1;
    done += static_cast<size_t>(r);
  }
  return static_cast<int64_t>(n);
}

int mlmc_writer_flush(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  return fdatasync(w->fd);
}

void mlmc_writer_close(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  if (w->fd >= 0) ::close(w->fd);
  delete w;
}

// ------------------------------ reader ------------------------------- //
void* mlmc_reader_open(const char* path, uint64_t prefetch_ahead_records) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || static_cast<size_t>(st.st_size) < sizeof(Header)) {
    ::close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (map == MAP_FAILED) { ::close(fd); return nullptr; }
  madvise(map, st.st_size, MADV_SEQUENTIAL);

  auto* r = new Reader;
  r->fd = fd;
  r->map = static_cast<uint8_t*>(map);
  r->map_size = st.st_size;
  const Header* h = reinterpret_cast<const Header*>(r->map);
  // m == 0 would divide by zero below; reject corrupted headers
  if (h->magic != kMagic || h->m == 0) {
    munmap(map, st.st_size);
    ::close(fd);
    delete r;
    return nullptr;
  }
  r->m = h->m;
  r->n_records = (st.st_size - sizeof(Header)) / record_bytes(h->m);
  r->prefetch_ahead = prefetch_ahead_records;

  if (prefetch_ahead_records > 0) {
    r->prefetch_thread = std::thread([r]() {
      const size_t rec = record_bytes(r->m);
      uint64_t touched = 0;
      volatile uint8_t sink = 0;
      while (!r->stop.load(std::memory_order_relaxed)) {
        uint64_t target = r->cursor.load(std::memory_order_relaxed) +
                          r->prefetch_ahead;
        if (target > r->n_records) target = r->n_records;
        if (touched >= target) {
          std::this_thread::sleep_for(std::chrono::microseconds(200));
          continue;
        }
        // touch one page per iteration step within the next record range
        size_t off = sizeof(Header) + touched * rec;
        size_t end = sizeof(Header) + target * rec;
        for (size_t p = off; p < end && !r->stop.load(std::memory_order_relaxed);
             p += 4096) {
          sink ^= r->map[p];
        }
        touched = target;
      }
      (void)sink;
    });
  }
  return r;
}

uint64_t mlmc_reader_n_records(void* handle) {
  return static_cast<Reader*>(handle)->n_records;
}

uint32_t mlmc_reader_m(void* handle) {
  return static_cast<Reader*>(handle)->m;
}

// copy records [start, start+n) into out ([n, 2, m] float64)
int64_t mlmc_reader_read(void* handle, uint64_t start, uint64_t n,
                         double* out) {
  auto* r = static_cast<Reader*>(handle);
  if (start > r->n_records) return -1;
  // clamp by subtraction: `start + n` could wrap uint64 for absurd n
  if (n > r->n_records - start) n = r->n_records - start;
  const size_t rec = record_bytes(r->m);
  std::memcpy(out, r->map + sizeof(Header) + start * rec, n * rec);
  r->cursor.store(start + n, std::memory_order_relaxed);
  return static_cast<int64_t>(n);
}

void mlmc_reader_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  r->stop.store(true);
  if (r->prefetch_thread.joinable()) r->prefetch_thread.join();
  if (r->map) munmap(r->map, r->map_size);
  if (r->fd >= 0) ::close(r->fd);
  delete r;
}

}  // extern "C"
