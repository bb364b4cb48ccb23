// Native RecordIO reader: index scan and multi-threaded batch reads off
// the Python thread.
//
// The port's copy of incubator_mxnet_tpu/src/io/recordio_native.cc (the
// reader of MXNet's RecordIO format, dmlc-core's `recordio.cc`, with the
// record reads of `src/io/iter_image_recordio_2.cc`). Same on-disk format
// as io/recordio.py:
//   record := magic(u32)=0xced7230a | cflag_len(u32) | payload | pad to 4B
//
// A plain C interface, loaded through ctypes (io/_native.py builds it with
// g++ on first use). All reads use pread, so one handle serves many
// threads; the batch call fans out over a small thread pool, which is what
// it gains over the Python reader (file reads and record splitting
// without the interpreter lock).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0xced7230a;
constexpr uint32_t kLenMask = (1u << 29) - 1;

struct Handle {
  int fd = -1;
  int64_t file_size = 0;
  std::vector<int64_t> offsets;  // record start offsets (header position)
  std::vector<int64_t> lengths;  // payload lengths
};

int64_t PayloadAt(const Handle* h, int64_t offset, int64_t* length_out) {
  uint32_t header[2];
  if (pread(h->fd, header, 8, offset) != 8) return -1;
  if (header[0] != kMagic) return -2;
  *length_out = static_cast<int64_t>(header[1] & kLenMask);
  return offset + 8;
}

}  // namespace

extern "C" {

void* mxtpu_rio_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  Handle* h = new Handle();
  h->fd = fd;
  h->file_size = st.st_size;
  return h;
}

void mxtpu_rio_close(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  if (h == nullptr) return;
  if (h->fd >= 0) close(h->fd);
  delete h;
}

// Scan the whole file once, recording every record's offset+length.
// Returns the record count, or a negative errno-style code.
int64_t mxtpu_rio_scan(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  if (h == nullptr) return -1;
  h->offsets.clear();
  h->lengths.clear();
  // buffered sequential scan
  constexpr int64_t kChunk = 8 << 20;
  std::vector<char> buf(kChunk);
  int64_t pos = 0;
  while (pos + 8 <= h->file_size) {
    uint32_t header[2];
    if (pread(h->fd, header, 8, pos) != 8) return -2;
    if (header[0] != kMagic) return -3;
    int64_t len = static_cast<int64_t>(header[1] & kLenMask);
    h->offsets.push_back(pos);
    h->lengths.push_back(len);
    int64_t padded = (len + 3) & ~int64_t{3};
    pos += 8 + padded;
  }
  (void)buf;
  return static_cast<int64_t>(h->offsets.size());
}

int64_t mxtpu_rio_count(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  return h ? static_cast<int64_t>(h->offsets.size()) : -1;
}

// Copy scan results out (cap = capacity of each array).
int64_t mxtpu_rio_index(void* handle, int64_t* offsets, int64_t* lengths,
                        int64_t cap) {
  Handle* h = static_cast<Handle*>(handle);
  if (h == nullptr) return -1;
  int64_t n = std::min<int64_t>(cap, h->offsets.size());
  std::memcpy(offsets, h->offsets.data(), n * sizeof(int64_t));
  std::memcpy(lengths, h->lengths.data(), n * sizeof(int64_t));
  return n;
}

// Read one payload at a header offset. Returns payload length or negative.
int64_t mxtpu_rio_read_at(void* handle, int64_t offset, char* out,
                          int64_t cap) {
  Handle* h = static_cast<Handle*>(handle);
  if (h == nullptr) return -1;
  int64_t len = 0;
  int64_t payload_off = PayloadAt(h, offset, &len);
  if (payload_off < 0) return payload_off;
  if (len > cap) return -4;
  int64_t got = pread(h->fd, out, len, payload_off);
  return got == len ? len : -5;
}

// Read n records (by header offsets) into one contiguous buffer using a
// thread pool. out_lens[i] receives each payload length; payloads are
// packed back-to-back in request order. Returns total bytes or negative.
int64_t mxtpu_rio_read_batch(void* handle, const int64_t* offsets, int64_t n,
                             char* out, int64_t cap, int64_t* out_lens,
                             int64_t n_threads) {
  Handle* h = static_cast<Handle*>(handle);
  if (h == nullptr) return -1;
  std::vector<int64_t> lens(n), payload_offs(n), starts(n);
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t len = 0;
    int64_t poff = PayloadAt(h, offsets[i], &len);
    if (poff < 0) return poff;
    lens[i] = len;
    payload_offs[i] = poff;
    starts[i] = total;
    total += len;
  }
  if (total > cap) return -4;

  n_threads = std::max<int64_t>(1, std::min<int64_t>(n_threads, n));
  std::atomic<int64_t> next{0};
  std::atomic<bool> ok{true};
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n || !ok.load()) break;
      int64_t got = pread(h->fd, out + starts[i], lens[i], payload_offs[i]);
      if (got != lens[i]) ok.store(false);
    }
  };
  std::vector<std::thread> pool;
  for (int64_t t = 1; t < n_threads; ++t) pool.emplace_back(worker);
  worker();
  for (auto& t : pool) t.join();
  if (!ok.load()) return -5;
  std::memcpy(out_lens, lens.data(), n * sizeof(int64_t));
  return total;
}

}  // extern "C"
