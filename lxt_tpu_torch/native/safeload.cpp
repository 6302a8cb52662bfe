// Native safetensors loader: per-tensor mmap + multithreaded dtype widening.
//
// The port's own copy of lxt_tpu/native/safeload.cpp. HF checkpoints are
// read directly: a tensor's bytes are mmap'd (zero-copy views for tensors
// read as stored) and bf16/f16 payloads are widened to f32 by a small
// thread pool. Exposed to Python via ctypes (lxt_tpu_torch/io.py, which
// builds it with g++ at first use into lxt_tpu_torch/_build/).
//
// Changes against the copied file: the header is read with pread, and each
// tensor is mapped on its own (sl_map / sl_unmap) instead of the whole file
// at open. A converter that reads one tensor at a time then holds one
// tensor's pages: the mapping ends with the last view of it (on the H100
// machine's kernel the first fault of a whole-file mapping made most of the
// file resident at once). The mapping is private and writable: a write into
// a view copies its page and never reaches the file, so the views can be
// handed to numpy and torch as ordinary writable arrays.
//
// File format (safetensors): u64 little-endian header length N, then N bytes
// of JSON {name: {dtype, shape, data_offsets:[begin,end]}, "__metadata__"?},
// then the tensor byte buffer. Offsets are relative to the end of the header.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread safeload.cpp -o libsafeload.so

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Container {
  int fd = -1;
  uint64_t size = 0;      // file bytes
  uint64_t hlen = 0;      // JSON header bytes
  std::vector<char> header;
};

inline float bf16_to_f32(uint16_t v) {
  uint32_t bits = static_cast<uint32_t>(v) << 16;
  float out;
  std::memcpy(&out, &bits, sizeof(out));
  return out;
}

inline float f16_to_f32(uint16_t h) {
  uint32_t sign = (h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t mant = h & 0x3FF;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;
    } else {  // subnormal: normalize
      int shift = 0;
      while (!(mant & 0x400)) { mant <<= 1; ++shift; }
      mant &= 0x3FF;
      bits = sign | ((127 - 15 - shift + 1) << 23) | (mant << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7F800000u | (mant << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float out;
  std::memcpy(&out, &bits, sizeof(out));
  return out;
}

void widen_range(const uint16_t* src, float* dst, size_t begin, size_t end,
                 int kind /*0=bf16, 1=f16*/) {
  if (kind == 0) {
    for (size_t i = begin; i < end; ++i) dst[i] = bf16_to_f32(src[i]);
  } else {
    for (size_t i = begin; i < end; ++i) dst[i] = f16_to_f32(src[i]);
  }
}

}  // namespace

extern "C" {

// Open a file and read its header; returns an opaque handle (heap
// Container*), null on failure or on a malformed container (size < 8 or
// header length past end-of-file) — rejecting truncated files here prevents
// out-of-bounds reads downstream.
void* sl_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  uint64_t hlen = 0;
  if (fstat(fd, &st) != 0 || st.st_size < 8 || ::pread(fd, &hlen, 8, 0) != 8 ||
      hlen > static_cast<uint64_t>(st.st_size) - 8) {
    ::close(fd);
    return nullptr;
  }
  auto* c = new Container{fd, static_cast<uint64_t>(st.st_size), hlen,
                          std::vector<char>(hlen)};
  uint64_t done = 0;
  while (done < hlen) {
    const ssize_t n = ::pread(fd, c->header.data() + done, hlen - done, 8 + done);
    if (n <= 0) {
      ::close(fd);
      delete c;
      return nullptr;
    }
    done += static_cast<uint64_t>(n);
  }
  return c;
}

uint64_t sl_header_len(void* handle) {
  return handle ? static_cast<Container*>(handle)->hlen : 0;
}

// Pointer to the JSON header (NOT null-terminated; length = sl_header_len).
const char* sl_header(void* handle) {
  return static_cast<Container*>(handle)->header.data();
}

uint64_t sl_file_size(void* handle) {
  return static_cast<Container*>(handle)->size;
}

// Map bytes [off, off + len) past the header (len > 0, inside the file) on
// their own, private and writable, with readahead advised; returns a
// pointer to byte `off`, null on failure. Unmap with sl_unmap(ptr, len).
void* sl_map(void* handle, uint64_t off, uint64_t len) {
  auto* c = static_cast<Container*>(handle);
  const uint64_t page = static_cast<uint64_t>(::sysconf(_SC_PAGESIZE));
  const uint64_t begin = 8 + c->hlen + off, base = begin / page * page;
  void* m = ::mmap(nullptr, begin + len - base, PROT_READ | PROT_WRITE, MAP_PRIVATE,
                   c->fd, static_cast<off_t>(base));
  if (m == MAP_FAILED) return nullptr;
  ::madvise(m, begin + len - base, MADV_WILLNEED);
  return static_cast<char*>(m) + (begin - base);
}

void sl_unmap(void* ptr, uint64_t len) {
  const uintptr_t page = static_cast<uintptr_t>(::sysconf(_SC_PAGESIZE));
  const uintptr_t p = reinterpret_cast<uintptr_t>(ptr), base = p / page * page;
  ::munmap(reinterpret_cast<void*>(base), p + len - base);
}

// Widen a half-precision payload into a caller-provided f32 buffer using
// `threads` workers. kind: 0 = bfloat16, 1 = float16.
void sl_widen(const void* src, float* dst, uint64_t count, int kind,
              int threads) {
  const auto* s = static_cast<const uint16_t*>(src);
  if (threads <= 1 || count < (1u << 20)) {
    widen_range(s, dst, 0, count, kind);
    return;
  }
  std::vector<std::thread> pool;
  uint64_t chunk = (count + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    uint64_t b = t * chunk;
    uint64_t e = b + chunk < count ? b + chunk : count;
    if (b >= e) break;
    pool.emplace_back(widen_range, s, dst, b, e, kind);
  }
  for (auto& th : pool) th.join();
}

void sl_close(void* handle) {
  auto* c = static_cast<Container*>(handle);
  if (!c) return;
  ::close(c->fd);
  delete c;
}

}  // extern "C"
