// fastsr_loader: native crop-extraction backend for the training pipeline
// of fast_srgan_torch (a copy of the JAX package's csrc/fastsr_loader.cpp).
//
// The reference feeds training with 16 Python DataLoader worker *processes*
// whose per-item work is: mmap an .npy, slice a random HxWx3 crop, convert
// and normalize (reference dataloader.py:24-38, train.py:81-113). Here the
// normalize/resize run on the device (train/steps.py prepare_batch), so the
// host hot path is exactly: page in the mapped file and memcpy crop rows.
// That is memcpy-bound work Python threads do with interpreter overhead per
// row; this library does it with a C++ thread pool over mmap'd files, called
// once per batch through ctypes (zero per-item Python transitions).
//
// Determinism contract: the caller (Python) draws file indices and crop
// offsets from its seeded RNG; this library is a pure gather.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -o libfastsr_loader.so
//        fastsr_loader.cpp -lpthread     (data/native.py builds it on first
//        use into fast_srgan_torch/_build/)

#include <atomic>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct MappedNpy {
  const uint8_t* data = nullptr;  // first element (past the npy header)
  void* base = nullptr;           // mmap base
  size_t map_len = 0;
  int64_t h = 0, w = 0, c = 0;
};

// Minimal .npy header parser for C-order uint8 arrays (the cache format
// written by data/preprocess.py).
bool parse_npy_header(const uint8_t* buf, size_t len, size_t* data_off,
                      int64_t* h, int64_t* w, int64_t* c) {
  if (len < 12 || std::memcmp(buf, "\x93NUMPY", 6) != 0) return false;
  const uint8_t major = buf[6];
  size_t header_len, header_off;
  if (major == 1) {
    header_len = buf[8] | (buf[9] << 8);
    header_off = 10;
  } else {
    header_len = buf[8] | (buf[9] << 8) | (buf[10] << 16) |
                 (static_cast<size_t>(buf[11]) << 24);
    header_off = 12;
  }
  if (header_off + header_len > len) return false;
  std::string header(reinterpret_cast<const char*>(buf + header_off),
                     header_len);
  if (header.find("'|u1'") == std::string::npos &&
      header.find("'uint8'") == std::string::npos)
    return false;
  if (header.find("'fortran_order': False") == std::string::npos) return false;
  size_t sp = header.find("'shape': (");
  if (sp == std::string::npos) return false;
  long long dims[3] = {0, 0, 0};
  int nd = 0;
  const char* p = header.c_str() + sp + 10;
  while (*p && *p != ')' && nd < 3) {
    while (*p == ' ' || *p == ',') ++p;
    if (*p == ')') break;
    dims[nd++] = strtoll(p, const_cast<char**>(&p), 10);
  }
  if (nd != 3) return false;
  *data_off = header_off + header_len;
  *h = dims[0];
  *w = dims[1];
  *c = dims[2];
  return true;
}

struct Dataset {
  std::vector<MappedNpy> files;
};

}  // namespace

extern "C" {

// Open n .npy files; returns an opaque handle, or nullptr on failure.
void* fsr_open(const char** paths, int32_t n) {
  auto* ds = new Dataset();
  ds->files.reserve(n);
  for (int32_t i = 0; i < n; ++i) {
    int fd = ::open(paths[i], O_RDONLY);
    if (fd < 0) {
      delete ds;
      return nullptr;
    }
    struct stat st;
    if (fstat(fd, &st) != 0) {
      ::close(fd);
      delete ds;
      return nullptr;
    }
    void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
    ::close(fd);
    if (base == MAP_FAILED) {
      delete ds;
      return nullptr;
    }
    madvise(base, st.st_size, MADV_RANDOM);  // crop access pattern
    MappedNpy m;
    size_t off = 0;
    if (!parse_npy_header(static_cast<const uint8_t*>(base), st.st_size, &off,
                          &m.h, &m.w, &m.c) ||
        m.c != 3 ||
        off + static_cast<size_t>(m.h) * m.w * m.c >
            static_cast<size_t>(st.st_size)) {
      munmap(base, st.st_size);
      delete ds;
      return nullptr;
    }
    m.base = base;
    m.map_len = st.st_size;
    m.data = static_cast<const uint8_t*>(base) + off;
    ds->files.push_back(m);
  }
  return ds;
}

void fsr_close(void* handle) {
  auto* ds = static_cast<Dataset*>(handle);
  if (!ds) return;
  for (auto& m : ds->files) munmap(m.base, m.map_len);
  delete ds;
}

int32_t fsr_num_files(void* handle) {
  return static_cast<int32_t>(static_cast<Dataset*>(handle)->files.size());
}

// hw_out[2*i], hw_out[2*i+1] = height, width of file i.
void fsr_shapes(void* handle, int64_t* hw_out) {
  auto* ds = static_cast<Dataset*>(handle);
  for (size_t i = 0; i < ds->files.size(); ++i) {
    hw_out[2 * i] = ds->files[i].h;
    hw_out[2 * i + 1] = ds->files[i].w;
  }
}

// Gather `batch` crops of size crop x crop x 3 into `out` (contiguous
// [batch, crop, crop, 3] uint8). Returns 0 on success, -1 on out-of-range.
int32_t fsr_crop_batch(void* handle, const int32_t* file_idx,
                       const int32_t* tops, const int32_t* lefts,
                       int32_t batch, int32_t crop, uint8_t* out,
                       int32_t threads) {
  auto* ds = static_cast<Dataset*>(handle);
  const size_t item_bytes = static_cast<size_t>(crop) * crop * 3;
  std::atomic<int32_t> bad{0};

  // Validate up front (cheap) so workers can run unchecked.
  for (int32_t i = 0; i < batch; ++i) {
    const int32_t f = file_idx[i];
    if (f < 0 || f >= static_cast<int32_t>(ds->files.size())) return -1;
    const MappedNpy& m = ds->files[f];
    if (tops[i] < 0 || lefts[i] < 0 || tops[i] + crop > m.h ||
        lefts[i] + crop > m.w)
      return -1;
  }

  auto worker = [&](int32_t begin, int32_t end) {
    for (int32_t i = begin; i < end; ++i) {
      const MappedNpy& m = ds->files[file_idx[i]];
      const size_t row_bytes = static_cast<size_t>(crop) * 3;
      const size_t src_stride = static_cast<size_t>(m.w) * 3;
      const uint8_t* src =
          m.data + (static_cast<size_t>(tops[i]) * m.w + lefts[i]) * 3;
      uint8_t* dst = out + static_cast<size_t>(i) * item_bytes;
      for (int32_t r = 0; r < crop; ++r) {
        std::memcpy(dst + r * row_bytes, src + r * src_stride, row_bytes);
      }
    }
  };

  if (threads <= 1 || batch <= 1) {
    worker(0, batch);
  } else {
    const int32_t n_threads = std::min(threads, batch);
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    const int32_t per = (batch + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; ++t) {
      const int32_t begin = t * per;
      const int32_t end = std::min(batch, begin + per);
      if (begin >= end) break;
      pool.emplace_back(worker, begin, end);
    }
    for (auto& th : pool) th.join();
  }
  return bad.load() ? -1 : 0;
}

}  // extern "C"
