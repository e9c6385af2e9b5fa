// Native clip engine for the training loader: batched window copies out of
// memory-mapped .npy feature files.
//
// A training batch is many fixed-length clips cut out of the preprocessed
// mel (80, T) and mu-law (T,) files. This library maps every file once and
// copies a whole batch's windows per call on a small thread pool, outside
// the Python GIL (ctypes releases it for the call), so batch assembly on the
// loader's thread does not hold back the trainer's thread.
//
// Scope: C-order .npy v1/v2, 1-D (T,) or 2-D (R, T) arrays, windows over
// the trailing (time) axis. The binding (data/native.py) builds it with
// g++, checks dtypes and row counts, and raises where it cannot build.

#include <algorithm>
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

struct File {
  const uint8_t* base = nullptr;  // mmap base (for munmap)
  size_t map_size = 0;
  const uint8_t* data = nullptr;  // first element
  int64_t rows = 0;               // 1 for 1-D arrays
  int64_t cols = 0;               // trailing (time) axis
  int32_t esize = 0;              // element size in bytes
};

// Minimal .npy v1/v2 header parse: returns false on anything unsupported
// (fortran order, >2 dims, exotic dtypes). descr is only used for esize;
// byte order is the platform's (files are written by the same host).
bool parse_header(const uint8_t* p, size_t n, File* f) {
  if (n < 10 || std::memcmp(p, "\x93NUMPY", 6) != 0) return false;
  const uint8_t major = p[6];
  size_t hlen, hoff;
  if (major == 1) {
    hlen = static_cast<size_t>(p[8]) | (static_cast<size_t>(p[9]) << 8);
    hoff = 10;
  } else {
    if (n < 12) return false;
    hlen = static_cast<size_t>(p[8]) | (static_cast<size_t>(p[9]) << 8) |
           (static_cast<size_t>(p[10]) << 16) |
           (static_cast<size_t>(p[11]) << 24);
    hoff = 12;
  }
  if (hoff + hlen > n) return false;
  std::string h(reinterpret_cast<const char*>(p + hoff), hlen);

  if (h.find("'fortran_order': False") == std::string::npos) return false;

  size_t d = h.find("'descr':");
  if (d == std::string::npos) return false;
  size_t q1 = h.find('\'', d + 8);
  size_t q2 = h.find('\'', q1 + 1);
  if (q1 == std::string::npos || q2 == std::string::npos) return false;
  std::string descr = h.substr(q1 + 1, q2 - q1 - 1);  // e.g. "<f4", "<i2"
  int es = 0;
  for (char c : descr)
    if (c >= '0' && c <= '9') es = es * 10 + (c - '0');
  if (es <= 0 || es > 16) return false;

  size_t s = h.find("'shape':");
  if (s == std::string::npos) return false;
  size_t o = h.find('(', s);
  size_t c = h.find(')', o);
  if (o == std::string::npos || c == std::string::npos) return false;
  std::vector<int64_t> dims;
  int64_t cur = -1;
  for (size_t i = o + 1; i < c; ++i) {
    char ch = h[i];
    if (ch >= '0' && ch <= '9')
      cur = (cur < 0 ? 0 : cur) * 10 + (ch - '0');
    else if (ch == ',') {
      if (cur >= 0) dims.push_back(cur);
      cur = -1;
    }
  }
  if (cur >= 0) dims.push_back(cur);
  if (dims.empty() || dims.size() > 2) return false;

  f->esize = es;
  f->rows = dims.size() == 2 ? dims[0] : 1;
  f->cols = dims.size() == 2 ? dims[1] : dims[0];
  f->data = p + hoff + hlen;
  if (static_cast<size_t>(f->rows * f->cols) * es >
      n - (hoff + hlen))
    return false;
  return true;
}

}  // namespace

extern "C" {

struct CsStore {
  std::vector<File> files;
};

// Open + mmap n .npy files. Returns nullptr if any file fails to parse.
CsStore* cs_open(const char** paths, int32_t n) {
  auto* store = new CsStore();
  store->files.reserve(n);
  for (int32_t i = 0; i < n; ++i) {
    int fd = ::open(paths[i], O_RDONLY);
    if (fd < 0) break;
    struct stat st;
    if (fstat(fd, &st) != 0) {
      ::close(fd);
      break;
    }
    void* m = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
    ::close(fd);
    if (m == MAP_FAILED) break;
    File f;
    f.base = static_cast<const uint8_t*>(m);
    f.map_size = st.st_size;
    if (!parse_header(f.base, f.map_size, &f)) {
      munmap(m, st.st_size);
      break;
    }
    store->files.push_back(f);
  }
  if (static_cast<int32_t>(store->files.size()) != n) {
    for (auto& f : store->files)
      munmap(const_cast<uint8_t*>(f.base), f.map_size);
    delete store;
    return nullptr;
  }
  return store;
}

void cs_close(CsStore* s) {
  if (!s) return;
  for (auto& f : s->files)
    munmap(const_cast<uint8_t*>(f.base), f.map_size);
  delete s;
}

static bool cs_valid(CsStore* s, int32_t i) {
  return s && i >= 0 && i < static_cast<int32_t>(s->files.size());
}
int64_t cs_rows(CsStore* s, int32_t i) {
  return cs_valid(s, i) ? s->files[i].rows : -1;
}
int64_t cs_cols(CsStore* s, int32_t i) {
  return cs_valid(s, i) ? s->files[i].cols : -1;
}
int32_t cs_esize(CsStore* s, int32_t i) {
  return cs_valid(s, i) ? s->files[i].esize : -1;
}

// Copy `count` windows [start, start+clip) over the time axis into `out`,
// laid out (count, rows, clip) with the files' element size. All referenced
// files must share rows/esize (the wrapper guarantees it). Returns 0 on
// success, or 1-based index of the first out-of-bounds request.
int32_t cs_sample(CsStore* s, const int32_t* ids, const int64_t* starts,
                  int32_t count, int64_t clip, uint8_t* out,
                  int32_t n_threads) {
  if (count <= 0) return 0;
  const int32_t n_files = static_cast<int32_t>(s->files.size());

  // Bounds-check up front (cheap; keeps the copy loop branch-free). File
  // ids are validated BEFORE any dereference so the exported C ABI is safe
  // against bad indices, not just the Python wrapper's own calls.
  for (int32_t i = 0; i < count; ++i) {
    if (ids[i] < 0 || ids[i] >= n_files) return i + 1;
  }
  const File& f0 = s->files[ids[0]];
  const int64_t rows = f0.rows;
  const int32_t es = f0.esize;
  const size_t item_bytes = static_cast<size_t>(rows) * clip * es;
  for (int32_t i = 0; i < count; ++i) {
    const File& f = s->files[ids[i]];
    if (starts[i] < 0 || starts[i] + clip > f.cols || f.rows != rows ||
        f.esize != es)
      return i + 1;
  }

  auto work = [&](int32_t lo, int32_t hi) {
    for (int32_t i = lo; i < hi; ++i) {
      const File& f = s->files[ids[i]];
      uint8_t* dst = out + static_cast<size_t>(i) * item_bytes;
      const uint8_t* src = f.data + static_cast<size_t>(starts[i]) * es;
      const size_t row_bytes = static_cast<size_t>(clip) * es;
      const size_t src_stride = static_cast<size_t>(f.cols) * es;
      for (int64_t r = 0; r < rows; ++r)
        std::memcpy(dst + r * row_bytes, src + r * src_stride, row_bytes);
    }
  };

  int32_t nt = n_threads;
  if (nt < 1) nt = 1;
  if (nt > count) nt = count;
  if (nt == 1) {
    work(0, count);
    return 0;
  }
  std::vector<std::thread> threads;
  threads.reserve(nt);
  const int32_t per = (count + nt - 1) / nt;
  for (int32_t t = 0; t < nt; ++t) {
    int32_t lo = t * per, hi = std::min(count, lo + per);
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"
