// Native data-staging runtime: multithreaded .npy hyperspectral-cube loader.
//
// umhs_tpu/native/loader.cpp, whose code below this comment is copied byte
// for byte: the CPU side of the reference's data pipeline (torch DataLoader
// workers streaming per-frame .npy cubes, its umhsnerf/data/utils/
// hs_dataloader.py:46-58). The port stages whole splits into device memory
// once, as umhs_tpu does; for the 141-band Bayspec
// scenes that is gigabytes of .npy decode + clamp work, which this library
// parallelises across cores with raw pread into the destination buffer
// (no intermediate copies, no GIL).
//
// Exposed C ABI (ctypes):
//   umhs_load_npy_f32(paths, n_paths, out, elems_per_item, n_threads, clamp01)
//     -> 0 on success, else 1-based index of the first failing path.
//
// Supported .npy payloads: little-endian f32/f64/u8/u16, C-order, v1/v2/v3
// headers. Output is float32; u8 is scaled by 1/255, u16 by 1/65535.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct NpyInfo {
  size_t header_bytes = 0;
  size_t elems = 0;
  char dtype = '?';  // 'f' f32, 'd' f64, 'B' u8, 'H' u16
};

bool parse_header(int fd, NpyInfo* info) {
  unsigned char magic[10];
  if (pread(fd, magic, 10, 0) != 10) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  int major = magic[6];
  size_t hlen, hoff;
  if (major == 1) {
    hlen = magic[8] | (magic[9] << 8);
    hoff = 10;
  } else {
    unsigned char ext[4];
    if (pread(fd, ext, 4, 8) != 4) return false;
    hlen = ext[0] | (ext[1] << 8) | ((size_t)ext[2] << 16) | ((size_t)ext[3] << 24);
    hoff = 12;
  }
  std::string header(hlen, '\0');
  if (pread(fd, header.data(), hlen, hoff) != (ssize_t)hlen) return false;
  info->header_bytes = hoff + hlen;

  auto find = [&](const char* key) { return header.find(key); };
  size_t dt = find("'descr':");
  if (dt == std::string::npos) return false;
  size_t q1 = header.find('\'', dt + 8);  // opening quote of the value
  size_t q2 = header.find('\'', q1 + 1);
  std::string descr = header.substr(q1 + 1, q2 - q1 - 1);
  if (descr == "<f4") info->dtype = 'f';
  else if (descr == "<f8") info->dtype = 'd';
  else if (descr == "|u1") info->dtype = 'B';
  else if (descr == "<u2") info->dtype = 'H';
  else return false;
  if (header.find("'fortran_order': True") != std::string::npos) return false;

  size_t sp = find("shape");
  if (sp == std::string::npos) return false;
  size_t p1 = header.find('(', sp);
  size_t p2 = header.find(')', p1);
  std::string dims = header.substr(p1 + 1, p2 - p1 - 1);
  size_t elems = 1;
  const char* s = dims.c_str();
  char* end;
  while (*s) {
    long v = strtol(s, &end, 10);
    if (end == s) break;
    elems *= (size_t)v;
    s = end;
    while (*s == ',' || *s == ' ') ++s;
  }
  info->elems = elems;
  return true;
}

bool load_one(const char* path, float* out, size_t expect_elems, bool clamp01) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return false;
  NpyInfo info;
  if (!parse_header(fd, &info) || info.elems != expect_elems) {
    close(fd);
    return false;
  }
  size_t item = info.dtype == 'f' ? 4 : info.dtype == 'd' ? 8 : info.dtype == 'B' ? 1 : 2;
  size_t bytes = info.elems * item;
  std::vector<unsigned char> raw;
  unsigned char* src;
  if (info.dtype == 'f') {
    src = reinterpret_cast<unsigned char*>(out);  // read f32 directly in place
  } else {
    raw.resize(bytes);
    src = raw.data();
  }
  size_t done = 0;
  while (done < bytes) {
    ssize_t r = pread(fd, src + done, bytes - done, info.header_bytes + done);
    if (r <= 0) {
      close(fd);
      return false;
    }
    done += (size_t)r;
  }
  close(fd);

  switch (info.dtype) {
    case 'f':
      break;
    case 'd': {
      const double* p = reinterpret_cast<const double*>(src);
      for (size_t i = 0; i < info.elems; ++i) out[i] = (float)p[i];
      break;
    }
    case 'B': {
      const unsigned char* p = src;
      for (size_t i = 0; i < info.elems; ++i) out[i] = p[i] * (1.0f / 255.0f);
      break;
    }
    case 'H': {
      const uint16_t* p = reinterpret_cast<const uint16_t*>(src);
      for (size_t i = 0; i < info.elems; ++i) out[i] = p[i] * (1.0f / 65535.0f);
      break;
    }
  }
  if (clamp01) {
    for (size_t i = 0; i < info.elems; ++i) {
      float v = out[i];
      out[i] = v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Returns 0 on success; on failure, 1-based index of the first failing path.
int umhs_load_npy_f32(const char** paths, int n_paths, float* out,
                      long elems_per_item, int n_threads, int clamp01) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> failed(0);
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n_paths || failed.load() != 0) return;
      if (!load_one(paths[i], out + (size_t)i * elems_per_item,
                    (size_t)elems_per_item, clamp01 != 0)) {
        int expected = 0;
        failed.compare_exchange_strong(expected, i + 1);
        return;
      }
    }
  };
  std::vector<std::thread> threads;
  int nt = std::min(n_threads, n_paths);
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return failed.load();
}

}  // extern "C"
