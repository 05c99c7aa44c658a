// Native COLMAP points3D.bin reader (C ABI, ctypes-bound).
//
// The sparse point cloud is the one COLMAP binary that gets large — a
// MipNeRF-360-class capture triangulates 10^5-10^7 points, each with a
// variable-length observation track, so the Python struct-per-record
// loop (scene/colmap.py:read_points3d_bin) pays ~10 us/point. This
// walks the same wire format (little-endian, per the public COLMAP
// read_write_model.py spec) in one pass over a whole-file buffer.
//
// Role analog: the reference keeps its capture-asset parsing native too
// (gaussians.cpp PLY parser); same framework answer here — native IO
// runtime, TPU compute path.
//
// Build: lazily by scene/colmap_native.py (g++ -O3 -shared -fPIC),
// artifact keyed by source hash (never committed, never stale).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct Buf {
  std::vector<unsigned char> data;
  size_t off = 0;
  bool ok = true;

  template <typename T>
  T get() {
    T v{};
    if (off + sizeof(T) > data.size()) {
      ok = false;
      return v;
    }
    std::memcpy(&v, data.data() + off, sizeof(T));  // alignment-safe
    off += sizeof(T);
    return v;
  }

  bool skip(size_t n) {
    if (off + n > data.size()) {
      ok = false;
      return false;
    }
    off += n;
    return true;
  }
};

bool read_file(const char* path, std::vector<unsigned char>& out) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  if (size < 0) {
    std::fclose(f);
    return false;
  }
  std::fseek(f, 0, SEEK_SET);
  out.resize(static_cast<size_t>(size));
  size_t got = size ? std::fread(out.data(), 1, out.size(), f) : 0;
  std::fclose(f);
  return got == out.size();
}

}  // namespace

extern "C" {

// Number of points, or -1 on unreadable/truncated file.
long long colmap_points_count(const char* path) {
  Buf b;
  if (!read_file(path, b.data)) return -1;
  uint64_t n = b.get<uint64_t>();
  if (!b.ok) return -1;
  return static_cast<long long>(n);
}

// Fills caller-allocated xyz (n,3) f64, rgb (n,3) u8, err (n,) f64.
// Returns 0 on success, nonzero error codes otherwise.
int colmap_points_load(const char* path, long long n, double* xyz,
                       unsigned char* rgb, double* err) {
  Buf b;
  if (!read_file(path, b.data)) return 1;
  uint64_t count = b.get<uint64_t>();
  if (!b.ok || static_cast<long long>(count) != n) return 2;
  for (long long i = 0; i < n; ++i) {
    b.get<uint64_t>();  // point3D_id
    xyz[i * 3 + 0] = b.get<double>();
    xyz[i * 3 + 1] = b.get<double>();
    xyz[i * 3 + 2] = b.get<double>();
    rgb[i * 3 + 0] = b.get<unsigned char>();
    rgb[i * 3 + 1] = b.get<unsigned char>();
    rgb[i * 3 + 2] = b.get<unsigned char>();
    err[i] = b.get<double>();
    uint64_t track = b.get<uint64_t>();
    if (!b.ok || !b.skip(track * 8)) return 3;  // (image_id, point2D_idx)
  }
  return b.ok ? 0 : 3;
}

}  // extern "C"
