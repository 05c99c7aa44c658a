// Native 3DGS PLY loader — C++ twin of the Python parser in scene/io.py.
//
// TPU-native counterpart of the reference's C++ streaming parser
// (src/core/utils/gaussians.cpp:32-142 and its CUDA upload twin
// src/core/cuda/misc.cu:13-135): header scan for format/element/property
// lines, property-name dispatch, binary_little_endian only, and the same
// load-time activations (opacity = sigmoid(raw), scale = exp(raw),
// gaussians.cpp:25-26). Instead of cudaMemcpy-ing an AoS Gaussian array to
// the device, it fills caller-provided SoA buffers (positions / sh /
// opacity / scales / quats) that Python hands straight to jax.device_put.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this environment).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

namespace {

struct Property {
  std::string name;
  int size = 4;      // bytes
  bool is_float = true;
};

// Parsed header description.
struct Header {
  long long num_vertices = -1;
  std::vector<Property> props;
  std::streamoff body_offset = 0;
  bool little_endian_binary = false;
};

bool parse_header(std::ifstream& f, Header* out, std::string* err) {
  std::string line;
  if (!std::getline(f, line)) { *err = "empty file"; return false; }
  // Strip optional \r (files written on Windows — the reference's dev env).
  if (!line.empty() && line.back() == '\r') line.pop_back();
  if (line != "ply") { *err = "missing 'ply' magic"; return false; }
  bool in_vertex = false;
  while (std::getline(f, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    if (line == "end_header") {
      out->body_offset = f.tellg();
      return out->num_vertices >= 0;
    }
    std::istringstream ss(line);
    std::string tok;
    ss >> tok;
    if (tok == "comment") continue;
    if (tok == "format") {
      std::string fmt, ver;
      ss >> fmt >> ver;
      out->little_endian_binary = (fmt == "binary_little_endian");
    } else if (tok == "element") {
      std::string name;
      long long n;
      ss >> name >> n;
      in_vertex = (name == "vertex");
      if (in_vertex) out->num_vertices = n;
    } else if (tok == "property" && in_vertex) {
      std::string type, name;
      ss >> type >> name;
      if (type == "list") { *err = "list properties unsupported"; return false; }
      Property p;
      p.name = name;
      if (type == "float" || type == "float32") { p.size = 4; p.is_float = true; }
      else if (type == "double" || type == "float64") { p.size = 8; p.is_float = true; }
      else if (type == "uchar" || type == "uint8" || type == "char" || type == "int8") { p.size = 1; p.is_float = false; }
      else if (type == "short" || type == "ushort" || type == "int16" || type == "uint16") { p.size = 2; p.is_float = false; }
      else { p.size = 4; p.is_float = false; }
      out->props.push_back(p);
    }
  }
  *err = "unexpected EOF in header";
  return false;
}

inline float read_value(const char* p, const Property& prop) {
  if (prop.is_float && prop.size == 4) {
    float v;
    std::memcpy(&v, p, 4);
    return v;
  }
  if (prop.is_float && prop.size == 8) {
    double v;
    std::memcpy(&v, p, 8);
    return static_cast<float>(v);
  }
  // Integer fallbacks (unused by standard 3DGS files).
  if (prop.size == 1) return static_cast<float>(*reinterpret_cast<const uint8_t*>(p));
  if (prop.size == 2) { int16_t v; std::memcpy(&v, p, 2); return static_cast<float>(v); }
  int32_t v;
  std::memcpy(&v, p, 4);
  return static_cast<float>(v);
}

}  // namespace

extern "C" {

// Returns the vertex count (or -1 on error). Cheap header-only scan so the
// caller can size its buffers before the full load.
long long ply_num_vertices(const char* path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return -1;
  Header h;
  std::string err;
  if (!parse_header(f, &h, &err)) return -1;
  return h.num_vertices;
}

// Loads a 3DGS PLY into caller-allocated SoA float32 buffers:
//   positions: N*3, sh: N*(3+n_rest), opacity: N, scales: N*3, quats: N*4.
// n_rest = 3*((max_sh_degree+1)^2 - 1) rest coefficients are kept (the
// reference keeps f_rest_0..23, i.e. degree 2 — gaussians.cpp:95).
// Activations applied at load: opacity=sigmoid, scale=exp.
// Returns 0 on success, negative error codes otherwise.
int ply_load(const char* path, int max_sh_degree, long long n_expected,
             float* positions, float* sh, float* opacity, float* scales,
             float* quats) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return -1;
  Header h;
  std::string err;
  if (!parse_header(f, &h, &err)) return -2;
  if (!h.little_endian_binary) return -3;  // reference rejects ascii too
  if (h.num_vertices != n_expected) return -4;

  const long long n = h.num_vertices;
  const int n_rest = 3 * ((max_sh_degree + 1) * (max_sh_degree + 1) - 1);
  const int sh_stride = 3 + n_rest;

  // Column kinds: 0 skip, 1 pos[idx], 2 f_dc[idx], 3 f_rest[idx],
  // 4 opacity, 5 scale[idx], 6 rot[idx].
  struct Slot { int kind = 0; int idx = 0; };
  std::vector<Slot> slots(h.props.size());
  std::vector<int> offsets(h.props.size());
  int stride = 0;
  for (size_t i = 0; i < h.props.size(); ++i) {
    offsets[i] = stride;
    stride += h.props[i].size;
    const std::string& nm = h.props[i].name;
    Slot s;
    if (nm == "x") { s = {1, 0}; }
    else if (nm == "y") { s = {1, 1}; }
    else if (nm == "z") { s = {1, 2}; }
    else if (nm == "opacity") { s = {4, 0}; }
    else if (nm.rfind("f_dc_", 0) == 0) { s = {2, std::atoi(nm.c_str() + 5)}; }
    else if (nm.rfind("f_rest_", 0) == 0) {
      int j = std::atoi(nm.c_str() + 7);
      if (j < n_rest) s = {3, j};  // reference: only j < 24 kept
    } else if (nm.rfind("scale_", 0) == 0) { s = {5, std::atoi(nm.c_str() + 6)}; }
    else if (nm.rfind("rot_", 0) == 0) { s = {6, std::atoi(nm.c_str() + 4)}; }
    slots[i] = s;
  }

  // Defaults matching the Python loader.
  for (long long v = 0; v < n; ++v) {
    quats[v * 4 + 0] = 1.0f;
    quats[v * 4 + 1] = quats[v * 4 + 2] = quats[v * 4 + 3] = 0.0f;
  }
  std::memset(sh, 0, sizeof(float) * static_cast<size_t>(n) * sh_stride);

  f.seekg(h.body_offset);
  // Stream the body in large chunks of whole records.
  const size_t records_per_chunk = (1 << 20) / (stride ? stride : 1) + 1;
  std::vector<char> buf(records_per_chunk * stride);
  long long v = 0;
  while (v < n) {
    const long long want =
        std::min<long long>(records_per_chunk, n - v);
    f.read(buf.data(), want * stride);
    if (f.gcount() != want * stride) return -5;  // truncated body
    for (long long r = 0; r < want; ++r, ++v) {
      const char* rec = buf.data() + r * stride;
      for (size_t i = 0; i < slots.size(); ++i) {
        const Slot& s = slots[i];
        if (s.kind == 0) continue;
        const float val = read_value(rec + offsets[i], h.props[i]);
        switch (s.kind) {
          case 1: positions[v * 3 + s.idx] = val; break;
          case 2: sh[v * sh_stride + s.idx] = val; break;
          case 3: sh[v * sh_stride + 3 + s.idx] = val; break;
          case 4: opacity[v] = 1.0f / (1.0f + std::exp(-val)); break;
          case 5: scales[v * 3 + s.idx] = std::exp(val); break;
          case 6: quats[v * 4 + s.idx] = val; break;
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
