// The SH view-dependent colour for Hopper (sm_90a), forward and backward:
// each splat's colour from its position, its SH coefficients and the
// camera position, and the gradients of its coefficients and position.
//
// Replaces no TPU kernel. The JAX package evaluates SH in plain jnp
// (gaussianrenderer_tpu/ops/sh.py `eval_sh_columns`, called from
// gaussianrenderer_tpu/ops/projection.py `preprocess_gaussians`), which XLA
// fuses. Eagerly in PyTorch the same chain is some 560 elementwise launches
// a training step at degree 3, forward and backward, and autograd's
// transpose of each of the 48 coefficient rows writes a zero-filled
// (48, N) tensor and adds it to the others: at N = 2M about 32 ms of
// device time a training step, where this pair moves ~1.3 GB.
//
//   d = pos - cam;  n = sqrt(dx*dx + dy*dy + dz*dz)  (IEEE sqrt)
//   inv_n = n > 1e-8 ? 1 / n : 0  (IEEE division);  u = d * inv_n
//   b_c(u), c < (D+1)^2: the real SH basis up to degree D <= 3
//   v_ch = ((b_0*sh[ch] + b_1*sh[3+ch]) + ...) + 0.5;  colour = clamp(v, 0, 1)
//
// The forward rounds every product and sum on its own in the order of
// ops/sh.py `eval_sh_columns` (with __fmul_rn / __fadd_rn, so nvcc fuses
// nothing into an FMA), so its colour equals the plain PyTorch chain's on
// the card bit for bit. The backward recomputes the colour for the clamp's
// mask (v in [0, 1], as torch.clamp's backward: NaN passes nothing), then
//
//   dsh[3c+ch] = m_ch*g_ch * b_c, one rounded product, as autograd's
//                (columns of degree above D: 0; -0 becomes +0, as
//                autograd's sum of the zero-filled rows leaves it)
//   dpos = inv_n * (g_u - u * (g_u . u)),  g_u = sum_c gb_c * db_c/du,
//   gb_c = sum_ch m_ch*g_ch * sh[3c+ch]
//
// dpos is a sum of many terms in another order than autograd's and agrees
// with it to rounding. No atomics: each splat's outputs belong to one
// thread, so two backward calls give the same bits.
//
// What bounds it on the card: bytes. Forward reads a splat's W floats of
// coefficients (W = 3*(SD+1)^2, 192 B at SD 3) and 3 of position and
// writes 3; backward reads the same and the 3 of the cotangent and writes
// W + 3. A warp stages its 32 rows of coefficients (6 KB at SD 3, one
// contiguous piece of the (N, W) tensor) through shared memory with
// float4 loads, all in flight at once, so every sector is read once and
// coalesced; the tile is kept transposed with a column stride of 33 words,
// so each thread then reads its own row without bank conflicts. The
// backward's dsh rows go back through the same tile and out as float4
// stores. One thread computes one splat in registers. Both kernels are
// templates on the stored degree SD (the tensor's width) and the evaluated
// degree D.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 33;  // words between two columns of a staged tile

// The float32 roundings of ops/sh.py's constants.
constexpr float C0 = 0x1.20dd76p-2f;
constexpr float C1 = 0x1.f45438p-2f;
constexpr float C2_0 = 0x1.17b142p+0f;
constexpr float C2_1 = -0x1.17b142p+0f;
constexpr float C2_2 = 0x1.42f602p-2f;
constexpr float C2_3 = -0x1.17b142p+0f;
constexpr float C2_4 = 0x1.17b142p-1f;
constexpr float C3_0 = -0x1.2e1a32p-1f;
constexpr float C3_1 = 0x1.71ff8ep+1f;
constexpr float C3_2 = -0x1.d403d0p-2f;
constexpr float C3_3 = 0x1.7e21f0p-2f;
constexpr float C3_4 = -0x1.d403d0p-2f;
constexpr float C3_5 = 0x1.71ff8ep+0f;
constexpr float C3_6 = -0x1.2e1a32p-1f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

template <int W>
__device__ __forceinline__ float& at(float* tile, int f) {
  return tile[(f % W) * kPad + f / W];
}

// tile <- the nf floats at g (rows of W), transposed: float f of the piece
// goes to column f % W, row f / W. float4 loads where g is 16-byte aligned
// (the caller's flag; a warp's piece starts at a multiple of 32 rows), all
// issued before any is stored.
template <int W>
__device__ __forceinline__ void stage_in(const float* __restrict__ g, int nf, bool vec,
                                         float* tile, int lane) {
  if (vec) {
    constexpr int kTrips = (8 * W + 31) / 32;  // float4s of a full piece, per lane
    const int nv = nf >> 2;
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4 v[kTrips];
#pragma unroll
    for (int k = 0; k < kTrips; ++k) {
      const int q = k * 32 + lane;
      if (q < nv) v[k] = __ldg(g4 + q);
    }
#pragma unroll
    for (int k = 0; k < kTrips; ++k) {
      const int q = k * 32 + lane;
      if (q < nv) {
        at<W>(tile, 4 * q) = v[k].x;
        at<W>(tile, 4 * q + 1) = v[k].y;
        at<W>(tile, 4 * q + 2) = v[k].z;
        at<W>(tile, 4 * q + 3) = v[k].w;
      }
    }
    for (int f = 4 * nv + lane; f < nf; f += 32) at<W>(tile, f) = __ldg(g + f);
  } else {
    for (int f = lane; f < nf; f += 32) at<W>(tile, f) = __ldg(g + f);
  }
}

// The transpose of stage_in: the nf floats of the tile out to g.
template <int W>
__device__ __forceinline__ void stage_out(float* __restrict__ g, int nf, bool vec,
                                          float* tile, int lane) {
  if (vec) {
    const int nv = nf >> 2;
    float4* g4 = reinterpret_cast<float4*>(g);
    for (int q = lane; q < nv; q += 32)
      g4[q] = make_float4(at<W>(tile, 4 * q), at<W>(tile, 4 * q + 1), at<W>(tile, 4 * q + 2),
                          at<W>(tile, 4 * q + 3));
    for (int f = 4 * nv + lane; f < nf; f += 32) g[f] = at<W>(tile, f);
  } else {
    for (int f = lane; f < nf; f += 32) g[f] = at<W>(tile, f);
  }
}

struct Dir {
  float x, y, z, inv_n;
};

// The unit view direction of splat i, as ops/sh.py `view_color` rounds it.
__device__ __forceinline__ Dir direction(const float* __restrict__ pos,
                                         const float* __restrict__ cam, long long i) {
  const float dx = sub(__ldg(pos + 3 * i), __ldg(cam));
  const float dy = sub(__ldg(pos + 3 * i + 1), __ldg(cam + 1));
  const float dz = sub(__ldg(pos + 3 * i + 2), __ldg(cam + 2));
  const float n = __fsqrt_rn(add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz)));
  const float inv_n = n > 1e-8f ? __fdiv_rn(1.0f, n) : 0.0f;
  return {mul(dx, inv_n), mul(dy, inv_n), mul(dz, inv_n), inv_n};
}

// b[0..(D+1)^2): the basis at u, each term rounded as eval_sh_columns rounds it.
template <int D>
__device__ __forceinline__ void basis(const Dir& u, float* b) {
  const float x = u.x, y = u.y, z = u.z;
  b[0] = C0;
  if constexpr (D > 0) {
    b[1] = mul(-C1, y);
    b[2] = mul(C1, z);
    b[3] = mul(-C1, x);
  }
  if constexpr (D > 1) {
    const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
    const float xy = mul(x, y), yz = mul(y, z), xz = mul(x, z);
    b[4] = mul(C2_0, xy);
    b[5] = mul(C2_1, yz);
    b[6] = mul(C2_2, sub(sub(mul(2.0f, zz), xx), yy));
    b[7] = mul(C2_3, xz);
    b[8] = mul(C2_4, sub(xx, yy));
    if constexpr (D > 2) {
      const float t4 = sub(sub(mul(4.0f, zz), xx), yy);
      b[9] = mul(mul(C3_0, y), sub(mul(3.0f, xx), yy));
      b[10] = mul(mul(C3_1, xy), z);
      b[11] = mul(mul(C3_2, y), t4);
      b[12] = mul(mul(C3_3, z), sub(sub(mul(2.0f, zz), mul(3.0f, xx)), mul(3.0f, yy)));
      b[13] = mul(mul(C3_4, x), t4);
      b[14] = mul(mul(C3_5, z), sub(xx, yy));
      b[15] = mul(mul(C3_6, x), sub(xx, mul(3.0f, yy)));
    }
  }
}

// Channel ch before the clamp: the sum over the basis in eval_sh_columns's
// order, plus 0.5. `tile` column k holds coefficient k of the warp's rows.
template <int K>
__device__ __forceinline__ float channel(const float* b, const float* tile, int lane, int ch) {
  float acc = mul(b[0], tile[ch * kPad + lane]);
#pragma unroll
  for (int c = 1; c < K; ++c) acc = add(acc, mul(b[c], tile[(3 * c + ch) * kPad + lane]));
  return add(acc, 0.5f);
}

// g_u = sum_c gb[c] * db_c/du for c in [1, (D+1)^2): the basis's own
// derivatives (not rounded as autograd rounds them).
template <int D>
__device__ __forceinline__ float3 basis_grad(const Dir& u, const float* gb) {
  const float x = u.x, y = u.y, z = u.z;
  float gx = -C1 * gb[3], gy = -C1 * gb[1], gz = C1 * gb[2];
  if constexpr (D > 1) {
    gx += C2_0 * y * gb[4] - 2.0f * C2_2 * x * gb[6] + C2_3 * z * gb[7] + 2.0f * C2_4 * x * gb[8];
    gy += C2_0 * x * gb[4] + C2_1 * z * gb[5] - 2.0f * C2_2 * y * gb[6] - 2.0f * C2_4 * y * gb[8];
    gz += C2_1 * y * gb[5] + 4.0f * C2_2 * z * gb[6] + C2_3 * x * gb[7];
    if constexpr (D > 2) {
      const float xx = x * x, yy = y * y, zz = z * z;
      const float xy = x * y, yz = y * z, xz = x * z;
      gx += 6.0f * C3_0 * xy * gb[9] + C3_1 * yz * gb[10] - 2.0f * C3_2 * xy * gb[11] -
            6.0f * C3_3 * xz * gb[12] + C3_4 * (4.0f * zz - 3.0f * xx - yy) * gb[13] +
            2.0f * C3_5 * xz * gb[14] + 3.0f * C3_6 * (xx - yy) * gb[15];
      gy += 3.0f * C3_0 * (xx - yy) * gb[9] + C3_1 * xz * gb[10] +
            C3_2 * (4.0f * zz - xx - 3.0f * yy) * gb[11] - 6.0f * C3_3 * yz * gb[12] -
            2.0f * C3_4 * xy * gb[13] - 2.0f * C3_5 * yz * gb[14] - 6.0f * C3_6 * xy * gb[15];
      gz += C3_1 * xy * gb[10] + 8.0f * C3_2 * yz * gb[11] +
            C3_3 * (6.0f * zz - 3.0f * xx - 3.0f * yy) * gb[12] + 8.0f * C3_4 * xz * gb[13] +
            C3_5 * (xx - yy) * gb[14];
    }
  }
  return make_float3(gx, gy, gz);
}

template <int SD, int D>
__global__ void __launch_bounds__(kThreads)
    sh_color_fwd_kernel(const float* __restrict__ pos, const float* __restrict__ sh,
                        const float* __restrict__ cam, long long n, bool vec,
                        float* __restrict__ out) {
  constexpr int W = 3 * (SD + 1) * (SD + 1);
  constexpr int K = (D + 1) * (D + 1);
  __shared__ float stage[kWarps][W * kPad];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row0 = (static_cast<long long>(blockIdx.x) * kWarps + warp) * 32;
  if (row0 >= n) return;  // the whole warp
  const int rows = n - row0 < 32 ? static_cast<int>(n - row0) : 32;
  float* tile = stage[warp];
  stage_in<W>(sh + row0 * W, rows * W, vec, tile, lane);
  __syncwarp();
  if (lane >= rows) return;
  const long long i = row0 + lane;
  float b[K];
  basis<D>(direction(pos, cam, i), b);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float v = channel<K>(b, tile, lane, ch);
    // torch.clamp: NaN stays NaN.
    out[3 * i + ch] = v != v ? v : fminf(fmaxf(v, 0.0f), 1.0f);
  }
}

template <int SD, int D>
__global__ void __launch_bounds__(kThreads)
    sh_color_bwd_kernel(const float* __restrict__ pos, const float* __restrict__ sh,
                        const float* __restrict__ cam, const float* __restrict__ grad,
                        long long n, bool vec_in, bool vec_out, float* __restrict__ dsh,
                        float* __restrict__ dpos) {
  constexpr int W = 3 * (SD + 1) * (SD + 1);
  constexpr int K = (D + 1) * (D + 1);
  __shared__ float stage[kWarps][W * kPad];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row0 = (static_cast<long long>(blockIdx.x) * kWarps + warp) * 32;
  if (row0 >= n) return;  // the whole warp
  const int rows = n - row0 < 32 ? static_cast<int>(n - row0) : 32;
  float* tile = stage[warp];
  stage_in<W>(sh + row0 * W, rows * W, vec_in, tile, lane);
  __syncwarp();

  const bool live = lane < rows;
  const long long i = row0 + lane;
  float b[K];
  float gm[3] = {0.0f, 0.0f, 0.0f};
  if (live) {
    const Dir u = direction(pos, cam, i);
    basis<D>(u, b);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float v = channel<K>(b, tile, lane, ch);
      gm[ch] = v >= 0.0f && v <= 1.0f ? __ldg(grad + 3 * i + ch) : 0.0f;
    }
    if constexpr (D > 0) {
      if (dpos != nullptr) {
        float gb[K];
#pragma unroll
        for (int c = 1; c < K; ++c)
          gb[c] = gm[0] * tile[3 * c * kPad + lane] + gm[1] * tile[(3 * c + 1) * kPad + lane] +
                  gm[2] * tile[(3 * c + 2) * kPad + lane];
        float3 g = basis_grad<D>(u, gb);
        // The part of g_u across the direction, over the distance.
        const float dot = g.x * u.x + g.y * u.y + g.z * u.z;
        dpos[3 * i] = u.inv_n * (g.x - u.x * dot);
        dpos[3 * i + 1] = u.inv_n * (g.y - u.y * dot);
        dpos[3 * i + 2] = u.inv_n * (g.z - u.z * dot);
      }
    }
  }
  if (dsh == nullptr) return;  // uniform over the grid
  __syncwarp();  // every lane has read its row of the tile
  if (live) {
#pragma unroll
    for (int c = 0; c < K; ++c)
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        tile[(3 * c + ch) * kPad + lane] = add(mul(gm[ch], b[c]), 0.0f);
#pragma unroll
    for (int k = 3 * K; k < W; ++k) tile[k * kPad + lane] = 0.0f;
  }
  __syncwarp();
  stage_out<W>(dsh + row0 * W, rows * W, vec_out, tile, lane);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// f(SD, D) as integral constants, for each stored degree 0..3 and each
// evaluated degree up to it; false for any other pair.
template <typename F>
bool dispatch(int sd, int d, F&& f) {
#define GR_CASE(S, E)                                                          \
  if (sd == S && d == E) {                                                     \
    f(std::integral_constant<int, S>{}, std::integral_constant<int, E>{});     \
    return true;                                                               \
  }
  GR_CASE(0, 0)
  GR_CASE(1, 0) GR_CASE(1, 1)
  GR_CASE(2, 0) GR_CASE(2, 1) GR_CASE(2, 2)
  GR_CASE(3, 0) GR_CASE(3, 1) GR_CASE(3, 2) GR_CASE(3, 3)
#undef GR_CASE
  return false;
}

bool grid(long long n, unsigned* blocks) {
  const long long b = (n + kThreads - 1) / kThreads;
  if (b > 0x7FFFFFFFLL) return false;
  *blocks = static_cast<unsigned>(b);
  return true;
}

}  // namespace

extern "C" {

// out (n, 3) = the clamped colour of n splats at pos (n, 3) with
// coefficients sh (n, 3*(sd+1)^2), evaluated to degree d <= sd, seen from
// cam (3,). All float32 on the card. Launches on `stream`; returns
// cudaGetLastError() (0 = ok).
int gr_sh_color_fwd(const float* pos, const float* sh, const float* cam, long long n, int sd,
                    int d, float* out, void* stream) {
  unsigned blocks = 0;
  if (n < 0 || !grid(n, &blocks)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(sh);
  const bool ok = dispatch(sd, d, [&](auto S, auto E) {
    sh_color_fwd_kernel<decltype(S)::value, decltype(E)::value>
        <<<blocks, kThreads, 0, s>>>(pos, sh, cam, n, vec, out);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The backward of gr_sh_color_fwd for the cotangent grad (n, 3): dsh
// (n, 3*(sd+1)^2) and dpos (n, 3), either NULL to skip it (dpos must be
// NULL at d = 0, where the colour does not depend on the position).
int gr_sh_color_bwd(const float* pos, const float* sh, const float* cam, const float* grad,
                    long long n, int sd, int d, float* dsh, float* dpos, void* stream) {
  unsigned blocks = 0;
  if (n < 0 || !grid(n, &blocks) || (d == 0 && dpos != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || (dsh == nullptr && dpos == nullptr)) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec_in = aligned16(sh), vec_out = aligned16(dsh);
  const bool ok = dispatch(sd, d, [&](auto S, auto E) {
    sh_color_bwd_kernel<decltype(S)::value, decltype(E)::value>
        <<<blocks, kThreads, 0, s>>>(pos, sh, cam, grad, n, vec_in, vec_out, dsh, dpos);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

const char* gr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
