// Packed-record tile compositor for Hopper (sm_90a).
//
// Replaces the TPU kernel gaussianrenderer_tpu/ops/pallas/tile_render2.py
// `_tile_kernel` (reached by `composite_tiles_packed`): for each screen
// tile, walk its sorted instance range [start, start+count) in chunks of K
// lanes aligned to multiples of K, decode the five packed u32 rows of each
// instance, and composite front to back.
//
// Per pixel and instance (the TPU kernel's mxu_q=False form):
//   md2   = (A*dx + B*dy)*dx + C*dy*dy,  q = md2 + q0,  q0 = -2 ln(op)
//   alpha = min(fast_exp(-q/2), 0.99), zeroed outside the u8 AABB, below
//           1e-3, or outside the tile's lane range
//   w     = alpha*T if T >= 1e-3 (per-pixel stop), T *= (1 - alpha) always
// and the block leaves the tile at a chunk end once no pixel has T >= 1e-3,
// the TPU kernel's own exit rule, so the alpha row (1 - T_final) agrees too.
//
// What bounds it on the card: operations. Every instance lane walked costs
// each of the tile's P pixels (1024 for 32x32 tiles) an AABB test, and the
// pixels inside the lane's AABB about 43 fp32/int operations more, against
// 20 bytes read for the lane: hundreds of operations per byte, far above
// the H100's ~20 fp32 operations per byte of HBM bandwidth.
// What the design does about it: one block per tile keeps the lanes in
// shared memory and decodes each lane once per block (not once per pixel);
// each thread owns P/blockDim pixels in registers, tests the integer AABB
// before any float work so pixels outside a splat's box cost two compares,
// and skips lanes outside the tile's range. Making it fast (warp-level lane
// culling, fewer pixels per lane) is later work.
//
// With a sat_idx output (the TPU kernel's with_sat census for the
// saturation cull) the kernel also records, per 16x16 pixel block of the
// tile, the last real lane of the first walked chunk after which no
// in-image pixel of the block has T >= 1e-3 (-1: never). Each thread folds
// its pixels into a per-block bitmask, a warp reduces it with one
// __reduce_or_sync and one shared atomicOr, and thread 0 reads the mask
// after the chunk-end barrier that already exists: no barrier is added.
// The census is a template flag, so frames without it run the same code
// as before.
//
// Arithmetic that the plain PyTorch version repeats (the fast_exp
// polynomial, the quadratic) uses round-to-nearest intrinsics so nvcc does
// not contract it into FMAs: the kernel then differs from the plain version
// only in the order sums are taken.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Constants are written as double literals cast to float: the same f32
// values the Python side gets from its float64 constants.
__device__ __forceinline__ float f32(double x) { return static_cast<float>(x); }

constexpr int kMaxThreads = 256;
constexpr int kConicExpBias = 80;
// Bytes of dynamic shared memory per chunk lane: 10 floats, the AABB word
// and the in-range flag.
constexpr int kSmemPerLane = 12 * 4;
// Saturation census: 16x16 blocks, at most 32 per tile (one mask word).
constexpr int kSatBlock = 16;
constexpr int kMaxSatBlocks = 32;

__device__ __forceinline__ float dec_e6m10(uint32_t e) {
  return __uint_as_float((e + (kConicExpBias << 10)) << 13);
}

__device__ __forceinline__ float dec_s1e6m9(uint32_t e) {
  uint32_t bits = (((e & 0x7FFFu) + (kConicExpBias << 9)) << 14) | ((e >> 15) << 31);
  return __uint_as_float(bits);
}

// exp(x) for x <= 0: exponent bit-stuffing times a degree-4 polynomial,
// bit for bit the TPU kernel's _fast_exp.
__device__ __forceinline__ float fast_exp(float x) {
  float y = __fmul_rn(fmaxf(x, -88.0f), f32(1.4426950408889634));
  float yi = floorf(y);
  float t = __fsub_rn(y, yi);
  float p = __fadd_rn(f32(0.0520114241), __fmul_rn(t, f32(0.013534055)));
  p = __fadd_rn(f32(0.2414429825), __fmul_rn(t, p));
  p = __fadd_rn(f32(0.6930037261), __fmul_rn(t, p));
  p = __fadd_rn(f32(1.0000026036), __fmul_rn(t, p));
  int eb = (static_cast<int>(yi) + 127) << 23;
  eb = min(max(eb, 0), 254 << 23);
  return __fmul_rn(p, __int_as_float(eb));
}

template <int PPT, bool SAT>
__global__ void __launch_bounds__(kMaxThreads)
tile_kernel(const uint32_t* __restrict__ feats, long long C,
            const int* __restrict__ tile_start, const int* __restrict__ tile_count,
            const float* __restrict__ depth_row, float* __restrict__ out,
            int* __restrict__ chunks_walked, int* __restrict__ sat_idx, int tiles_x,
            int tile_w, int tile_h, int width, int height, int K, int out_alpha,
            int out_depth) {
  extern __shared__ float smem[];
  // Census state (SAT only): the open-block mask of the current and the
  // next chunk, and each block's recorded lane (thread 0 alone).
  __shared__ uint32_t s_open[2];
  __shared__ int s_sat[kMaxSatBlocks];
  float* s_cx = smem;
  float* s_cy = s_cx + K;
  float* s_a = s_cy + K;
  float* s_b = s_a + K;
  float* s_c = s_b + K;
  float* s_q0 = s_c + K;
  float* s_r = s_q0 + K;
  float* s_g = s_r + K;
  float* s_bl = s_g + K;
  float* s_d = s_bl + K;
  uint32_t* s_box = reinterpret_cast<uint32_t*>(s_d + K);
  int* s_ok = reinterpret_cast<int*>(s_box + K);

  const float kAlphaEps = f32(1e-3);
  const float kTEps = f32(1e-3);
  const float kAlphaMax = f32(0.99);

  const int tile = blockIdx.x;
  const int start = tile_start[tile];
  const int count = tile_count[tile];
  const int aligned = (start / K) * K;
  const int num_chunks = (start + count - aligned + K - 1) / K;
  const int x0 = (tile % tiles_x) * tile_w;
  const int y0 = (tile / tiles_x) * tile_h;

  int pxi[PPT], pyi[PPT];
  float T[PPT], acc_r[PPT], acc_g[PPT], acc_b[PPT], acc_d[PPT];
  uint32_t blk_bit[PPT];  // SAT: this pixel's block bit, 0 past the image
  const int sat_bw = tile_w / kSatBlock;
  const int n_sat = sat_bw * (tile_h / kSatBlock);
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = threadIdx.x + i * blockDim.x;
    pxi[i] = p % tile_w;
    pyi[i] = p / tile_w;
    T[i] = 1.0f;
    acc_r[i] = acc_g[i] = acc_b[i] = acc_d[i] = 0.0f;
    if constexpr (SAT) {
      const bool in_img = x0 + pxi[i] < width && y0 + pyi[i] < height;
      blk_bit[i] = in_img ? 1u << ((pyi[i] / kSatBlock) * sat_bw + pxi[i] / kSatBlock) : 0u;
    }
  }
  if constexpr (SAT) {
    if (threadIdx.x == 0) {
      s_open[0] = s_open[1] = 0u;
      for (int b = 0; b < n_sat; ++b) s_sat[b] = -1;
    }
  }

  int walked = 0;
  for (int ci = 0; ci < num_chunks; ++ci) {
    // Stage and decode this chunk's lanes once for the whole block.
    const int base = aligned + ci * K;
    for (int l = threadIdx.x; l < K; l += blockDim.x) {
      const int slot = base + l;
      const int ok = slot >= start && slot < start + count;
      s_ok[l] = ok;
      if (!ok) continue;
      const uint32_t r0 = feats[slot];
      const uint32_t r1 = feats[C + slot];
      const uint32_t r2 = feats[2 * C + slot];
      const uint32_t r3 = feats[3 * C + slot];
      const bool coarse = (r3 >> 30) & 1u;
      const float c_scale = coarse ? 1.0f : f32(1.0 / 8.0);
      const float c_bias = coarse ? 32768.0f : 4096.0f;
      s_cx[l] = __fsub_rn(__fmul_rn(static_cast<float>(static_cast<int>(r0 >> 16)), c_scale), c_bias);
      s_cy[l] = __fsub_rn(__fmul_rn(static_cast<float>(static_cast<int>(r0 & 0xFFFFu)), c_scale), c_bias);
      const float u = dec_e6m10(r1 >> 16);
      const float w = dec_e6m10(r1 & 0xFFFFu);
      const float v = dec_s1e6m9(r2 >> 16);
      s_a[l] = __fmul_rn(u, u);
      s_b[l] = __fmul_rn(__fmul_rn(2.0f, u), v);
      s_c[l] = __fadd_rn(__fmul_rn(v, v), __fmul_rn(w, w));
      const float op = fmaxf(__fmul_rn(static_cast<float>(static_cast<int>(r2 & 0xFFFFu)),
                                       f32(1.0 / 65535.0)), f32(1e-6));
      s_q0[l] = __fmul_rn(-2.0f, logf(op));
      const float inv1023 = f32(1.0 / 1023.0);
      s_r[l] = __fmul_rn(static_cast<float>(static_cast<int>(r3 & 0x3FFu)), inv1023);
      s_g[l] = __fmul_rn(static_cast<float>(static_cast<int>((r3 >> 10) & 0x3FFu)), inv1023);
      s_bl[l] = __fmul_rn(static_cast<float>(static_cast<int>((r3 >> 20) & 0x3FFu)), inv1023);
      s_d[l] = out_depth ? depth_row[slot] : 0.0f;
      s_box[l] = feats[4 * C + slot];
    }
    __syncthreads();

    for (int l = 0; l < K; ++l) {
      if (!s_ok[l]) continue;  // alpha 0: neither weight nor T changes
      const uint32_t box = s_box[l];
      const int xmin = box & 0xFF, ymin = (box >> 8) & 0xFF;
      const int xmax = (box >> 16) & 0xFF, ymax = box >> 24;
      const uint32_t bw = static_cast<uint32_t>(xmax - xmin);
      const uint32_t bh = static_cast<uint32_t>(ymax - ymin);
      const float cx = s_cx[l], cy = s_cy[l], A = s_a[l], B = s_b[l], Cc = s_c[l];
      const float q0 = s_q0[l];
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        if (static_cast<uint32_t>(pxi[i] - xmin) > bw ||
            static_cast<uint32_t>(pyi[i] - ymin) > bh)
          continue;
        const float dx = __fsub_rn(static_cast<float>(pxi[i]), cx);
        const float dy = __fsub_rn(static_cast<float>(pyi[i]), cy);
        const float md2 = __fadd_rn(
            __fmul_rn(__fadd_rn(__fmul_rn(A, dx), __fmul_rn(B, dy)), dx),
            __fmul_rn(__fmul_rn(Cc, dy), dy));
        const float q = __fadd_rn(md2, q0);
        const float alpha = fminf(fast_exp(__fmul_rn(-0.5f, q)), kAlphaMax);
        if (!(alpha >= kAlphaEps)) continue;
        const float tb = T[i];
        if (tb >= kTEps) {
          const float wgt = __fmul_rn(tb, alpha);
          acc_r[i] = __fadd_rn(acc_r[i], __fmul_rn(wgt, s_r[l]));
          acc_g[i] = __fadd_rn(acc_g[i], __fmul_rn(wgt, s_g[l]));
          acc_b[i] = __fadd_rn(acc_b[i], __fmul_rn(wgt, s_bl[l]));
          acc_d[i] = __fadd_rn(acc_d[i], __fmul_rn(wgt, s_d[l]));
        }
        T[i] = __fmul_rn(tb, __fsub_rn(1.0f, alpha));
      }
    }
    walked = ci + 1;
    // Chunk-end exit once no pixel of the tile can still take weight; the
    // barrier also keeps the next chunk's staging off lanes still in use.
    int alive = 0;
#pragma unroll
    for (int i = 0; i < PPT; ++i) alive |= T[i] >= kTEps;
    if constexpr (SAT) {
      uint32_t open = 0u;
#pragma unroll
      for (int i = 0; i < PPT; ++i)
        if (T[i] >= kTEps) open |= blk_bit[i];
      open = __reduce_or_sync(0xFFFFFFFFu, open);
      if ((threadIdx.x & 31) == 0 && open != 0u) atomicOr(&s_open[ci & 1], open);
    }
    const int any_alive = __syncthreads_or(alive);
    if constexpr (SAT) {
      // Every warp's mask for this chunk is in; the next chunk's word is
      // written only after the next staging barrier, which thread 0 must
      // reach after clearing it.
      if (threadIdx.x == 0) {
        const uint32_t open = s_open[ci & 1];
        s_open[(ci + 1) & 1] = 0u;
        const int lane_end = min(base + K, start + count) - 1;
        for (int b = 0; b < n_sat; ++b)
          if (s_sat[b] < 0 && !((open >> b) & 1u)) s_sat[b] = lane_end;
      }
    }
    if (!any_alive) break;
  }
  if (chunks_walked != nullptr && threadIdx.x == 0) chunks_walked[tile] = walked;
  if constexpr (SAT) {
    if (threadIdx.x == 0)
      for (int b = 0; b < n_sat; ++b) sat_idx[static_cast<long long>(tile) * n_sat + b] = s_sat[b];
  }

  const long long plane = static_cast<long long>(height) * width;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int gx = x0 + pxi[i], gy = y0 + pyi[i];
    if (gx >= width || gy >= height) continue;
    float* o = out + static_cast<long long>(gy) * width + gx;
    o[0] = acc_r[i];
    o[plane] = acc_g[i];
    o[2 * plane] = acc_b[i];
    int row = 3;
    if (out_alpha) o[(row++) * plane] = 1.0f - T[i];
    if (out_depth) o[row * plane] = acc_d[i];
  }
}

template <int PPT>
cudaError_t launch(dim3 grid, int threads, size_t smem, cudaStream_t stream,
                   const uint32_t* feats, long long C, const int* ts, const int* tc,
                   const float* depth_row, float* out, int* chunks_walked, int* sat_idx,
                   int tiles_x, int tile_w, int tile_h, int width, int height, int K,
                   int out_alpha, int out_depth) {
  if (sat_idx != nullptr)
    tile_kernel<PPT, true><<<grid, threads, smem, stream>>>(
        feats, C, ts, tc, depth_row, out, chunks_walked, sat_idx, tiles_x, tile_w, tile_h,
        width, height, K, out_alpha, out_depth);
  else
    tile_kernel<PPT, false><<<grid, threads, smem, stream>>>(
        feats, C, ts, tc, depth_row, out, chunks_walked, nullptr, tiles_x, tile_w, tile_h,
        width, height, K, out_alpha, out_depth);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Composite all tiles. feats is the (5, C) u32 record matrix (row-major),
// tile_start/tile_count (T,) int32, depth_row (C,) f32 or null, out
// (3 + out_alpha + out_depth, height, width) f32, chunks_walked (T,) int32
// or null, sat_idx (T * blocks per tile,) int32 or null (no census).
// Launches on `stream` and returns cudaGetLastError() (0 = ok).
int gr_tile_render2(const void* feats, long long C, const void* tile_start,
                    const void* tile_count, const void* depth_row, void* out,
                    void* chunks_walked, void* sat_idx, int tiles_x, int tiles_y,
                    int tile_w, int tile_h, int width, int height, int K, int out_alpha,
                    int out_depth, void* stream) {
  const int P = tile_w * tile_h;
  const int threads = (P % 256 == 0) ? 256 : 128;
  const int ppt = P / threads;
  if (P % threads != 0 || ppt < 1 || ppt > 16 || K < 1 || K > 1024 ||
      (out_depth && depth_row == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (sat_idx != nullptr &&
      (tile_w % kSatBlock != 0 || tile_h % kSatBlock != 0 ||
       (tile_w / kSatBlock) * (tile_h / kSatBlock) > kMaxSatBlocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(tiles_x * tiles_y);
  const size_t smem = static_cast<size_t>(K) * kSmemPerLane;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* f = static_cast<const uint32_t*>(feats);
  const int* ts = static_cast<const int*>(tile_start);
  const int* tc = static_cast<const int*>(tile_count);
  const float* d = static_cast<const float*>(depth_row);
  float* o = static_cast<float*>(out);
  int* cw = static_cast<int*>(chunks_walked);
  int* si = static_cast<int*>(sat_idx);
#define GR_CASE(N)                                                                  \
  case N:                                                                           \
    return static_cast<int>(launch<N>(grid, threads, smem, s, f, C, ts, tc, d, o, cw,  \
                                      si, tiles_x, tile_w, tile_h, width, height, K, \
                                      out_alpha, out_depth));
  switch (ppt) {
    GR_CASE(1) GR_CASE(2) GR_CASE(3) GR_CASE(4) GR_CASE(5) GR_CASE(6) GR_CASE(7)
    GR_CASE(8) GR_CASE(9) GR_CASE(10) GR_CASE(11) GR_CASE(12) GR_CASE(13) GR_CASE(14)
    GR_CASE(15) GR_CASE(16)
  }
#undef GR_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* gr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
