// Training compositor for Hopper (sm_90a): the f32 forward and its
// hand-written backward.
//
// Replaces the TPU kernels gaussianrenderer_tpu/ops/pallas/tile_train.py
// `_fwd_kernel` (forward) and `_bwd_kernel` (backward), reached by
// `composite_tiles_train`. The features are (C, 16) f32 rows in sorted
// instance order (ops/compositing.py layout: cx, cy, A, B, C, op, r, g, b,
// xmin, ymin, xmax, ymax, depth, pad) with global pixel centers and AABBs.
//
// Forward, one block per tile, each thread owning PPT pixels: walk the
// K-aligned chunk windows of [start, start+count) (lanes outside are
// invalid). Per lane and pixel
//   md2 = clip(A*dx^2 + B*dx*dy + C*dy^2, 0, 80)
//   alpha = min(op*exp(-md2/2), 0.99), zeroed outside the AABB, below 1e-3
//   t_before = T_carry * prod_{j<i}(1 - alpha_j)   (ungated)
//   weight = alpha*t_before while t_before >= 1e-3
// and at the chunk end T_carry *= the product over the gated lanes. Before
// each chunk the walk stops once no pixel has T >= 1e-3 (__syncthreads_or).
// Each walked chunk's entry T_carry goes to the checkpoint buffer, rows
// chk_offset[tile] + chunk (an exclusive cumsum of exact chunk counts).
//
// Backward, one block per tile: walk the chunks in reverse from i_end - 1,
// with the cotangent premultiplied, A = dL/dT_carry * T_carry, seeded with
// gT * T_final. Each chunk is recomputed from its checkpoint with the
// forward's arithmetic (the same device function, round-to-nearest
// intrinsics, no contraction), so gates and t_before are the forward's bit
// for bit. Per lane
//   dalpha_i = (g.c_i)*t_before_i - (S_i + A_exit)/(1 - alpha_i)  (gated)
//   S_i = sum_{j>i, same chunk} (g.c_j)*w_j,  A_entry = A_exit + sum_j (g.c_j)*w_j
// chained through the 0.99 clamp, the mask and the md2 clip to
// d(cx, cy, A, B, C, op, r, g, b). Gates are a prefix along the lanes, so a
// pixel is done at its first ungated lane. A first pass over the chunk sums
// each pixel's (g.c)*w; the second gets S_i as that total minus the running
// prefix, both in double so the difference keeps the suffix's precision.
// Each thread sums its pixels' per-lane terms; a warp shuffle reduction and
// a shared [9][K] accumulator (atomicAdd) sum them over the tile. Only the
// lanes inside the tile's range are written: adjacent tiles' aligned
// windows overlap, and their blocks run at the same time, but each lane
// belongs to one tile, so d_feats needs no atomics and starts as zeros
// (rows 9-15 get no gradient).
//
// What bounds it on the card: operations. Every lane walked costs each of
// the tile's P pixels an AABB test, and each pixel inside the AABB about 40
// fp32 operations (forward) or three times that (backward: two recomputes
// and the chain), against 64 bytes read for the lane: hundreds of
// operations per byte, far above the H100's ~20 fp32 operations per byte of
// HBM bandwidth. What the design does about it: one block per tile stages a
// chunk's lanes in shared memory once; each thread keeps its pixels in
// registers, tests the AABB before any float work, and leaves a chunk's
// lane loop once its warp has no pixel left above the stop threshold; a
// whole warp skips a lane's reduction when none of its pixels contributed.
// Making it fast (fewer passes, warp-level lane culling) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float f32(double x) { return static_cast<float>(x); }

constexpr int kMaxThreads = 256;
constexpr int kFeatDim = 16;
constexpr int kGradCols = 9;
// Shared floats per chunk lane: 13 fields and the in-range flag.
constexpr int kLaneFields = 14;

struct LaneSmem {
  float *cx, *cy, *a, *b, *c, *op, *r, *g, *bl, *xmin, *ymin, *xmax, *ymax;
  int* ok;
};

__device__ __forceinline__ LaneSmem lane_smem(float* smem, int K) {
  LaneSmem s;
  s.cx = smem;
  s.cy = s.cx + K;
  s.a = s.cy + K;
  s.b = s.a + K;
  s.c = s.b + K;
  s.op = s.c + K;
  s.r = s.op + K;
  s.g = s.r + K;
  s.bl = s.g + K;
  s.xmin = s.bl + K;
  s.ymin = s.xmin + K;
  s.xmax = s.ymin + K;
  s.ymax = s.xmax + K;
  s.ok = reinterpret_cast<int*>(s.ymax + K);
  return s;
}

// Stage chunk `base`'s K lanes: fields of the lanes in [start, end), and
// each lane's in-range flag.
__device__ __forceinline__ void stage_chunk(const LaneSmem& s, const float* __restrict__ feats,
                                            int base, int start, int end, int K) {
  for (int l = threadIdx.x; l < K; l += blockDim.x) {
    const int slot = base + l;
    const int ok = slot >= start && slot < end;
    s.ok[l] = ok;
    if (!ok) continue;
    const float* f = feats + static_cast<long long>(slot) * kFeatDim;
    s.cx[l] = f[0];
    s.cy[l] = f[1];
    s.a[l] = f[2];
    s.b[l] = f[3];
    s.c[l] = f[4];
    s.op[l] = f[5];
    s.r[l] = f[6];
    s.g[l] = f[7];
    s.bl[l] = f[8];
    s.xmin[l] = f[9];
    s.ymin[l] = f[10];
    s.xmax[l] = f[11];
    s.ymax[l] = f[12];
  }
}

struct Terms {
  float dx, dy, md2_raw, e, alpha_raw, alpha;
};

// The lane's alpha at one pixel inside its AABB, with the plain version's
// arithmetic: md2 = (A*dx)*dx + (B*dx)*dy + (C*dy)*dy, each product and sum
// rounded on its own. alpha is 0 where it falls below 1e-3.
__device__ __forceinline__ Terms alpha_terms(float px, float py, float cx, float cy, float A,
                                             float B, float C, float op) {
  Terms t;
  t.dx = __fsub_rn(px, cx);
  t.dy = __fsub_rn(py, cy);
  const float m = __fadd_rn(__fmul_rn(__fmul_rn(A, t.dx), t.dx),
                            __fmul_rn(__fmul_rn(B, t.dx), t.dy));
  t.md2_raw = __fadd_rn(m, __fmul_rn(__fmul_rn(C, t.dy), t.dy));
  const float md2 = fminf(fmaxf(t.md2_raw, 0.0f), 80.0f);
  t.e = expf(__fmul_rn(-0.5f, md2));
  t.alpha_raw = __fmul_rn(op, t.e);
  const float amin = fminf(t.alpha_raw, f32(0.99));
  t.alpha = amin >= f32(1e-3) ? amin : 0.0f;
  return t;
}

__device__ __forceinline__ bool in_box(const LaneSmem& s, int l, float px, float py) {
  return px >= s.xmin[l] && px <= s.xmax[l] && py >= s.ymin[l] && py <= s.ymax[l];
}

// g.c, the cotangent's dot with the lane's colour, rounded the same way in
// both backward passes.
__device__ __forceinline__ float g_dot_c(float gr, float gg, float gb, float cr, float cg,
                                         float cb) {
  return __fadd_rn(__fadd_rn(__fmul_rn(gr, cr), __fmul_rn(gg, cg)), __fmul_rn(gb, cb));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

template <int PPT>
__global__ void __launch_bounds__(kMaxThreads)
train_fwd_kernel(const float* __restrict__ feats, const int* __restrict__ tile_start,
                 const int* __restrict__ tile_count, const int* __restrict__ chk_offset,
                 float* __restrict__ stats, float* __restrict__ chk, int tiles_x,
                 int num_tiles, int tile_w, int tile_h, int K) {
  extern __shared__ float smem[];
  const LaneSmem s = lane_smem(smem, K);
  const float kTEps = f32(1e-3);

  const int tile = blockIdx.x;
  const int P = tile_w * tile_h;
  const int start = tile_start[tile];
  const int end = start + tile_count[tile];
  const int aligned = (start / K) * K;
  const int num_chunks = (end - aligned + K - 1) / K;
  const long long chk_base = chk_offset[tile];
  const int x0 = (tile % tiles_x) * tile_w;
  const int y0 = (tile / tiles_x) * tile_h;

  float px[PPT], py[PPT], T[PPT], acc_r[PPT], acc_g[PPT], acc_b[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = threadIdx.x * PPT + i;
    px[i] = static_cast<float>(x0 + p % tile_w);
    py[i] = static_cast<float>(y0 + p / tile_w);
    T[i] = 1.0f;
    acc_r[i] = acc_g[i] = acc_b[i] = 0.0f;
  }

  int walked = 0;
  for (int ci = 0; ci < num_chunks; ++ci) {
    float* crow = chk + (chk_base + ci) * P + threadIdx.x * PPT;
#pragma unroll
    for (int i = 0; i < PPT; ++i) crow[i] = T[i];
    stage_chunk(s, feats, aligned + ci * K, start, end, K);
    __syncthreads();

    float u[PPT];
    bool live[PPT];
    bool any_live = false;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      u[i] = 1.0f;
      live[i] = T[i] >= kTEps;
      any_live |= live[i];
    }
    for (int l = 0; l < K; ++l) {
      if (!__any_sync(0xFFFFFFFFu, any_live)) break;  // the warp's pixels are done
      if (!s.ok[l]) continue;
      const float cx = s.cx[l], cy = s.cy[l], A = s.a[l], B = s.b[l], C = s.c[l];
      const float op = s.op[l], cr = s.r[l], cg = s.g[l], cb = s.bl[l];
      any_live = false;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        if (!live[i]) continue;
        any_live = true;
        if (!in_box(s, l, px[i], py[i])) continue;
        const Terms t = alpha_terms(px[i], py[i], cx, cy, A, B, C, op);
        if (t.alpha == 0.0f) continue;
        const float tb = __fmul_rn(T[i], u[i]);
        if (!(tb >= kTEps)) {  // gates are a prefix: this pixel is done
          live[i] = false;
          continue;
        }
        const float w = __fmul_rn(t.alpha, tb);
        acc_r[i] = __fadd_rn(acc_r[i], __fmul_rn(w, cr));
        acc_g[i] = __fadd_rn(acc_g[i], __fmul_rn(w, cg));
        acc_b[i] = __fadd_rn(acc_b[i], __fmul_rn(w, cb));
        u[i] = __fmul_rn(u[i], __fsub_rn(1.0f, t.alpha));
      }
    }
    int alive = 0;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      T[i] = __fmul_rn(T[i], u[i]);
      alive |= T[i] >= kTEps;
    }
    walked = ci + 1;
    // The barrier also keeps the next chunk's staging off lanes in use.
    if (!__syncthreads_or(alive)) break;
  }

  const long long TP = static_cast<long long>(num_tiles) * P;
  float* o = stats + static_cast<long long>(tile) * P + threadIdx.x * PPT;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    o[i] = acc_r[i];
    o[TP + i] = acc_g[i];
    o[2 * TP + i] = acc_b[i];
    o[3 * TP + i] = T[i];
    o[4 * TP + i] = static_cast<float>(walked);
    o[5 * TP + i] = 0.0f;
    o[6 * TP + i] = 0.0f;
    o[7 * TP + i] = 0.0f;
  }
}

template <int PPT>
__global__ void __launch_bounds__(kMaxThreads)
train_bwd_kernel(const float* __restrict__ feats, const int* __restrict__ tile_start,
                 const int* __restrict__ tile_count, const int* __restrict__ chk_offset,
                 const float* __restrict__ gout, const float* __restrict__ stats,
                 const float* __restrict__ chk, float* __restrict__ d_feats, int tiles_x,
                 int num_tiles, int tile_w, int tile_h, int K) {
  extern __shared__ float smem[];
  const LaneSmem s = lane_smem(smem, K);
  float* s_grad = smem + kLaneFields * K;  // [kGradCols][K]
  const float kTEps = f32(1e-3);
  const float kAlphaMax = f32(0.99);

  const int tile = blockIdx.x;
  const int P = tile_w * tile_h;
  const int start = tile_start[tile];
  const int end = start + tile_count[tile];
  const int aligned = (start / K) * K;
  const long long chk_base = chk_offset[tile];
  const int x0 = (tile % tiles_x) * tile_w;
  const int y0 = (tile / tiles_x) * tile_h;
  const long long TP = static_cast<long long>(num_tiles) * P;
  const long long pix0 = static_cast<long long>(tile) * P + threadIdx.x * PPT;
  const int i_end = static_cast<int>(stats[4 * TP + static_cast<long long>(tile) * P]);

  float px[PPT], py[PPT], gr[PPT], gg[PPT], gb[PPT], acc[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = threadIdx.x * PPT + i;
    px[i] = static_cast<float>(x0 + p % tile_w);
    py[i] = static_cast<float>(y0 + p / tile_w);
    gr[i] = gout[pix0 + i];
    gg[i] = gout[TP + pix0 + i];
    gb[i] = gout[2 * TP + pix0 + i];
    // A = dL/dT_final * T_final.
    acc[i] = __fmul_rn(gout[3 * TP + pix0 + i], stats[3 * TP + pix0 + i]);
  }

  for (int ci = i_end - 1; ci >= 0; --ci) {
    stage_chunk(s, feats, aligned + ci * K, start, end, K);
    for (int j = threadIdx.x; j < kGradCols * K; j += blockDim.x) s_grad[j] = 0.0f;
    __syncthreads();

    float tc[PPT];
    const float* crow = chk + (chk_base + ci) * P + threadIdx.x * PPT;
#pragma unroll
    for (int i = 0; i < PPT; ++i) tc[i] = crow[i];

    // Pass 1: each pixel's chunk total Y = sum_j (g.c_j)*w_j.
    double ysum[PPT];
    float u[PPT];
    bool live[PPT];
    bool any_live = false;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      ysum[i] = 0.0;
      u[i] = 1.0f;
      live[i] = tc[i] >= kTEps;
      any_live |= live[i];
    }
    for (int l = 0; l < K; ++l) {
      if (!__any_sync(0xFFFFFFFFu, any_live)) break;
      if (!s.ok[l]) continue;
      const float cx = s.cx[l], cy = s.cy[l], A = s.a[l], B = s.b[l], C = s.c[l];
      const float op = s.op[l], cr = s.r[l], cg = s.g[l], cb = s.bl[l];
      any_live = false;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        if (!live[i]) continue;
        any_live = true;
        if (!in_box(s, l, px[i], py[i])) continue;
        const Terms t = alpha_terms(px[i], py[i], cx, cy, A, B, C, op);
        if (t.alpha == 0.0f) continue;
        const float tb = __fmul_rn(tc[i], u[i]);
        if (!(tb >= kTEps)) {
          live[i] = false;
          continue;
        }
        const float w = __fmul_rn(t.alpha, tb);
        const float gc = g_dot_c(gr[i], gg[i], gb[i], cr, cg, cb);
        ysum[i] += static_cast<double>(__fmul_rn(gc, w));
        u[i] = __fmul_rn(u[i], __fsub_rn(1.0f, t.alpha));
      }
    }

    // Pass 2: per-lane gradients, S_i = Y − (prefix through i).
    double prefix[PPT];
    any_live = false;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      prefix[i] = 0.0;
      u[i] = 1.0f;
      live[i] = tc[i] >= kTEps;
      any_live |= live[i];
    }
    for (int l = 0; l < K; ++l) {
      if (!__any_sync(0xFFFFFFFFu, any_live)) break;
      if (!s.ok[l]) continue;
      const float cx = s.cx[l], cy = s.cy[l], A = s.a[l], B = s.b[l], C = s.c[l];
      const float op = s.op[l], cr = s.r[l], cg = s.g[l], cb = s.bl[l];
      float v[kGradCols];
#pragma unroll
      for (int c = 0; c < kGradCols; ++c) v[c] = 0.0f;
      bool hit = false;
      any_live = false;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        if (!live[i]) continue;
        any_live = true;
        if (!in_box(s, l, px[i], py[i])) continue;
        const Terms t = alpha_terms(px[i], py[i], cx, cy, A, B, C, op);
        if (t.alpha == 0.0f) continue;
        const float tb = __fmul_rn(tc[i], u[i]);
        if (!(tb >= kTEps)) {
          live[i] = false;
          continue;
        }
        hit = true;
        const float one_minus = __fsub_rn(1.0f, t.alpha);
        const float w = __fmul_rn(t.alpha, tb);
        const float gc = g_dot_c(gr[i], gg[i], gb[i], cr, cg, cb);
        const float y = __fmul_rn(gc, w);
        prefix[i] += static_cast<double>(y);
        const float S = static_cast<float>(ysum[i] - prefix[i]);
        v[6] += gr[i] * w;
        v[7] += gg[i] * w;
        v[8] += gb[i] * w;
        if (t.alpha_raw < kAlphaMax) {
          const float d_alpha = gc * tb - (S + acc[i]) / one_minus;
          v[5] += d_alpha * t.e;
          if (t.md2_raw > 0.0f && t.md2_raw < 80.0f) {
            const float d_md2 = -0.5f * d_alpha * t.alpha_raw;
            const float dx = t.dx, dy = t.dy;
            v[0] += d_md2 * (-(2.0f * A * dx + B * dy));
            v[1] += d_md2 * (-(2.0f * C * dy + B * dx));
            v[2] += d_md2 * dx * dx;
            v[3] += d_md2 * dx * dy;
            v[4] += d_md2 * dy * dy;
          }
        }
        u[i] = __fmul_rn(u[i], one_minus);
      }
      if (__any_sync(0xFFFFFFFFu, hit)) {
#pragma unroll
        for (int c = 0; c < kGradCols; ++c) v[c] = warp_sum(v[c]);
        if ((threadIdx.x & 31) == 0) {
#pragma unroll
          for (int c = 0; c < kGradCols; ++c) atomicAdd(&s_grad[c * K + l], v[c]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < PPT; ++i) acc[i] += static_cast<float>(ysum[i]);
    __syncthreads();

    const int base = aligned + ci * K;
    for (int l = threadIdx.x; l < K; l += blockDim.x) {
      if (!s.ok[l]) continue;
      float* d = d_feats + static_cast<long long>(base + l) * kFeatDim;
#pragma unroll
      for (int c = 0; c < kGradCols; ++c) d[c] = s_grad[c * K + l];
    }
    __syncthreads();  // before the next chunk restages the lanes
  }
}

int threads_for(int P) { return (P % 256 == 0) ? 256 : 128; }

bool bad_shape(int P, int K) {
  const int threads = threads_for(P);
  const int ppt = P / threads;
  return P % 128 != 0 || ppt < 1 || ppt > 16 || K < 1 || K > 512;
}

}  // namespace

extern "C" {

// Forward over all tiles. feats (C, 16) f32, tile_start/tile_count/
// chk_offset (T,) int32, stats (8, T*P) f32 out, chk (sum of chunk counts,
// P) f32 out. Launches on `stream`; returns cudaGetLastError() (0 = ok).
int gr_train_forward(const void* feats, const void* tile_start, const void* tile_count,
                     const void* chk_offset, void* stats, void* chk, int tiles_x,
                     int tiles_y, int tile_w, int tile_h, int K, void* stream) {
  const int P = tile_w * tile_h;
  if (bad_shape(P, K)) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = threads_for(P);
  const int num_tiles = tiles_x * tiles_y;
  const dim3 grid(num_tiles);
  const size_t smem = static_cast<size_t>(K) * kLaneFields * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(feats);
  const int* ts = static_cast<const int*>(tile_start);
  const int* tc = static_cast<const int*>(tile_count);
  const int* co = static_cast<const int*>(chk_offset);
  float* so = static_cast<float*>(stats);
  float* ck = static_cast<float*>(chk);
#define GR_CASE(N)                                                                     \
  case N:                                                                              \
    train_fwd_kernel<N><<<grid, threads, smem, st>>>(f, ts, tc, co, so, ck, tiles_x,   \
                                                     num_tiles, tile_w, tile_h, K);    \
    return static_cast<int>(cudaGetLastError());
  switch (P / threads) {
    GR_CASE(1) GR_CASE(2) GR_CASE(3) GR_CASE(4) GR_CASE(5) GR_CASE(6) GR_CASE(7)
    GR_CASE(8) GR_CASE(9) GR_CASE(10) GR_CASE(11) GR_CASE(12) GR_CASE(13) GR_CASE(14)
    GR_CASE(15) GR_CASE(16)
  }
#undef GR_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Backward over all tiles. gout (8, T*P) f32: rows 0-2 dL/drgb, row 3
// dL/dT_final; stats and chk from the forward; d_feats (C, 16) f32,
// zero-filled by the caller, receives columns 0-8 of the lanes in each
// tile's range. Launches on `stream`; returns cudaGetLastError().
int gr_train_backward(const void* feats, const void* tile_start, const void* tile_count,
                      const void* chk_offset, const void* gout, const void* stats,
                      const void* chk, void* d_feats, int tiles_x, int tiles_y, int tile_w,
                      int tile_h, int K, void* stream) {
  const int P = tile_w * tile_h;
  if (bad_shape(P, K)) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = threads_for(P);
  const int num_tiles = tiles_x * tiles_y;
  const dim3 grid(num_tiles);
  const size_t smem = static_cast<size_t>(K) * (kLaneFields + kGradCols) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(feats);
  const int* ts = static_cast<const int*>(tile_start);
  const int* tc = static_cast<const int*>(tile_count);
  const int* co = static_cast<const int*>(chk_offset);
  const float* go = static_cast<const float*>(gout);
  const float* so = static_cast<const float*>(stats);
  const float* ck = static_cast<const float*>(chk);
  float* df = static_cast<float*>(d_feats);
#define GR_CASE(N)                                                                      \
  case N:                                                                               \
    train_bwd_kernel<N><<<grid, threads, smem, st>>>(f, ts, tc, co, go, so, ck, df,     \
                                                     tiles_x, num_tiles, tile_w, tile_h, \
                                                     K);                                \
    return static_cast<int>(cudaGetLastError());
  switch (P / threads) {
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
