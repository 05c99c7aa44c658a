// Training compositor for Hopper (sm_90a): the f32 forward and its
// hand-written backward, as passes over (tile, chunk) rows.
//
// Replaces the TPU kernels gaussianrenderer_tpu/ops/pallas/tile_train.py
// `_fwd_kernel` (forward) and `_bwd_kernel` (backward), reached by
// `composite_tiles_train`. The features are (C, 16) f32 rows in sorted
// instance order (ops/compositing.py layout: cx, cy, A, B, C, op, r, g, b,
// xmin, ymin, xmax, ymax, depth, pad) with global pixel centers and AABBs.
// Each tile walks the K-aligned chunk windows of its lane range
// [start, start+count) (lanes outside are invalid). A row is one (tile,
// chunk window): rows are numbered chk_offset[tile] + chunk (an exclusive
// cumsum of the tiles' window counts), and row r is also checkpoint row r.
//
// Per lane and pixel
//   md2 = clip(A*dx^2 + B*dx*dy + C*dy^2, 0, 80)
//   alpha = min(op*exp(-md2/2), 0.99), zeroed outside the AABB, below 1e-3
//   t_before = T_carry * u,  u = prod_{j<i}(1 - alpha_j)   (ungated)
//   weight = alpha*t_before while t_before >= 1e-3
// and T_carry after the chunk is T_carry * u at the last gated lane. A tile
// stops after the first chunk that leaves none of its pixels at T >= 1e-3.
//
// Why the walk splits at chunk boundaries. u depends on the chunk's own
// lanes only and never rises, so gates are a prefix. If fl(T_carry * U) >=
// 1e-3, U the chunk's whole product, every gate passes and T_next =
// fl(T_carry * U); otherwise the pixel leaves the chunk below 1e-3 and stays
// there. Each direction first maps every row to its tile (a binary search
// over chk_offset); then the passes (grid: one block per row, or per tile):
//   forward  products  (rows)  U per pixel, written into the checkpoint row.
//                              A pixel leaves the lane loop once its product
//                              is below 1e-3: with T_carry <= 1 it ends this
//                              chunk below 1e-3 whatever T_carry is.
//            scan      (tiles) per pixel T <- fl(T*U) row after row while it
//                              stays >= 1e-3: the checkpoints up to the
//                              pixel's last row (the one it ends below 1e-3,
//                              or the tile's last), that row (stats row 5)
//                              and i_end = max last + 1 (row 4).
//            composite (rows)  each row below i_end from its checkpoint with
//                              the gated arithmetic: per-pixel rgb partials,
//                              and at a pixel's last row its exact exit T
//                              (row 3).
//            reduce    (tiles) rgb = the partials added in chunk order from 0
//                              (the plain version's order), the exit T into
//                              the checkpoints after each pixel's last row,
//                              rows 5-7 zeroed.
//   backward totals    (rows)  Y_c = sum_j (g.c_j)*w_j per pixel, in double.
//            suffix    (tiles) the premultiplied cotangent at each chunk's
//                              exit, A_exit(c) = gT*T_final + sum_{c'>c} Y_c',
//                              added in reverse chunk order as floats.
//            gradients (rows)  per lane, with S_i = Y_c - prefix (double),
//                              dalpha_i = (g.c_i)*t_before_i
//                                         - (S_i + A_exit)/(1 - alpha_i),
//                              chained through the 0.99 clamp, the mask and
//                              the md2 clip to d(cx, cy, A, B, C, op, r, g, b)
//                              and summed over the tile's pixels (a warp
//                              shuffle; each warp adds its sums into its own
//                              [9][K] slice of shared memory, and the slices
//                              are added over warps 0..7 in order, so the
//                              sum has one order whatever the warps' timing).
//                              Only lanes inside the tile's range are
//                              written: each belongs to one tile and one
//                              chunk, so d_feats needs no atomics and starts
//                              as zeros (rows 9-15 get no gradient).
// Every pass rounds as the old one-block-per-tile walk did (the same device
// functions, round-to-nearest intrinsics, no contraction), so a pixel's U,
// its gates and its exit T agree bit for bit between the passes. A block
// walks its pixels in groups of kGroup, and only the tile passes carry
// per-pixel state from row to row, through device memory: a tile may hold
// any multiple of 128 pixels.
//
// What bounds it on the card: operations. A live pixel-lane pair costs 4
// (outside the AABB), 27 (alpha below 1e-3), 38 (weighted, forward) or 73
// (weighted, backward) fp32 operations (chip_smoke.OPS_TRAIN_*) against 64
// bytes read per lane: hundreds of operations per byte, far above the
// H100's ~20 fp32 operations per byte of HBM bandwidth. What the design does
// about it: the old launch gave each tile one block, which walked the tile's
// chunks in order, so the densest tile (127 chunks walked at train-500k)
// ran alone on one SM while the rest of the card idled. One block per row
// puts every chunk of every tile in flight at once (~8,000 blocks at
// train-500k). The price: the products pass also runs the rows past a
// tile's exit, and each direction walks a row twice. A block stages its
// chunk's lanes in shared memory once (four float4s a lane, an empty AABB
// for lanes outside the range), each thread holds four pixels in
// registers, tests the AABB before any float work and leaves the lane loop
// once its warp has no live pixel; a warp skips a lane's reduction when
// none of its pixels contributed.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

extern "C" {

// The arguments every pass takes (unused pointers may be null): the
// ctypes structure in ops/cuda/tile_train.py mirrors it field for field.
struct GrTrainArgs {
  const float* feats;     // (C, 16) sorted features
  const int* tile_start;  // (T,)
  const int* tile_count;  // (T,)
  const int* chk_offset;  // (T,) first row of each tile
  int* row_tile;          // (n_rows,) the tile of each row
  float* chk;             // (n_rows, P) checkpoints
  float* stats;           // (8, T*P)
  float* part;            // (n_rows, 3, P) rgb partials (forward scratch)
  const float* gout;      // (8, T*P) cotangent rows (backward)
  double* ysum;           // (n_rows, P) chunk totals (backward scratch)
  float* a_exit;          // (n_rows, P) cotangent at each chunk's exit
  float* d_feats;         // (C, 16) gradient, zero-filled
  int n_rows;
  int tiles_x;
  int num_tiles;
  int tile_w;
  int tile_h;
  int K;
};

}  // extern "C"

namespace {

constexpr int kThreads = 256;       // threads of a row block
constexpr int kWarps = kThreads / 32;
constexpr int kPPT = 4;             // pixels a thread walks at once
constexpr int kGroup = kThreads * kPPT;
constexpr int kTileThreads = 1024;  // most threads of a tile block
constexpr int kDepth = 8;           // rows a tile pass loads ahead
constexpr int kFeatDim = 16;
constexpr int kGradCols = 9;
constexpr int kMaxChunk = 512;
constexpr unsigned kFull = 0xFFFFFFFFu;

enum Pass {
  kRowTiles = 0,
  kFwdProducts = 1,
  kFwdScan = 2,
  kFwdComposite = 3,
  kFwdReduce = 4,
  kBwdTotals = 5,
  kBwdSuffix = 6,
  kBwdGrads = 7,
};

__device__ __forceinline__ float f32(double x) { return static_cast<float>(x); }

__device__ __forceinline__ int num_chunks(int start, int count, int K) {
  const int aligned = (start / K) * K;
  return (start + count - aligned + K - 1) / K;
}

// A tile's first row and its rows (clipped to the buffer).
struct TileRows {
  long long base;
  int n;
};

__device__ __forceinline__ TileRows tile_rows(const GrTrainArgs& a, int tile) {
  TileRows t;
  t.base = a.chk_offset[tile];
  t.n = num_chunks(a.tile_start[tile], a.tile_count[tile], a.K);
  const long long room = a.n_rows - t.base;
  if (t.n > room) t.n = room > 0 ? static_cast<int>(room) : 0;
  if (t.base < 0) t.n = 0;
  return t;
}

// One chunk lane in shared memory: box = (xmin, ymin, xmax, ymax), geo =
// (cx, cy, A, B), mat = (C, op, r, g), col.x = b.
struct Lane {
  float4 box, geo, mat, col;
};

// What a row block knows of its row.
struct Row {
  long long row;
  int tile, ci, start, end, P;
  float x0, y0;
};

// The block's row; false for a row no tile owns (the block exits).
__device__ __forceinline__ bool row_of(const GrTrainArgs& a, Row& r) {
  r.row = blockIdx.x;
  r.tile = a.row_tile[r.row];
  if (r.tile < 0) return false;
  r.ci = static_cast<int>(r.row - a.chk_offset[r.tile]);
  r.start = a.tile_start[r.tile];
  r.end = r.start + a.tile_count[r.tile];
  r.P = a.tile_w * a.tile_h;
  r.x0 = static_cast<float>((r.tile % a.tiles_x) * a.tile_w);
  r.y0 = static_cast<float>((r.tile / a.tiles_x) * a.tile_h);
  return true;
}

// Stage the row's K lanes; lanes outside [start, end) get an empty AABB,
// so no pixel is ever inside them.
__device__ __forceinline__ void stage_chunk(Lane* s, const float* __restrict__ feats,
                                            const Row& r, int K) {
  const int base = (r.start / K) * K + r.ci * K;
  for (int l = threadIdx.x; l < K; l += blockDim.x) {
    const int slot = base + l;
    Lane v;
    if (slot >= r.start && slot < r.end) {
      const float4* f = reinterpret_cast<const float4*>(feats + static_cast<long long>(slot) *
                                                                    kFeatDim);
      const float4 f0 = f[0], f1 = f[1], f2 = f[2], f3 = f[3];
      v.box = make_float4(f2.y, f2.z, f2.w, f3.x);
      v.geo = f0;
      v.mat = f1;
      v.col = make_float4(f2.x, 0.0f, 0.0f, 0.0f);
    } else {
      v.box = make_float4(INFINITY, INFINITY, -INFINITY, -INFINITY);
      v.geo = v.mat = v.col = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    s[l] = v;
  }
}

// Global (x, y) of the thread's kPPT pixels from p0.
__device__ __forceinline__ void pixels_xy(const Row& r, int tile_w, int p0, float* px,
                                          float* py) {
#pragma unroll
  for (int i = 0; i < kPPT; ++i) {
    const int p = p0 + i;
    px[i] = r.x0 + static_cast<float>(p % tile_w);
    py[i] = r.y0 + static_cast<float>(p / tile_w);
  }
}

__device__ __forceinline__ bool in_box(const float4& b, float px, float py) {
  return px >= b.x && px <= b.z && py >= b.y && py <= b.w;
}

struct Terms {
  float dx, dy, md2_raw, e, alpha_raw, alpha;
};

// The lane's alpha at one pixel inside its AABB, with the plain version's
// arithmetic: md2 = (A*dx)*dx + (B*dx)*dy + (C*dy)*dy, each product and sum
// rounded on its own. alpha is 0 where it falls below 1e-3.
__device__ __forceinline__ Terms alpha_terms(float px, float py, const float4& geo,
                                             const float4& mat) {
  Terms t;
  t.dx = __fsub_rn(px, geo.x);
  t.dy = __fsub_rn(py, geo.y);
  const float m = __fadd_rn(__fmul_rn(__fmul_rn(geo.z, t.dx), t.dx),
                            __fmul_rn(__fmul_rn(geo.w, t.dx), t.dy));
  t.md2_raw = __fadd_rn(m, __fmul_rn(__fmul_rn(mat.x, t.dy), t.dy));
  const float md2 = fminf(fmaxf(t.md2_raw, 0.0f), 80.0f);
  t.e = expf(__fmul_rn(-0.5f, md2));
  t.alpha_raw = __fmul_rn(mat.y, t.e);
  const float amin = fminf(t.alpha_raw, f32(0.99));
  t.alpha = amin >= f32(1e-3) ? amin : 0.0f;
  return t;
}

// g.c, the cotangent's dot with the lane's colour, rounded the same way in
// both backward passes.
__device__ __forceinline__ float g_dot_c(float gr, float gg, float gb, float cr, float cg,
                                         float cb) {
  return __fadd_rn(__fadd_rn(__fmul_rn(gr, cr), __fmul_rn(gg, cg)), __fmul_rn(gb, cb));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ bool any_of(const bool* live) {
  bool any = false;
#pragma unroll
  for (int i = 0; i < kPPT; ++i) any |= live[i];
  return any;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void unpack4(const float4& v, float* out) {
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// Each row's tile: the last tile whose first row is at or before it, if
// the row lies inside that tile's windows, else -1.
__global__ void row_tiles_kernel(GrTrainArgs a) {
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= a.n_rows) return;
  int lo = 0, hi = a.num_tiles - 1, tile = -1;
  while (lo <= hi) {
    const int mid = (lo + hi) / 2;
    if (a.chk_offset[mid] <= row) {
      tile = mid;
      lo = mid + 1;
    } else {
      hi = mid - 1;
    }
  }
  if (tile >= 0) {
    const TileRows t = tile_rows(a, tile);
    if (row >= t.base + t.n) tile = -1;
  }
  a.row_tile[row] = tile;
}

// Forward pass 1: the chunk's ungated product U per pixel, into chk[row].
__global__ void __launch_bounds__(kThreads) fwd_products_kernel(GrTrainArgs a) {
  extern __shared__ float4 smem4[];
  Lane* lanes = reinterpret_cast<Lane*>(smem4);
  Row r;
  if (!row_of(a, r)) return;
  stage_chunk(lanes, a.feats, r, a.K);
  __syncthreads();
  const float kTEps = f32(1e-3);
  float* out = a.chk + r.row * r.P;
  for (int g = 0; g < r.P; g += kGroup) {
    const int p0 = g + threadIdx.x * kPPT;
    const bool mine = p0 < r.P;  // P is a multiple of 4: all four or none
    float px[kPPT], py[kPPT], u[kPPT];
    bool live[kPPT];
    pixels_xy(r, a.tile_w, p0, px, py);
#pragma unroll
    for (int i = 0; i < kPPT; ++i) {
      u[i] = 1.0f;
      live[i] = mine;
    }
    bool any = mine;
    for (int l = 0; l < a.K; ++l) {
      if (!__any_sync(kFull, any)) break;  // the warp's pixels are done
      const float4 box = lanes[l].box;
#pragma unroll
      for (int i = 0; i < kPPT; ++i) {
        if (!live[i] || !in_box(box, px[i], py[i])) continue;
        const float alpha = alpha_terms(px[i], py[i], lanes[l].geo, lanes[l].mat).alpha;
        if (alpha == 0.0f) continue;
        u[i] = __fmul_rn(u[i], __fsub_rn(1.0f, alpha));
        live[i] = u[i] >= kTEps;
      }
      any = any_of(live);
    }
    if (mine) *reinterpret_cast<float4*>(out + p0) = make_float4(u[0], u[1], u[2], u[3]);
  }
}

// Forward pass 2, one block per tile: each pixel's transmittance from row
// to row (checkpoints), its last row, and the tile's i_end.
__global__ void __launch_bounds__(kTileThreads) fwd_scan_kernel(GrTrainArgs a) {
  const int tile = blockIdx.x;
  const int P = a.tile_w * a.tile_h;
  const long long TP = static_cast<long long>(a.num_tiles) * P;
  const TileRows t = tile_rows(a, tile);
  float* chk = a.chk + t.base * P;
  float* st = a.stats + static_cast<long long>(tile) * P;
  const float kTEps = f32(1e-3);
  int last_max = -1;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    float T = 1.0f;
    int last = t.n - 1;
    bool alive = true;
    for (int c0 = 0; alive && c0 < t.n; c0 += kDepth) {
      float U[kDepth];
#pragma unroll
      for (int j = 0; j < kDepth; ++j)
        U[j] = c0 + j < t.n ? chk[static_cast<long long>(c0 + j) * P + p] : 0.0f;
#pragma unroll
      for (int j = 0; j < kDepth; ++j) {
        if (!alive || c0 + j >= t.n) break;
        chk[static_cast<long long>(c0 + j) * P + p] = T;
        const float v = __fmul_rn(T, U[j]);
        if (v >= kTEps) {
          T = v;
        } else {
          last = c0 + j;
          alive = false;
        }
      }
    }
    st[5 * TP + p] = static_cast<float>(last);
    last_max = max(last_max, last);
  }
  __shared__ int s_last;
  if (threadIdx.x == 0) s_last = -1;
  __syncthreads();
  atomicMax(&s_last, last_max);
  __syncthreads();
  const float i_end = static_cast<float>(s_last + 1);
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    st[4 * TP + p] = i_end;
    if (t.n == 0) st[3 * TP + p] = 1.0f;
  }
}

// Forward pass 3: a row below i_end composited from its checkpoint.
__global__ void __launch_bounds__(kThreads) fwd_composite_kernel(GrTrainArgs a) {
  extern __shared__ float4 smem4[];
  Lane* lanes = reinterpret_cast<Lane*>(smem4);
  Row r;
  if (!row_of(a, r)) return;
  const long long TP = static_cast<long long>(a.num_tiles) * r.P;
  float* st = a.stats + static_cast<long long>(r.tile) * r.P;
  if (r.ci >= static_cast<int>(st[4 * TP])) return;
  stage_chunk(lanes, a.feats, r, a.K);
  __syncthreads();
  const float kTEps = f32(1e-3);
  const float* crow = a.chk + r.row * r.P;
  float* prow = a.part + r.row * 3 * r.P;
  for (int g = 0; g < r.P; g += kGroup) {
    const int p0 = g + threadIdx.x * kPPT;
    const bool mine = p0 < r.P;
    float px[kPPT], py[kPPT], T[kPPT], last[kPPT], u[kPPT], ar[kPPT], ag[kPPT], ab[kPPT];
    bool live[kPPT];
    pixels_xy(r, a.tile_w, p0, px, py);
    if (mine) {
      unpack4(load4(crow + p0), T);
      unpack4(load4(st + 5 * TP + p0), last);
    }
#pragma unroll
    for (int i = 0; i < kPPT; ++i) {
      // Past its last row a pixel's checkpoint still holds U (reduce
      // writes it later); it adds nothing there.
      live[i] = mine && r.ci <= static_cast<int>(last[i]);
      u[i] = 1.0f;
      ar[i] = ag[i] = ab[i] = 0.0f;
    }
    bool any = any_of(live);
    for (int l = 0; l < a.K; ++l) {
      if (!__any_sync(kFull, any)) break;
      const float4 box = lanes[l].box;
#pragma unroll
      for (int i = 0; i < kPPT; ++i) {
        if (!live[i] || !in_box(box, px[i], py[i])) continue;
        const Lane& ln = lanes[l];
        const float alpha = alpha_terms(px[i], py[i], ln.geo, ln.mat).alpha;
        if (alpha == 0.0f) continue;
        const float tb = __fmul_rn(T[i], u[i]);
        if (!(tb >= kTEps)) {  // gates are a prefix: this pixel is done
          live[i] = false;
          continue;
        }
        const float w = __fmul_rn(alpha, tb);
        ar[i] = __fadd_rn(ar[i], __fmul_rn(w, ln.mat.z));
        ag[i] = __fadd_rn(ag[i], __fmul_rn(w, ln.mat.w));
        ab[i] = __fadd_rn(ab[i], __fmul_rn(w, ln.col.x));
        u[i] = __fmul_rn(u[i], __fsub_rn(1.0f, alpha));
      }
      any = any_of(live);
    }
    if (!mine) continue;
    *reinterpret_cast<float4*>(prow + p0) = make_float4(ar[0], ar[1], ar[2], ar[3]);
    *reinterpret_cast<float4*>(prow + r.P + p0) = make_float4(ag[0], ag[1], ag[2], ag[3]);
    *reinterpret_cast<float4*>(prow + 2 * r.P + p0) = make_float4(ab[0], ab[1], ab[2], ab[3]);
#pragma unroll
    for (int i = 0; i < kPPT; ++i)
      if (r.ci == static_cast<int>(last[i])) st[3 * TP + p0 + i] = __fmul_rn(T[i], u[i]);
  }
}

// Forward pass 4, one block per tile: rgb from the partials in chunk
// order, the exit T into the checkpoints past each pixel's last row, and
// rows 5-7 zeroed.
__global__ void __launch_bounds__(kTileThreads) fwd_reduce_kernel(GrTrainArgs a) {
  const int tile = blockIdx.x;
  const int P = a.tile_w * a.tile_h;
  const long long TP = static_cast<long long>(a.num_tiles) * P;
  const TileRows t = tile_rows(a, tile);
  const float* part = a.part + t.base * 3 * P;
  float* chk = a.chk + t.base * P;
  float* st = a.stats + static_cast<long long>(tile) * P;
  const int i_end = static_cast<int>(st[4 * TP]);
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int last = static_cast<int>(st[5 * TP + p]);
    float r = 0.0f, g = 0.0f, b = 0.0f;
    for (int c0 = 0; c0 <= last; c0 += kDepth) {
      const int n = min(kDepth, last + 1 - c0);
      float vr[kDepth], vg[kDepth], vb[kDepth];
#pragma unroll
      for (int j = 0; j < kDepth; ++j) {
        const float* q = part + (static_cast<long long>(c0 + j) * 3) * P + p;
        vr[j] = j < n ? q[0] : 0.0f;
        vg[j] = j < n ? q[P] : 0.0f;
        vb[j] = j < n ? q[2 * P] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kDepth; ++j) {
        if (j < n) {
          r = __fadd_rn(r, vr[j]);
          g = __fadd_rn(g, vg[j]);
          b = __fadd_rn(b, vb[j]);
        }
      }
    }
    st[p] = r;
    st[TP + p] = g;
    st[2 * TP + p] = b;
    const float t_final = st[3 * TP + p];
    for (int c = last + 1; c < i_end; ++c) chk[static_cast<long long>(c) * P + p] = t_final;
    st[5 * TP + p] = 0.0f;
    st[6 * TP + p] = 0.0f;
    st[7 * TP + p] = 0.0f;
  }
}

// Backward pass 1: each pixel's chunk total Y = sum_j (g.c_j)*w_j.
__global__ void __launch_bounds__(kThreads) bwd_totals_kernel(GrTrainArgs a) {
  extern __shared__ float4 smem4[];
  Lane* lanes = reinterpret_cast<Lane*>(smem4);
  Row r;
  if (!row_of(a, r)) return;
  const long long TP = static_cast<long long>(a.num_tiles) * r.P;
  const long long pix = static_cast<long long>(r.tile) * r.P;
  if (r.ci >= static_cast<int>(a.stats[4 * TP + pix])) return;
  stage_chunk(lanes, a.feats, r, a.K);
  __syncthreads();
  const float kTEps = f32(1e-3);
  const float* crow = a.chk + r.row * r.P;
  double* yrow = a.ysum + r.row * r.P;
  for (int g = 0; g < r.P; g += kGroup) {
    const int p0 = g + threadIdx.x * kPPT;
    const bool mine = p0 < r.P;
    float px[kPPT], py[kPPT], tc[kPPT], gr[kPPT], gg[kPPT], gb[kPPT], u[kPPT];
    double ys[kPPT];
    bool live[kPPT];
    pixels_xy(r, a.tile_w, p0, px, py);
    if (mine) {
      unpack4(load4(crow + p0), tc);
      unpack4(load4(a.gout + pix + p0), gr);
      unpack4(load4(a.gout + TP + pix + p0), gg);
      unpack4(load4(a.gout + 2 * TP + pix + p0), gb);
    }
#pragma unroll
    for (int i = 0; i < kPPT; ++i) {
      live[i] = mine && tc[i] >= kTEps;
      u[i] = 1.0f;
      ys[i] = 0.0;
    }
    bool any = any_of(live);
    for (int l = 0; l < a.K; ++l) {
      if (!__any_sync(kFull, any)) break;
      const float4 box = lanes[l].box;
#pragma unroll
      for (int i = 0; i < kPPT; ++i) {
        if (!live[i] || !in_box(box, px[i], py[i])) continue;
        const Lane& ln = lanes[l];
        const float alpha = alpha_terms(px[i], py[i], ln.geo, ln.mat).alpha;
        if (alpha == 0.0f) continue;
        const float tb = __fmul_rn(tc[i], u[i]);
        if (!(tb >= kTEps)) {
          live[i] = false;
          continue;
        }
        const float w = __fmul_rn(alpha, tb);
        const float gc = g_dot_c(gr[i], gg[i], gb[i], ln.mat.z, ln.mat.w, ln.col.x);
        ys[i] += static_cast<double>(__fmul_rn(gc, w));
        u[i] = __fmul_rn(u[i], __fsub_rn(1.0f, alpha));
      }
      any = any_of(live);
    }
    if (mine) {
#pragma unroll
      for (int i = 0; i < kPPT; ++i) yrow[p0 + i] = ys[i];
    }
  }
}

// Backward pass 2, one block per tile: A_exit of every walked row, from
// gT*T_final back to chunk 0.
__global__ void __launch_bounds__(kTileThreads) bwd_suffix_kernel(GrTrainArgs a) {
  const int tile = blockIdx.x;
  const int P = a.tile_w * a.tile_h;
  const long long TP = static_cast<long long>(a.num_tiles) * P;
  const long long pix = static_cast<long long>(tile) * P;
  const TileRows t = tile_rows(a, tile);
  const int i_end = min(static_cast<int>(a.stats[4 * TP + pix]), t.n);
  const double* ysum = a.ysum + t.base * P;
  float* a_exit = a.a_exit + t.base * P;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    // A = dL/dT_final * T_final.
    float acc = __fmul_rn(a.gout[3 * TP + pix + p], a.stats[3 * TP + pix + p]);
    for (int c0 = i_end - 1; c0 >= 0; c0 -= kDepth) {
      const int n = min(kDepth, c0 + 1);
      double y[kDepth];
#pragma unroll
      for (int j = 0; j < kDepth; ++j)
        y[j] = j < n ? ysum[static_cast<long long>(c0 - j) * P + p] : 0.0;
#pragma unroll
      for (int j = 0; j < kDepth; ++j) {
        if (j < n) {
          a_exit[static_cast<long long>(c0 - j) * P + p] = acc;
          acc = __fadd_rn(acc, static_cast<float>(y[j]));
        }
      }
    }
  }
}

// Backward pass 3: per-lane gradients of a row, summed over the tile's
// pixels; the block writes columns 0-8 of the row's in-range lanes. The
// sums have a fixed order, so two launches on the same inputs agree bit
// for bit: within a warp the shuffle tree, within a warp's slice the pixel
// groups in order (lane 0 of the warp is its only writer), across warps
// warp 0 first, then 1, ..., 7. A shared atomicAdd would add the warps in
// the order they arrive, which changes from launch to launch.
__global__ void __launch_bounds__(kThreads) bwd_grads_kernel(GrTrainArgs a) {
  extern __shared__ float4 smem4[];
  Lane* lanes = reinterpret_cast<Lane*>(smem4);
  Row r;
  if (!row_of(a, r)) return;
  const long long TP = static_cast<long long>(a.num_tiles) * r.P;
  const long long pix = static_cast<long long>(r.tile) * r.P;
  if (r.ci >= static_cast<int>(a.stats[4 * TP + pix])) return;
  const int K = a.K;
  float* s_part = reinterpret_cast<float*>(lanes + K);  // [kWarps][kGradCols][K]
  float* w_part = s_part + (threadIdx.x >> 5) * kGradCols * K;
  stage_chunk(lanes, a.feats, r, K);
  for (int j = threadIdx.x; j < kWarps * kGradCols * K; j += blockDim.x) s_part[j] = 0.0f;
  __syncthreads();
  const float kTEps = f32(1e-3);
  const float kAlphaMax = f32(0.99);
  const float* crow = a.chk + r.row * r.P;
  const double* yrow = a.ysum + r.row * r.P;
  const float* arow = a.a_exit + r.row * r.P;
  for (int g = 0; g < r.P; g += kGroup) {
    const int p0 = g + threadIdx.x * kPPT;
    const bool mine = p0 < r.P;
    float px[kPPT], py[kPPT], tc[kPPT], gr[kPPT], gg[kPPT], gb[kPPT], acc[kPPT], u[kPPT];
    double ys[kPPT], prefix[kPPT];
    bool live[kPPT];
    pixels_xy(r, a.tile_w, p0, px, py);
    if (mine) {
      unpack4(load4(crow + p0), tc);
      unpack4(load4(a.gout + pix + p0), gr);
      unpack4(load4(a.gout + TP + pix + p0), gg);
      unpack4(load4(a.gout + 2 * TP + pix + p0), gb);
      unpack4(load4(arow + p0), acc);
    }
#pragma unroll
    for (int i = 0; i < kPPT; ++i) {
      live[i] = mine && tc[i] >= kTEps;
      ys[i] = mine ? yrow[p0 + i] : 0.0;
      prefix[i] = 0.0;
      u[i] = 1.0f;
    }
    bool any = any_of(live);
    for (int l = 0; l < K; ++l) {
      if (!__any_sync(kFull, any)) break;
      const float4 box = lanes[l].box;
      float v[kGradCols];
#pragma unroll
      for (int c = 0; c < kGradCols; ++c) v[c] = 0.0f;
      bool hit = false;
#pragma unroll
      for (int i = 0; i < kPPT; ++i) {
        if (!live[i] || !in_box(box, px[i], py[i])) continue;
        const Lane& ln = lanes[l];
        const Terms t = alpha_terms(px[i], py[i], ln.geo, ln.mat);
        if (t.alpha == 0.0f) continue;
        const float tb = __fmul_rn(tc[i], u[i]);
        if (!(tb >= kTEps)) {
          live[i] = false;
          continue;
        }
        hit = true;
        const float one_minus = __fsub_rn(1.0f, t.alpha);
        const float w = __fmul_rn(t.alpha, tb);
        const float gc = g_dot_c(gr[i], gg[i], gb[i], ln.mat.z, ln.mat.w, ln.col.x);
        const float y = __fmul_rn(gc, w);
        prefix[i] += static_cast<double>(y);
        const float S = static_cast<float>(ys[i] - prefix[i]);
        v[6] += gr[i] * w;
        v[7] += gg[i] * w;
        v[8] += gb[i] * w;
        if (t.alpha_raw < kAlphaMax) {
          const float d_alpha = gc * tb - (S + acc[i]) / one_minus;
          v[5] += d_alpha * t.e;
          if (t.md2_raw > 0.0f && t.md2_raw < 80.0f) {
            const float d_md2 = -0.5f * d_alpha * t.alpha_raw;
            const float dx = t.dx, dy = t.dy;
            const float A = ln.geo.z, B = ln.geo.w, C = ln.mat.x;
            v[0] += d_md2 * (-(2.0f * A * dx + B * dy));
            v[1] += d_md2 * (-(2.0f * C * dy + B * dx));
            v[2] += d_md2 * dx * dx;
            v[3] += d_md2 * dx * dy;
            v[4] += d_md2 * dy * dy;
          }
        }
        u[i] = __fmul_rn(u[i], one_minus);
      }
      if (__any_sync(kFull, hit)) {
#pragma unroll
        for (int c = 0; c < kGradCols; ++c) v[c] = warp_sum(v[c]);
        if ((threadIdx.x & 31) == 0) {
#pragma unroll
          for (int c = 0; c < kGradCols; ++c) w_part[c * K + l] += v[c];
        }
      }
      any = any_of(live);
    }
  }
  __syncthreads();
  const int base = (r.start / K) * K + r.ci * K;
  for (int l = threadIdx.x; l < K; l += blockDim.x) {
    const int slot = base + l;
    if (slot < r.start || slot >= r.end) continue;
    float* d = a.d_feats + static_cast<long long>(slot) * kFeatDim;
#pragma unroll
    for (int c = 0; c < kGradCols; ++c) {
      float sum = s_part[c * K + l];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum = __fadd_rn(sum, s_part[(w * kGradCols + c) * K + l]);
      d[c] = sum;
    }
  }
}

}  // namespace

extern "C" {

// Launches one pass on `stream` (see the Pass ids above; row passes need
// n_rows >= 1) and returns cudaGetLastError() (0 = ok). Tiles of any
// multiple of 128 pixels, chunks of 1..512 lanes; feats, chk, stats, part,
// gout and a_exit 16-byte aligned.
int gr_train_pass(int pass, const GrTrainArgs* args, void* stream) {
  const GrTrainArgs a = *args;
  const int P = a.tile_w * a.tile_h;
  if (a.tile_w < 1 || a.tile_h < 1 || P % 128 != 0 || a.K < 1 || a.K > kMaxChunk ||
      a.num_tiles < 1 || a.tiles_x < 1 || a.n_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool row_pass = pass == kRowTiles || pass == kFwdProducts || pass == kFwdComposite ||
                        pass == kBwdTotals || pass == kBwdGrads;
  if (row_pass && a.n_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t lane_bytes = static_cast<size_t>(a.K) * sizeof(Lane);
  const int tile_threads = P < kTileThreads ? P : kTileThreads;
  switch (pass) {
    case kRowTiles:
      row_tiles_kernel<<<(a.n_rows + 255) / 256, 256, 0, st>>>(a);
      break;
    case kFwdProducts:
      fwd_products_kernel<<<a.n_rows, kThreads, lane_bytes, st>>>(a);
      break;
    case kFwdScan:
      fwd_scan_kernel<<<a.num_tiles, tile_threads, 0, st>>>(a);
      break;
    case kFwdComposite:
      fwd_composite_kernel<<<a.n_rows, kThreads, lane_bytes, st>>>(a);
      break;
    case kFwdReduce:
      fwd_reduce_kernel<<<a.num_tiles, tile_threads, 0, st>>>(a);
      break;
    case kBwdTotals:
      bwd_totals_kernel<<<a.n_rows, kThreads, lane_bytes, st>>>(a);
      break;
    case kBwdSuffix:
      bwd_suffix_kernel<<<a.num_tiles, tile_threads, 0, st>>>(a);
      break;
    case kBwdGrads: {
      // The lanes and every warp's gradient slice: K * (64 + 8 * 36) bytes,
      // 180,224 at kMaxChunk (under the 232,448 a block may opt in to).
      const size_t smem =
          lane_bytes + static_cast<size_t>(a.K) * kWarps * kGradCols * sizeof(float);
      if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            bwd_grads_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
      }
      bwd_grads_kernel<<<a.n_rows, kThreads, smem, st>>>(a);
      break;
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* gr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
