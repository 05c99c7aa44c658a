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
// What bounds it on the card: operations. A pixel inside a lane's AABB
// costs about 43 fp32/int operations while it is live, against 20 bytes
// read for the lane. What wastes them: warps testing lanes that miss all
// their pixels, pixels that have stopped computing on until the whole
// tile exits, the densest tiles running alone on one SM at the end of a
// frame, and chunk loads that wait for the previous chunk.
//
// What this design does about it:
// - Each warp owns an 8x4 pixel rectangle of the tile, one pixel a thread.
//   For each group of 32 lanes of a chunk the warp ballots which lanes'
//   u8 AABBs overlap its rectangle and walks only those, with __ffs, in
//   lane order. This is exact: a lane that misses every pixel of the
//   rectangle gives each of them alpha 0, which changes neither a weight
//   nor T.
// - Without an alpha row, T past a pixel's stop feeds nothing (not the
//   weights, not the exit or the census, since T only falls), so a warp
//   whose pixels have all stopped stops walking (template flag OUT_ALPHA;
//   with it, T stays ungated and every walked lane is applied).
// - A three-step pipeline over two raw and two decoded buffers: while the
//   block composites chunk i, it decodes chunk i+1 (once per block, packed
//   as three float4s a lane for broadcast loads) and copies chunk i+2 into
//   shared memory with cp.async. One barrier a chunk, at its end, which
//   also gives the tile-wide exit.
// - Without an alpha row, the tile-wide exit decides nothing but
//   chunks_walked (a stopped pixel takes no weight, whoever walks on), so
//   a tile is cut into bands of about kBandRects rectangles (whole census
//   block rows when the census is on), one CTA each, walking until its own
//   pixels stop; chunks_walked is the largest band's count (atomicMax).
//   A dense tile's pixels then spread over several SMs (the densest tiles
//   of a frame otherwise run alone at its end). Bands of 8 rectangles
//   time best of 4, 8, 16 and 32 (one block a 32x32 tile) on both 1080p
//   frames of chip_smoke.py (tools/torch_band_probe.py).
// - A tile (or band) of more than 32 rectangles runs with 32 warps that
//   walk the rectangles in groups of 32 (MULTI), each group's per-pixel
//   state (T and four sums) kept in a device-memory scratch between chunks
//   (L2-resident: 20 bytes a pixel). Any packed_compatible tile runs
//   (sides <= 255, pixel count a multiple of 128). A cluster of CTAs
//   holding the state in registers would cap a tile at 8 CTAs' pixels
//   and need a cluster barrier every chunk, for tiles off the default
//   path (32x32): the scratch is simpler.
// - The saturation census (SAT) has up to 128 16x16 blocks (four mask
//   words). An 8x4 rectangle lies inside one census block, so a warp adds
//   its block's "open" bit with one __any_sync and one shared atomicOr;
//   after the chunk-end barrier, thread b records block b.
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

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kRectW = 8, kRectH = 4;
// Rectangles a band (without an alpha row), about.
constexpr int kBandRects = 8;
constexpr int kConicExpBias = 80;
// Raw rows staged per lane: the five record rows and the depth row.
constexpr int kRawRows = 6;
// Decoded lane: three float4s (cx, cy, A, B), (C, q0, r, g), (b, depth,
// box bits, unused), read with three broadcast loads; the boxes again as a
// u32 row for the ballot.
constexpr int kDecWords = 12;
// Dynamic shared memory per chunk lane: two raw and two decoded buffers.
constexpr int kSmemPerLane = 2 * (kRawRows + kDecWords + 1) * 4;
// Saturation census: 16x16 blocks, at most 128 a tile (four mask words).
constexpr int kSatBlock = 16;
constexpr int kMaxSatBlocks = 128;
constexpr int kSatWords = kMaxSatBlocks / 32;
// Per-pixel state kept in the scratch between chunks (MULTI): T, r, g, b, d.
constexpr int kStateRows = 5;

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

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct Args {
  const uint32_t* feats;
  long long C;
  const int* tile_start;
  const int* tile_count;
  const float* depth_row;
  float* out;
  int* chunks_walked;
  int* sat_idx;
  float* state;  // MULTI: kStateRows planes of (tiles, groups, 1024) floats
  int tiles_x, num_tiles, tile_w, tile_h, width, height, K, out_depth;
  int rects_x, n_rects, groups;
  // Bands of band_rows rectangle rows a tile, one CTA each (1: the tile).
  int bands, band_rows;
};

// One chunk's decoded lanes in shared memory.
struct Lanes {
  const float4* q;  // [K][3]
  const uint32_t* box;
};

struct Pix {
  float T, r, g, b, d;
};

// True if some p in [r0, r1] passes the kernel's unsigned box test
// (uint32)(p - lo) <= (uint32)(hi - lo): lo <= p <= hi, or, for an
// inverted box (lo > hi), p >= lo or p <= hi.
__device__ __forceinline__ bool range_hit(int lo, int hi, int r0, int r1) {
  return lo <= hi ? (lo <= r1 && hi >= r0) : (lo <= r1 || hi >= r0);
}

// Issue the cp.async copies of the chunk at `base` (its lanes in the tile's
// range) into `buf` ([kRawRows][K] u32), as one commit group.
__device__ __forceinline__ void stage(uint32_t* buf, const Args& a, int base, int lo,
                                      int hi) {
  const int K = a.K;
  for (int l = lo + threadIdx.x; l < hi; l += blockDim.x) {
    const long long slot = static_cast<long long>(base) + l;
#pragma unroll
    for (int r = 0; r < 5; ++r) cp_async4(buf + r * K + l, a.feats + r * a.C + slot);
    if (a.out_depth) cp_async4(buf + 5 * K + l, a.depth_row + slot);
  }
  cp_async_commit();
}

// Decode the staged lanes [lo, hi) of `buf` into `dec` ([K][3] float4)
// and `box` ([K] u32).
__device__ __forceinline__ void decode(const uint32_t* buf, float4* dec, uint32_t* box,
                                       int K, int lo, int hi, int out_depth) {
  for (int l = lo + threadIdx.x; l < hi; l += blockDim.x) {
    const uint32_t r0 = buf[l], r1 = buf[K + l], r2 = buf[2 * K + l], r3 = buf[3 * K + l];
    const bool coarse = (r3 >> 30) & 1u;
    const float c_scale = coarse ? 1.0f : f32(1.0 / 8.0);
    const float c_bias = coarse ? 32768.0f : 4096.0f;
    const float cx = __fsub_rn(
        __fmul_rn(static_cast<float>(static_cast<int>(r0 >> 16)), c_scale), c_bias);
    const float cy = __fsub_rn(
        __fmul_rn(static_cast<float>(static_cast<int>(r0 & 0xFFFFu)), c_scale), c_bias);
    const float u = dec_e6m10(r1 >> 16);
    const float w = dec_e6m10(r1 & 0xFFFFu);
    const float v = dec_s1e6m9(r2 >> 16);
    const float op = fmaxf(__fmul_rn(static_cast<float>(static_cast<int>(r2 & 0xFFFFu)),
                                     f32(1.0 / 65535.0)),
                           f32(1e-6));
    const float inv1023 = f32(1.0 / 1023.0);
    dec[3 * l] = make_float4(cx, cy, __fmul_rn(u, u), __fmul_rn(__fmul_rn(2.0f, u), v));
    dec[3 * l + 1] = make_float4(
        __fadd_rn(__fmul_rn(v, v), __fmul_rn(w, w)), __fmul_rn(-2.0f, logf(op)),
        __fmul_rn(static_cast<float>(static_cast<int>(r3 & 0x3FFu)), inv1023),
        __fmul_rn(static_cast<float>(static_cast<int>((r3 >> 10) & 0x3FFu)), inv1023));
    dec[3 * l + 2] = make_float4(
        __fmul_rn(static_cast<float>(static_cast<int>((r3 >> 20) & 0x3FFu)), inv1023),
        out_depth ? __uint_as_float(buf[5 * K + l]) : 0.0f, __uint_as_float(buf[4 * K + l]),
        0.0f);
    box[l] = buf[4 * K + l];
  }
}

// Composite chunk lanes [lo, hi) onto this thread's pixel (px, py) of the
// warp's rectangle [rx0, rx1] x [ry0, ry1]. `real`: the pixel is in the tile.
template <bool OUT_ALPHA>
__device__ __forceinline__ void composite_rect(const Lanes& s, int lo, int hi, int rx0,
                                               int rx1, int ry0, int ry1, int px, int py,
                                               bool real, Pix& st) {
  const float kAlphaEps = f32(1e-3);
  const float kTEps = f32(1e-3);
  const float kAlphaMax = f32(0.99);
  const int lane = threadIdx.x & 31;
  const float fx = static_cast<float>(px), fy = static_cast<float>(py);
  for (int j0 = lo & ~31; j0 < hi; j0 += 32) {
    // Every pixel of the rectangle has stopped: nothing it could still
    // take feeds an output.
    if (!OUT_ALPHA && !__any_sync(kFull, real && st.T >= kTEps)) return;
    const int l = j0 + lane;
    bool hit = false;
    if (l >= lo && l < hi) {
      const uint32_t box = s.box[l];
      hit = range_hit(box & 0xFF, (box >> 16) & 0xFF, rx0, rx1) &&
            range_hit((box >> 8) & 0xFF, box >> 24, ry0, ry1);
    }
    uint32_t m = __ballot_sync(kFull, hit);
    while (m != 0u) {
      const int ll = j0 + __ffs(m) - 1;
      m &= m - 1;
      const float4 v2 = s.q[3 * ll + 2];
      const uint32_t box = __float_as_uint(v2.z);
      const int xmin = box & 0xFF, ymin = (box >> 8) & 0xFF;
      const int xmax = (box >> 16) & 0xFF, ymax = box >> 24;
      if (static_cast<uint32_t>(px - xmin) > static_cast<uint32_t>(xmax - xmin) ||
          static_cast<uint32_t>(py - ymin) > static_cast<uint32_t>(ymax - ymin))
        continue;
      const float4 v0 = s.q[3 * ll], v1 = s.q[3 * ll + 1];
      const float dx = __fsub_rn(fx, v0.x);
      const float dy = __fsub_rn(fy, v0.y);
      const float md2 = __fadd_rn(
          __fmul_rn(__fadd_rn(__fmul_rn(v0.z, dx), __fmul_rn(v0.w, dy)), dx),
          __fmul_rn(__fmul_rn(v1.x, dy), dy));
      const float q = __fadd_rn(md2, v1.y);
      const float alpha = fminf(fast_exp(__fmul_rn(-0.5f, q)), kAlphaMax);
      if (!(alpha >= kAlphaEps)) continue;
      const float tb = st.T;
      if (tb >= kTEps) {
        const float wgt = __fmul_rn(tb, alpha);
        st.r = __fadd_rn(st.r, __fmul_rn(wgt, v1.z));
        st.g = __fadd_rn(st.g, __fmul_rn(wgt, v1.w));
        st.b = __fadd_rn(st.b, __fmul_rn(wgt, v2.x));
        st.d = __fadd_rn(st.d, __fmul_rn(wgt, v2.y));
      }
      st.T = __fmul_rn(tb, __fsub_rn(1.0f, alpha));
    }
  }
}

// Rectangle rr of the tile: its clipped pixel range and this thread's pixel.
struct Rect {
  int rx0, rx1, ry0, ry1, px, py;
  bool real;
};

__device__ __forceinline__ Rect rect_of(const Args& a, int rr) {
  Rect q;
  const int lane = threadIdx.x & 31;
  q.rx0 = (rr % a.rects_x) * kRectW;
  q.ry0 = (rr / a.rects_x) * kRectH;
  q.rx1 = min(q.rx0 + kRectW - 1, a.tile_w - 1);
  q.ry1 = min(q.ry0 + kRectH - 1, a.tile_h - 1);
  q.px = q.rx0 + (lane & (kRectW - 1));
  q.py = q.ry0 + lane / kRectW;
  q.real = q.px < a.tile_w && q.py < a.tile_h;
  return q;
}

__device__ __forceinline__ long long state_index(const Args& a, int tile, int g) {
  return (static_cast<long long>(tile) * a.groups + g) * kMaxThreads + threadIdx.x;
}

__device__ __forceinline__ void load_state(const Args& a, long long i, Pix& p) {
  const long long plane = static_cast<long long>(a.num_tiles) * a.groups * kMaxThreads;
  p.T = a.state[i];
  p.r = a.state[plane + i];
  p.g = a.state[2 * plane + i];
  p.b = a.state[3 * plane + i];
  p.d = a.state[4 * plane + i];
}

__device__ __forceinline__ void store_state(const Args& a, long long i, const Pix& p) {
  const long long plane = static_cast<long long>(a.num_tiles) * a.groups * kMaxThreads;
  a.state[i] = p.T;
  a.state[plane + i] = p.r;
  a.state[2 * plane + i] = p.g;
  a.state[3 * plane + i] = p.b;
  a.state[4 * plane + i] = p.d;
}

// One rectangle a warp, its state in registers (MULTI: `groups` of them
// one after another, state in the scratch); SAT: the census; OUT_ALPHA:
// the alpha row (T ungated, no dead-warp stop).
template <bool MULTI, bool SAT, bool OUT_ALPHA>
__global__ void __launch_bounds__(kMaxThreads) tile_kernel(const Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint32_t s_open[3][kSatWords];
  const int K = a.K;
  uint32_t* raw = smem;  // [2][kRawRows][K]
  // Two decode buffers: [2][K][3] float4, then [2][K] u32 boxes.
  float4* dec = reinterpret_cast<float4*>(smem + 2 * kRawRows * K);
  uint32_t* boxes = reinterpret_cast<uint32_t*>(dec + 6 * K);
  const float kTEps = f32(1e-3);

  const int tile = blockIdx.x / a.bands;
  const int band = blockIdx.x % a.bands;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const int start = a.tile_start[tile];
  const int count = a.tile_count[tile];
  const int aligned = (start / K) * K;
  const int num_chunks = (start + count - aligned + K - 1) / K;
  const int x0 = (tile % a.tiles_x) * a.tile_w;
  const int y0 = (tile / a.tiles_x) * a.tile_h;
  // This CTA's rectangles: rect0 .. rect0 + n_rects - 1 of the tile.
  const int rect0 = band * a.band_rows * a.rects_x;
  const int n_rects = min(a.n_rects - rect0, a.band_rows * a.rects_x);
  // Its census blocks (bands are whole block rows): sat0 .. sat0 + n_sat - 1.
  const int sat_bw = a.tile_w / kSatBlock;
  const int sat0 = rect0 / a.rects_x * kRectH / kSatBlock * sat_bw;
  const int n_sat =
      SAT ? min(sat_bw * (a.tile_h / kSatBlock) - sat0,
                (a.band_rows * kRectH / kSatBlock) * sat_bw)
          : 0;
  int sat = -1;  // thread b < n_sat: census block sat0 + b's recorded lane
  // Chunk ci holds lanes [lo, hi) of the window at aligned + ci * K.
  auto lo_of = [&](int ci) { return max(start - aligned - ci * K, 0); };
  auto hi_of = [&](int ci) { return min(start + count - aligned - ci * K, K); };

  Pix st{1.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  // MULTI without an alpha row: bit g set once group g's pixels all stopped.
  unsigned long long dead = 0ull;
  const int n_groups = MULTI ? a.groups : 1;

  // Pipeline: between two chunk-end barriers the block composites chunk
  // ci, decodes chunk ci+1 (staged earlier) and stages chunk ci+2, each in
  // its own buffer, so each chunk costs one barrier, which also publishes
  // the copies and gives the tile-wide exit.
  if (SAT && threadIdx.x < 3 * kSatWords) s_open[threadIdx.x / kSatWords][threadIdx.x % kSatWords] = 0u;
  if (num_chunks > 0) {
    stage(raw, a, aligned, lo_of(0), hi_of(0));
    cp_async_wait_all();
    __syncthreads();
    decode(raw, dec, boxes, K, lo_of(0), hi_of(0), a.out_depth);
    if (num_chunks > 1) stage(raw + kRawRows * K, a, aligned + K, 0, hi_of(1));
  }

  int walked = 0;
  bool alive = true;
  for (int ci = 0;; ++ci) {
    cp_async_wait_all();
    const int any_alive = __syncthreads_or(alive);
    if (SAT && ci > 0) {
      // Every warp's bits for chunk ci-1 are in; the word set cleared here
      // is next written after the next barrier.
      const int b = threadIdx.x;
      if (b < n_sat && sat < 0 && !((s_open[(ci - 1) % 3][b >> 5] >> (b & 31)) & 1u))
        sat = min(aligned + ci * K, start + count) - 1;
      if (b < kSatWords) s_open[(ci + 1) % 3][b] = 0u;
    }
    // Leave after chunk ci-1 once no pixel of the tile can take weight.
    if (ci == num_chunks || !any_alive) break;
    if (ci + 2 < num_chunks)
      stage(raw + (ci & 1) * kRawRows * K, a, aligned + (ci + 2) * K, 0, hi_of(ci + 2));
    if (ci + 1 < num_chunks)
      decode(raw + ((ci + 1) & 1) * kRawRows * K, dec + ((ci + 1) & 1) * 3 * K,
             boxes + ((ci + 1) & 1) * K, K, 0, hi_of(ci + 1), a.out_depth);
    const Lanes lanes{dec + (ci & 1) * 3 * K, boxes + (ci & 1) * K};
    const int lo = lo_of(ci), hi = hi_of(ci);

    alive = false;
    for (int g = 0; g < n_groups; ++g) {
      const int rr = g * nw + warp;
      if (rr >= n_rects) break;
      if (MULTI && !OUT_ALPHA && ((dead >> g) & 1ull)) continue;
      const Rect q = rect_of(a, rect0 + rr);
      if (MULTI) {
        if (ci == 0)
          st = Pix{1.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        else
          load_state(a, state_index(a, tile, g), st);
      }
      composite_rect<OUT_ALPHA>(lanes, lo, hi, q.rx0, q.rx1, q.ry0, q.ry1, q.px, q.py,
                                q.real, st);
      if (MULTI) store_state(a, state_index(a, tile, g), st);
      const bool live = __any_sync(kFull, q.real && st.T >= kTEps);
      alive = alive || live;
      if (MULTI && !OUT_ALPHA && !live) dead |= 1ull << g;
      if (SAT) {
        const bool in_img = q.real && x0 + q.px < a.width && y0 + q.py < a.height;
        const bool open = __any_sync(kFull, in_img && st.T >= kTEps);
        if (open && lane == 0) {
          const int b = (q.ry0 / kSatBlock) * sat_bw + q.rx0 / kSatBlock - sat0;
          atomicOr(&s_open[ci % 3][b >> 5], 1u << (b & 31));
        }
      }
    }
    walked = ci + 1;
  }
  // The tile walks as far as its furthest band (the launch zeroed the
  // counts when there are bands).
  if (a.chunks_walked != nullptr && threadIdx.x == 0) {
    if (a.bands > 1)
      atomicMax(a.chunks_walked + tile, walked);
    else
      a.chunks_walked[tile] = walked;
  }
  if (SAT && threadIdx.x < n_sat)
    a.sat_idx[static_cast<long long>(tile) * sat_bw * (a.tile_h / kSatBlock) + sat0 +
              threadIdx.x] = sat;

  const long long plane = static_cast<long long>(a.height) * a.width;
  for (int g = 0; g < n_groups; ++g) {
    const int rr = g * nw + warp;
    if (rr >= n_rects) break;
    const Rect q = rect_of(a, rect0 + rr);
    if (MULTI) {
      if (walked > 0)
        load_state(a, state_index(a, tile, g), st);
      else
        st = Pix{1.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    }
    const int gx = x0 + q.px, gy = y0 + q.py;
    if (!q.real || gx >= a.width || gy >= a.height) continue;
    float* o = a.out + static_cast<long long>(gy) * a.width + gx;
    o[0] = st.r;
    o[plane] = st.g;
    o[2 * plane] = st.b;
    int row = 3;
    if (OUT_ALPHA) o[(row++) * plane] = 1.0f - st.T;
    if (a.out_depth) o[row * plane] = st.d;
  }
}

template <bool MULTI>
cudaError_t launch(const Args& a, int threads, size_t smem, cudaStream_t stream, bool sat,
                   bool out_alpha) {
  void (*kernel)(const Args);
  if (sat)
    kernel = out_alpha ? tile_kernel<MULTI, true, true> : tile_kernel<MULTI, true, false>;
  else
    kernel = out_alpha ? tile_kernel<MULTI, false, true> : tile_kernel<MULTI, false, false>;
  // Above 48 KB a launch is refused unless the kernel is allowed more.
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<a.num_tiles * a.bands, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The tile's rectangles and how the blocks share them: without an alpha
// row, bands of about kBandRects rectangles (whole census block rows with
// the census, at most 32 rectangles), one block each; else, or where no
// such band exists, one block a tile, in groups of 32 rectangles above 32.
void layout(int tile_w, int tile_h, bool out_alpha, bool sat, Args& a) {
  const int rect_rows = (tile_h + kRectH - 1) / kRectH;
  a.rects_x = (tile_w + kRectW - 1) / kRectW;
  a.n_rects = a.rects_x * rect_rows;
  a.groups = (a.n_rects + kMaxWarps - 1) / kMaxWarps;
  a.bands = 1;
  a.band_rows = rect_rows;
  if (out_alpha) return;
  int rows = max(1, kBandRects / a.rects_x);
  if (sat) rows = (rows + 3) / 4 * 4;
  rows = min(rows, rect_rows);
  if (a.rects_x * rows > kMaxWarps) return;
  a.bands = (rect_rows + rows - 1) / rows;
  a.band_rows = rows;
  a.groups = 1;
}

}  // namespace

extern "C" {

// Composite all tiles. feats is the (5, C) u32 record matrix (row-major),
// tile_start/tile_count (T,) int32, depth_row (C,) f32 or null, out
// (3 + out_alpha + out_depth, height, width) f32, chunks_walked (T,) int32
// or null, sat_idx (T * blocks per tile,) int32 or null (no census).
// Tiles walked in groups of 32 8x4 rectangles need `state`,
// gr_tile_render2_state_floats(...) f32, else null. With bands (no alpha
// row), chunks_walked is zeroed on `stream` and each band adds its count
// with atomicMax.
// Launches on `stream` and returns cudaGetLastError() (0 = ok).
int gr_tile_render2(const void* feats, long long C, const void* tile_start,
                    const void* tile_count, const void* depth_row, void* out,
                    void* chunks_walked, void* sat_idx, void* state, int tiles_x,
                    int tiles_y, int tile_w, int tile_h, int width, int height, int K,
                    int out_alpha, int out_depth, void* stream) {
  if (tile_w < 1 || tile_w > 255 || tile_h < 1 || tile_h > 255 || K < 1 || K > 1024 ||
      (out_depth && depth_row == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (sat_idx != nullptr &&
      (tile_w % kSatBlock != 0 || tile_h % kSatBlock != 0 ||
       (tile_w / kSatBlock) * (tile_h / kSatBlock) > kMaxSatBlocks))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.feats = static_cast<const uint32_t*>(feats);
  a.C = C;
  a.tile_start = static_cast<const int*>(tile_start);
  a.tile_count = static_cast<const int*>(tile_count);
  a.depth_row = static_cast<const float*>(depth_row);
  a.out = static_cast<float*>(out);
  a.chunks_walked = static_cast<int*>(chunks_walked);
  a.sat_idx = static_cast<int*>(sat_idx);
  a.state = static_cast<float*>(state);
  a.tiles_x = tiles_x;
  a.num_tiles = tiles_x * tiles_y;
  a.tile_w = tile_w;
  a.tile_h = tile_h;
  a.width = width;
  a.height = height;
  a.K = K;
  a.out_depth = out_depth;
  layout(tile_w, tile_h, out_alpha != 0, sat_idx != nullptr, a);
  if (a.num_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunks_walked != nullptr && a.bands > 1) {
    const cudaError_t err =
        cudaMemsetAsync(chunks_walked, 0, sizeof(int) * a.num_tiles, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t smem = static_cast<size_t>(K) * kSmemPerLane;
  const bool sat = sat_idx != nullptr, alpha = out_alpha != 0;
  if (a.groups > 1) {
    if (state == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch<true>(a, kMaxThreads, smem, s, sat, alpha));
  }
  const int threads = min(a.n_rects, a.band_rows * a.rects_x) * 32;
  return static_cast<int>(launch<false>(a, threads, smem, s, sat, alpha));
}

// Floats of the `state` scratch gr_tile_render2 needs for these arguments
// (0: none).
long long gr_tile_render2_state_floats(int num_tiles, int tile_w, int tile_h, int out_alpha,
                                       int with_sat) {
  Args a;
  layout(tile_w, tile_h, out_alpha != 0, with_sat != 0, a);
  return a.groups > 1 ? static_cast<long long>(kStateRows) * num_tiles * a.groups * kMaxThreads
                      : 0;
}

const char* gr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
