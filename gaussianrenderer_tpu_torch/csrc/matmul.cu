// bf16 GEMM for Hopper (sm_90a): C = A · B with f32 accumulation, in two
// kernels.
//
// Replaces the TPU kernel gaussianrenderer_tpu/ops/pallas/matmul.py
// `_mm_kernel` (reached by `matmul_pallas`): (M, K) · (K, N), bf16 inputs,
// f32 accumulator, f32 output, all row-major. The TPU kernel walks K as the
// trailing grid dimension and carries the (bm, bn) sum in VMEM scratch
// from one grid step to the next; blocks here run in parallel and in no
// order, so each block owns its output tiles and walks all of K itself.
//
// What bounds it on the card: operations. At the harness's 8192^3 it
// needs 2 x 5.5e11 multiply-adds over 989 TFLOP/s of dense bf16 (1.11 ms)
// against 537 MB over 3.35 TB/s (0.16 ms), and only `wgmma` reaches that
// rate. So the main kernel (`gr_matmul_sm90`) is the warp-specialised
// Hopper shape:
//
// - a persistent grid, one CTA per SM, walking 128x256 output tiles in
//   groups of 8 tile rows, so the CTAs running at once share A and B
//   panels in L2, and the producer fetches the next tile's first K steps
//   while the consumers write the last one out;
// - one producer warp that only issues TMA loads (128-byte swizzle, zero
//   fill past every edge) into a 4-stage ring of 48 KB stages (A 128x64,
//   B 64x256 as four 64-wide N slabs), handed over by full/empty
//   mbarriers;
// - two consumer warpgroups, each multiplying its 64 rows by the whole
//   256 columns with `wgmma.mma_async.m64n256k16` straight from shared
//   memory into 128 f32 accumulators a thread, one K step's group kept
//   in flight while the next is issued. A is K-major; B, being (K, N)
//   row-major, is N-major: its descriptor steps 8 KB between N slabs
//   (leading offset) and 1 KB between groups of 8 K rows (stride
//   offset), and the instruction transposes it (imm-trans-b = 1).
//   `setmaxnreg` moves registers from the producer (40) to the
//   consumers (232);
// - an epilogue that stores each accumulator pair as one float2, guarded
//   on M and N.
//
// TMA needs 16-byte global strides and bases: K and N multiples of 8 and
// both base pointers 16-byte aligned (the wrapper's `gemm_kernel` decides
// this from shape and alignment alone). Every other shape goes to the
// second kernel (`gr_matmul`): `nvcuda::wmma` 16x16x16 fragments, a
// 128x128 tile per block of 8 warps, A and B slices staged through padded
// shared rows with zero fill (16 bytes at a time when it can, else one
// element at a time) and a guarded per-warp output scratch, so it takes
// any M, N, K >= 1, at the rate of Ampere's `mma.sync` tiles.

#include <cuda.h>  // CUtensorMap and its enums (libcuda itself is not linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kThreads = 256;
constexpr int kWarpsM = 4;  // warp grid 4 x 2; each warp 32 x 64
constexpr int kWarpM = kBM / kWarpsM;
constexpr int kWarpN = kBN / 2;
constexpr int kFragM = kWarpM / 16;  // 2
constexpr int kFragN = kWarpN / 16;  // 4
// Shared rows padded by 8 bf16 (16 bytes): keeps every fragment pointer
// 32-byte aligned and spreads rows over the banks.
constexpr int kLdA = kBK + 8;
constexpr int kLdB = kBN + 8;
// Elements (or 8-element vectors) each thread stages per K step.
constexpr int kScalarLoads = kBM * kBK / kThreads;     // 16 of A, 16 of B
constexpr int kVecLoads = kBM * kBK / 8 / kThreads;    // 2 of A, 2 of B

static_assert(kBM * kBK == kBK * kBN, "A and B slices hold as many elements");

struct Staged {
  uint4 a[kVecLoads];
  uint4 b[kVecLoads];
  uint16_t as[kScalarLoads];
  uint16_t bs[kScalarLoads];
};

// Loads the K step at k0 into registers, zero past the edges.
template <bool kVec>
__device__ __forceinline__ void load_step(const uint16_t* __restrict__ A,
                                          const uint16_t* __restrict__ B, int M, int N,
                                          int K, int m0, int n0, int k0, Staged& st) {
  const int t = threadIdx.x;
  if (kVec) {
#pragma unroll
    for (int i = 0; i < kVecLoads; ++i) {
      const int v = t + i * kThreads;
      const int ar = v / (kBK / 8), ac = (v % (kBK / 8)) * 8;
      const int gr = m0 + ar, gc = k0 + ac;
      st.a[i] = (gr < M && gc < K)
                    ? *reinterpret_cast<const uint4*>(A + static_cast<size_t>(gr) * K + gc)
                    : make_uint4(0, 0, 0, 0);
      const int br = v / (kBN / 8), bc = (v % (kBN / 8)) * 8;
      const int hr = k0 + br, hc = n0 + bc;
      st.b[i] = (hr < K && hc < N)
                    ? *reinterpret_cast<const uint4*>(B + static_cast<size_t>(hr) * N + hc)
                    : make_uint4(0, 0, 0, 0);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kScalarLoads; ++i) {
      const int e = t + i * kThreads;
      const int ar = e / kBK, ac = e % kBK;
      const int gr = m0 + ar, gc = k0 + ac;
      st.as[i] = (gr < M && gc < K) ? A[static_cast<size_t>(gr) * K + gc] : 0;
      const int br = e / kBN, bc = e % kBN;
      const int hr = k0 + br, hc = n0 + bc;
      st.bs[i] = (hr < K && hc < N) ? B[static_cast<size_t>(hr) * N + hc] : 0;
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void store_step(const Staged& st, uint16_t* sA, uint16_t* sB) {
  const int t = threadIdx.x;
  if (kVec) {
#pragma unroll
    for (int i = 0; i < kVecLoads; ++i) {
      const int v = t + i * kThreads;
      *reinterpret_cast<uint4*>(sA + (v / (kBK / 8)) * kLdA + (v % (kBK / 8)) * 8) = st.a[i];
      *reinterpret_cast<uint4*>(sB + (v / (kBN / 8)) * kLdB + (v % (kBN / 8)) * 8) = st.b[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < kScalarLoads; ++i) {
      const int e = t + i * kThreads;
      sA[(e / kBK) * kLdA + e % kBK] = st.as[i];
      sB[(e / kBN) * kLdB + e % kBN] = st.bs[i];
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const uint16_t* __restrict__ A, const uint16_t* __restrict__ B,
              float* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(32) uint16_t sA[kBM * kLdA];
  __shared__ __align__(32) uint16_t sB[kBK * kLdB];
  __shared__ __align__(32) float sOut[kThreads / 32][16 * 16];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFragM][kFragN];
#pragma unroll
  for (int i = 0; i < kFragM; ++i)
#pragma unroll
    for (int j = 0; j < kFragN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  Staged st;
  load_step<kVec>(A, B, M, N, K, m0, n0, 0, st);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the previous step's fragments are loaded
    store_step<kVec>(st, sA, sB);
    __syncthreads();
    if (k0 + kBK < K) load_step<kVec>(A, B, M, N, K, m0, n0, k0 + kBK, st);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[kFragM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[kFragN];
#pragma unroll
      for (int i = 0; i < kFragM; ++i)
        wmma::load_matrix_sync(
            fa[i], reinterpret_cast<const __nv_bfloat16*>(sA + (wm * kWarpM + i * 16) * kLdA + kk),
            kLdA);
#pragma unroll
      for (int j = 0; j < kFragN; ++j)
        wmma::load_matrix_sync(
            fb[j], reinterpret_cast<const __nv_bfloat16*>(sB + kk * kLdB + wn * kWarpN + j * 16),
            kLdB);
#pragma unroll
      for (int i = 0; i < kFragM; ++i)
#pragma unroll
        for (int j = 0; j < kFragN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }

  // Epilogue: each fragment through the warp's scratch, guarded stores.
  float* scratch = sOut[warp];
#pragma unroll
  for (int i = 0; i < kFragM; ++i) {
#pragma unroll
    for (int j = 0; j < kFragN; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r0 = m0 + wm * kWarpM + i * 16, c0 = n0 + wn * kWarpN + j * 16;
#pragma unroll
      for (int e = lane; e < 256; e += 32) {
        const int r = r0 + e / 16, c = c0 + e % 16;
        if (r < M && c < N) C[static_cast<size_t>(r) * N + c] = scratch[e];
      }
      __syncwarp();
    }
  }
}

// ------------------------------------------------------------------ sm90
namespace sm90 {

constexpr int kBM = 128;
constexpr int kBN = 256;
constexpr int kBK = 64;                 // one 128-byte swizzle row of bf16
constexpr int kStages = 4;
constexpr int kConsumers = 2;           // warpgroups, 64 rows of the tile each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kGroupM = 8;              // tile rows per raster group
constexpr int kSlabN = 64;              // N width of one B slab (128 bytes)
constexpr int kATileBytes = kBM * kBK * 2;             // 16 KB
constexpr int kBSlabBytes = kBK * kSlabN * 2;          // 8 KB
constexpr int kBTileBytes = kBSlabBytes * (kBN / kSlabN);  // 32 KB
constexpr int kStageBytes = kATileBytes + kBTileBytes;     // 48 KB
constexpr int kBarrierBytes = 2 * kStages * 8;
// The ring, its barriers, and slack to align the ring to 1024 bytes (the
// 128-byte swizzle's period).
constexpr int kSmemBytes = kStages * kStageBytes + kBarrierBytes + 1024;
constexpr int kAccum = kBN / 2;          // f32 accumulators a consumer thread

// Matrix descriptor fields that do not depend on the address: the
// 128-byte swizzle (layout type 1, bits 62-63) and the leading and stride
// byte offsets in 16-byte units (bits 16-29 and 32-45).
constexpr uint64_t desc_bits(uint32_t lbo_bytes, uint32_t sbo_bytes) {
  return (1ull << 62) | (static_cast<uint64_t>(sbo_bytes >> 4) << 32) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16);
}
// A, K-major: 8-row groups 1024 bytes apart; the leading offset is unused
// under the swizzle (1 by convention).
constexpr uint64_t kDescA = desc_bits(16, 1024);
// B, N-major: 64-wide N slabs kBSlabBytes apart (leading), groups of 8 K
// rows 1024 bytes apart (stride).
constexpr uint64_t kDescB = desc_bits(kBSlabBytes, 1024);

__device__ __forceinline__ uint64_t desc(uint64_t bits, uint32_t smem_addr) {
  return bits | static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// One TMA tile load (coordinates innermost first) that completes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_accum(float (&d)[kAccum]) {
#pragma unroll
  for (int i = 0; i < kAccum; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64x256, f32) += A (64x16, K-major) · B (16x256, N-major): scale-d
// 1 (accumulate), A not transposed, B transposed.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[kAccum], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %130, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void tile_coords(int t, int num_m, int num_n, int& mt, int& nt) {
  const int per_group = kGroupM * num_n;
  const int first = (t / per_group) * kGroupM;
  const int rows = min(num_m - first, kGroupM);
  const int local = t % per_group;
  mt = first + local % rows;
  nt = local / rows;
}

__global__ void __launch_bounds__(kThreads, 1)
matmul_kernel(const __grid_constant__ CUtensorMap map_a,
              const __grid_constant__ CUtensorMap map_b, float* __restrict__ C, int M, int N,
              int K) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) &
                        ~1023u;
  const uint32_t full_bar = ring + kStages * kStageBytes;  // + 8 s: stage s loaded
  const uint32_t empty_bar = full_bar + kStages * 8;       // + 8 s: stage s consumed
  const int num_m = (M + kBM - 1) / kBM, num_n = (N + kBN - 1) / kBN;
  const int num_tiles = num_m * num_n;
  const int k_steps = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer: one thread walks the same (tile, K step) sequence as the
    // consumers and keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == kConsumers * 128) {
      uint32_t it = 0;
      for (int t = blockIdx.x; t < num_tiles; t += gridDim.x) {
        int mt, nt;
        tile_coords(t, num_m, num_n, mt, nt);
        for (int k = 0; k < k_steps; ++k, ++it) {
          const uint32_t s = it % kStages;
          mbar_wait(empty_bar + 8 * s, ((it / kStages) & 1) ^ 1);
          const uint32_t a_dst = ring + s * kStageBytes;
          const uint32_t b_dst = a_dst + kATileBytes;
          mbar_expect_tx(full_bar + 8 * s, kStageBytes);
          tma_load(a_dst, &map_a, full_bar + 8 * s, k * kBK, mt * kBM);
#pragma unroll
          for (int j = 0; j < kBN / kSlabN; ++j)
            tma_load(b_dst + j * kBSlabBytes, &map_b, full_bar + 8 * s,
                     nt * kBN + j * kSlabN, k * kBK);
        }
      }
    }
  } else {
    // Consumers: warpgroup wg multiplies rows [64 wg, 64 wg + 64) of each
    // tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const bool leader = threadIdx.x % 128 == 0;
    float d[kAccum];
    uint32_t it = 0;
    for (int t = blockIdx.x; t < num_tiles; t += gridDim.x) {
      int mt, nt;
      tile_coords(t, num_m, num_n, mt, nt);
#pragma unroll
      for (int i = 0; i < kAccum; ++i) d[i] = 0.0f;
      uint32_t prev = 0;
      for (int k = 0; k < k_steps; ++k, ++it) {
        const uint32_t s = it % kStages;
        mbar_wait(full_bar + 8 * s, (it / kStages) & 1);
        const uint32_t a_src = ring + s * kStageBytes + wg * (64 * kBK * 2);
        const uint32_t b_src = ring + s * kStageBytes + kATileBytes;
        fence_accum(d);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          // K advances 32 bytes inside A's swizzled rows and 16 rows
          // (2 KB) down B's slabs.
          wgmma_m64n256k16(d, desc(kDescA, a_src + 32 * kk), desc(kDescB, b_src + 2048 * kk));
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        fence_accum(d);
        // The previous step's products are done: release its stage.
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        fence_accum(d);
        if (k > 0 && leader) mbar_arrive(empty_bar + 8 * prev);
        prev = s;
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_accum(d);
      if (leader) mbar_arrive(empty_bar + 8 * prev);

      // Accumulator layout of m64nNk16: warp w holds rows 16 w + lane / 4
      // (d[4 j], d[4 j + 1]) and 8 rows below (d[4 j + 2], d[4 j + 3]),
      // at columns 8 j + 2 (lane % 4) and the one after.
      const int row = mt * kBM + wg * 64 + warp * 16 + lane / 4;
      const int col0 = nt * kBN + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = col0 + 8 * j;
        if (col < N) {
          if (row < M)
            __stcs(reinterpret_cast<float2*>(C + static_cast<size_t>(row) * N + col),
                   make_float2(d[4 * j], d[4 * j + 1]));
          if (row + 8 < M)
            __stcs(reinterpret_cast<float2*>(C + static_cast<size_t>(row + 8) * N + col),
                   make_float2(d[4 * j + 2], d[4 * j + 3]));
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which the runtime has already loaded.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major (rows, cols) bf16 matrix read in (box_rows, 64) boxes with
// the 128-byte swizzle and zero fill past its edges.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, int rows, int cols,
            int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

int num_sms() {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cached <= 0)
      cached = 132;
  }
  return cached;
}

}  // namespace sm90
}  // namespace

extern "C" {

// C (M, N) f32 = A (M, K) bf16 · B (K, N) bf16, all row-major and
// contiguous, by the `wmma` kernel (any shape). Launches on `stream`;
// returns cudaGetLastError() (0 = ok).
int gr_matmul(const void* a, const void* b, void* c, int m, int n, int k, void* stream) {
  if (m < 1 || n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const uint16_t* A = static_cast<const uint16_t*>(a);
  const uint16_t* B = static_cast<const uint16_t*>(b);
  float* C = static_cast<float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = k % 8 == 0 && n % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (vec)
    matmul_kernel<true><<<grid, kThreads, 0, s>>>(A, B, C, m, n, k);
  else
    matmul_kernel<false><<<grid, kThreads, 0, s>>>(A, B, C, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// The same product by the wgmma + TMA kernel. Needs k and n multiples of 8
// and a, b 16-byte aligned (TMA's global strides and bases); returns
// cudaErrorInvalidValue otherwise, and cudaErrorNotSupported if the
// tensor maps cannot be encoded.
int gr_matmul_sm90(const void* a, const void* b, void* c, int m, int n, int k, void* stream) {
  if (m < 1 || n < 1 || k < 1 || k % 8 != 0 || n % 8 != 0 ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 || reinterpret_cast<uintptr_t>(b) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const sm90::EncodeTiled fn = sm90::encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map_a, map_b;
  if (!sm90::encode(fn, &map_a, a, m, k, sm90::kBM) ||
      !sm90::encode(fn, &map_b, b, k, n, sm90::kBK))
    return static_cast<int>(cudaErrorNotSupported);
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(sm90::matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sm90::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const long long tiles = static_cast<long long>((m + sm90::kBM - 1) / sm90::kBM) *
                          ((n + sm90::kBN - 1) / sm90::kBN);
  const int grid = static_cast<int>(tiles < sm90::num_sms() ? tiles : sm90::num_sms());
  sm90::matmul_kernel<<<grid, sm90::kThreads, sm90::kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(map_a, map_b,
                                                              static_cast<float*>(c), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

const char* gr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
