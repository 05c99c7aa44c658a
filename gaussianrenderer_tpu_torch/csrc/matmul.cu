// Blocked bf16 GEMM for Hopper (sm_90a): C = A · B with f32 accumulation.
//
// Replaces the TPU kernel gaussianrenderer_tpu/ops/pallas/matmul.py
// `_mm_kernel` (reached by `matmul_pallas`): (M, K) · (K, N), bf16 inputs,
// f32 accumulator, f32 output. The TPU kernel walks K as the trailing grid
// dimension and carries the (bm, bn) sum in VMEM scratch from one grid
// step to the next; blocks here run in parallel and in no order, so each
// block owns one output tile and walks all of K itself.
//
// What bounds it on the card: operations. At the harness's 8192^3 it needs
// 1.1e12 multiply-adds x 2 over 989 TFLOP/s of dense bf16 (1.11 ms) against
// 537 MB over 3.35 TB/s (0.16 ms). What the design does about it: the
// products run on the tensor cores (nvcuda::wmma 16x16x16 bf16 fragments
// into f32 accumulators); a 128x128 output tile per block of 8 warps, each
// warp 32x64 (2x4 fragments), so each A and B element staged in shared
// memory feeds 4 or 2 fragments' products; the next K step's slices are
// loaded into registers while the current one is multiplied.
//
// This is the simple version: no wgmma, no TMA, no multi-stage pipeline,
// which the card's full rate needs.
//
// Edges: the A and B slices are staged through shared memory with zero
// fill past the matrix edges (wmma loads need 32-byte-aligned rows, which
// an arbitrary K or N does not give in global memory), and the output is
// written through a per-warp shared scratch with a guard on each element.
// So the kernel takes any M, N, K >= 1. Rows are read 16 bytes at a time
// when K and N are multiples of 8 and both bases are 16-byte aligned,
// else one element at a time.

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

}  // namespace

extern "C" {

// C (M, N) f32 = A (M, K) bf16 · B (K, N) bf16, all row-major and
// contiguous. Launches on `stream`; returns cudaGetLastError() (0 = ok).
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

const char* gr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
