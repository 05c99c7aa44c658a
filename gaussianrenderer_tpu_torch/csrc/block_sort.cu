// Bitonic block sort for Hopper (sm_90a): each `run`-sized block of a
// (9, C) matrix of u32 values held in int64 sorted by row 0, the 8 payload
// rows following their key.
//
// Replaces the TPU kernel gaussianrenderer_tpu/ops/pallas/block_sort.py
// `_block_sort_kernel` (reached by `block_sort_runs`). Same network, same
// result bit for bit: stage k = 1 .. log2(run), substage j = k-1 .. 0,
// partner at XOR distance 2^j, ascending iff bit k of the in-run index is
// 0, and a pair swaps only when its keys are strictly out of order. On
// equal keys both elements keep their own rows, which is the TPU kernel's
// tie rule (`take_self` with <= and >=); the network is not stable, and
// with this rule its output, payloads included, is fixed by the keys'
// order alone.
//
// One block per run. The TPU kernel pairs lanes with two rolls and a select
// over whole vregs; here a thread owns a compare-exchange pair per
// substage, and the substages are separated by __syncthreads(). Since the
// swaps depend on the keys alone, only (key, in-run index) pairs go through
// the network, in shared memory (8 bytes a column, 131,072 bytes at run
// 16384); then each output column gathers its 9 int64 words from the input
// column the network put there. The key is compared as the u32 in the low
// word of its int64. Runs above 16384 do not fit the 227 KB a block may
// use and are refused.
//
// What bounds it on the card: bytes. Every column is read once and written
// once (144 bytes as int64), against one compare and a few selects per pair
// and substage. The keys are read once, coalesced; the payload gather reads
// within the run's own columns, which stay in L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 9;
constexpr int kMaxThreads = 1024;
constexpr int kMaxRun = 16384;

__global__ void __launch_bounds__(kMaxThreads)
block_sort_kernel(const long long* __restrict__ x, long long* __restrict__ out, long long c,
                  int run, int log_run) {
  // smem[i] the key and smem[run + i] the in-run index of the column now at i.
  extern __shared__ uint32_t smem[];
  const long long base = static_cast<long long>(blockIdx.x) * run;
  for (int i = threadIdx.x; i < run; i += blockDim.x) {
    smem[i] = static_cast<uint32_t>(x[base + i]);
    smem[run + i] = static_cast<uint32_t>(i);
  }
  __syncthreads();

  const int half = run / 2;
  for (int k = 1; k <= log_run; ++k) {
    for (int j = k - 1; j >= 0; --j) {
      const int d = 1 << j;
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int lo = ((p >> j) << (j + 1)) | (p & (d - 1));
        const int hi = lo + d;
        const bool asc = ((lo >> k) & 1) == 0;
        const uint32_t klo = smem[lo], khi = smem[hi];
        if (asc ? (klo > khi) : (klo < khi)) {
          smem[lo] = khi;
          smem[hi] = klo;
          const uint32_t t = smem[run + lo];
          smem[run + lo] = smem[run + hi];
          smem[run + hi] = t;
        }
      }
      __syncthreads();
    }
  }

  for (int i = threadIdx.x; i < run; i += blockDim.x) {
    const long long src = base + smem[run + i];
#pragma unroll
    for (int r = 0; r < kRows; ++r) out[r * c + base + i] = x[r * c + src];
  }
}

}  // namespace

extern "C" {

// out = each `run` block of x (9, c) int64, row-major, sorted by the low
// 32 bits of row 0 as u32 with the bitonic network. run a power of two in
// [256, 16384], c a multiple of run; x and out must not overlap. Launches
// on `stream`; returns cudaGetLastError() (0 = ok).
int gr_block_sort(const void* x, void* out, long long c, int run, void* stream) {
  if (run < 256 || run > kMaxRun || (run & (run - 1)) != 0 || c < 0 || c % run != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (c == 0) return 0;
  int log_run = 0;
  while ((1 << log_run) < run) ++log_run;
  const int smem = run * 2 * static_cast<int>(sizeof(uint32_t));
  // Above 48 KB a launch is refused unless the kernel is allowed more.
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        block_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = run / 2 < kMaxThreads ? run / 2 : kMaxThreads;
  block_sort_kernel<<<static_cast<unsigned>(c / run), threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(x), static_cast<long long*>(out), c, run, log_run);
  return static_cast<int>(cudaGetLastError());
}

const char* gr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
