// Small-table lookup for Hopper (sm_90a).
//
// Replaces the TPU kernel gaussianrenderer_tpu/ops/pallas/lookup.py
// `_lookup_kernel` (reached by `table_lookup`), which reads a table of at
// most r*q entries without gathers, as a one-hot MXU matmul. Same function:
//
//   out[n] = f32(bf16_rne(table[clip(idx[n], 0, M - 1)]))
//
// On the card a gather is cheap, so the kernel is a plain gather from
// shared memory: each block stages the whole table once, rounded to bf16
// (the TPU kernel's table type, so every read returns the same value), and
// then walks its share of the indices in a grid-stride loop.
//
// What bounds it on the card: bytes. Each index is read once (4 or 8
// bytes) and each output written once (4 bytes); the table (at most a few
// hundred KB) is read once per block from L2. There is no arithmetic to
// speak of. What the design does about it: coalesced index reads and
// output writes, a table in shared memory so no read of it reaches device
// memory, and a grid of a few blocks per SM so the staging cost is paid a
// few hundred times, not once per 256 indices.
//
// Indices arrive as int32 (the pyramid samples of satcull.rect_cutoff) or
// int64 (the per-position tile ids of instance emission); both widths are
// instantiated, so neither caller pays a cast pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 4;
// Largest table the kernel stages: 227 KB of shared memory as bf16. A
// 4096x4096 frame's pyramid has 87,381 entries.
constexpr long long kMaxEntries = 232448 / 2;

template <typename Index>
__global__ void __launch_bounds__(kThreads)
lookup_kernel(const float* __restrict__ table, int m, const Index* __restrict__ idx,
              long long n, float* __restrict__ out) {
  extern __shared__ __nv_bfloat16 s_tab[];
  for (int i = threadIdx.x; i < m; i += blockDim.x) s_tab[i] = __float2bfloat16_rn(table[i]);
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    long long k = static_cast<long long>(idx[j]);
    k = k < 0 ? 0 : (k >= m ? m - 1 : k);
    out[j] = __bfloat162float(s_tab[k]);
  }
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

template <typename Index>
cudaError_t launch(const float* table, int m, const Index* idx, long long n, float* out,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(m) * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lookup_kernel<Index>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(num_sms()) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  lookup_kernel<Index><<<static_cast<int>(blocks), kThreads, smem, stream>>>(
      table, m, idx, n, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out[n] = f32(bf16_rne(table[clip(idx[n], 0, m - 1)])) for n < N. table is
// (m,) f32, idx (N,) int32 (idx_bytes 4) or int64 (idx_bytes 8), out (N,)
// f32. Launches on `stream`; returns cudaGetLastError() (0 = ok).
int gr_table_lookup(const void* table, int m, const void* idx, int idx_bytes, long long n,
                    void* out, void* stream) {
  if (m < 1 || m > kMaxEntries || n < 0 || (idx_bytes != 4 && idx_bytes != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const float* t = static_cast<const float*>(table);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 4)
    return static_cast<int>(launch<int32_t>(t, m, static_cast<const int32_t*>(idx), n, o, s));
  return static_cast<int>(launch<long long>(t, m, static_cast<const long long*>(idx), n, o, s));
}

const char* gr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
