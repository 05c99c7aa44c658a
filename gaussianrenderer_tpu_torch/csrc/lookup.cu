// Small-table lookup for Hopper (sm_90a).
//
// Replaces the TPU kernel gaussianrenderer_tpu/ops/pallas/lookup.py
// `_lookup_kernel` (reached by `table_lookup`), which reads a table of at
// most r*q entries without gathers, as a one-hot MXU matmul. Same function:
//
//   out[n] = f32(bf16_rne(table[clip(idx[n], 0, M - 1)]))
//
// On the card a gather is cheap, so the kernel is a gather from shared
// memory: each block stages the whole table, rounded to bf16 (the TPU
// kernel's table type, so every read returns the same value), and then
// walks its share of the indices.
//
// What bounds it on the card: bytes. Each index is read once (4 or 8
// bytes) and each output written once (4 bytes); there is no arithmetic
// to speak of. At the culled 1080p frame's 3M int32 indices that is 24 MB,
// 7.2 us at 3.35 TB/s, so two other costs matter as much as the stream:
// staging the table (43.6 KB of f32 from L2 for a 1080p pyramid) in every
// block, and keeping enough bytes in flight to cover HBM's latency. What
// the design does about them:
//
// - one block of 1024 threads per SM, so the table is staged once per SM
//   (132 times), not once per 512 threads;
// - each thread issues its first kUnroll index loads before it stages the
//   table, so they are in flight while it does;
// - the table is staged with 16-byte f32 loads, converted to bf16 pairs
//   on the way into shared memory;
// - the main loop moves 16 bytes of indices a thread per step (4 int32 or
//   2 int64, read-only loads that do not allocate in L1), kUnroll steps a
//   thread at a time with the next kUnroll already loading, and stores 16
//   or 8 bytes of output at once;
// - a head of up to 3 indices before the first 16-byte boundary (a slice
//   of a larger tensor can start anywhere) and the tail past the last
//   whole vector are done one element at a time; where the output at the
//   head's end is not aligned for a vector store, the vectors' outputs
//   are stored one element at a time too.
//
// Indices arrive as int32 (the pyramid samples of satcull.rect_cutoff) or
// int64 (the per-position tile ids of instance emission); both widths are
// instantiated, so neither caller pays a cast pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kBlocksPerSm = 1;
// 16-byte index vectors a thread has loading at once (4 and 8 ran slower
// on the H100 at the culled 1080p frame's 3M int32 indices).
constexpr int kUnroll = 2;
// Largest table the kernel stages: 227 KB of shared memory as bf16. A
// 4096x4096 frame's pyramid has 87,381 entries.
constexpr long long kMaxEntries = 232448 / 2;

// 16 bytes of indices: 4 int32 or 2 int64.
template <typename Index>
struct Vec {
  static constexpr int kN = 16 / sizeof(Index);
  Index v[kN];
};

__device__ __forceinline__ Vec<int32_t> load_vec(const int32_t* p) {
  Vec<int32_t> r;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.v[0]), "=r"(r.v[1]), "=r"(r.v[2]), "=r"(r.v[3])
      : "l"(p));
  return r;
}

__device__ __forceinline__ Vec<long long> load_vec(const long long* p) {
  Vec<long long> r;
  asm("ld.global.nc.L1::no_allocate.v2.s64 {%0, %1}, [%2];"
      : "=l"(r.v[0]), "=l"(r.v[1])
      : "l"(p));
  return r;
}

template <typename Index>
__device__ __forceinline__ float look(const __nv_bfloat16* s_tab, Index k, int m) {
  k = k < 0 ? 0 : (k >= m ? m - 1 : k);
  return __bfloat162float(s_tab[k]);
}

__device__ __forceinline__ void store_vec(float* out, const float (&f)[4], bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(out) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = f[i];
  }
}

__device__ __forceinline__ void store_vec(float* out, const float (&f)[2], bool vec) {
  if (vec) {
    *reinterpret_cast<float2*>(out) = make_float2(f[0], f[1]);
  } else {
    out[0] = f[0];
    out[1] = f[1];
  }
}

template <typename Index>
__device__ __forceinline__ void emit(const __nv_bfloat16* s_tab, int m, const Vec<Index>& x,
                                     float* out, bool vec) {
  float f[Vec<Index>::kN];
#pragma unroll
  for (int i = 0; i < Vec<Index>::kN; ++i) f[i] = look(s_tab, x.v[i], m);
  store_vec(out, f, vec);
}

// The table into shared memory as bf16 (round to nearest even), 4 entries
// a thread at a time where it is 16-byte aligned.
__device__ __forceinline__ void stage_table(const float* __restrict__ table, int m,
                                            __nv_bfloat16* s_tab) {
  int done = 0;
  if (reinterpret_cast<uintptr_t>(table) % 16 == 0) {
    const float4* t4 = reinterpret_cast<const float4*>(table);
    done = m / 4 * 4;
    for (int i = threadIdx.x; i < m / 4; i += blockDim.x) {
      const float4 f = __ldg(t4 + i);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(f.x, f.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(f.z, f.w);
      uint2 packed;
      packed.x = reinterpret_cast<const uint32_t&>(lo);
      packed.y = reinterpret_cast<const uint32_t&>(hi);
      reinterpret_cast<uint2*>(s_tab)[i] = packed;
    }
  }
  for (int i = done + threadIdx.x; i < m; i += blockDim.x)
    s_tab[i] = __float2bfloat16_rn(table[i]);
}

// idx + head is 16-byte aligned; vectors [0, nv) start there; out_vec
// says whether out + head is aligned for the vectors' stores.
template <typename Index>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
lookup_kernel(const float* __restrict__ table, int m, const Index* __restrict__ idx,
              long long n, float* __restrict__ out, int head, long long nv, bool out_vec) {
  constexpr int kN = Vec<Index>::kN;
  extern __shared__ __align__(16) __nv_bfloat16 s_tab[];
  const Index* vidx = idx + head;
  float* vout = out + head;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;

  // This thread's first kUnroll vectors load while the table is staged.
  Vec<Index> cur[kUnroll] = {};
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    if (v + u * stride < nv) cur[u] = load_vec(vidx + (v + u * stride) * kN);
  stage_table(table, m, s_tab);
  __syncthreads();

  if (blockIdx.x == 0) {
    const long long tail = head + nv * kN;
    if (threadIdx.x < head) out[threadIdx.x] = look(s_tab, idx[threadIdx.x], m);
    if (threadIdx.x < n - tail) out[tail + threadIdx.x] = look(s_tab, idx[tail + threadIdx.x], m);
  }
  for (; v < nv; v += kUnroll * stride) {
    Vec<Index> next[kUnroll] = {};
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long w = v + (kUnroll + u) * stride;
      if (w < nv) next[u] = load_vec(vidx + w * kN);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long w = v + u * stride;
      if (w < nv) emit(s_tab, m, cur[u], vout + w * kN, out_vec);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = next[u];
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
  constexpr int kN = Vec<Index>::kN;
  // Raised once to the largest table, so no launch pays the call again.
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(lookup_kernel<Index>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxEntries * sizeof(__nv_bfloat16)));
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const uintptr_t addr = reinterpret_cast<uintptr_t>(idx);
  long long head = static_cast<long long>((16 - addr % 16) % 16) / sizeof(Index);
  if (head > n) head = n;
  const long long nv = (n - head) / kN;
  const bool out_vec = reinterpret_cast<uintptr_t>(out + head) % (kN * sizeof(float)) == 0;
  long long blocks = (nv + kUnroll * kThreads - 1) / (kUnroll * kThreads);
  if (blocks > num_sms() * kBlocksPerSm) blocks = num_sms() * kBlocksPerSm;
  if (blocks < 1) blocks = 1;
  lookup_kernel<Index><<<static_cast<int>(blocks), kThreads, m * sizeof(__nv_bfloat16), stream>>>(
      table, m, idx, n, out, static_cast<int>(head), nv, out_vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out[n] = f32(bf16_rne(table[clip(idx[n], 0, m - 1)])) for n < N. table is
// (m,) f32, idx (N,) int32 (idx_bytes 4) or int64 (idx_bytes 8), out (N,)
// f32, all on the current card. Launches on `stream`; returns
// cudaGetLastError() (0 = ok).
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
