// Fixed-order segment sum for Hopper (sm_90a): the transpose of the
// training path's duplicating row gather.
//
// Replaces no TPU kernel. The JAX package transposes the gather
// `feats[gaussian_id]` (gaussianrenderer_tpu/ops/compositing.py
// `_gather_rows_seg_bwd`) in XLA: a sort by Gaussian id, one cumsum over
// the sorted cotangent rows, and each segment's sum as a difference of two
// prefixes, which loses up to 1.5e-2 of a column's largest value where one
// splat dominates. The port sums each segment directly; a scatter-add
// (`index_add_`) on the card adds with float atomics, in an order that
// changes from run to run, so a fit could not reproduce itself. This
// kernel gives one order:
//
//   out[s, c] = (((0 + rows[order[o_s], c]) + rows[order[o_s + 1], c]) + ...)
//
// over k in [offsets[s], offsets[s + 1]). The training gather passes the
// emission's own bounds and each emitted instance's sorted row (the tile
// assignment's `segment_start` and `segment_slot`), which list each
// Gaussian's rows in their index order, as a stable argsort by id would:
// the order in which the CPU's `index_add_` adds them, so the two agree
// bit for bit.
//
// What bounds it on the card: bytes. Every cotangent row is read once
// (D floats) with its 4-byte index, every segment's two bounds once, and
// every output row written once; one add per element read. Threads work
// in groups of D / 4, one group a segment, each thread owning a float4 of
// the row: at D = 16 a quad reads a whole 64-byte row in one 16-byte load
// a thread, and a warp serves 8 neighbouring segments, whose indices lie
// side by side in `order`. A thread reads its rows eight at a time, all
// eight loads in flight at once (unconditional: past the segment's end
// it reads the last row again), then adds them in the segment's order.
// But a segment's sum is one chain of adds, so the longest segment would
// set the kernel's time at one trip to memory per eight rows: at
// train-500k a splat over 300 tiles has 300 rows, and the big splats lie
// near each other in the scene's order (chip_smoke's segment_sum line
// times the kernel with every segment cut to 8 rows beside it). So at
// D = 16 a segment of more than kLong rows goes to a whole warp, which
// reads 64 of its rows a trip and hands each lane its column's values by
// shuffles, to add in the same order; blocks of their own at the head of
// the grid list the long segments of each 256 and deal them to their
// warps, so the long sums spread over many warps and start first.
// Outputs go out as float4 stores; no sum uses an atomic. A width that
// is not a multiple of 4 (or rows not 16-byte aligned) takes the scalar
// kernel: one thread a (segment, column), the same order.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kInFlight = 8;   // rows a thread reads before it adds them
constexpr int kLong = 16;      // longer segments (D = 16) go to the whole warp
constexpr int kGroups = 8;     // groups of 8 rows the warp reads a trip
constexpr int kWarpRows = 8 * kGroups;
constexpr unsigned kWarp = 0xFFFFFFFFu;

__device__ __forceinline__ void set_zero(float4& v) { v = make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
__device__ __forceinline__ void set_zero(float& v) { v = 0.0f; }

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ float4 shfl(float4 v, int src) {
  return make_float4(__shfl_sync(kWarp, v.x, src), __shfl_sync(kWarp, v.y, src),
                     __shfl_sync(kWarp, v.z, src), __shfl_sync(kWarp, v.w, src));
}

// acc += the rows order[k0..k1) of one thread's column (element c of a
// row `d` T wide), in order, kInFlight rows a trip to memory. Past k1 a
// thread loads the segment's last row again (k1 > k0), so every load is
// unconditional and all of a trip's loads are in flight at once; only
// the adds are guarded.
template <typename T>
__device__ __forceinline__ void sum_rows(const T* __restrict__ rows, int d, int c,
                                         const int* __restrict__ order, int k0, int k1,
                                         T& acc) {
  for (int k = k0; k < k1; k += kInFlight) {
    T r[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      r[u] = __ldg(rows + static_cast<long long>(__ldg(order + min(k + u, k1 - 1))) * d + c);
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      if (k + u < k1) acc = add(acc, r[u]);
  }
}

// Any width: one thread a (segment, element of T) of a row `d` T wide, T
// float4 (D / 4 of them a row) or float.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(const T* __restrict__ rows, int d, const int* __restrict__ order,
                       const int* __restrict__ offsets, int n, T* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(n) * d) return;
  const int seg = static_cast<int>(t / d);
  const int c = static_cast<int>(t - static_cast<long long>(seg) * d);
  T acc;
  set_zero(acc);
  sum_rows(rows, d, c, order, __ldg(offsets + seg), __ldg(offsets + seg + 1), acc);
  out[t] = acc;
}

// The sum of the rows order[s0..s1) in column quad q = lane % 4, by the
// whole warp: a trip reads kWarpRows rows (kGroups groups of 8, a lane the
// row lane / 4 of each group in its column), the next trip's indices
// loading beside them, and each lane adds them in the segment's order
// from its neighbours' registers. Past s1 a lane reads the last row again.
__device__ __forceinline__ float4 warp_sum(const float4* __restrict__ rows,
                                           const int* __restrict__ order, int s0, int s1,
                                           int lane) {
  const int q = lane % 4;
  float4 sum;
  set_zero(sum);
  int j[kGroups];
#pragma unroll
  for (int i = 0; i < kGroups; ++i) j[i] = __ldg(order + min(s0 + 8 * i + lane / 4, s1 - 1));
  for (int k = s0; k < s1; k += kWarpRows) {
    float4 r[kGroups];
#pragma unroll
    for (int i = 0; i < kGroups; ++i) r[i] = __ldg(rows + static_cast<long long>(j[i]) * 4 + q);
#pragma unroll
    for (int i = 0; i < kGroups; ++i)
      j[i] = __ldg(order + min(k + kWarpRows + 8 * i + lane / 4, s1 - 1));
#pragma unroll
    for (int i = 0; i < kGroups; ++i)
#pragma unroll
      for (int row = 0; row < 8; ++row) {
        const float4 v = shfl(r[i], 4 * row + q);
        if (k + 8 * i + row < s1) sum = add(sum, v);
      }
  }
  return sum;
}

// D = 16, the training gather's rows, in two kinds of block. A long
// segment's chain of adds would set the kernel's time, and long segments
// bunch (the big splats of a scene lie near each other in its order), so
// the first `long_blocks` blocks only find and sum them: a block reads
// the bounds of 256 neighbouring segments at a time (a stride over all of
// them), lists those longer than kLong in shared memory, and its 8 warps
// take the list in turns, each summing a segment with the whole warp
// (`warp_sum`). Coming first in the grid, these blocks run beside the
// first wave of the other blocks, which sum every other segment a quad at
// a time, each thread a float4 column, 8 segments a warp. Every sum keeps
// its order, so the bits do not depend on which warp takes a segment.
__global__ void __launch_bounds__(kThreads)
    segment_sum16_kernel(const float4* __restrict__ rows, const int* __restrict__ order,
                         const int* __restrict__ offsets, int n, float4* __restrict__ out,
                         int long_blocks) {
  const int lane = threadIdx.x % 32;
  if (static_cast<int>(blockIdx.x) < long_blocks) {
    constexpr int kWarps = kThreads / 32;
    __shared__ int found[kThreads];
    __shared__ int count;
    for (int base = blockIdx.x * kThreads; base < n; base += long_blocks * kThreads) {
      if (threadIdx.x == 0) count = 0;
      __syncthreads();
      const int s = base + static_cast<int>(threadIdx.x);
      if (s < n && __ldg(offsets + s + 1) - __ldg(offsets + s) > kLong)
        found[atomicAdd(&count, 1)] = s;
      __syncthreads();
      for (int e = threadIdx.x / 32; e < count; e += kWarps) {
        const int sg = found[e];
        const float4 sum = warp_sum(rows, order, __ldg(offsets + sg), __ldg(offsets + sg + 1),
                                    lane);
        if (lane < 4) out[static_cast<long long>(sg) * 4 + lane] = sum;
      }
      __syncthreads();  // the list is read before the next round writes it
    }
    return;
  }
  const long long t =
      static_cast<long long>(blockIdx.x - long_blocks) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(n) * 4) return;
  const int seg = static_cast<int>(t / 4);
  const int k0 = __ldg(offsets + seg), k1 = __ldg(offsets + seg + 1);
  if (k1 - k0 > kLong) return;  // a long block sums it
  float4 acc;
  set_zero(acc);
  sum_rows(rows, 4, lane % 4, order, k0, k1, acc);
  out[t] = acc;
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

}  // namespace

extern "C" {

// out (n, d) = per-segment sums of rows (m, d) in the order `order` (m,)
// gives, segment s being order[offsets[s]:offsets[s + 1]] (offsets (n + 1,),
// both int32). Launches on `stream`; returns cudaGetLastError() (0 = ok).
int gr_segment_sum(const float* rows, int d, const int* order, const int* offsets, int n,
                   float* out, void* stream) {
  if (d < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int width = vec ? d / 4 : d;
  const long long threads = static_cast<long long>(n) * width;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL - 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (vec && width == 4) {
    // Two long blocks an SM at most, and no more than there are segments
    // for their warps to walk.
    const long long long_blocks =
        std::min<long long>(2LL * num_sms(), (n + kThreads - 1) / kThreads);
    segment_sum16_kernel<<<static_cast<unsigned>(long_blocks + blocks), kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(rows), order, offsets, n,
        reinterpret_cast<float4*>(out), static_cast<int>(long_blocks));
  } else if (vec)
    segment_sum_kernel<float4><<<grid, kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(rows), width, order, offsets, n,
        reinterpret_cast<float4*>(out));
  else
    segment_sum_kernel<float><<<grid, kThreads, 0, s>>>(rows, width, order, offsets, n, out);
  return static_cast<int>(cudaGetLastError());
}

const char* gr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
