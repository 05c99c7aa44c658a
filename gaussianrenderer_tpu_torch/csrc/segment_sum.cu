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
// over k in [offsets[s], offsets[s + 1]), where `order` is the stable
// argsort of the rows' segment ids: each segment's rows in their index
// order, the order in which the CPU's `index_add_` adds them, so the two
// agree bit for bit.
//
// What bounds it on the card: bytes. Every cotangent row is read once
// (D floats), with its 8-byte index, and every output row written once;
// one add per element read. One thread owns one (segment, column) and
// walks its segment: D neighbouring threads read one row's D neighbouring
// floats, so each step of a warp reads whole 64-byte rows (D = 16), and
// nothing is shared between threads, so nothing needs an atomic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(const float* __restrict__ rows, int d,
                       const long long* __restrict__ order,
                       const long long* __restrict__ offsets, long long n,
                       float* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n * d) return;
  const long long seg = t / d;
  const int c = static_cast<int>(t - seg * d);
  const long long k0 = offsets[seg], k1 = offsets[seg + 1];
  float acc = 0.0f;
  for (long long k = k0; k < k1; ++k) acc = __fadd_rn(acc, rows[order[k] * d + c]);
  out[t] = acc;
}

}  // namespace

extern "C" {

// out (n, d) = per-segment sums of rows (m, d) in the order `order` (m,)
// gives, segment s being order[offsets[s]:offsets[s + 1]] (offsets (n + 1,)).
// Launches on `stream`; returns cudaGetLastError() (0 = ok).
int gr_segment_sum(const float* rows, int d, const long long* order,
                   const long long* offsets, long long n, float* out, void* stream) {
  if (d < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const long long threads = n * d;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  segment_sum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(rows, d, order, offsets, n, out);
  return static_cast<int>(cudaGetLastError());
}

const char* gr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
