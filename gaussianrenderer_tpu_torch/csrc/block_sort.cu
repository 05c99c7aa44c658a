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
// order alone. So only (key, in-run index) pairs go through the network;
// then each output column gathers its 9 int64 words from the input column
// the network put there. The key is compared as the u32 in the low word of
// its int64, never packed with the index (that would break ties by index,
// another network's result).
//
// What bounds it on the card: bytes. Every column is read once and written
// once (144 bytes as int64), against one compare and a few selects per pair
// and substage.
//
// Design. A thread keeps E = 8 consecutive (key, index) pairs in
// registers. A substage at distance d < 8 runs in the thread's registers;
// 8 <= d < 256 (partners in one warp) through __shfl_xor_sync, with no
// barrier; only d >= 256 goes through shared memory, one barrier a
// substage (13 barriers for the network at run 2048, against one for each
// of its 66 substages). A block holds up to 8192 pairs (1024 threads, 64 KB of
// shared memory, 96 KB with the gather's row buffer). A longer run first sorts
// its 8192-pair segments in blocks, then takes each later stage's
// substages at d >= 8192 as global passes over the pairs, stored as
// (key << 32 | index) words (storage only), and the substages below in a
// block again; so any power of two >= 256 runs, in 1 + sum over the later
// stages k of (k - 12) launches. The last launch gathers the 9 rows by the
// final index and writes them coalesced: where the block holds whole runs
// it first stages each row of its segment in shared memory with coalesced
// loads (random 8-byte reads from device memory cost whole sectors);
// longer runs gather from device memory, one row at a time so that the
// run's source columns stay in L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 9;
constexpr int kE = 8;          // pairs a thread
constexpr int kLogE = 3;
constexpr int kLogWarp = 8;    // log2(32 * kE): wider substages use shared memory
constexpr int kMaxThreads = 1024;
constexpr int kMaxSeg = kMaxThreads * kE;  // pairs a block
constexpr int kLogMaxSeg = 13;
constexpr int kMinSeg = 2048;  // shorter runs share a block
constexpr unsigned kFull = 0xFFFFFFFFu;

struct SortArgs {
  const long long* x;
  long long* out;
  unsigned long long* pairs;  // runs above kMaxSeg: (key << 32 | index) per column
  long long c;
  unsigned mask;  // run - 1
  int seg;        // pairs a block
  int k_lo, k_hi; // stages this launch runs
  int j_top;      // highest substage of a stage this launch runs
};

__device__ __forceinline__ bool out_of_order(bool asc, uint32_t klo, uint32_t khi) {
  return asc ? klo > khi : klo < khi;
}

// Substage J < kLogE inside the thread's registers. in0 is the in-run index
// of the thread's first pair.
template <int J>
__device__ __forceinline__ void reg_substage(uint32_t (&key)[kE], uint32_t (&idx)[kE],
                                             uint32_t in0, int k) {
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    if (e & (1 << J)) continue;
    const int h = e | (1 << J);
    const bool asc = (((in0 + e) >> k) & 1u) == 0u;
    if (out_of_order(asc, key[e], key[h])) {
      const uint32_t tk = key[e], ti = idx[e];
      key[e] = key[h];
      idx[e] = idx[h];
      key[h] = tk;
      idx[h] = ti;
    }
  }
}

// Substage j (kLogE <= j < kLogWarp): partner pairs in lane ^ 2^(j-3), same slot.
__device__ __forceinline__ void shfl_substage(uint32_t (&key)[kE], uint32_t (&idx)[kE],
                                              uint32_t in0, int k, int j) {
  const int s = 1 << (j - kLogE);
  const bool lower = ((threadIdx.x & 31) & s) == 0;
  const bool asc = ((in0 >> k) & 1u) == 0u;  // k > j >= 3: the same for all 8 slots
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const uint32_t pk = __shfl_xor_sync(kFull, key[e], s);
    const uint32_t pi = __shfl_xor_sync(kFull, idx[e], s);
    const uint32_t klo = lower ? key[e] : pk, khi = lower ? pk : key[e];
    if (out_of_order(asc, klo, khi)) {
      key[e] = pk;
      idx[e] = pi;
    }
  }
}

// Substage j >= kLogWarp on the block's pairs in shared memory.
__device__ __forceinline__ void smem_substage(uint32_t* s_key, uint32_t* s_idx,
                                              const SortArgs& a, long long seg0, int k,
                                              int j) {
  const int d = 1 << j;
  for (int p = threadIdx.x; p < a.seg / 2; p += blockDim.x) {
    const int lo = ((p >> j) << (j + 1)) | (p & (d - 1));
    const int hi = lo + d;
    const bool asc = (((static_cast<uint32_t>(seg0 + lo) & a.mask) >> k) & 1u) == 0u;
    const uint32_t klo = s_key[lo], khi = s_key[hi];
    if (out_of_order(asc, klo, khi)) {
      s_key[lo] = khi;
      s_key[hi] = klo;
      const uint32_t t = s_idx[lo];
      s_idx[lo] = s_idx[hi];
      s_idx[hi] = t;
    }
  }
}

__device__ __forceinline__ void regs_to_smem(uint32_t* s, const uint32_t (&v)[kE]) {
  uint4* d = reinterpret_cast<uint4*>(s + threadIdx.x * kE);
  d[0] = make_uint4(v[0], v[1], v[2], v[3]);
  d[1] = make_uint4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void smem_to_regs(const uint32_t* s, uint32_t (&v)[kE]) {
  const uint4* d = reinterpret_cast<const uint4*>(s + threadIdx.x * kE);
  const uint4 a = d[0], b = d[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Stages k_lo..k_hi (from substage j_top down) of the block's segment of
// seg pairs. FROM_X: the keys come from x's row 0 and the indices are the
// in-run positions; else both come from `pairs`. GATHER: write the 9 rows
// of `out` by the final index; else store the pairs.
template <bool FROM_X, bool GATHER>
__global__ void __launch_bounds__(kMaxThreads) sort_block(const SortArgs a) {
  // [seg] u32 indices, then [seg] u64: the keys while sorting, one row of
  // the segment while gathering.
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* s_idx = smem;
  uint32_t* s_key = smem + a.seg;
  const long long seg0 = static_cast<long long>(blockIdx.x) * a.seg;
  const long long g0 = seg0 + static_cast<long long>(threadIdx.x) * kE;
  const bool valid = g0 < a.c;  // c is a multiple of 256: whole threads
  const uint32_t in0 = static_cast<uint32_t>(g0) & a.mask;
  uint32_t key[kE], idx[kE];

  if (FROM_X) {
    for (int i = threadIdx.x; i < a.seg; i += blockDim.x) {
      const long long g = seg0 + i;
      s_key[i] = g < a.c ? static_cast<uint32_t>(a.x[g]) : 0u;
    }
    __syncthreads();
    smem_to_regs(s_key, key);
#pragma unroll
    for (int e = 0; e < kE; ++e) idx[e] = in0 + e;
  } else {
    const ulonglong2* src = reinterpret_cast<const ulonglong2*>(a.pairs + g0);
#pragma unroll
    for (int q = 0; q < kE / 2; ++q) {
      const ulonglong2 v = valid ? src[q] : make_ulonglong2(0ull, 0ull);
      key[2 * q] = static_cast<uint32_t>(v.x >> 32);
      idx[2 * q] = static_cast<uint32_t>(v.x);
      key[2 * q + 1] = static_cast<uint32_t>(v.y >> 32);
      idx[2 * q + 1] = static_cast<uint32_t>(v.y);
    }
  }

  for (int k = a.k_lo; k <= a.k_hi; ++k) {
    const int jtop = min(k - 1, a.j_top);
    if (jtop >= kLogWarp) {
      __syncthreads();  // earlier readers of the shared pairs are done
      regs_to_smem(s_key, key);
      regs_to_smem(s_idx, idx);
      __syncthreads();
      for (int j = jtop; j >= kLogWarp; --j) {
        smem_substage(s_key, s_idx, a, seg0, k, j);
        __syncthreads();
      }
      smem_to_regs(s_key, key);
      smem_to_regs(s_idx, idx);
    }
    for (int j = min(jtop, kLogWarp - 1); j >= kLogE; --j) shfl_substage(key, idx, in0, k, j);
    if (jtop >= 2) reg_substage<2>(key, idx, in0, k);
    if (jtop >= 1) reg_substage<1>(key, idx, in0, k);
    if (jtop >= 0) reg_substage<0>(key, idx, in0, k);
  }

  if (GATHER) {
    __syncthreads();
    regs_to_smem(s_idx, idx);
    const long long run_mask = a.mask;
    if (run_mask < a.seg) {
      // Whole runs in the block: stage each row of the segment with
      // coalesced loads, gather it from shared memory, write coalesced.
      long long* s_row = reinterpret_cast<long long*>(s_key);
      const int n = static_cast<int>(min(static_cast<long long>(a.seg), a.c - seg0));
#pragma unroll 1
      for (int r = 0; r < kRows; ++r) {
        __syncthreads();  // the previous row's readers are done
        const long long* xr = a.x + r * a.c + seg0;
        for (int i = threadIdx.x; i < n; i += blockDim.x) s_row[i] = __ldg(xr + i);
        __syncthreads();
        long long* outr = a.out + r * a.c + seg0;
        for (int i = threadIdx.x; i < n; i += blockDim.x)
          outr[i] = s_row[(i & ~static_cast<int>(run_mask)) + s_idx[i]];
      }
    } else {
      __syncthreads();
#pragma unroll 1
      for (int r = 0; r < kRows; ++r) {
        const long long* xr = a.x + r * a.c;
        long long* outr = a.out + r * a.c;
        for (int i = threadIdx.x; i < a.seg; i += blockDim.x) {
          const long long g = seg0 + i;
          if (g >= a.c) break;
          outr[g] = __ldg(xr + ((g & ~run_mask) + s_idx[i]));
        }
      }
    }
  } else if (valid) {
    ulonglong2* dst = reinterpret_cast<ulonglong2*>(a.pairs + g0);
#pragma unroll
    for (int q = 0; q < kE / 2; ++q)
      dst[q] = make_ulonglong2(
          (static_cast<unsigned long long>(key[2 * q]) << 32) | idx[2 * q],
          (static_cast<unsigned long long>(key[2 * q + 1]) << 32) | idx[2 * q + 1]);
  }
}

// One substage j (2^j >= a block's pairs) of stage k over all pairs.
__global__ void sort_global(unsigned long long* __restrict__ pairs, long long half,
                            unsigned mask, int k, int j) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= half) return;
  const long long d = 1ll << j;
  const long long lo = ((p >> j) << (j + 1)) | (p & (d - 1));
  const long long hi = lo + d;
  const bool asc = (((static_cast<uint32_t>(lo) & mask) >> k) & 1u) == 0u;
  const unsigned long long vlo = pairs[lo], vhi = pairs[hi];
  if (out_of_order(asc, static_cast<uint32_t>(vlo >> 32), static_cast<uint32_t>(vhi >> 32))) {
    pairs[lo] = vhi;
    pairs[hi] = vlo;
  }
}

template <bool FROM_X, bool GATHER>
cudaError_t launch_block(const SortArgs& a, unsigned blocks, cudaStream_t stream) {
  // 8 bytes a pair, 12 where the gather stages rows of whole runs.
  const bool staged = GATHER && static_cast<int>(a.mask) < a.seg;
  const int smem = a.seg * (staged ? 12 : 8);
  // Above 48 KB a launch is refused unless the kernel is allowed more.
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sort_block<FROM_X, GATHER>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  sort_block<FROM_X, GATHER><<<blocks, a.seg / kE, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out = each `run` block of x (9, c) int64, row-major, sorted by the low
// 32 bits of row 0 as u32 with the bitonic network. run a power of two in
// [256, 2^30], c a multiple of run; x and out must not overlap. Runs above
// 8192 need `pairs`, c u64 of scratch (else null). Launches on `stream`,
// counts its launches in *launches, and returns cudaGetLastError() of the
// first failing launch (0 = ok).
int gr_block_sort(const void* x, void* out, void* pairs, long long c, int run, void* stream,
                  int* launches) {
  *launches = 0;
  if (run < 256 || run > (1 << 30) || (run & (run - 1)) != 0 || c < 0 || c % run != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (c == 0) return 0;
  if (run > kMaxSeg && pairs == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int log_run = 0;
  while ((1 << log_run) < run) ++log_run;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SortArgs a;
  a.x = static_cast<const long long*>(x);
  a.out = static_cast<long long*>(out);
  a.pairs = static_cast<unsigned long long*>(pairs);
  a.c = c;
  a.mask = static_cast<unsigned>(run - 1);
  a.seg = run > kMaxSeg ? kMaxSeg : (run < kMinSeg ? kMinSeg : run);
  a.k_lo = 1;
  a.j_top = 31;
  const unsigned blocks = static_cast<unsigned>((c + a.seg - 1) / a.seg);
  cudaError_t err;
  if (run <= kMaxSeg) {
    a.k_hi = log_run;
    err = launch_block<true, true>(a, blocks, s);
    ++*launches;
    return static_cast<int>(err);
  }
  a.k_hi = kLogMaxSeg;
  err = launch_block<true, false>(a, blocks, s);
  ++*launches;
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long half = c / 2;
  const unsigned gblocks = static_cast<unsigned>((half + 255) / 256);
  for (int k = kLogMaxSeg + 1; k <= log_run; ++k) {
    for (int j = k - 1; j >= kLogMaxSeg; --j) {
      sort_global<<<gblocks, 256, 0, s>>>(a.pairs, half, a.mask, k, j);
      ++*launches;
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    a.k_lo = a.k_hi = k;
    a.j_top = kLogMaxSeg - 1;
    err = k == log_run ? launch_block<false, true>(a, blocks, s)
                       : launch_block<false, false>(a, blocks, s);
    ++*launches;
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

const char* gr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
