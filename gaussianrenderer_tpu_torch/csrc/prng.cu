// JAX's default random draw for Hopper (sm_90a): the bits, uniforms and
// standard normals of `jax.random.{bits,uniform,normal}(PRNGKey(seed),
// shape)`, bit for bit in the integer and uniform steps.
//
// Replaces no TPU kernel. The JAX package draws a densify episode's (n, 3)
// sample offsets with `jax.random.normal(jax.random.PRNGKey(seed), (n, 3),
// jnp.float32)` (gaussianrenderer_tpu/train.py `densify_step`), which XLA
// lowers to elementwise ops; the port draws the same numbers here, so one
// seed gives one fit in both packages and on both devices.
//
//   key      (k0, k1) = (0, seed mod 2^32)          (PRNGKey with x64 off)
//   counter  (x0, x1) = (i >> 32, i & 0xFFFFFFFF)   (i: row-major flat index)
//   bits     threefry2x32(key, counter), 20 rounds; out = x0 ^ x1
//   uniform  u = max(lo, (bitcast(bits >> 9 | 0x3F800000) - 1) * (1 - lo) + lo),
//            lo = nextafter(-1, 0)
//   normal   f32(sqrt 2) * erf_inv(u), XLA's f32 erf_inv polynomial:
//            w = -log1p(-u*u); w < 5 ? w - 2.5 : sqrt(w) - 3; a degree-8
//            Horner in fused multiply-adds; p * u (u * inf where |u| == 1)
//
// The bf16 normal (jax.random.normal(..., jnp.bfloat16)) takes 8 random bits
// a value, (x0 ^ x1) & 0xFF, the same mantissa trick on 7 bits with 0x3F80,
// the uniform in bf16, erf_inv in f32 rounded to bf16, and the product with
// bf16(sqrt 2) rounded to bf16.
//
// Every step but log1pf matches XLA's bit for bit; the normals stay within
// 4 ulp of JAX's. nvcc contracts `a * b + c` into an FMA unless told not to
// (`-fmad=true` is its default), which would change the uniform's bits, so
// that step is written with __fmul_rn / __fadd_rn; the Horner steps are
// explicit fmaf, as XLA's are.
//
// What bounds it on the card: operations, narrowly. The kernel reads
// nothing and writes 4 bytes (2 for bf16) a value; each value costs about
// 80 integer operations of threefry and some 30 of the uniform and erf_inv.
// One thread computes one value in registers, with `__funnelshift_l` for
// the rotations; neighbouring threads write neighbouring words.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum Mode { kBits = 0, kUniform = 1, kNormal = 2, kNormalBf16 = 3 };

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return __funnelshift_l(x, x, d);
}

// threefry2x32 with 20 rounds on the key (0, k1) and the counter of flat
// index i; returns x0 ^ x1 (jax.random.bits, partitionable threefry).
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k1, unsigned long long i) {
  const uint32_t k0 = 0u;
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  uint32_t x0 = static_cast<uint32_t>(i >> 32) + ks[0];
  uint32_t x1 = static_cast<uint32_t>(i) + ks[1];
#define GR_ROUND(r)  \
  x0 += x1;          \
  x1 = rotl(x1, r);  \
  x1 ^= x0;
#define GR_ROUNDS_A GR_ROUND(13) GR_ROUND(15) GR_ROUND(26) GR_ROUND(6)
#define GR_ROUNDS_B GR_ROUND(17) GR_ROUND(29) GR_ROUND(16) GR_ROUND(24)
  GR_ROUNDS_A x0 += ks[1]; x1 += ks[2] + 1u;
  GR_ROUNDS_B x0 += ks[2]; x1 += ks[0] + 2u;
  GR_ROUNDS_A x0 += ks[0]; x1 += ks[1] + 3u;
  GR_ROUNDS_B x0 += ks[1]; x1 += ks[2] + 4u;
  GR_ROUNDS_A x0 += ks[2]; x1 += ks[0] + 5u;
#undef GR_ROUNDS_B
#undef GR_ROUNDS_A
#undef GR_ROUND
  return x0 ^ x1;
}

// XLA's f32 erf_inv (its ErfInv32): log1p, then one of two degree-8
// polynomials in Horner form, one fused multiply-add a step.
__device__ __forceinline__ float erf_inv_xla(float x) {
  constexpr float kLt5[9] = {2.81022636e-08f,  3.43273939e-07f, -3.5233877e-06f,
                             -4.39150654e-06f, 0.00021858087f,  -0.00125372503f,
                             -0.00417768164f,  0.246640727f,    1.50140941f};
  constexpr float kGe5[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                             -0.00367342844f,  0.00573950773f,  -0.0076224613f,
                             0.00943887047f,   1.00167406f,     2.83297682f};
  float w = -log1pf(-__fmul_rn(x, x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(sqrtf(w), 3.0f);
  float p = lt ? kLt5[0] : kGe5[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) p = fmaf(p, w, lt ? kLt5[k] : kGe5[k]);
  return fabsf(x) == 1.0f ? __fmul_rn(x, __int_as_float(0x7F800000)) : __fmul_rn(p, x);
}

__global__ void __launch_bounds__(kThreads)
    prng_kernel(uint32_t k1, long long n, int mode, void* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t bits = threefry_bits(k1, static_cast<unsigned long long>(i));
  if (mode == kBits) {
    static_cast<uint32_t*>(out)[i] = bits;
    return;
  }
  if (mode == kNormalBf16) {
    const float lo = -0.99609375f;  // nextafter(-1, 0) in bf16
    const uint32_t h = ((bits & 0xFFu) >> 1) | 0x3F80u;
    const float f = __fsub_rn(__uint_as_float(h << 16), 1.0f);  // exact
    // (1 - lo) rounds to 2 in bf16; f * 2 + lo is exact in f32, then
    // rounded to bf16 as the bf16 add rounds.
    const float span = __bfloat162float(__float2bfloat16_rn(__fsub_rn(1.0f, lo)));
    float u = __bfloat162float(__float2bfloat16_rn(__fadd_rn(__fmul_rn(f, span), lo)));
    u = fmaxf(lo, u);
    const float e = __bfloat162float(__float2bfloat16_rn(erf_inv_xla(u)));
    const float s2 = __bfloat162float(__float2bfloat16_rn(1.41421356f));
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(__fmul_rn(s2, e));
    return;
  }
  const float lo = -0.99999994f;  // nextafter(-1, 0) in f32
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  // The product and the sum rounded apart, as XLA rounds them.
  const float u = fmaxf(lo, __fadd_rn(__fmul_rn(f, __fsub_rn(1.0f, lo)), lo));
  if (mode == kUniform) {
    static_cast<float*>(out)[i] = u;
    return;
  }
  static_cast<float*>(out)[i] = __fmul_rn(1.41421356f, erf_inv_xla(u));
}

}  // namespace

extern "C" {

// out (n,) = the draw of `mode` (0 bits as uint32, 1 uniform f32, 2 normal
// f32, 3 normal bf16) from the key (0, k1), value i from flat index i.
// Launches on `stream`; returns cudaGetLastError() (0 = ok).
int gr_prng(unsigned int k1, long long n, int mode, void* out, void* stream) {
  if (n < 0 || mode < kBits || mode > kNormalBf16) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  prng_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(k1, n, mode, out);
  return static_cast<int>(cudaGetLastError());
}

const char* gr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
