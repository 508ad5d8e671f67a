// Bit-serial IEEE-754 float32 multiply for Hopper (sm_90a): K8.
//
// Replaces: repro/kernels/pim_fp.py:_pim_fp32_mul_kernel, the Pallas TPU
// kernel behind pim_fp32_mul — the in-kernel analogue of the paper's §3.3
// mantissa shift-and-add (Fig. 4b). Same function, element by element:
// the 24-step loop over the multiplier's significand bits adds the
// shifted multiplicand into two 24-bit limbs (lo, hi), the paper's two
// ping-pong accumulator columns, with carry propagation; the product is
// normalized on bit 47, rounded to nearest even from the guard and sticky
// bits and renormalized when the rounding overflows; the exponent is
// ea + eb - 127 + top + overflow. A result exponent <= 0 gives a signed
// zero (FTZ), >= 255 a signed inf. An input whose exponent field is 0 or
// 255 (zero, subnormal, inf, NaN) takes the native product of the inputs
// with subnormals read as signed zeros (DAZ) — the reference's contract
// under XLA, which flushes its native multiply. The DAZ is done here in
// code, so the build needs no -ftz: __fmul_rn is the IEEE product.
//
// Bound: integer issue, not bytes. The function moves 12 bytes per
// element (two float32 read, one written: 12 n bytes over 3.35 TB/s), but
// the unrolled 24-step loop is ~6 uint32 operations a step, ~170 with
// the rounding, against ~64 integer lanes per SM-cycle on the H100.
//
// Design: a grid-stride loop over the flat elements, one element per
// thread per iteration; where every pointer is 16-byte aligned (as fresh
// PyTorch allocations are) each thread moves float4s over the first
// 4 * (n / 4) elements and the last n % 4 are a scalar tail, as K3 does.
// There is no padding to rows of 1024 as in the Pallas grid: the tail is
// masked by the loop bound. The 24-step loop is unrolled and stays a loop
// of shift-and-add steps, because that loop is the procedure the kernel
// models.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;   // 16 blocks per H100 SM
constexpr uint32_t kM23 = 0x7FFFFFu;
constexpr uint32_t kM24 = 0xFFFFFFu;

// x with a subnormal replaced by a zero of its sign (DAZ)
__device__ __forceinline__ float daz(float x) {
  const uint32_t u = __float_as_uint(x);
  return ((u >> 23) & 0xFFu) == 0 ? __uint_as_float(u & 0x80000000u) : x;
}

__device__ __forceinline__ float pim_mul(float a, float b) {
  const uint32_t ua = __float_as_uint(a), ub = __float_as_uint(b);
  const uint32_t ea = (ua >> 23) & 0xFFu, eb = (ub >> 23) & 0xFFu;
  // specials (zero / subnormal-DAZ, inf, nan) -> native semantics
  if (ea == 0 || eb == 0 || ea == 255 || eb == 255)
    return __fmul_rn(daz(a), daz(b));
  const uint32_t sig_a = (ua & kM23) | (1u << 23);
  const uint32_t sig_b = (ub & kM23) | (1u << 23);

  // 24-step shift-and-add into ping-pong 24-bit limbs (lo, hi)
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int i = 0; i < 24; ++i) {
    const uint32_t bit = (sig_b >> i) & 1u;
    const uint32_t keep_mask = (1u << (24 - i)) - 1u;
    lo += bit * ((sig_a & keep_mask) << i);
    hi += bit * (sig_a >> (24 - i));
    hi += lo >> 24;                 // carry propagate
    lo &= kM24;
  }

  // product in [2^46, 2^48): normalize by top bit (47)
  const uint32_t top = (hi >> 23) & 1u;
  uint32_t keep, guard;
  bool sticky;
  if (top) {
    keep = hi;                                  // bits 24..47
    guard = (lo >> 23) & 1u;
    sticky = (lo & kM23) != 0;
  } else {
    keep = ((hi << 1) | (lo >> 23)) & kM24;     // bits 23..46
    guard = (lo >> 22) & 1u;
    sticky = (lo & 0x3FFFFFu) != 0;
  }
  keep += guard & ((uint32_t)sticky | (keep & 1u));
  const uint32_t round_ovf = (keep >> 24) & 1u;
  if (round_ovf) keep >>= 1;

  const int e = (int)ea + (int)eb - 127 + (int)top + (int)round_ovf;
  const uint32_t sign = (ua ^ ub) & 0x80000000u;
  if (e <= 0) return __uint_as_float(sign);                 // FTZ
  if (e >= 255) return __uint_as_float(sign | 0x7F800000u);  // inf
  return __uint_as_float(sign | ((uint32_t)e << 23) | (keep & kM23));
}

__global__ void __launch_bounds__(kThreads)
pim_fp32_mul_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ out, long long n, bool vec) {
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long done = 0;
  if (vec) {
    const long long n4 = n / 4;
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long i = first; i < n4; i += stride) {
      const float4 x = a4[i], y = b4[i];
      o4[i] = make_float4(pim_mul(x.x, y.x), pim_mul(x.y, y.y),
                          pim_mul(x.z, y.z), pim_mul(x.w, y.w));
    }
    done = 4 * n4;
  }
  for (long long i = done + first; i < n; i += stride)
    out[i] = pim_mul(a[i], b[i]);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// out[i] = a[i] * b[i] by the bit-serial procedure for i < n: contiguous
// float32 on the current device. Returns a cudaError_t (0 on success).
extern "C" int pim_fp32_mul(const void* a, const void* b, void* out,
                            long long n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const bool vec = aligned16(a) && aligned16(b) && aligned16(out);
  const long long items = vec ? (n + 3) / 4 : n;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  pim_fp32_mul_kernel<<<static_cast<int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), n, vec);
  return (int)cudaGetLastError();
}
