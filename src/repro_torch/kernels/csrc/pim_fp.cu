// Bit-serial IEEE-754 float32 multiply for Hopper (sm_90a): K8.
//
// Replaces: repro/kernels/pim_fp.py:_pim_fp32_mul_kernel, the Pallas TPU
// kernel behind pim_fp32_mul — the in-kernel analogue of the paper's §3.3
// mantissa shift-and-add (Fig. 4b). Same function, element by element: a
// 24-step loop over the multiplier's significand bits adds the
// multiplicand into two 24-bit limbs (hi, lo), the paper's two ping-pong
// accumulator columns, which end as the high and low halves of the exact
// 48-bit product; the product is normalized on bit 47, rounded to nearest
// even from the guard and sticky bits and renormalized when the rounding
// overflows; the exponent is ea + eb - 127 + top + overflow. A result
// exponent <= 0 gives a signed zero (FTZ), >= 255 a signed inf. An input
// whose exponent field is 0 or 255 (zero, subnormal, inf, NaN) takes the
// native product of the inputs with subnormals read as signed zeros (DAZ)
// — the reference's contract under XLA, which flushes its native
// multiply. The DAZ is done here in code, so the build needs no -ftz:
// __fmul_rn is the IEEE product.
//
// The steps: a right-shifting accumulator. Step i (bit i of sig_b, from
// the least significant) adds sig_a into hi where the bit is set, then
// shifts the pair (hi, lo) right by one, the bit leaving hi entering lo.
// After step i, hi * 2^(i+1) + (lo's i + 1 bits) * 2^0 = the sum of the
// bits 0..i of sig_b times sig_a, and hi < 2^24 (hi + sig_a < 2^25 before
// the shift); so after 24 steps hi = P >> 24 and lo = P & 0xFFFFFF for
// the exact product P = sig_a * sig_b — the two limbs that the reference's
// left-shifting loop (lo += bit * (sig_a << i), the carry out of lo into
// hi) ends with, so the rounding below reads the same bits. lo is kept
// top-aligned in its 32 bits (the funnel shift brings hi's low bit in at
// bit 31; after 24 steps its limb is bits 8..31): a step is a bit test
// into a predicate, a predicated add, a funnel shift and a shift — four
// integer instructions, where the reference loop's form took about eight.
//
// Bound: integer issue, not bytes. The function moves 12 bytes per
// element (two float32 read, one written: 12 n bytes over 3.35 TB/s), but
// the unrolled 24-step loop is 4 integer instructions a step, ~115 an
// element with the rounding and the special-value test (chip_smoke.py's
// static count of the SASS), against the H100's integer instruction rate.
//
// Design: a grid-stride loop over the flat elements, one element per
// thread per iteration; where every pointer is 16-byte aligned (as fresh
// PyTorch allocations are) each thread moves float4s over the first
// 4 * (n / 4) elements and the last n % 4 are a scalar tail, as K3 does.
// There is no padding to rows of 1024 as in the Pallas grid: the tail is
// masked by the loop bound. The 24-step loop is unrolled and stays a loop
// of shift-and-add steps, because that loop is the procedure the kernel
// models. The special-value path is a branch taken before the steps, so
// a normal pair never reaches the hardware multiplier. A select in its
// place (the native product taken of zeros for a normal pair) removes the
// divergence that random bit patterns cause, but measured slower on the
// H100 and took more instructions: the branch skips the steps where the
// select computes them for nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;   // 16 blocks per H100 SM
constexpr uint32_t kM23 = 0x7FFFFFu;
constexpr uint32_t kSign = 0x80000000u;

__device__ __forceinline__ float pim_mul(float a, float b) {
  const uint32_t ua = __float_as_uint(a), ub = __float_as_uint(b);
  const uint32_t ea = (ua >> 23) & 0xFFu, eb = (ub >> 23) & 0xFFu;
  // exponent field 0 (zero, subnormal) or 255 (inf, nan)
  const bool special = ea - 1u >= 254u || eb - 1u >= 254u;
  if (special)
    return __fmul_rn(__uint_as_float(ea ? ua : ua & kSign),
                     __uint_as_float(eb ? ub : ub & kSign));
  const uint32_t sig_a = (ua & kM23) | (1u << 23);
  const uint32_t sig_b = (ub & kM23) | (1u << 23);

  // 24 shift-and-add steps into the ping-pong limbs (hi, lo << 8)
  uint32_t hi = 0, lo = 0;
#pragma unroll
  for (int i = 0; i < 24; ++i) {
    // hi += sig_a where bit i of sig_b is set: a predicated add (written
    // in PTX: as C++ the compiler turns it into a mask of the bit, three
    // instructions where the predicate takes one)
    asm("{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %1, 0;\n\t"
        "@p add.u32 %0, %0, %2;\n\t}"
        : "+r"(hi)
        : "r"(sig_b & (1u << i)), "r"(sig_a));
    lo = __funnelshift_r(lo, hi, 1);   // hi's low bit into lo's bit 31
    hi >>= 1;
  }

  // product in [2^46, 2^48): normalize by its top bit (47, hi's bit 23),
  // shifting (hi, lo) left by one where it is clear
  const uint32_t top = hi >> 23;
  const uint32_t sh = top ^ 1u;
  uint32_t keep = __funnelshift_l(lo, hi, sh);   // 24 bits kept
  const uint32_t rest = lo << sh;                // the bits below, on top
  const uint32_t guard = rest >> 31;
  const uint32_t sticky = (rest << 1) != 0u;
  keep += guard & (sticky | (keep & 1u));
  const uint32_t round_ovf = keep >> 24;
  keep >>= round_ovf;

  const int e = (int)ea + (int)eb - 127 + (int)(top + round_ovf);
  const uint32_t sign = (ua ^ ub) & kSign;
  const uint32_t bits =
      e <= 0 ? sign                                   // FTZ
      : e >= 255 ? sign | 0x7F800000u                 // inf
                 : sign | ((uint32_t)e << 23) | (keep & kM23);
  return __uint_as_float(bits);
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
