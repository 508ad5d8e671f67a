// Elementwise PIM MAC, out = acc + a * b in float32, for Hopper (sm_90a):
// K3.
//
// Replaces: repro/kernels/pim_mac.py:_mac_kernel, the Pallas TPU kernel
// behind pim_mac (pim_mac_grouped concatenates a wave of operands and
// makes one launch of it). Same function, with the precision contract of
// the paper's MAC unit: two roundings, the product rounded to float32 and
// then the sum, never contracted into one fused multiply-add
// (__fmul_rn / __fadd_rn are never contracted by the compiler).
//
// Bound: bytes. Two flops per element against 16 bytes moved (three
// float32 operands read once, one written once): 16 n bytes over
// 3.35 TB/s on an H100 SXM.
//
// Design: a grid-stride loop over the flat elements, one launch. Where
// every pointer is 16-byte aligned (as fresh PyTorch allocations are),
// each thread moves float4s — 16-byte loads and stores, consecutive
// threads on consecutive addresses — over the first 4 * (n / 4) elements,
// and the last n % 4 are a scalar tail. Otherwise every element is a
// scalar, so any length and any offset is taken.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;   // 16 blocks per H100 SM

__device__ __forceinline__ float mac(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}

__global__ void __launch_bounds__(kThreads)
pim_mac_kernel(const float* __restrict__ a, const float* __restrict__ b,
               const float* __restrict__ acc, float* __restrict__ out,
               long long n, bool vec) {
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long done = 0;
  if (vec) {
    const long long n4 = n / 4;
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    const float4* c4 = reinterpret_cast<const float4*>(acc);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long i = first; i < n4; i += stride) {
      const float4 x = a4[i], y = b4[i], z = c4[i];
      o4[i] = make_float4(mac(z.x, x.x, y.x), mac(z.y, x.y, y.y),
                          mac(z.z, x.z, y.z), mac(z.w, x.w, y.w));
    }
    done = 4 * n4;
  }
  for (long long i = done + first; i < n; i += stride)
    out[i] = mac(acc[i], a[i], b[i]);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// out[i] = acc[i] + a[i] * b[i] for i < n: contiguous float32 on the
// current device.
extern "C" int pim_mac(const void* a, const void* b, const void* acc,
                       void* out, long long n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const bool vec =
      aligned16(a) && aligned16(b) && aligned16(acc) && aligned16(out);
  const long long items = vec ? (n + 3) / 4 : n;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  pim_mac_kernel<<<static_cast<int>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(acc), static_cast<float*>(out), n, vec);
  return (int)cudaGetLastError();
}
