// Paged one-token GQA decode attention over a quantized KV pool, for
// Hopper (sm_90a).
//
// Replaces: repro/kernels/flash_attention.py:_paged_decode_kernel_q, the
// Pallas TPU kernel behind paged_decode_attention_grouped_q (K6). Same
// function as paged_decode_attention.cu (K4), with K and V stored as packed
// codes [N, bs, G, D] and one float32 scale per (token, kv head)
// [N, bs, G, 1]: each element is dequantized on load as
// repro.core.quant.dequantize_kv does — code * scale for the int8 grid,
// decode(code) * scale for the sign|exp|mant float grids — and scores,
// softmax and the PV product run in float32. The probabilities are not
// rounded before the PV product (v is float32 once dequantized), and the
// output is acc / max(l, 1e-20) in q's dtype.
//
// The float grids are the reference's, not IEEE's or OCP's: an exponent
// field of 0 decodes to +0 (no subnormals), and the top binade is finite
// (no inf or NaN codes; fp8_e4m3 reaches 480). So decoding is bit
// arithmetic on the code, never a hardware fp8 or half conversion.
//
// Blocks with w * bs > pos[b] are never read: their table entries point at
// the scratch block 0, which holds garbage codes and scales.
//
// Bound: bytes. The kernel does ~4 flops per query head per K/V element it
// reads plus one multiply to dequantize, far below the ~295 flops per byte
// where the H100's tensor cores would limit it. The least time is the bytes
// the function must move over 3.35 TB/s: q read once; the codes and scales
// of the rows at positions 0..pos[b] of each (slot, kv head) read once with
// the table entries they sit in; the output written once. For llama3-8b at
// batch 8 with 1-byte codes and bf16 q, at the positions chip_smoke.py
// uses (0 to 1023, 3,528 rows in all), that is about 7.58 MB, 2.26 us; the
// fp16 grid's 2-byte codes make it 14.8 MB, 4.42 us.
//
// Design: K4's — one thread block per (slot, kv head), 128 threads, the rep
// query rows in shared memory as float32, the online-softmax state in
// shared memory and registers. The slot's table row is copied to shared
// memory once, so a block's loads never wait on a table read. For each
// valid block, every thread first stages up to 16 K codes, 16 V codes and
// their scales in registers (consecutive threads on consecutive bytes, all
// loads independent and in flight together), then dequantizes them into
// float32 [bs, D] tiles in shared memory. What it does not yet do about the
// bound: B * G blocks (64 for llama3-8b at batch 8) leave half of the 132
// SMs idle, and the slot with the longest history walks all its blocks
// alone (split-KV across SMs is the fix); codes are loaded one or two bytes
// per thread, not as 16-byte vectors; no load of the next block is in
// flight while this one is computed (a cp.async/TMA ring); and the tiles
// go through shared memory as float32, four times the bytes of the codes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 16;                  // query heads per kv head
constexpr int kMaxDChunks = 2;               // D <= kThreads * kMaxDChunks
constexpr int kItems = 16;                   // codes a thread stages per pass
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}

// The float grids' sign|exp|mant code -> float32 (repro.core.quant
// decode_float): exponent field 0 is +0, every other field a normal binade.
__device__ __forceinline__ float decode_float(uint32_t c, int ne, int nm,
                                              int bias) {
  const uint32_t e_t = (c >> nm) & ((1u << ne) - 1u);
  if (e_t == 0) return 0.f;
  const uint32_t sign = (c >> (ne + nm)) & 1u;
  const uint32_t m_t = c & ((1u << nm) - 1u);
  const uint32_t e = (uint32_t)((int)e_t - bias + 127);
  return __uint_as_float((sign << 31) | (e << 23) | (m_t << (23 - nm)));
}

// dequantize_kv: the decoded value times its vector's scale, one rounding
__device__ __forceinline__ float dequant(int8_t c, float s, int, int, int) {
  return __fmul_rn((float)c, s);
}
__device__ __forceinline__ float dequant(uint8_t c, float s, int ne, int nm,
                                         int bias) {
  return __fmul_rn(decode_float(c, ne, nm, bias), s);
}
__device__ __forceinline__ float dequant(uint16_t c, float s, int ne, int nm,
                                         int bias) {
  return __fmul_rn(decode_float(c, ne, nm, bias), s);
}

template <typename T, typename C>
__global__ void __launch_bounds__(kThreads)
paged_decode_q_kernel(const T* __restrict__ q,             // [B, H, D]
                      const C* __restrict__ k_pool,        // [N, bs, G, D]
                      const float* __restrict__ k_scale,   // [N, bs, G, 1]
                      const C* __restrict__ v_pool,        // [N, bs, G, D]
                      const float* __restrict__ v_scale,   // [N, bs, G, 1]
                      const int32_t* __restrict__ table,   // [B, W]
                      const int32_t* __restrict__ pos,     // [B]
                      T* __restrict__ out,                 // [B, H, D]
                      int G, int rep, int D, int bs, int W, float scale,
                      int ne, int nm, int bias) {
  extern __shared__ float smem[];
  float* q_s = smem;                // [rep, D]
  float* k_s = q_s + rep * D;       // [bs, D] dequantized K tile
  float* v_s = k_s + bs * D;        // [bs, D] dequantized V tile
  float* s_s = v_s + bs * D;        // [rep, bs] scores, then exp(s - m)
  float* m_s = s_s + rep * bs;      // [rep] running max
  float* l_s = m_s + rep;           // [rep] running sum
  float* a_s = l_s + rep;           // [rep] this block's rescale factor
  int32_t* tbl_s = reinterpret_cast<int32_t*>(a_s + rep);   // [W]

  const int b = blockIdx.x, g = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = G * rep;
  const int p = pos[b];
  const int n_valid = min(p / bs + 1, W);   // blocks with w * bs <= p

  const T* q_bg = q + ((size_t)b * H + (size_t)g * rep) * D;
  for (int i = tid; i < rep * D; i += kThreads) q_s[i] = to_f32(q_bg[i]);
  for (int i = tid; i < n_valid; i += kThreads)
    tbl_s[i] = table[(size_t)b * W + i];
  if (tid < rep) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  float acc[kMaxRep][kMaxDChunks];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r)
#pragma unroll
    for (int c = 0; c < kMaxDChunks; ++c) acc[r][c] = 0.f;

  const int tile = bs * D;
  for (int w = 0; w < n_valid; ++w) {
    __syncthreads();   // table row, q ready; the previous tiles consumed
    // (token, kv head) row of token 0 of this block; token t is G rows on
    const size_t row0 = (size_t)tbl_s[w] * bs * G + g;
    for (int i0 = 0; i0 < tile; i0 += kThreads * kItems) {
      C kc[kItems], vc[kItems];
      float ks[kItems], vs[kItems];
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int i = i0 + j * kThreads + tid;
        if (i < tile) {
          const int t = i / D, d = i - t * D;
          const size_t row = row0 + (size_t)t * G;
          kc[j] = k_pool[row * D + d];
          vc[j] = v_pool[row * D + d];
          ks[j] = k_scale[row];
          vs[j] = v_scale[row];
        }
      }
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int i = i0 + j * kThreads + tid;
        if (i < tile) {
          k_s[i] = dequant(kc[j], ks[j], ne, nm, bias);
          v_s[i] = dequant(vc[j], vs[j], ne, nm, bias);
        }
      }
    }
    __syncthreads();

    // scores: one warp per key, lanes across D, shuffle-reduced
    for (int t = warp; t < bs; t += kWarps) {
      const bool valid = w * bs + t <= p;
      for (int r = 0; r < rep; ++r) {
        float dot = 0.f;
        for (int d = lane; d < D; d += 32) dot += q_s[r * D + d] * k_s[t * D + d];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (lane == 0) s_s[r * bs + t] = valid ? dot * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: one thread per query row
    if (tid < rep) {
      float* s = s_s + tid * bs;
      const float m_prev = m_s[tid];
      float m_new = m_prev;
      for (int t = 0; t < bs; ++t) m_new = fmaxf(m_new, s[t]);
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float e = expf(s[t] - m_new);
        s[t] = e;
        sum += e;
      }
      const float alpha = expf(m_prev - m_new);
      l_s[tid] = l_s[tid] * alpha + sum;
      m_s[tid] = m_new;
      a_s[tid] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + p @ V; thread tid owns columns tid + c*128
#pragma unroll
    for (int c = 0; c < kMaxDChunks; ++c) {
      const int d = tid + c * kThreads;
      if (d < D) {
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r) {
          if (r < rep) {
            float pv = 0.f;
            for (int t = 0; t < bs; ++t) pv += s_s[r * bs + t] * v_s[t * D + d];
            acc[r][c] = acc[r][c] * a_s[r] + pv;
          }
        }
      }
    }
  }
  __syncthreads();

  T* o_bg = out + ((size_t)b * H + (size_t)g * rep) * D;
#pragma unroll
  for (int c = 0; c < kMaxDChunks; ++c) {
    const int d = tid + c * kThreads;
    if (d < D) {
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r)
        if (r < rep) from_f32(acc[r][c] / fmaxf(l_s[r], 1e-20f), &o_bg[r * D + d]);
    }
  }
}

template <typename T, typename C>
int launch(const void* q, const void* k, const void* ks, const void* v,
           const void* vs, const void* table, const void* pos, void* out,
           int B, int H, int G, int D, int bs, int W, int ne, int nm,
           int bias, cudaStream_t stream) {
  const int rep = H / G;
  const size_t smem =
      sizeof(float) * ((size_t)rep * D + 2 * (size_t)bs * D +
                       (size_t)rep * bs + 3 * (size_t)rep) +
      sizeof(int32_t) * (size_t)W;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_q_kernel<T, C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B, G);
  paged_decode_q_kernel<T, C><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(k),
      static_cast<const float*>(ks), static_cast<const C*>(v),
      static_cast<const float*>(vs), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(pos), static_cast<T*>(out), G, rep, D, bs,
      W, 1.0f / sqrtf((float)D), ne, nm, bias);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_codes(const void* q, const void* k, const void* ks, const void* v,
                 const void* vs, const void* table, const void* pos,
                 void* out, int B, int H, int G, int D, int bs, int W,
                 int codes, int ne, int nm, int bias, cudaStream_t s) {
  switch (codes) {
    case 0:
      return launch<T, int8_t>(q, k, ks, v, vs, table, pos, out, B, H, G, D,
                               bs, W, ne, nm, bias, s);
    case 1:
      return launch<T, uint8_t>(q, k, ks, v, vs, table, pos, out, B, H, G, D,
                                bs, W, ne, nm, bias, s);
    case 2:
      return launch<T, uint16_t>(q, k, ks, v, vs, table, pos, out, B, H, G,
                                 D, bs, W, ne, nm, bias, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (q and out): 0 = float32, 1 = bfloat16. codes: 0 = int8 codes of
// the int8 grid; 1 = uint8 and 2 = 16-bit sign|exp|mant codes of a float
// grid with n_exp exponent bits, n_mant mantissa bits and exponent bias
// `bias`. Returns a cudaError_t (0 on success).
extern "C" int paged_decode_attention_q(
    const void* q, const void* k, const void* k_scale, const void* v,
    const void* v_scale, const void* table, const void* pos, void* out,
    int B, int H, int G, int D, int bs, int W, int dtype, int codes,
    int n_exp, int n_mant, int bias, void* stream) {
  if (B < 1 || G < 1 || H % G != 0 || H / G > kMaxRep || D < 1 ||
      D > kThreads * kMaxDChunks || bs < 1 || W < 1 || G > 65535)
    return (int)cudaErrorInvalidValue;
  if (codes != 0) {
    const int width = codes == 1 ? 8 : 16;
    if (n_exp < 1 || n_mant < 0 || n_mant > 23 ||
        1 + n_exp + n_mant > width || bias < 0 || bias > 126)
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_codes<float>(q, k, k_scale, v, v_scale, table, pos, out,
                                 B, H, G, D, bs, W, codes, n_exp, n_mant,
                                 bias, s);
    case 1:
      return launch_codes<__nv_bfloat16>(q, k, k_scale, v, v_scale, table,
                                         pos, out, B, H, G, D, bs, W, codes,
                                         n_exp, n_mant, bias, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
