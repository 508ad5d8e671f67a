// Paged one-token GQA decode attention for Hopper (sm_90a).
//
// Replaces: repro/kernels/flash_attention.py:_paged_decode_kernel, the
// Pallas TPU kernel behind paged_decode_attention_grouped. Same function:
// for every batch slot b and query head h, attend the one new query over
// the slot's KV, read from the shared block pool [N, bs, G, D] through the
// block table [B, W], positions 0..pos[b]; query head h reads kv head
// h / (H / G). Scores, running max, running sum and the accumulator are
// float32; scores are the float32 dot product times 1/sqrt(D); keys past
// pos[b] are masked to -1e30; the probabilities are rounded to v's dtype
// before the PV product; the output is acc / max(l, 1e-20) in q's dtype.
// Blocks with w * bs > pos[b] are never read: their table entries point at
// the scratch block, which holds garbage.
//
// Bound: bytes. The kernel does ~4 flops per K/V element it reads, far
// below the ~295 flops per byte where the H100's tensor cores would limit
// it. The least time is the bytes the function must move over 3.35 TB/s:
// q read once, the K and V rows at positions 0..pos[b] of each (slot, kv
// head) read once, the output written once — for llama3-8b at batch 8 and
// positions near 512, about 16.8 MB per layer per tick, 5.0 us.
//
// Design: one thread block per (slot, kv head), 128 threads. The rep query
// rows of that kv head sit in shared memory as float32. The block walks the
// slot's valid blocks in order; for each, all threads copy the [bs, D] K
// and V tiles into shared memory with consecutive threads on consecutive
// addresses (each byte of the pool read once), a warp per key computes the
// rep scores, one thread per query row updates the online softmax, and
// thread d keeps acc[r][d] for every row r in registers. What it does not
// yet do about the bound: B * G blocks (64 for llama3-8b at batch 8) leave
// half of the 132 SMs idle, the slot with the longest history walks all of
// its blocks alone (measured on the H100: ~10 us per block, so its time
// grows with the longest slot, not with the bytes), and no copy is in
// flight during compute. Splitting the key range across SMs
// (flash-decoding), 16-byte loads and a cp.async/TMA ring are the next
// steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 16;                  // query heads per kv head
constexpr int kMaxDChunks = 2;               // D <= kThreads * kMaxDChunks
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}
// round a probability to the storage type of v (the Pallas kernel's
// pr.astype(v.dtype) before its PV dot)
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q,          // [B, H, D]
                    const T* __restrict__ k_pool,     // [N, bs, G, D]
                    const T* __restrict__ v_pool,     // [N, bs, G, D]
                    const int32_t* __restrict__ table,  // [B, W]
                    const int32_t* __restrict__ pos,    // [B]
                    T* __restrict__ out,              // [B, H, D]
                    int G, int rep, int D, int bs, int W, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                // [rep, D]
  float* k_s = q_s + rep * D;       // [bs, D]
  float* v_s = k_s + bs * D;        // [bs, D]
  float* s_s = v_s + bs * D;        // [rep, bs] scores, then exp(s - m)
  float* m_s = s_s + rep * bs;      // [rep] running max
  float* l_s = m_s + rep;           // [rep] running sum
  float* a_s = l_s + rep;           // [rep] this block's rescale factor

  const int b = blockIdx.x, g = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = G * rep;
  const int p = pos[b];
  const int n_valid = min(p / bs + 1, W);   // blocks with w * bs <= p

  const T* q_bg = q + ((size_t)b * H + (size_t)g * rep) * D;
  for (int i = tid; i < rep * D; i += kThreads) q_s[i] = to_f32(q_bg[i]);
  if (tid < rep) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  float acc[kMaxRep][kMaxDChunks];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r)
#pragma unroll
    for (int c = 0; c < kMaxDChunks; ++c) acc[r][c] = 0.f;

  const size_t tok_stride = (size_t)G * D;    // between a block's tokens
  for (int w = 0; w < n_valid; ++w) {
    const size_t base =
        ((size_t)table[(size_t)b * W + w] * bs * G + g) * D;
    __syncthreads();   // the previous block's tiles and scores are consumed
    for (int i = tid; i < bs * D; i += kThreads) {
      const int t = i / D, d = i - t * D;
      const size_t off = base + t * tok_stride + d;
      k_s[i] = to_f32(k_pool[off]);
      v_s[i] = to_f32(v_pool[off]);
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

    // acc = acc * alpha + round(p) @ V; thread tid owns columns tid + c*128
#pragma unroll
    for (int c = 0; c < kMaxDChunks; ++c) {
      const int d = tid + c * kThreads;
      if (d < D) {
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r) {
          if (r < rep) {
            float pv = 0.f;
            for (int t = 0; t < bs; ++t)
              pv += round_as(s_s[r * bs + t], v_pool) * v_s[t * D + d];
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

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* table,
           const void* pos, void* out, int B, int H, int G, int D, int bs,
           int W, cudaStream_t stream) {
  const int rep = H / G;
  const size_t smem =
      sizeof(float) * ((size_t)rep * D + 2 * (size_t)bs * D +
                       (size_t)rep * bs + 3 * (size_t)rep);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B, G);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(pos), static_cast<T*>(out), G, rep, D, bs,
      W, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int paged_decode_attention(const void* q, const void* k,
                                      const void* v, const void* table,
                                      const void* pos, void* out, int B,
                                      int H, int G, int D, int bs, int W,
                                      int dtype, void* stream) {
  if (B < 1 || G < 1 || H % G != 0 || H / G > kMaxRep || D < 1 ||
      D > kThreads * kMaxDChunks || bs < 1 || W < 1 || G > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, table, pos, out, B, H, G, D, bs, W, s);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, table, pos, out, B, H, G, D, bs,
                                   W, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
