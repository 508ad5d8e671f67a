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
// Design: split-KV ("flash-decoding") in two kernels on one stream, so
// that no slot walks its history alone and the card's SMs share the keys.
//
// Split pass (paged_decode_split_kernel): grid (B * G, n_split), 128
// threads. Split j of slot b covers the table entries [j nb, (j + 1) nb);
// the caller chooses nb (the wrapper's split_policy: 32 keys a split, 2
// blocks at bs 16) and n_split = ceil(W / nb) follows, so the host never
// reads pos and a slot's output does not depend on the other slots. A split whose first
// key lies past pos[b] writes m = -1e30, l = 0 and returns. Otherwise the
// block reads its own table entries and copies the K rows, then the V
// rows, at positions <= pos[b] into shared memory by 16-byte cp.async
// copies (consecutive threads on consecutive 16 bytes of a row; rows
// padded by 16 bytes), V's copy in flight while the scores are computed.
// A key past pos[b] would score -1e30, whose exponential is exactly 0: it
// is neither copied nor summed. The split's table entries are read beside
// pos, so the rows' addresses wait on one load, not two. Warp r takes
// query row r (and r + 4, ..) and lane t key t (and t + 32, ..): a whole
// row of K by 16-byte shared loads against the float32 q row, the split's
// max and sum by warp shuffles, the probabilities exp(s - m) rounded to
// v's dtype at the split's own max, stored key-major. Thread d keeps the
// unnormalised acc[r][d] over the rounded probabilities, the rep of a key
// read as one vector (rep is rounded up to a power of two R, a template
// argument). It writes acc to a float32 workspace [B, G, n_split, rep, D]
// and (m, l) to [B, G, n_split, rep, 2]. Three barriers a split, none a
// block.
//
// Combine pass (paged_decode_combine_kernel): one block per (slot, query
// head) reads the splits in split order: M = max m_j, out = sum
// e^(m_j - M) acc_j / max(sum e^(m_j - M) l_j, 1e-20) in q's dtype, over
// the splits with l_j > 0 (a prefix), their loads independent of each
// other so that they overlap. No float atomics: a call and its rerun are
// equal bit for bit. What it does not yet do about the bound: the two
// kernels' launch and the DRAM latency of pos, the table and the rows
// sit on one chain of each split (a persistent block or a CUDA graph of
// the decode step would hide them), and the workspace makes a round trip
// through L2.

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

// q . k over 16 bytes of a staged K row: 4 float32 or 8 bf16 values
__device__ __forceinline__ float dot16(const float* q, const float* k) {
  const float4 kv = *reinterpret_cast<const float4*>(k);
  const float4 qa = *reinterpret_cast<const float4*>(q);
  return qa.x * kv.x + qa.y * kv.y + qa.z * kv.z + qa.w * kv.w;
}
__device__ __forceinline__ float dot16(const float* q,
                                       const __nv_bfloat16* k) {
  const uint4 raw = *reinterpret_cast<const uint4*>(k);
  const __nv_bfloat162* kv = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float4 qa = *reinterpret_cast<const float4*>(q);
  const float4 qb = *reinterpret_cast<const float4*>(q + 4);
  const float2 k0 = __bfloat1622float2(kv[0]), k1 = __bfloat1622float2(kv[1]);
  const float2 k2 = __bfloat1622float2(kv[2]), k3 = __bfloat1622float2(kv[3]);
  return qa.x * k0.x + qa.y * k0.y + qa.z * k1.x + qa.w * k1.y +
         qb.x * k2.x + qb.y * k2.y + qb.z * k3.x + qb.w * k3.y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// a staged K/V row: D values and 16 bytes of padding
template <typename T>
__host__ __device__ constexpr int row_len(int D) {
  return D + 16 / (int)sizeof(T);
}

// rep (query heads of a kv head) rounded up to R, a power of two <= kMaxRep
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const T* __restrict__ q,          // [B, H, D]
                          const T* __restrict__ k_pool,     // [N, bs, G, D]
                          const T* __restrict__ v_pool,     // [N, bs, G, D]
                          const int32_t* __restrict__ table,  // [B, W]
                          const int32_t* __restrict__ pos,    // [B]
                          float* __restrict__ ws_acc,  // [B, G, n, rep, D]
                          float* __restrict__ ws_ml,   // [B, G, n, rep, 2]
                          int G, int rep, int D, int bs, int W, int nb,
                          float scale) {
  const int cap = nb * bs;                 // keys of a split
  const int row = row_len<T>(D);
  extern __shared__ float4 smem4[];
  T* k_s = reinterpret_cast<T*>(smem4);                     // [cap][row]
  T* v_s = k_s + (size_t)cap * row;                         // [cap][row]
  float* q_s = reinterpret_cast<float*>(v_s + (size_t)cap * row);  // [R][D]
  float* p_s = q_s + R * D;                 // [cap][R] probabilities
  int* tb_s = reinterpret_cast<int*>(p_s + cap * R);        // [nb]

  const int bg = blockIdx.x, j = blockIdx.y, n_split = gridDim.y;
  const int b = bg / G, g = bg - b * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t split = (size_t)bg * n_split + j;
  float* ml = ws_ml + split * rep * 2;
  // the split's table entries, read beside pos (neither waits on the other)
  if (tid < nb) {
    const int w = j * nb + tid;
    tb_s[tid] = w < W ? table[(size_t)b * W + w] : 0;
  }
  const int p = pos[b];
  const int key0 = j * cap;
  if (key0 > p) {
    if (tid < rep) {
      ml[2 * tid] = kNegInf;
      ml[2 * tid + 1] = 0.f;
    }
    return;
  }
  __syncthreads();                         // tb_s
  // keys key0 .. key0 + n_keys - 1 are at positions <= pos[b]
  const int n_keys = min(min(cap, p - key0 + 1), (W - j * nb) * bs);

  const int vec = 16 / (int)sizeof(T);     // values a 16-byte copy
  const int chunks = D / vec;
  const size_t tok = (size_t)G * D;        // between a block's tokens
  for (int i = tid; i < n_keys * chunks; i += kThreads) {
    const int t = i / chunks, c = i - t * chunks;
    const size_t off = ((size_t)tb_s[t / bs] * bs + t % bs) * tok +
                       (size_t)g * D + c * vec;
    cp_async16(smem_addr(k_s + t * row + c * vec), k_pool + off);
  }
  cp_async_commit();
  for (int i = tid; i < n_keys * chunks; i += kThreads) {
    const int t = i / chunks, c = i - t * chunks;
    const size_t off = ((size_t)tb_s[t / bs] * bs + t % bs) * tok +
                       (size_t)g * D + c * vec;
    cp_async16(smem_addr(v_s + t * row + c * vec), v_pool + off);
  }
  cp_async_commit();
  const T* q_bg = q + ((size_t)b * G * rep + (size_t)g * rep) * D;
  for (int i = tid; i < rep * D; i += kThreads) q_s[i] = to_f32(q_bg[i]);
  cp_async_wait<1>();                      // K landed (V may be in flight)
  __syncthreads();

  // scores, the split's max and sum: warp r row r, lane t key t
  for (int r = warp; r < rep; r += kWarps) {
    const float* qr = q_s + r * D;
    float mx = kNegInf;
    for (int t = lane; t < n_keys; t += 32) {
      const T* kr = k_s + t * row;
      float dot = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += vec) dot += dot16(qr + d, kr + d);
      const float sc = dot * scale;
      p_s[t * R + r] = sc;
      mx = fmaxf(mx, sc);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < n_keys; t += 32) {
      const float e = expf(p_s[t * R + r] - mx);
      sum += e;
      p_s[t * R + r] = round_as(e, v_pool);
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      ml[2 * r] = mx;
      ml[2 * r + 1] = sum;
    }
  }
  cp_async_wait<0>();                      // V landed
  __syncthreads();

  // acc[r][d] = sum_t round(p[t][r]) v[t][d], thread d; p[t][0..R) is one
  // vector read
  float* acc_out = ws_acc + split * rep * D;
#pragma unroll
  for (int c = 0; c < kMaxDChunks; ++c) {
    const int d = tid + c * kThreads;
    if (d < D) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
      for (int t = 0; t < n_keys; ++t) {
        const float vv = to_f32(v_s[t * row + d]);
        float pr[R];
        if constexpr (R % 4 == 0) {
#pragma unroll
          for (int r = 0; r < R; r += 4)
            *reinterpret_cast<float4*>(pr + r) =
                *reinterpret_cast<const float4*>(p_s + t * R + r);
        } else {
#pragma unroll
          for (int r = 0; r < R; ++r) pr[r] = p_s[t * R + r];
        }
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(pr[r], vv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < rep) acc_out[r * D + d] = acc[r];
    }
  }
}

// out = sum_j e^(m_j - M) acc_j / max(sum_j e^(m_j - M) l_j, 1e-20) over
// the live splits, which are a prefix (split j is live iff j * keys of a
// split <= pos[b]), in split order
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_combine_kernel(const float* __restrict__ ws_acc,
                            const float* __restrict__ ws_ml,
                            T* __restrict__ out,   // [B, H, D]
                            int G, int rep, int D, int n_split) {
  const int bh = blockIdx.x;                // b * H + h
  const int H = G * rep;
  const int b = bh / H, h = bh - b * H;
  const int g = h / rep, r = h - g * rep;
  const size_t first = (size_t)(b * G + g) * n_split;   // split 0 of (b, g)
  // split j's (m, l) at ml[j * rep]; acc at acc[j * rep * D]
  const float2* ml = reinterpret_cast<const float2*>(ws_ml) + first * rep + r;
  const float* acc = ws_acc + (first * rep + r) * D;
  float m_all = kNegInf;
  int n_live = 0;
#pragma unroll 8
  for (int j = 0; j < n_split; ++j) {
    const float2 x = ml[(size_t)j * rep];
    if (x.y > 0.f) {
      m_all = fmaxf(m_all, x.x);
      ++n_live;
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxDChunks; ++c) {
    const int d = threadIdx.x + c * kThreads;
    if (d < D) {
      float num = 0.f, den = 0.f;
#pragma unroll 4
      for (int j = 0; j < n_live; ++j) {     // in split order
        const float2 x = ml[(size_t)j * rep];
        const float w = expf(x.x - m_all);
        num += w * acc[(size_t)j * rep * D + d];
        den += w * x.y;
      }
      from_f32(num / fmaxf(den, 1e-20f), &out[(size_t)bh * D + d]);
    }
  }
}

template <typename T, int R>
int launch_split(const void* q, const void* k, const void* v,
                 const void* table, const void* pos, void* ws_acc,
                 void* ws_ml, int B, int G, int rep, int D, int bs, int W,
                 int nb, int n_split, cudaStream_t stream) {
  const int cap = nb * bs;
  const size_t smem = 2 * (size_t)cap * row_len<T>(D) * sizeof(T) +
                      sizeof(float) * ((size_t)R * D + (size_t)cap * R) +
                      sizeof(int) * (size_t)nb;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_split_kernel<T, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_decode_split_kernel<T, R><<<dim3(B * G, n_split), kThreads, smem,
                                    stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(pos), static_cast<float*>(ws_acc),
      static_cast<float*>(ws_ml), G, rep, D, bs, W, nb,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* table,
           const void* pos, void* out, void* ws_acc, void* ws_ml, int B,
           int H, int G, int D, int bs, int W, int nb, cudaStream_t stream) {
  const int rep = H / G, n_split = (W + nb - 1) / nb;
  const int e =
      rep <= 1 ? launch_split<T, 1>(q, k, v, table, pos, ws_acc, ws_ml, B, G,
                                    rep, D, bs, W, nb, n_split, stream)
      : rep <= 2 ? launch_split<T, 2>(q, k, v, table, pos, ws_acc, ws_ml, B,
                                      G, rep, D, bs, W, nb, n_split, stream)
      : rep <= 4 ? launch_split<T, 4>(q, k, v, table, pos, ws_acc, ws_ml, B,
                                      G, rep, D, bs, W, nb, n_split, stream)
      : rep <= 8 ? launch_split<T, 8>(q, k, v, table, pos, ws_acc, ws_ml, B,
                                      G, rep, D, bs, W, nb, n_split, stream)
                 : launch_split<T, 16>(q, k, v, table, pos, ws_acc, ws_ml, B,
                                       G, rep, D, bs, W, nb, n_split, stream);
  if (e != 0) return e;
  paged_decode_combine_kernel<T><<<B * H, kThreads, 0, stream>>>(
      static_cast<const float*>(ws_acc), static_cast<const float*>(ws_ml),
      static_cast<T*>(out), G, rep, D, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D a multiple of 8; k/v 16-byte
// aligned; nb <= 128 table entries a split; ws_acc [B, G, n_split, rep, D] and
// ws_ml [B, G, n_split, rep, 2] float32, n_split = ceil(W / nb). Returns a
// cudaError_t (0 on success).
extern "C" int paged_decode_attention(const void* q, const void* k,
                                      const void* v, const void* table,
                                      const void* pos, void* out,
                                      void* ws_acc, void* ws_ml, int B,
                                      int H, int G, int D, int bs, int W,
                                      int nb, int dtype, void* stream) {
  if (B < 1 || G < 1 || H % G != 0 || H / G > kMaxRep || D < 8 ||
      D % 8 != 0 || D > kThreads * kMaxDChunks || bs < 1 || W < 1 ||
      (long long)B * H > 0x7FFFFFFFLL ||
      nb < 1 || nb > kThreads || (W + nb - 1) / nb > 65535 ||
      (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, table, pos, out, ws_acc, ws_ml, B, H, G,
                           D, bs, W, nb, s);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, table, pos, out, ws_acc, ws_ml,
                                   B, H, G, D, bs, W, nb, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
