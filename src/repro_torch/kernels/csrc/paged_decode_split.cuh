// Split-KV paged one-token GQA decode attention ("flash-decoding"): the two
// passes that K4 (paged_decode_attention.cu, a pool of values) and K6
// (paged_decode_attention_q.cu, a pool of codes with one float32 scale a
// row) share. Each source wraps them in __global__ kernels of its own
// names, so a profile tells the two apart.
//
// Split pass (split_pass): grid (B * G, n_split), kThreads threads. Split
// j of slot b covers the table entries [j nb, (j + 1) nb); the caller
// chooses nb (the wrapper's split_policy: 32 keys a split, 2 blocks at bs
// 16) and n_split = ceil(W / nb) follows, so the host never reads pos and
// a slot's output does not depend on the other slots. A split whose first
// key lies past pos[b] writes m = -1e30, l = 0 and returns. Otherwise the
// block reads its own table entries and copies the K rows, then the V
// rows, at positions <= pos[b] into shared memory as they are stored, by
// 16-byte cp.async copies (consecutive threads on consecutive 16 bytes of
// a row; rows padded by 16 bytes), with each row's float32 scale by a
// 4-byte copy where the rows are codes; V's copy is in flight while the
// scores are computed. Where the rows are codes (K6), the block first
// dequantizes the split's K codes once, every thread four consecutive
// elements at a time, into float32 rows in shared memory that every warp's
// scores then read: the scores read each K element once per query row,
// and decoding it there would repeat the decode for every warp. A key
// past pos[b] would score -1e30, whose
// exponential is exactly 0: it is neither copied nor summed, and table
// entries past pos (the scratch block 0, garbage) are never read. The
// split's table entries are read beside pos, so the rows' addresses wait
// on one load, not two. Warp r takes query row r (and r + 4, ..) and lane
// t key t (and t + 32, ..): a whole row of K by 16-byte shared loads
// against the float32 q row (dot16: K4's values converted, K6's
// dequantized rows as they are), the split's max and sum by warp shuffles,
// the probabilities
// exp(s - m) at the split's own max, rounded to the type P (the template
// argument round_as names) and stored key-major. Thread d keeps the
// unnormalised acc[r][d] over those probabilities and Rows::value of its
// V element, the rep of a key read as one vector (rep is rounded up to a
// power of two R, a template argument). It writes acc to a float32
// workspace [B, G, n_split, rep, D] and (m, l) to [B, G, n_split, rep, 2].
// Three barriers a split (four where K is dequantized first).
//
// Combine pass (combine_pass): one block per (slot, query head) reads the
// splits in split order: M = max m_j, out = sum e^(m_j - M) acc_j /
// max(sum e^(m_j - M) l_j, 1e-20) in q's dtype, over the splits with
// l_j > 0 (a prefix), their loads independent of each other so that they
// overlap. No float atomics: a call and its rerun are equal bit for bit.
//
// A Rows type says how a K/V row is stored and read:
//   using Code = ...;                  the stored element (16-byte copies)
//   static constexpr bool kScaled;     one float32 scale a row beside it;
//                                      K is then dequantized before scoring
//   const Code* k; const Code* v;      the pools [N, bs, G, D]
//   const float* ks; const float* vs;  the scales [N, bs, G, 1] (kScaled)
//   void widen4(const Code* c, float s, float* out) const;   (kScaled)
//                                      four K elements as float32
//   float value(Code c, float s) const;  one V element as float32
// s is the row's scale (1 where the rows are not scaled).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace paged_split {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 16;                  // query heads per kv head
constexpr int kMaxDChunks = 2;               // D <= kThreads * kMaxDChunks
constexpr int kMaxSplitEntries = kThreads;   // nb: table entries a split
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}

// a probability rounded to P before the PV product: float keeps it as it
// is, __nv_bfloat16 rounds it to bf16
template <typename P>
__device__ __forceinline__ float round_as(float x) {
  static_assert(std::is_same<P, float>::value, "P: float or bf16");
  return x;
}
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
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

// a staged K/V row: D elements and 16 bytes of padding
template <typename Code>
__host__ __device__ constexpr int row_len(int D) {
  return D + 16 / (int)sizeof(Code);
}

// the split pass's shared memory: K and V rows as stored, K's rows in
// float32 (kScaled), q [R][D] and p [cap][R] in float32, the rows' scales
// (kScaled), the split's table entries
template <typename Rows, int R>
__host__ __device__ constexpr size_t split_smem_bytes(int D, int nb,
                                                      int bs) {
  using Code = typename Rows::Code;
  const size_t cap = (size_t)nb * bs;
  return 2 * cap * row_len<Code>(D) * sizeof(Code) +
         sizeof(float) * ((Rows::kScaled ? cap * row_len<float>(D) : 0) +
                          (size_t)R * D + cap * R +
                          (Rows::kScaled ? 2 * cap : 0)) +
         sizeof(int) * (size_t)nb;
}

// the query rows of a kv head rounded up to R, a power of two <= kMaxRep
template <typename Rows, typename P, int R, typename T>
__device__ __forceinline__ void split_pass(
    const Rows& rows, const T* __restrict__ q,     // [B, H, D]
    const int32_t* __restrict__ table,              // [B, W]
    const int32_t* __restrict__ pos,                // [B]
    float* __restrict__ ws_acc,                     // [B, G, n, rep, D]
    float* __restrict__ ws_ml,                      // [B, G, n, rep, 2]
    int G, int rep, int D, int bs, int W, int nb, float scale) {
  using Code = typename Rows::Code;
  constexpr bool kScaled = Rows::kScaled;
  // a K row as the scores read it: dequantized to float32 where scaled
  using Score = typename std::conditional<kScaled, float, Code>::type;
  const int cap = nb * bs;                 // keys of a split
  const int row = row_len<Code>(D);
  const int frow = row_len<float>(D);
  extern __shared__ float4 smem4[];
  Code* k_s = reinterpret_cast<Code*>(smem4);                 // [cap][row]
  Code* v_s = k_s + (size_t)cap * row;                        // [cap][row]
  float* kf_s = reinterpret_cast<float*>(v_s + (size_t)cap * row);
  float* q_s = kf_s + (kScaled ? (size_t)cap * frow : 0);     // [R][D]
  float* p_s = q_s + R * D;                 // [cap][R] probabilities
  float* ks_s = p_s + cap * R;              // [cap] K rows' scales
  float* vs_s = ks_s + (kScaled ? cap : 0);                   // [cap]
  int* tb_s = reinterpret_cast<int*>(vs_s + (kScaled ? cap : 0));

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

  const int vec = 16 / (int)sizeof(Code);  // elements a 16-byte copy
  const int chunks = D / vec;
  const size_t tok = (size_t)G * D;        // between a block's tokens
  for (int i = tid; i < n_keys * chunks; i += kThreads) {
    const int t = i / chunks, c = i - t * chunks;
    const size_t off = ((size_t)tb_s[t / bs] * bs + t % bs) * tok +
                       (size_t)g * D + c * vec;
    cp_async16(smem_addr(k_s + t * row + c * vec), rows.k + off);
  }
  if constexpr (kScaled) {
    for (int t = tid; t < n_keys; t += kThreads)
      cp_async4(smem_addr(ks_s + t),
                rows.ks + ((size_t)tb_s[t / bs] * bs + t % bs) * G + g);
  }
  cp_async_commit();
  for (int i = tid; i < n_keys * chunks; i += kThreads) {
    const int t = i / chunks, c = i - t * chunks;
    const size_t off = ((size_t)tb_s[t / bs] * bs + t % bs) * tok +
                       (size_t)g * D + c * vec;
    cp_async16(smem_addr(v_s + t * row + c * vec), rows.v + off);
  }
  if constexpr (kScaled) {
    for (int t = tid; t < n_keys; t += kThreads)
      cp_async4(smem_addr(vs_s + t),
                rows.vs + ((size_t)tb_s[t / bs] * bs + t % bs) * G + g);
  }
  cp_async_commit();
  const T* q_bg = q + ((size_t)b * G * rep + (size_t)g * rep) * D;
  for (int i = tid; i < rep * D; i += kThreads) q_s[i] = to_f32(q_bg[i]);
  cp_async_wait<1>();                      // K landed (V may be in flight)
  __syncthreads();
  const Score* k_rows = reinterpret_cast<const Score*>(k_s);
  int srow = row;                          // between staged K rows
  if constexpr (kScaled) {
    // K's codes dequantized once, into the float32 rows the scores read
    const int quads = D / 4;
    for (int i = tid; i < n_keys * quads; i += kThreads) {
      const int t = i / quads, c = 4 * (i - t * quads);
      rows.widen4(k_s + t * row + c, ks_s[t], kf_s + t * frow + c);
    }
    __syncthreads();
    k_rows = reinterpret_cast<const Score*>(kf_s);
    srow = frow;
  }

  // scores, the split's max and sum: warp r row r, lane t key t
  const int svec = 16 / (int)sizeof(Score);
  for (int r = warp; r < rep; r += kWarps) {
    const float* qr = q_s + r * D;
    float mx = kNegInf;
    for (int t = lane; t < n_keys; t += 32) {
      const Score* kr = k_rows + t * srow;
      float dot = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += svec) dot += dot16(qr + d, kr + d);
      const float sc = dot * scale;
      p_s[t * R + r] = sc;
      mx = fmaxf(mx, sc);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < n_keys; t += 32) {
      const float e = expf(p_s[t * R + r] - mx);
      sum += e;
      p_s[t * R + r] = round_as<P>(e);
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      ml[2 * r] = mx;
      ml[2 * r + 1] = sum;
    }
  }
  cp_async_wait<0>();                      // V landed
  __syncthreads();

  // acc[r][d] = sum_t p[t][r] v[t][d], thread d; p[t][0..R) is one vector
  // read
  float* acc_out = ws_acc + split * rep * D;
#pragma unroll
  for (int c = 0; c < kMaxDChunks; ++c) {
    const int d = tid + c * kThreads;
    if (d < D) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
      for (int t = 0; t < n_keys; ++t) {
        float sv = 1.f;
        if constexpr (kScaled) sv = vs_s[t];
        const float vv = rows.value(v_s[t * row + d], sv);
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
// split <= pos[b]), in split order; one block per (slot, query head)
template <typename T>
__device__ __forceinline__ void combine_pass(
    const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
    T* __restrict__ out,                           // [B, H, D]
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

// the split arguments both entry points take: rep <= kMaxRep, D <= 256,
// nb <= kMaxSplitEntries, n_split within the grid's y limit
inline bool split_args_ok(int B, int H, int G, int D, int bs, int W,
                          int nb) {
  return B >= 1 && G >= 1 && H % G == 0 && H / G <= kMaxRep && D >= 1 &&
         D <= kThreads * kMaxDChunks && bs >= 1 && W >= 1 &&
         (long long)B * H <= 0x7FFFFFFFLL && (long long)B * G <= 0x7FFFFFFFLL &&
         nb >= 1 && nb <= kMaxSplitEntries && (W + nb - 1) / nb <= 65535;
}

// f(std::integral_constant<int, R>{}) for R the power of two >= rep
template <typename F>
int with_rep(int rep, F&& f) {
  if (rep <= 1) return f(std::integral_constant<int, 1>{});
  if (rep <= 2) return f(std::integral_constant<int, 2>{});
  if (rep <= 4) return f(std::integral_constant<int, 4>{});
  if (rep <= 8) return f(std::integral_constant<int, 8>{});
  return f(std::integral_constant<int, 16>{});
}

// launch kernel<<<grid, kThreads, smem, stream>>>(args...), raising its
// dynamic shared memory limit first where smem needs it
template <typename... Params, typename... Args>
int launch_kernel(void (*kernel)(Params...), dim3 grid, size_t smem,
                  cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace paged_split
