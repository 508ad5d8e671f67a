// Causal GQA flash attention, forward, for Hopper (sm_90a): K7.
//
// Replaces: repro/kernels/flash_attention.py:_flash_kernel, the Pallas TPU
// kernel behind flash_attention. Same function: q [B, S, H, D] and k/v
// [B, S, G, D] give [B, S, H, D] in q's dtype; query head h reads kv head
// h / (H / G) in place (K/V are never repeated); scores are the float32
// dot product times 1/sqrt(D), -1e30 where the query position is below
// the key position; the online-softmax state (acc [rows, D], m, l) is
// float32; the probabilities are rounded to v's dtype before the PV
// product while l sums them unrounded; the output is acc / max(l, 1e-20).
// A KV tile wholly in the causal future of the query tile is never read.
// Products are float32 FMAs for both dtypes (bf16 inputs are widened on
// load, so each product is exact as in the Pallas dots with
// preferred_element_type=f32); no TF32.
//
// Bound: operations. The causal work is 4 B H D S (S + 1) / 2 flops
// against (q + k + v + out) bytes read and written once, H S / (2 (H + G))
// flops per bf16 byte: at llama3-8b's heads (H 32, G 8, D 128) 0.4 S,
// above the H100's ~295 flops per byte from S ~ 740 (819 at S 2048), and
// above its float32 line (67 TFLOP/s over 3.35 TB/s, 20 flops per byte)
// from S ~ 100. The least time is the flops over 989 TFLOP/s (bf16,
// tensor cores) or 67 TFLOP/s (float32).
//
// Design: a simple SIMT kernel, one thread block of 256 threads (16 x 16)
// per (batch, query head, 64-row query tile). The query tile is staged
// once in shared memory, transposed, as float32; each 64-key K tile is
// staged transposed and each V tile row-major, both as float32, with rows
// past S zero-filled. Thread (ty, tx) owns query rows 4 ty .. 4 ty + 3:
// it computes their scores against keys 4 tx .. 4 tx + 3 from float4
// reads (16 FMAs per two 16-byte loads), reduces the row max and sum
// across the 16 lanes of its row group by shuffles, writes its rounded
// probabilities to shared memory (transposed), and keeps the output
// columns tx + 16 c of its four rows in registers. Query tiles go out
// longest first (the last tile walks every KV tile). What it does not
// yet do about the bound: no tensor cores (mma.sync / wgmma for bf16), no
// copy in flight during compute (cp.async / TMA), one block per SM at
// D = 128 (~120 KB of shared memory).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // keys per KV tile
constexpr int kTX = 16, kTY = 16;       // thread grid: kTY row groups
constexpr int kThreads = kTX * kTY;
constexpr int kRows = kBQ / kTY;        // query rows per thread (4)
constexpr int kCols = kBK / kTX;        // keys per thread (4)
constexpr int kLQ = kBQ + 4;            // padded row of q^T and p^T
constexpr int kLK = kBK + 4;            // padded row of k^T
constexpr float kNegInf = -1e30f;

static_assert(kRows == 4 && kCols == 4, "the float4 reads take 4 x 4");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}
// a probability rounded to the storage type of v (the Pallas kernel's
// p.astype(v.dtype) before its PV dot)
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// max / sum over the 16 lanes (tx) of one row group
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = kTX / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = kTX / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)D * kLQ + (size_t)D * kLK + (size_t)kBK * D +
          (size_t)kBK * kLQ);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q,     // [B, S, H, D]
             const T* __restrict__ k,     // [B, S, G, D]
             const T* __restrict__ v,     // [B, S, G, D]
             T* __restrict__ out,         // [B, S, H, D]
             int S, int H, int G, float scale) {
  constexpr int kDC = D / kTX;            // output columns per thread
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // [D][kLQ]  q tile^T
  float* kt = qt + D * kLQ;                      // [D][kLK]  k tile^T
  float* vs = kt + D * kLK;                      // [kBK][D]  v tile
  float* pt = vs + kBK * D;                      // [kBK][kLQ] p^T

  const int n_q = gridDim.y;
  const int iq = n_q - 1 - (int)blockIdx.y;      // longest rows first
  const int h = (int)blockIdx.x % H, b = (int)blockIdx.x / H;
  const int g = h / (H / G);
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const int q0 = iq * kBQ;
  const size_t q_row = (size_t)H * D, kv_row = (size_t)G * D;
  const T* qb = q + (size_t)b * S * q_row + (size_t)h * D;
  const T* kb = k + (size_t)b * S * kv_row + (size_t)g * D;
  const T* vb = v + (size_t)b * S * kv_row + (size_t)g * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    qt[d * kLQ + r] = q0 + r < S ? to_f32(qb[(size_t)(q0 + r) * q_row + d])
                                 : 0.f;
  }

  float acc[kRows][kDC];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc[i][c] = 0.f;
  }

  // KV tiles with a key position <= the tile's last query position
  const int last = min(q0 + kBQ - 1, S - 1) / kBK;
  for (int jk = 0; jk <= last; ++jk) {
    const int k0 = jk * kBK;
    __syncthreads();   // q staged; the previous tiles are consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const bool in = k0 + r < S;
      const size_t off = (size_t)(k0 + r) * kv_row + d;
      kt[d * kLK + r] = in ? to_f32(kb[off]) : 0.f;
      vs[r * D + d] = in ? to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv =
          *reinterpret_cast<const float4*>(&qt[d * kLQ + ty * kRows]);
      const float4 kv =
          *reinterpret_cast<const float4*>(&kt[d * kLK + tx * kCols]);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

    // mask, scale, online softmax by row; p^T to shared memory
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + ty * kRows + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx * kCols + j;
        s[i][j] = qp >= kp ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      *reinterpret_cast<float4*>(&pt[(tx * kCols + j) * kLQ + ty * kRows]) =
          make_float4(round_as(s[0][j], v), round_as(s[1][j], v),
                      round_as(s[2][j], v), round_as(s[3][j], v));
    __syncthreads();

    // acc += round(p) @ V over this tile's keys
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 pv =
          *reinterpret_cast<const float4*>(&pt[kk * kLQ + ty * kRows]);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int c = 0; c < kDC; ++c) {
        const float vv = vs[kk * D + tx + kTX * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pa[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + ty * kRows + i;
    if (qp < S) {
      T* o = out + ((size_t)b * S + qp) * q_row + (size_t)h * D;
      const float denom = fmaxf(l[i], 1e-20f);
#pragma unroll
      for (int c = 0; c < kDC; ++c)
        from_f32(acc[i][c] / denom, &o[tx + kTX * c]);
    }
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int G, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_kernel<D, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, G,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int S, int H, int G, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16, T>(q, k, v, out, B, S, H, G, stream);
    case 32: return launch<32, T>(q, k, v, out, B, S, H, G, stream);
    case 64: return launch<64, T>(q, k, v, out, B, S, H, G, stream);
    case 128: return launch<128, T>(q, k, v, out, B, S, H, G, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D in {16, 32, 64, 128}; contiguous
// tensors on the current device. Returns a cudaError_t (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int S, int H, int G, int D,
                               int dtype, void* stream) {
  if (B < 1 || S < 1 || G < 1 || H % G != 0 ||
      (long long)B * H > 0x7FFFFFFFLL || (S + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(q, k, v, out, B, S, H, G, D, s);
    case 1: return dispatch<__nv_bfloat16>(q, k, v, out, B, S, H, G, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
