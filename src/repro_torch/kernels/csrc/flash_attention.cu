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
// Every product is exact and summed in float32, as in the Pallas dots with
// preferred_element_type=f32; no TF32.
//
// Bound: operations. The causal work is 4 B H D S (S + 1) / 2 flops
// against (q + k + v + out) bytes read and written once, H S / (2 (H + G))
// flops per bf16 byte: at llama3-8b's heads (H 32, G 8, D 128) 0.4 S,
// above the H100's ~295 flops per byte from S ~ 740 (819 at S 2048), and
// above its float32 line (67 TFLOP/s over 3.35 TB/s, 20 flops per byte)
// from S ~ 100. The least time is the flops over 989 TFLOP/s (bf16,
// tensor cores) or 67 TFLOP/s (float32).
//
// bfloat16 (flash_mma_kernel): FlashAttention-2 on mma.sync. One block of
// 4 warps per (batch, query head, 64-row query tile); warp w owns query
// rows 16 w .. 16 w + 15. Both products are
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 (bf16 x bf16 is exact, the
// sum float32). The query tile and each 64-key K and V tile are staged as
// bf16 by 16-byte cp.async copies (rows past S zero-filled, src-size 0)
// into rows padded by 16 bytes, so the 8 rows an ldmatrix phase reads sit
// on distinct banks; K and V go through a 2-stage ring, the next tile's
// copy in flight while the current one is used. Q's A-fragments are
// loaded once (ldmatrix) and kept in registers (at D 256, 168,960 bytes of
// shared memory and one block an SM, they are re-read from shared memory
// each tile, which keeps the accumulator's 128 registers a thread clear of
// spills); K's B-fragments come from
// ldmatrix, V's from ldmatrix.trans ([keys][D] row-major is PV's k x n
// operand). The score accumulator is the softmax's input: a row lives on
// a quad of 4 lanes, whose max and sum reduce by __shfl_xor_sync over
// offsets 1 and 2 (the sum once, after the last tile). The probabilities
// become PV's A-fragment in registers: two adjacent n8 accumulator tiles
// are one k16 fragment, each pair rounded by __floats2bfloat162_rn (to
// nearest even, as the Pallas kernel's p.astype(bf16)). Only the
// diagonal tile is masked: a row past S in the ragged last tile reads
// zero-filled keys and is not stored, and every key past S is above the
// diagonal of every stored row. The softmax runs in base 2: m is kept in
// units of log2(e) and p = exp2f(s scale log2(e) - m), one FMA and one
// exp2 an element (the same function as expf(s scale - m) up to float32
// rounding; a masked score of -1e30 still gives exactly 0). Query tiles
// go out longest first. 87,040 bytes of shared memory at D = 128: two
// blocks an SM. What it does not yet do about the bound: wgmma/TMA and warp
// specialisation (a producer warp feeding asynchronous warpgroup
// products), which the card's full bf16 rate needs.
//
// float32 (flash_kernel): a simple SIMT kernel, one thread block of 256
// threads (16 x 16) per (batch, query head, 64-row query tile). The query
// tile is staged once in shared memory, transposed; each 64-key K tile is
// staged transposed and each V tile row-major, with rows past S
// zero-filled. Thread (ty, tx) owns query rows 4 ty .. 4 ty + 3: it
// computes their scores against keys 4 tx .. 4 tx + 3 from float4 reads
// (16 FMAs per two 16-byte loads), reduces the row max and sum across the
// 16 lanes of its row group by shuffles, writes its probabilities to
// shared memory (transposed), and keeps the output columns tx + 16 c of
// its four rows in registers. Query tiles go out longest first. What it
// does not yet do about the bound: no copy in flight during compute, one
// block per SM at D = 128 (~120 KB of shared memory; 222,208 bytes at
// D = 256, under the 227 KB a block may opt in to), and float32 FMAs
// (TF32 would break the float32 tolerance).

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
__device__ __forceinline__ void from_f32(float x, float* dst) { *dst = x; }
// a probability rounded to the storage type of v (the Pallas kernel's
// p.astype(v.dtype) before its PV dot): float32 keeps it
__device__ __forceinline__ float round_as(float x, const float*) { return x; }

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
           int S, int H, int G, float scale, cudaStream_t stream) {
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
      static_cast<const T*>(v), static_cast<T*>(out), S, H, G, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: FlashAttention-2 on mma.sync
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int kMmaWarps = kBQ / 16;          // 16 query rows a warp
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kStages = 2;                   // K/V tiles of the ring

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, bypassing L1; src-size 0 zero-fills
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// four 8 x 8 bf16 matrices; lane i gives the address of row i % 8 of
// matrix i / 8 and receives row lane / 4, columns 2 (lane % 4) + {0, 1} of
// each (of its transpose with .trans)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}
// c += a b: a the 16 x 16 bf16 A-fragment, (b0, b1) the 16 x 8 B-fragment,
// c the 16 x 8 float32 accumulator (rows lane / 4 and lane / 4 + 8,
// columns 2 (lane % 4) + {0, 1})
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two probabilities, rounded to nearest even, as one bf16 pair (x low)
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <int D>
__host__ __device__ constexpr int mma_row() { return D + 8; }  // D + 16 bytes

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (size_t)(kBQ + 2 * kStages * kBK) * mma_row<D>();
}

// cp.async of the [64, D] tile of rows r0 .. r0 + 63 of src (row stride
// `stride` elements) into dst; rows past S are zero-filled
template <int D>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src,
                                           size_t stride, int r0, int S,
                                           int tid) {
  constexpr int kChunks = D / 8;              // 16-byte copies a row
  static_assert(kBK * kChunks % kMmaThreads == 0, "whole copies a thread");
#pragma unroll
  for (int it = 0; it < kBK * kChunks / kMmaThreads; ++it) {
    const int i = tid + it * kMmaThreads;
    const int r = i / kChunks, c = i - r * kChunks;
    const bool in = r0 + r < S;
    cp_async16(smem_addr(dst + r * mma_row<D>() + c * 8),
               src + (size_t)(in ? r0 + r : 0) * stride + c * 8, in);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_mma_kernel(const bf16* __restrict__ q,     // [B, S, H, D]
                 const bf16* __restrict__ k,     // [B, S, G, D]
                 const bf16* __restrict__ v,     // [B, S, G, D]
                 bf16* __restrict__ out,         // [B, S, H, D]
                 int S, int H, int G, float scale) {
  static_assert(kBQ == kBK && kBQ % 16 == 0 && D % 16 == 0, "tiles");
  constexpr int kRow = mma_row<D>();
  constexpr int kKS = D / 16;                 // k16 steps of q k^T
  constexpr int kNT = kBK / 8;                // n8 tiles of the scores
  constexpr int kDT = D / 8;                  // n8 tiles of the output
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);  // [kBQ][kRow]
  bf16* ks = qs + kBQ * kRow;                 // [kStages][kBK][kRow]
  bf16* vs = ks + kStages * kBK * kRow;       // [kStages][kBK][kRow]

  const int n_q = gridDim.y;
  const int iq = n_q - 1 - (int)blockIdx.y;   // longest rows first
  const int h = (int)blockIdx.x % H, b = (int)blockIdx.x / H;
  const int g = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int quad = lane >> 2, t4 = lane & 3;
  const int q0 = iq * kBQ;
  const size_t q_row = (size_t)H * D, kv_row = (size_t)G * D;
  const bf16* qb = q + (size_t)b * S * q_row + (size_t)h * D;
  const bf16* kb = k + (size_t)b * S * kv_row + (size_t)g * D;
  const bf16* vb = v + (size_t)b * S * kv_row + (size_t)g * D;
  // this thread's two query rows (accumulator rows quad and quad + 8)
  const int row_a = q0 + warp * 16 + quad, row_b = row_a + 8;
  const float scale2 = scale * 1.4426950408889634f;   // scale log2(e)

  // KV tiles with a key position <= the tile's last query position; the
  // last is the diagonal tile
  const int last = min(q0 + kBQ - 1, S - 1) / kBK;
  stage_tile<D>(qs, qb, q_row, q0, S, tid);
  stage_tile<D>(ks, kb, kv_row, 0, S, tid);
  stage_tile<D>(vs, vb, kv_row, 0, S, tid);
  cp_async_commit();

  // q's A-fragments stay in registers up to D 128; at D 256 they would
  // take 64 more registers a thread beside the 128 of the accumulator,
  // so each KV tile re-reads them from shared memory instead
  constexpr bool kQInRegs = D <= 128;
  uint32_t qf[kQInRegs ? kKS : 1][4];
  float o[kDT][4];
#pragma unroll
  for (int t = 0; t < kDT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  for (int jk = 0; jk <= last; ++jk) {
    const int st = jk & 1;
    if (jk < last) {
      stage_tile<D>(ks + (st ^ 1) * kBK * kRow, kb, kv_row, (jk + 1) * kBK, S,
                    tid);
      stage_tile<D>(vs + (st ^ 1) * kBK * kRow, vb, kv_row, (jk + 1) * kBK, S,
                    tid);
    }
    cp_async_commit();      // empty past the last tile: the count stays
    cp_async_wait<1>();     // every group but the newest: tile jk landed
    __syncthreads();
    if constexpr (kQInRegs) {
      if (jk == 0) {
#pragma unroll
        for (int kk = 0; kk < kKS; ++kk)
          ldmatrix_x4(qf[kk], smem_addr(qs + (warp * 16 + (lane & 15)) *
                                                 kRow +
                                        kk * 16 + (lane >> 4) * 8));
      }
    }

    // s = q k^T over the tile's 64 keys: 16 x 64 a warp, float32
    const bf16* kt = ks + st * kBK * kRow;
    float s[kNT][4];
#pragma unroll
    for (int t = 0; t < kNT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      if constexpr (!kQInRegs)
        ldmatrix_x4(qf[0], smem_addr(qs + (warp * 16 + (lane & 15)) * kRow +
                                     kk * 16 + (lane >> 4) * 8));
      const uint32_t(&qa)[4] = qf[kQInRegs ? kk : 0];
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        // keys 16 np + {0..7, 8..15} x d 16 kk + {0..7, 8..15}
        uint32_t kf[4];
        ldmatrix_x4(kf, smem_addr(kt + (np * 16 + (lane & 7) +
                                        (lane >> 4) * 8) * kRow +
                                  kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * np], qa, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
      }
    }

    // mask the diagonal tile, online softmax by row in base 2: scores
    // times scale log2(e), so exp(x - m) is exp2 of one FMA
    const bool diag = jk == last;
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = jk * kBK + t * 8 + 2 * t4 + (e & 1);
        const int qp = e < 2 ? row_a : row_b;
        if (diag && kp > qp) s[t][e] = kNegInf;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[t][0], s[t][1]) * scale2);
      mx_b = fmaxf(mx_b, fmaxf(s[t][2], s[t][3]) * scale2);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float alpha_a = exp2f(m_a - mn_a), alpha_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
      s[t][0] = exp2f(fmaf(s[t][0], scale2, -mn_a));
      s[t][1] = exp2f(fmaf(s[t][1], scale2, -mn_a));
      s[t][2] = exp2f(fmaf(s[t][2], scale2, -mn_b));
      s[t][3] = exp2f(fmaf(s[t][3], scale2, -mn_b));
      sum_a += s[t][0] + s[t][1];
      sum_b += s[t][2] + s[t][3];
    }
    l_a = l_a * alpha_a + sum_a;     // this lane's share; the quad sums last
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int t = 0; t < kDT; ++t) {
      o[t][0] *= alpha_a;
      o[t][1] *= alpha_a;
      o[t][2] *= alpha_b;
      o[t][3] *= alpha_b;
    }

    // o += round(p) v: n8 score tiles 2 kk and 2 kk + 1 are the k16
    // A-fragment of keys 16 kk .. 16 kk + 15
    const bf16* vt = vs + st * kBK * kRow;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kDT / 2; ++dp) {
        // keys 16 kk + {0..7, 8..15} x d 16 dp + {0..7, 8..15}
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, smem_addr(vt + (kk * 16 + (lane & 7) +
                                              ((lane >> 3) & 1) * 8) * kRow +
                                        dp * 16 + (lane >> 4) * 8));
        mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();        // the stage is consumed before it is refilled
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float den_a = fmaxf(l_a, 1e-20f), den_b = fmaxf(l_b, 1e-20f);
  bf16* ob = out + (size_t)b * S * q_row + (size_t)h * D + 2 * t4;
#pragma unroll
  for (int t = 0; t < kDT; ++t) {
    if (row_a < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row_a * q_row + t * 8) =
          __floats2bfloat162_rn(o[t][0] / den_a, o[t][1] / den_a);
    if (row_b < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row_b * q_row + t * 8) =
          __floats2bfloat162_rn(o[t][2] / den_b, o[t][3] / den_b);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B,
               int S, int H, int G, float scale, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), S, H, G, scale);
  return (int)cudaGetLastError();
}

int dispatch_f32(const void* q, const void* k, const void* v, void* out,
                 int B, int S, int H, int G, int D, float scale,
                 cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16, float>(q, k, v, out, B, S, H, G, scale, stream);
    case 32: return launch<32, float>(q, k, v, out, B, S, H, G, scale, stream);
    case 64: return launch<64, float>(q, k, v, out, B, S, H, G, scale, stream);
    case 128: return launch<128, float>(q, k, v, out, B, S, H, G, scale, stream);
    case 256: return launch<256, float>(q, k, v, out, B, S, H, G, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch_bf16(const void* q, const void* k, const void* v, void* out,
                  int B, int S, int H, int G, int D, float scale,
                  cudaStream_t stream) {
  switch (D) {
    case 16: return launch_mma<16>(q, k, v, out, B, S, H, G, scale, stream);
    case 32: return launch_mma<32>(q, k, v, out, B, S, H, G, scale, stream);
    case 64: return launch_mma<64>(q, k, v, out, B, S, H, G, scale, stream);
    case 128: return launch_mma<128>(q, k, v, out, B, S, H, G, scale, stream);
    case 256: return launch_mma<256>(q, k, v, out, B, S, H, G, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D in {16, 32, 64, 128, 256}, the head dim
// as stored (a smaller one zero-padded up to it by the wrapper); scale the
// scores' factor, 1/sqrt of the head dim before padding; contiguous
// tensors on the current device. Returns a cudaError_t (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int S, int H, int G, int D,
                               int dtype, float scale, void* stream) {
  if (B < 1 || S < 1 || G < 1 || H % G != 0 ||
      (long long)B * H > 0x7FFFFFFFLL || (S + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_f32(q, k, v, out, B, S, H, G, D, scale, s);
    case 1: return dispatch_bf16(q, k, v, out, B, S, H, G, D, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
