// Blocked float32 matrix product of placed PIM weight blocks, for Hopper
// (sm_90a): K1, K2 and K5 in one kernel body.
//
// Replaces: repro/kernels/pim_mac.py:_matmul_grouped_kernel (the Pallas
// TPU kernel behind pim_matmul_grouped, K1) and :_matmul_kernel (behind
// pim_matmul, K2, the executor's per-block oracle). Same function:
// C[g] = A[g / col_groups] @ B[g] for a stack of G padded weight blocks,
// float32 in and out, float32 accumulation. Group g reads A slab
// g / col_groups (the reference's shared-A index map): a node's column
// blocks all consume one activation slab, never copied.
//
// Bit identity. A product splits its K into S contiguous chunks of
// k_chunk (a whole number of 128-deep tiles; the last chunk may be
// shorter); S = 1 is one chunk over all of K. Every output element is, per
// chunk, the chain fmaf(a[r][k], b[k][c], acc) from acc = 0 over the
// chunk's k in ascending order, and the S chunk sums are then added in
// ascending chunk order with __fadd_rn. S and k_chunk come from the
// wrapper (kernels/pim_mac.py split_k), a function of the per-block
// (M, K, N) alone: not of G, col_groups or the device. So K2 (this kernel
// launched with G = 1 and col_groups = 1) equals every group of a K1
// launch on the same blocks bit for bit (repro/mapper/lowering.py:16-22),
// and a launch gives the same bits run after run: no float atomics. S = 1
// whenever K <= 256, which is every forward and every dA launch of the
// mapper's paths, so their arithmetic is one ascending chain over all of K.
//
// No TF32 and no tensor cores: TF32 keeps about 3 decimal digits and would
// break the 1e-4 contract of the mapper's verify. A 3xTF32 or wgmma design
// is later work.
//
// Bound: operations on the padded work. Float32 FMA runs at about 67
// TFLOP/s on an H100 SXM against 3.35 TB/s of device memory. LeNet-5's
// conv1 at batch 256 (one group, M 147456, K 128, N 128 after padding to
// the 128 tiles) is 4.83 GFLOP, about 72 us, against 151 MB moved, about
// 45 us; its weight gradient dB = A^T g (M 128, K 147456, N 128) is the
// same 4.83 GFLOP over the same bytes.
//
// Design: the classic SIMT SGEMM. One thread block of 256 threads per
// (128 x 128 output tile, group, K chunk) (grid: M/128 x S, N/128, G). K
// advances 8 at a time through a ring of 4 shared-memory stages filled by
// cp.async, so three stages of loads are in flight while the block
// computes on the fourth. A is kept transposed in shared memory ([k][m],
// rows padded by 4 floats) so a thread reads its rows as float4s. Each
// thread keeps an 8 x 8 accumulator in registers: rows {4ty..4ty+3,
// 64+4ty..64+4ty+3} and the same split of columns, so its shared-memory
// reads and its stores are float4s on consecutive addresses. Two blocks
// fit an SM (33 KB of static shared memory each, at most 128 registers a
// thread by the launch bounds). With S > 1 each block writes its chunk's
// partial tile to a workspace [S, G, M, N] that the wrapper allocates, and
// a second kernel on the same stream sums the S partials of each element
// in ascending order.
//
// The split: a K-deep product with T = (M/128)(N/128) output tiles and
// K > 256 takes chunks of max(2, ceil(K/128 x T / 264)) tiles, so that the
// blocks of a group number at most about 264 (two per SM of a 132-SM card,
// a constant of the policy, not read from the device) and a chunk is at
// least 256 deep. conv1's dB at batch 256 (T 1, K 147456): chunks of 640,
// S 231, 231 blocks; conv2's dB (T 2, K 16384): chunks of 256, S 64, 128
// blocks.
//
// A loaders. Row-major A ([M, K], the forward and dA) is read as 4-byte
// cp.async copies, a warp covering 4 rows x 8 columns of the 128 x 8 tile
// (four 32-byte sectors), each into its transposed place. The dB
// cotangent's A^T is read in place (kTransA): the stored activation slab
// [K', M'] of the forward's A is already [k][m], so a tile of A^T is 8
// rows of 128 consecutive floats, one 16-byte cp.async a thread, and no
// transposed copy is made. Both loaders place the same values in the same
// shared-memory cells, so a product is the same bits either way.
//
// K5 replaces repro/kernels/pim_mac.py:_matmul_grouped_q_kernel (behind
// pim_matmul_grouped_q): C[g] = A[g / col_groups] @ (Q[g] * S[g]), with Q
// the placed block's on-grid weight values (float32, as the TPU kernel
// reads them) and S [G, 1, N] one scale per (group, output column). It is
// the same body with another B stage (the kDequant instantiation): once a
// stage has landed, each thread multiplies the float4 of q it copied by
// its four columns' scales with __fmul_rn, in place, before the barrier
// that hands the stage to the block. So the product chain sees exactly the
// float32 values q * s that an elementwise multiply forms, and K5(a, q, s)
// == K1(a, q * s) bit for bit by construction (the reference's grouped ==
// per-block claim on quantized grids). Its bound is K1's: operations (the
// scale read is N floats per group). An fp8/int8 tensor-core variant would
// change the numerics.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 8;
constexpr int kStages = 4;        // cp.async ring depth
constexpr int kLdA = kBM + 4;     // padded A rows: the 4-byte copies of a
                                  // warp land on 32 distinct banks
constexpr int kThreads = 256;     // 16 x 16 threads, 8 x 8 outputs each
constexpr int kChunkTile = 128;   // a split chunk is whole 128-deep tiles
constexpr int kSumThreads = 256;

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies of all but the newest n groups have landed
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// K5's B stage: the staged values times their columns' scales, each
// product rounded once (no contraction into the product chain).
__device__ __forceinline__ float4 dequantize(float4 q, float4 s) {
  return make_float4(__fmul_rn(q.x, s.x), __fmul_rn(q.y, s.y),
                     __fmul_rn(q.z, s.z), __fmul_rn(q.w, s.w));
}

template <bool kDequant, bool kTransA>
__global__ void __launch_bounds__(kThreads, 2)
pim_matmul_kernel(const float* __restrict__ A,   // [G / col_groups, M, K];
                                                 // kTransA: [.., K, M]
                  const float* __restrict__ B,   // [G, K, N] (K5: Q)
                  const float* __restrict__ S,   // K5: [G, 1, N]; else null
                  float* __restrict__ C,         // [G, M, N]; split:
                                                 // workspace [S, G, M, N]
                  int M, int K, int N, int col_groups, int k_chunk) {
  __shared__ __align__(16) float a_s[kStages][kBK][kLdA];   // [k][m]
  __shared__ __align__(16) float b_s[kStages][kBK][kBN];

  const int tiles_m = M / kBM;
  const int chunk = blockIdx.x / tiles_m;
  const int m0 = (blockIdx.x - chunk * tiles_m) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int g = blockIdx.z;
  const int k0 = chunk * k_chunk;
  const int n_k = min(k_chunk, K - k0) / kBK;
  const float* a = A + static_cast<size_t>(g / col_groups) * M * K;
  const float* b = B + static_cast<size_t>(g) * K * N;
  float* c = C + (static_cast<size_t>(chunk) * gridDim.z + g) * M * N;

  const int tid = threadIdx.x;
  // 8 x 128 tiles (B; A^T in place): a float4 per thread
  const int r_row = tid >> 5;
  const int r_col = (tid & 31) * 4;
  const float* b_src = b + static_cast<size_t>(k0 + r_row) * N + n0 + r_col;
  // row-major A: a 128 x 8 tile as four 4-byte copies per thread, rows
  // a_row + 32 j, column a_col
  const int a_row = tid >> 3;
  const int a_col = tid & 7;
  const float* a_src =
      kTransA ? a + static_cast<size_t>(k0 + r_row) * M + m0 + r_col
              : a + static_cast<size_t>(m0 + a_row) * K + k0 + a_col;
  float4 sv = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  if constexpr (kDequant)       // this thread's four columns' scales
    sv = *reinterpret_cast<const float4*>(S + static_cast<size_t>(g) * N +
                                          n0 + r_col);

  auto load_stage = [&](int slot, int t) {
    if constexpr (kTransA) {
      cp_async16(&a_s[slot][r_row][r_col],
                 a_src + static_cast<size_t>(t) * kBK * M);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cp_async4(&a_s[slot][a_col][a_row + 32 * j],
                  a_src + static_cast<size_t>(32 * j) * K + t * kBK);
    }
    cp_async16(&b_s[slot][r_row][r_col],
               b_src + static_cast<size_t>(t) * kBK * N);
  };

  // compute mapping
  const int tx = tid & 15;
  const int ty = tid >> 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  // the ring's first kStages - 1 stages; a group per stage, empty past
  // the chunk, so that the wait below counts the same in every step
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_k) load_stage(st, st);
    cp_async_commit();
  }

  for (int t = 0; t < n_k; ++t) {
    const int slot = t % kStages;
    cp_async_wait<kStages - 2>();      // this thread's copies of stage t
    if constexpr (kDequant) {          // K5: dequantize what it copied
      float4* q = reinterpret_cast<float4*>(&b_s[slot][r_row][r_col]);
      *q = dequantize(*q, sv);
    }
    // stage t is the block's; every thread is done with stage t - 1,
    // whose slot the next load refills
    __syncthreads();
    if (t + kStages - 1 < n_k)
      load_stage((t + kStages - 1) % kStages, t + kStages - 1);
    cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&a_s[slot][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&a_s[slot][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&b_s[slot][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&b_s[slot][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    float* out = c + static_cast<size_t>(row) * N + n0;
    *reinterpret_cast<float4*>(out + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(out + 64 + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// C[e] = ws[0][e] + ws[1][e] + ... + ws[S-1][e], added in that order.
__global__ void __launch_bounds__(kSumThreads)
pim_matmul_splitk_sum(const float* __restrict__ ws, float* __restrict__ C,
                      size_t n, int splits) {
  const size_t e = static_cast<size_t>(blockIdx.x) * kSumThreads +
                   threadIdx.x;
  if (e >= n) return;
  float acc = ws[e];
#pragma unroll 8
  for (int s = 1; s < splits; ++s)
    acc = __fadd_rn(acc, ws[static_cast<size_t>(s) * n + e]);
  C[e] = acc;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// the chunks cover K exactly, each non-empty; a split chunk is whole tiles
bool valid_split(int K, int splits, int k_chunk, const void* ws) {
  if (splits == 1) return k_chunk == K;
  return splits > 1 && k_chunk > 0 && k_chunk % kChunkTile == 0 &&
         static_cast<long long>(splits - 1) * k_chunk < K &&
         static_cast<long long>(splits) * k_chunk >= K && ws != nullptr &&
         aligned16(ws);
}

template <bool kDequant, bool kTransA>
int launch(const void* a, const void* b, const void* s, void* c, void* ws,
           int G, int col_groups, int M, int K, int N, int splits,
           int k_chunk, void* stream) {
  if (G < 1 || G > 65535 || col_groups < 1 || G % col_groups != 0 ||
      M < kBM || M % kBM != 0 || N < kBN || N % kBN != 0 || N / kBN > 65535 ||
      K < kBK || K % kBK != 0 || !valid_split(K, splits, k_chunk, ws) ||
      static_cast<long long>(M / kBM) * splits > INT_MAX || !aligned16(a) ||
      !aligned16(b) || !aligned16(c) || (kDequant && !aligned16(s)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(M / kBM * splits, N / kBN, G);
  pim_matmul_kernel<kDequant, kTransA><<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(s),
      static_cast<float*>(splits == 1 ? c : ws), M, K, N, col_groups,
      k_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t n = static_cast<size_t>(G) * M * N;
  const size_t blocks = (n + kSumThreads - 1) / kSumThreads;
  pim_matmul_splitk_sum<<<static_cast<unsigned>(blocks), kSumThreads, 0,
                          st>>>(static_cast<const float*>(ws),
                                static_cast<float*>(c), n, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// K1: C[g] = A[g / col_groups] @ B[g], g < G. A [G / col_groups, M, K]
// (trans_a: [G / col_groups, K, M], read as its transpose), B [G, K, N],
// C [G, M, N], all contiguous float32 on the current device. splits and
// k_chunk: the K split (splits == 1: k_chunk == K, ws unused); ws [splits,
// G, M, N] float32 scratch when splits > 1.
extern "C" int pim_matmul_grouped(const void* a, const void* b, void* c,
                                  void* ws, int G, int col_groups, int M,
                                  int K, int N, int splits, int k_chunk,
                                  int trans_a, void* stream) {
  return trans_a ? launch<false, true>(a, b, nullptr, c, ws, G, col_groups,
                                       M, K, N, splits, k_chunk, stream)
                 : launch<false, false>(a, b, nullptr, c, ws, G, col_groups,
                                        M, K, N, splits, k_chunk, stream);
}

// K2: C = A @ B, A [M, K] (trans_a: [K, M]), B [K, N], C [M, N]: K1 with
// one group.
extern "C" int pim_matmul(const void* a, const void* b, void* c, void* ws,
                          int M, int K, int N, int splits, int k_chunk,
                          int trans_a, void* stream) {
  return pim_matmul_grouped(a, b, c, ws, 1, 1, M, K, N, splits, k_chunk,
                            trans_a, stream);
}

// K5: C[g] = A[g / col_groups] @ (Q[g] * S[g]). A [G / col_groups, M, K], Q
// [G, K, N] on-grid values, S [G, 1, N] scales, C [G, M, N], all contiguous
// float32 on the current device; splits, k_chunk and ws as K1's.
extern "C" int pim_matmul_grouped_q(const void* a, const void* q,
                                    const void* s, void* c, void* ws, int G,
                                    int col_groups, int M, int K, int N,
                                    int splits, int k_chunk, void* stream) {
  return launch<true, false>(a, q, s, c, ws, G, col_groups, M, K, N, splits,
                             k_chunk, stream);
}
