// Blocked float32 matrix product of placed PIM weight blocks, for Hopper
// (sm_90a): K1 and K2 in one kernel body.
//
// Replaces: repro/kernels/pim_mac.py:_matmul_grouped_kernel (the Pallas
// TPU kernel behind pim_matmul_grouped, K1) and :_matmul_kernel (behind
// pim_matmul, K2, the executor's per-block oracle). Same function:
// C[g] = A[g / col_groups] @ B[g] for a stack of G padded weight blocks,
// float32 in and out, float32 accumulation. K2 is this kernel launched
// with G = 1 and col_groups = 1, so "grouped == per-block bit for bit"
// (repro/mapper/lowering.py:16-22) holds by construction: every output
// element is the same chain fmaf(a[r][k], b[k][c], acc) over k = 0..K-1 in
// ascending order, whatever G and the group are. Group g reads A slab
// g / col_groups (the reference's shared-A index map): a node's column
// blocks all consume one activation slab, never copied.
//
// No TF32 and no tensor cores: TF32 keeps about 3 decimal digits and would
// break the 1e-4 contract of the mapper's verify. A 3xTF32 or wgmma design
// is later work.
//
// Bound: operations. Float32 FMA runs at about 67 TFLOP/s on an H100 SXM
// against 3.35 TB/s of device memory. At LeNet-5's conv1 at batch 256
// (one group, M 147456, K 128, N 128 after padding to the 128 tiles) that
// is 4.83 GFLOP, about 72 us, against 151 MB moved, about 45 us.
//
// Design: the classic SIMT SGEMM. One thread block of 256 threads per
// 128 x 128 output tile of one group (grid: M/128, N/128, G). K advances 8
// at a time through a double-buffered pair of shared-memory tiles (A
// stored transposed so a thread reads its rows as float4s); each thread
// loads one float4 of A and one of B per step into registers while the
// block computes on the other buffer, then stores them. Each thread keeps
// an 8 x 8 accumulator in registers: rows {4ty..4ty+3, 64+4ty..64+4ty+3}
// and the same split of columns, so its shared-memory reads and its
// output stores are float4s on consecutive addresses. The operands are the
// mapper's padded blocks: M and N are multiples of 128 and K of 8, so no
// tile has a ragged edge.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 8;
constexpr int kThreads = 256;     // 16 x 16 threads, 8 x 8 outputs each

__global__ void __launch_bounds__(kThreads)
pim_matmul_kernel(const float* __restrict__ A,   // [G / col_groups, M, K]
                  const float* __restrict__ B,   // [G, K, N]
                  float* __restrict__ C,         // [G, M, N]
                  int M, int K, int N, int col_groups) {
  __shared__ __align__(16) float a_s[2][kBK][kBM];   // transposed: [k][m]
  __shared__ __align__(16) float b_s[2][kBK][kBN];

  const int g = blockIdx.z;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const float* a = A + static_cast<size_t>(g / col_groups) * M * K;
  const float* b = B + static_cast<size_t>(g) * K * N;
  float* c = C + static_cast<size_t>(g) * M * N;

  const int tid = threadIdx.x;
  // loaders: the A tile (128 x 8) and the B tile (8 x 128) are one float4
  // per thread each
  const int a_row = tid >> 1;
  const int a_col = (tid & 1) * 4;
  const int b_row = tid >> 5;
  const int b_col = (tid & 31) * 4;
  const float* a_ptr = a + static_cast<size_t>(m0 + a_row) * K + a_col;
  const float* b_ptr = b + static_cast<size_t>(b_row) * N + n0 + b_col;
  // compute mapping
  const int tx = tid & 15;
  const int ty = tid >> 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  float4 ra = *reinterpret_cast<const float4*>(a_ptr);
  float4 rb = *reinterpret_cast<const float4*>(b_ptr);
  a_s[0][a_col + 0][a_row] = ra.x;
  a_s[0][a_col + 1][a_row] = ra.y;
  a_s[0][a_col + 2][a_row] = ra.z;
  a_s[0][a_col + 3][a_row] = ra.w;
  *reinterpret_cast<float4*>(&b_s[0][b_row][b_col]) = rb;
  __syncthreads();

  const int n_k = K / kBK;
  for (int t = 0; t < n_k; ++t) {
    const int cur = t & 1;
    if (t + 1 < n_k) {          // next tile into registers during compute
      ra = *reinterpret_cast<const float4*>(a_ptr + (t + 1) * kBK);
      rb = *reinterpret_cast<const float4*>(
          b_ptr + static_cast<size_t>(t + 1) * kBK * N);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&a_s[cur][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&a_s[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&b_s[cur][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&b_s[cur][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (t + 1 < n_k) {
      const int nxt = cur ^ 1;
      a_s[nxt][a_col + 0][a_row] = ra.x;
      a_s[nxt][a_col + 1][a_row] = ra.y;
      a_s[nxt][a_col + 2][a_row] = ra.z;
      a_s[nxt][a_col + 3][a_row] = ra.w;
      *reinterpret_cast<float4*>(&b_s[nxt][b_row][b_col]) = rb;
    }
    __syncthreads();
  }

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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// K1: C[g] = A[g / col_groups] @ B[g], g < G. A [G / col_groups, M, K], B
// [G, K, N], C [G, M, N], all contiguous float32 on the current device.
extern "C" int pim_matmul_grouped(const void* a, const void* b, void* c,
                                  int G, int col_groups, int M, int K, int N,
                                  void* stream) {
  if (G < 1 || G > 65535 || col_groups < 1 || G % col_groups != 0 ||
      M < kBM || M % kBM != 0 || N < kBN || N % kBN != 0 || N / kBN > 65535 ||
      K < kBK || K % kBK != 0 || !aligned16(a) || !aligned16(b) ||
      !aligned16(c))
    return (int)cudaErrorInvalidValue;
  dim3 grid(M / kBM, N / kBN, G);
  pim_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(c), M, K, N, col_groups);
  return (int)cudaGetLastError();
}

// K2: C = A @ B, A [M, K], B [K, N], C [M, N]: K1 with one group.
extern "C" int pim_matmul(const void* a, const void* b, void* c, int M, int K,
                          int N, void* stream) {
  return pim_matmul_grouped(a, b, c, 1, 1, M, K, N, stream);
}
