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
// that no slot walks its history alone and the card's SMs share the keys:
// paged_decode_split_kernel and paged_decode_combine_kernel, thin wrappers
// of the split and combine passes that K6 shares (paged_decode_split.cuh,
// which states the schedule). K4's rows are values of q's dtype T, read as
// they are (a whole 16-byte row chunk against the float32 q row), and the
// probabilities are rounded to T before the PV product: the template
// argument P of split_pass is T here, as the Pallas kernel casts them to
// v's dtype. What it does not yet do about the bound: the two kernels'
// launch and the DRAM latency of pos, the table and the rows sit on one
// chain of each split (a persistent block or a CUDA graph of the decode
// step would hide them), and the workspace makes a round trip through L2.

#include "paged_decode_split.cuh"

namespace {

using namespace paged_split;

// K4's rows: values of T, read as they are (no scale)
template <typename T>
struct ValueRows {
  using Code = T;
  static constexpr bool kScaled = false;
  const T* k;
  const T* v;

  __device__ __forceinline__ float value(T x, float) const {
    return to_f32(x);
  }
};

// P = T: the probabilities are rounded to v's dtype before the PV product
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
  split_pass<ValueRows<T>, T, R>(ValueRows<T>{k_pool, v_pool}, q, table,
                                 pos, ws_acc, ws_ml, G, rep, D, bs, W, nb,
                                 scale);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_combine_kernel(const float* __restrict__ ws_acc,
                            const float* __restrict__ ws_ml,
                            T* __restrict__ out,   // [B, H, D]
                            int G, int rep, int D, int n_split) {
  combine_pass<T>(ws_acc, ws_ml, out, G, rep, D, n_split);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* table,
           const void* pos, void* out, void* ws_acc, void* ws_ml, int B,
           int H, int G, int D, int bs, int W, int nb, cudaStream_t stream) {
  const int rep = H / G, n_split = (W + nb - 1) / nb;
  const int e = with_rep(rep, [&](auto r) {
    constexpr int R = decltype(r)::value;
    return launch_kernel(
        paged_decode_split_kernel<T, R>, dim3(B * G, n_split),
        split_smem_bytes<ValueRows<T>, R>(D, nb, bs), stream,
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int32_t*>(table),
        static_cast<const int32_t*>(pos), static_cast<float*>(ws_acc),
        static_cast<float*>(ws_ml), G, rep, D, bs, W, nb,
        1.0f / sqrtf((float)D));
  });
  if (e != 0) return e;
  return launch_kernel(paged_decode_combine_kernel<T>, dim3(B * H), 0,
                       stream, static_cast<const float*>(ws_acc),
                       static_cast<const float*>(ws_ml), static_cast<T*>(out),
                       G, rep, D, n_split);
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
  if (!split_args_ok(B, H, G, D, bs, W, nb) || D < 8 || D % 8 != 0 ||
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
