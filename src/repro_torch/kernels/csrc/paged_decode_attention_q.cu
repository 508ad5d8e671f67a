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
// Table entries past pos[b] are never followed: they point at the
// scratch block 0, which holds garbage codes and scales.
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
// Design: K4's split-KV schedule (paged_decode_split.cuh, which states it)
// in two kernels of K6's own names, paged_decode_q_split_kernel and
// paged_decode_q_combine_kernel; the wrapper chooses the splits with K4's
// split_policy and allocates the float32 workspace. What differs from K4:
// - Each split copies its rows' codes into shared memory as they are
//   stored, by 16-byte cp.async copies (D codes: 128 B a row at D 128 for
//   1-byte codes, 256 B for the fp16 grid's 16-bit codes), and each row's
//   float32 scale beside it by a 4-byte copy. K's codes are then
//   dequantized once into float32 rows in shared memory (every thread
//   four elements at a time), which the scores read as K4's float32 path
//   does: each warp scores one query row against every key, so decoding
//   in the score loop would decode each element once a warp. V stays at
//   code width: thread d decodes its V element in the PV product, once.
// - Every element is dequantized exactly as dequantize_kv does it:
//   __fmul_rn(decode(code), scale), one rounding; the scale is not folded
//   out of the dot product, which would round differently.
// - The probabilities are NOT rounded before the PV product: the template
//   argument P of split_pass is float here. The reference casts them to
//   v's dtype, and v is float32 once dequantized; rounding them to bf16
//   under bf16 q, as K4 does, would pass the bf16 tolerance and still be
//   another function.
// What it does not yet do about the bound is K4's: the launch and the DRAM
// latency of pos, the table and the rows on one chain of each split, the
// workspace's round trip through L2; and K's float32 rows take four times
// the shared memory of its codes, with a fourth barrier.

#include "paged_decode_split.cuh"

namespace {

using namespace paged_split;

// The float grids' sign|exp|mant code -> float32 (repro.core.quant
// decode_float): exponent field 0 is +0, every other field a normal binade
// whose exponent is the field - bias + 127.
struct FloatGrid {
  uint32_t em_mask;     // the exponent and mantissa fields
  int n_mant;
  int sign_up;          // shift that takes the sign bit to bit 31
  uint32_t bias_add;    // (127 - bias) << 23
};

__device__ __forceinline__ float decode(int8_t c, const FloatGrid&) {
  return (float)c;
}
__device__ __forceinline__ float decode(uint32_t c, const FloatGrid& f) {
  const uint32_t em = c & f.em_mask;
  if ((em >> f.n_mant) == 0) return 0.f;
  return __uint_as_float(((c << f.sign_up) & 0x80000000u) |
                         ((em << (23 - f.n_mant)) + f.bias_add));
}
__device__ __forceinline__ float decode(uint8_t c, const FloatGrid& f) {
  return decode((uint32_t)c, f);
}
__device__ __forceinline__ float decode(uint16_t c, const FloatGrid& f) {
  return decode((uint32_t)c, f);
}

// K6's rows: codes of C, one float32 scale a row
template <typename C>
struct CodeRows {
  using Code = C;
  static constexpr bool kScaled = true;
  const C* k;
  const C* v;
  const float* ks;
  const float* vs;
  FloatGrid grid;

  // dequantize_kv: the decoded value times its row's scale, one rounding
  __device__ __forceinline__ float value(C c, float s) const {
    return __fmul_rn(decode(c, grid), s);
  }
  // four elements as float32: 4 (1-byte) or 8 (2-byte) bytes of a row
  __device__ __forceinline__ void widen4(const C* c, float s,
                                         float* out) const {
    float4 f;
    if constexpr (sizeof(C) == 1) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(c);
      f = make_float4(value(static_cast<C>(w), s),
                      value(static_cast<C>(w >> 8), s),
                      value(static_cast<C>(w >> 16), s),
                      value(static_cast<C>(w >> 24), s));
    } else {
      const uint2 w = *reinterpret_cast<const uint2*>(c);
      f = make_float4(value(static_cast<C>(w.x), s),
                      value(static_cast<C>(w.x >> 16), s),
                      value(static_cast<C>(w.y), s),
                      value(static_cast<C>(w.y >> 16), s));
    }
    *reinterpret_cast<float4*>(out) = f;
  }
};

// P = float: the probabilities are not rounded before the PV product
template <typename T, typename C, int R>
__global__ void __launch_bounds__(kThreads)
paged_decode_q_split_kernel(const T* __restrict__ q,           // [B, H, D]
                            const C* __restrict__ k_pool,      // [N,bs,G,D]
                            const float* __restrict__ k_scale,  // [N,bs,G,1]
                            const C* __restrict__ v_pool,      // [N,bs,G,D]
                            const float* __restrict__ v_scale,  // [N,bs,G,1]
                            const int32_t* __restrict__ table,  // [B, W]
                            const int32_t* __restrict__ pos,    // [B]
                            float* __restrict__ ws_acc,  // [B,G,n,rep,D]
                            float* __restrict__ ws_ml,   // [B,G,n,rep,2]
                            int G, int rep, int D, int bs, int W, int nb,
                            float scale, FloatGrid grid) {
  split_pass<CodeRows<C>, float, R>(
      CodeRows<C>{k_pool, v_pool, k_scale, v_scale, grid}, q, table, pos,
      ws_acc, ws_ml, G, rep, D, bs, W, nb, scale);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_q_combine_kernel(const float* __restrict__ ws_acc,
                              const float* __restrict__ ws_ml,
                              T* __restrict__ out,   // [B, H, D]
                              int G, int rep, int D, int n_split) {
  combine_pass<T>(ws_acc, ws_ml, out, G, rep, D, n_split);
}

struct Args {
  const void *q, *k, *ks, *v, *vs, *table, *pos;
  void *out, *ws_acc, *ws_ml;
  int B, H, G, D, bs, W, nb;
  FloatGrid grid;
  cudaStream_t stream;
};

template <typename T, typename C>
int launch(const Args& a) {
  const int rep = a.H / a.G, n_split = (a.W + a.nb - 1) / a.nb;
  const int e = with_rep(rep, [&](auto r) {
    constexpr int R = decltype(r)::value;
    return launch_kernel(
        paged_decode_q_split_kernel<T, C, R>, dim3(a.B * a.G, n_split),
        split_smem_bytes<CodeRows<C>, R>(a.D, a.nb, a.bs), a.stream,
        static_cast<const T*>(a.q), static_cast<const C*>(a.k),
        static_cast<const float*>(a.ks), static_cast<const C*>(a.v),
        static_cast<const float*>(a.vs), static_cast<const int32_t*>(a.table),
        static_cast<const int32_t*>(a.pos), static_cast<float*>(a.ws_acc),
        static_cast<float*>(a.ws_ml), a.G, rep, a.D, a.bs, a.W, a.nb,
        1.0f / sqrtf((float)a.D), a.grid);
  });
  if (e != 0) return e;
  return launch_kernel(paged_decode_q_combine_kernel<T>, dim3(a.B * a.H), 0,
                       a.stream, static_cast<const float*>(a.ws_acc),
                       static_cast<const float*>(a.ws_ml),
                       static_cast<T*>(a.out), a.G, rep, a.D, n_split);
}

template <typename T>
int launch_codes(const Args& a, int codes) {
  switch (codes) {
    case 0:
      return launch<T, int8_t>(a);
    case 1:
      return launch<T, uint8_t>(a);
    case 2:
      return launch<T, uint16_t>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (q and out): 0 = float32, 1 = bfloat16. codes: 0 = int8 codes of
// the int8 grid; 1 = uint8 and 2 = 16-bit sign|exp|mant codes of a float
// grid with n_exp exponent bits, n_mant mantissa bits and exponent bias
// `bias`. D * (bytes a code) a multiple of 16; k/v 16-byte aligned; nb <=
// 128 table entries a split; ws_acc [B, G, n_split, rep, D] and ws_ml [B,
// G, n_split, rep, 2] float32, n_split = ceil(W / nb). Returns a
// cudaError_t (0 on success).
extern "C" int paged_decode_attention_q(
    const void* q, const void* k, const void* k_scale, const void* v,
    const void* v_scale, const void* table, const void* pos, void* out,
    void* ws_acc, void* ws_ml, int B, int H, int G, int D, int bs, int W,
    int nb, int dtype, int codes, int n_exp, int n_mant, int bias,
    void* stream) {
  if (codes < 0 || codes > 2 || !split_args_ok(B, H, G, D, bs, W, nb))
    return (int)cudaErrorInvalidValue;
  const int width = codes == 2 ? 16 : 8;
  if ((D * width / 8) % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16)
    return (int)cudaErrorInvalidValue;
  FloatGrid grid{0u, 0, 0, 0u};
  if (codes != 0) {
    if (n_exp < 1 || n_mant < 0 || n_mant > 23 ||
        1 + n_exp + n_mant > width || bias < 0 || bias > 126)
      return (int)cudaErrorInvalidValue;
    grid = FloatGrid{(1u << (n_exp + n_mant)) - 1u, n_mant,
                     31 - (n_exp + n_mant), (uint32_t)(127 - bias) << 23};
  }
  const Args a{q, k, k_scale, v, v_scale, table, pos, out, ws_acc, ws_ml,
               B, H, G, D, bs, W, nb, grid, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0:
      return launch_codes<float>(a, codes);
    case 1:
      return launch_codes<__nv_bfloat16>(a, codes);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
