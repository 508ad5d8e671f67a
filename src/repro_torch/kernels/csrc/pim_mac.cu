// Elementwise PIM MAC over a wave of members, out = acc + a * b in
// float32, for Hopper (sm_90a): K3.
//
// Replaces: repro/kernels/pim_mac.py:_mac_kernel, the Pallas TPU kernel
// behind pim_mac and pim_mac_grouped. There the wave's operands are
// broadcast, filled (ones, zeros) and concatenated inside one jit around
// the pallas_call, where XLA folds them into the kernel's operands. This
// kernel is that fusion: one launch computes every member of a ragged
// wave from its operands where they lie. Same function, with the
// precision contract of the paper's MAC unit: two roundings, the product
// rounded to float32 and then the sum, never contracted into one fused
// multiply-add (__fmul_rn / __fadd_rn are never contracted by the
// compiler), immediates included: mul is 0 + a*b (a product of -0 gives
// +0), add is b + a*1, sub is a + b*(-1).
//
// Bound: bytes. Two flops per element against each operand read once
// where it lies (a broadcast bias once, an immediate never) and the
// output written once: 8 n bytes for a bias add, 16 n for three dense
// operands, over 3.35 TB/s on an H100 SXM. A member of a few thousand
// elements is launch latency, so a whole wave rides one launch.
//
// Design: the wave is a table of members passed by value as one
// __grid_constant__ kernel parameter (no host-to-device copy, no sync).
// Each member has an output pointer, a collapsed shape of at most four
// dims (outermost first, leading dims 1) and, per operand, a device
// pointer with element strides over those dims (0 on a broadcast dim) or
// a float32 immediate. The output is dense in the member's iteration
// order: the wrapper permutes the dims so that it is, and so writes the
// layout it was asked for. Blocks map to members through each member's
// first block (a prefix of ceil(n / kBlockElems)); a block finds its
// member by binary search and takes kBlockElems of its elements. A flat
// member (every pointer operand dense, or one value read once) runs the
// float4 path — 16-byte loads and stores, consecutive threads on
// consecutive addresses — where its pointers sit on 16 bytes, with no
// index arithmetic. A strided member reads through its index map, still
// consecutive threads on consecutive elements; below 2^31 elements (and
// offsets) its coordinates and offsets are 32-bit, the coordinates from
// multiply-shift division by divisors the wrapper precomputes (3
// instructions each, no divide), and where its inner dim allows (a bias
// broadcast over an NHWC view, say) it takes four elements at a time
// with 16-byte loads and stores.
// The table's size is a template argument, so a small wave does not pay
// at launch for copying the largest parameter block. A wave of more than
// kMaxMembers members (the most one parameter block holds) keeps its one
// launch: the wrapper copies the same table into device memory, stream
// ordered and without a host sync, and pim_mac_table_kernel reads it
// there, one member a block staged in shared memory.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kDims = 4;
constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kBlockElems = kThreads * kPerThread;
// kernel parameters a launch may take on Hopper with CUDA >= 12.1
constexpr int kParamBytes = 32764;

// member flags: bits 0-2 operand r is dense (a flat member's pointer
// with stride 1; a pointer without the bit reads one value); kFlagVec on
// a flat member: its dense operands sit on 16 bytes; on a strided one:
// strided_member4 reads it
enum : unsigned char { kFlagStrided = 8, kFlagVec = 16, kFlagWide = 32 };

struct Member {                  // 184 bytes; kernels/pim_mac.py packs it
  float* out;
  const float* ptr[3];           // a, b, acc; null: the immediate
  long long n;                   // elements
  long long stride[3][kDims];    // element strides of a, b, acc
  unsigned size[kDims];          // collapsed shape, outermost first
  unsigned magic[kDims - 1];     // size[1..3] as multiply-shift divisors
  float imm[3];
  int first_block;
  unsigned char shift[kDims - 1];
  unsigned char flags;
};

template <int kCap>
struct Wave {
  int members;
  int blocks;
  Member m[kCap];
};

constexpr int kMaxMembers =
    static_cast<int>((kParamBytes - offsetof(Wave<1>, m)) / sizeof(Member));
static_assert(sizeof(Member) == 184, "the wrapper packs 184-byte members");
static_assert(sizeof(Wave<kMaxMembers>) <= kParamBytes,
              "the largest table must fit the kernel parameters");

__device__ __forceinline__ float mac(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}

// A flat member's operand: a dense pointer (p), else its one value (k).
__device__ __forceinline__ float4 load4(const float* p, float k,
                                        long long q) {
  return p ? __ldg(reinterpret_cast<const float4*>(p) + q)
           : make_float4(k, k, k, k);
}

__device__ __forceinline__ float load1(const float* p, float k,
                                       long long i) {
  return p ? __ldg(p + i) : k;
}

// Elements [base, base + kBlockElems) of a member whose pointer operands
// are dense over its n elements or read one value (an immediate, or a
// pointer with every stride 0).
__device__ __forceinline__ void flat_member(const Member& m,
                                            long long base) {
  const float* p[3];
  float k[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float* ptr = m.ptr[r];
    const bool dense = m.flags & (1 << r);
    p[r] = dense ? ptr : nullptr;
    k[r] = ptr == nullptr ? m.imm[r] : (dense ? 0.f : __ldg(ptr));
  }
  const long long n = m.n;
  float* out = m.out;
  if (m.flags & kFlagVec) {
    const long long q0 = base / 4;
#pragma unroll
    for (int j = 0; j < kPerThread / 4; ++j) {
      const long long q = q0 + j * kThreads + threadIdx.x;
      const long long i = 4 * q;
      if (i + 4 <= n) {
        const float4 x = load4(p[0], k[0], q), y = load4(p[1], k[1], q),
                     z = load4(p[2], k[2], q);
        reinterpret_cast<float4*>(out)[q] =
            make_float4(mac(z.x, x.x, y.x), mac(z.y, x.y, y.y),
                        mac(z.z, x.z, y.z), mac(z.w, x.w, y.w));
      } else {
        for (long long e = i; e < n; ++e)      // the last n % 4
          out[e] = mac(load1(p[2], k[2], e), load1(p[0], k[0], e),
                       load1(p[1], k[1], e));
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const long long i = base + j * kThreads + threadIdx.x;
      if (i < n)
        out[i] = mac(load1(p[2], k[2], i), load1(p[0], k[0], i),
                     load1(p[1], k[1], i));
    }
  }
}

// x / size[d + 1] and x % size[d + 1] for x < 2^31: t = umulhi(x, magic),
// q = (t + x) >> shift (the wrapper's divisors; t + x < 2^32).
__device__ __forceinline__ unsigned divmod(const Member& m, int d,
                                           unsigned& x) {
  const unsigned q = (__umulhi(x, m.magic[d]) + x) >> m.shift[d];
  const unsigned r = x - q * m.size[d + 1];
  x = q;
  return r;
}

__device__ __forceinline__ unsigned long long divmod(
    const Member& m, int d, unsigned long long& x) {
  const unsigned long long s = m.size[d + 1];
  const unsigned long long q = x / s, r = x - q * s;
  x = q;
  return r;
}

// Elements [base, base + kBlockElems) of a member read through its index
// map: element i's coordinates over the collapsed shape (row-major), each
// pointer operand at the dot of those with its strides. I is the type
// of the coordinates and offsets: 32 bits, dividing by multiply-shift,
// where the member has fewer than 2^31 elements and every operand's
// offsets stay below 2^31 (the wrapper's kFlagWide says otherwise), else
// 64 bits. Each thread's loads are all issued before its first store.
template <typename I>
__device__ __forceinline__ void strided_member(const Member& m,
                                               long long base) {
  const long long n = m.n;
  float v[kPerThread][3];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long i = base + j * kThreads + threadIdx.x;
    if (i < n) {
      I rem = static_cast<I>(i);
      const I c3 = divmod(m, 2, rem);
      const I c2 = divmod(m, 1, rem);
      const I c1 = divmod(m, 0, rem);
      const I c0 = rem;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const float* ptr = m.ptr[r];
        const long long* s = m.stride[r];
        v[j][r] = ptr == nullptr
                      ? m.imm[r]
                      : __ldg(ptr + (c0 * static_cast<I>(s[0])
                                     + c1 * static_cast<I>(s[1])
                                     + c2 * static_cast<I>(s[2])
                                     + c3 * static_cast<I>(s[3])));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long i = base + j * kThreads + threadIdx.x;
    if (i < n) m.out[i] = mac(v[j][2], v[j][0], v[j][1]);
  }
}

// A strided member read four elements at a time: its inner dim a multiple
// of 4, each pointer operand's inner stride 1 (a float4, its other
// strides multiples of 4 and its address on 16 bytes: the wrapper's
// kFlagVec) or 0 (one value for the four), 32-bit coordinates. One
// coordinate computation per four elements, 16-byte loads and stores.
__device__ __forceinline__ void strided_member4(const Member& m,
                                                long long base) {
  const long long n = m.n;
  float4 v[kPerThread / 4][3];
#pragma unroll
  for (int j = 0; j < kPerThread / 4; ++j) {
    const long long i = base + 4 * (j * kThreads + threadIdx.x);
    if (i < n) {
      unsigned rem = static_cast<unsigned>(i);
      const unsigned c3 = divmod(m, 2, rem);
      const unsigned c2 = divmod(m, 1, rem);
      const unsigned c1 = divmod(m, 0, rem);
      const unsigned c0 = rem;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const float* ptr = m.ptr[r];
        const long long* s = m.stride[r];
        if (ptr == nullptr) {
          v[j][r] = make_float4(m.imm[r], m.imm[r], m.imm[r], m.imm[r]);
          continue;
        }
        const float* at = ptr + (c0 * static_cast<unsigned>(s[0])
                                 + c1 * static_cast<unsigned>(s[1])
                                 + c2 * static_cast<unsigned>(s[2])
                                 + c3 * static_cast<unsigned>(s[3]));
        if (s[3]) {
          v[j][r] = __ldg(reinterpret_cast<const float4*>(at));
        } else {
          const float x = __ldg(at);
          v[j][r] = make_float4(x, x, x, x);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kPerThread / 4; ++j) {
    const long long i = base + 4 * (j * kThreads + threadIdx.x);
    if (i < n) {
      const float4 x = v[j][0], y = v[j][1], z = v[j][2];
      *reinterpret_cast<float4*>(m.out + i) =
          make_float4(mac(z.x, x.x, y.x), mac(z.y, x.y, y.y),
                      mac(z.z, x.z, y.z), mac(z.w, x.w, y.w));
    }
  }
}

// The last member of table m[0, members) whose first block is at or
// before blk.
__device__ __forceinline__ int member_of(const Member* m, int members,
                                         int blk) {
  int lo = 0, hi = members - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (m[mid].first_block <= blk) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// This block's kBlockElems elements of member m.
__device__ __forceinline__ void member_block(const Member& m, int blk) {
  const long long base =
      static_cast<long long>(blk - m.first_block) * kBlockElems;
  if (!(m.flags & kFlagStrided))
    flat_member(m, base);
  else if (m.flags & kFlagWide)
    strided_member<unsigned long long>(m, base);
  else if (m.flags & kFlagVec)
    strided_member4(m, base);
  else
    strided_member<unsigned>(m, base);
}

template <int kCap>
__global__ void __launch_bounds__(kThreads)
pim_mac_kernel(const __grid_constant__ Wave<kCap> w) {
  const int blk = blockIdx.x;
  member_block(w.m[member_of(w.m, w.members, blk)], blk);
}

// The same over a table in device memory, for a wave above kMaxMembers:
// one thread finds the block's member and stages it in shared memory.
__global__ void __launch_bounds__(kThreads)
pim_mac_table_kernel(const Member* __restrict__ table, int members) {
  __shared__ Member m;
  const int blk = blockIdx.x;
  if (threadIdx.x == 0) m = table[member_of(table, members, blk)];
  __syncthreads();
  member_block(m, blk);
}

template <int kCap>
int launch(const Member* table, int members, int blocks,
           cudaStream_t stream) {
  Wave<kCap> w;
  w.members = members;
  w.blocks = blocks;
  memcpy(w.m, table, sizeof(Member) * members);
  pim_mac_kernel<kCap><<<blocks, kThreads, 0, stream>>>(w);
  return (int)cudaGetLastError();
}

long long blocks_of(long long n) {
  return (n + kBlockElems - 1) / kBlockElems;
}

// Whether ``members`` packed rows, ``blocks`` blocks in all, are a wave:
// each row's first block the sum of the rows before it.
bool valid_table(const Member* rows, int members, int blocks) {
  if (members < 1 || blocks < 1) return false;
  long long next = 0;
  for (int i = 0; i < members; ++i) {
    if (rows[i].n < 1 || rows[i].first_block != next) return false;
    next += blocks_of(rows[i].n);
  }
  return next == blocks;
}

}  // namespace

// One launch over ``members`` rows of ``table`` (the wrapper's packed
// Member array, each row's first block the sum of the rows before it),
// ``blocks`` in all, on ``stream``: the table passed by value, at most
// kMaxMembers rows.
extern "C" int pim_mac_wave(const void* table, int members, int blocks,
                            void* stream) {
  const Member* rows = static_cast<const Member*>(table);
  if (members > kMaxMembers || !valid_table(rows, members, blocks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (members <= 4) return launch<4>(rows, members, blocks, s);
  if (members <= 32) return launch<32>(rows, members, blocks, s);
  return launch<kMaxMembers>(rows, members, blocks, s);
}

// The same wave of any number of rows, read from ``device_table``: a copy
// of ``table`` in device memory that is ready on ``stream`` (the caller
// enqueued it there) and stays allocated until this launch has run.
// ``table``, on the host, is what is checked.
extern "C" int pim_mac_wave_table(const void* table, const void* device_table,
                                  int members, int blocks, void* stream) {
  if (!valid_table(static_cast<const Member*>(table), members, blocks))
    return (int)cudaErrorInvalidValue;
  pim_mac_table_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Member*>(device_table), members);
  return (int)cudaGetLastError();
}

// The layout the wrapper packs and checks at load time: 0 sizeof(Member),
// 1 the member cap, 2 elements a block takes, 3 offsetof(Member,
// first_block); and 4 the CUDA toolkit the library was built with.
extern "C" int pim_mac_layout(int what) {
  switch (what) {
    case 0: return static_cast<int>(sizeof(Member));
    case 1: return kMaxMembers;
    case 2: return kBlockElems;
    case 3: return static_cast<int>(offsetof(Member, first_block));
    case 4: return CUDART_VERSION;
  }
  return -1;
}
