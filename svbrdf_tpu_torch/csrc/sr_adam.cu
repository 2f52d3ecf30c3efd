// Fused Adam update with stochastic rounding to bf16, for Hopper: every
// parameter tensor of an optimizer step in one launch.
//
// Not a port of a TPU kernel: in the JAX package XLA fuses this update
// (svbrdf_tpu/parallel/optimizer.py scale_by_adam_bf16sr and the bf16
// masters' SR in svbrdf_tpu/parallel/step.py make_train_step). In eager
// PyTorch its plain version (svbrdf_tpu_torch/parallel/optimizer.py
// adam_update_plain) runs as dozens of passes over each leaf, several of
// them on int64 tensors for the dither; this kernel is one pass over all
// of them.
//
// What it computes, per element of each leaf of the launch's table, all
// arithmetic in f32:
//   mu' = mu * b1 + g * (1 - b1)            stored round-to-nearest
//   nu' = nu * b2 + g * g * (1 - b2)        bf16: stochastically rounded
//   u   = (mu' / bc1) / (sqrt(nu' / bc2) + eps) * (-lr)
//   p'  = p + u                              bf16: stochastically rounded
// where the SR of x to bf16 adds the low 16 bits of a counter-based hash
// of (element index in the leaf, salt) to x's bit pattern and truncates
// (JAX's _dither_bits: two multiply-xorshift rounds in uint32). Leaf i of
// the optimizer takes the moment salt nu_base + i and the master salt
// master_salt + i, in uint32. g, p, mu and nu are each f32 or bf16, per
// leaf.
//
// In the 'bf16' state mode (optax.adam(mu_dtype=bfloat16)) the launch's
// flag picks the other kernel, which forms mu' in optax's order instead:
//   mu' = f32(bf16(mu * bf16(b1))) + g * (1 - b1)
// the product of two bf16 values exact in f32 and rounded once to bf16;
// u is computed from that f32 mu' and only the stored mu is rounded. The
// two kernels share every other line, so sr_adam_kernel's code is the
// same as without the second one.
//
// Rounding: the plain version's ops in its order, IEEE division and
// sqrtf, no contraction into FMAs (built with -fmad=false, ops/_build.py),
// the hash in uint32: bit-exact with the plain version.
//
// What bounds it on this card: bytes. With bf16 masters, gradients and
// moments it reads 8 bytes and writes 6 per element, 1.12 GB a step of
// the full-width models (0.334 ms at 3.35 TB/s). Issue is close behind:
// bit-exactness keeps three IEEE divisions and an IEEE square root per
// element, with their slow-path calls, and the two hashes, so the
// all-bf16 vector loop is 790 SASS instructions for 8 elements (~99 an
// element; all-f32: 598), ~0.24 ms of issue at 132 SMs x 4 schedulers,
// 70 % of the bytes' time (chip_smoke.py counts them). 70 registers, 3
// blocks of 256 threads per SM; capping at 64 registers spills. The
// design:
//   - one launch per step: the wrapper passes a table of leaves (pointers,
//     dtype code, leaf index) by value as a __grid_constant__
//     parameter, so no buffer can change under a queued launch, and a
//     chunk map (entry, first element, length) built once per leaf layout;
//     each block updates one chunk, a branch uniform over the block picks
//     the leaf's dtype combination;
//   - 16-byte loads and stores (8 bf16 values, or two float4), all four
//     tensors' loads issued before the arithmetic, streaming cache hints
//     (about 1.1 GB a step passes through the 50 MB L2 once), 32-bit
//     offsets inside a chunk from one 64-bit base per chunk;
//   - leaf tails (n % 8) and leaves whose four pointers are not all
//     16-byte aligned take a scalar loop in the same kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // elements per vector step: 16 bytes of bf16
// Leaves per table. The table travels as a kernel parameter: up to 32,764
// bytes of parameters from CUDA 12.1 on, 4,096 before.
#if CUDART_VERSION >= 12010
constexpr int kMaxLeaves = 256;
#else
constexpr int kMaxLeaves = 80;
#endif

struct Scalars {
  float b1, omb1, b2, omb2, bc1, bc2, eps, neg_lr;
  unsigned nu_base, master_salt;
};

// One leaf as the wrapper packs it: five 64-bit words (its size is in the
// chunk map).
struct Leaf {
  void* p;
  const void* g;
  void* mu;
  void* nu;
  int code;  // bits 0-3: p, g, mu, nu hold bf16; bit 4: all 16-byte aligned
  unsigned index;  // position over all the optimizer's parameters
};
static_assert(sizeof(Leaf) == 40, "the wrapper packs five 64-bit words");

constexpr int kAligned = 16;

struct Table {
  Scalars s;
  Leaf leaves[kMaxLeaves];
};
static_assert(sizeof(Table) <= (CUDART_VERSION >= 12010 ? 32764 : 4096),
              "the table must fit the kernel parameter space");

// JAX's _dither_bits for element `idx` (the index modulo 2^32, as its
// uint32 iota) and `salt`.
__device__ __forceinline__ unsigned dither(unsigned idx, unsigned salt) {
  unsigned z = idx * 0x9E3779B9u + salt * 0x85EBCA6Bu;
  z ^= z >> 16;
  z *= 0x7FEB352Du;
  z ^= z >> 15;
  return z ^ (z >> 16);
}

// The bf16 bit pattern of x stochastically rounded.
__device__ __forceinline__ unsigned sr_bits(float x, unsigned idx,
                                            unsigned salt) {
  return (__float_as_uint(x) + (dither(idx, salt) & 0xFFFFu)) >> 16;
}

__device__ __forceinline__ unsigned rn_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// Eight consecutive values, 16-byte aligned, widened to f32.
__device__ __forceinline__ void load8(const float* a, float (&v)[kVec]) {
  const float4 x = __ldcs(reinterpret_cast<const float4*>(a));
  const float4 y = __ldcs(reinterpret_cast<const float4*>(a) + 1);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* a,
                                      float (&v)[kVec]) {
  const uint4 x = __ldcs(reinterpret_cast<const uint4*>(a));
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
  }
}

// Eight f32 values stored as they are (f32) or as the bf16 patterns that
// `round` gives for (value, k).
template <class Round>
__device__ __forceinline__ void store8(float* a, const float (&v)[kVec],
                                       Round) {
  __stcs(reinterpret_cast<float4*>(a), make_float4(v[0], v[1], v[2], v[3]));
  __stcs(reinterpret_cast<float4*>(a) + 1,
         make_float4(v[4], v[5], v[6], v[7]));
}
template <class Round>
__device__ __forceinline__ void store8(__nv_bfloat16* a,
                                       const float (&v)[kVec], Round round) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[k] = round(v[2 * k], 2 * k) | (round(v[2 * k + 1], 2 * k + 1) << 16);
  }
  __stcs(reinterpret_cast<uint4*>(a), make_uint4(w[0], w[1], w[2], w[3]));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One element, stored round-to-nearest (mu) or stochastically rounded (nu,
// p) where the storage is bf16.
__device__ __forceinline__ void store1_rn(float* a, float x) { *a = x; }
__device__ __forceinline__ void store1_rn(__nv_bfloat16* a, float x) {
  *a = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store1_sr(float* a, float x, unsigned,
                                          unsigned) {
  *a = x;
}
__device__ __forceinline__ void store1_sr(__nv_bfloat16* a, float x,
                                          unsigned idx, unsigned salt) {
  *a = __ushort_as_bfloat16(static_cast<unsigned short>(
      sr_bits(x, idx, salt)));
}

// The update of one element, in the plain version's order; kBf16Mu: the
// first moment's product with b1 in bf16, as optax forms a bf16 mu.
struct Moments {
  float mu, nu, u;
};
template <bool kBf16Mu>
__device__ __forceinline__ Moments adam(float g32, float mu, float nu,
                                        const Scalars& s) {
  float mu32;
  if constexpr (kBf16Mu) {
    const float b1 = __bfloat162float(__float2bfloat16_rn(s.b1));
    mu32 = __bfloat162float(__float2bfloat16_rn(mu * b1)) + g32 * s.omb1;
  } else {
    mu32 = mu * s.b1 + g32 * s.omb1;
  }
  const float nu32 = nu * s.b2 + g32 * g32 * s.omb2;
  float u = (mu32 / s.bc1) / (sqrtf(nu32 / s.bc2) + s.eps);
  u = u * s.neg_lr;
  return {mu32, nu32, u};
}

// One chunk of one leaf: elements [first, first + len).
template <bool kBf16Mu, class P, class G, class M, class N>
__device__ __forceinline__ void update_chunk(const Leaf& leaf,
                                             long long first, int len,
                                             const Scalars& s) {
  P* p = static_cast<P*>(leaf.p) + first;
  const G* g = static_cast<const G*>(leaf.g) + first;
  M* mu = static_cast<M*>(leaf.mu) + first;
  N* nu = static_cast<N*>(leaf.nu) + first;
  const unsigned nu_salt = s.nu_base + leaf.index;
  const unsigned p_salt = s.master_salt + leaf.index;
  const unsigned base = static_cast<unsigned>(first);
  // Chunk starts are multiples of kVec elements, so a leaf whose pointers
  // are 16-byte aligned keeps every vector of the chunk aligned.
  const int n_vec = (leaf.code & kAligned) ? len / kVec : 0;
#pragma unroll 1
  for (int v = threadIdx.x; v < n_vec; v += kThreads) {
    const int j = v * kVec;
    float gv[kVec], pv[kVec], mv[kVec], nv[kVec];
    load8(g + j, gv);
    load8(mu + j, mv);
    load8(nu + j, nv);
    load8(p + j, pv);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const Moments m = adam<kBf16Mu>(gv[k], mv[k], nv[k], s);
      mv[k] = m.mu;
      nv[k] = m.nu;
      pv[k] = pv[k] + m.u;
    }
    const unsigned idx = base + static_cast<unsigned>(j);
    store8(mu + j, mv, [](float x, int) { return rn_bits(x); });
    store8(nu + j, nv, [=](float x, int k) {
      return sr_bits(x, idx + k, nu_salt);
    });
    store8(p + j, pv, [=](float x, int k) {
      return sr_bits(x, idx + k, p_salt);
    });
  }
  for (int j = n_vec * kVec + threadIdx.x; j < len; j += kThreads) {
    const Moments m =
        adam<kBf16Mu>(to_f32(g[j]), to_f32(mu[j]), to_f32(nu[j]), s);
    const unsigned idx = base + static_cast<unsigned>(j);
    store1_rn(mu + j, m.mu);
    store1_sr(nu + j, m.nu, idx, nu_salt);
    store1_sr(p + j, to_f32(p[j]) + m.u, idx, p_salt);
  }
}

template <bool kBf16>
using Storage = std::conditional_t<kBf16, __nv_bfloat16, float>;

// The body for the leaf's dtype code, one comparison at a time.
template <bool kBf16Mu, int kCode = 0>
__device__ __forceinline__ void dispatch(const Leaf& leaf, long long first,
                                         int len, const Scalars& s) {
  if constexpr (kCode < 16) {
    if ((leaf.code & 15) == kCode) {
      update_chunk<kBf16Mu, Storage<(kCode & 1) != 0>,
                   Storage<(kCode & 2) != 0>, Storage<(kCode & 4) != 0>,
                   Storage<(kCode & 8) != 0>>(leaf, first, len, s);
    } else {
      dispatch<kBf16Mu, kCode + 1>(leaf, first, len, s);
    }
  }
}

// One block per chunk; chunks[3 * b .. 3 * b + 2] = (table entry, first
// element, length) of block b.
template <bool kBf16Mu>
__device__ __forceinline__ void update_block(const Table& table,
                                             const long long* chunks) {
  const long long* c = chunks + 3 * static_cast<long long>(blockIdx.x);
  const Leaf& leaf = table.leaves[static_cast<int>(__ldg(c))];
  dispatch<kBf16Mu>(leaf, __ldg(c + 1), static_cast<int>(__ldg(c + 2)),
                    table.s);
}

__global__ void __launch_bounds__(kThreads)
sr_adam_kernel(const __grid_constant__ Table table,
               const long long* __restrict__ chunks) {
  update_block<false>(table, chunks);
}

// The 'bf16' state mode's update (optax's bf16 mu), launched when the
// launch's flag asks for it.
__global__ void __launch_bounds__(kThreads)
sr_adam_bf16mu_kernel(const __grid_constant__ Table table,
                      const long long* __restrict__ chunks) {
  update_block<true>(table, chunks);
}

}  // namespace

extern "C" {

// The leaves one launch's table holds.
int svbrdf_sr_adam_max_leaves(void) { return kMaxLeaves; }

// The update of n_leaves leaves in place, one launch: `leaves` points to
// n_leaves packed Leaf records on the host, `chunks` to n_chunks (entry,
// first element, length) int64 triples on the device; bf16_mu_product
// nonzero: the first moment in optax's bf16-mu order (the 'bf16' state
// mode). Returns the CUDA error of the launch (0: launched).
int svbrdf_sr_adam_multi(const void* leaves, int n_leaves,
                         const long long* chunks, long long n_chunks,
                         unsigned nu_base, unsigned master_salt, float b1,
                         float omb1, float b2, float omb2, float bc1,
                         float bc2, float eps, float neg_lr,
                         int bf16_mu_product, void* stream) {
  if (n_leaves < 0 || n_leaves > kMaxLeaves || n_chunks < 0 ||
      n_chunks > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_chunks == 0) return 0;
  Table table;
  table.s = Scalars{b1, omb1, b2, omb2, bc1, bc2, eps, neg_lr, nu_base,
                    master_salt};
  std::memcpy(table.leaves, leaves, sizeof(Leaf) * n_leaves);
  const unsigned blocks = static_cast<unsigned>(n_chunks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_mu_product) {
    sr_adam_bf16mu_kernel<<<blocks, kThreads, 0, st>>>(table, chunks);
  } else {
    sr_adam_kernel<<<blocks, kThreads, 0, st>>>(table, chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
