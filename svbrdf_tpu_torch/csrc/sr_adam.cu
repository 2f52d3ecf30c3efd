// Fused Adam update with stochastic rounding to bf16, for Hopper.
//
// Not a port of a TPU kernel: in the JAX package XLA fuses this update
// (svbrdf_tpu/parallel/optimizer.py scale_by_adam_bf16sr and the bf16
// masters' SR in svbrdf_tpu/parallel/step.py make_train_step). In eager
// PyTorch its plain version (svbrdf_tpu_torch/parallel/optimizer.py
// adam_update_plain) runs as dozens of passes over each leaf, several of
// them on int64 tensors for the dither; this kernel is one pass.
//
// What it computes, per element of one parameter tensor (one launch per
// tensor), all arithmetic in f32:
//   mu' = mu * b1 + g * (1 - b1)            stored round-to-nearest
//   nu' = nu * b2 + g * g * (1 - b2)        bf16: stochastically rounded
//   u   = (mu' / bc1) / (sqrt(nu' / bc2) + eps) * (-lr)
//   p'  = p + u                              bf16: stochastically rounded
// where the SR of x to bf16 adds the low 16 bits of a counter-based hash
// of (element index, salt) to x's bit pattern and truncates (JAX's
// _dither_bits: two multiply-xorshift rounds in uint32), nu with the
// leaf's moment salt and p with its master salt. g, p, mu and nu are each
// f32 or bf16 (a template on the four); the wrapper passes the salts and
// the f32 scalars from the host.
//
// Rounding: the plain version's ops in its order, IEEE division and
// sqrtf, no contraction into FMAs (built with -fmad=false, ops/_build.py),
// the hash in uint32: bit-exact with the plain version.
//
// What bounds it on this card: memory. With bf16 masters, bf16 gradients
// and bf16 moments it reads 8 bytes and writes 6 per element and does ~20
// f32 and ~25 integer operations, far below the ~20 operations per byte
// where the card's issue rate would bound it. The design is the simplest
// that touches each value once: one thread per element over a grid-stride
// loop, neighbouring threads on neighbouring elements. One launch per
// tensor (~100 a step) and scalar loads are left for a later pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;

struct Scalars {
  float b1, omb1, b2, omb2, bc1, bc2, eps, neg_lr;
  unsigned nu_salt, master_salt;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// JAX's _dither_bits for element `idx` (the index modulo 2^32, as its
// uint32 iota) and `salt`.
__device__ __forceinline__ unsigned dither(unsigned idx, unsigned salt) {
  unsigned z = idx * 0x9E3779B9u + salt * 0x85EBCA6Bu;
  z ^= z >> 16;
  z *= 0x7FEB352Du;
  z ^= z >> 15;
  return z ^ (z >> 16);
}

__device__ __forceinline__ __nv_bfloat16 sr_bf16(float x, unsigned idx,
                                                 unsigned salt) {
  unsigned hi = (__float_as_uint(x) + (dither(idx, salt) & 0xFFFFu)) >> 16;
  return __ushort_as_bfloat16(static_cast<unsigned short>(hi));
}

// Round to nearest (mu).
__device__ __forceinline__ void store_rn(float* a, long long i, float x) {
  a[i] = x;
}
__device__ __forceinline__ void store_rn(__nv_bfloat16* a, long long i,
                                         float x) {
  a[i] = __float2bfloat16_rn(x);
}

// Stochastic rounding where the storage is bf16 (nu, p), else as is.
__device__ __forceinline__ void store_sr(float* a, long long i, float x,
                                         unsigned) {
  a[i] = x;
}
__device__ __forceinline__ void store_sr(__nv_bfloat16* a, long long i,
                                         float x, unsigned salt) {
  a[i] = sr_bf16(x, static_cast<unsigned>(i), salt);
}

template <class P, class G, class M, class N>
__global__ void __launch_bounds__(kThreads)
sr_adam_kernel(P* __restrict__ p, const G* __restrict__ g,
               M* __restrict__ mu, N* __restrict__ nu, long long n,
               Scalars s) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    const float g32 = to_f32(g[i]);
    const float mu32 = to_f32(mu[i]) * s.b1 + g32 * s.omb1;
    const float nu32 = to_f32(nu[i]) * s.b2 + g32 * g32 * s.omb2;
    float u = (mu32 / s.bc1) / (sqrtf(nu32 / s.bc2) + s.eps);
    u = u * s.neg_lr;
    store_rn(mu, i, mu32);
    store_sr(nu, i, nu32, s.nu_salt);
    store_sr(p, i, to_f32(p[i]) + u, s.master_salt);
  }
}

template <class P, class G, class M, class N>
int launch(void* p, const void* g, void* mu, void* nu, long long n,
           const Scalars& s, cudaStream_t stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks > 0) {
    sr_adam_kernel<P, G, M, N><<<static_cast<int>(blocks), kThreads, 0,
                                 stream>>>(
        static_cast<P*>(p), static_cast<const G*>(g), static_cast<M*>(mu),
        static_cast<N*>(nu), n, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// Picks the template instance from the four storage flags, one at a time.
template <class... T>
struct Pick {
  static int run(const int* flags, void* p, const void* g, void* mu,
                 void* nu, long long n, const Scalars& s,
                 cudaStream_t stream) {
    if constexpr (sizeof...(T) == 4) {
      return launch<T...>(p, g, mu, nu, n, s, stream);
    } else {
      return flags[sizeof...(T)]
                 ? Pick<T..., __nv_bfloat16>::run(flags, p, g, mu, nu, n, s,
                                                  stream)
                 : Pick<T..., float>::run(flags, p, g, mu, nu, n, s, stream);
    }
  }
};

}  // namespace

extern "C" {

// One leaf's update in place. *_bf16 say whether each tensor holds bf16
// (else f32); all four hold n elements, contiguous. Returns the CUDA error
// of the launch (0: launched).
int svbrdf_sr_adam(void* p, const void* g, void* mu, void* nu, long long n,
                   int p_bf16, int g_bf16, int mu_bf16, int nu_bf16,
                   unsigned nu_salt, unsigned master_salt, float b1,
                   float omb1, float b2, float omb2, float bc1, float bc2,
                   float eps, float neg_lr, void* stream) {
  const int flags[4] = {p_bf16, g_bf16, mu_bf16, nu_bf16};
  const Scalars s{b1, omb1, b2, omb2, bc1, bc2, eps, neg_lr, nu_salt,
                  master_salt};
  return Pick<>::run(flags, p, g, mu, nu, n, s,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
