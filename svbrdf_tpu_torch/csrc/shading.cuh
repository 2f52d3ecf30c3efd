// Per-pixel Cook-Torrance shading and its hand-derived VJP, shared by the
// loss kernels (mixed_loss.cu, rendering_loss.cu).
//
// Device translation of the in-kernel helpers of
// svbrdf_tpu/ops/render_pallas.py: _scene_geometry, _shade_side (split here
// into the normal-dependent part, shade_side, and the per-channel part,
// shade_channel), _side_bwd (side_vjp_channel per channel, then
// side_vjp_normal for the normal's chain), _scene_loss_and_grads
// (scene_loop), the patch coordinates and the block's loss partial. One
// thread shades one pixel.
//
// What bounds the kernels: the instructions they issue. They move 24 to 48
// floats per pixel but do ~560 FP32 and ~50 special-function operations
// per pixel and scene, and every add and multiply issues alone (no FMA
// contraction, below). So the design cuts instructions first:
// - One reciprocal per quantity (1/d^2, 1/VN, 1/LN, 1/NH^2, 1/denom,
//   1/(1 + sqrt(.)), 1/(r + 0.1)), its quotients taken as products; a
//   square root and its reciprocal come from one rsqrtf. Without fast math
//   an IEEE `a / b` or sqrtf is a MUFU op, a Newton step in FFMAs and a
//   check that branches to a slow path; a reciprocal is about half that,
//   and the shading had 55 divisions and 12 square roots per scene.
// - Registers for occupancy, in the gradient kernels: the pixel's inputs
//   and gradient accumulators live in thread-private columns of shared
//   memory (SharedValues), so registers hold one scene's working set and
//   more blocks fit an SM (mixed_loss.cu and rendering_loss.cu say how
//   many). The value-only kernels have no accumulators and keep their
//   inputs in registers (RegisterValues), where they already fit 4 blocks.
//
// Rounding: the kernels are built without FMA contraction (-fmad=false)
// and without fast math, every `x / c` by a constant is taken as
// `x * (1/c)` as torch does on the card, and every reciprocal as `1.f / x`
// as torch.reciprocal takes it, so each op rounds as in the plain torch
// versions of ops/render_fused.py (see the note in mixed_loss.cu).

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace svbrdf {

constexpr int kThreads = 256;
constexpr float kPi = 3.14159265358979323846f;
// x / pi is taken as x * (1/pi in float): torch on the card divides a tensor
// by a Python number through the number's float reciprocal, and so the
// kernel and its plain version round alike.
constexpr float kInvPi = 1.f / kPi;
constexpr float kEps = 1e-3f;        // dot, roughness and denominator clamp
constexpr float kEpsRender = 0.1f;   // log-space epsilon of the renders
constexpr float kEpsL1 = 0.01f;      // log-space epsilon of the L1 term
// Blocks per SM that the registers of the two training kernels (fwdgrad
// of both losses) are held to: 80 registers a thread, which their inputs
// and accumulators in shared memory allow (they take about that without
// the cap too). Measured on an H100 (PERF.md): 4-5 % faster than with
// everything in registers at 2 blocks; held to 4 blocks (64 registers)
// they spill and run slower.
constexpr int kMinBlocks = 3;

// jnp.sign: 0 at 0 (copysignf would give +-1).
__device__ __forceinline__ float sign0(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// d max(x, k)/dx as autodiff takes it: [x >= k].
__device__ __forceinline__ float ge(float x, float k) {
  return x >= k ? 1.f : 0.f;
}

// Patch coordinates of column `col` and global row `row`:
// x = -1 + 2 col / (W - 1), y = 1 - 2 row / (H_full - 1), each division a
// multiply by the float reciprocal, as for pi above.
__device__ __forceinline__ float patch_x(int col, int W) {
  return -1.f + 2.f * (float)col * (1.f / (float)(W - 1));
}

__device__ __forceinline__ float patch_y(int row, int full_height) {
  return 1.f - 2.f * (float)row * (1.f / (float)(full_height - 1));
}

struct Geometry {
  float vx, vy, vz, lx, ly, lz, hx, hy, hz, inv_dsq, omv5;
};

// _scene_geometry: SVBRDF-independent terms shared by both sides.
__device__ __forceinline__ Geometry scene_geometry(const float* sc, float x,
                                                   float y) {
  Geometry g;
  const float vx = sc[0] - x, vy = sc[1] - y, vz = sc[2];
  const float inv_v = rsqrtf(vx * vx + vy * vy + vz * vz);
  g.vx = vx * inv_v;
  g.vy = vy * inv_v;
  g.vz = vz * inv_v;
  const float lx = sc[3] - x, ly = sc[4] - y, lz = sc[5];
  const float dist_sq = lx * lx + ly * ly + lz * lz;
  g.inv_dsq = 1.f / dist_sq;
  const float inv_l = rsqrtf(dist_sq);
  g.lx = lx * inv_l;
  g.ly = ly * inv_l;
  g.lz = lz * inv_l;
  const float hx = (g.vx + g.lx) * 0.5f, hy = (g.vy + g.ly) * 0.5f,
              hz = (g.vz + g.lz) * 0.5f;
  const float inv_h = rsqrtf(hx * hx + hy * hy + hz * hz);
  g.hx = hx * inv_h;
  g.hy = hy * inv_h;
  g.hz = hz * inv_h;
  const float vh = fmaxf(g.vx * g.hx + g.vy * g.hy + g.vz * g.hz, kEps);
  const float o = 1.f - vh;
  g.omv5 = o * o * o * o * o;
  return g;
}

// The normal-dependent terms of one side (_shade_side's shared part). Each
// quotient is a product with one reciprocal per quantity: 1/VN, 1/LN and
// 1/NH^2 here, 1/d^2 in the geometry.
struct Side {
  float nh_raw, vn_raw, ln_raw, NH, VN, LN, NH_sq, inv_VN, inv_LN, scale, tv,
      tl, tn, inv_4vnln;
};

__device__ __forceinline__ Side shade_side(float nx, float ny, float nz,
                                           const Geometry& g) {
  Side s;
  s.nh_raw = nx * g.hx + ny * g.hy + nz * g.hz;
  s.vn_raw = g.vx * nx + g.vy * ny + g.vz * nz;
  s.ln_raw = g.lx * nx + g.ly * ny + g.lz * nz;
  s.NH = fmaxf(s.nh_raw, kEps);
  s.VN = fmaxf(s.vn_raw, kEps);
  s.LN = fmaxf(s.ln_raw, kEps);
  s.NH_sq = s.NH * s.NH;
  s.inv_VN = 1.f / s.VN;
  s.inv_LN = 1.f / s.LN;
  const float inv_NH_sq = 1.f / s.NH_sq;
  s.scale = fmaxf(s.ln_raw, 0.f) * g.inv_dsq;
  // (1 - X^2) * (1/X)^2 and not (1/X)^2 - 1: near X = 1 the difference
  // 1 - X^2 is exact, and tan^2 keeps its relative accuracy.
  s.tv = (1.f - s.VN * s.VN) * (s.inv_VN * s.inv_VN);
  s.tl = (1.f - s.LN * s.LN) * (s.inv_LN * s.inv_LN);
  s.tn = (1.f - s.NH_sq) * inv_NH_sq;
  s.inv_4vnln = s.inv_VN * s.inv_LN * 0.25f;
  return s;
}

// One colour channel of one side (_shade_side's per-channel part), with the
// reciprocals its VJP reuses: 1/denom, 1/sv and 1/(1 + sv) (and for l).
struct Chan {
  float rough, a, denom_raw, denom, inv_denom, chi, D, inv_sv, rv, g1v,
      inv_sl, rl, g1l, G, spec_base, F, f, out;
};

__device__ __forceinline__ Chan shade_channel(float albedo, float rough_raw,
                                              float spec, const Side& s,
                                              const Geometry& g, float color) {
  Chan k;
  k.rough = fmaxf(rough_raw, kEps);
  const float r2 = k.rough * k.rough;
  k.a = r2 * r2;
  k.denom_raw = s.NH_sq * (k.a + s.tn);
  k.denom = fmaxf(k.denom_raw, kEps);
  k.inv_denom = 1.f / k.denom;
  k.chi = s.NH > 0.f ? 1.f : 0.f;
  k.D = k.a * k.chi * (k.inv_denom * k.inv_denom) * kInvPi;
  // G1 with chi_x == 1: the clamps keep XH / XN > 0. sqrt(t) = t * rsqrt(t),
  // and rsqrt(t) is 1/sqrt(t) for the VJP.
  const float tv1 = 1.f + k.a * s.tv;
  k.inv_sv = rsqrtf(tv1);
  k.rv = 1.f / (1.f + tv1 * k.inv_sv);
  k.g1v = 2.f * k.rv;
  const float tl1 = 1.f + k.a * s.tl;
  k.inv_sl = rsqrtf(tl1);
  k.rl = 1.f / (1.f + tl1 * k.inv_sl);
  k.g1l = 2.f * k.rl;
  k.G = k.g1v * k.g1l;
  k.spec_base = k.G * k.D * s.inv_4vnln;
  k.F = spec + (1.f - spec) * g.omv5;
  k.f = (1.f - k.F) * albedo * kInvPi + k.F * k.spec_base;
  k.out = k.f * color * s.scale;
  return k;
}

// What one side's per-channel VJPs leave for the normal's chain.
struct NormalAcc {
  float NH = 0.f, VN = 0.f, LN = 0.f, lp = 0.f;
};

// _side_bwd for one colour channel c of one side: the gradient of
// u * out_c, where u is the cotangent of the channel's radiance (for the
// log-L1 loss +-sign(diff) / (r + 0.1)). Adds d/d(albedo), d/d(roughness)
// and d/d(specular) of this channel to values 3 + c, 6 + c and 9 + c of
// `d` and the normal-dependent parts to `acc`.
template <class Values>
__device__ __forceinline__ void side_vjp_channel(
    float u, float color, float albedo, float rough_raw, const Chan& k,
    const Side& s, const Geometry& g, Values& d, int c, NormalAcc& acc) {
  const float w = u * color;
  const float ws = w * s.scale;
  const float wsF = ws * k.F;
  d.add(3 + c, ws * (1.f - k.F) * kInvPi);
  d.add(9 + c, ws * (1.f - g.omv5) * (k.spec_base - albedo * kInvPi));
  const float mask_denom = ge(k.denom_raw, kEps);
  const float inv_denom3 = k.inv_denom * k.inv_denom * k.inv_denom;
  const float dD_da =
      k.chi * (k.denom - 2.f * k.a * s.NH_sq * mask_denom) * inv_denom3 *
      kInvPi;
  const float dg1v_da = -s.tv * k.rv * k.rv * k.inv_sv;
  const float dg1l_da = -s.tl * k.rl * k.rl * k.inv_sl;
  const float dG_da = dg1v_da * k.g1l + k.g1v * dg1l_da;
  const float dsb_da = (dG_da * k.D + k.G * dD_da) * s.inv_4vnln;
  d.add(6 + c, wsF * dsb_da * 4.f * k.rough * k.rough * k.rough *
                   ge(rough_raw, kEps));
  const float dsb_dNH = (k.G * s.inv_4vnln) *
                        (-2.f * k.a * k.chi * inv_denom3 * kInvPi) * 2.f *
                        s.NH * (k.a - 1.f) * mask_denom;
  const float inv_VN3 = s.inv_VN * s.inv_VN * s.inv_VN;
  const float inv_LN3 = s.inv_LN * s.inv_LN * s.inv_LN;
  const float dg1v_dVN = 2.f * k.a * k.rv * k.rv * k.inv_sv * inv_VN3;
  const float dsb_dVN =
      (dg1v_dVN * k.g1l * k.D - k.G * k.D * s.inv_VN) * s.inv_4vnln;
  const float dg1l_dLN = 2.f * k.a * k.rl * k.rl * k.inv_sl * inv_LN3;
  const float dsb_dLN =
      (k.g1v * dg1l_dLN * k.D - k.G * k.D * s.inv_LN) * s.inv_4vnln;
  acc.NH += wsF * dsb_dNH;
  acc.VN += wsF * dsb_dVN;
  acc.LN += wsF * dsb_dLN;
  acc.lp += w * k.f * g.inv_dsq;
}

// _side_bwd's normal chain, after the three channels: adds d/d(normal) of
// the side to values 0..2 of `d`.
template <class Values>
__device__ __forceinline__ void side_vjp_normal(const NormalAcc& acc,
                                                const Side& s,
                                                const Geometry& g,
                                                Values& d) {
  const float cn = acc.NH * ge(s.nh_raw, kEps);
  const float cv = acc.VN * ge(s.vn_raw, kEps);
  const float cl = acc.LN * ge(s.ln_raw, kEps) + acc.lp * ge(s.ln_raw, 0.f);
  d.add(0, cn * g.hx + cv * g.vx + cl * g.lx);
  d.add(1, cn * g.hy + cv * g.vy + cl * g.ly);
  d.add(2, cn * g.hz + cv * g.vz + cl * g.lz);
}

// The 12 values of this thread's pixel (one SVBRDF or its gradient) in a
// column of shared memory: value c at col[c * kThreads], so the threads of
// a warp touch 32 consecutive words (no bank conflicts). Volatile: every
// use reads shared memory, and the compiler cannot hoist the values into
// registers across the scene loop, which is what frees the registers.
struct SharedValues {
  volatile float* col;
  __device__ __forceinline__ explicit SharedValues(float* c) : col(c) {}
  __device__ __forceinline__ float operator[](int c) const {
    return col[c * kThreads];
  }
  __device__ __forceinline__ void set(int c, float x) { col[c * kThreads] = x; }
  __device__ __forceinline__ void add(int c, float x) {
    col[c * kThreads] = col[c * kThreads] + x;
  }
};

// The same 12 values in registers (the pointer is not used).
struct RegisterValues {
  float v[12];
  __device__ __forceinline__ explicit RegisterValues(float*) {}
  __device__ __forceinline__ float operator[](int c) const { return v[c]; }
  __device__ __forceinline__ void set(int c, float x) { v[c] = x; }
  __device__ __forceinline__ void add(int c, float x) { v[c] += x; }
};

// Where a kernel keeps its pixel's pred and gt values: in shared memory in
// the gradient kernels, in registers in the value-only ones.
template <bool kWithGrad>
using InputValues =
    std::conditional_t<kWithGrad, SharedValues, RegisterValues>;

// Dynamic shared memory of a kernel with `gradients` gradients (0, 1 or
// 2): the columns of pred, gt and each gradient where it has any, then the
// item's S * 9 scene scalars, which start at float shared_columns(.) *
// kThreads.
__host__ __device__ constexpr int shared_columns(int gradients) {
  return gradients > 0 ? 24 + 12 * gradients : 0;
}

inline size_t shared_bytes(int gradients, int S) {
  return ((size_t)shared_columns(gradients) * kThreads + (size_t)S * 9) *
         sizeof(float);
}

// _scene_loss_and_grads over the S scenes of the block's item at patch
// point (x, y): returns sum |log(r_p + 0.1) - log(r_t + 0.1)| over scenes
// and channels; with kWithGrad adds the pred side's VJP to dp and with
// kTargetGrad the gt side's to dt.
template <bool kWithGrad, bool kTargetGrad, class Inputs>
__device__ __forceinline__ float scene_loop(const Inputs& P, const Inputs& T,
                                            const float* scene_s, int S,
                                            float x, float y,
                                            SharedValues& dp,
                                            SharedValues& dt) {
  float sum = 0.f;
  for (int s = 0; s < S; ++s) {
    const float* sc = scene_s + s * 9;
    const Geometry g = scene_geometry(sc, x, y);
    const Side sp = shade_side(P[0], P[1], P[2], g);
    const Side st = shade_side(T[0], T[1], T[2], g);
    NormalAcc acc_p, acc_t;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float color = sc[6 + c];
      const Chan kp = shade_channel(P[3 + c], P[6 + c], P[9 + c], sp, g,
                                    color);
      const Chan kt = shade_channel(T[3 + c], T[6 + c], T[9 + c], st, g,
                                    color);
      const float rp = kp.out + kEpsRender;
      const float rt = kt.out + kEpsRender;
      const float diff = logf(rp) - logf(rt);
      sum += fabsf(diff);
      if (kWithGrad) {
        const float sgn = sign0(diff);
        side_vjp_channel(sgn * (1.f / rp), color, P[3 + c], P[6 + c], kp, sp,
                         g, dp, c, acc_p);
        if (kTargetGrad) {
          side_vjp_channel(-sgn * (1.f / rt), color, T[3 + c], T[6 + c], kt,
                           st, g, dt, c, acc_t);
        }
      }
    }
    if (kWithGrad) side_vjp_normal(acc_p, sp, g, dp);
    if (kTargetGrad) side_vjp_normal(acc_t, st, g, dt);
  }
  return sum;
}

// One loss partial per block: warp shuffles, then the first warp writes
// the block's sum to partials[blockIdx.y * gridDim.x + blockIdx.x]. No
// float atomics, so the loss is the same from run to run. Every thread of
// the block must call it.
__device__ __forceinline__ void block_partial(float value, float* partials) {
  __shared__ float warp_sums[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    value += __shfl_down_sync(0xffffffffu, value, off);
  }
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = value;
  __syncthreads();
  if (threadIdx.x < 32) {
    value = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      value += __shfl_down_sync(0xffffffffu, value, off);
    }
    if (threadIdx.x == 0) {
      partials[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = value;
    }
  }
}

// The block's batch item's S * 9 scene scalars into shared memory.
__device__ __forceinline__ void load_scenes(const float* scenes, int S,
                                            float* scene_s) {
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < S * 9; i += kThreads) {
    scene_s[i] = scenes[(size_t)b * S * 9 + i];
  }
  __syncthreads();
}

// Lets `kernel` take `smem` bytes of dynamic shared memory: above the
// default 48 KB a kernel must ask for it (the `both` variant of
// rendering_loss.cu keeps 48 columns, 48 KB, and its scenes).
template <class Kernel>
cudaError_t allow_shared(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Blocks of `kernel` that fit one SM with `smem` bytes of dynamic shared
// memory each (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus a
// CUDA error code.
template <class Kernel>
int blocks_per_sm(Kernel kernel, size_t smem) {
  cudaError_t err = allow_shared(kernel, smem);
  int n = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                        smem);
  }
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace svbrdf
