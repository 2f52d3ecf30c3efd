// Per-pixel Cook-Torrance shading and its hand-derived VJP, shared by the
// loss kernels (mixed_loss.cu, rendering_loss.cu).
//
// Device translation of the in-kernel helpers of
// svbrdf_tpu/ops/render_pallas.py: _scene_geometry, _shade_side (split here
// into the normal-dependent part, shade_side, and the per-channel part,
// shade_channel), _side_bwd (side_vjp_channel per channel, then
// side_vjp_normal for the normal's chain), the patch coordinates and the
// block's loss partial. One thread shades one pixel; every value lives in
// registers.
//
// Rounding: the kernels are built without FMA contraction (-fmad=false)
// and without fast math, and every `x / c` by a constant is taken as
// `x * (1/c)` as torch does on the card, so each op rounds as in the plain
// torch versions of ops/render_fused.py (see the note in mixed_loss.cu).

#pragma once

#include <cuda_runtime.h>

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
  float vx, vy, vz, lx, ly, lz, hx, hy, hz, dist_sq, omv5;
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
  g.dist_sq = lx * lx + ly * ly + lz * lz;
  const float inv_l = rsqrtf(g.dist_sq);
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

// The normal-dependent terms of one side (_shade_side's shared part).
struct Side {
  float nh_raw, vn_raw, ln_raw, NH, VN, LN, NH_sq, scale, tv, tl, tn,
      inv_4vnln;
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
  s.scale = fmaxf(s.ln_raw, 0.f) / g.dist_sq;
  s.tv = (1.f - s.VN * s.VN) / (s.VN * s.VN);
  s.tl = (1.f - s.LN * s.LN) / (s.LN * s.LN);
  s.tn = (1.f - s.NH_sq) / s.NH_sq;
  s.inv_4vnln = 1.f / (4.f * s.VN * s.LN);
  return s;
}

// One colour channel of one side (_shade_side's per-channel part).
struct Chan {
  float rough, a, denom_raw, denom, chi, D, sv, g1v, sl, g1l, G, spec_base, F,
      f, out;
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
  k.chi = s.NH > 0.f ? 1.f : 0.f;
  k.D = k.a * k.chi / (kPi * k.denom * k.denom);
  // G1 with chi_x == 1: the clamps keep XH / XN > 0.
  k.sv = sqrtf(1.f + k.a * s.tv);
  k.g1v = 2.f / (1.f + k.sv);
  k.sl = sqrtf(1.f + k.a * s.tl);
  k.g1l = 2.f / (1.f + k.sl);
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

// _side_bwd for one colour channel of one side: the gradient of
// u * out_c, where u is the cotangent of the channel's radiance (for the
// log-L1 loss +-sign(diff) / (r + 0.1)). Adds d/d(albedo), d/d(roughness)
// and d/d(specular) of this channel to *d_albedo, *d_rough, *d_spec and
// the normal-dependent parts to `acc`.
__device__ __forceinline__ void side_vjp_channel(
    float u, float color, float albedo, float rough_raw, const Chan& k,
    const Side& s, const Geometry& g, float* d_albedo, float* d_rough,
    float* d_spec, NormalAcc& acc) {
  const float w = u * color;
  const float ws = w * s.scale;
  const float wsF = ws * k.F;
  *d_albedo += ws * (1.f - k.F) * kInvPi;
  *d_spec += ws * (1.f - g.omv5) * (k.spec_base - albedo * kInvPi);
  const float mask_denom = ge(k.denom_raw, kEps);
  const float inv_denom = 1.f / k.denom;
  const float inv_denom3 = inv_denom * inv_denom * inv_denom;
  const float dD_da =
      k.chi * (k.denom - 2.f * k.a * s.NH_sq * mask_denom) * inv_denom3 *
      kInvPi;
  const float dg1v_da = -s.tv / (k.sv * (1.f + k.sv) * (1.f + k.sv));
  const float dg1l_da = -s.tl / (k.sl * (1.f + k.sl) * (1.f + k.sl));
  const float dG_da = dg1v_da * k.g1l + k.g1v * dg1l_da;
  const float dsb_da = (dG_da * k.D + k.G * dD_da) * s.inv_4vnln;
  *d_rough += wsF * dsb_da * 4.f * k.rough * k.rough * k.rough *
              ge(rough_raw, kEps);
  const float dsb_dNH = (k.G * s.inv_4vnln) *
                        (-2.f * k.a * k.chi * inv_denom3 * kInvPi) * 2.f *
                        s.NH * (k.a - 1.f) * mask_denom;
  const float dg1v_dVN =
      2.f * k.a / ((1.f + k.sv) * (1.f + k.sv) * k.sv * s.VN * s.VN * s.VN);
  const float dsb_dVN =
      (dg1v_dVN * k.g1l * k.D - k.G * k.D / s.VN) * s.inv_4vnln;
  const float dg1l_dLN =
      2.f * k.a / ((1.f + k.sl) * (1.f + k.sl) * k.sl * s.LN * s.LN * s.LN);
  const float dsb_dLN =
      (k.g1v * dg1l_dLN * k.D - k.G * k.D / s.LN) * s.inv_4vnln;
  acc.NH += wsF * dsb_dNH;
  acc.VN += wsF * dsb_dVN;
  acc.LN += wsF * dsb_dLN;
  acc.lp += w * k.f / g.dist_sq;
}

// _side_bwd's normal chain, after the three channels: adds d/d(normal) of
// the side to d_normal[0..2].
__device__ __forceinline__ void side_vjp_normal(const NormalAcc& acc,
                                                const Side& s,
                                                const Geometry& g,
                                                float* d_normal) {
  const float cn = acc.NH * ge(s.nh_raw, kEps);
  const float cv = acc.VN * ge(s.vn_raw, kEps);
  const float cl = acc.LN * ge(s.ln_raw, kEps) + acc.lp * ge(s.ln_raw, 0.f);
  d_normal[0] += cn * g.hx + cv * g.vx + cl * g.lx;
  d_normal[1] += cn * g.hy + cv * g.vy + cl * g.ly;
  d_normal[2] += cn * g.hz + cv * g.vz + cl * g.lz;
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

}  // namespace svbrdf
