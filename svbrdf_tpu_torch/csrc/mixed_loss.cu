// Fused mixed loss (rendering loss + l1_weight * SVBRDF L1) for Hopper.
//
// Replaces the TPU kernels of svbrdf_tpu/ops/render_pallas.py:
//   _mixed_fwdgrad_kernel  -> svbrdf_mixed_loss_fwdgrad (training step)
//   _mixed_fwd_kernel      -> svbrdf_mixed_loss_fwd     (validation step)
// at fold=1 (channel planes (B, 12, H, W), f32).
//
// What it computes, per pixel of one batch item: for each of S point-light
// scenes, shade pred and gt once (Cook-Torrance: GGX D with chi+, Schlick F,
// Smith G1 product, clamps at 1e-3), add |log(r_p + 0.1) - log(r_t + 0.1)|
// over the 3 colour channels, and (fwdgrad) add the hand-derived VJP of the
// pred side with u = sign(diff) / (r_p + 0.1). Then the L1 term (plain on
// normals/roughness, log(x + 0.01) on diffuse/specular) is added with its
// gradient, and everything is scaled as the TPU kernel does:
//   value = sum|diff| * inv_render + l1_coef * l1
//   dpred = dp * inv_render + l1_coef * dl1
// with inv_render = 1/(B*S*H*W*3) and l1_coef = l1_weight/(B*H*W*3).
//
// What bounds it on this card: arithmetic, not memory. fwdgrad moves 36
// floats per pixel (24 in, 12 out: ~75 MB at B=8, 256^2) but needs at least
// ~560 FP32 operations and ~50 special-function operations (log, sqrt,
// rsqrt, reciprocal) per pixel per scene, times S=9 scenes (the count is in
// chip_smoke.py). The special functions set the floor; built without FMA
// contraction (below), each add and multiply issues alone, and the FP32
// work takes about as long again.
//
// What the design does about it: one thread per pixel keeps every
// intermediate (24 input values, 12 gradient accumulators, the per-scene
// geometry and per-channel shading terms) in registers, so device memory is
// touched exactly once per input and output value. The per-channel shading
// and its VJP are fused so only one channel's terms are live at a time.
// Threads next to each other read neighbouring addresses of each plane
// (coalesced). The block loads its item's S*9 scene scalars into shared
// memory once. The loss is reduced in the block with warp shuffles into one
// partial per block; the caller sums the partials, so the loss needs no
// float atomics and is the same from run to run. Blocks mask their own
// ragged edge, so any H*W works.
//
// Rounding: IEEE division, sqrt and logf (no fast-math), and no contraction
// of a * b + c into FMAs (built with -fmad=false). With contraction the
// compiler fuses the pred side, whose terms the VJP shares, differently from
// the gt side, so equal inputs rendered to different last bits and a pred
// equal to gt gave a loss of ~6e-9 instead of 0. Without it both sides round
// alike, and each op rounds as the plain torch version's does.

#include <cuda_runtime.h>

namespace {

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

template <bool kWithGrad>
__global__ void __launch_bounds__(kThreads)
mixed_loss_kernel(const float* __restrict__ pred, const float* __restrict__ gt,
                  const float* __restrict__ scenes,
                  float* __restrict__ partials, float* __restrict__ dpred,
                  int H, int W, int S, int row_offset, int full_height,
                  float inv_render, float l1_coef) {
  extern __shared__ float scene_s[];  // S * 9 scalars of this batch item
  __shared__ float warp_sums[kThreads / 32];

  const int b = blockIdx.y;
  const int hw = H * W;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  for (int i = threadIdx.x; i < S * 9; i += kThreads) {
    scene_s[i] = scenes[(size_t)b * S * 9 + i];
  }
  __syncthreads();

  float value = 0.f;
  if (p < hw) {
    const size_t base = (size_t)b * 12 * hw + p;
    float P[12], T[12], dp[12];
#pragma unroll
    for (int c = 0; c < 12; ++c) {
      P[c] = pred[base + (size_t)c * hw];
      T[c] = gt[base + (size_t)c * hw];
      dp[c] = 0.f;
    }
    const int row = p / W;
    const int col = p - row * W;
    // x = -1 + 2 col / (W - 1), y = 1 - 2 row / (H_full - 1), each division
    // a multiply by the float reciprocal, as for pi above.
    const float x = -1.f + 2.f * (float)col * (1.f / (float)(W - 1));
    const float y = 1.f - 2.f * (float)(row + row_offset) *
                              (1.f / (float)(full_height - 1));

    float render_sum = 0.f;
    for (int s = 0; s < S; ++s) {
      const float* sc = scene_s + s * 9;
      const Geometry g = scene_geometry(sc, x, y);
      const Side sp = shade_side(P[0], P[1], P[2], g);
      const Side st = shade_side(T[0], T[1], T[2], g);
      float A_NH = 0.f, A_VN = 0.f, A_LN = 0.f, A_lp = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float color = sc[6 + c];
        const Chan kp = shade_channel(P[3 + c], P[6 + c], P[9 + c], sp, g,
                                      color);
        const Chan kt = shade_channel(T[3 + c], T[6 + c], T[9 + c], st, g,
                                      color);
        const float rp = kp.out + kEpsRender;
        const float diff = logf(rp) - logf(kt.out + kEpsRender);
        render_sum += fabsf(diff);
        if (kWithGrad) {
          // _side_bwd for this channel, u = sign(diff) / (r_p + 0.1).
          const float w = sign0(diff) / rp * color;
          const float ws = w * sp.scale;
          const float wsF = ws * kp.F;
          dp[3 + c] += ws * (1.f - kp.F) * kInvPi;
          dp[9 + c] +=
              ws * (1.f - g.omv5) * (kp.spec_base - P[3 + c] * kInvPi);
          const float mask_denom = ge(kp.denom_raw, kEps);
          const float inv_denom = 1.f / kp.denom;
          const float inv_denom3 = inv_denom * inv_denom * inv_denom;
          const float dD_da =
              kp.chi * (kp.denom - 2.f * kp.a * sp.NH_sq * mask_denom) *
              inv_denom3 * kInvPi;
          const float dg1v_da =
              -sp.tv / (kp.sv * (1.f + kp.sv) * (1.f + kp.sv));
          const float dg1l_da =
              -sp.tl / (kp.sl * (1.f + kp.sl) * (1.f + kp.sl));
          const float dG_da = dg1v_da * kp.g1l + kp.g1v * dg1l_da;
          const float dsb_da = (dG_da * kp.D + kp.G * dD_da) * sp.inv_4vnln;
          dp[6 + c] += wsF * dsb_da * 4.f * kp.rough * kp.rough * kp.rough *
                       ge(P[6 + c], kEps);
          const float dsb_dNH = (kp.G * sp.inv_4vnln) *
                                (-2.f * kp.a * kp.chi * inv_denom3 * kInvPi) *
                                2.f * sp.NH * (kp.a - 1.f) * mask_denom;
          const float dg1v_dVN =
              2.f * kp.a /
              ((1.f + kp.sv) * (1.f + kp.sv) * kp.sv * sp.VN * sp.VN * sp.VN);
          const float dsb_dVN =
              (dg1v_dVN * kp.g1l * kp.D - kp.G * kp.D / sp.VN) * sp.inv_4vnln;
          const float dg1l_dLN =
              2.f * kp.a /
              ((1.f + kp.sl) * (1.f + kp.sl) * kp.sl * sp.LN * sp.LN * sp.LN);
          const float dsb_dLN =
              (kp.g1v * dg1l_dLN * kp.D - kp.G * kp.D / sp.LN) * sp.inv_4vnln;
          A_NH += wsF * dsb_dNH;
          A_VN += wsF * dsb_dVN;
          A_LN += wsF * dsb_dLN;
          A_lp += w * kp.f / g.dist_sq;
        }
      }
      if (kWithGrad) {
        const float cn = A_NH * ge(sp.nh_raw, kEps);
        const float cv = A_VN * ge(sp.vn_raw, kEps);
        const float cl = A_LN * ge(sp.ln_raw, kEps) + A_lp * ge(sp.ln_raw, 0.f);
        dp[0] += cn * g.hx + cv * g.vx + cl * g.lx;
        dp[1] += cn * g.hy + cv * g.vy + cl * g.ly;
        dp[2] += cn * g.hz + cv * g.vz + cl * g.lz;
      }
    }

    // _l1_tile: plain L1 on normals (0-2) and roughness (6-8), L1 of
    // log(x + 0.01) on diffuse (3-5) and specular (9-11).
    float l1 = 0.f;
    float gl1[12];
#pragma unroll
    for (int c = 0; c < 12; ++c) {
      const bool log_space = (c >= 3 && c < 6) || c >= 9;
      if (log_space) {
        const float pc = P[c] + kEpsL1;
        const float d = logf(pc) - logf(T[c] + kEpsL1);
        l1 += fabsf(d);
        gl1[c] = sign0(d) / pc;
      } else {
        const float d = P[c] - T[c];
        l1 += fabsf(d);
        gl1[c] = sign0(d);
      }
    }
    value = render_sum * inv_render + l1_coef * l1;
    if (kWithGrad) {
#pragma unroll
      for (int c = 0; c < 12; ++c) {
        dpred[base + (size_t)c * hw] = dp[c] * inv_render + l1_coef * gl1[c];
      }
    }
  }

  // One partial per block: warp shuffles, then the first warp.
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
    if (threadIdx.x == 0) partials[(size_t)b * gridDim.x + blockIdx.x] = value;
  }
}

template <bool kWithGrad>
int launch(const void* pred, const void* gt, const void* scenes,
           void* partials, void* dpred, int B, int H, int W, int S,
           int row_offset, int full_height, float inv_render, float l1_coef,
           void* stream) {
  const dim3 grid((H * W + kThreads - 1) / kThreads, B);
  const size_t smem = (size_t)S * 9 * sizeof(float);
  mixed_loss_kernel<kWithGrad>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(pred), static_cast<const float*>(gt),
          static_cast<const float*>(scenes), static_cast<float*>(partials),
          static_cast<float*>(dpred), H, W, S, row_offset, full_height,
          inv_render, l1_coef);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Threads per block; the caller sizes `partials` as B * ceil(H*W / this).
int svbrdf_mixed_loss_threads() { return kThreads; }

// Loss partials (B * ceil(H*W/threads) floats) and dpred (B, 12, H, W).
int svbrdf_mixed_loss_fwdgrad(const void* pred, const void* gt,
                              const void* scenes, void* partials, void* dpred,
                              int B, int H, int W, int S, int row_offset,
                              int full_height, float inv_render, float l1_coef,
                              void* stream) {
  return launch<true>(pred, gt, scenes, partials, dpred, B, H, W, S,
                      row_offset, full_height, inv_render, l1_coef, stream);
}

// Loss partials only.
int svbrdf_mixed_loss_fwd(const void* pred, const void* gt, const void* scenes,
                          void* partials, int B, int H, int W, int S,
                          int row_offset, int full_height, float inv_render,
                          float l1_coef, void* stream) {
  return launch<false>(pred, gt, scenes, partials, nullptr, B, H, W, S,
                       row_offset, full_height, inv_render, l1_coef, stream);
}

}  // extern "C"
