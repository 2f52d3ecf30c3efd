// Fused mixed loss (rendering loss + l1_weight * SVBRDF L1) for Hopper.
//
// Replaces the TPU kernels of svbrdf_tpu/ops/render_pallas.py:
//   _mixed_fwdgrad_kernel  -> svbrdf_mixed_loss_fwdgrad (training step)
//   _mixed_fwd_kernel      -> svbrdf_mixed_loss_fwd     (validation step)
// at fold=1 (channel planes (B, 12, H, W), f32). The shading, its VJP and
// the block reduction are in shading.cuh, shared with rendering_loss.cu.
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

#include "shading.cuh"

namespace {

using namespace svbrdf;

template <bool kWithGrad>
__global__ void __launch_bounds__(kThreads)
mixed_loss_kernel(const float* __restrict__ pred, const float* __restrict__ gt,
                  const float* __restrict__ scenes,
                  float* __restrict__ partials, float* __restrict__ dpred,
                  int H, int W, int S, int row_offset, int full_height,
                  float inv_render, float l1_coef) {
  extern __shared__ float scene_s[];  // S * 9 scalars of this batch item
  load_scenes(scenes, S, scene_s);

  const int b = blockIdx.y;
  const int hw = H * W;
  const int p = blockIdx.x * kThreads + threadIdx.x;
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
    const float x = patch_x(col, W);
    const float y = patch_y(row + row_offset, full_height);

    float render_sum = 0.f;
    for (int s = 0; s < S; ++s) {
      const float* sc = scene_s + s * 9;
      const Geometry g = scene_geometry(sc, x, y);
      const Side sp = shade_side(P[0], P[1], P[2], g);
      const Side st = shade_side(T[0], T[1], T[2], g);
      NormalAcc acc;
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
          side_vjp_channel(sign0(diff) / rp, color, P[3 + c], P[6 + c], kp,
                           sp, g, &dp[3 + c], &dp[6 + c], &dp[9 + c], acc);
        }
      }
      if (kWithGrad) side_vjp_normal(acc, sp, g, dp);
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
  block_partial(value, partials);
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
