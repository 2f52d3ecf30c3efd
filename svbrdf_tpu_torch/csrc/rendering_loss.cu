// Fused rendering-only loss for Hopper.
//
// Replaces the TPU kernels of svbrdf_tpu/ops/render_pallas.py:
//   _fwd_kernel           -> svbrdf_rendering_loss_fwd (value; validation)
//   _fwdgrad_kernel       -> svbrdf_rendering_loss_fwdgrad (value + dpred;
//                            training with the rendering loss)
//   _fwdgrad_kernel_both  -> svbrdf_rendering_loss_fwdgrad_both (value +
//                            dpred + dgt; want_target_grad callers)
// on channel planes (B, 12, H, W), f32.
//
// What it computes, per pixel of one batch item and each of S point-light
// scenes (_scene_loss_and_grads): shade pred and gt once, add
// |log(r_p + 0.1) - log(r_t + 0.1)| over the 3 colour channels, and with a
// gradient add the VJP of the pred side with u = sign(diff) / (r_p + 0.1)
// and, in the `both` variant, of the gt side with
// u = -sign(diff) / (r_t + 0.1). There is no L1 term. Each block writes the
// raw sum of its pixels' terms as one partial; the caller divides the sum of
// the partials by count = B*S*H_global*W*3, and dpred and dgt are written
// scaled by inv_count = 1/count.
//
// What bounds it on this card: arithmetic, as for the mixed loss
// (mixed_loss.cu): per pixel and scene it needs about as many FP32 and
// special-function operations as the mixed kernels without their L1 term,
// and the `both` variant a second VJP (the count is in chip_smoke.py); it
// moves 24 (fwd), 36 (fwdgrad) or 48 (both) floats per pixel.
//
// What the design does about it: the mixed kernels' design (one thread per
// pixel, every intermediate in registers, the block's scenes in shared
// memory, per-block partials without float atomics, built with -fmad=false
// and every `x / c` by a constant taken as `x * (1/c)`) over one kernel body
// with two template switches. The `both` variant keeps 24 gradient
// accumulators per thread beside the 24 inputs.

#include "shading.cuh"

namespace {

using namespace svbrdf;

template <bool kWithGrad, bool kTargetGrad>
__global__ void __launch_bounds__(kThreads)
rendering_loss_kernel(const float* __restrict__ pred,
                      const float* __restrict__ gt,
                      const float* __restrict__ scenes,
                      float* __restrict__ partials, float* __restrict__ dpred,
                      float* __restrict__ dgt, int H, int W, int S,
                      int row_offset, int full_height, float inv_count) {
  static_assert(kWithGrad || !kTargetGrad, "dgt comes with dpred");
  extern __shared__ float scene_s[];  // S * 9 scalars of this batch item
  load_scenes(scenes, S, scene_s);

  const int b = blockIdx.y;
  const int hw = H * W;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  float value = 0.f;
  if (p < hw) {
    const size_t base = (size_t)b * 12 * hw + p;
    float P[12], T[12], dp[12], dt[12];
#pragma unroll
    for (int c = 0; c < 12; ++c) {
      P[c] = pred[base + (size_t)c * hw];
      T[c] = gt[base + (size_t)c * hw];
      dp[c] = 0.f;
      dt[c] = 0.f;
    }
    const int row = p / W;
    const int col = p - row * W;
    const float x = patch_x(col, W);
    const float y = patch_y(row + row_offset, full_height);

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
        value += fabsf(diff);
        if (kWithGrad) {
          const float sgn = sign0(diff);
          side_vjp_channel(sgn / rp, color, P[3 + c], P[6 + c], kp, sp, g,
                           &dp[3 + c], &dp[6 + c], &dp[9 + c], acc_p);
          if (kTargetGrad) {
            side_vjp_channel(-sgn / rt, color, T[3 + c], T[6 + c], kt, st, g,
                             &dt[3 + c], &dt[6 + c], &dt[9 + c], acc_t);
          }
        }
      }
      if (kWithGrad) side_vjp_normal(acc_p, sp, g, dp);
      if (kTargetGrad) side_vjp_normal(acc_t, st, g, dt);
    }

    if (kWithGrad) {
#pragma unroll
      for (int c = 0; c < 12; ++c) {
        dpred[base + (size_t)c * hw] = dp[c] * inv_count;
      }
    }
    if (kTargetGrad) {
#pragma unroll
      for (int c = 0; c < 12; ++c) {
        dgt[base + (size_t)c * hw] = dt[c] * inv_count;
      }
    }
  }
  block_partial(value, partials);
}

template <bool kWithGrad, bool kTargetGrad>
int launch(const void* pred, const void* gt, const void* scenes,
           void* partials, void* dpred, void* dgt, int B, int H, int W, int S,
           int row_offset, int full_height, float inv_count, void* stream) {
  const dim3 grid((H * W + kThreads - 1) / kThreads, B);
  const size_t smem = (size_t)S * 9 * sizeof(float);
  rendering_loss_kernel<kWithGrad, kTargetGrad>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(pred), static_cast<const float*>(gt),
          static_cast<const float*>(scenes), static_cast<float*>(partials),
          static_cast<float*>(dpred), static_cast<float*>(dgt), H, W, S,
          row_offset, full_height, inv_count);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Threads per block; the caller sizes `partials` as B * ceil(H*W / this).
int svbrdf_rendering_loss_threads() { return kThreads; }

// Loss partials (B * ceil(H*W/threads) raw sums) only.
int svbrdf_rendering_loss_fwd(const void* pred, const void* gt,
                              const void* scenes, void* partials, int B,
                              int H, int W, int S, int row_offset,
                              int full_height, void* stream) {
  return launch<false, false>(pred, gt, scenes, partials, nullptr, nullptr,
                              B, H, W, S, row_offset, full_height, 0.f,
                              stream);
}

// Loss partials and dpred (B, 12, H, W) scaled by inv_count.
int svbrdf_rendering_loss_fwdgrad(const void* pred, const void* gt,
                                  const void* scenes, void* partials,
                                  void* dpred, int B, int H, int W, int S,
                                  int row_offset, int full_height,
                                  float inv_count, void* stream) {
  return launch<true, false>(pred, gt, scenes, partials, dpred, nullptr, B,
                             H, W, S, row_offset, full_height, inv_count,
                             stream);
}

// Loss partials, dpred and dgt (B, 12, H, W), both scaled by inv_count.
int svbrdf_rendering_loss_fwdgrad_both(const void* pred, const void* gt,
                                       const void* scenes, void* partials,
                                       void* dpred, void* dgt, int B, int H,
                                       int W, int S, int row_offset,
                                       int full_height, float inv_count,
                                       void* stream) {
  return launch<true, true>(pred, gt, scenes, partials, dpred, dgt, B, H, W,
                            S, row_offset, full_height, inv_count, stream);
}

}  // extern "C"
