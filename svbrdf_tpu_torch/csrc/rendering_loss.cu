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
// What bounds it on this card: the instructions it issues, as for the mixed
// loss (mixed_loss.cu): per pixel and scene it needs about as many FP32 and
// special-function operations as the mixed kernels without their L1 term,
// and the `both` variant a second VJP (the count is in chip_smoke.py); it
// moves 24 (fwd), 36 (fwdgrad) or 48 (both) floats per pixel.
//
// What the design does about it: the mixed kernels' design (shading.cuh's
// reciprocals, one thread per pixel and one block per 256 pixels, the
// block's scenes in shared memory, per-block partials without float
// atomics, built with -fmad=false) over one kernel body with two template
// switches. The gradient variants keep the pixel's inputs and accumulators
// in thread-private columns of shared memory: fwdgrad, the training kernel,
// is held to 80 registers and 3 blocks per SM (36 KB of shared memory a
// block); `both` keeps 48 columns (48 KB) and fits 2 blocks per SM, where
// with everything in registers it fitted one. The value-only kernel keeps
// its inputs in registers.

#include "shading.cuh"

namespace {

using namespace svbrdf;

// Blocks per SM that each variant's registers are held to: fwdgrad, the
// training kernel, as the mixed one. The others as they compile: the
// value-only kernel takes 62 registers (4 blocks per SM; held to 64 it took
// 60 and ran 2 % slower), `both` 115 (2 blocks).
__host__ __device__ constexpr int min_blocks(bool with_grad,
                                             bool target_grad) {
  return with_grad && !target_grad ? kMinBlocks : 1;
}

__host__ __device__ constexpr int gradients(bool with_grad,
                                            bool target_grad) {
  return (with_grad ? 1 : 0) + (target_grad ? 1 : 0);
}

template <bool kWithGrad, bool kTargetGrad>
__global__ void __launch_bounds__(kThreads,
                                  min_blocks(kWithGrad, kTargetGrad))
rendering_loss_kernel(const float* __restrict__ pred,
                      const float* __restrict__ gt,
                      const float* __restrict__ scenes,
                      float* __restrict__ partials, float* __restrict__ dpred,
                      float* __restrict__ dgt, int H, int W, int S,
                      int row_offset, int full_height, float inv_count) {
  static_assert(kWithGrad || !kTargetGrad, "dgt comes with dpred");
  extern __shared__ float smem[];
  float* scene_s =
      smem + shared_columns(gradients(kWithGrad, kTargetGrad)) * kThreads;
  load_scenes(scenes, S, scene_s);

  const int b = blockIdx.y;
  const int hw = H * W;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  float value = 0.f;
  if (p < hw) {
    const size_t base = (size_t)b * 12 * hw + p;
    InputValues<kWithGrad> P(smem + threadIdx.x);
    InputValues<kWithGrad> T(smem + 12 * kThreads + threadIdx.x);
    SharedValues dp(smem + 24 * kThreads + threadIdx.x);
    SharedValues dt(smem + 36 * kThreads + threadIdx.x);
#pragma unroll
    for (int c = 0; c < 12; ++c) {
      P.set(c, pred[base + (size_t)c * hw]);
      T.set(c, gt[base + (size_t)c * hw]);
      if (kWithGrad) dp.set(c, 0.f);
      if (kTargetGrad) dt.set(c, 0.f);
    }
    const int row = p / W;
    const int col = p - row * W;
    const float x = patch_x(col, W);
    const float y = patch_y(row + row_offset, full_height);
    value = scene_loop<kWithGrad, kTargetGrad>(P, T, scene_s, S, x, y, dp,
                                               dt);
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
int blocks_per_sm_of(int S) {
  return blocks_per_sm(rendering_loss_kernel<kWithGrad, kTargetGrad>,
                       shared_bytes(gradients(kWithGrad, kTargetGrad), S));
}

template <bool kWithGrad, bool kTargetGrad>
int launch(const void* pred, const void* gt, const void* scenes,
           void* partials, void* dpred, void* dgt, int B, int H, int W, int S,
           int row_offset, int full_height, float inv_count, void* stream) {
  const dim3 grid((H * W + kThreads - 1) / kThreads, B);
  const size_t smem = shared_bytes(gradients(kWithGrad, kTargetGrad), S);
  const cudaError_t err =
      allow_shared(rendering_loss_kernel<kWithGrad, kTargetGrad>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
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

// Blocks of each kernel that fit one SM at S scenes, or minus a CUDA error.
int svbrdf_rendering_loss_fwd_blocks_per_sm(int S) {
  return blocks_per_sm_of<false, false>(S);
}
int svbrdf_rendering_loss_fwdgrad_blocks_per_sm(int S) {
  return blocks_per_sm_of<true, false>(S);
}
int svbrdf_rendering_loss_fwdgrad_both_blocks_per_sm(int S) {
  return blocks_per_sm_of<true, true>(S);
}

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
