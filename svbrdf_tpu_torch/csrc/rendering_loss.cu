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
// What the design does about it: the gradient variants take the mixed
// gradient kernel's design (shading.cuh's reciprocals, one thread per pixel
// and one block per 256 pixels, the block's scenes in shared memory,
// per-block partials without float atomics, built with -fmad=false) over
// one kernel template with the target's gradient as its switch, and keep
// the pixel's inputs and accumulators in thread-private columns of shared
// memory: fwdgrad, the training kernel, is held to 80 registers and 3
// blocks per SM (36 KB of shared memory a block); `both` keeps 48 columns
// (48 KB) and fits 2 blocks per SM, where with everything in registers it
// fitted one. The value-only kernel is the mixed one's without the L1 term
// (value_loss_kernel<false>, value_shading.cuh): its own shading, with 27
// special functions per pixel and scene where shading.cuh takes 46,
// single-instruction rsqrt and reciprocal, explicit FMAs and one log per
// ratio, its inputs in registers (48, 5 blocks per SM); 2.5x faster than
// the same kernel over shading.cuh.
//
// Rounding: as in mixed_loss.cu. The two gradient variants are bit-exact
// against their plain versions; the value-only kernel is held to its plain
// version at loss rel 1e-5 and gives exactly 0 for pred = gt.

#include "shading.cuh"
#include "value_shading.cuh"

namespace {

using namespace svbrdf;

// The two gradient variants, value + dpred and (kTargetGrad) + dgt; the
// value-only kernel is value_loss_kernel<false> (value_shading.cuh).
// Blocks per SM their registers are held to: fwdgrad, the training kernel,
// as the mixed one; `both` as it compiles (115 registers, 2 blocks).
template <bool kTargetGrad>
__global__ void __launch_bounds__(kThreads, kTargetGrad ? 1 : kMinBlocks)
rendering_fwdgrad_kernel(const float* __restrict__ pred,
                         const float* __restrict__ gt,
                         const float* __restrict__ scenes,
                         float* __restrict__ partials,
                         float* __restrict__ dpred, float* __restrict__ dgt,
                         int H, int W, int S, int row_offset,
                         int full_height, float inv_count) {
  extern __shared__ float smem[];
  float* scene_s = smem + shared_columns(kTargetGrad ? 2 : 1) * kThreads;
  load_scenes(scenes, S, scene_s);

  const int b = blockIdx.y;
  const int hw = H * W;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  float value = 0.f;
  if (p < hw) {
    const size_t base = (size_t)b * 12 * hw + p;
    SharedValues P(smem + threadIdx.x);
    SharedValues T(smem + 12 * kThreads + threadIdx.x);
    SharedValues dp(smem + 24 * kThreads + threadIdx.x);
    SharedValues dt(smem + 36 * kThreads + threadIdx.x);
#pragma unroll
    for (int c = 0; c < 12; ++c) {
      P.set(c, pred[base + (size_t)c * hw]);
      T.set(c, gt[base + (size_t)c * hw]);
      dp.set(c, 0.f);
      if (kTargetGrad) dt.set(c, 0.f);
    }
    const int row = p / W;
    const int col = p - row * W;
    const float x = patch_x(col, W);
    const float y = patch_y(row + row_offset, full_height);
    value = scene_loop<kTargetGrad>(P, T, scene_s, S, x, y, dp, dt);
#pragma unroll
    for (int c = 0; c < 12; ++c) {
      dpred[base + (size_t)c * hw] = dp[c] * inv_count;
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

template <bool kTargetGrad>
size_t fwdgrad_shared_bytes(int S) {
  return shared_bytes(kTargetGrad ? 2 : 1, S);
}

}  // namespace

extern "C" {

// Threads per block; the caller sizes `partials` as B * ceil(H*W / this).
int svbrdf_rendering_loss_threads() { return kThreads; }

// Blocks of each kernel that fit one SM at S scenes, or minus a CUDA error.
int svbrdf_rendering_loss_fwd_blocks_per_sm(int S) {
  return blocks_per_sm(value_loss_kernel<false>, value_shared_bytes(S));
}
int svbrdf_rendering_loss_fwdgrad_blocks_per_sm(int S) {
  return blocks_per_sm(rendering_fwdgrad_kernel<false>,
                       fwdgrad_shared_bytes<false>(S));
}
int svbrdf_rendering_loss_fwdgrad_both_blocks_per_sm(int S) {
  return blocks_per_sm(rendering_fwdgrad_kernel<true>,
                       fwdgrad_shared_bytes<true>(S));
}

// Loss partials (B * ceil(H*W/threads) raw sums) only.
int svbrdf_rendering_loss_fwd(const void* pred, const void* gt,
                              const void* scenes, void* partials, int B,
                              int H, int W, int S, int row_offset,
                              int full_height, void* stream) {
  return launch_tiles(value_loss_kernel<false>, value_shared_bytes(S), B,
                      H * W, stream, pred, gt, scenes, partials, H, W, S,
                      row_offset, full_height, 1.f, 0.f);
}

// Loss partials and dpred (B, 12, H, W) scaled by inv_count.
int svbrdf_rendering_loss_fwdgrad(const void* pred, const void* gt,
                                  const void* scenes, void* partials,
                                  void* dpred, int B, int H, int W, int S,
                                  int row_offset, int full_height,
                                  float inv_count, void* stream) {
  return launch_tiles(rendering_fwdgrad_kernel<false>,
                      fwdgrad_shared_bytes<false>(S), B, H * W, stream, pred,
                      gt, scenes, partials, dpred, nullptr, H, W, S,
                      row_offset, full_height, inv_count);
}

// Loss partials, dpred and dgt (B, 12, H, W), both scaled by inv_count.
int svbrdf_rendering_loss_fwdgrad_both(const void* pred, const void* gt,
                                       const void* scenes, void* partials,
                                       void* dpred, void* dgt, int B, int H,
                                       int W, int S, int row_offset,
                                       int full_height, float inv_count,
                                       void* stream) {
  return launch_tiles(rendering_fwdgrad_kernel<true>,
                      fwdgrad_shared_bytes<true>(S), B, H * W, stream, pred,
                      gt, scenes, partials, dpred, dgt, H, W, S, row_offset,
                      full_height, inv_count);
}

}  // extern "C"
