// Fused rendering-only loss for Hopper.
//
// Replaces the TPU kernels of svbrdf_tpu/ops/render_pallas.py:
//   _fwd_kernel           -> svbrdf_rendering_loss_fwd (value; validation)
//   _fwdgrad_kernel       -> svbrdf_rendering_loss_fwdgrad (value + dpred;
//                            training with the rendering loss)
//   _fwdgrad_kernel_both  -> svbrdf_rendering_loss_fwdgrad_both (value +
//                            dpred + dgt; want_target_grad callers)
// on channel planes (B, 12, H, W), f32 or bf16 (the entries with a _bf16
// suffix: loaded into f32, shaded in f32, gradients rounded once to bf16).
//
// What it computes, per pixel of one batch item and each of S point-light
// scenes (_scene_loss_and_grads): shade pred and gt once, add
// |log(r_p + 0.1) - log(r_t + 0.1)| over the 3 colour channels, and with a
// gradient add the VJP of the pred side with u = sign(diff) / (r_p + 0.1)
// and, in the `both` kernel, of the gt side with
// u = -sign(diff) / (r_t + 0.1). There is no L1 term. Each block writes the
// raw sum of its pixels' terms as one partial; the caller divides the sum of
// the partials by count = B*S*H_global*W*3, and dpred and dgt are written
// scaled by inv_count = 1/count.
//
// What bounds it on this card: the instructions it issues, as for the mixed
// loss (mixed_loss.cu): per pixel and scene it needs about as many FP32 and
// special-function operations as the mixed kernels without their L1 term,
// and `both` a second VJP (the count is in chip_smoke.py); it moves 24
// (fwd), 36 (fwdgrad) or 48 (both) plane values per pixel.
//
// What the design does about it:
// - fwdgrad, the training kernel, takes the mixed gradient kernel's design
//   (shading.cuh's reciprocals, built with -fmad=false, bit-exact against
//   its plain version) and keeps the pixel's inputs and dpred accumulators
//   in thread-private columns of shared memory: 80 registers and 3 blocks
//   per SM (36 KB of shared memory a block);
// - the value-only kernel is the mixed one's without the L1 term
//   (value_loss_kernel<false>, value_shading.cuh): its own shading, with 27
//   special functions per pixel and scene where shading.cuh takes 46,
//   single-instruction rsqrt and reciprocal, explicit FMAs and one log per
//   ratio, its inputs in registers (48, 5 blocks per SM); 2.5x faster than
//   the same kernel over shading.cuh;
// - `both` (rendering_both_kernel) shades on the value kernels' algebra and
//   runs a VJP on it (value_vjp.cuh): no special function beyond the
//   forward's 27 per pixel and scene, where on shading.cuh's algebra it took
//   46 and two VJPs over IEEE reciprocals; its inputs and both sides' 24
//   accumulators in registers, held to 2 blocks per SM (kBothMinBlocks);
//   2.5x faster than the kernel it replaced.
// All: one thread per pixel and one block per 256 pixels, the block's scenes
// in shared memory, per-block partials without float atomics.
//
// Rounding: as in mixed_loss.cu. fwdgrad is bit-exact against its plain
// version; the value-only kernel and `both` are held to theirs at loss rel
// 1e-5 (and `both`'s gradients normwise, chip_smoke.py) and give exactly 0
// for pred = gt.

#include "shading.cuh"
#include "value_shading.cuh"
#include "value_vjp.cuh"

namespace {

using namespace svbrdf;

// The training kernel, value + dpred, for planes of type Plane (float or
// __nv_bfloat16: loaded into f32, dpred rounded once to Plane), held to
// kMinBlocks blocks per SM as the mixed one.
template <class Plane>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rendering_fwdgrad_kernel(const Plane* __restrict__ pred,
                         const Plane* __restrict__ gt,
                         const float* __restrict__ scenes,
                         float* __restrict__ partials,
                         Plane* __restrict__ dpred, int H, int W, int S,
                         int row_offset, int full_height, float inv_count) {
  extern __shared__ float smem[];
  float* scene_s = smem + kSharedColumns * kThreads;
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
#pragma unroll
    for (int c = 0; c < 12; ++c) {
      P.set(c, to_f32(pred[base + (size_t)c * hw]));
      T.set(c, to_f32(gt[base + (size_t)c * hw]));
      dp.set(c, 0.f);
    }
    const int row = p / W;
    const int col = p - row * W;
    const float x = patch_x(col, W);
    const float y = patch_y(row + row_offset, full_height);
    value = scene_loop(P, T, scene_s, S, x, y, dp);
#pragma unroll
    for (int c = 0; c < 12; ++c) {
      dpred[base + (size_t)c * hw] = from_f32<Plane>(dp[c] * inv_count);
    }
  }
  block_partial(value, partials);
}

// Blocks per SM the registers of the kernel with both gradients are held
// to: 2, 128 registers (72 bytes of spill). Measured on an H100 (PERF.md,
// B=8, 256^2, S=9): 0.120 ms; with no cap 204 registers, 1 block, 0.134
// ms; with its 24 accumulators in shared-memory columns 128 registers, 2
// blocks, 0.124 ms, or at 3 blocks (80 registers) 0.149 ms; in registers
// at 3 blocks 0.272 ms (440 bytes of spill).
constexpr int kBothMinBlocks = 2;

// The kernel with both gradients (value_vjp.cuh): loss partials, dpred and
// dgt scaled by inv_count; the block's scenes in shared memory as the value
// kernels keep them, the pixel's inputs and both sides' 24 accumulators in
// registers.
template <class Plane>
__global__ void __launch_bounds__(kThreads, kBothMinBlocks)
rendering_both_kernel(const Plane* __restrict__ pred,
                      const Plane* __restrict__ gt,
                      const float* __restrict__ scenes,
                      float* __restrict__ partials, Plane* __restrict__ dpred,
                      Plane* __restrict__ dgt, int H, int W, int S,
                      int row_offset, int full_height, float inv_count) {
  extern __shared__ float4 value_scenes[];
  load_value_scenes(scenes, S, value_scenes);

  const int hw = H * W;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  float value = 0.f;
  if (p < hw) {
    const size_t base = (size_t)blockIdx.y * 12 * hw + p;
    float pred_v[12], gt_v[12];
    load_pixel(pred + base, hw, pred_v);
    load_pixel(gt + base, hw, gt_v);
    Grad12 dp, dt;
    const int row = p / W;
    const int col = p - row * W;
    value = vjp_scene_loop(VjpPixel(pred_v), VjpPixel(gt_v), value_scenes, S,
                           patch_x(col, W),
                           patch_y(row + row_offset, full_height), dp, dt);
    store_gradient(dp, pred + base, hw, inv_count, dpred + base);
    store_gradient(dt, gt + base, hw, inv_count, dgt + base);
  }
  block_partial(value, partials);
}

template <class Plane>
int fwd(const void* pred, const void* gt, const void* scenes, void* partials,
        int B, int H, int W, int S, int row_offset, int full_height,
        void* stream) {
  return launch_tiles(value_loss_kernel<false, Plane>, value_shared_bytes(S),
                      B, H * W, stream, pred, gt, scenes, partials, H, W, S,
                      row_offset, full_height, 1.f, 0.f);
}

template <class Plane>
int fwdgrad(const void* pred, const void* gt, const void* scenes,
            void* partials, void* dpred, int B, int H, int W, int S,
            int row_offset, int full_height, float inv_count, void* stream) {
  return launch_tiles(rendering_fwdgrad_kernel<Plane>, shared_bytes(S), B,
                      H * W, stream, pred, gt, scenes, partials, dpred, H, W,
                      S, row_offset, full_height, inv_count);
}

template <class Plane>
int fwdgrad_both(const void* pred, const void* gt, const void* scenes,
                 void* partials, void* dpred, void* dgt, int B, int H, int W,
                 int S, int row_offset, int full_height, float inv_count,
                 void* stream) {
  return launch_tiles(rendering_both_kernel<Plane>, value_shared_bytes(S), B,
                      H * W, stream, pred, gt, scenes, partials, dpred, dgt,
                      H, W, S, row_offset, full_height, inv_count);
}

}  // namespace

extern "C" {

// Threads per block; the caller sizes `partials` as B * ceil(H*W / this).
int svbrdf_rendering_loss_threads() { return kThreads; }

// Blocks of each kernel that fit one SM at S scenes, or minus a CUDA error.
int svbrdf_rendering_loss_fwd_blocks_per_sm(int S) {
  return blocks_per_sm(value_loss_kernel<false, float>,
                       value_shared_bytes(S));
}
int svbrdf_rendering_loss_fwdgrad_blocks_per_sm(int S) {
  return blocks_per_sm(rendering_fwdgrad_kernel<float>, shared_bytes(S));
}
int svbrdf_rendering_loss_fwdgrad_both_blocks_per_sm(int S) {
  return blocks_per_sm(rendering_both_kernel<float>, value_shared_bytes(S));
}
int svbrdf_rendering_loss_fwd_bf16_blocks_per_sm(int S) {
  return blocks_per_sm(value_loss_kernel<false, __nv_bfloat16>,
                       value_shared_bytes(S));
}
int svbrdf_rendering_loss_fwdgrad_bf16_blocks_per_sm(int S) {
  return blocks_per_sm(rendering_fwdgrad_kernel<__nv_bfloat16>,
                       shared_bytes(S));
}
int svbrdf_rendering_loss_fwdgrad_both_bf16_blocks_per_sm(int S) {
  return blocks_per_sm(rendering_both_kernel<__nv_bfloat16>,
                       value_shared_bytes(S));
}

// Loss partials (B * ceil(H*W/threads) raw sums) only: f32 planes, and
// (_bf16) bf16 planes. The same for the entries below, whose gradients are
// written in the planes' type.
int svbrdf_rendering_loss_fwd(const void* pred, const void* gt,
                              const void* scenes, void* partials, int B,
                              int H, int W, int S, int row_offset,
                              int full_height, void* stream) {
  return fwd<float>(pred, gt, scenes, partials, B, H, W, S, row_offset,
                    full_height, stream);
}
int svbrdf_rendering_loss_fwd_bf16(const void* pred, const void* gt,
                                   const void* scenes, void* partials, int B,
                                   int H, int W, int S, int row_offset,
                                   int full_height, void* stream) {
  return fwd<__nv_bfloat16>(pred, gt, scenes, partials, B, H, W, S,
                            row_offset, full_height, stream);
}

// Loss partials and dpred (B, 12, H, W) scaled by inv_count.
int svbrdf_rendering_loss_fwdgrad(const void* pred, const void* gt,
                                  const void* scenes, void* partials,
                                  void* dpred, int B, int H, int W, int S,
                                  int row_offset, int full_height,
                                  float inv_count, void* stream) {
  return fwdgrad<float>(pred, gt, scenes, partials, dpred, B, H, W, S,
                        row_offset, full_height, inv_count, stream);
}
int svbrdf_rendering_loss_fwdgrad_bf16(const void* pred, const void* gt,
                                       const void* scenes, void* partials,
                                       void* dpred, int B, int H, int W,
                                       int S, int row_offset, int full_height,
                                       float inv_count, void* stream) {
  return fwdgrad<__nv_bfloat16>(pred, gt, scenes, partials, dpred, B, H, W,
                                S, row_offset, full_height, inv_count,
                                stream);
}

// Loss partials, dpred and dgt (B, 12, H, W), both scaled by inv_count.
int svbrdf_rendering_loss_fwdgrad_both(const void* pred, const void* gt,
                                       const void* scenes, void* partials,
                                       void* dpred, void* dgt, int B, int H,
                                       int W, int S, int row_offset,
                                       int full_height, float inv_count,
                                       void* stream) {
  return fwdgrad_both<float>(pred, gt, scenes, partials, dpred, dgt, B, H, W,
                             S, row_offset, full_height, inv_count, stream);
}
int svbrdf_rendering_loss_fwdgrad_both_bf16(const void* pred, const void* gt,
                                            const void* scenes,
                                            void* partials, void* dpred,
                                            void* dgt, int B, int H, int W,
                                            int S, int row_offset,
                                            int full_height, float inv_count,
                                            void* stream) {
  return fwdgrad_both<__nv_bfloat16>(pred, gt, scenes, partials, dpred, dgt,
                                     B, H, W, S, row_offset, full_height,
                                     inv_count, stream);
}

}  // extern "C"
