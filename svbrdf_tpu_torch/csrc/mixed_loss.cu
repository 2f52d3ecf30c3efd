// Fused mixed loss (rendering loss + l1_weight * SVBRDF L1) for Hopper.
//
// Replaces the TPU kernels of svbrdf_tpu/ops/render_pallas.py:
//   _mixed_fwdgrad_kernel  -> svbrdf_mixed_loss_fwdgrad (training step)
//   _mixed_fwd_kernel      -> svbrdf_mixed_loss_fwd     (validation step)
// at fold=1 (channel planes (B, 12, H, W), f32). The shading, its VJP, the
// scene loop and the block reduction are in shading.cuh, shared with
// rendering_loss.cu.
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
// What bounds it on this card: the instructions it issues, not memory.
// fwdgrad moves 36 floats per pixel (24 in, 12 out: ~75 MB at B=8, 256^2)
// but needs at least ~560 FP32 and ~50 special-function operations (log,
// rsqrt, reciprocal) per pixel per scene, times S=9 scenes (the count is
// in chip_smoke.py). The special functions set the least time; built
// without FMA contraction (below), each add and multiply issues alone, and
// the FP32 work alone takes longer than that.
//
// What the design does about it (measured on an H100 in PERF.md):
// - one reciprocal per quantity and no IEEE division or sqrtf in the
//   shading (shading.cuh): the fwdgrad kernel issues a fifth fewer
//   instructions, half the calls to the division slow path, and runs 1.55x
//   faster than with a division per quotient;
// - fwdgrad keeps the pixel's 24 inputs and 12 gradient accumulators in
//   thread-private columns of shared memory (36 KB a block), which holds it
//   to 80 registers and 3 blocks (24 warps) per SM where it had 128 and 2;
//   the value-only kernel has no accumulators and keeps its inputs in
//   registers, held to 64 (4 blocks per SM);
// - one thread per pixel, one block per 256 pixels of one item: device
//   memory is touched once per input and output value, neighbouring threads
//   read neighbouring addresses, and each block masks its own ragged edge,
//   so any H*W works. A grid of one wave whose blocks walk the tiles ran
//   6-8 % slower, so the hardware schedules the blocks;
// - the block loads its item's S*9 scene scalars into shared memory once,
//   and reduces the loss with warp shuffles into one partial per block; the
//   caller sums the partials, so the loss needs no float atomics and is the
//   same from run to run.
//
// Rounding: IEEE reciprocal and logf, rsqrtf as torch.rsqrt takes it (no
// fast math), and no contraction of a * b + c into FMAs (built with
// -fmad=false). With contraction the compiler fuses the pred side, whose
// terms the VJP shares, differently from the gt side, so equal inputs
// rendered to different last bits and a pred equal to gt gave a loss of
// ~6e-9 instead of 0. Without it both sides round alike, and each op
// rounds as the plain torch version's does.

#include "shading.cuh"

namespace {

using namespace svbrdf;

// Blocks per SM that the value-only kernel is held to: 64 registers.
// Without the cap it takes 69, fits 3 blocks and ran 5 % slower on an H100.
constexpr int kMinBlocksValue = 4;

template <bool kWithGrad>
__global__ void __launch_bounds__(kThreads,
                                  kWithGrad ? kMinBlocks : kMinBlocksValue)
mixed_loss_kernel(const float* __restrict__ pred, const float* __restrict__ gt,
                  const float* __restrict__ scenes,
                  float* __restrict__ partials, float* __restrict__ dpred,
                  int H, int W, int S, int row_offset, int full_height,
                  float inv_render, float l1_coef) {
  extern __shared__ float smem[];
  float* scene_s = smem + shared_columns(kWithGrad) * kThreads;
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
#pragma unroll
    for (int c = 0; c < 12; ++c) {
      P.set(c, pred[base + (size_t)c * hw]);
      T.set(c, gt[base + (size_t)c * hw]);
      if (kWithGrad) dp.set(c, 0.f);
    }
    const int row = p / W;
    const int col = p - row * W;
    const float x = patch_x(col, W);
    const float y = patch_y(row + row_offset, full_height);
    const float render_sum =
        scene_loop<kWithGrad, false>(P, T, scene_s, S, x, y, dp, dp);

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
        gl1[c] = sign0(d) * (1.f / pc);
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
  const size_t smem = shared_bytes(kWithGrad, S);
  const cudaError_t err = allow_shared(mixed_loss_kernel<kWithGrad>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
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

// Blocks of each kernel that fit one SM at S scenes, or minus a CUDA error.
int svbrdf_mixed_loss_fwdgrad_blocks_per_sm(int S) {
  return blocks_per_sm(mixed_loss_kernel<true>, shared_bytes(1, S));
}
int svbrdf_mixed_loss_fwd_blocks_per_sm(int S) {
  return blocks_per_sm(mixed_loss_kernel<false>, shared_bytes(0, S));
}

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
