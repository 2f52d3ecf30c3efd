// Fused mixed loss (rendering loss + l1_weight * SVBRDF L1) for Hopper.
//
// Replaces the TPU kernels of svbrdf_tpu/ops/render_pallas.py:
//   _mixed_fwdgrad_kernel  -> svbrdf_mixed_loss_fwdgrad (training step)
//   _mixed_fwd_kernel      -> svbrdf_mixed_loss_fwd     (validation step)
// at fold=1 (channel planes (B, 12, H, W), f32 or bf16: every kernel loads
// bf16 into f32, shades in f32 and rounds dpred once to bf16; the C
// entries with a _bf16 suffix take bf16 planes). The gradient kernel's
// shading, its VJP, the scene loop and the block reduction are in
// shading.cuh, shared with rendering_loss.cu; the value-only kernel and its
// own shading are in value_shading.cuh, shared with rendering_loss.cu's.
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
// rsqrt, reciprocal) per pixel per scene, times S=9 scenes; the value-only
// kernel moves 24 and needs 231 and 27 (the counts are in chip_smoke.py).
//
// What the design does about it (measured on an H100 in PERF.md):
// - the gradient kernel: one reciprocal per quantity and no IEEE division
//   or sqrtf in the shading (shading.cuh): a fifth fewer instructions, half
//   the calls to the division slow path, and 1.55x faster than with a
//   division per quotient; the pixel's 24 inputs and 12 gradient
//   accumulators in thread-private columns of shared memory (36 KB a
//   block), which holds it to 80 registers and 3 blocks (24 warps) per SM
//   where it had 128 and 2;
// - the value-only kernel (value_loss_kernel<true>, value_shading.cuh):
//   its own shading, with 27 special functions per pixel and scene where
//   shading.cuh takes 46, single-instruction rsqrt and reciprocal,
//   explicit FMAs and one log per ratio, its inputs in registers (57, 4
//   blocks per SM); the L1 term's log-space channels take one log of each
//   ratio too. 2.5x faster than the same kernel over shading.cuh;
// - one thread per pixel, one block per 256 pixels of one item: device
//   memory is touched once per input and output value, neighbouring threads
//   read neighbouring addresses, and each block masks its own ragged edge,
//   so any H*W works. A grid of one wave whose blocks walk the tiles ran
//   6-8 % slower, so the hardware schedules the blocks;
// - the block loads its item's S scenes into shared memory once, and
//   reduces the loss with warp shuffles into one partial per block; the
//   caller sums the partials, so the loss needs no float atomics and is the
//   same from run to run.
//
// Rounding. The gradient kernel is bit-exact against its plain torch
// version: IEEE reciprocal and logf, rsqrtf as torch.rsqrt takes it (no
// fast math), and no contraction of a * b + c into FMAs (built with
// -fmad=false). With contraction the compiler fuses the pred side, whose
// terms the VJP shares, differently from the gt side, so equal inputs
// rendered to different last bits and a pred equal to gt gave a loss of
// ~6e-9 instead of 0. Without it both sides round alike, and each op
// rounds as the plain torch version's does. The value-only kernel rounds
// otherwise (approximate rsqrt and reciprocal, FMAs written as fmaf, which
// -fmad=false leaves fused) and is held to its plain version at loss rel
// 1e-5; both sides run the same explicit instructions, so pred = gt still
// gives exactly 0 (value_shading.cuh).

#include "shading.cuh"
#include "value_shading.cuh"

namespace {

using namespace svbrdf;

// The value + gradient kernel for planes of type Plane (float or
// __nv_bfloat16: loaded into f32, dpred rounded once to Plane); the
// value-only kernel is value_loss_kernel<true, Plane> (value_shading.cuh).
template <class Plane>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mixed_fwdgrad_kernel(const Plane* __restrict__ pred,
                     const Plane* __restrict__ gt,
                     const float* __restrict__ scenes,
                     float* __restrict__ partials, Plane* __restrict__ dpred,
                     int H, int W, int S, int row_offset, int full_height,
                     float inv_render, float l1_coef) {
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
    const float render_sum = scene_loop(P, T, scene_s, S, x, y, dp);

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
#pragma unroll
    for (int c = 0; c < 12; ++c) {
      dpred[base + (size_t)c * hw] =
          from_f32<Plane>(dp[c] * inv_render + l1_coef * gl1[c]);
    }
  }
  block_partial(value, partials);
}

template <class Plane>
int mixed_fwdgrad(const void* pred, const void* gt, const void* scenes,
                  void* partials, void* dpred, int B, int H, int W, int S,
                  int row_offset, int full_height, float inv_render,
                  float l1_coef, void* stream) {
  return launch_tiles(mixed_fwdgrad_kernel<Plane>, shared_bytes(S), B, H * W,
                      stream, pred, gt, scenes, partials, dpred, H, W, S,
                      row_offset, full_height, inv_render, l1_coef);
}

template <class Plane>
int mixed_fwd(const void* pred, const void* gt, const void* scenes,
              void* partials, int B, int H, int W, int S, int row_offset,
              int full_height, float inv_render, float l1_coef,
              void* stream) {
  return launch_tiles(value_loss_kernel<true, Plane>, value_shared_bytes(S),
                      B, H * W, stream, pred, gt, scenes, partials, H, W, S,
                      row_offset, full_height, inv_render, l1_coef);
}

}  // namespace

extern "C" {

// Threads per block; the caller sizes `partials` as B * ceil(H*W / this).
int svbrdf_mixed_loss_threads() { return kThreads; }

// Blocks of each kernel that fit one SM at S scenes, or minus a CUDA error.
int svbrdf_mixed_loss_fwdgrad_blocks_per_sm(int S) {
  return blocks_per_sm(mixed_fwdgrad_kernel<float>, shared_bytes(S));
}
int svbrdf_mixed_loss_fwd_blocks_per_sm(int S) {
  return blocks_per_sm(value_loss_kernel<true, float>, value_shared_bytes(S));
}
int svbrdf_mixed_loss_fwdgrad_bf16_blocks_per_sm(int S) {
  return blocks_per_sm(mixed_fwdgrad_kernel<__nv_bfloat16>, shared_bytes(S));
}
int svbrdf_mixed_loss_fwd_bf16_blocks_per_sm(int S) {
  return blocks_per_sm(value_loss_kernel<true, __nv_bfloat16>,
                       value_shared_bytes(S));
}

// Loss partials (B * ceil(H*W/threads) floats) and dpred (B, 12, H, W):
// f32 planes, and (_bf16) bf16 planes with a bf16 dpred.
int svbrdf_mixed_loss_fwdgrad(const void* pred, const void* gt,
                              const void* scenes, void* partials, void* dpred,
                              int B, int H, int W, int S, int row_offset,
                              int full_height, float inv_render, float l1_coef,
                              void* stream) {
  return mixed_fwdgrad<float>(pred, gt, scenes, partials, dpred, B, H, W, S,
                              row_offset, full_height, inv_render, l1_coef,
                              stream);
}
int svbrdf_mixed_loss_fwdgrad_bf16(const void* pred, const void* gt,
                                   const void* scenes, void* partials,
                                   void* dpred, int B, int H, int W, int S,
                                   int row_offset, int full_height,
                                   float inv_render, float l1_coef,
                                   void* stream) {
  return mixed_fwdgrad<__nv_bfloat16>(pred, gt, scenes, partials, dpred, B, H,
                                      W, S, row_offset, full_height,
                                      inv_render, l1_coef, stream);
}

// Loss partials only.
int svbrdf_mixed_loss_fwd(const void* pred, const void* gt, const void* scenes,
                          void* partials, int B, int H, int W, int S,
                          int row_offset, int full_height, float inv_render,
                          float l1_coef, void* stream) {
  return mixed_fwd<float>(pred, gt, scenes, partials, B, H, W, S, row_offset,
                          full_height, inv_render, l1_coef, stream);
}
int svbrdf_mixed_loss_fwd_bf16(const void* pred, const void* gt,
                               const void* scenes, void* partials, int B,
                               int H, int W, int S, int row_offset,
                               int full_height, float inv_render,
                               float l1_coef, void* stream) {
  return mixed_fwd<__nv_bfloat16>(pred, gt, scenes, partials, B, H, W, S,
                                  row_offset, full_height, inv_render,
                                  l1_coef, stream);
}

}  // extern "C"
