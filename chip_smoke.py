"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each raising (and so exiting non-zero) on any failure:
  1. device: the card's name and power limit, torch and CUDA versions; TF32
     off for convolutions and matrix products (the f32 phases' setting;
     the bf16 phases and the CLI's default run set their own, _tf32);
  2. build: every CUDA kernel compiled from csrc/ with nvcc, one process per
     source, all started together;
  3. kernels: each of the five loss kernels held against its plain torch
     version at the paths' shapes (B=8, 12 x 256 x 256 planes, S=9 scenes)
     on two input sets, pred far from gt (bench_setup.loss_inputs) and pred
     near gt (loss_inputs_near: where validation runs once a model trains),
     each in f32 and in bf16, each loss also against the plain version in
     float64, the gradients of `both` (which shades on another algebra than
     the training kernels) against it in float64; each bf16 instantiation
     against the f32 one on the upcast planes; and checked to give a loss
     and gradients of exactly 0 for pred equal to gt;
  3a. the U-Net block tail's kernel pair (csrc/norm_merge.cu) held to its
     plain version at every tail shape of both full-width models (batch 8,
     24 rows, and the estimator's batch 1), f32 and bf16
     (bench_setup.hold_tail_kernels); each configuration's tails timed
     together forward and backward (device time) beside their byte bound
     and the plain version; registers and blocks per SM
     (phase_norm_merge); every path below that runs a model counts its
     launches, one a direction a tail a step (_tail_launches);
  3b. the fused SR-Adam update (csrc/sr_adam.cu, one multi-tensor launch
     per optimizer step) against its plain version, bit-exact: one-leaf
     tables of the largest conv leaf and a 1-D leaf of the full-width
     single-view model, in each dtype combination the policies use, at 3
     salts and step counts past 2148; one table of every leaf of each
     full-width model (single view, multi view) in the bf16-SR dtypes, with
     random moments, at a count past 2148 and master salts that wrap; and
     its stochastic rounding unbiased on the card (the mean over 400 salts
     within rel 1e-3); and the 'bf16' state mode (SVBRDF_OPT_STATE=bf16:
     f32 parameters and gradients, bf16 mu, f32 nu, the launch's flag for
     optax's bf16-mu order) over every leaf of the full-width single-view
     model at step counts 1 and 2148, its launches counted;
  4. agreement: a small single-view mixed-loss model and a small multi-view
     rendering-loss model: train step, eval loss and prediction on the card
     against the same program on the CPU; and a small single-view bf16
     step with bf16-SR masters (loss rel 2e-2, masters within SR's reach);
  5. paths, each with every launch counter (the loss kernels' by planes
     dtype, and sr_adam's) set to 0 just before and read just after, at
     full width (depth 8, 64 filters, 256^2, batch 8, seeded weights):
       - single-view model, mixed loss, f32: 5 train steps, 1 eval step,
         predict;
       - multi-view model (3 synthesized views), rendering-only loss, f32:
         5 train steps, 1 eval step, predict;
       - the same two in bf16 with bf16-SR masters: the bf16 instantiations
         of the loss kernels and one sr_adam launch per optimizer step (a
         table holds every leaf), bf16 >=2-D masters that moved, f32 maps;
       - the rendering loss with the target's gradient under autograd;
       - one call each of the mixed loss and of the rendering loss with the
         target's gradient on bf16 planes under autograd;
       - the path tracer (--renderer pathtracing; its own kernels,
         csrc/pathtrace.cu): first held card against CPU on the same
         injected samples (B=2, S=9, 32^2, spp (4, 2): renders, the mixed
         loss and its gradient, each against float64 where f32 is
         ill-conditioned; loss and gradient exactly 0 for pred equal to
         target); then each of its two kernels (the forward estimator
         pathtrace_shade, the backward estimator's VJP
         pathtrace_shade_vjp) against its plain version on the card
         (bench_setup.hold_pathtrace_kernels: renders by hold_render, the
         VJP's sums against float64) at full width (B=8, S=9, 256^2, spp
         (16, 8)) for an f32 and a bf16 SVBRDF, on a ragged grid (250 x
         243, B=3) and with scene gradients (32^2), the path-traced loss
         and its gradient exactly 0 for pred equal to target at full
         width, and each kernel's time, bound, registers and blocks per SM
         beside its plain version's; then the single-view mixed path at
         full width at the CLI's default precision (bf16, bf16-SR) and in
         f32 (TF32 off), spp (16, 8): 5 train steps, 1 eval step,
         predict, no loss kernel launched, pathtrace_shade twice (the
         prediction's render in the compute dtype, the f32 target's) and
         pathtrace_shade_vjp once a train step, pathtrace_shade twice an
         eval step, one sr_adam a bf16-SR step, the peak device memory,
         the steps' times and the loss's share of a train step; then
         utils/pathtrace_stability for 20 steps;
  6. times: CUDA-event medians of each kernel launched alone (f32, and its
     bf16 instantiation on the same planes in bf16), its wrapper, its plain
     version and each path's steps, each kernel's bound for f32 and bf16
     planes, and the blocks of each kernel that fit one SM (the occupancy
     query of the library, beside the ptxas register and spill lines of
     phase 2); the train and eval steps of both configurations side by side
     in f32 with TF32 off, in TF32 (single view only, not a CLI mode), in
     bf16 with f32 masters and in bf16 with bf16-SR masters; the whole
     optimizer step of each bf16-SR model: sr_adam's device time
     (torch.profiler) and launches per step, the step's wall time, against
     its plain version and its bound, with the kernel's registers and the
     SASS instructions per element of its vector loops (all-bf16 and
     all-f32 leaves) and the issue time they imply;
  7. the CLI, `svbrdf_tpu_torch.main.main([...])` in process at full width
     on 101 maps-only 1024 x 256 strips (two strips' maps written with the
     port's PNG writer, and symlinks; the 1 % split holds one out), each run
     with the launch counters set to 0 just before and read just after:
       - single view, mixed loss, --dtype float32, 2 epochs (13 steps each,
         one validation sample each), then resumed to 3 epochs, then test
         mode on data/test: the counters equal the loop's train steps
         (mixed_fwdgrad) and validation batches (mixed_fwd), the checkpoint
         reloads into a fresh model that predicts the same bits, the logs,
         grid and metrics.json read back;
       - the same for 1 epoch with --device-data-cache;
       - multi view (3 synthesized views), rendering loss, --dtype float32,
         1 epoch with --device-data-cache and 2 without (render_fwdgrad,
         render_fwd);
       - single view, mixed loss at the CLI's defaults (--dtype auto: bf16
         on the card, bf16-SR masters), TF32 as torch sets it: 2 epochs,
         then resumed to 3 ("Restored master_dtype 'bf16sr'"): the bf16
         loss kernels and one sr_adam launch per step, f32
         weights in the checkpoint, which a fresh bf16-SR model reloads to
         predict the same bits;
       - single view, mixed loss, --renderer pathtracing at the CLI's
         defaults and with --dtype float32, 1 epoch each: no loss kernel,
         the path tracer's kernels as on the path (phase 5), one sr_adam a
         bf16-SR step;
     and the loop's median ms per step against the build_program train
     step of phase 5, each epoch's validation pass ms (epoch 0 decodes the
     strips through the dataset's decode pool of worker processes, later
     epochs read its caches: epoch 0's median against epoch 1's), the
     decode ms of one strip, the checkpoint's save ms and size. Every run
     passes --num-devices 1, so that the default (every visible card)
     cannot change what it times;
  8. data parallel (parallel/mesh, the data-parallel step), each run with
     the launch counters set to 0 just before and read just after:
       - the CLI's defaults (bf16, bf16-SR) at full width for 1 epoch on
         phase 7's corpus: plain, then through the launcher
         (`parallel/multihost --num-processes 1`, a world-1 NCCL group),
         then plain again, dropout's generators reseeded alike: each
         run's median ms a step and launches (mixed_fwdgrad and sr_adam
         once a step), the launcher's final weights against the plain
         runs' (bit-equal where the plain runs are);
       - world 2 on the card (two cards over NCCL where there are two,
         else both ranks on cuda:0 over gloo): the main path's program at
         full width, global batch 8, 5 f32 steps (TF32 off, dropout off)
         against world 1's (the first step's loss rel 1e-5, every step's
         1e-4, the update normwise 5e-2: cuDNN's backward differs by
         batch size, DP_TOL),
         then 5 bf16-SR steps; the replicas bit-identical after each
         (all-gathered checksums), each rank's launches, ms a step;
  9. the tail (the inference API and the tools) at full width, each run
     with every launch counter set to 0 just before and read just after:
       - data/toy.generate_toy_dataset on the card: 8 train and 8 test
         256^2 strips of 10 photos (ms a strip), the train directory
         filled with symlinks to 101 files;
       - the CLI on those photo strips at its defaults (bf16, bf16-SR),
         --image-count 10 --used-image-count 1, 1 epoch: mixed_fwdgrad_bf16
         and sr_adam once a step, mixed_fwd_bf16 once a validation batch,
         every other counter 0; its median ms a step beside phase 7's
         maps-only run at the same precision;
       - SvbrdfEstimator.from_checkpoint on its checkpoint: predict on 8
         test photos bit-equal to a fresh model restored from the same
         file, predict_to_files' 8 strips read back at (256, 1024, 3),
         predict ms at batch 8 and ms a photo file to file;
       - experiments/map_recovery: the diffuse map of a 256^2 toy material
         over 200 steps under 6 fixed scenes (last loss < 0.3 x the
         first, ms a step); at 16^2, 10 steps on the card against the same
         call on the CPU (loss rel 1e-4, maps 1e-4);
       - viz.turntable_frames: 8 frames of 384^2 written as a GIF (its
         header, frames, delays and loop block read back);
       - the four examples' main(argv) once each, each writing its file;
       - utils/flops.mfu of the main path's f32 and bf16-SR train steps
         (phases 5-6) against this card's peaks;
 10. spatial H-sharding (--shard-spatial; parallel/spatial,
     training/spatial_loop), each run with every launch counter set to 0
     just before and read just after:
       - render_fwdgrad and render_fwd on the two row halves of the 256^2
         input set (row offset 0 and 128, global height 256) against their
         plain versions by phase 3's rules; the halves' losses sum to the
         whole image's (rel 1e-6);
       - world 2 (two cards over NCCL where there are two, else both ranks
         on cuda:0 over gloo): the main path's program at full width, the
         height split over the ranks, 5 f32 steps (TF32 off, dropout off)
         against world 1 (DP_TOL), and at 32^2 with cuDNN off
         (DP_TOL_EXACT); an eval step and predict against one device's;
         the replicas bit-identical; render_fwdgrad once a train step and
         render_fwd once an eval step on each rank, every other counter 0;
         each rank's peak device memory at 256^2 batch 8 and 1024^2 batch 2
         beside one device's; ms a step and the collectives' host ms;
       - the CLI at its defaults with --shard-spatial 2 for 1 epoch on
         phase 7's corpus, main.main(argv, group) in the two ranks: the
         launches, the checkpoint's meta (upconv 'fold', master_dtype
         'f32'), a fresh model restored from it predicting the same bits;
       - dryrun.run_spatial(2), which with one card must raise the no-card
         error.
The next-to-last line is the JSON `kernels` record; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# The least operations per pixel that each kernel's function needs. Each
# value is counted once: terms that do not depend on the colour channel
# once per side, terms that do not depend on the side once per scene, terms
# that do not depend on the scene once per pixel, terms of the scene alone
# (z^2, colour / pi) not per pixel. log, sqrt, rsqrt and reciprocal count
# as one special-function operation (SFU) each; add, sub, mul, max and
# compare-select as one FP32 operation, a fused multiply-add as two; abs
# and negation are free operand modifiers. All five on the algebra of
# csrc/value_shading.cuh, which needs the fewest and which the value
# kernels and `both` run (shading.cuh's, which the two training kernels run
# to be bit-exact, takes 310 FP32 / 46 SFU per scene for the value alone):
#   value, per scene: geometry (v, l, h, w = 1 - (1 - VH)^5, 1/d^2 =
#     (1/d)^2) 41 FP / 3 SFU; two sides (dots, clamps, NH^2, VN^2, LN^2 and
#     their complements, scale) 52 / 0; six channel shades (denom, two
#     sv = sqrt(VN^2 + a (1 - VN^2)) from one rsqrt each, one reciprocal R
#     of P = denom^2 (VN + sv) (LN + sl), spec = a R, 1 - F, radiance + 0.1)
#     132 / 18; three |log(r_p / r_t)| 6 / 6 -> 231 FP, 27 SFU;
#   the pred side's VJP, per scene: 1/r_p for u = sign / r_p and the ratio
#     both from one reciprocal of r_p r_t (3 FP a channel more than the
#     quotient, no SFU more); per channel u, t = u * colour_scale, F, the
#     albedo and 1 - spec terms, d/d spec = t F, then d/dP = -(t F spec) R
#     taken apart by the products already formed (d/d denom = 2 d/dP
#     denom (VN + sv) (LN + sl), d/d(VN + sv) = d/dP denom^2 (LN + sl), and
#     for l), d/d sv^2 from sv's rsqrt, the denominator's clamp, and the
#     sums over channels of d/da, d/dNH^2, d/dVN, d/dLN and d/d scale: 42
#     FP, no SFU; the normal's chain (NH, VN and LN through their squares
#     and clamps, scale's, and three 3-vectors into d/dn) 32 FP -> 158 FP;
#     so fwdgrad 231 + 9 + 158 = 398 FP / 27 SFU, and fwdgrad_both with the
#     gt side's VJP (1/r_t from the same reciprocal) 556 / 27;
#   per pixel once: a = max(rough, eps)^4 and 1 - spec of both sides 24 FP,
#     coordinates and the block sum 7; for the mixed loss the L1 term (one
#     log of each log-space ratio) and the scaling 39 FP / 12 SFU; with a
#     gradient, d/d roughness from d/da per channel (12 FP a side), a - 1
#     (3 a side), the L1 gradient (1/(p + 0.01) from the ratio's
#     reciprocal: 4 FP a channel more, no SFU) and dpred's scaling (mixed
#     fwdgrad 175 FP / 12 SFU), or one multiply by 1/count per gradient
#     value written (rendering fwdgrad 58, both 85); the division of the
#     partials' sum by count is one operation per call.
# The FP32 peak counts a fused multiply-add as two operations, so the FP32
# time assumes every add pairs with a multiply. The two training kernels
# are built with -fmad=false and issue each add and multiply alone, at half
# that rate: `fp32_nofma_us` in the bound's parts is that floor for their
# counts (the value kernels and `both` write their FMAs out).
FP32_PER_SCENE = {"mixed_fwdgrad": 398, "mixed_fwd": 231,
                  "render_fwdgrad": 398, "render_fwd": 231,
                  "render_fwdgrad_both": 556}
SFU_PER_SCENE = {"mixed_fwdgrad": 27, "mixed_fwd": 27, "render_fwdgrad": 27,
                 "render_fwd": 27, "render_fwdgrad_both": 27}
FP32_PER_PIXEL = {"mixed_fwdgrad": 175, "mixed_fwd": 70, "render_fwdgrad": 58,
                  "render_fwd": 31, "render_fwdgrad_both": 85}
SFU_PER_PIXEL = {"mixed_fwdgrad": 12, "mixed_fwd": 12, "render_fwdgrad": 0,
                 "render_fwd": 0, "render_fwdgrad_both": 0}
# Plane values each kernel must move per pixel: pred and gt in, gradients
# out; 4 bytes each for f32 planes, 2 for bf16 (the compute terms are the
# same: every kernel shades in f32).
FLOATS_PER_PIXEL = {"mixed_fwdgrad": 36, "mixed_fwd": 24,
                    "render_fwdgrad": 36, "render_fwd": 24,
                    "render_fwdgrad_both": 48}

# The torch build on which the kernels and their plain versions were seen to
# agree to the last bit on an H100 (see phase_kernels).
BIT_EXACT_TORCH = "2.11.0+cu128"

# Peak rates at full power: memory bytes/s, FP32 (non-tensor) FLOP/s,
# special-function results/s (16 per clock per SM on compute capability 9.0,
# CUDA C++ Programming Guide throughput table) and warp instructions issued
# per second (4 schedulers per SM, one each a clock), at the boost clock
# that gives the FP32 figure. NVIDIA data sheets. First match wins.
CARDS = (
    ("H100 PCIe", {"bytes": 2.0e12, "fp32": 51.2e12,
                   "sfu": 114 * 16 * 1.755e9, "issue": 114 * 4 * 1.755e9}),
    ("H200", {"bytes": 4.8e12, "fp32": 66.9e12, "sfu": 132 * 16 * 1.98e9,
              "issue": 132 * 4 * 1.98e9}),
    ("H100", {"bytes": 3.35e12, "fp32": 66.9e12, "sfu": 132 * 16 * 1.98e9,
              "issue": 132 * 4 * 1.98e9}),
)

_MIXED = "svbrdf_tpu_torch/csrc/mixed_loss.cu"
_RENDERING = "svbrdf_tpu_torch/csrc/rendering_loss.cu"
KERNELS = {
    "mixed_fwdgrad": {
        "route": "cuda", "source": _MIXED,
        "replaces": "svbrdf_tpu/ops/render_pallas.py:470",
        "tpu_kernel": "_mixed_fwdgrad_kernel"},
    "mixed_fwd": {
        "route": "cuda", "source": _MIXED,
        "replaces": "svbrdf_tpu/ops/render_pallas.py:440",
        "tpu_kernel": "_mixed_fwd_kernel"},
    "render_fwdgrad": {
        "route": "cuda", "source": _RENDERING,
        "replaces": "svbrdf_tpu/ops/render_pallas.py:392",
        "tpu_kernel": "_fwdgrad_kernel"},
    "render_fwd": {
        "route": "cuda", "source": _RENDERING,
        "replaces": "svbrdf_tpu/ops/render_pallas.py:370",
        "tpu_kernel": "_fwd_kernel"},
    "render_fwdgrad_both": {
        "route": "cuda", "source": _RENDERING,
        "replaces": "svbrdf_tpu/ops/render_pallas.py:508",
        "tpu_kernel": "_fwdgrad_kernel_both"},
}

# The fused SR-Adam update: not a TPU kernel's port (XLA fuses the update
# in the JAX package, at the line named).
SR_ADAM = {"name": "sr_adam", "route": "cuda",
           "source": "svbrdf_tpu_torch/csrc/sr_adam.cu",
           "replaces": "svbrdf_tpu/parallel/optimizer.py:75",
           "tpu_kernel": None}
# Its least operations per element: mu 3, nu 4, u 6 (two quotients and a
# square root counted as one operation each), p + u 1: 14 FP32; the hash's
# integer operations are not counted. Bytes: each value read or written once.
SR_ADAM_FP32_PER_ELEMENT = 14

MAIN = {"batch": 8, "size": 256, "depth": 8, "num_filters": 64,
        "n_scenes": 9, "train_steps": 5}
# The paths driven at full width: (model kind, loss kind), the compute dtype
# and master policy, and the launches each must show by counter (every
# other counter: 0; a bf16-SR path's sr_adam count, one launch per step,
# is added where the path runs).
STEPS = MAIN["train_steps"]
BF16 = torch.bfloat16
PATHS = {
    "single_mixed": (("single", "mixed"), torch.float32, None,
                     {"mixed_fwdgrad": STEPS, "mixed_fwd": 1}),
    "multi_rendering": (("multi", "rendering"), torch.float32, None,
                        {"render_fwdgrad": STEPS, "render_fwd": 1}),
    "single_mixed_bf16": (("single", "mixed"), BF16, "bf16sr",
                          {"mixed_fwdgrad_bf16": STEPS,
                           "mixed_fwd_bf16": 1}),
    "multi_rendering_bf16": (("multi", "rendering"), BF16, "bf16sr",
                             {"render_fwdgrad_bf16": STEPS,
                              "render_fwd_bf16": 1}),
}
# The path tracer's full-width paths (--renderer pathtracing): single view,
# mixed loss, at the CLI's default precision (bf16, bf16-SR masters) and in
# f32 with TF32 off. The loss kernels do not run; the path tracer's own do
# (csrc/pathtrace.cu; no TPU kernel: plain JAX in the reference), as (per
# train step, per eval step) launches: the forward kernel for the
# prediction's render (in the compute dtype) and for the target's (f32
# maps: the path-traced loss does not cast the target), the VJP for the
# prediction's. sr_adam once a bf16-SR step (added where the path runs).
TRACED_PATH = "single_mixed_pathtracing"
TRACED_PATH_F32 = "single_mixed_pathtracing_f32"
TRACED_PATHS = {
    TRACED_PATH: (("single", "mixed"), BF16, "bf16sr", (
        {"pathtrace_shade_bf16": 1, "pathtrace_shade": 1,
         "pathtrace_shade_vjp_bf16": 1},
        {"pathtrace_shade_bf16": 1, "pathtrace_shade": 1})),
    TRACED_PATH_F32: (("single", "mixed"), torch.float32, None, (
        {"pathtrace_shade": 2, "pathtrace_shade_vjp": 1},
        {"pathtrace_shade": 2})),
}
_PATHTRACE = "svbrdf_tpu_torch/csrc/pathtrace.cu"
PATHTRACE_KERNELS = {
    "pathtrace_shade": {
        "route": "cuda", "source": _PATHTRACE,
        "replaces": "svbrdf_tpu/ops/pathtrace.py:149",
        "tpu_kernel": None},
    "pathtrace_shade_vjp": {
        "route": "cuda", "source": _PATHTRACE,
        "replaces": "svbrdf_tpu/ops/pathtrace.py:231",
        "tpu_kernel": None},
}
# The least operations of the path tracer's kernels, counted from
# csrc/pathtrace.cu's algebra by the convention of the loss kernels' counts
# above (an FMA as two, a quotient as one reciprocal, an SFU operation, and
# a product; pow as log2 and exp2, two SFU, and a product; floor one FP32),
# each term once where it depends on no more than it: per sample and pixel
# of one scene, per pixel and scene, per pixel. The precision devices (1 -
# n.h from the cross product, the lobe's log by its polynomial, the
# cosines' dot products in double) are left out: the same function at f32
# accuracy needs none of them.
#   forward, per sample: the point on the light and rel (u's wrap with its
#     floor 10, u times the extent 2, (light - coords) + a0 t_l + a1 b_l
#     12) 24; d^2 5 and wi from one rsqrt 3 / 1; cos_surf and cos_light
#     with their clips 12; w = cs cl (1/d)^2 3; h (sum 3, |.|^2 5, one
#     rsqrt, scale 3) 11 / 1; n.h and wo.h with clips 14; n.wi's clip 2;
#     pow(n.h, e) 1 / 2; (1 - wo.h)^5 4; G1(n.wi) as a quotient (clips 4,
#     1 - ct^2 2, a from one rsqrt 2 / 1, the rational's numerator and
#     denominator 8, their selects 2) 18 / 1; r = pw num / (den nl) from
#     one reciprocal (den nl 1, two products) 3 / 1; the four sums (1 - x5
#     1, w r 1, three FMAs and an add) 9 -> 109 / 6 (G1's quotient and 1 /
#     nl as two reciprocals: 108 / 7; a per-channel algebra: 145 / 7);
#     per pixel and scene: wo (cam - coords 3, |.|^2 5, rsqrt, scale 3)
#     11 / 1, light - coords 3, n.wo and its clip 7, G1(n.wo) 18 / 2, A =
#     G1 dn / (4 nv) 3 / 1, three channels from the sums (diffuse 2, A (sp
#     (R2 + RX) + oms RX) 5, em area / spp 2) 27 -> 69 / 4 (G1's quotient
#     and 1 / nv from one reciprocal, 70 / 3, would not lower the bound:
#     with the sample's 109 / 6 the forward is FP32-bound);
#     per pixel: r's clip, 1/r, e, (e + 2)/(2 pi), sqrt(.5 e + 1) 11 / 2,
#     dif / pi, 1 - specular 6 -> 17 / 2;
#   VJP without scene gradients, per sample (FP32-bound: each reciprocal
#     shared by one more product would raise its bound, so the forward's
#     terms are counted with two) the forward's 108 / 7; the
#     coefficients' B (4) and d w r (2) 6; d cos_surf 2; d pw, d G1, d nl
#     (t 2, 1, 1, 2) 6; G1(n.wi)'s VJP 28; pow's (e log n.h 2, e pw / n.h
#     3 / 1) 5 / 1; the clips' derivatives 6; d n.wi 4; h 3 and d normals 12
#     15 -> 182 / 8;
#     per pixel and scene: the forward's view terms but the channels 42 /
#     4; the coefficients (ge 6, beta 9, gamma 6, eta 6, A's 2) 29; A's
#     cotangent and its chain to dn and nv (g_A 4, 2, 3, 2) 11, G1(n.wo)'s
#     VJP 28, n.wo's chain 10, the maps' sums 15 -> 135 / 4;
#     per pixel: the forward's 17 / 2, the maps' cotangents 12 and e's
#     chain to rough_blinn 9 -> 38 / 2.
#   With scene gradients the VJP adds ~110 FP32 a sample (wo, wi, rel and
#   the per-block partials): its bound is given for the training kernel.
PATHTRACE_OPS = {"pathtrace_shade": {"sample": (109, 6), "view": (69, 4),
                                     "pixel": (17, 2)},
                 "pathtrace_shade_vjp": {"sample": (182, 8),
                                         "view": (135, 4),
                                         "pixel": (38, 2)}}
# The card-vs-CPU check of the path tracer, and the stability run's steps.
PATHTRACE_SMALL = {"batch": 2, "size": 32, "spp": (4, 2)}
STABILITY_STEPS = 20
TARGET_GRAD_PATH = "rendering_target_grad"
# The path whose run each kernel's `launches` comes from, and its calls
# (train steps, eval steps or target-gradient calls) in that run.
KERNEL_PATH = {"mixed_fwdgrad": ("single_mixed", STEPS),
               "mixed_fwd": ("single_mixed", 1),
               "render_fwdgrad": ("multi_rendering", STEPS),
               "render_fwd": ("multi_rendering", 1),
               "render_fwdgrad_both": (TARGET_GRAD_PATH, 1)}
# The run that launches each kernel's bf16 instantiation on a path.
KERNEL_PATH_BF16 = {"mixed_fwdgrad": "single_mixed_bf16",
                    "mixed_fwd": "single_mixed_bf16",
                    "render_fwdgrad": "multi_rendering_bf16",
                    "render_fwd": "multi_rendering_bf16",
                    "render_fwdgrad_both": "bf16_rendering_target_grad"}

# The CLI phase: full width, 101 maps-only strips (100 train, 1 held out).
CLI = {"size": 256, "depth": 8, "num_filters": 64, "batch": 8,
       "samples": 101}
REPO = pathlib.Path(__file__).resolve().parent
# The keys of the JAX package's metrics.json (svbrdf_tpu/metrics.py).
METRIC_KEYS = ("rmse_normals", "rmse_diffuse", "rmse_roughness",
               "rmse_specular", "log_rmse_diffuse", "log_rmse_specular",
               "ssim_normals", "ssim_diffuse", "ssim_roughness",
               "ssim_specular", "rendering_rmse")
# Printout lines of a CLI run worth echoing.
CLI_ECHO = ("Training samples", "Validation samples", "Restored epoch",
            "Restored master_dtype",
            "Training from", "validation loss", "steps:", "Test metrics",
            "Device data cache")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_rates(name: str) -> dict:
    for key, rates in CARDS:
        if key in name:
            return rates
    raise RuntimeError(f"no peak rates recorded for {name!r}")


def cuda_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median of `runs` CUDA-event timings of fn() after `warmup` calls
    (bench_setup.cuda_ms)."""
    from svbrdf_tpu_torch.utils.bench_setup import cuda_ms as timed

    return timed(fn, runs, warmup)


def bound(kernel: str, batch: int, height: int, width: int, n_scenes: int,
          rates: dict, plane_bytes: int = 4) -> tuple:
    """(bound_ms, bound_by, parts in us) for one call on planes of
    `plane_bytes` bytes a value: the larger of the bytes it must move over
    the memory rate and its operations over the peak rates."""
    pixels = batch * height * width
    bytes_moved = (pixels * FLOATS_PER_PIXEL[kernel] * plane_bytes
                   + batch * n_scenes * 9 * 4)
    fp32 = pixels * (n_scenes * FP32_PER_SCENE[kernel]
                     + FP32_PER_PIXEL[kernel])
    sfu = pixels * (n_scenes * SFU_PER_SCENE[kernel] + SFU_PER_PIXEL[kernel])
    t_bytes = bytes_moved / rates["bytes"]
    t_ops = max(fp32 / rates["fp32"], sfu / rates["sfu"])
    parts = {"bytes_us": t_bytes * 1e6, "fp32_us": fp32 / rates["fp32"] * 1e6,
             "fp32_nofma_us": 2 * fp32 / rates["fp32"] * 1e6,
             "sfu_us": sfu / rates["sfu"] * 1e6}
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", parts
    return t_ops * 1e3, "operations", parts


def pathtrace_bound(kernel: str, items: int, scenes: int, height: int,
                    width: int, spp: int, rates: dict,
                    field_bytes: int = 4) -> tuple:
    """(bound_ms, bound_by, parts in us) of one launch of a path tracer
    kernel (PATHTRACE_OPS) on items x scenes x height x width at spp
    samples, the SVBRDF's values field_bytes each: the larger of its bytes
    (each input read once, each output written once) over the memory rate
    and its operations over the peak rates."""
    pixels = items * height * width
    views = pixels * scenes
    ops = PATHTRACE_OPS[kernel]
    fp32, sfu = (views * spp * ops["sample"][i] + views * ops["view"][i]
                 + pixels * ops["pixel"][i] for i in (0, 1))
    # coords, the maps (10 values), the scene fields and offsets, shift;
    # out (forward) or d_sample in and the maps' 10 sums out (VJP).
    bytes_in = (height * width * 3 * field_bytes + pixels * 10 * field_bytes
                + items * scenes * (18 + 2 * spp) * 4 + views * 2 * 4)
    bytes_moved = bytes_in + (views * 3 * 4 if kernel == "pathtrace_shade"
                              else views * 3 * 4 + pixels * 10 * 4)
    t_bytes = bytes_moved / rates["bytes"]
    t_ops = max(fp32 / rates["fp32"], sfu / rates["sfu"])
    parts = {"bytes_us": t_bytes * 1e6, "fp32_us": fp32 / rates["fp32"] * 1e6,
             "fp32_nofma_us": 2 * fp32 / rates["fp32"] * 1e6,
             "sfu_us": sfu / rates["sfu"] * 1e6}
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", parts
    return t_ops * 1e3, "operations", parts


def phase_device() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("TF32 off: torch.backends.cudnn.allow_tf32 = False, "
        "torch.backends.cuda.matmul.allow_tf32 = False")


def phase_build() -> dict:
    """Build every source; the compiler's output by source (empty where a
    library was up to date)."""
    from svbrdf_tpu_torch.ops import _build

    start = time.perf_counter()
    report = _build.build()
    for name, r in report.items():
        log(f"built {name}.cu in {r['seconds']:.1f} s")
        for line in r["log"].splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                log(f"  ptxas: {line.strip()}")
    log(f"build phase {time.perf_counter() - start:.1f} s")
    return report


def _outputs(out) -> tuple:
    """(loss, gradients...) of a kernel's wrapper or plain version."""
    return out if isinstance(out, tuple) else (out,)


def _loss64(name: str, inputs) -> float:
    """The loss of kernel `name`'s function on `inputs` in float64 (its
    value-only plain version, whose sum every kernel of the loss shares)."""
    from svbrdf_tpu_torch.ops import render_fused as rf

    plain = (rf.mixed_loss_fwd_plain if name.startswith("mixed")
             else rf.rendering_loss_fwd_plain)
    return float(plain(*(t.double() for t in inputs)))


def _normwise(actual, expected, keep=None) -> float:
    """||actual - expected|| / ||expected|| in float64, over the pixels
    where `keep` ((B, H, W)) is true, or all."""
    actual, expected = actual.double(), expected.double()
    if keep is not None:
        actual, expected = actual * keep[:, None], expected * keep[:, None]
    return float((actual - expected).norm() / expected.norm())


def _hold_both(label, out, ref, inputs) -> dict:
    """The kernel with both gradients (csrc/value_vjp.cuh) at its
    tolerance, against the plain version in float64 on the same planes:
    dpred and dgt each normwise no further than 2x the f32 (for bf16
    planes: the bf16) plain version's own distance, and for f32 planes
    <= 2e-4, over the pixels at least render_fused.KINK_MARGIN from a
    point where the loss is not differentiable (render_fused.kink_distance,
    in float64). Closer, an f32 evaluation may take either one-sided
    derivative, and one such pixel can put the plain version itself 1e-2
    from float64 over the whole image; those distances are printed."""
    from svbrdf_tpu_torch.ops import render_fused as rf

    inputs64 = [t.double() for t in inputs]
    ref64 = rf.rendering_loss_fwdgrad_both_plain(*inputs64)
    keep = rf.kink_distance(*inputs64) >= rf.KINK_MARGIN
    errs = {"kink_pixels": 1.0 - float(keep.double().mean())}
    for grad_name, grad, plain, grad64 in zip(("dpred", "dgt"), out[1:],
                                              ref[1:], ref64[1:]):
        kernel_err = _normwise(grad, grad64, keep)
        plain_err = _normwise(plain, grad64, keep)
        errs[grad_name] = {
            "float64_normwise": kernel_err,
            "plain_float64_normwise": plain_err,
            "float64_normwise_all": _normwise(grad, grad64),
            "plain_float64_normwise_all": _normwise(plain, grad64),
            "plain_normwise": _normwise(grad, plain)}
        limit = 2.0 * plain_err
        if inputs[0].dtype == torch.float32:
            limit = min(limit, 2e-4)
        e = errs[grad_name]
        log(f"render_fwdgrad_both [{label}] {grad_name}: float64 normwise "
            f"kernel {kernel_err:.3g}, plain {plain_err:.3g} (limit "
            f"{limit:.3g}) away from the kinks "
            f"({errs['kink_pixels']:.3%} of pixels set apart); over all "
            f"pixels kernel {e['float64_normwise_all']:.3g}, plain "
            f"{e['plain_float64_normwise_all']:.3g}; kernel vs plain "
            f"{e['plain_normwise']:.3g}")
        if kernel_err > limit:
            raise RuntimeError(f"render_fwdgrad_both {grad_name} on {label}: "
                               f"float64 normwise {kernel_err:.3g} > "
                               f"{limit:.3g}")
    return errs


def phase_kernels(input_sets: dict) -> dict:
    """Each kernel against its plain version on each input set (pred far
    from gt; pred near gt, as near convergence; each in f32 and, labelled
    " bf16", as bf16 planes): loss rel <= 1e-5; the two training kernels'
    gradients bit-exact (f32: every value within 1e-6 * its max |value|,
    which on an H100 they meet to the last bit); `both` as _hold_both says;
    each loss against the plain version in float64; each bf16 launch equal
    to the f32 instantiation's on the upcast planes, the gradients rounded
    once, and its loss near the f32 loss on the unquantized planes
    (_hold_bf16); exactly 0 for pred equal to gt; a NaN in pred gives
    `both` a NaN loss."""
    from svbrdf_tpu_torch.ops import render_fused as rf

    errors = {name: {} for name in rf.PLAIN_VERSIONS}
    for label, inputs in input_sets.items():
        bf16 = inputs[0].dtype == torch.bfloat16
        loss64 = {kind: _loss64(kind, inputs) for kind in ("mixed", "render")}
        for name, plain in rf.PLAIN_VERSIONS.items():
            out = _outputs(rf.CUDA_WRAPPERS[name](*inputs))
            torch.cuda.synchronize()
            ref = _outputs(plain(*inputs))
            torch.cuda.synchronize()
            loss, ref_loss = float(out[0]), float(ref[0])
            rel = abs(loss - ref_loss) / abs(ref_loss)
            grad_errs, parts = [], []
            for i, (g, g_ref) in enumerate(zip(out[1:], ref[1:])):
                if not torch.isfinite(g).all():
                    raise RuntimeError(f"{name} produced non-finite gradient "
                                       f"{i} on {label}")
                if g.dtype != inputs[0].dtype:
                    raise RuntimeError(f"{name} gradient {i} is {g.dtype}")
                err = float((g.float() - g_ref.float()).abs().max())
                scale = float(g_ref.float().abs().max())
                grad_errs.append(err)
                parts.append(f"grad {i}: max |ref| {scale:.3g}, max abs err "
                             f"{err:.3g} (ratio {err / scale:.3g})")
                if name == "render_fwdgrad_both":
                    continue  # held by _hold_both below
                # The training kernels round every op as the plain versions
                # do on the card (no FMA contraction; x / c as x * (1/c),
                # as torch takes a tensor divided by a Python number), and
                # with torch BIT_EXACT_TORCH on an H100 the two agree to the
                # last bit, in f32 and so in bf16 (rounded once each). A
                # kernel that rounds one op otherwise is ~1e-4 * max|grad|
                # away (9.8e-5 measured with IEEE divisions by pi): a
                # normal's gradient scales one ulp by up to 1/denom^3 ~
                # 1e9, and a log-difference within rounding of 0 flips
                # |x|'s sign. So another torch that rounds these ops
                # otherwise fails this check with no fault in the kernel;
                # the message says so.
                if (not torch.equal(g, g_ref)) if bf16 else err > 1e-6 * scale:
                    raise RuntimeError(
                        f"{name} gradient {i} disagrees with its plain "
                        f"version on {label}: {err:.3g} vs max {scale:.3g}; "
                        f"the two agreed to the last bit with torch "
                        f"{BIT_EXACT_TORCH}, this is torch "
                        f"{torch.__version__}")
            ref64 = loss64["mixed" if name.startswith("mixed") else "render"]
            rel64 = abs(loss - ref64) / abs(ref64)
            plain_rel64 = abs(ref_loss - ref64) / abs(ref64)
            log(f"{name} [{label}]: loss kernel {loss:.9g} plain "
                f"{ref_loss:.9g} rel {rel:.3g}; float64 {ref64:.12g}: "
                f"kernel rel {rel64:.3g}, f32 plain rel {plain_rel64:.3g}"
                + "".join(f"; {p}" for p in parts))
            # The value-only kernels and `both` round otherwise than their
            # plain versions (csrc/value_shading.cuh, csrc/value_vjp.cuh)
            # and are held here, on every input set.
            if rel > 1e-5:
                raise RuntimeError(f"{name} loss disagrees with its plain "
                                   f"version on {label}: rel {rel:.3g} > 1e-5")
            errors[name][label] = {
                "max_abs_err": (max(grad_errs) if grad_errs
                                else abs(loss - ref_loss)),
                "loss_rel_err": rel, "float64_rel": rel64,
                "plain_float64_rel": plain_rel64}
            if name == "render_fwdgrad_both":
                errors[name][label].update(_hold_both(label, out, ref,
                                                      inputs))
            if bf16:
                errors[name][label].update(_hold_bf16(
                    name, label, out, inputs, input_sets[label[:-5]]))
    # pred equal to gt: both sides must round alike, to a loss and gradients
    # of exactly 0, as the plain versions and the TPU kernels give; and a
    # NaN in pred gives `both` a NaN loss, as the value kernels.
    for label, (pred_t, gt_t, scenes9) in input_sets.items():
        if "near" in label:
            continue
        for name in rf.PLAIN_VERSIONS:
            zero = _outputs(rf.CUDA_WRAPPERS[name](gt_t.clone(), gt_t,
                                                   scenes9))
            nonzero = [int(torch.count_nonzero(g)) for g in zero[1:]]
            log(f"{name} [{label}] pred == gt: loss {float(zero[0])!r}, "
                f"non-zero gradient values {nonzero}")
            if float(zero[0]) != 0.0 or any(nonzero):
                raise RuntimeError(f"{name} does not give 0 for pred equal "
                                   f"to gt on {label}")
        bad = pred_t.clone()
        bad[1, 3, 7, 5] = math.nan
        nan_loss = float(rf.rendering_loss_fwdgrad_both_cuda(bad, gt_t,
                                                            scenes9)[0])
        log(f"render_fwdgrad_both [{label}] NaN in pred: loss {nan_loss!r}")
        if not math.isnan(nan_loss):
            raise RuntimeError("render_fwdgrad_both: a NaN in pred gives a "
                               "loss that is not NaN")
    return errors


def _hold_bf16(name, label, out, inputs, inputs32) -> dict:
    """A bf16 launch of kernel `name` against its f32 instantiation on the
    upcast planes (the same loss, each gradient that one rounded once to
    bf16) and its loss against the f32 loss on the unquantized planes
    `inputs32`: rel <= 2e-2 with pred far from gt, as the JAX package's
    bf16 test holds it. Near gt the rel is printed only: rounding each side
    to bf16 (~2e-3) moves it further than the 1e-3 that separates them."""
    from svbrdf_tpu_torch.ops import render_fused as rf

    pred_t, gt_t, scenes9 = inputs
    wrapper = rf.CUDA_WRAPPERS[name]
    out32 = _outputs(wrapper(pred_t.float(), gt_t.float(), scenes9))
    same = torch.equal(out[0], out32[0]) and all(
        torch.equal(g, g32.to(torch.bfloat16))
        for g, g32 in zip(out[1:], out32[1:]))
    loss32 = float(_outputs(wrapper(*inputs32))[0])
    rel32 = abs(float(out[0]) - loss32) / abs(loss32)
    log(f"{name} [{label}]: f32 instantiation on the upcast planes, "
        f"rounded: {'equal' if same else 'DIFFERENT'}; loss against f32 "
        f"on the unquantized planes rel {rel32:.3g}")
    if not same:
        raise RuntimeError(f"{name} on {label}: the bf16 instantiation "
                           f"differs from the f32 one on the upcast planes")
    if rel32 > 2e-2 and "near" not in label:
        raise RuntimeError(f"{name} on {label}: bf16 loss rel {rel32:.3g} "
                           f"from the f32 loss > 2e-2")
    return {"f32_loss_rel": rel32}


# The storage dtypes (p, g, mu, nu) of each kind of leaf the policies
# train: >=2-D leaves under bf16-SR masters or f32 masters with 'bf16sr'
# state, and under 'bf16' state; 1-D leaves (f32 masters; f32 moments under
# 'bf16sr', a bf16 mu under 'bf16').
F32 = torch.float32
# Each combination's (p, g, mu, nu) dtypes and whether its launch takes the
# 'bf16' state mode's flag (optax's bf16-mu order).
SR_COMBOS = {
    "conv": {"bf16 masters, bf16sr state": ((BF16, BF16, BF16, BF16), False),
             "f32 masters, bf16sr state": ((F32, F32, BF16, BF16), False),
             "f32 masters, bf16 state": ((F32, F32, BF16, F32), True)},
    "1-D": {"bf16sr state": ((F32, F32, F32, F32), False),
            "bf16 state": ((F32, F32, BF16, F32), True)},
}
# The 'bf16' state mode over every leaf of the full-width single-view
# model: the Adam step counts.
SR_BF16_STATE_COUNTS = (1, 2148)
# (Adam step count, master salt): salts at 0, the largest and another, the
# counts past 2147, where JAX's int32 moment salt count * 1000003 wraps.
SR_STEPS = ((1, 0), (2148, 2 ** 31 - 2), (5000, 123456789))


def _sr_leaf_shapes() -> dict:
    """The largest conv leaf and the largest 1-D leaf of the full-width
    single-view model (shapes only, made on the meta device)."""
    from svbrdf_tpu_torch.models.generator import Generator

    with torch.device("meta"):
        gen = Generator(9, MAIN["num_filters"], MAIN["depth"])
    params = list(gen.parameters())
    return {"conv": tuple(max((p for p in params if p.dim() >= 2),
                              key=lambda p: p.numel()).shape),
            "1-D": tuple(max((p for p in params if p.dim() == 1),
                             key=lambda p: p.numel()).shape)}


def phase_sr_adam() -> dict:
    """The fused SR-Adam kernel against its plain version on the card,
    bit-exact (p, mu and nu equal), for each leaf kind, dtype combination
    and (count, salt) of SR_COMBOS and SR_STEPS; then its SR unbiased: the
    mean over 400 salts of a stochastically rounded nu within rel 1e-3 of
    the f32 value, as the JAX package's test holds sr_bf16."""
    from svbrdf_tpu_torch.ops import sr_adam
    from svbrdf_tpu_torch.parallel import optimizer as opt

    g = torch.Generator(device="cuda").manual_seed(11)
    out = {"checks": [], "max_abs_err": 0.0}
    for kind, shape in _sr_leaf_shapes().items():
        for label, (dtypes, bf16_mu) in SR_COMBOS[kind].items():
            for count, salt in SR_STEPS:
                scales = (0.02, 1e-3, 1e-4)
                leaf = [(torch.randn(shape, generator=g, device="cuda")
                         * sc).to(dt) for sc, dt in zip(scales, dtypes)]
                leaf.append((torch.rand(shape, generator=g, device="cuda")
                             * 1e-6).to(dtypes[3]))
                s = opt.adam_scalars(1e-5, (0.9, 0.999), 1e-8, count,
                                     count * 1000003 + 7, salt + 7,
                                     bf16_mu_product=bf16_mu)
                kern = [t.clone() for t in leaf]
                plain = [t.clone() for t in leaf]
                sr_adam.sr_adam_update_cuda(*kern, s)
                opt.adam_update_plain(*plain, s)
                torch.cuda.synchronize()
                equal = all(torch.equal(a, b) for a, b in zip(kern, plain))
                err = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(kern, plain))
                moved = float((kern[0] != leaf[0]).double().mean())
                out["checks"].append({"leaf": kind, "shape": list(shape),
                                      "dtypes": label, "count": count,
                                      "master_salt": salt, "equal": equal,
                                      "max_abs_err": err})
                out["max_abs_err"] = max(out["max_abs_err"], err)
                log(f"sr_adam {kind} {shape} [{label}] count {count} salt "
                    f"{salt}: kernel vs plain "
                    f"{'bit-exact' if equal else 'DIFFERENT'} (max abs err "
                    f"{err:.3g}); {moved:.3%} of p moved")
                if not equal:
                    raise RuntimeError(f"sr_adam differs from its plain "
                                       f"version on {kind} [{label}] at "
                                       f"count {count}")
    # Unbiasedness: nu32 = 0 * 1 + x * x * 1 stored bf16 through SR.
    x = torch.sqrt(torch.empty(64, device="cuda").uniform_(
        1e-8, 1e-4, generator=g))
    target = (x * x).double()
    acc = torch.zeros(64, dtype=torch.float64, device="cuda")
    n_salts = 400
    for salt in range(n_salts):
        p, mu = torch.zeros_like(x), torch.zeros_like(x)
        nu = torch.zeros(64, dtype=BF16, device="cuda")
        sr_adam.sr_adam_update_cuda(p, x, mu, nu, opt.AdamScalars(
            b1=0.9, omb1=0.1, b2=1.0, omb2=1.0, bc1=1.0, bc2=1.0, eps=1e-8,
            neg_lr=0.0, nu_salt=salt, master_salt=0))
        acc += nu.double()
    rel = float(((acc / n_salts - target).abs() / target).max())
    log(f"sr_adam SR unbiased: mean over {n_salts} salts, max rel err "
        f"{rel:.3g} (limit 1e-3)")
    if rel > 1e-3:
        raise RuntimeError(f"sr_adam SR is biased: rel {rel:.3g}")
    out["unbiased_max_rel"] = rel
    out["models"] = {kind: _sr_adam_model_check(kind, g)
                     for kind in ("single", "multi")}
    # The 'bf16' state mode (SVBRDF_OPT_STATE=bf16): f32 parameters and
    # gradients, bf16 mu, f32 nu, the launch's flag set; its launches
    # counted from 0.
    sr_adam.sr_adam_multi_cuda.launches = 0
    out["bf16_state"] = {count: _sr_adam_model_check("single", g, "bf16",
                                                     count)
                         for count in SR_BF16_STATE_COUNTS}
    out["bf16_state_launches"] = sr_adam.sr_adam_multi_cuda.launches
    log(f"sr_adam 'bf16' state mode: every leaf of the single-view model at "
        f"counts {SR_BF16_STATE_COUNTS}, bit-exact, "
        f"{out['bf16_state_launches']} launch(es)")
    out["bf16_state_times"] = _sr_adam_bf16_state_times(g)
    return out


def _sr_adam_bf16_state_times(g) -> dict:
    """One multi-tensor update of every leaf of the full-width single-view
    model in the 'bf16' state mode's dtypes (f32 p and g, bf16 mu, f32 nu:
    24 bytes an element read and written), CUDA-event median of 20: the
    mode's kernel (the flag) beside sr_adam_kernel on the same leaves, and
    the bytes' bound."""
    from svbrdf_tpu_torch.models import build_model
    from svbrdf_tpu_torch.ops import sr_adam
    from svbrdf_tpu_torch.parallel import optimizer as opt

    leaves = []
    for i, p in enumerate(build_model("single", False, MAIN["depth"],
                                      MAIN["num_filters"],
                                      device="cuda").parameters()):
        shape = tuple(p.shape)
        leaves.append(sr_adam.SrLeaf(
            i, torch.randn(shape, generator=g, device="cuda") * 0.02,
            torch.randn(shape, generator=g, device="cuda") * 1e-3,
            torch.zeros(shape, dtype=BF16, device="cuda"),
            torch.zeros(shape, device="cuda")))
    elements = sum(lf.p.numel() for lf in leaves)
    s = opt.adam_scalars(1e-5, (0.9, 0.999), 1e-8, 2148, 2148 * 1000003, 0,
                         bf16_mu_product=True)
    plans = {}
    out = {"elements": elements,
           "ms": cuda_ms(lambda: sr_adam.sr_adam_multi_cuda(leaves, s,
                                                            plans)),
           "sr_adam_kernel_ms": cuda_ms(lambda: sr_adam.sr_adam_multi_cuda(
               leaves, s._replace(bf16_mu_product=False), plans)),
           "bound_ms": elements * 24 / card_rates(
               torch.cuda.get_device_name(0))["bytes"] * 1e3,
           "bound_by": "bytes"}
    log(f"sr_adam 'bf16' state mode, one update of {elements} elements: "
        f"{out['ms']:.4f} ms (sr_adam_kernel on the same leaves "
        f"{out['sr_adam_kernel_ms']:.4f} ms), bound {out['bound_ms']:.4f} ms "
        f"(bytes)")
    return out


def _sr_adam_model_check(kind: str, g, state: str = "bf16sr",
                         count: int = 2148) -> dict:
    """Every leaf of the full-width `kind` model in one multi-tensor call,
    random gradients and moments, Adam step `count` and a master salt that
    wraps with the leaf index: bit-exact against the plain version, one
    launch per table. state 'bf16sr': the bf16-SR main path's dtypes
    (>=2-D leaves: bf16 master, gradient and moments; 1-D: f32); 'bf16':
    the 'bf16' state mode's (f32 parameters and gradients, bf16 mu, f32
    nu, optax's bf16-mu order)."""
    from svbrdf_tpu_torch.models import build_model
    from svbrdf_tpu_torch.ops import sr_adam
    from svbrdf_tpu_torch.parallel import optimizer as opt

    shapes = [tuple(p.shape) for p in build_model(
        kind, False, MAIN["depth"], MAIN["num_filters"],
        device="cuda").parameters()]
    leaves = []
    for i, shape in enumerate(shapes):
        dt = BF16 if len(shape) >= 2 else F32
        dts = (dt,) * 4 if state == "bf16sr" else (F32, F32, BF16, F32)
        ts = [(torch.randn(shape, generator=g, device="cuda") * sc).to(d)
              for sc, d in zip((0.02, 1e-3, 1e-4), dts)]
        ts.append((torch.rand(shape, generator=g, device="cuda")
                   * 1e-6).to(dts[3]))
        leaves.append(sr_adam.SrLeaf(i, *ts))
    s = opt.adam_scalars(1e-5, (0.9, 0.999), 1e-8, count, count * 1000003,
                         2 ** 32 - 40, bf16_mu_product=state == "bf16")
    copy = [sr_adam.SrLeaf(lf.index, *(t.clone() for t in lf[1:]))
            for lf in leaves]
    before = sr_adam.sr_adam_multi_cuda.launches
    sr_adam.sr_adam_multi_cuda(copy, s)
    launches = sr_adam.sr_adam_multi_cuda.launches - before
    opt.sr_adam_multi_plain(leaves, s)
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for x, y in zip(copy, leaves)
                for a, b in zip(x[1:], y[1:]))
    err = max(float((a.float() - b.float()).abs().max()) for x, y in
              zip(copy, leaves) for a, b in zip(x[1:], y[1:]) if a.numel())
    tables = math.ceil(len(leaves) / sr_adam.max_leaves())
    elements = sum(math.prod(shape) for shape in shapes)
    log(f"sr_adam multi-tensor [{state} state, count {count}], every leaf "
        f"of the full-width {kind}-view model ({len(leaves)} leaves, "
        f"{elements} elements, {launches} launch(es)): kernel vs plain "
        f"{'bit-exact' if equal else 'DIFFERENT'} (max abs err {err:.3g})")
    if not equal or launches != tables:
        raise RuntimeError(f"sr_adam multi-tensor [{state} state] on the "
                           f"{kind}-view model: equal {equal}, {launches} "
                           f"launches for {tables} table(s)")
    return {"leaves": len(leaves), "elements": elements,
            "launches": launches, "equal": equal, "max_abs_err": err}


def _bf16_ulp(a, b):
    """One bf16 ulp at the larger magnitude of a and b, elementwise."""
    big = torch.maximum(a.abs(), b.abs()).clamp_min(1e-38)
    return torch.exp2(torch.floor(torch.log2(big)) - 7)


def _agreement_bf16() -> dict:
    """One train step of a small single-view bf16 model with bf16-SR
    masters on the card against the same program on the CPU (weights,
    batch, scenes and step salt the same, dropout off): loss within rel
    2e-2; the post-step bf16 masters within one bf16 ulp of each other
    except where the two gradients, which differ in bf16 rounding, have
    other signs (<= 0.1 % of the elements), and within one ulp plus 2 lr
    everywhere: each side stochastically rounds p + u to one of its two
    bf16 neighbours with |u| <= lr at the first step, so where p is small
    against lr a sign flip of u moves the two far apart in ulps."""
    from svbrdf_tpu_torch import losses
    from svbrdf_tpu_torch.models import SingleViewModel
    from svbrdf_tpu_torch.ops import sampling
    from svbrdf_tpu_torch.parallel import step as step_lib
    from svbrdf_tpu_torch.utils.bench_setup import synthetic_raw_batch

    lr = 1e-5
    g = torch.Generator().manual_seed(3)
    prep = step_lib.PrepConfig(used_input_image_count=1, mix_materials=True)
    raw = {k: torch.from_numpy(v)
           for k, v in synthetic_raw_batch(2, 32, 0, seed=3).items()}
    batch = step_lib.prepare(raw, prep, g)
    scenes = sampling.generate_loss_scenes(2, generator=g)
    results = {}
    for dev in ("cpu", "cuda"):
        model = SingleViewModel(8, 5, device="cpu", seed=3,
                                dtype=BF16).to(dev)
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.eval()
        with step_lib.master_dtype_scope():
            step_lib.set_master_dtype_policy("bf16sr")
            step_lib.master_cast(model)
        step = step_lib.make_train_step(
            model, step_lib.make_optimizer(model.parameters(), lr, BF16),
            losses.make_loss_fn("mixed"), prep, None, seed=3)
        loss = float(step.update({k: v.to(dev) for k, v in batch.items()},
                                 scenes=scenes.to(dev), step=1))
        results[dev] = (loss, torch.cat([
            p.detach().double().cpu().flatten()
            for p in model.parameters() if p.dim() >= 2]))
    (lc, mc), (lg, mg) = results["cpu"], results["cuda"]
    diff, ulp = (mg - mc).abs(), _bf16_ulp(mg, mc)
    beyond = float((diff > ulp).double().mean())
    worst = float((diff - ulp - 2 * lr).max())
    log(f"agreement SingleViewModel + mixed, bf16 with bf16-SR masters "
        f"(depth 5, 32^2, 8 filters, batch 2): loss card {lg:.9g} cpu "
        f"{lc:.9g}; masters more than one bf16 ulp apart: {beyond:.4%}; "
        f"max |card - cpu| - (ulp + 2 lr) {worst:.3g}")
    if abs(lg - lc) > 2e-2 * abs(lc):
        raise RuntimeError("bf16 card and CPU losses disagree beyond rel "
                           "2e-2")
    if worst > 0.0 or beyond > 1e-3:
        raise RuntimeError("bf16 card and CPU masters disagree beyond SR's "
                           "reach")
    return {"loss_rel": abs(lg - lc) / abs(lc), "beyond_one_ulp": beyond}


def _agreement(model_cls, loss_kind: str, n_views: int) -> None:
    """One train step, the eval loss and a prediction of a small model on
    the card against the same program, weights, batch and scenes on the
    CPU (dropout off on both), where the loss runs the plain versions."""
    from svbrdf_tpu_torch import losses
    from svbrdf_tpu_torch.ops import sampling
    from svbrdf_tpu_torch.parallel import step as step_lib
    from svbrdf_tpu_torch.utils.bench_setup import synthetic_raw_batch

    g = torch.Generator().manual_seed(3)
    prep = step_lib.PrepConfig(used_input_image_count=n_views,
                               mix_materials=True)
    raw = {k: torch.from_numpy(v)
           for k, v in synthetic_raw_batch(2, 32, 0, seed=3).items()}
    batch = step_lib.prepare(raw, prep, g)
    scenes = sampling.generate_loss_scenes(2, generator=g)
    loss_fn = losses.make_loss_fn(loss_kind)
    results = {}
    for dev in ("cpu", "cuda"):
        model = model_cls(8, 5, device="cpu", seed=3).to(dev)
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.eval()
        step = step_lib.make_train_step(
            model, step_lib.make_optimizer(model.parameters()), loss_fn,
            prep, None)
        b = {k: v.to(dev) for k, v in batch.items()}
        sc = scenes.to(dev)
        loss = float(step.update(b, scenes=sc))
        grads = torch.cat([p.grad.flatten() for p in model.parameters()
                           if p.grad is not None]).cpu()
        # The eval step's loss: dropout off, no autograd (value-only kernel).
        with torch.no_grad():
            pred = step_lib.make_predict_fn(model)(b["inputs"])
            eval_loss = float(loss_fn(pred, b["svbrdf"], scenes=sc))
        results[dev] = (loss, grads, eval_loss, pred.cpu())
    (lc, gc, ec, pc), (lg, gg, eg, pg) = results["cpu"], results["cuda"]
    grad_rel = float((gg - gc).norm() / gc.norm())
    pred_err = float((pg - pc).abs().max())
    log(f"agreement {model_cls.__name__} + {loss_kind} (depth 5, 32^2, 8 "
        f"filters, batch 2, {n_views} view(s)): loss card {lg:.9g} cpu "
        f"{lc:.9g}; grad rel {grad_rel:.3g}; eval loss card {eg:.9g} cpu "
        f"{ec:.9g}; predict max abs err {pred_err:.3g}")
    if abs(lg - lc) > 1e-4 * abs(lc) or abs(eg - ec) > 1e-4 * abs(ec):
        raise RuntimeError("card and CPU losses disagree beyond rel 1e-4")
    if grad_rel > 1e-3 or pred_err > 1e-4:
        raise RuntimeError("card and CPU gradients or predictions disagree")


def phase_agreement() -> dict:
    from svbrdf_tpu_torch.models import MultiViewModel, SingleViewModel

    _agreement(SingleViewModel, "mixed", 1)
    _agreement(MultiViewModel, "rendering", 3)
    return _agreement_bf16()


def _zero_counts() -> None:
    from svbrdf_tpu_torch.utils import bench_setup

    bench_setup.zero_launch_counts()


def _counts() -> dict:
    """Every launch counter: each loss kernel's by planes dtype (the bf16
    instantiation as <kernel>_bf16), and sr_adam's."""
    from svbrdf_tpu_torch.utils import bench_setup

    return bench_setup.launch_counts()


@contextlib.contextmanager
def _tf32(cudnn: bool, matmul: bool):
    """TF32 for convolutions and matrix products as given, restored after.
    torch's own defaults are cudnn True, matmul False."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _stepped_leaves(model) -> int:
    """Parameter tensors the last backward gave a gradient."""
    return sum(p.grad is not None for p in model.parameters())


def _sr_adam_launches(model) -> int:
    """sr_adam launches of one AdamBf16SR step of `model`: one per table
    of stepped leaves in the step's one bucket (every leaf shares its param
    group and count on these paths); one table holds them all."""
    from svbrdf_tpu_torch.ops import sr_adam

    return math.ceil(_stepped_leaves(model) / sr_adam.max_leaves())


def _expect(counts: dict, expected: dict, what: str) -> None:
    want = {k: expected.get(k, 0) for k in counts}
    if counts != want:
        raise RuntimeError(f"{what}: launch counts {counts}, expected {want}")


def _tail_launches(kind: str, train: int, forwards: int = 0,
                   depth: int = MAIN["depth"]) -> dict:
    """The block tail's launches (ops.norm_merge) in `train` train steps
    and `forwards` more forwards (eval steps, predict calls) of the
    `kind` model of `depth` blocks run whole on the card: a forward
    launches the forward kernel once a tail (bench_setup.tail_cases), a
    train step also the backward kernel once a tail."""
    from svbrdf_tpu_torch.utils import bench_setup

    tails = len(bench_setup.tail_cases(kind, 1, 2 ** depth, depth))
    return {"norm_merge_fwd": tails * (train + forwards),
            "norm_merge_bwd": tails * train}


def _grids(printout: str) -> int:
    """Comparison grids a CLI run printed that it wrote: after training it
    predicts each held-out sample, one forward each (training/loop.run_test,
    on rank 0 alone)."""
    return sum(line.startswith("wrote ") and line.endswith(".png")
               for line in printout.splitlines())


def _spatial_tail_launches(train: int, forwards: int, size: int,
                           depth: int = MAIN["depth"],
                           world: int = 2) -> dict:
    """_tail_launches of the single-view model sharded by height over
    `world` ranks (parallel/spatial), on each rank: only the blocks that
    run whole there launch the kernels, the encoder blocks whose output
    and the decoder blocks whose input does not split (spatial.splits: a
    height that is a multiple of the world and at least one row a rank);
    the sharded ones take spatial._norm_merge. The first encoder block has
    no tail."""
    def whole(height):
        return height % world != 0 or height < world

    tails = (sum(whole(size >> (i + 1)) for i in range(1, depth))
             + sum(whole(size >> (depth - i)) for i in range(depth)))
    return {"norm_merge_fwd": tails * (train + forwards),
            "norm_merge_bwd": tails * train}


def phase_path(path: str, program) -> dict:
    """One path with every launch counter set to 0 just before and read
    just after: 5 train steps, 1 eval step, predict. A bf16-SR path also
    keeps bf16 >=2-D masters (f32 1-D ones) and moves more than 5 % of
    their elements, as tests/test_training.py::TestBf16SRMasters asks."""
    from svbrdf_tpu_torch.parallel.step import prepare

    spec = PATHS[path] if path in PATHS else TRACED_PATHS[path]
    if path in TRACED_PATHS:
        per_train, per_eval = spec[3]
        train_only = {k: STEPS * n for k, n in per_train.items()}
        expected = {k: train_only.get(k, 0) + per_eval.get(k, 0)
                    for k in {**per_train, **per_eval}}
    else:
        expected, train_only = dict(spec[3]), None
    bf16sr = spec[2] == "bf16sr"
    before = ([p.detach().clone() for p in program.model.parameters()]
              if bf16sr else None)
    torch.cuda.synchronize()
    _zero_counts()
    train_losses = [float(program.train_step(program.raw))
                    for _ in range(STEPS)]
    after_train = _counts()
    eval_loss = float(program.eval_step(program.raw))
    images = prepare(program.raw, program.prep, program.generator)["inputs"]
    svbrdf = program.predict(images)
    torch.cuda.synchronize()
    counts = _counts()
    log(f"{path}: train losses {train_losses}; eval loss {eval_loss!r}; "
        f"launches after train {after_train}, after eval+predict {counts}")

    if not all(torch.isfinite(torch.tensor(train_losses + [eval_loss]))):
        raise RuntimeError(f"{path}: non-finite loss")
    if bf16sr:
        expected["sr_adam"] = STEPS * _sr_adam_launches(program.model)
    if train_only is None:
        train_only = {k: v for k, v in expected.items()
                      if "fwdgrad" in k or k == "sr_adam"}
    elif bf16sr:
        train_only["sr_adam"] = expected["sr_adam"]
    # The block tails: the train steps', then the eval step's and
    # predict's forwards.
    train_only.update(_tail_launches(spec[0][0], STEPS))
    expected.update(_tail_launches(spec[0][0], STEPS, 2))
    _expect(after_train, train_only, f"{path} after the train steps")
    _expect(counts, expected, f"{path} after eval and predict")
    if bf16sr:
        changed = total = 0
        for p0, p in zip(before, program.model.parameters()):
            if p.dtype != (BF16 if p.dim() >= 2 else torch.float32):
                raise RuntimeError(f"{path}: a {p.dim()}-D master is "
                                   f"{p.dtype}")
            if p.dim() >= 2:
                changed += int((p0 != p).sum())
                total += p.numel()
        log(f"{path}: >=2-D masters bf16, 1-D f32; {changed} of {total} "
            f"bf16 master elements changed ({changed / total:.3%}); "
            f"sr_adam launched {counts['sr_adam']} times in {STEPS} steps, "
            f"{_stepped_leaves(program.model)} tensors a step")
        if changed <= 0.05 * total:
            raise RuntimeError(f"{path}: SR updates did not land: "
                               f"{changed / total:.3%} of elements moved")
    size = MAIN["size"]
    if tuple(svbrdf.shape) != (MAIN["batch"], size, size, 12) \
            or svbrdf.dtype != torch.float32:
        raise RuntimeError(f"{path}: predict gave {svbrdf.dtype} of shape "
                           f"{tuple(svbrdf.shape)}")
    if not torch.isfinite(svbrdf).all():
        raise RuntimeError(f"{path}: predict gave non-finite maps")
    norm_err = float((svbrdf[..., :3].norm(dim=-1) - 1.0).abs().max())
    maps = svbrdf[..., 3:]
    if norm_err > 1e-4 or float(maps.min()) < 0.0 or float(maps.max()) > 1.0:
        raise RuntimeError(f"{path}: predicted maps out of range: normal "
                           f"norm err {norm_err:.3g}, maps in "
                           f"[{float(maps.min())}, {float(maps.max())}]")
    log(f"{path} predict: f32 {tuple(svbrdf.shape)}, {tuple(images.shape)} "
        f"input, unit normals (max err {norm_err:.3g}), maps in [0, 1]")
    return counts


def phase_target_grad(inputs) -> dict:
    """rendering_loss_fused_planes with want_target_grad under autograd at
    the paths' shapes, both inputs requiring grad: one launch of the kernel
    with both gradients, and pred.grad / gt.grad equal to upstream * dpred
    / dgt of that kernel."""
    from svbrdf_tpu_torch.ops import render_fused as rf
    from svbrdf_tpu_torch.scene import Scene

    p, g, s9 = inputs
    scenes = Scene(s9[..., 0:3], s9[..., 3:6], s9[..., 6:9])
    pred, gt = p.clone().requires_grad_(), g.clone().requires_grad_()
    upstream = 3.0
    torch.cuda.synchronize()
    _zero_counts()
    loss = rf.rendering_loss_fused_planes(pred, gt, scenes,
                                          want_target_grad=True)
    (upstream * loss).backward()
    torch.cuda.synchronize()
    counts = _counts()
    log(f"{TARGET_GRAD_PATH}: loss {float(loss.detach())!r}; launches "
        f"{counts}")
    _expect(counts, {"render_fwdgrad_both": 1}, TARGET_GRAD_PATH)
    # The comparison's own launch, after the counts are read.
    ref_loss, dpred, dgt = rf.rendering_loss_fwdgrad_both_cuda(p, g, s9)
    if not (torch.equal(loss.detach(), ref_loss)
            and torch.equal(pred.grad, upstream * dpred)
            and torch.equal(gt.grad, upstream * dgt)):
        raise RuntimeError(f"{TARGET_GRAD_PATH}: the gradients are not "
                           f"upstream * dpred / dgt")
    log(f"{TARGET_GRAD_PATH}: pred.grad and gt.grad equal {upstream} * "
        f"dpred / dgt")
    return counts


def phase_pathtrace_agreement() -> dict:
    """The path tracer on the card against the CPU on the same injected
    samples (B=2, S=9, 32^2, spp (4, 2)): the renders (render_mc) by the
    CPU tests' rule (bench_setup.hold_render: rel 1e-5, or where f32 is
    ill-conditioned against float64; the card's 3-term dot products sum
    in another order than the CPU's), the mixed path-traced loss at rel
    1e-5, its gradient for pred within 1e-4 of the CPU's (normwise) and as
    close to a float64 evaluation as the CPU's (2x, plus 1e-5); then, with
    a generator on the card, loss and gradient exactly 0 for pred equal to
    target."""
    from svbrdf_tpu_torch import losses
    from svbrdf_tpu_torch.ops import pathtrace as pt
    from svbrdf_tpu_torch.utils.bench_setup import (hold_render,
                                                    pathtrace_inputs,
                                                    render_conditioning)

    small = PATHTRACE_SMALL
    loss_fn = losses.make_loss_fn("mixed", "pathtracing")

    def run(device, cast=lambda x: x):
        pred, target, scenes, samples = pathtrace_inputs(
            small["batch"], small["size"], small["spp"], device=device)
        scenes = type(scenes)(*map(cast, (scenes.camera_pos,
                                          scenes.light_pos,
                                          scenes.light_color)))
        samples = pt.RenderSamples(*(pt.Samples(*map(cast, s))
                                     for s in samples))
        pred, target = cast(pred), cast(target)
        render = pt.render_mc(scenes, pred[:, None], samples)
        p = pred.clone().requires_grad_()
        loss = loss_fn(p, target, scenes=scenes, samples=samples)
        loss.backward()
        return (render.detach().double().cpu(), float(loss.detach()),
                p.grad.double().cpu())

    (rc, lc, gc), (rp, lp, gp) = run("cuda"), run("cpu")
    r64, _, g64 = run("cpu", lambda x: x.double())
    pred, _, scenes, samples = pathtrace_inputs(
        small["batch"], small["size"], small["spp"], device="cpu")
    cond = render_conditioning(scenes, pred[:, None], samples)
    out = {"render": hold_render(rc, rp, r64, cond),
           "loss_rel": abs(lc - lp) / abs(lp),
           "grad_rel": float((gc - gp).norm() / gp.norm()),
           "grad_rel_float64": float((gc - g64).norm() / g64.norm()),
           "cpu_grad_rel_float64": float((gp - g64).norm() / g64.norm())}
    target = pathtrace_inputs(small["batch"], small["size"],
                              small["spp"], device="cuda")[1]
    p = target.clone().requires_grad_()
    zero = loss_fn(p, target, torch.Generator(device="cuda").manual_seed(1))
    zero.backward()
    out["zero_loss"] = float(zero.detach())
    out["zero_grad_nonzero"] = int(torch.count_nonzero(p.grad))
    log(f"agreement path tracer (B={small['batch']}, S=9, "
        f"{small['size']}^2, spp {small['spp']}): loss card {lc!r} cpu "
        f"{lp!r}; {out}")
    if out["loss_rel"] > 1e-5:
        raise RuntimeError("path-traced loss: card and CPU disagree beyond "
                           "rel 1e-5")
    if out["grad_rel"] > 1e-4 or out["grad_rel_float64"] > (
            2 * out["cpu_grad_rel_float64"] + 1e-5):
        raise RuntimeError("path-traced loss gradient: card and CPU "
                           "disagree")
    if out["zero_loss"] != 0.0 or out["zero_grad_nonzero"]:
        raise RuntimeError("path-traced loss or gradient not 0 for pred "
                           "equal to target")
    return out


def phase_pathtrace_path() -> dict:
    """Each full-width path-traced path (bf16-SR at TF32 as torch sets it,
    f32 with TF32 off): 5 train steps, 1 eval step and predict with every
    launch counter read (the loss kernels 0, the path tracer's kernels as
    TRACED_PATHS says, sr_adam one a bf16-SR step), the peak device memory
    of that run, the steps' times and the loss's share of a train step
    (utils/profile_step.phase_times: loss forward + its gradient for the
    maps, against the whole step)."""
    from svbrdf_tpu_torch.utils.bench_setup import build_program
    from svbrdf_tpu_torch.utils.profile_step import phase_times

    out = {}
    for path, (kinds, dtype, master, _) in TRACED_PATHS.items():
        with (_tf32(True, False) if dtype == BF16
              else contextlib.nullcontext()):
            program = build_program(*kinds, MAIN["batch"], MAIN["size"],
                                    MAIN["depth"], MAIN["num_filters"],
                                    seed=0, device="cuda", dtype=dtype,
                                    master_dtype=master,
                                    renderer="pathtracing")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            counts = phase_path(path, program)
            peak = torch.cuda.max_memory_allocated()
            times = step_times(path, program)
            phases = phase_times(program, 5)
        loss_ms = phases["loss"] + phases["loss_backward"]
        out[path] = {"launches": counts, "max_memory_allocated": peak,
                     "steps_ms": times, "phases_ms": phases,
                     "loss_ms": loss_ms,
                     "loss_share": loss_ms / sum(phases.values())}
        log(f"{path}: peak device memory {peak} bytes; phases (CUDA "
            f"events, median of 5) {phases}; loss forward + its gradient "
            f"{loss_ms:.2f} ms, {out[path]['loss_share']:.1%} of the train "
            f"step")
        del program
        torch.cuda.empty_cache()
    return out


def phase_pathtrace_kernels(rates: dict, build_log: str) -> dict:
    """Each path tracer kernel against its plain version on the card
    (bench_setup.PATHTRACE_CASES, hold_pathtrace_kernels); the path-traced
    mixed loss and its gradient exactly 0 for pred equal to target at full
    width (f32 and bf16 maps, the kernels' launches); then at full width
    each kernel's time (median of 20, CUDA events) and its plain
    version's, for an f32 and a bf16 SVBRDF, its bound, registers and
    blocks per SM."""
    from svbrdf_tpu_torch import losses
    from svbrdf_tpu_torch.ops import pathtrace as pt
    from svbrdf_tpu_torch.utils import bench_setup
    from svbrdf_tpu_torch.utils.bench_setup import (hold_pathtrace_kernels,
                                                    pathtrace_case,
                                                    pathtrace_inputs)
    from svbrdf_tpu_torch.utils.compare_builds import ptxas_lines

    checks = {}
    for label, (batch, height, width, spp, dtype, scene_grads) in \
            bench_setup.PATHTRACE_CASES.items():
        case = pathtrace_case(batch, height, width, spp, dtype=dtype)
        checks[label] = hold_pathtrace_kernels(case, scene_grads)
        torch.cuda.synchronize()
        log(f"pathtrace kernels, {label} (B={batch}, S=9, {height}x{width}, "
            f"spp {spp}, {dtype}, scene gradients {scene_grads}): "
            f"{json.dumps(checks[label])}")
        del case
        torch.cuda.empty_cache()

    zero = {}
    loss_fn = losses.make_loss_fn("mixed", "pathtracing")
    for dtype in (torch.float32, BF16):
        target = pathtrace_inputs(MAIN["batch"], MAIN["size"],
                                  device="cuda")[1].to(dtype)
        pred = target.clone().requires_grad_()
        _zero_counts()
        loss = loss_fn(pred, target,
                       torch.Generator(device="cuda").manual_seed(1))
        loss.backward()
        torch.cuda.synchronize()
        zero[str(dtype)] = {"loss": float(loss.detach()),
                            "grad_nonzero": int(torch.count_nonzero(
                                pred.grad)),
                            "launches": _nonzero(_counts())}
        if zero[str(dtype)]["loss"] != 0.0 or zero[str(dtype)][
                "grad_nonzero"]:
            raise RuntimeError(f"path-traced loss or gradient not 0 for "
                               f"pred equal to target: {zero}")
    log(f"pathtrace kernels, pred = target at full width: {zero}")

    # ptxas's registers and spills of each instance, by kernel: its f32 and
    # bf16 SVBRDF instances (the VJP's with scene gradients as _scene).
    registers = {name: {k: v for k, v in ptxas_lines(build_log).items()
                        if k == name or k.startswith(name + "_")
                        and "vjp" not in k[len(name):]}
                 for name in PATHTRACE_KERNELS}
    code = pathtrace_code(build_log)
    batch, size, n_scenes, spp = MAIN["batch"], MAIN["size"], 9, (16, 8)
    times = {}
    for dtype, suffix in ((torch.float32, ""), (BF16, "_bf16")):
        case = pathtrace_case(batch, size, size, spp, dtype=dtype)
        flat, flat_bwd, d = case["flat"], case["flat_bwd"], case["d_sample"]
        calls = {"pathtrace_shade": (pt.shade_cuda, pt.shade_plain, flat,
                                     spp[0]),
                 "pathtrace_shade_vjp": (pt.shade_vjp_cuda,
                                         pt.shade_vjp_plain,
                                         (*flat_bwd, d), spp[1])}
        for name, (kernel, plain, args, n) in calls.items():
            ms = cuda_ms(lambda: kernel(*args))
            plain_ms = cuda_ms(lambda: plain(*args))
            bound_ms, bound_by, parts = pathtrace_bound(
                name, batch, n_scenes, size, size, n, rates,
                2 if dtype == BF16 else 4)
            per_sm = pt.blocks_per_sm(name, dtype, n_scenes, n)
            times[name + suffix] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "bound_parts_us": parts,
                "bound_share": bound_ms / ms, "blocks_per_sm": per_sm}
            log(f"{name}{suffix}: kernel {ms:.4f} ms, plain {plain_ms:.2f} "
                f"ms, bound {bound_ms:.4f} ms ({bound_by}, "
                + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
                + f"), {bound_ms / ms:.1%} of it; {per_sm} blocks per SM; "
                f"registers {registers[name]}")
        del case, calls
        torch.cuda.empty_cache()
    return {"checks": checks, "zero": zero, "times": times,
            "registers": registers, "code": code}


def pathtrace_code(build_log: str) -> dict:
    """Each path tracer instance's registers and spill bytes (ptxas, from
    phase 2's log; none where the library was built before this run) beside
    its static FP64 instructions and local loads and stores
    (compare_builds.pathtrace_library_code on the built library), printed a
    line each."""
    from svbrdf_tpu_torch.ops import _build
    from svbrdf_tpu_torch.utils import compare_builds

    built = compare_builds.pathtrace_library_code(
        _build.library_path("pathtrace"), build_log)
    code = {}
    for instance, c in built.items():
        if c["sass"] is None:
            raise RuntimeError(f"pathtrace: no {instance} in the SASS")
        classes = c["classes"]
        code[instance] = {**(c["ptxas"] or {}), "fp64": classes["fp64"],
                          "ldl_stl": classes["local"],
                          "sass_total": classes["total"]}
        c = code[instance]
        log(f"{instance} code: {c.get('registers')} registers, spill "
            f"stores {c.get('spill_stores')} B, loads {c.get('spill_loads')}"
            f" B; {c['fp64']} FP64 and {c['ldl_stl']} LDL/STL of "
            f"{c['sass_total']} SASS instructions")
    return code


def phase_stability() -> dict:
    """utils/pathtrace_stability.run for STABILITY_STEPS steps at full
    width, the CLI's default precision: every loss and Adam second moment
    finite."""
    from svbrdf_tpu_torch.parallel.step import master_dtype_scope
    from svbrdf_tpu_torch.utils import pathtrace_stability

    with _tf32(True, False), master_dtype_scope():
        record = pathtrace_stability.run(steps=STABILITY_STEPS)
    log(f"pathtrace stability: {json.dumps(record)}")
    if not (record["all_finite"] and record["adam_nu_finite"]):
        raise RuntimeError("pathtrace stability: a non-finite loss or Adam "
                           "second moment")
    torch.cuda.empty_cache()
    return record


BF16_PATHS = {
    "bf16_mixed": ("mixed_loss_fused_planes", {}, "mixed_fwdgrad"),
    "bf16_rendering_target_grad": ("rendering_loss_fused_planes",
                                   {"want_target_grad": True},
                                   "render_fwdgrad_both"),
}


def phase_bf16_calls(inputs) -> dict:
    """One call each through the planes entries on bf16 planes under
    autograd (the mixed loss; the rendering loss with the target's
    gradient), both inputs requiring grad, every launch counter set to 0
    just before and read just after: one launch of the value+gradient
    kernel and none of any other; each .grad is bf16 and equals that
    kernel's gradient times the upstream scalar in f32, rounded once."""
    from svbrdf_tpu_torch.ops import render_fused as rf
    from svbrdf_tpu_torch.scene import Scene

    p, g, s9 = inputs
    scenes = Scene(s9[..., 0:3], s9[..., 3:6], s9[..., 6:9])
    upstream = 3.1  # not a bf16 value
    counts = {}
    for path, (entry, kw, kernel) in BF16_PATHS.items():
        pred, gt = p.clone().requires_grad_(), g.clone().requires_grad_()
        torch.cuda.synchronize()
        _zero_counts()
        loss = getattr(rf, entry)(pred, gt, scenes, **kw)
        (upstream * loss).backward()
        torch.cuda.synchronize()
        counts[path] = _counts()
        log(f"{path}: loss {float(loss.detach())!r}; launches {counts[path]}")
        _expect(counts[path], {kernel + "_bf16": 1}, path)
        # The comparison's own launch, after the counts are read.
        ref_loss, *grads = rf.CUDA_WRAPPERS[kernel](p, g, s9)
        # Without the target's gradient the target is detached.
        have = [pred.grad, gt.grad] if len(grads) == 2 else [pred.grad]
        ok = torch.equal(loss.detach(), ref_loss) and (
            len(grads) == 2 or gt.grad is None)
        for grad, d in zip(have, grads):
            ok = ok and grad.dtype == torch.bfloat16 and torch.equal(
                grad, (d.float() * upstream).to(torch.bfloat16))
        if not ok:
            raise RuntimeError(f"{path}: the gradients are not the kernel's "
                               f"times {upstream}, rounded once to bf16")
        log(f"{path}: .grad bf16, equal to (d.float() * {upstream})"
            f".to(bf16)")
    return counts


def kernel_times(inputs, inputs_bf16, rates: dict) -> dict:
    """Each kernel launched alone and through its wrapper, its plain
    version, and its bound at these inputs; and its bf16 instantiation
    launched alone on the same planes in bf16, with that call's bound."""
    from svbrdf_tpu_torch.ops import render_fused as rf
    from svbrdf_tpu_torch.utils.bench_setup import kernel_ms

    batch, _, height, width = inputs[0].shape
    n_scenes = inputs[2].shape[1]
    out = {}
    for name, plain in rf.PLAIN_VERSIONS.items():
        wrapper = rf.CUDA_WRAPPERS[name]
        ms = kernel_ms(name, inputs)
        wrapper_ms = cuda_ms(lambda: wrapper(*inputs))
        plain_ms = cuda_ms(lambda: plain(*inputs))
        bound_ms, bound_by, parts = bound(name, batch, height, width,
                                          n_scenes, rates)
        per_sm = rf.blocks_per_sm(name, n_scenes)
        bf16_ms = kernel_ms(name, inputs_bf16)
        bf16_bound, bf16_by, bf16_parts = bound(name, batch, height, width,
                                                n_scenes, rates, 2)
        bf16_per_sm = rf.blocks_per_sm(name, n_scenes, torch.bfloat16)
        out[name] = {"ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "bound_parts_us": parts, "blocks_per_sm": per_sm,
                     "bf16_ms": bf16_ms, "bf16_bound_ms": bf16_bound,
                     "bf16_bound_by": bf16_by, "bf16_bound_parts_us": bf16_parts,
                     "bf16_blocks_per_sm": bf16_per_sm}
        log(f"{name}: kernel {ms:.4f} ms (wrapper {wrapper_ms:.4f} ms), "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
            + ", ".join(f"{k} {v:.2f}" for k, v in parts.items())
            + f"), {per_sm} blocks per SM; bf16 kernel {bf16_ms:.4f} ms, "
            f"bound {bf16_bound:.4f} ms ({bf16_by}, bytes "
            f"{bf16_parts['bytes_us']:.2f} us), {bf16_per_sm} blocks per SM")
    return out


def step_times(path: str, program, predict: bool = True) -> dict:
    from svbrdf_tpu_torch.parallel.step import prepare

    images = prepare(program.raw, program.prep, program.generator)["inputs"]
    steps = {"train_step": lambda: program.train_step(program.raw),
             "eval_step": lambda: program.eval_step(program.raw)}
    if predict:
        steps["predict"] = lambda: program.predict(images)
    out = {k: cuda_ms(fn, runs=20, warmup=2) for k, fn in steps.items()}
    log(f"{path} ms (median of 20, CUDA events): {out}")
    return out


# The precision modes timed side by side (phase 6): compute dtype, master
# policy, TF32 (cudnn, matmul); the paths each applies to. f32 and bf16-SR
# are phase 5's programs; TF32 is a measured line, not a mode of the CLI.
MODES = {"f32": (F32, None, (False, False), ("single_mixed",
                                             "multi_rendering")),
         "tf32": (F32, None, (True, True), ("single_mixed",)),
         "bf16_f32_masters": (BF16, "f32", (True, False),
                              ("single_mixed", "multi_rendering")),
         "bf16_bf16sr": (BF16, "bf16sr", (True, False),
                         ("single_mixed", "multi_rendering"))}


def mode_times() -> dict:
    """Train and eval steps of the modes that phase 5 does not run (TF32,
    bf16 with f32 masters), one program each at full width."""
    from svbrdf_tpu_torch.utils.bench_setup import build_program

    out = {}
    for mode in ("tf32", "bf16_f32_masters"):
        dtype, master, tf32, paths = MODES[mode]
        for path in paths:
            kinds = PATHS[path][0]
            with _tf32(*tf32):
                program = build_program(*kinds, MAIN["batch"], MAIN["size"],
                                        MAIN["depth"], MAIN["num_filters"],
                                        seed=0, device="cuda", dtype=dtype,
                                        master_dtype=master)
                out[f"{path}_{mode}"] = step_times(
                    f"{path} [{mode}]", program, predict=False)
            del program
            torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _plain_optimizer_updates():
    """AdamBf16SR's leaves updated by the plain version (on the card)."""
    from svbrdf_tpu_torch.parallel import optimizer as opt

    saved = opt.update_leaves
    opt.update_leaves = lambda leaves, s, plans=None: \
        opt.sr_adam_multi_plain(leaves, s)
    try:
        yield
    finally:
        opt.update_leaves = saved


def sr_adam_code(build_log: str) -> dict:
    """The SR-Adam kernel's registers (ptxas, from phase 2's log; None
    where the library was built before this run), SASS total, blocks per
    SM by its registers and, per vector loop (compare_builds.SR_ADAM_LOOPS),
    its static SASS instructions per element (cuobjdump -sass of the built
    library: compare_builds.sr_adam_code); the 'bf16' state mode's kernel
    under "bf16mu"."""
    from svbrdf_tpu_torch.ops import _build
    from svbrdf_tpu_torch.utils import compare_builds

    sass = compare_builds.sass_text(_build.library_path("sr_adam"))
    code = compare_builds.sr_adam_code(sass, build_log)
    if set(code) != {"sr_adam", "sr_adam_bf16mu"}:
        raise RuntimeError(f"sr_adam: kernels {sorted(code)} in the SASS")
    out = dict(code["sr_adam"], bf16mu=code["sr_adam_bf16mu"])
    for kind in compare_builds.SR_ADAM_LOOPS:
        if kind not in out["loops"]:
            raise RuntimeError(f"sr_adam: no {kind} vector loop in the SASS")
    log(f"sr_adam code: {out['registers']} registers, "
        f"{out['sass_total']} SASS instructions, "
        f"{out.get('blocks_per_sm')} blocks per SM; vector loops "
        + ", ".join(f"{k} {v['instructions']} instructions / 8 elements "
                    f"= {v['per_element']:.2f} a element"
                    for k, v in out["loops"].items())
        + f"; the 'bf16' state mode's kernel: {out['bf16mu']['registers']} "
        f"registers, {out['bf16mu']['sass_total']} SASS instructions")
    return out


def optimizer_times(program, rates: dict, code: dict) -> dict:
    """The whole optimizer step of a bf16-SR program, on the gradients of
    its last train step: sr_adam's device time and launches a step
    (torch.profiler and the launch counter over 5 steps), the step's wall
    time between CUDA events, the plain version's step, and the bound: each
    tensor read or written once (g, p, mu, nu in; p, mu, nu out) over the
    memory rate, or SR_ADAM_FP32_PER_ELEMENT over the FP32 rate; beside
    it, the issue time of the vector loops' instructions (`code`,
    sr_adam_code) for the step's bf16 and f32 leaves."""
    from torch.profiler import ProfilerActivity, profile

    from svbrdf_tpu_torch.ops import sr_adam

    optimizer = program.train_step.optimizer
    leaves = [(p, optimizer.state[p]) for p in program.model.parameters()
              if p.grad is not None]
    nbytes = sum(p.numel() * (p.grad.element_size() + 2 * (
        p.element_size() + st["exp_avg"].element_size()
        + st["exp_avg_sq"].element_size())) for p, st in leaves)
    elements = sum(p.numel() for p, _ in leaves)
    t_bytes = nbytes / rates["bytes"]
    t_ops = elements * SR_ADAM_FP32_PER_ELEMENT / rates["fp32"]
    # Warp instructions: a thread's loop pass covers 8 elements, 32
    # threads a warp.
    warp_instructions = sum(
        p.numel() * code["loops"]["bf16" if p.dtype == BF16 else "f32"][
            "per_element"] / 32 for p, _ in leaves)
    t_issue = warp_instructions / rates["issue"]
    salt = [0]

    def step():
        salt[0] += 1
        optimizer.step(master_salt=salt[0])

    wall_ms = cuda_ms(step)
    torch.cuda.synchronize()
    before = sr_adam.sr_adam_multi_cuda.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            step()
        torch.cuda.synchronize()
    launches = (sr_adam.sr_adam_multi_cuda.launches - before) / 5
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if "sr_adam_kernel" in e.key) / 1e3 / 5
    with _plain_optimizer_updates():
        plain_ms = cuda_ms(step, runs=5, warmup=1)
    out = {"ms": device_ms, "wall_ms": wall_ms, "plain_ms": plain_ms,
           "launches_per_step": launches,
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bound_parts_us": {"bytes_us": t_bytes * 1e6,
                              "fp32_us": t_ops * 1e6},
           "issue_us": t_issue * 1e6, "tensors": len(leaves),
           "elements": elements, "bytes": nbytes, "code": code}
    log(f"sr_adam optimizer step ({len(leaves)} tensors, {elements} "
        f"elements, {nbytes} bytes): device {device_ms:.4f} ms "
        f"(torch.profiler, {launches:g} launch(es) a step), wall "
        f"{wall_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{out['bound_ms']:.4f} ms ({out['bound_by']}; the device time "
        f"{device_ms / out['bound_ms']:.2f}x it), vector loops' issue "
        f"{t_issue * 1e3:.4f} ms")
    return out


def _cli_dataset(root: pathlib.Path) -> pathlib.Path:
    """The four map tiles of each training strip as a 1024 x 256 strip,
    written with the port's writer, and symlinks to them up to
    CLI["samples"] files."""
    from svbrdf_tpu_torch.data import png, strips

    data = root / "maps"
    data.mkdir()
    for n, name in enumerate(("toy_train_00.png", "toy_train_01.png")):
        strip = strips.read_image_u8(str(REPO / "data" / "train" / name))
        png.write_png_rgb8(str(data / f"maps_{n}.png"), strip[:, 10 * 256:])
    for n in range(2, CLI["samples"]):
        (data / f"link_{n:03d}.png").symlink_to(data / f"maps_{n % 2}.png")
    return data


def _host_ms(fn, reps: int = 5) -> float:
    """Median host wall time of fn() in ms."""
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def _cli(name: str, argv: list, entry=None):
    """main(argv) (or entry(argv)) with every launch counter set to 0 just
    before and read just after: (result, printout, counts)."""
    from svbrdf_tpu_torch.main import main as cli_main

    torch.cuda.synchronize()
    _zero_counts()
    start = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = (entry or cli_main)(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    counts = _counts()
    lines = [line for line in out.getvalue().splitlines()
             if any(key in line for key in CLI_ECHO)]
    log(f"cli {name} ({seconds:.1f} s): " + " | ".join(lines))
    log(f"cli {name} launches {counts}")
    return result, out.getvalue(), counts


def _cli_train(name, argv, kernels, steps, validation_batches,
               sr_adam=False):
    """A training run: its launches must be the loop's train steps
    (kernels[0]) and validation batches (kernels[1]), with `sr_adam` one
    sr_adam launch per step, the block tails' as _tail_launches gives them
    for the steps, the validation batches and the held-out samples'
    grids, 0 elsewhere."""
    run, out, counts = _cli(name, argv)
    if (run.steps, run.validation_batches) != (steps, validation_batches):
        raise RuntimeError(f"cli {name}: {run.steps} steps and "
                           f"{run.validation_batches} validation batches, "
                           f"expected {steps} and {validation_batches}")
    kind = (argv[argv.index("--model-type") + 1] if "--model-type" in argv
            else "single")
    expected = {kernels[0]: run.steps, kernels[1]: run.validation_batches,
                **_tail_launches(kind, run.steps,
                                 run.validation_batches + _grids(out))}
    if sr_adam:
        expected["sr_adam"] = run.steps * _sr_adam_launches(run.model)
    _expect(counts, expected, f"cli {name}")
    if not math.isfinite(run.last_loss):
        raise RuntimeError(f"cli {name}: last loss {run.last_loss}")
    return run, out, counts


def _adam_steps(model_dir: pathlib.Path) -> int:
    blob = torch.load(model_dir / "checkpoint.tar", map_location="cpu",
                      weights_only=True)
    return int(blob["optimizer_state_dict"]["state"][0]["step"])


def _cli_default_runs(root, train, per_epoch) -> dict:
    """Single view, mixed loss at the CLI's defaults (--dtype auto: bf16 on
    the card, bf16-SR masters) with TF32 as torch sets it, as a user runs
    it: 2 epochs, then resumed to 3. The resume restores the policy from
    the checkpoint, which holds f32 weights; a fresh bf16-SR model reloaded
    from it predicts the trained model's bits."""
    from svbrdf_tpu_torch.models import build_model
    from svbrdf_tpu_torch.parallel import step as step_lib
    from svbrdf_tpu_torch.training.checkpoint import Checkpoint

    kernels = ("mixed_fwdgrad_bf16", "mixed_fwd_bf16")
    mixed = ["--used-image-count", "1", "--loss", "mixed"]
    model_dir = root / "default"
    runs = {}
    with _tf32(True, False):
        runs["single_mixed_default"] = _cli_train(
            "single_mixed_default", train("default", *mixed, "--epochs", "2",
                                          "--retrain"),
            kernels, 2 * per_epoch, 2, sr_adam=True)
        runs["single_mixed_default_resume"] = _cli_train(
            "single_mixed_default_resume",
            train("default", *mixed, "--epochs", "3"), kernels,
            2 * per_epoch, 2, sr_adam=True)
    resumed, out, _ = runs["single_mixed_default_resume"]
    if ("Restored master_dtype 'bf16sr'" not in out
            or "Training from epoch 1 to 3" not in out):
        raise RuntimeError("cli default: the resume did not restore "
                           "master_dtype 'bf16sr' and continue from epoch 1")
    if _adam_steps(model_dir) != 4 * per_epoch:
        raise RuntimeError("cli default: after the resume the Adam step is "
                           "not the steps taken in both runs")
    blob = torch.load(model_dir / "checkpoint.tar", map_location="cpu",
                      weights_only=True)
    dtypes = {v.dtype for v in blob["model_state_dict"].values()}
    if dtypes != {torch.float32} or blob.get("master_dtype") != "bf16sr":
        raise RuntimeError(f"cli default: checkpoint weights {dtypes}, "
                           f"master_dtype {blob.get('master_dtype')!r}")
    for p in resumed.model.parameters():
        if p.dtype != (BF16 if p.dim() >= 2 else torch.float32):
            raise RuntimeError(f"cli default: a {p.dim()}-D master is "
                               f"{p.dtype}")
    device = next(resumed.model.parameters()).device
    fresh = build_model("single", False, CLI["depth"], CLI["num_filters"],
                        device=device, seed=1, dtype=BF16)
    with contextlib.redirect_stdout(io.StringIO()):
        Checkpoint.load(model_dir).restore_params(fresh)
    with step_lib.master_dtype_scope():
        step_lib.set_master_dtype_policy("bf16sr")
        step_lib.master_cast(fresh)
    images = torch.rand(2, 1, CLI["size"], CLI["size"], 3, device=device)
    with _tf32(True, False):
        same = torch.equal(step_lib.make_predict_fn(fresh)(images),
                           step_lib.make_predict_fn(resumed.model)(images))
    if not same:
        raise RuntimeError("cli default: the reloaded bf16-SR model "
                           "predicts otherwise than the trained one")
    log(f"cli single_mixed_default: resumed with master_dtype 'bf16sr'; "
        f"checkpoint weights f32; a fresh bf16-SR model reloaded from it "
        f"predicts the same bits")
    del fresh
    shutil.rmtree(model_dir)
    return runs


def _cli_pathtracing(train, per_epoch, path=TRACED_PATH):
    """--renderer pathtracing for 1 epoch, at the CLI's defaults (bf16,
    bf16-SR masters; TRACED_PATH) or with --dtype float32 (TF32 off;
    TRACED_PATH_F32): the loss kernels never launch, the path tracer's
    kernels as on the path (TRACED_PATHS) a step and a validation batch,
    sr_adam once a bf16-SR step."""
    f32 = path == TRACED_PATH_F32
    with _tf32(True, False):
        run, out, counts = _cli(path, train(
            path, "--used-image-count", "1", "--loss", "mixed",
            "--renderer", "pathtracing", "--epochs", "1", "--retrain",
            *(("--dtype", "float32") if f32 else ())))
    if (run.steps, run.validation_batches) != (per_epoch, 1):
        raise RuntimeError(f"cli {path}: {run.steps} steps and "
                           f"{run.validation_batches} validation batches")
    if "Using renderer 'pathtracing'" not in out:
        raise RuntimeError(f"cli {path}: not the path tracer")
    per_step, per_batch = TRACED_PATHS[path][3]
    expected = {k: run.steps * per_step.get(k, 0)
                + run.validation_batches * per_batch.get(k, 0)
                for k in {**per_step, **per_batch}}
    expected.update(_tail_launches("single", run.steps,
                                   run.validation_batches + _grids(out)))
    if not f32:
        expected["sr_adam"] = run.steps * _sr_adam_launches(run.model)
    _expect(counts, expected, f"cli {path}")
    if not math.isfinite(run.last_loss):
        raise RuntimeError(f"cli {path}: last loss {run.last_loss}")
    return run, out, counts


def phase_cli(build_program_ms: dict) -> dict:
    """The CLI runs of phase 7; returns their numbers and launches."""
    from svbrdf_tpu_torch.data import strips
    from svbrdf_tpu_torch.data.prefetch import PrefetchPool
    from svbrdf_tpu_torch.models import build_model
    from svbrdf_tpu_torch.parallel.step import make_predict_fn
    from svbrdf_tpu_torch.training.checkpoint import Checkpoint
    from svbrdf_tpu_torch.training.tensorboard import read_scalars

    per_epoch = math.ceil(math.ceil(CLI["samples"] * 0.99) / CLI["batch"])
    width = ["--image-size", str(CLI["size"]), "--model-depth",
             str(CLI["depth"]), "--num-filters", str(CLI["num_filters"]),
             "--batch-size", str(CLI["batch"]), "--gpu-id", "0",
             "--num-devices", "1"]
    out = {"runs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        data = _cli_dataset(root)
        out["decode_ms"] = {
            "repo strip 3584x256, Paeth rows": _host_ms(
                lambda: strips.read_image_u8(
                    str(REPO / "data" / "train" / "toy_train_00.png"))),
            "written strip 1024x256, filter 0 rows": _host_ms(
                lambda: strips.read_image_u8(str(data / "maps_0.png")))}
        log(f"cli decode ms per strip (host, median of 5): "
            f"{out['decode_ms']}")
        # A fresh decode pool's first strip: its spawned workers start (and
        # import this script as their main module) before they decode.
        start = time.perf_counter()
        with PrefetchPool([str(data / "maps_0.png")], 2) as pool:
            pool.request(0)
            pool.take(0)
            out["pool_first_take_ms"] = (time.perf_counter() - start) * 1e3
        log(f"cli decode pool: a fresh pool's first strip after "
            f"{out['pool_first_take_ms']:.1f} ms")

        def train(model_dir, *extra):
            return (["--mode", "train", "--input-dir", str(data),
                     "--image-count", "0", "--save-frequency", "1",
                     "--validation-frequency", "1", "--model-dir",
                     str(root / model_dir)] + width + list(extra))

        single = ("mixed_fwdgrad", "mixed_fwd")
        multi = ("render_fwdgrad", "render_fwd")
        # The f32 runs say so: the CLI's default on the card is bf16.
        mixed = ["--used-image-count", "1", "--loss", "mixed", "--dtype",
                 "float32"]
        render = ["--model-type", "multi", "--used-image-count", "3",
                  "--loss", "render", "--dtype", "float32"]
        model_dir = root / "single"
        runs = {}
        runs["single_mixed"] = _cli_train(
            "single_mixed", train("single", *mixed, "--epochs", "2",
                                  "--retrain"),
            single, 2 * per_epoch, 2)
        first = runs["single_mixed"][0]
        if _adam_steps(model_dir) != first.steps:
            raise RuntimeError("cli: the checkpoint's Adam step is not the "
                               "steps taken")
        scalars = read_scalars(str(model_dir / "logs"))
        losses = [v for _, v in scalars["loss"]]
        if (len(losses) != first.steps or not all(map(math.isfinite, losses))
                or len(scalars["val_loss"]) != 2):
            raise RuntimeError(f"cli: logs hold {len(losses)} losses and "
                               f"{len(scalars['val_loss'])} val_loss")
        device = next(first.model.parameters()).device
        fresh = build_model("single", False, CLI["depth"],
                            CLI["num_filters"], device=device, seed=1)
        with contextlib.redirect_stdout(io.StringIO()):
            Checkpoint.load(model_dir).restore_params(fresh)
        images = torch.rand(2, 1, CLI["size"], CLI["size"], 3,
                            device=device)
        if not torch.equal(make_predict_fn(fresh)(images),
                           make_predict_fn(first.model)(images)):
            raise RuntimeError("cli: the reloaded checkpoint predicts "
                               "otherwise than the trained model")
        log(f"cli single_mixed: checkpoint.tar reloads strictly, predict "
            f"equal; Adam step {first.steps}; logs {len(losses)} finite "
            f"losses, 2 val_loss")
        ckpt_dir = root / "save_timing"
        ckpt_ms = _host_ms(lambda: Checkpoint.save(
            ckpt_dir, first.model, first.optimizer, 1, "single", False,
            model_depth=CLI["depth"], num_filters=CLI["num_filters"]),
            reps=3)
        out["checkpoint"] = {
            "save_ms": ckpt_ms,
            "bytes": (ckpt_dir / "checkpoint.tar").stat().st_size}
        shutil.rmtree(ckpt_dir)
        log(f"cli checkpoint: save {ckpt_ms:.1f} ms (median of 3), "
            f"{out['checkpoint']['bytes']} bytes")
        del fresh

        runs["single_mixed_resume"] = _cli_train(
            "single_mixed_resume", train("single", *mixed, "--epochs", "3"),
            single, 2 * per_epoch, 2)
        resumed = runs["single_mixed_resume"][1]
        if ("Restored epoch 1" not in resumed
                or "Training from epoch 1 to 3" not in resumed):
            raise RuntimeError("cli: the resumed run did not continue from "
                               "epoch 1")
        if _adam_steps(model_dir) != 4 * per_epoch:
            raise RuntimeError("cli: after the resume the Adam step is not "
                               "the steps taken in both runs")
        written, _, counts = _cli("single_mixed_test", [
            "--mode", "test", "--input-dir", str(REPO / "data" / "test"),
            "--image-count", "10", "--model-dir", str(model_dir),
            "--dtype", "float32"] + width)
        # A forward a sample.
        _expect(counts, _tail_launches("single", 0, len(written)),
                "cli single_mixed_test")
        grid = strips.read_image_u8(written[0])
        summary = json.loads((model_dir / "test_outputs" /
                              "metrics.json").read_text())
        bad = [k for k in METRIC_KEYS
               if not math.isfinite(summary["mean"].get(k, math.nan))]
        if grid.shape != (2 * CLI["size"], 5 * CLI["size"], 3) or bad:
            raise RuntimeError(f"cli test: grid {grid.shape}, metrics "
                               f"missing or not finite: {bad}")
        log(f"cli single_mixed_test: grid {grid.shape}, metrics.json "
            f"{summary['mean']}")
        runs["single_mixed_test"] = (None, None, counts)

        for name, kind, args in (
                ("single_mixed_cache", single, mixed + [
                    "--device-data-cache"]),
                ("multi_rendering_cache", multi, render + [
                    "--device-data-cache"]),
                ("multi_rendering", multi, render)):
            # The host path runs 2 epochs: the first decodes the strips.
            epochs = 1 if "--device-data-cache" in args else 2
            runs[name] = _cli_train(
                name, train(name, *args, "--epochs", str(epochs),
                            "--retrain"),
                kind, epochs * per_epoch, epochs)
            shutil.rmtree(root / name)  # a checkpoint is ~1 GB at full width

        runs.update(_cli_default_runs(root, train, per_epoch))
        for path in TRACED_PATHS:
            runs[path] = _cli_pathtracing(train, per_epoch, path)
            shutil.rmtree(root / path)

    for name, (run, _, counts) in runs.items():
        entry = {"launches": counts}
        if run is not None:
            path = (name if name in TRACED_PATHS
                    else "single_mixed_bf16" if "default" in name
                    else "single_mixed" if name.startswith("single")
                    else "multi_rendering")
            base = build_program_ms[path]["train_step"]
            # Every step is timed (--log-every 1); the first is the
            # timer's warm-up. An epoch's first pass over the strips
            # decodes them, later epochs read the dataset's caches.
            times = run.timer.steady_times() * 1e3
            epochs = [times[max(0, e * per_epoch - 1):(e + 1) * per_epoch - 1]
                      for e in range(run.steps // per_epoch)]
            epoch_ms = [statistics.median(t) for t in epochs]
            # One validation pass per epoch: its batches' decode, copy and
            # eval steps (the value-only kernel), host clock with syncs.
            validation_ms = [float(t) for t in
                             run.validation_timer.steady_times() * 1e3]
            entry.update(steps=run.steps,
                         validation_batches=run.validation_batches,
                         step_ms_median=run.timer.median_ms(),
                         step_ms_mean=run.timer.mean_ms(),
                         epoch_step_ms_medians=epoch_ms,
                         validation_pass_ms=validation_ms,
                         build_program_train_step_ms=base)
            log(f"cli {name}: {run.timer.summary()}; median per epoch "
                + ", ".join(f"{t:.2f}" for t in epoch_ms)
                + f" ms; build_program train step {base:.2f} ms, CLI / "
                f"build_program " + ", ".join(f"{t / base:.3f}"
                                              for t in epoch_ms)
                + "; validation pass per epoch "
                + ", ".join(f"{t:.2f}" for t in validation_ms) + " ms")
            if len(epoch_ms) > 1 and "cache" not in name:
                # Epoch 0 decodes the strips through the dataset's decode
                # pool; epoch 1 reads its caches.
                entry["pool_epoch0_minus_epoch1_ms"] = (epoch_ms[0]
                                                        - epoch_ms[1])
                log(f"cli {name} decode pool: epoch 0 median "
                    f"{epoch_ms[0]:.2f} ms, epoch 1 {epoch_ms[1]:.2f} ms, "
                    f"epoch 0 - epoch 1 {epoch_ms[0] - epoch_ms[1]:.2f} ms")
        out["runs"][name] = entry
    return out


# The data-parallel phase: the global batch of the main path, 5 steps a run
# of world size 2, and the spawned ranks' time limit (s).
DP = {"steps": 5, "timeout": 600}
# World 2 against world 1 (f32, TF32 off, dropout off) at full width: the
# first step's loss rel (the CPU tests' 1e-5; the same weights and draws),
# every step's, and the update theta_5 - theta_0 normwise. After the first
# step the weights differ: cuDNN takes other backward algorithms at batch 4
# than at 8, and Adam's first steps, about lr * sign(g), magnify the
# difference where a gradient is near 0 (the update 1.2e-2-1.5e-2 on an
# H100, the fifth loss up to 5.0e-6, where the CPU shows 1.6e-5 and
# 1.3e-7). So the same run is also made at 32^2 (depth 5, 8 filters,
# global batch 4) with cuDNN off, held at the CPU tests' tolerances: a
# fault of the reduction or of the rows' draws cannot hide there under
# cuDNN's choice of algorithm; and with cuDNN on at 32^2, printed beside
# it.
DP_TOL = {"loss_rel_first": 1e-5, "loss_rel": 1e-4, "update": 5e-2}
DP_EXACT = {"batch": 4, "size": 32, "depth": 5, "num_filters": 8}
DP_TOL_EXACT = {"loss_rel": 1e-5, "update": 1e-4}


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _max_abs(a, b) -> float:
    """The largest difference between two lists of tensors (as f32)."""
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b))


def _update_normwise(run, ref) -> float:
    num = sum(float(((b - a) - (rb - ra)).double().norm() ** 2)
              for a, b, ra, rb in zip(run["params0"], run["params"],
                                      ref["params0"], ref["params"]))
    den = sum(float((rb - ra).double().norm() ** 2)
              for ra, rb in zip(ref["params0"], ref["params"]))
    return (num / den) ** 0.5


def _dp_launcher_runs(card: str) -> dict:
    """The CLI's default run (bf16, bf16-SR masters, TF32 as torch sets
    it) at full width for 1 epoch on phase 7's corpus: plain, through the
    launcher at world size 1 (NCCL), plain again; the default generators
    reseeded before each, so dropout draws alike. Each run's launches, its
    median ms a step, and the final weights against the first plain
    run's."""
    from svbrdf_tpu_torch.parallel import multihost

    per_epoch = math.ceil(math.ceil(CLI["samples"] * 0.99) / CLI["batch"])
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        data = _cli_dataset(root)

        def train(name):
            return ["--mode", "train", "--input-dir", str(data),
                    "--image-count", "0", "--used-image-count", "1",
                    "--loss", "mixed", "--save-frequency", "1",
                    "--validation-frequency", "1", "--model-dir",
                    str(root / name), "--image-size", str(CLI["size"]),
                    "--model-depth", str(CLI["depth"]), "--num-filters",
                    str(CLI["num_filters"]), "--batch-size",
                    str(CLI["batch"]), "--epochs", "1", "--retrain",
                    "--gpu-id", "0"]

        runs = {}
        for name, argv, entry in (
                ("plain_a", train("plain_a") + ["--num-devices", "1"], None),
                ("launcher_world1", ["--num-processes", "1", "--"]
                 + train("launcher_world1"), multihost.main),
                ("plain_b", train("plain_b") + ["--num-devices", "1"],
                 None)):
            torch.manual_seed(0)
            with _tf32(True, False):
                run, text, counts = _cli(f"dp {name}", argv, entry)
            if (run.steps, run.validation_batches) != (per_epoch, 1):
                raise RuntimeError(f"dp {name}: {run.steps} steps, "
                                   f"{run.validation_batches} validation "
                                   f"batches")
            _expect(counts, {"mixed_fwdgrad_bf16": run.steps,
                             "mixed_fwd_bf16": run.validation_batches,
                             "sr_adam": run.steps * _sr_adam_launches(
                                 run.model),
                             **_tail_launches("single", run.steps,
                                              run.validation_batches
                                              + _grids(text))},
                    f"dp {name}")
            if entry is not None and ("process 0/1" not in text
                                      or "over nccl" not in text):
                raise RuntimeError("dp launcher: not a world-1 NCCL group")
            runs[name] = run
            out[name] = {"launches": counts,
                         "step_ms_median": run.timer.median_ms(),
                         "last_loss": run.last_loss}
            shutil.rmtree(root / name)  # a checkpoint is ~1 GB
    params = {k: [p.detach() for p in r.model.parameters()]
              for k, r in runs.items()}
    plain = _max_abs(params["plain_a"], params["plain_b"])
    dist = _max_abs(params["launcher_world1"], params["plain_a"])
    deterministic = plain == 0.0
    # Bit-equal when the plain runs are; else no further from a plain run
    # than twice the plain runs' own distance (three draws of one
    # nondeterministic run: the third need not be the nearest).
    if dist > 2 * plain:
        raise RuntimeError(f"dp launcher: weights {dist} from the plain "
                           f"run's, the plain runs {plain} apart")
    out.update(weights_max_abs_launcher_vs_plain=dist,
               weights_max_abs_plain_vs_plain=plain,
               plain_runs_bit_equal=deterministic)
    log(f"dp [{card}] CLI defaults (bf16, bf16-SR), 1 epoch, "
        f"{per_epoch} steps: median ms a step plain "
        f"{out['plain_a']['step_ms_median']:.2f}, launcher world 1 (NCCL) "
        f"{out['launcher_world1']['step_ms_median']:.2f}, plain "
        f"{out['plain_b']['step_ms_median']:.2f}; launcher launches "
        f"{_nonzero(out['launcher_world1']['launches'])} (mixed_fwdgrad "
        f"and sr_adam once a step, mixed_fwd once a validation batch)")
    log(f"dp [{card}] final weights: launcher vs plain max abs {dist:g}, "
        f"plain vs plain {plain:g} ("
        + ("the plain runs are bit-equal: cuDNN ran deterministically"
           if deterministic else "the plain runs differ: cuDNN's backward "
           "ran nondeterministically") + ")")
    return out


def _dp_world_two(card: str) -> dict:
    """World 2 on the card: two ranks (on two cards over NCCL where there
    are two, else both on cuda:0 over gloo) run the main path's
    data-parallel program (bench_setup.data_parallel_runs) at full width,
    global batch 8 (4 a rank): 5 f32 steps (TF32 off, dropout off) held
    against world 1's on the same global batch, then 5 bf16-SR steps;
    the replicas bit-identical after each, and each rank's launches."""
    from svbrdf_tpu_torch.utils import bench_setup

    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= 2 else "gloo"
    program = dict(model_kind="single", loss_kind="mixed",
                   batch=MAIN["batch"], size=MAIN["size"],
                   depth=MAIN["depth"], num_filters=MAIN["num_filters"],
                   seed=0, device="cuda")
    bf16 = dict(program, dtype=BF16, master_dtype="bf16sr")
    small = dict(program, **DP_EXACT)
    steps = DP["steps"]
    torch.cuda.empty_cache()
    start = time.perf_counter()
    two, two_bf16, two_small_off, two_small_on = (
        bench_setup.data_parallel_runs(
            2, [((program, steps), {}), ((bf16, steps), {}),
                ((small, steps), {"cudnn": False}), ((small, steps), {})],
            backend, DP["timeout"]))
    spawn_s = time.perf_counter() - start
    exact = _dp_exact(two_small_off, two_small_on, steps)
    group1, group1_bf16 = bench_setup.data_parallel_runs(
        1, [((program, steps), {}), ((bf16, steps), {})], None,
        DP["timeout"])
    one = bench_setup.train_steps(program, steps)
    torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(two["losses"],
                                                   one["losses"]))
    rel_first = abs(two["losses"][0] - one["losses"][0]) / abs(
        one["losses"][0])
    update = _update_normwise(two, one)
    for name, run, kernel in (("f32", two, "mixed_fwdgrad"),
                              ("bf16-SR", two_bf16, "mixed_fwdgrad_bf16")):
        if len(set(run["checksums"])) != 1:
            raise RuntimeError(f"dp world 2 {name}: replicas differ")
        want = {kernel: steps, **_tail_launches("single", steps)}
        if run is two_bf16:
            want["sr_adam"] = steps
        for r, counts in enumerate(run["launches"]):
            _expect(counts, want, f"dp world 2 {name} rank {r}")
    if (rel_first > DP_TOL["loss_rel_first"] or rel > DP_TOL["loss_rel"]
            or update > DP_TOL["update"]):
        raise RuntimeError(f"dp world 2 f32: first loss rel {rel_first:g}, "
                           f"loss rel {rel:g}, update normwise {update:g}, "
                           f"over {DP_TOL}")
    shared = backend == "gloo"
    ms = {"world2_f32": statistics.median(two["step_ms"][1:]),
          "world2_bf16sr": statistics.median(two_bf16["step_ms"][1:]),
          "world1_nccl_f32": statistics.median(group1["step_ms"][1:]),
          "world1_nccl_bf16sr": statistics.median(
              group1_bf16["step_ms"][1:]),
          "world1_f32": statistics.median(one["step_ms"][1:])}
    reduce_ms = {"world2_f32": two["reduce_ms"],
                 "world2_bf16sr": two_bf16["reduce_ms"],
                 "world1_nccl_f32": group1["reduce_ms"],
                 "world1_nccl_bf16sr": group1_bf16["reduce_ms"]}
    rel1 = max(abs(a - b) / abs(b) for a, b in zip(group1["losses"],
                                                    one["losses"]))
    rel1_first = abs(group1["losses"][0] - one["losses"][0]) / abs(
        one["losses"][0])
    for name, run in (("f32", group1), ("bf16-SR", group1_bf16)):
        kernel = "mixed_fwdgrad" if run is group1 else "mixed_fwdgrad_bf16"
        want = {kernel: steps, **_tail_launches("single", steps),
                **({"sr_adam": steps} if run is group1_bf16 else {})}
        _expect(run["launches"][0], want, f"dp world 1 nccl {name}")
    if rel1_first > DP_TOL["loss_rel_first"] or rel1 > DP_TOL["loss_rel"]:
        raise RuntimeError(f"dp world 1 (NCCL group) f32: first loss rel "
                           f"{rel1_first:g}, loss rel {rel1:g}")
    log(f"dp [{card}] world 2 over {backend} ({n_cards} card(s)"
        + (", both ranks on cuda:0" if shared else "") + f"): f32 losses "
        f"{[round(v, 6) for v in two['losses']]} vs world 1 "
        f"{[round(v, 6) for v in one['losses']]}, loss rel first step "
        f"{rel_first:.3g}, any step {rel:.3g}, "
        f"update normwise {update:.3g}; replicas bit-identical after f32 "
        f"and bf16-SR; launches per rank f32 "
        f"{[_nonzero(c) for c in two['launches']]}, bf16-SR "
        f"{[_nonzero(c) for c in two_bf16['launches']]}")
    log(f"dp [{card}] ms a step (host clock, the loss fetched; median of "
        f"steps 2-{steps}): world 2 f32 {ms['world2_f32']:.2f}, bf16-SR "
        f"{ms['world2_bf16sr']:.2f}"
        + (" (not a scaling number: both ranks share one card)"
           if shared else "") + f"; world 1 NCCL group f32 "
        f"{ms['world1_nccl_f32']:.2f}, bf16-SR "
        f"{ms['world1_nccl_bf16sr']:.2f}; plain world 1 f32 "
        f"{ms['world1_f32']:.2f}; the two ranks' run {spawn_s:.1f} s with "
        f"their start")
    log(f"dp [{card}] gradient all-reduce (reduce_gradients, host ms "
        f"synced, median of 5): " + ", ".join(
            f"{k} {v:.3f}" for k, v in reduce_ms.items())
        + f"; world 1 NCCL group f32 losses vs plain: rel {rel1:.3g}")
    return {"backend": backend, "cards": n_cards, "shared_card": shared,
            "losses": two["losses"], "losses_world1": one["losses"],
            "loss_rel": rel, "loss_rel_first": rel_first,
            "update_normwise": update, "step_ms": ms,
            "reduce_ms": reduce_ms, "world1_nccl_loss_rel": rel1,
            "launches": {"f32": two["launches"],
                         "bf16sr": two_bf16["launches"]},
            "small_32": exact, "spawn_and_run_s": spawn_s}


def _dp_exact(two_off: dict, two_on: dict, steps: int) -> dict:
    """World 2 at 32^2 (DP_EXACT) against world 1 on the card, with cuDNN
    off (held at DP_TOL_EXACT, the CPU tests' tolerances) and on
    (printed), f32, TF32 off, dropout off; the replicas bit-identical."""
    from svbrdf_tpu_torch.utils import bench_setup

    small = dict(model_kind="single", loss_kind="mixed", seed=0,
                 device="cuda", **DP_EXACT)
    out = {}
    for name, two, cudnn in (("cudnn_off", two_off, False),
                             ("cudnn_on", two_on, True)):
        one = bench_setup.train_steps(small, steps, cudnn=cudnn)
        if len(set(two["checksums"])) != 1:
            raise RuntimeError(f"dp world 2 32^2 {name}: replicas differ")
        for r, counts in enumerate(two["launches"]):
            _expect(counts, {"mixed_fwdgrad": steps,
                             **_tail_launches("single", steps,
                                              depth=DP_EXACT["depth"])},
                    f"dp world 2 32^2 {name} rank {r}")
        out[name] = {
            "loss_rel": max(abs(a - b) / abs(b)
                            for a, b in zip(two["losses"], one["losses"])),
            "update_normwise": _update_normwise(two, one)}
    off = out["cudnn_off"]
    if (off["loss_rel"] > DP_TOL_EXACT["loss_rel"]
            or off["update_normwise"] > DP_TOL_EXACT["update"]):
        raise RuntimeError(f"dp world 2 32^2 cuDNN off: loss rel "
                           f"{off['loss_rel']:g}, update normwise "
                           f"{off['update_normwise']:g}, over "
                           f"{DP_TOL_EXACT}")
    log(f"dp world 2 at 32^2 (depth {DP_EXACT['depth']}, "
        f"{DP_EXACT['num_filters']} filters, global batch "
        f"{DP_EXACT['batch']}, f32) vs world 1, {steps} steps: cuDNN off "
        f"loss rel {off['loss_rel']:.3g}, update normwise "
        f"{off['update_normwise']:.3g} (held at {DP_TOL_EXACT}); cuDNN on "
        f"loss rel {out['cudnn_on']['loss_rel']:.3g}, update normwise "
        f"{out['cudnn_on']['update_normwise']:.3g}; replicas "
        f"bit-identical")
    return out


def phase_data_parallel() -> dict:
    """The data-parallel phase (parallel/mesh, the data-parallel step):
    the launcher at world size 1, and world size 2 on the card."""
    card = _card()
    start = time.perf_counter()
    out = {"card": card, "launcher": _dp_launcher_runs(card),
           "world2": _dp_world_two(card)}
    out["seconds"] = time.perf_counter() - start
    log(f"dp phase {out['seconds']:.1f} s")
    return out


# The tail's phase (9): the inference API and the tools at full width. The
# toy corpus: TAIL["strips"] strips with 10 photos each (train) and as many
# test strips, symlinks up to CLI["samples"] training files (the 1 % split
# holds one out; 13 steps of 8 an epoch). Every run of the phase is on
# TAIL["device"], and checked to be.
TAIL = {"device": "cuda", "size": 256, "photos": 10, "strips": 8,
        "recovery_steps": 200, "recovery_scenes": 6, "small_size": 16,
        "small_steps": 10, "frames": 8, "sensor": 384, "predict_batch": 8,
        "example_recovery_steps": 50}
# Map recovery card vs CPU at 16^2 (the CPU tests' rule against JAX).
TAIL_TOL = {"loss_rel": 1e-4, "maps_abs": 1e-4}


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def _tail_run(name: str, fn, expected=None):
    """fn() with every launch counter set to 0 just before and read just
    after: torch ops and host work, so every count must be 0 but those
    `expected` names."""
    torch.cuda.synchronize()
    _zero_counts()
    start = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    counts = _counts()
    _expect(counts, expected or {}, f"tail {name}")
    log(f"tail {name} ({seconds:.2f} s): launches {_nonzero(counts)}")
    return result, seconds, counts


def _tail_data(root: pathlib.Path) -> dict:
    """The toy corpus, generated on the card: TAIL["strips"] train and
    test strips of 10 photos; the train directory filled with symlinks up
    to CLI["samples"] files; the first photo of each test strip as a photo
    file."""
    from svbrdf_tpu_torch.data import png, strips, toy

    n = TAIL["strips"]
    written, seconds, counts = _tail_run("toy data", lambda: _quiet(
        toy.generate_toy_dataset, str(root / "toy"), n, n, TAIL["size"],
        TAIL["photos"], seed=313, device=TAIL["device"]))
    train = root / "toy" / "train"
    for k in range(n, CLI["samples"]):
        (train / f"link_{k:03d}.png").symlink_to(
            train / f"toy_train_{k % n:02d}.png")
    size = TAIL["size"]
    photos = []
    for path in written[n:]:
        strip = strips.read_image_u8(path)
        if strip.shape != (size, (TAIL["photos"] + 4) * size, 3):
            raise RuntimeError(f"tail toy data: {path} is {strip.shape}")
        photo = root / "photos" / pathlib.Path(path).name
        photo.parent.mkdir(exist_ok=True)
        png.write_png_rgb8(str(photo), strip[:, :size])
        photos.append(str(photo))
    ms = seconds / len(written) * 1e3
    log(f"tail toy data: {len(written)} strips of {TAIL['photos']} photos "
        f"at {size}^2 in {seconds:.2f} s, {ms:.1f} ms a strip (maps on the "
        f"host, photos rendered on the card, PNG written)")
    return {"train": train, "test": written[n:], "photos": photos,
            "ms_per_strip": ms, "launches": _nonzero(counts)}


def _tail_cli(train: pathlib.Path, model_dir: pathlib.Path, cli: dict
              ) -> dict:
    """The CLI on photo strips at its defaults (bf16, bf16-SR) for 1
    epoch: mixed_fwdgrad_bf16 and sr_adam once a step, mixed_fwd_bf16 once
    a validation batch."""
    per_epoch = math.ceil(math.ceil(CLI["samples"] * 0.99) / CLI["batch"])
    argv = ["--mode", "train", "--input-dir", str(train), "--image-count",
            str(TAIL["photos"]), "--used-image-count", "1", "--loss",
            "mixed", "--epochs", "1", "--retrain", "--save-frequency", "1",
            "--validation-frequency", "1", "--model-dir", str(model_dir),
            "--image-size", str(CLI["size"]), "--model-depth",
            str(CLI["depth"]), "--num-filters", str(CLI["num_filters"]),
            "--batch-size", str(CLI["batch"]), "--gpu-id", "0",
            "--num-devices", "1"]
    with _tf32(True, False):
        run, _, counts = _cli_train(
            "photo_strips_default", argv,
            ("mixed_fwdgrad_bf16", "mixed_fwd_bf16"), per_epoch, 1,
            sr_adam=True)
    maps_only = cli["runs"]["single_mixed_default"]
    out = {"steps": run.steps, "validation_batches": run.validation_batches,
           "step_ms_median": run.timer.median_ms(),
           "maps_only_epoch0_step_ms": maps_only["epoch_step_ms_medians"][0],
           "maps_only_step_ms_median": maps_only["step_ms_median"],
           "launches": counts}
    log(f"tail cli on photo strips (bf16, bf16-SR, 1 epoch, decoded "
        f"through the pool): median {out['step_ms_median']:.2f} ms a step; "
        f"phase 7's maps-only run at the same precision: epoch 0 "
        f"{out['maps_only_epoch0_step_ms']:.2f} ms, both epochs "
        f"{out['maps_only_step_ms_median']:.2f} ms")
    return out


def _tail_estimator(model_dir: pathlib.Path, data: dict, root: pathlib.Path
                    ) -> dict:
    """SvbrdfEstimator on the card: predict on 8 test photos bit-equal to a
    fresh model restored from the same checkpoint; predict_to_files; the
    times."""
    from svbrdf_tpu_torch.data import strips
    from svbrdf_tpu_torch.estimator import SvbrdfEstimator
    from svbrdf_tpu_torch.models import build_model
    from svbrdf_tpu_torch.parallel.step import make_predict_fn
    from svbrdf_tpu_torch.training.checkpoint import Checkpoint

    est, _, _ = _tail_run("estimator load", lambda: _quiet(
        SvbrdfEstimator.from_checkpoint, model_dir, device=TAIL["device"]))
    if est.device.type != TAIL["device"]:
        raise RuntimeError(f"tail estimator: on {est.device}")
    photos = data["photos"][:TAIL["predict_batch"]]
    images = np.stack([strips.read_image(p) for p in photos]) ** 2.2
    # One forward a call.
    maps, _, counts = _tail_run("estimator predict",
                                lambda: est.predict(images),
                                _tail_launches("single", 0, 1))
    fresh = build_model("single", False, CLI["depth"], CLI["num_filters"],
                        device=TAIL["device"], seed=1)
    _quiet(lambda: Checkpoint.load(model_dir).restore_params(fresh))
    direct = make_predict_fn(fresh)(torch.from_numpy(images).to(
        TAIL["device"]))
    if not np.array_equal(maps, direct.cpu().numpy()):
        raise RuntimeError("tail estimator: predict differs from a fresh "
                           "model restored from the checkpoint")
    size = TAIL["size"]
    if maps.shape != (len(photos), size, size, 12) \
            or not np.isfinite(maps).all():
        raise RuntimeError(f"tail estimator: maps {maps.shape}")
    out_dir = root / "predicted"
    written, _, _ = _tail_run("estimator files", lambda: est.predict_to_files(
        photos, str(out_dir)), _tail_launches("single", 0, 1))
    for path in written:
        if strips.read_image_u8(path).shape != (size, 4 * size, 3):
            raise RuntimeError(f"tail estimator: {path} misread")
    predict_ms = cuda_ms(lambda: est.predict(images))
    files_ms = _host_ms(lambda: est.predict_to_files(photos, str(out_dir)),
                        reps=3) / len(photos)
    log(f"tail estimator: predict of {len(photos)} photos bit-equal to a "
        f"fresh restored model; {len(written)} map strips read back at "
        f"({size}, {4 * size}, 3); predict {predict_ms:.2f} ms at batch "
        f"{len(photos)} (CUDA events, median of 20, numpy in and out), "
        f"{files_ms:.2f} ms a photo file to file (host clock, median of 3)")
    return {"predict_ms": predict_ms, "files_ms_per_photo": files_ms,
            "written": len(written), "launches": _nonzero(counts)}


def _tail_recovery() -> dict:
    """Map recovery at 256^2 on the card (diffuse, 200 fixed-scene steps,
    6 scenes): converges; at 16^2, 10 steps card against CPU."""
    from svbrdf_tpu_torch.data import toy
    from svbrdf_tpu_torch.experiments import recover_maps
    from svbrdf_tpu_torch.ops import sampling
    from svbrdf_tpu_torch.scene import Scene

    def scenes(seed):
        drawn = sampling.generate_loss_scenes(
            1, TAIL["recovery_scenes"] // 2,
            TAIL["recovery_scenes"] - TAIL["recovery_scenes"] // 2,
            generator=torch.Generator().manual_seed(seed))
        return Scene(drawn.camera_pos[0], drawn.light_pos[0],
                     drawn.light_color[0])

    target = toy.make_toy_svbrdf(np.random.default_rng(5), TAIL["size"])
    steps = TAIL["recovery_steps"]
    dev = TAIL["device"]
    result, seconds, counts = _tail_run("map recovery", lambda: recover_maps(
        torch.Generator(device=dev).manual_seed(0), target,
        optimize=("diffuse",), steps=steps, scenes=scenes(1), device=dev))
    trace = result.losses.cpu()
    first, last = float(trace[0]), float(trace[-1])
    if result.svbrdf.device.type != dev or not last < 0.3 * first:
        raise RuntimeError(f"tail map recovery on {result.svbrdf.device}: "
                           f"loss {first} -> {last}")
    small = toy.make_toy_svbrdf(np.random.default_rng(6), TAIL["small_size"])
    card, cpu = (recover_maps(torch.Generator(device=d).manual_seed(0),
                              small, optimize=("diffuse",),
                              steps=TAIL["small_steps"], scenes=scenes(2),
                              device=d) for d in (dev, "cpu"))
    loss_rel = float(((card.losses.cpu() - cpu.losses).abs()
                      / cpu.losses.abs()).max())
    maps_abs = float((card.svbrdf.cpu() - cpu.svbrdf).abs().max())
    out = {"first_loss": first, "last_loss": last,
           "ms_per_step": seconds / steps * 1e3,
           "small_loss_rel": loss_rel, "small_maps_abs": maps_abs,
           "launches": _nonzero(counts)}
    log(f"tail map recovery ({TAIL['size']}^2, diffuse, {steps} steps, "
        f"{TAIL['recovery_scenes']} fixed scenes): loss {first:.5f} -> "
        f"{last:.5f} ({last / first:.3f}x); {out['ms_per_step']:.2f} ms a "
        f"step; at {TAIL['small_size']}^2, {TAIL['small_steps']} steps card "
        f"vs CPU: loss rel {loss_rel:.3g} (limit {TAIL_TOL['loss_rel']}), "
        f"maps {maps_abs:.3g} (limit {TAIL_TOL['maps_abs']})")
    if loss_rel > TAIL_TOL["loss_rel"] or maps_abs > TAIL_TOL["maps_abs"]:
        raise RuntimeError(f"tail map recovery card vs CPU: loss rel "
                           f"{loss_rel:.3g}, maps {maps_abs:.3g}")
    return out


def _tail_turntable(root: pathlib.Path) -> dict:
    """8 frames of 384^2 from a 256^2 toy map, written as a GIF."""
    from svbrdf_tpu_torch import viz
    from svbrdf_tpu_torch.data import gif, toy

    target = toy.make_toy_svbrdf(np.random.default_rng(7), TAIL["size"])
    path = root / "turntable.gif"
    sensor = (TAIL["sensor"], TAIL["sensor"])

    def run():
        frames = viz.turntable_frames(target, n_frames=TAIL["frames"],
                                      sensor_size=sensor,
                                      device=TAIL["device"])
        viz.save_animation(str(path), frames)
        return frames

    frames, seconds, counts = _tail_run("turntable", run)
    info = gif.gif_info(str(path))
    if (info != {"size": sensor, "frames": TAIL["frames"],
                 "delays_cs": [7] * TAIL["frames"], "loop": 0}
            or max(float(f.mean()) for f in frames) <= 0.05):
        raise RuntimeError(f"tail turntable: {info}")
    log(f"tail turntable: {TAIL['frames']} frames of {sensor} from a "
        f"{TAIL['size']}^2 map in {seconds:.2f} s; GIF89a {info}, "
        f"{path.stat().st_size} bytes")
    return {"seconds": seconds, "gif": info, "bytes": path.stat().st_size,
            "launches": _nonzero(counts)}


def _tail_examples(root: pathlib.Path, model_dir: pathlib.Path,
                   data: dict) -> dict:
    """Each of the four examples' main(argv) once on the toy strips;
    renderer_compare renders its f32 maps once through the path tracer's
    forward kernel, predict runs one forward of the model (its block
    tails' forward kernel), the others launch no kernel."""
    from svbrdf_tpu_torch.examples import (predict, recover_maps,
                                           renderer_compare, turntable)

    strip = data["test"][0]
    out = root / "examples"
    out.mkdir()
    runs = {
        "predict": (predict.main, [str(model_dir), str(out / "predict"),
                                   *data["photos"][:2]],
                    [out / "predict" / (pathlib.Path(p).stem
                                        + "_svbrdf.png")
                     for p in data["photos"][:2]]),
        "turntable": (turntable.main, [strip, str(out / "t.gif"), "4"],
                      [out / "t.gif"]),
        "renderer_compare": (renderer_compare.main,
                             [strip, str(out / "compare.png")],
                             [out / "compare.png"]),
        "recover_maps": (recover_maps.main,
                         [strip, "diffuse", str(out / "recovered.png"),
                          str(TAIL["example_recovery_steps"])],
                         [out / "recovered.png"]),
    }
    expected = {"renderer_compare": {"pathtrace_shade": 1},
                "predict": _tail_launches("single", 0, 1)}
    result = {}
    for name, (main_fn, argv, files) in runs.items():
        argv = argv + ["--device", TAIL["device"]]
        _, seconds, counts = _tail_run(
            f"example {name}", lambda: _quiet(main_fn, argv),
            expected.get(name))
        missing = [str(f) for f in files if not f.is_file()]
        if missing:
            raise RuntimeError(f"tail example {name} wrote no {missing}")
        result[name] = {"seconds": seconds, "launches": _nonzero(counts)}
    log("tail examples: " + ", ".join(f"{k} {v['seconds']:.2f} s"
                                     for k, v in result.items()))
    return result


def _tail_mfu(steps_ms: dict) -> dict:
    """utils/flops.mfu of the main path's train-step medians (phases
    5-6): bf16-SR against the card's bf16 peak, f32 against its f32 one."""
    from svbrdf_tpu_torch.utils import flops

    name = torch.cuda.get_device_name(0)
    out = {"card": _card()}
    for label, path, dtype in (("bf16_bf16sr", "single_mixed_bf16",
                                "bfloat16"),
                               ("f32", "single_mixed", "float32")):
        ms = steps_ms[path]["train_step"]
        out[label] = {"train_step_ms": ms, "mfu": flops.mfu(
            ms / 1e3, MAIN["batch"], MAIN["size"], dtype, device_name=name),
            "peak_flops": flops.peak_flops(name, dtype)}
    out["train_step_flops"] = flops.train_step_flops(MAIN["batch"],
                                                     MAIN["size"])
    log(f"tail MFU ({out['card']}): bf16-SR train step "
        f"{out['bf16_bf16sr']['train_step_ms']:.2f} ms -> "
        f"{out['bf16_bf16sr']['mfu']:.4%} of "
        f"{out['bf16_bf16sr']['peak_flops'] / 1e12:g} TFLOP/s; f32 "
        f"{out['f32']['train_step_ms']:.2f} ms -> {out['f32']['mfu']:.4%} "
        f"of {out['f32']['peak_flops'] / 1e12:g} TFLOP/s "
        f"({out['train_step_flops']} model FLOPs a step)")
    return out


def phase_tail(steps_ms: dict, cli: dict) -> dict:
    """Phase 9: toy photo strips made on the card -> the CLI trains on them
    -> the estimator predicts from its checkpoint -> map recovery -> a
    turntable GIF -> the four examples; and the main path's MFU."""
    start = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        data = _tail_data(root)
        out["toy_data"] = {k: data[k] for k in ("ms_per_strip", "launches")}
        model_dir = root / "model"
        out["cli"] = _tail_cli(data["train"], model_dir, cli)
        out["estimator"] = _tail_estimator(model_dir, data, root)
        out["map_recovery"] = _tail_recovery()
        out["turntable"] = _tail_turntable(root)
        out["examples"] = _tail_examples(root, model_dir, data)
    out["mfu"] = _tail_mfu(steps_ms)
    out["seconds"] = time.perf_counter() - start
    log(f"tail phase {out['seconds']:.1f} s")
    return out


# The spatial phase (10): --shard-spatial at world 2 (parallel/spatial,
# training/spatial_loop). The main path's single-view mixed program at full
# width (MAIN), the height split over 2 ranks (two cards over NCCL where
# there are two, else both ranks on cuda:0 over gloo, as phase 8), 5 f32
# steps (TF32 off, dropout off) held against world 1 as phase 8 holds data
# parallel (DP_TOL: cuDNN picks its algorithms by the shard's shape), and
# at 32^2 with cuDNN off at DP_TOL_EXACT; each rank's peak device memory at
# the shapes of SPATIAL["memory"] (f32, SPATIAL["memory_steps"] steps)
# beside one device's; eval and predict (the gathered maps within
# SPATIAL["maps_abs"] of one device's); the two rendering kernels at row
# offset SPATIAL["offset"] of MAIN["size"] against their plain versions;
# the CLI with --shard-spatial 2 for 1 epoch on phase 7's corpus; and
# dryrun.run_spatial(2), which needs two cards.
SPATIAL = {"steps": 5, "timeout": 900, "memory_steps": 2,
           "memory": ((256, 8), (1024, 2)), "offset": 128, "runs": 5,
           "maps_abs": 1e-4}


def _spatial_eval_rank(program: dict, images, runs: int, group) -> dict:
    """In a rank of the spatial group: the eval step on the program's raw
    batch and the sharded predict of `images`, each once with every launch
    counter set to 0 just before and read just after, then `runs` times
    more under spatial.timed_collectives (host clock, synced): the group's
    eval loss, the maps gathered on rank 0, each call's launches, median
    ms and collectives' ms and calls."""
    from svbrdf_tpu_torch.device import precision_scope
    from svbrdf_tpu_torch.parallel import spatial
    from svbrdf_tpu_torch.utils import bench_setup

    dev = group.device
    out = {}
    with precision_scope(torch.float32):
        prog = bench_setup.build_program(**program, space=group)
        images = images.to(dev)
        for name, fn in (("eval", lambda: prog.eval_step(prog.raw)),
                         ("predict", lambda: prog.predict(images))):
            torch.cuda.synchronize(dev)
            bench_setup.zero_launch_counts()
            value = fn()
            torch.cuda.synchronize(dev)
            out[f"{name}_launches"] = bench_setup.launch_counts()
            times = []
            with spatial.timed_collectives(dev) as collectives:
                for _ in range(runs):
                    start = time.perf_counter()
                    fn()
                    torch.cuda.synchronize(dev)
                    times.append((time.perf_counter() - start) * 1e3)
            out[f"{name}_ms"] = statistics.median(times)
            out[f"{name}_collective_ms"] = collectives["ms"] / runs
            out[f"{name}_collective_calls"] = collectives["calls"] / runs
            out[name] = value
    out["eval"] = float(out["eval"])
    maps = spatial.gather_maps(out.pop("predict"), group)
    out["maps"] = None if maps is None else maps.cpu()
    return out


def _spatial_cli_rank(argv: list, images, group) -> dict:
    """In a rank of the spatial group: main.main(argv, group) with every
    launch counter set to 0 just before and read just after; the run's
    steps, validation batches, last loss, median ms a step, printout, the
    sr_adam launches a step its optimizer takes, and on rank 0 the trained
    model's maps of `images` (unsharded predict)."""
    from svbrdf_tpu_torch import main as cli_main
    from svbrdf_tpu_torch.parallel.optimizer import AdamBf16SR
    from svbrdf_tpu_torch.parallel.step import make_predict_fn
    from svbrdf_tpu_torch.utils import bench_setup

    torch.cuda.synchronize(group.device)
    bench_setup.zero_launch_counts()
    text = io.StringIO()
    start = time.perf_counter()
    with contextlib.redirect_stdout(text):
        run = cli_main.main(argv, group)
    torch.cuda.synchronize(group.device)
    out = {"seconds": time.perf_counter() - start,
           "launches": bench_setup.launch_counts(), "steps": run.steps,
           "validation_batches": run.validation_batches,
           "last_loss": run.last_loss,
           "step_ms_median": run.timer.median_ms(), "text": text.getvalue(),
           "sr_adam_per_step": (_sr_adam_launches(run.model)
                                if isinstance(run.optimizer, AdamBf16SR)
                                else 0)}
    if group.is_main:
        out["maps"] = make_predict_fn(run.model)(
            images.to(group.device)).cpu()
    return out


def _peak_bytes(fn) -> tuple:
    """(fn(), the device's peak allocation while it ran, less what was
    allocated before it)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    result = fn()
    torch.cuda.synchronize()
    return result, torch.cuda.max_memory_allocated() - base


def _spatial_offset_kernels(inputs) -> dict:
    """render_fwdgrad and render_fwd on the two row halves of `inputs`
    (rows 0 and SPATIAL["offset"] of the global height), each against its
    plain version at the same offset by phase 3's rules (loss rel 1e-5;
    render_fwdgrad's gradient within 1e-6 of its max |value|), and the
    halves' losses summed against the whole image's (rel 1e-6), the
    halves' gradients put together against the whole's (the same rule)."""
    from svbrdf_tpu_torch.ops import render_fused as rf

    pred_t, gt_t, scenes9 = inputs
    height = pred_t.shape[2]
    cut = SPATIAL["offset"]
    out = {}
    for name in ("render_fwdgrad", "render_fwd"):
        wrapper, plain = rf.CUDA_WRAPPERS[name], rf.PLAIN_VERSIONS[name]
        whole = _outputs(wrapper(pred_t, gt_t, scenes9))
        halves, errs = [], {}
        for lo, hi in ((0, cut), (cut, height)):
            args = (pred_t[:, :, lo:hi].contiguous(),
                    gt_t[:, :, lo:hi].contiguous(), scenes9, lo, height)
            got, ref = _outputs(wrapper(*args)), _outputs(plain(*args))
            torch.cuda.synchronize()
            rel = abs(float(got[0]) - float(ref[0])) / abs(float(ref[0]))
            grad = (float((got[1] - ref[1]).abs().max())
                    / float(ref[1].abs().max())) if len(got) > 1 else 0.0
            if rel > 1e-5 or grad > 1e-6:
                raise RuntimeError(f"{name} at row offset {lo}: loss rel "
                                   f"{rel:.3g}, gradient {grad:.3g} of its "
                                   f"max from its plain version")
            errs[f"offset_{lo}"] = {"loss_rel": rel, "grad_rel_max": grad}
            halves.append(got)
        total = float(halves[0][0]) + float(halves[1][0])
        sum_rel = abs(total - float(whole[0])) / abs(float(whole[0]))
        grad_sum = 0.0
        if len(whole) > 1:
            joined = torch.cat([h[1] for h in halves], dim=2)
            grad_sum = (float((joined - whole[1]).abs().max())
                        / float(whole[1].abs().max()))
        if sum_rel > 1e-6 or grad_sum > 1e-6:
            raise RuntimeError(f"{name}: the halves sum to {total!r} against "
                               f"the whole's {float(whole[0])!r} (rel "
                               f"{sum_rel:.3g}), gradients {grad_sum:.3g}")
        out[name] = dict(errs, halves_sum_rel=sum_rel,
                         halves_grad_rel_max=grad_sum)
        log(f"spatial {name} at row offsets 0 and {cut} of {height}: vs "
            f"plain loss rel {errs['offset_0']['loss_rel']:.3g} / "
            f"{errs[f'offset_{cut}']['loss_rel']:.3g}, gradient "
            f"{errs['offset_0']['grad_rel_max']:.3g} / "
            f"{errs[f'offset_{cut}']['grad_rel_max']:.3g} of its max; the "
            f"halves' losses sum to the whole's at rel {sum_rel:.3g}, "
            f"gradients {grad_sum:.3g}")
    return out


def _spatial_cli(backend: str, images) -> dict:
    """The CLI at its defaults with --shard-spatial 2, 1 epoch on phase 7's
    corpus, main.main(argv, group) in the two ranks: every rank's launches
    (render_fwdgrad once a train step, render_fwd once a validation batch,
    sr_adam as its optimizer takes it, 0 else), finite losses, the
    checkpoint's meta (upconv 'fold', master_dtype 'f32'), and a fresh
    model restored from it predicting the trained model's bits."""
    from svbrdf_tpu_torch.models import build_model
    from svbrdf_tpu_torch.parallel.step import make_predict_fn
    from svbrdf_tpu_torch.training.checkpoint import Checkpoint
    from svbrdf_tpu_torch.training.loop import resolve_dtype
    from svbrdf_tpu_torch.utils import bench_setup

    per_epoch = math.ceil(math.ceil(CLI["samples"] * 0.99) / CLI["batch"])
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        data = _cli_dataset(root)
        model_dir = root / "spatial"
        argv = ["--mode", "train", "--input-dir", str(data),
                "--image-count", "0", "--used-image-count", "1",
                "--loss", "mixed", "--save-frequency", "1",
                "--validation-frequency", "1", "--model-dir",
                str(model_dir), "--image-size", str(CLI["size"]),
                "--model-depth", str(CLI["depth"]), "--num-filters",
                str(CLI["num_filters"]), "--batch-size", str(CLI["batch"]),
                "--epochs", "1", "--retrain", "--gpu-id", "0",
                "--shard-spatial", "2"]
        (runs,) = bench_setup.rank_runs(
            2, [(_spatial_cli_rank, (argv, images), {})], "cuda", backend,
            SPATIAL["timeout"])
        for rank, run in enumerate(runs):
            if (run["steps"], run["validation_batches"]) != (per_epoch, 1):
                raise RuntimeError(f"spatial cli rank {rank}: {run['steps']} "
                                   f"steps, {run['validation_batches']} "
                                   f"validation batches")
            # The sharded steps and validation batches, then rank 0's
            # whole forwards of the held-out samples.
            sharded = _spatial_tail_launches(
                run["steps"], run["validation_batches"], CLI["size"],
                CLI["depth"])
            whole = _tail_launches("single", 0, _grids(run["text"]))
            _expect(run["launches"], {
                "render_fwdgrad": run["steps"],
                "render_fwd": run["validation_batches"],
                "sr_adam": run["steps"] * run["sr_adam_per_step"],
                **{k: sharded[k] + whole[k] for k in sharded}},
                f"spatial cli rank {rank}")
            if (not math.isfinite(run["last_loss"]) or "Spatial group: H "
                    "split over 2 rank(s)" not in run["text"]):
                raise RuntimeError(f"spatial cli rank {rank}: last loss "
                                   f"{run['last_loss']}")
        blob = torch.load(model_dir / "checkpoint.tar", map_location="cpu",
                          weights_only=True)
        meta = {k: blob.get(k) for k in ("upconv", "master_dtype", "epoch")}
        if meta != {"upconv": "fold", "master_dtype": "f32", "epoch": 0}:
            raise RuntimeError(f"spatial cli: checkpoint meta {meta}")
        fresh = build_model("single", False, CLI["depth"],
                            CLI["num_filters"], device="cuda", seed=1,
                            dtype=resolve_dtype("auto", "cuda"))
        _quiet(lambda: Checkpoint.load(model_dir).restore_params(fresh))
        # TF32 as the ranks' processes left it: torch's defaults.
        with _tf32(True, False):
            same = torch.equal(make_predict_fn(fresh)(images.cuda()).cpu(),
                               runs[0]["maps"])
        if not same:
            raise RuntimeError("spatial cli: a fresh model restored from the "
                               "checkpoint predicts otherwise than the "
                               "trained model")
    out = {"launches": [r["launches"] for r in runs],
           "step_ms_median": [r["step_ms_median"] for r in runs],
           "seconds": [r["seconds"] for r in runs],
           "last_loss": runs[0]["last_loss"], "meta": meta}
    log(f"spatial cli (--shard-spatial 2, the CLI's defaults, 1 epoch, "
        f"{per_epoch} steps) over {backend}: launches per rank "
        f"{[_nonzero(c) for c in out['launches']]}; median ms a step "
        f"{[round(v, 2) for v in out['step_ms_median']]}; checkpoint meta "
        f"{meta}; a fresh restored model predicts the same bits")
    return out


def phase_spatial(inputs) -> dict:
    """Phase 10: spatial H-sharding on the card (SPATIAL)."""
    from svbrdf_tpu_torch.parallel import dryrun
    from svbrdf_tpu_torch.utils import bench_setup

    card = _card()
    start = time.perf_counter()
    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= 2 else "gloo"
    steps, runs = SPATIAL["steps"], SPATIAL["runs"]
    program = dict(model_kind="single", loss_kind="mixed",
                   batch=MAIN["batch"], size=MAIN["size"],
                   depth=MAIN["depth"], num_filters=MAIN["num_filters"],
                   seed=0, device="cuda")
    small = dict(program, **DP_EXACT)
    memory = [dict(program, size=size, batch=batch)
              for size, batch in SPATIAL["memory"]]
    images = torch.rand((MAIN["batch"], 1, MAIN["size"], MAIN["size"], 3),
                        generator=torch.Generator().manual_seed(5))
    out = {"card": card, "backend": backend, "cards": n_cards,
           "offset_kernels": _spatial_offset_kernels(inputs)}
    torch.cuda.empty_cache()
    jobs = ([(bench_setup.spatial_train_steps, (program, steps), {}),
             (bench_setup.spatial_train_steps, (small, steps),
              {"cudnn": False}),
             (_spatial_eval_rank, (program, images, runs), {})]
            + [(bench_setup.spatial_train_steps,
                (p, SPATIAL["memory_steps"]), {}) for p in memory])
    t = time.perf_counter()
    two, two_small, two_eval, *two_memory = bench_setup.rank_runs(
        2, jobs, "cuda", backend, SPATIAL["timeout"])
    spawn_s = time.perf_counter() - t
    one, one_peak = _peak_bytes(lambda: bench_setup.train_steps(program,
                                                                steps))
    one_small = bench_setup.train_steps(small, steps, cudnn=False)
    one_memory = [_peak_bytes(lambda p=p: bench_setup.train_steps(
        p, SPATIAL["memory_steps"]))[1] for p in memory]
    with _tf32(False, False):
        prog = bench_setup.build_program(**program)
        one_eval = float(prog.eval_step(prog.raw))
        one_maps = prog.predict(images.cuda()).cpu()
        eval_ms = cuda_ms(lambda: prog.eval_step(prog.raw), runs, 1)
        predict_ms = cuda_ms(lambda: prog.predict(images.cuda()), runs, 1)
    del prog
    torch.cuda.empty_cache()

    checks = {}
    for name, run, ref, tol in (("full", two[0], one, DP_TOL),
                                ("32_cudnn_off", two_small[0], one_small,
                                 {"loss_rel_first": DP_TOL_EXACT["loss_rel"],
                                  **DP_TOL_EXACT})):
        rels = [abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                    ref["losses"])]
        update = _update_normwise(run, ref)
        checks[name] = {"loss_rel_first": rels[0], "loss_rel": max(rels),
                        "update_normwise": update}
        if (rels[0] > tol["loss_rel_first"] or max(rels) > tol["loss_rel"]
                or update > tol["update"]):
            raise RuntimeError(f"spatial world 2 {name}: first loss rel "
                               f"{rels[0]:g}, loss rel {max(rels):g}, update "
                               f"normwise {update:g}, over {tol}")
    for name, ranks, want in (
            ("train", two, {"render_fwdgrad": steps,
                            **_spatial_tail_launches(steps, 0,
                                                     MAIN["size"])}),
            ("train 32^2", two_small, {
                "render_fwdgrad": steps,
                **_spatial_tail_launches(steps, 0, DP_EXACT["size"],
                                         DP_EXACT["depth"])}),
            *((f"memory {s}^2 batch {b}", r,
               {"render_fwdgrad": SPATIAL["memory_steps"],
                **_spatial_tail_launches(SPATIAL["memory_steps"], 0, s)})
              for (s, b), r in zip(SPATIAL["memory"], two_memory))):
        if len(set(ranks[0]["checksums"])) != 1:
            raise RuntimeError(f"spatial world 2 {name}: replicas differ")
        for r, counts in enumerate(ranks[0]["launches"]):
            _expect(counts, want, f"spatial world 2 {name} rank {r}")
    whole = _spatial_tail_launches(0, 1, MAIN["size"])
    for r, e in enumerate(two_eval):
        _expect(e["eval_launches"], {"render_fwd": 1, **whole},
                f"spatial eval rank {r}")
        _expect(e["predict_launches"], whole, f"spatial predict rank {r}")
    eval_rel = abs(two_eval[0]["eval"] - one_eval) / abs(one_eval)
    maps_abs = float((two_eval[0]["maps"] - one_maps).abs().max())
    if eval_rel > DP_TOL["loss_rel_first"] or maps_abs > SPATIAL["maps_abs"]:
        raise RuntimeError(f"spatial eval loss rel {eval_rel:g}, predict "
                           f"maps max abs {maps_abs:g}")
    shared = backend == "gloo"
    ms = {"world2_train": statistics.median(two[0]["step_ms"][1:]),
          "world1_train": statistics.median(one["step_ms"][1:]),
          "world2_eval": two_eval[0]["eval_ms"], "world1_eval": eval_ms,
          "world2_predict": two_eval[0]["predict_ms"],
          "world1_predict": predict_ms}
    collectives = {"train_ms": two[0]["collective_ms"],
                   "train_calls": two[0]["collective_calls"],
                   "gradient_all_reduce_ms": two[0]["reduce_ms"],
                   "eval_ms": two_eval[0]["eval_collective_ms"],
                   "eval_calls": two_eval[0]["eval_collective_calls"],
                   "predict_ms": two_eval[0]["predict_collective_ms"],
                   "predict_calls": two_eval[0]["predict_collective_calls"]}
    peaks = {f"{s}x{s}_batch{b}": {"world2_per_rank": r[0]["peak_bytes"],
                                   "world1": p}
             for (s, b), r, p in zip(
                 SPATIAL["memory"], two_memory, one_memory)}
    peaks[f"{MAIN['size']}x{MAIN['size']}_batch{MAIN['batch']}"][
        "world1_5_steps"] = one_peak
    out.update(checks=checks, step_ms=ms, collectives=collectives,
               peak_bytes=peaks, eval_loss_rel=eval_rel,
               predict_maps_max_abs=maps_abs,
               launches={"train": two[0]["launches"],
                         "eval": [e["eval_launches"] for e in two_eval]},
               spawn_and_run_s=spawn_s)
    log(f"spatial [{card}] world 2 over {backend} ({n_cards} card(s)"
        + (", both ranks on cuda:0" if shared else "") + f"), f32, "
        f"{steps} steps vs world 1: full width first loss rel "
        f"{checks['full']['loss_rel_first']:.3g}, any "
        f"{checks['full']['loss_rel']:.3g}, update normwise "
        f"{checks['full']['update_normwise']:.3g} (DP_TOL); 32^2 cuDNN off "
        f"loss rel {checks['32_cudnn_off']['loss_rel']:.3g}, update "
        f"{checks['32_cudnn_off']['update_normwise']:.3g} (DP_TOL_EXACT); "
        f"eval loss rel {eval_rel:.3g}, predict maps max abs "
        f"{maps_abs:.3g}; replicas bit-identical; launches per rank train "
        f"{[_nonzero(c) for c in two[0]['launches']]}, eval "
        f"{[_nonzero(e['eval_launches']) for e in two_eval]}")
    log(f"spatial [{card}] ms (host clock, synced; train median of steps "
        f"2-{steps}, eval / predict median of {runs}): "
        + ", ".join(f"{k} {v:.2f}" for k, v in ms.items())
        + (" (both ranks share one card)" if shared else "")
        + "; collectives a call (host ms, synced on both sides): train "
        f"{collectives['train_ms']:.2f} in {collectives['train_calls']:.0f} "
        f"calls and the gradient all-reduce "
        f"{collectives['gradient_all_reduce_ms']:.2f} (reduce_gradients, "
        f"median of 5), eval {collectives['eval_ms']:.2f} in "
        f"{collectives['eval_calls']:.0f}, predict "
        f"{collectives['predict_ms']:.2f} in "
        f"{collectives['predict_calls']:.0f}")
    log(f"spatial [{card}] peak device memory (max_memory_allocated, f32, "
        f"{SPATIAL['memory_steps']} train steps): " + "; ".join(
            f"{k}: each rank of world 2 {v['world2_per_rank'] / 2**30:.3f} "
            f"GiB, one device {v['world1'] / 2**30:.3f} GiB"
            for k, v in peaks.items()))
    out["cli"] = _spatial_cli(backend, images[:2])
    if n_cards >= 2:
        out["dryrun_loss"] = dryrun.run_spatial(2, timeout=SPATIAL["timeout"])
    else:
        try:
            dryrun.run_spatial(2)
        except ValueError as e:
            out["dryrun"] = f"raises without a second card: {e}"
        else:
            raise RuntimeError("dryrun.run_spatial(2) ran on one card")
        log(f"spatial dryrun.run_spatial(2): {out['dryrun']}")
    out["seconds"] = time.perf_counter() - start
    log(f"spatial phase {out['seconds']:.1f} s")
    return out


# The block tail's kernels (csrc/norm_merge.cu): replace no TPU kernel (XLA
# fuses the tail in the JAX package, at the line named).
NORM_MERGE = {"name": "norm_merge", "route": "cuda",
              "source": "svbrdf_tpu_torch/csrc/norm_merge.cu",
              "replaces": "svbrdf_tpu/models/layers.py:194",
              "tpu_kernel": None}
# Configurations of the tails' timings: model, batch, activations' dtype.
NORM_MERGE_CONFIGS = {"single_bf16": ("single", 8, BF16),
                      "multi_bf16": ("multi", 8, BF16),
                      "predict_f32": ("single", 1, torch.float32)}
# GPU clock cycles torch.cuda._sleep spins before a timed sequence, so the
# host has queued all of it before the start event runs (~30 ms).
NORM_MERGE_SLEEP = 50_000_000


def _device_ms(fn, runs: int = 10) -> float:
    """Median device time of the launches fn() queues: a spin queued first
    keeps the card busy while the host queues them, so the events time the
    device work alone, not the host's."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(NORM_MERGE_SLEEP)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(statistics.median(times))


def _tail_bytes(case: tuple, size: int) -> tuple:
    """(forward, backward) bytes a tail must move, each value read or
    written once, activations `size` bytes a value: x in, out out where it
    is written; dout (and x with the norm) in, dx out where it is written;
    the per-plane vectors and the statistics."""
    b, c, h, w, norm, merge, tap, _ = case
    n, planes = b * c * h * w, b * c
    fwd = n * size * (2 if norm or merge else 1) + planes * (
        4 * (2 if norm else 1) + (size if merge else 0))
    bwd = 0
    if norm or tap or merge:
        bwd = n * size * (1 + norm + (norm or tap)) + planes * (
            4 * (2 * norm + tap) + (size if merge else 0) + 8 * norm)
    return fwd, bwd


def phase_norm_merge(rates: dict) -> dict:
    """The tail's kernels: held to the plain version at every tail of the
    three configurations (bench_setup.hold_tail_kernels); each
    configuration's tails timed together, forward and backward (device
    time), beside their byte bound and the plain version; registers and
    blocks per SM of every instance. Their launches are counted on every
    path that runs a model (_tail_launches)."""
    from svbrdf_tpu_torch.ops import norm_merge as nm
    from svbrdf_tpu_torch.utils import bench_setup

    start = time.perf_counter()
    out = {"checks": {}, "times": {}, "code": {}}
    for name, (kind, batch, dtype) in NORM_MERGE_CONFIGS.items():
        cases = bench_setup.tail_cases(kind, batch, MAIN["size"])
        holds = [bench_setup.hold_tail_kernels(c) for c in sorted(set(cases))]
        failed = {str(h["case"]): h["failed"] for h in holds if h["failed"]}
        worst = {k: max(h[k] if k in ("out", "mean") else h[k][0] / max(
            h[k][1], 1e-30) for h in holds if k in h)
            for k in ("out", "mean", "dx", "dw", "db", "dm")}
        out["checks"][name] = {"cases": len(holds), "failed": failed,
                               "worst": worst}
        log(f"norm_merge {name}: {len(holds)} tail shapes held; worst "
            f"forward rel {worst['out']:.2e} (tap {worst['mean']:.2e}), "
            f"gradients' distance over the plain version's: " + ", ".join(
                f"{k} {worst[k]:.3f}" for k in ("dx", "dw", "db", "dm"))
            + (f"; FAILED {failed}" if failed else ""))
        if failed:
            raise RuntimeError(f"norm_merge kernels off the plain version: "
                               f"{failed}")
        tails = []
        for c in cases:
            t = bench_setup.tail_inputs(c, 0)
            cast = {k: (v.to(dtype) if k != "g" else v) for k, v in t.items()}
            cast["stats"] = nm.norm_merge_fwd_cuda(
                cast["x"], cast.get("weight"), cast.get("bias"),
                cast.get("m"))[1]
            tails.append((c, cast))

        def forward():
            for _, t in tails:
                nm.norm_merge_fwd_cuda(t["x"], t.get("weight"),
                                       t.get("bias"), t.get("m"))

        def backward():
            for c, t in tails:
                norm = c[4]
                nm.norm_merge_bwd_cuda(
                    t["dout"], t.get("g"), t["x"] if norm else None,
                    t["stats"] if norm else None, t.get("weight"), c[5])

        def plain():
            for c, t in tails:
                leaves = {k: t[k].detach().requires_grad_()
                          for k in ("x", "weight", "bias", "m") if k in t}
                o, mean = nm.norm_merge_plain(
                    leaves["x"], leaves.get("weight"), leaves.get("bias"),
                    leaves.get("m"))
                outs, cots = [o], [t["dout"]]
                if c[6]:
                    outs.append(mean)
                    cots.append(t["g"])
                torch.autograd.grad(outs, list(leaves.values()), cots,
                                    allow_unused=True)

        size = torch.tensor([], dtype=dtype).element_size()
        fwd_bytes, bwd_bytes = map(sum, zip(*(_tail_bytes(c, size)
                                              for c in cases)))
        fwd_ms, bwd_ms = _device_ms(forward), _device_ms(backward)
        plain_ms = _device_ms(plain, runs=5)
        r = {"tails": len(cases), "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
             "fwd_bound_ms": fwd_bytes / rates["bytes"] * 1e3,
             "bwd_bound_ms": bwd_bytes / rates["bytes"] * 1e3,
             "plain_fwd_bwd_ms": plain_ms, "fwd_bytes": fwd_bytes,
             "bwd_bytes": bwd_bytes,
             "elements": sum(c[0] * c[1] * c[2] * c[3] for c in cases)}
        r["fwd_share"] = r["fwd_bound_ms"] / fwd_ms
        r["bwd_share"] = r["bwd_bound_ms"] / bwd_ms
        out["times"][name] = r
        log(f"norm_merge {name}: {len(cases)} tails, forward {fwd_ms:.4f} ms "
            f"(bound {r['fwd_bound_ms']:.4f} ms, bytes, "
            f"{100 * r['fwd_share']:.1f} %), backward {bwd_ms:.4f} ms "
            f"(bound {r['bwd_bound_ms']:.4f} ms, "
            f"{100 * r['bwd_share']:.1f} %); plain forward + backward "
            f"{plain_ms:.4f} ms")
        del tails
        torch.cuda.empty_cache()
    for direction in ("fwd", "bwd"):
        for dtype in (torch.float32, BF16):
            for mapping in nm.MAPPINGS:
                key = (f"{direction}_{'bf16' if dtype == BF16 else 'f32'}_"
                       f"{mapping}")
                out["code"][key] = nm.kernel_attributes(direction == "bwd",
                                                        dtype, mapping)
    log("norm_merge registers, blocks per SM: " + ", ".join(
        f"{k} {v['registers']}, {v['blocks_per_sm']}"
        for k, v in out["code"].items()))
    log(f"norm_merge phase {time.perf_counter() - start:.1f} s")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is False; it "
                 "needs an NVIDIA GPU")
    t0 = time.perf_counter()
    phase_device()
    name = torch.cuda.get_device_name(0)
    rates = card_rates(name)
    build_log = "".join(r["log"] for r in phase_build().values())
    from svbrdf_tpu_torch.utils.bench_setup import (build_program, loss_inputs,
                                                    loss_inputs_near)

    shape = (MAIN["batch"], MAIN["size"], MAIN["n_scenes"])
    input_sets = {}
    for suffix, dtype in (("", torch.float32), (" bf16", torch.bfloat16)):
        input_sets["loss_inputs" + suffix] = loss_inputs(*shape, dtype=dtype)
        input_sets["loss_inputs_near" + suffix] = loss_inputs_near(
            *shape, dtype=dtype)
    inputs, inputs_bf16 = input_sets["loss_inputs"], input_sets[
        "loss_inputs bf16"]
    errors = phase_kernels(input_sets)
    tails = phase_norm_merge(rates)
    sr_checks = phase_sr_adam()
    agreement_bf16 = phase_agreement()

    counts, steps_ms = {}, {"modes": {}}
    code = sr_adam_code(build_log)
    optimizer = {}
    for path, (kinds, dtype, master, _) in PATHS.items():
        # The f32 paths run with TF32 off (phase 1); the bf16 ones with
        # TF32 as torch sets it, as the CLI runs them.
        with (_tf32(True, False) if dtype == BF16
              else contextlib.nullcontext()):
            program = build_program(*kinds, MAIN["batch"], MAIN["size"],
                                    MAIN["depth"], MAIN["num_filters"],
                                    seed=0, device="cuda", dtype=dtype,
                                    master_dtype=master)
            counts[path] = phase_path(path, program)
            steps_ms[path] = step_times(path, program)
            if PATHS[path][2] == "bf16sr":
                optimizer[path] = optimizer_times(program, rates, code)
        del program
        torch.cuda.empty_cache()
    steps_ms["modes"] = mode_times()
    for path in ("single_mixed", "multi_rendering"):
        log(f"{path} train / eval ms by mode: " + "; ".join(
            f"{mode} {t['train_step']:.2f} / {t['eval_step']:.2f}"
            for mode, t in (
                ("f32", steps_ms[path]),
                ("tf32", steps_ms["modes"].get(f"{path}_tf32")),
                ("bf16_f32_masters",
                 steps_ms["modes"][f"{path}_bf16_f32_masters"]),
                ("bf16_bf16sr", steps_ms[f"{path}_bf16"])) if t))
    traced = {"agreement": phase_pathtrace_agreement(),
              "kernels": phase_pathtrace_kernels(rates, build_log)}
    traced["paths"] = phase_pathtrace_path()
    for path, run in traced["paths"].items():
        counts[path] = run["launches"]
        steps_ms[path] = run["steps_ms"]
    traced["stability"] = phase_stability()
    counts[TARGET_GRAD_PATH] = phase_target_grad(inputs)
    counts.update(phase_bf16_calls(inputs_bf16))
    times = kernel_times(inputs, inputs_bf16, rates)
    cli = phase_cli(steps_ms)
    dp = phase_data_parallel()
    tail = phase_tail(steps_ms, cli)
    spatial = phase_spatial(inputs)
    launcher = dp["launcher"]["launcher_world1"]["launches"]

    def dp_launches(name):
        """A kernel's launches on the data-parallel path: the launcher's
        world-1 run, and each rank's of world 2 (f32, bf16-SR)."""
        return {"launcher_world1": {k: v for k, v in launcher.items()
                                    if k in (name, name + "_bf16")},
                "world2_per_rank": {
                    mode: [{k: v for k, v in c.items()
                            if k in (name, name + "_bf16")} for c in runs]
                    for mode, runs in dp["world2"]["launches"].items()}}

    def spatial_launches(name):
        """A kernel's launches on the spatial path, each rank's: 5 f32
        train steps, an eval step, the CLI's 1-epoch run."""
        return {run: [c[name] for c in counts_by_rank] for run, counts_by_rank
                in (("train_per_rank", spatial["launches"]["train"]),
                    ("eval_per_rank", spatial["launches"]["eval"]),
                    ("cli_per_rank", spatial["cli"]["launches"]))}

    kernels = []
    for k in KERNELS:
        path, calls = KERNEL_PATH[k]
        launches = counts[path][k]
        bf16_path = KERNEL_PATH_BF16[k]
        kernels.append(dict(
            name=k, **KERNELS[k], path=path, launches=launches,
            launches_per_call=launches / calls,
            launches_by_dtype={"f32": launches,
                               "bf16": counts[bf16_path][k + "_bf16"]},
            bf16_path=bf16_path,
            max_abs_err=errors[k]["loss_inputs"]["max_abs_err"],
            loss_rel_err=errors[k]["loss_inputs"]["loss_rel_err"],
            checks=errors[k],
            ms=times[k]["ms"], wrapper_ms=times[k]["wrapper_ms"],
            plain_ms=times[k]["plain_ms"], bound_ms=times[k]["bound_ms"],
            bound_us=times[k]["bound_ms"] * 1e3,
            bound_by=times[k]["bound_by"],
            bound_parts_us=times[k]["bound_parts_us"],
            blocks_per_sm=times[k]["blocks_per_sm"], library_ms=None,
            bf16_ms=times[k]["bf16_ms"],
            bf16_bound_ms=times[k]["bf16_bound_ms"],
            bf16_bound_by=times[k]["bf16_bound_by"],
            bf16_blocks_per_sm=times[k]["bf16_blocks_per_sm"],
            bf16_launches={p: counts[p][k + "_bf16"] for p in BF16_PATHS},
            cli_launches={run: {"f32": c["launches"][k],
                                "bf16": c["launches"][k + "_bf16"]}
                          for run, c in cli["runs"].items()},
            data_parallel_launches=dp_launches(k),
            spatial_launches=spatial_launches(k),
            tail_cli_launches={"f32": tail["cli"]["launches"][k],
                               "bf16": tail["cli"]["launches"][k + "_bf16"]}))
    # sr_adam: launches from the bf16-SR main path; the times of one whole
    # optimizer step of that path's model (one launch a step).
    main_step = optimizer["single_mixed_bf16"]
    kernels.append(dict(
        **SR_ADAM, path="single_mixed_bf16",
        launches=counts["single_mixed_bf16"]["sr_adam"],
        launches_per_call=counts["single_mixed_bf16"]["sr_adam"] / STEPS,
        launches_by_path={p: counts[p]["sr_adam"]
                          for p in list(PATHS) + [TRACED_PATH]},
        max_abs_err=max(sr_checks["max_abs_err"], *(
            m["max_abs_err"] for m in sr_checks["models"].values())),
        checks=sr_checks,
        ms=main_step["ms"], wall_ms=main_step["wall_ms"],
        plain_ms=main_step["plain_ms"], bound_ms=main_step["bound_ms"],
        bound_us=main_step["bound_ms"] * 1e3,
        bound_by=main_step["bound_by"],
        bound_parts_us=main_step["bound_parts_us"],
        registers=code["registers"],
        sass_per_element={k: v["per_element"]
                          for k, v in code["loops"].items()},
        issue_us=main_step["issue_us"],
        optimizer_step=optimizer, library_ms=None,
        cli_launches={run: c["launches"]["sr_adam"]
                      for run, c in cli["runs"].items()},
        data_parallel_launches=dp_launches("sr_adam"),
        spatial_launches=spatial_launches("sr_adam"),
        tail_cli_launches=tail["cli"]["launches"]["sr_adam"],
        bf16_state_launches=sr_checks["bf16_state_launches"],
        bf16_state_code=code["bf16mu"]))
    # The path tracer's kernels: launches from the bf16-SR path-traced
    # path (the prediction's bf16 instantiation, the target's f32 one),
    # the errors of the full-width f32 case, the times at full width.
    pt_kernels = traced["kernels"]
    full = pt_kernels["checks"]["full_f32"]
    for k in PATHTRACE_KERNELS:
        by_path = {p: {"f32": counts[p][k], "bf16": counts[p][k + "_bf16"]}
                   for p in TRACED_PATHS}
        launches = sum(by_path[TRACED_PATH].values())
        t, t16 = pt_kernels["times"][k], pt_kernels["times"][k + "_bf16"]
        kernels.append(dict(
            name=k, **PATHTRACE_KERNELS[k], path=TRACED_PATH,
            launches=launches,
            launches_per_call=launches / (STEPS + 1),
            launches_by_dtype=by_path[TRACED_PATH],
            launches_by_path=by_path,
            max_abs_err=(full["render"]["max_abs_err"]
                         if k == "pathtrace_shade" else
                         max(v["max_abs_err"] for n, v in full.items()
                             if n != "render" and isinstance(v, dict))),
            checks=pt_kernels["checks"], zero=pt_kernels["zero"],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_us=t["bound_ms"] * 1e3, bound_by=t["bound_by"],
            bound_parts_us=t["bound_parts_us"],
            blocks_per_sm=t["blocks_per_sm"],
            registers=pt_kernels["registers"][k],
            code={i: c for i, c in pt_kernels["code"].items()
                  if i == k or i.startswith(k + "_")
                  and "vjp" not in i[len(k):]},
            library_ms=None,
            bf16_ms=t16["ms"], bf16_plain_ms=t16["plain_ms"],
            bf16_bound_ms=t16["bound_ms"], bf16_bound_by=t16["bound_by"],
            bf16_blocks_per_sm=t16["blocks_per_sm"],
            cli_launches={p: {"f32": cli["runs"][p]["launches"][k],
                              "bf16": cli["runs"][p]["launches"][k + "_bf16"]}
                          for p in TRACED_PATHS}))
    # The block tail's pair: launches (forward and backward) from the
    # bf16-SR main path's run and every other path's; the main paths' tails
    # timed together, their bound and share.
    nm_keys = ("norm_merge_fwd", "norm_merge_bwd")
    kernels.append(dict(
        **NORM_MERGE, path="single_mixed_bf16",
        launches=sum(counts["single_mixed_bf16"][k] for k in nm_keys),
        launches_by_path={p: {k: c[k] for k in nm_keys}
                          for p, c in counts.items()},
        cli_launches={run: {k: c["launches"][k] for k in nm_keys}
                      for run, c in cli["runs"].items()},
        data_parallel_launches={k: dp_launches(k) for k in nm_keys},
        spatial_launches={k: spatial_launches(k) for k in nm_keys},
        tail_cli_launches={k: tail["cli"]["launches"][k] for k in nm_keys},
        checks=tails["checks"], times=tails["times"], code=tails["code"],
        library_ms=None))
    steps_ms["agreement_bf16"] = agreement_bf16
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels, "steps_ms": steps_ms,
                      "cli": cli, "pathtrace": traced,
                      "data_parallel": dp, "tail": tail,
                      "spatial": spatial}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
