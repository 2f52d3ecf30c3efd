// StyleGAN2's styled-conv tail, forward and backward, one kernel each, for
// Hopper: the up-sampling conv's [1, 3, 3, 1] FIR, the demodulation, the
// bias, the noise, leaky ReLU 0.2 and the gain sqrt 2.
//
// Replaces no TPU kernel: the JAX package has no StyleGAN2. In eager
// PyTorch the tail of each of MaterialGAN's 13 styled convs
// (svbrdf_tpu_torch/ops/styled_tail.py, styled_tail_plain) ran as a
// depthwise conv for the FIR (ATen's generic kernel), two addcmul, leaky
// ReLU and a multiply forward, and about twice as many ops backward, each a
// full f32 pass over the activation. This pair runs each direction of a
// tail as one launch.
//
// What it computes, all in f32 (built with -fmad=false, ops/_build.py), for
// the output (B, C, H, W), t the conv's output, (H + 1, W + 1) for an
// up-sampling conv (a transposed conv of stride 2 gives 2h + 1) and (H, W)
// for a plain one:
//   forward:  y = t, or for an up conv the FIR with padding 1,
//             y[r, c] = sum_ab k[a] k[b] t[r + a - 1, c + b - 1], k = [1, 3,
//             3, 1] / 4 (zero outside t; the row pass, then the column pass);
//             pre = (bias[c] + y d[b, c]) + noise[b, r, c] strength;
//             out = (pre > 0 ? pre : 0.2 pre) sqrt 2; y is written for the
//             backward where asked (an up conv's; a plain conv's y is t).
//   backward: from the cotangent g, y, noise, d, bias and strength:
//             gpre = pre > 0 ? g sqrt 2 : (g sqrt 2) 0.2 (torch's
//             leaky_relu_backward, pre recomputed as above: a NaN pre
//             takes the 0.2 side);
//             grad_d[b, c] = sum_rc gpre y;
//             grad_bias[c] = sum_brc gpre;
//             grad_noise[b, r, c] = strength sum_c gpre;
//             grad_strength = sum_brc noise[b, r, c] sum_c gpre;
//             grad_t = gpre d, for an up conv the FIR's transpose of it,
//             grad_t[u, v] = sum_ab k[a] k[b] (gpre d)[u + a - 2, v + b - 2],
//             on the (H + 1, W + 1) grid.
//
// What bounds it on this card: bytes. A few FLOPs an element, far below the
// H100's ridge, so its least time is the bytes it must move: forward t read
// and out written, backward g and y (or t) read and grad_t written, the
// noise maps once. The design:
//   - a block takes a tile of up to 32 x 32 output pixels of one sample and
//     a group of up to 32 channels, and loops over the group's channels: the
//     noise of its pixels is read once into registers, and the backward's
//     channel sum for grad_noise stays in registers;
//   - the FIR runs from a shared-memory tile with its halo, one channel at a
//     time, a row pass and then a column pass (8 taps an output, not 16).
//     The forward writes the blurred y for the backward (one write more than
//     the plain conv's tail), so the backward's halo is only its own
//     transpose's (2 pixels), gpre recomputed on it from g and y;
//   - the reductions that cross blocks go through partials in a fixed
//     order, with no float atomics, so a run repeats to the bit: each
//     block's grad_d and grad_bias partials of its tile (a warp's by
//     shuffles, then the block's warps in order), its grad_noise partial of
//     its channel group and its grad_strength partial; the last block of a
//     (sample, channel group) to finish sums the tiles' partials in tile
//     order, the last of a (sample, tile) the groups' in group order, and
//     the last block of the grid grad_bias's samples in order and the
//     blocks' grad_strength partials in a fixed tree (an unsigned counter
//     each, zeroed before the launch). A single tile or group writes its
//     sums directly. A capture's generator is frozen, so its backward asks
//     for neither grad_bias nor grad_strength and pays nothing for them;
//   - the group narrows (32, 16, ... channels) until the grid gives every SM
//     four blocks, the planner in ops/styled_tail.py.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxItems = 4;  // pixels a thread: a tile holds at most 1024
constexpr float kSqrt2 = 1.41421356237309515f;
constexpr float kSlope = 0.2f;
constexpr float kTap0 = 0.25f;  // [1, 3, 3, 1] / 4
constexpr float kTap1 = 0.75f;

struct Args {
  const float* t;         // forward: the conv's output
  const float* g;         // backward: the output's cotangent
  const float* y;         // backward: the forward's y
  const float* d;         // (B, C)
  const float* bias;      // (C)
  const float* noise;     // (B, H, W)
  const float* strength;  // one value
  float* out;             // forward: (B, C, H, W)
  float* keep;            // forward: y, or null
  float* grad_t;          // backward: t's shape, or null
  float* grad_d;          // backward: (B, C), or null
  float* grad_bias;       // backward: (C), or null
  float* grad_noise;      // backward: (B, H, W), or null
  float* grad_strength;   // backward: one value, or null
  float* part_d;          // (tiles, B, C) where tiles > 1
  float* part_bias;       // (tiles, B, C) where tiles > 1
  float* bias_bc;         // (B, C): grad_bias's sums over H x W
  float* part_noise;      // (groups, B, H, W) where groups > 1
  float* part_strength;   // one a block
  unsigned* count_d;      // (B, groups)
  unsigned* count_noise;  // (B, tiles)
  unsigned* count_all;    // one
  int batch;
  int channels;
  int h;  // the output's
  int w;
  int up;
  int th;  // a tile's rows and columns
  int tw;
  int tiles_x;
  int tiles;
  int cg;  // channels a group
  int groups;
  int items;  // pixels a thread
};

// What a block takes: a sample, a tile (rows r0.., columns c0..) and the
// channels [c_begin, c_end).
struct Block {
  int b;
  int group;
  int tile;
  int r0;
  int c0;
  int c_begin;
  int c_end;
};

__device__ __forceinline__ Block block_of(const Args& a) {
  Block k;
  k.tile = static_cast<int>(blockIdx.x % a.tiles);
  const int rest = static_cast<int>(blockIdx.x / a.tiles);
  k.group = rest % a.groups;
  k.b = rest / a.groups;
  k.r0 = (k.tile / a.tiles_x) * a.th;
  k.c0 = (k.tile % a.tiles_x) * a.tw;
  k.c_begin = k.group * a.cg;
  k.c_end = min(k.c_begin + a.cg, a.channels);
  return k;
}

__device__ __forceinline__ float taps(float q0, float q1, float q2, float q3) {
  return ((kTap0 * q0 + kTap1 * q1) + kTap1 * q2) + kTap0 * q3;
}

// The tail's pre-activation: the plain version's two addcmul.
__device__ __forceinline__ float pre_of(float y, float d, float bias,
                                        float noise, float strength) {
  const float yd = y * d;
  const float biased = bias + yd;
  const float scaled = noise * strength;
  return biased + scaled;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// p[0] + p[stride] + ... + p[(n - 1) stride], added in that order (from
// -0, which leaves the first term as it is), the loads of each run of 8
// issued together: another block's partials, read past L1.
__device__ __forceinline__ float sum_in_order(const float* p,
                                              long long stride, int n) {
  float v = -0.f;
  int i = 0;
  for (; i + 8 <= n; i += 8) {
    float q[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) q[j] = __ldcg(p + (i + j) * stride);
#pragma unroll
    for (int j = 0; j < 8; ++j) v += q[j];
  }
  for (; i < n; ++i) v += __ldcg(p + i * stride);
  return v;
}

__global__ void __launch_bounds__(kMaxThreads)
    styled_tail_fwd_kernel(Args a) {
  extern __shared__ float smem[];
  const Block k = block_of(a);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int pixels = a.th * a.tw;
  const int hin = a.h + a.up, win = a.w + a.up;
  const float strength = *a.strength;
  float nz[kMaxItems];
#pragma unroll
  for (int i = 0; i < kMaxItems; ++i) {
    const int p = tid + i * nt;
    const int r = k.r0 + p / a.tw, c = k.c0 + p % a.tw;
    nz[i] = (i < a.items && p < pixels && r < a.h && c < a.w)
                ? a.noise[(static_cast<long long>(k.b) * a.h + r) * a.w + c]
                : 0.f;
  }
  // Up conv: the tile of t with its halo (rows r0 - 1 .., th + 3 of them),
  // then its row pass (th + 3 rows of tw).
  const int hr = a.th + 3, hc = a.tw + 3;
  float* s_t = smem;
  float* s_h = smem + hr * hc;
  for (int ch = k.c_begin; ch < k.c_end; ++ch) {
    const long long plane = static_cast<long long>(k.b) * a.channels + ch;
    const float dv = a.d[plane], bv = a.bias[ch];
    if (a.up) {
      const float* tp = a.t + plane * hin * win;
      for (int i = tid; i < hr * hc; i += nt) {
        const int r = k.r0 - 1 + i / hc, c = k.c0 - 1 + i % hc;
        s_t[i] = (r >= 0 && r < hin && c >= 0 && c < win)
                     ? tp[static_cast<long long>(r) * win + c]
                     : 0.f;
      }
      __syncthreads();
      for (int i = tid; i < hr * a.tw; i += nt) {
        const float* q = s_t + (i / a.tw) * hc + i % a.tw;
        s_h[i] = taps(q[0], q[1], q[2], q[3]);
      }
      __syncthreads();
    }
    const long long base = plane * a.h * a.w;
#pragma unroll
    for (int i = 0; i < kMaxItems; ++i) {
      const int p = tid + i * nt;
      if (i >= a.items || p >= pixels) break;
      const int py = p / a.tw, px = p % a.tw;
      const int r = k.r0 + py, c = k.c0 + px;
      if (r >= a.h || c >= a.w) continue;
      const long long at = base + static_cast<long long>(r) * a.w + c;
      float y;
      if (a.up) {
        const float* q = s_h + py * a.tw + px;
        y = taps(q[0], q[a.tw], q[2 * a.tw], q[3 * a.tw]);
        if (a.keep != nullptr) a.keep[at] = y;
      } else {
        y = a.t[at];
      }
      const float pre = pre_of(y, dv, bv, nz[i], strength);
      a.out[at] = (pre > 0.f ? pre : pre * kSlope) * kSqrt2;
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    styled_tail_bwd_kernel(Args a) {
  extern __shared__ float smem[];
  __shared__ int s_last[3];
  const Block k = block_of(a);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warps = nt / 32, warp = tid / 32, lane = tid % 32;
  const int pixels = a.th * a.tw;
  const int hin = a.h + a.up, win = a.w + a.up;
  const bool want_t = a.grad_t != nullptr;
  const bool want_d = a.grad_d != nullptr;
  const bool want_bias = a.grad_bias != nullptr;
  const bool want_noise = a.grad_noise != nullptr;
  const bool want_strength = a.grad_strength != nullptr;
  const bool fir = a.up && want_t;
  const float strength = *a.strength;
  const long long noise_base = static_cast<long long>(k.b) * a.h * a.w;
  float nz[kMaxItems], nsum[kMaxItems];
#pragma unroll
  for (int i = 0; i < kMaxItems; ++i) {
    const int p = tid + i * nt;
    const int r = k.r0 + p / a.tw, c = k.c0 + p % a.tw;
    nz[i] = (i < a.items && p < pixels && r < a.h && c < a.w)
                ? a.noise[noise_base + static_cast<long long>(r) * a.w + c]
                : 0.f;
    nsum[i] = 0.f;
  }
  // Shared memory: the warps' partials of grad_d and of grad_bias (cg x
  // warps each) and of grad_strength (warps), then for the FIR's transpose
  // the tile of gpre d with its halo (rows r0 - 2 .., th + 4 of them, tw + 4
  // columns) and its row pass (th + 4 rows of tw + 1).
  float* s_acc = smem;
  float* s_bias = s_acc + a.cg * warps;
  float* s_strength = s_bias + a.cg * warps;
  const int hr = a.th + 4, hc = a.tw + 4, ho = a.tw + 1;
  float* s_gy = s_strength + warps;
  float* s_h = s_gy + hr * hc;
  // The grad_t rows and columns this block writes: its tile's, and the
  // last row (column) of t's grid in the last tile row (column).
  const int rows_out = min(a.th, a.h - k.r0) + (k.r0 + a.th >= a.h ? 1 : 0);
  const int cols_out = min(a.tw, a.w - k.c0) + (k.c0 + a.tw >= a.w ? 1 : 0);

  for (int ch = k.c_begin; ch < k.c_end; ++ch) {
    const long long plane = static_cast<long long>(k.b) * a.channels + ch;
    const float dv = a.d[plane], bv = a.bias[ch];
    const long long base = plane * a.h * a.w;
    float dprod = 0.f, gsum = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxItems; ++i) {
      const int p = tid + i * nt;
      if (i >= a.items || p >= pixels) break;
      const int py = p / a.tw, px = p % a.tw;
      const int r = k.r0 + py, c = k.c0 + px;
      float gy = 0.f;
      if (r < a.h && c < a.w) {
        const long long at = base + static_cast<long long>(r) * a.w + c;
        const float yv = a.y[at];
        const float pre = pre_of(yv, dv, bv, nz[i], strength);
        const float gs = a.g[at] * kSqrt2;
        const float gp = pre > 0.f ? gs : gs * kSlope;
        nsum[i] += gp;
        dprod += gp * yv;
        gsum += gp;
        gy = gp * dv;
        if (want_t && !a.up) {
          a.grad_t[at] = gy;
        }
      }
      if (fir) s_gy[(py + 2) * hc + px + 2] = gy;
    }
    if (want_d) {
      dprod = warp_sum(dprod);
      if (lane == 0) s_acc[(ch - k.c_begin) * warps + warp] = dprod;
    }
    if (want_bias) {
      gsum = warp_sum(gsum);
      if (lane == 0) s_bias[(ch - k.c_begin) * warps + warp] = gsum;
    }
    if (!fir) continue;
    // The halo's ring (two rows above and below, two columns either side):
    // gpre d recomputed from g and y, 0 outside the output.
    const int ring = hr * hc - pixels;
    for (int i = tid; i < ring; i += nt) {
      int sr, sc;
      if (i < 2 * hc) {
        sr = i / hc;
        sc = i % hc;
      } else if (i < 4 * hc) {
        sr = a.th + 2 + (i - 2 * hc) / hc;
        sc = (i - 2 * hc) % hc;
      } else {
        const int j = i - 4 * hc;
        sr = 2 + j / 4;
        sc = j % 4 < 2 ? j % 4 : a.tw + j % 4;
      }
      const int r = k.r0 - 2 + sr, c = k.c0 - 2 + sc;
      float gy = 0.f;
      if (r >= 0 && r < a.h && c >= 0 && c < a.w) {
        const long long at = base + static_cast<long long>(r) * a.w + c;
        const float pre = pre_of(a.y[at], dv, bv,
                                 a.noise[noise_base +
                                         static_cast<long long>(r) * a.w + c],
                                 strength);
        const float gs = a.g[at] * kSqrt2;
        gy = (pre > 0.f ? gs : gs * kSlope) * dv;
      }
      s_gy[sr * hc + sc] = gy;
    }
    __syncthreads();
    for (int i = tid; i < hr * ho; i += nt) {
      const float* q = s_gy + (i / ho) * hc + i % ho;
      s_h[i] = taps(q[0], q[1], q[2], q[3]);
    }
    __syncthreads();
    float* gt = a.grad_t + plane * hin * win;
    for (int i = tid; i < rows_out * cols_out; i += nt) {
      const int oy = i / cols_out, ox = i % cols_out;
      const float* q = s_h + oy * ho + ox;
      gt[static_cast<long long>(k.r0 + oy) * win + k.c0 + ox] =
          taps(q[0], q[ho], q[2 * ho], q[3 * ho]);
    }
  }

  // The block's sums: grad_d's and grad_bias's over its tile, a channel's
  // warps in order; grad_noise's over its channel group; grad_strength's,
  // sum noise (sum_c gpre), over its tile and group, the warps in order.
  const bool split_c = (want_d || want_bias) && a.tiles > 1;
  const bool split_noise = want_noise && a.groups > 1;
  const long long bc_count = static_cast<long long>(a.batch) * a.channels;
  if (want_d || want_bias) {
    __syncthreads();
    for (int cl = tid; cl < k.c_end - k.c_begin; cl += nt) {
      const long long bc = static_cast<long long>(k.b) * a.channels +
                           k.c_begin + cl;
      const long long part = k.tile * bc_count + bc;
      if (want_d) {
        float v = s_acc[cl * warps];
        for (int w = 1; w < warps; ++w) v += s_acc[cl * warps + w];
        (split_c ? a.part_d[part] : a.grad_d[bc]) = v;
      }
      if (want_bias) {
        float v = s_bias[cl * warps];
        for (int w = 1; w < warps; ++w) v += s_bias[cl * warps + w];
        (split_c ? a.part_bias[part] : a.bias_bc[bc]) = v;
      }
    }
  }
  if (want_noise) {
#pragma unroll
    for (int i = 0; i < kMaxItems; ++i) {
      const int p = tid + i * nt;
      if (i >= a.items || p >= pixels) break;
      const int r = k.r0 + p / a.tw, c = k.c0 + p % a.tw;
      if (r >= a.h || c >= a.w) continue;
      const long long at = noise_base + static_cast<long long>(r) * a.w + c;
      if (split_noise) {
        a.part_noise[static_cast<long long>(k.group) * a.batch * a.h * a.w +
                     at] = nsum[i];
      } else {
        a.grad_noise[at] = strength * nsum[i];
      }
    }
  }
  if (want_strength) {
    // Pixels outside the tile or the output hold 0 in both.
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxItems; ++i) v += nz[i] * nsum[i];
    v = warp_sum(v);
    if (lane == 0) s_strength[warp] = v;
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < warps; ++w) v += s_strength[w];
      a.part_strength[blockIdx.x] = v;
    }
  }

  // The last block of a (sample, group) adds the tiles' grad_d and grad_bias
  // partials, the last of a (sample, tile) the groups' grad_noise partials,
  // each in order.
  if (split_c || split_noise) {
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      s_last[0] = split_c &&
                  atomicAdd(a.count_d + k.b * a.groups + k.group, 1u) ==
                      static_cast<unsigned>(a.tiles - 1);
      s_last[1] = split_noise &&
                  atomicAdd(a.count_noise + k.b * a.tiles + k.tile, 1u) ==
                      static_cast<unsigned>(a.groups - 1);
    }
    __syncthreads();
    if (s_last[0] || s_last[1]) __threadfence();
    if (s_last[0]) {
      for (int cl = tid; cl < k.c_end - k.c_begin; cl += nt) {
        const long long bc = static_cast<long long>(k.b) * a.channels +
                             k.c_begin + cl;
        if (want_d) {
          a.grad_d[bc] = sum_in_order(a.part_d + bc, bc_count, a.tiles);
        }
        if (want_bias) {
          a.bias_bc[bc] = sum_in_order(a.part_bias + bc, bc_count, a.tiles);
        }
      }
    }
    if (s_last[1]) {
      const long long stride = static_cast<long long>(a.batch) * a.h * a.w;
#pragma unroll
      for (int i = 0; i < kMaxItems; ++i) {
        const int p = tid + i * nt;
        if (i >= a.items || p >= pixels) break;
        const int r = k.r0 + p / a.tw, c = k.c0 + p % a.tw;
        if (r >= a.h || c >= a.w) continue;
        const long long at = noise_base + static_cast<long long>(r) * a.w + c;
        a.grad_noise[at] =
            strength * sum_in_order(a.part_noise + at, stride, a.groups);
      }
    }
  }
  if (!want_bias && !want_strength) return;

  // The last block of the grid adds grad_bias's (sample, channel) sums over
  // the samples, and grad_strength's block partials: thread j the blocks j,
  // j + threads, .. in order, then the warps' shuffles and the warps in
  // order.
  __threadfence();
  __syncthreads();
  const int blocks = a.batch * a.groups * a.tiles;
  if (tid == 0) {
    s_last[2] = atomicAdd(a.count_all, 1u) ==
                static_cast<unsigned>(blocks - 1);
  }
  __syncthreads();
  if (!s_last[2]) return;
  __threadfence();
  if (want_bias) {
    for (int ch = tid; ch < a.channels; ch += nt) {
      a.grad_bias[ch] = sum_in_order(a.bias_bc + ch, a.channels, a.batch);
    }
  }
  if (want_strength) {
    float v = 0.f;
    for (int j = tid; j < blocks; j += nt) v += __ldcg(a.part_strength + j);
    v = warp_sum(v);
    if (lane == 0) s_strength[warp] = v;
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < warps; ++w) v += s_strength[w];
      *a.grad_strength = v;
    }
  }
}

// Makes `device` current for the launch and puts the caller's back.
struct DeviceScope {
  int previous = -1;
  explicit DeviceScope(int device) {
    cudaGetDevice(&previous);
    if (previous != device) {
      cudaSetDevice(device);
    } else {
      previous = -1;
    }
  }
  ~DeviceScope() {
    if (previous >= 0) cudaSetDevice(previous);
  }
};

// The plan's derived sizes; false where the plan cannot be launched.
bool fill_plan(Args& a, int batch, int channels, int h, int w, int up, int th,
               int tw, int cg, int threads) {
  if (batch <= 0 || channels <= 0 || h <= 0 || w <= 0 || th <= 0 ||
      tw <= 0 || cg <= 0 || threads <= 0 || threads > kMaxThreads ||
      threads % 32 != 0) {
    return false;
  }
  a.batch = batch;
  a.channels = channels;
  a.h = h;
  a.w = w;
  a.up = up ? 1 : 0;
  a.th = th;
  a.tw = tw;
  a.tiles_x = (w + tw - 1) / tw;
  a.tiles = a.tiles_x * ((h + th - 1) / th);
  a.cg = cg;
  a.groups = (channels + cg - 1) / cg;
  a.items = (th * tw + threads - 1) / threads;
  return a.items <= kMaxItems &&
         static_cast<long long>(batch) * a.groups * a.tiles <= 0x7FFFFFFFLL;
}

int launch(void (*kernel)(Args), const Args& a, int threads, size_t smem,
           cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(a.batch * a.groups * a.tiles);
  kernel<<<blocks, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The forward of a tail on `stream` of `device`: t (B, C, H + up, W + up),
// d (B, C), bias (C), noise (B, H, W), strength (one value), all f32 and
// contiguous; out (B, C, H, W), and keep (y, (B, C, H, W)) where not null.
// The plan: tiles of th x tw output pixels, cg channels a block, `threads`
// threads a block (a multiple of 32, at most 256, th * tw at most 4 times
// it). Returns the CUDA error of the launch (0: launched).
int svbrdf_styled_tail_fwd(const float* t, const float* d, const float* bias,
                           const float* noise, const float* strength,
                           float* out, float* keep, int batch, int channels,
                           int h, int w, int up, int th, int tw, int cg,
                           int threads, int device, void* stream) {
  Args a = {};
  if (!fill_plan(a, batch, channels, h, w, up, th, tw, cg, threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceScope scope(device);
  a.t = t;
  a.d = d;
  a.bias = bias;
  a.noise = noise;
  a.strength = strength;
  a.out = out;
  a.keep = up ? keep : nullptr;
  const size_t smem =
      up ? sizeof(float) * (th + 3) * (2 * tw + 3) : 0;
  return launch(styled_tail_fwd_kernel, a, threads, smem,
                static_cast<cudaStream_t>(stream));
}

// The backward on `stream` of `device`, from g (the output's cotangent) and
// the forward's y (B, C, H, W), d, bias, noise and strength: grad_t (t's
// shape), grad_d (B, C), grad_bias (C), grad_noise (B, H, W) and
// grad_strength (one value), each written where not null. `scratch` holds
// `scratch_floats` f32, at least what the wanted gradients need, in this
// order: where grad_d is wanted and the plan has more than one tile, its
// partials (tiles x B x C); likewise grad_bias's; where grad_bias is wanted,
// its (B, C) sums; where grad_noise is wanted and the plan has more than
// one group, its partials (groups x B x H x W); where grad_strength is
// wanted, one a block (B x groups x tiles); then, where any of these is
// there, the blocks' counters (B x groups + B x tiles + 1 unsigned), zeroed
// here before the launch. The plan as the forward's.
int svbrdf_styled_tail_bwd(const float* g, const float* y, const float* d,
                           const float* bias, const float* noise,
                           const float* strength, float* grad_t,
                           float* grad_d, float* grad_bias, float* grad_noise,
                           float* grad_strength, float* scratch,
                           long long scratch_floats, int batch, int channels,
                           int h, int w, int up, int th, int tw, int cg,
                           int threads, int device, void* stream) {
  Args a = {};
  if (!fill_plan(a, batch, channels, h, w, up, th, tw, cg, threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (grad_t == nullptr && grad_d == nullptr && grad_bias == nullptr &&
      grad_noise == nullptr && grad_strength == nullptr) {
    return 0;
  }
  DeviceScope scope(device);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  a.g = g;
  a.y = y;
  a.d = d;
  a.bias = bias;
  a.noise = noise;
  a.strength = strength;
  a.grad_t = grad_t;
  a.grad_d = grad_d;
  a.grad_bias = grad_bias;
  a.grad_noise = grad_noise;
  a.grad_strength = grad_strength;
  const long long bc = static_cast<long long>(batch) * channels;
  const bool split_c = (grad_d != nullptr || grad_bias != nullptr) &&
                       a.tiles > 1;
  const bool split_noise = grad_noise != nullptr && a.groups > 1;
  if (split_c || split_noise || grad_bias != nullptr ||
      grad_strength != nullptr) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    long long used = 0;
    auto take = [&](long long n) { return scratch + (used += n) - n; };
    if (split_c && grad_d != nullptr) a.part_d = take(a.tiles * bc);
    if (split_c && grad_bias != nullptr) a.part_bias = take(a.tiles * bc);
    if (grad_bias != nullptr) a.bias_bc = take(bc);
    if (split_noise) {
      a.part_noise = take(static_cast<long long>(a.groups) * batch * h * w);
    }
    if (grad_strength != nullptr) {
      a.part_strength =
          take(static_cast<long long>(batch) * a.groups * a.tiles);
    }
    const long long counters =
        static_cast<long long>(batch) * (a.groups + a.tiles) + 1;
    a.count_d = reinterpret_cast<unsigned*>(take(counters));
    a.count_noise = a.count_d + static_cast<long long>(batch) * a.groups;
    a.count_all = a.count_noise + static_cast<long long>(batch) * a.tiles;
    if (used > scratch_floats) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t err =
        cudaMemsetAsync(a.count_d, 0, sizeof(unsigned) * counters, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int warps = threads / 32;
  const size_t smem =
      sizeof(float) *
      (static_cast<size_t>(2 * cg + 1) * warps +
       (up && grad_t != nullptr ? (th + 4) * (2 * tw + 5) : 0));
  return launch(styled_tail_bwd_kernel, a, threads, smem, st);
}

}  // extern "C"
