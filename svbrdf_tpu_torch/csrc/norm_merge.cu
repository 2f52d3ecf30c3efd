// The U-Net block's tail, forward and backward, one kernel each, for Hopper:
// the pre-norm channel-mean tap, the optional InstanceNorm with its affine,
// and the merge of the global track's projected vector.
//
// Replaces no TPU kernel: the JAX package leaves this tail to XLA, which
// fuses it (svbrdf_tpu/models/layers.py). In eager PyTorch the same tail
// (svbrdf_tpu_torch/ops/norm_merge.py, norm_merge_plain) runs as about 17
// ops forward and as many backward, each a launch with its host dispatch
// and most of them a full f32 pass over the activation; with 16 tails in a
// U-Net (20 in the multi-view model) they were a large share of a train
// step's launches and of its device time. This pair runs each direction of
// a tail as one launch.
//
// What it computes, per (row, channel) plane of n = H * W values, all
// arithmetic in f32 in the plain version's order of ops (built with
// -fmad=false, ops/_build.py), T the activations' dtype (f32 or bf16):
//   forward:  mu = (sum x) / n, the tap, returned; with the norm
//             var = max((sum x^2) / n - mu^2, 0) (a NaN stays NaN),
//             rstd = rsqrt(var + eps),
//             y = round_T(((x - mu) * rstd) * w + b), w and b upcast;
//             with a merge vector m: out = round_T(y + m); mu and rstd are
//             kept for the backward.
//   backward: from dout, the tap's cotangent g (where it has one), x, mu
//             and rstd, with xh = (x - mu) * rstd and dy = dout:
//             with the norm dx = round_T(rstd * w * ((dy - sum(dy) / n)
//             - xh * sum(dy * xh) / n) + g / n), and sum(dy * xh) and
//             sum(dy) per plane (dw's and db's partials, which torch.sum
//             adds over the batch: no float atomics); without it dx =
//             round_T(dy + g / n) (with no g, dx is dout and nothing is
//             written); with a merge vector its cotangent round_T(sum dy).
//
// What bounds it on this card: bytes. It does a few FLOPs per element, far
// below the H100's ridge of about 295 bf16 operations a byte, so its least
// time is the bytes it must move: in bf16, x read and out written forward
// (4 bytes an element), dout and x read and dx written backward (6). The
// design:
//   - one pass takes sum x and sum x^2 together: the tap and the norm share
//     one mean, which the plain version computes twice;
//   - the second pass (normalise, affine, merge; or the backward's dx)
//     reads a block's share again, from the L1 and L2 caches: a share is at
//     most 8192 values where the cluster size allows (16 KB in bf16), so the
//     blocks in flight hold far less than the 50 MB L2; tails without a norm
//     take a single pass;
//   - the mapping follows what the launch sees, with no knob. NCHW planes
//     of up to 1024 values take one warp each, eight a block (the innermost
//     blocks have thousands of 1-, 4- and 16-value planes); larger planes a
//     block of 256 threads, or, where a plane is larger than 8192 values or
//     there are too few planes to give every SM four blocks (a batch-1
//     forward at 256^2), a cluster of up to 8 blocks whose partial sums meet
//     in distributed shared memory: no second launch, no atomics, and every
//     block of a cluster adds the partials in rank order, so all see one
//     total. Channels-last tensors (the encoder's conv outputs: the images
//     come NHWC and cuDNN keeps the layout) take a block a group of 16 to 64
//     channels of a row, each thread 8 channels of one pixel at a time, so a
//     warp's loads are whole 32-byte sectors; the group narrows until the
//     groups and clusters give every SM four blocks;
//   - 16-byte loads and stores (8 bf16, or two float4) wherever the layout
//     allows; a scalar loop otherwise (planes of 1, 4 or 9 channels, a
//     cotangent whose layout differs from x's).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;                 // values of one 16-byte step in bf16
constexpr long long kWarpPlane = 1024;  // planes up to this take one warp
constexpr int kMaxCluster = 8;          // the portable cluster size
constexpr int kBlocksPerSm = 4;         // what clusters aim to fill
constexpr int kChunk = 8192;            // values a block aims to take
constexpr int kMaxGroup = 64;           // channels of a column block, at most

// The mappings of planes onto the card.
constexpr int kPlaneWarp = 0;   // a warp a plane, eight planes a block
constexpr int kPlaneBlock = 1;  // a block (or a cluster) a plane
constexpr int kColumns = 2;     // channels last: a block (or a cluster) a
                                // group of 16 to 64 channels of a row, a
                                // thread 8 channels

// Bits of the launches' flags.
constexpr int kBf16 = 1;       // x, out, m, dout, dx and dm in bf16
constexpr int kParamBf16 = 2;  // w and b in bf16
constexpr int kNorm = 4;       // InstanceNorm with its affine
constexpr int kMerge = 8;      // a merge vector (backward: its cotangent)
constexpr int kTap = 16;       // backward: the tap's cotangent is given

// A tensor's strides, in values: between rows, channels and a plane's
// pixels (H and W merged: a plane's pixels are one stride apart).
struct Strides {
  long long row;
  long long chan;
  long long pixel;
};

struct FwdArgs {
  const void* x;  // out has x's strides
  Strides xs;
  const void* w;
  const void* b;
  const void* m;
  void* out;
  float* mean;
  float* rstd;
  long long planes;
  int channels;
  int n;        // values a plane
  int cluster;  // blocks a plane (block mapping)
  int vecs;     // channel vectors a block (channels-last mapping)
  int flags;
  int vec;
  float inv_n;
  float eps;
};

struct BwdArgs {
  const void* dout;
  Strides ds;
  const float* g;
  long long g_row;
  const void* x;
  Strides xs;
  const float* mean;
  const float* rstd;
  const void* w;
  void* dx;
  Strides dxs;
  void* dm;
  float* dw;  // sum(dy * xh) a plane
  float* db;  // sum(dy) a plane
  long long planes;
  int channels;
  int n;
  int cluster;
  int vecs;
  int flags;
  int vec;
  float inv_n;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// v rounded to T, as f32.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (sizeof(T) == 2) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

__device__ __forceinline__ float param(const void* p, bool bf16, int c) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c])
              : static_cast<const float*>(p)[c];
}

// U values at p: a 16-byte aligned vector when U == kVec, else one value.
template <int U>
__device__ __forceinline__ void load(const float* p, float (&v)[U]) {
  if constexpr (U == kVec) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    v[0] = *p;
  }
}

template <int U>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[U]) {
  if constexpr (U == kVec) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  } else {
    v[0] = __bfloat162float(*p);
  }
}

// U values to p, each rounded to the pointer's type (exact for values that
// are already rounded to it).
template <int U>
__device__ __forceinline__ void store(float* p, const float (&v)[U]) {
  if constexpr (U == kVec) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    *p = v[0];
  }
}

template <int U>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[U]) {
  if constexpr (U == kVec) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    }
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// The units (vectors, or single values) of a plane that one thread visits:
// first, first + step, ... below end; `lead` writes the plane's results.
struct Span {
  long long plane;  // -1: past the last plane (warp mapping)
  int first;
  int end;
  int step;
  bool lead;
};

template <bool kWarp>
__device__ __forceinline__ Span span_of(long long planes, int units,
                                        int cluster) {
  Span s;
  if constexpr (kWarp) {
    const int lane = threadIdx.x & 31;
    s.plane = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
    if (s.plane >= planes) s.plane = -1;
    s.first = lane;
    s.end = units;
    s.step = 32;
    s.lead = lane == 0;
  } else {
    // A cluster's blocks are consecutive in x: its rank is blockIdx.x's
    // remainder, and it takes the rank-th of `cluster` equal chunks.
    const int rank = static_cast<int>(blockIdx.x % cluster);
    s.plane = blockIdx.x / cluster;
    const int chunk = (units + cluster - 1) / cluster;
    const int lo = rank * chunk;
    s.first = lo + static_cast<int>(threadIdx.x);
    s.end = min(lo + chunk, units);
    s.step = kThreads;
    s.lead = threadIdx.x == 0 && rank == 0;
  }
  return s;
}

__device__ __forceinline__ void warp_sum(float (&s)[2]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s[0] += __shfl_xor_sync(0xffffffffu, s[0], off);
    s[1] += __shfl_xor_sync(0xffffffffu, s[1], off);
  }
}

// The plane's two totals in every thread: within a warp, then over the
// block's warps in order, then over the cluster's blocks in rank order.
// Every thread of the block (and of its cluster) must call it.
template <bool kWarp>
__device__ __forceinline__ void plane_sum(float (&s)[2], int cluster) {
  warp_sum(s);
  if constexpr (!kWarp) {
    __shared__ float red[kWarps][2];
    __shared__ float part[2];
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      red[warp][0] = s[0];
      red[warp][1] = s[1];
    }
    __syncthreads();
    s[0] = red[0][0];
    s[1] = red[0][1];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      s[0] += red[w][0];
      s[1] += red[w][1];
    }
    if (cluster > 1) {
      cg::cluster_group cl = cg::this_cluster();
      if (threadIdx.x == 0) {
        part[0] = s[0];
        part[1] = s[1];
      }
      cl.sync();
      const float* q = cl.map_shared_rank(part, 0);
      s[0] = q[0];
      s[1] = q[1];
      for (int r = 1; r < cluster; ++r) {
        q = cl.map_shared_rank(part, r);
        s[0] += q[0];
        s[1] += q[1];
      }
      // No block leaves while another still reads its partials.
      cl.sync();
    }
  }
}

// The planes' forward, U values a step: kVec (16-byte vectors) or 1.
template <typename T, bool kWarp, int U>
__device__ __forceinline__ void planes_fwd(const FwdArgs& a) {
  const Span s = span_of<kWarp>(a.planes, a.n / U, a.cluster);
  if (kWarp && s.plane < 0) return;
  const bool norm = a.flags & kNorm;
  const bool merge = a.flags & kMerge;
  const long long row = s.plane / a.channels;
  const int c = static_cast<int>(s.plane % a.channels);
  const long long base = row * a.xs.row + c * a.xs.chan;
  const long long step = a.xs.pixel;  // 1 wherever U == kVec
  const T* x = static_cast<const T*>(a.x) + base;
  T* out = static_cast<T*>(a.out) + base;
  const float mv = merge ? to_f32(static_cast<const T*>(a.m)[s.plane]) : 0.f;

  float sums[2] = {0.f, 0.f};  // sum x, sum x^2
  for (int i = s.first; i < s.end; i += s.step) {
    float v[U];
    load<U>(x + static_cast<long long>(i) * U * step, v);
#pragma unroll
    for (int k = 0; k < U; ++k) {
      sums[0] += v[k];
      sums[1] += v[k] * v[k];
    }
    if (!norm && merge) {
#pragma unroll
      for (int k = 0; k < U; ++k) v[k] = round_to<T>(v[k] + mv);
      store<U>(out + static_cast<long long>(i) * U * step, v);
    }
  }
  plane_sum<kWarp>(sums, a.cluster);

  const float mu = sums[0] * a.inv_n;
  float rstd = 0.f;
  if (norm) {
    float var = sums[1] * a.inv_n - mu * mu;
    var = var < 0.f ? 0.f : var;  // torch.clamp(min=0): NaN stays NaN
    rstd = rsqrtf(var + a.eps);
  }
  if (s.lead) {
    a.mean[s.plane] = mu;
    if (norm) a.rstd[s.plane] = rstd;
  }
  if (!norm) return;

  const bool pbf16 = a.flags & kParamBf16;
  const float w = param(a.w, pbf16, c);
  const float b = param(a.b, pbf16, c);
  for (int i = s.first; i < s.end; i += s.step) {
    float v[U];
    load<U>(x + static_cast<long long>(i) * U * step, v);
#pragma unroll
    for (int k = 0; k < U; ++k) {
      float y = (v[k] - mu) * rstd;
      y = round_to<T>(y * w + b);
      v[k] = merge ? round_to<T>(y + mv) : y;
    }
    store<U>(out + static_cast<long long>(i) * U * step, v);
  }
}

// The planes' backward, U values a step as planes_fwd.
template <typename T, bool kWarp, int U>
__device__ __forceinline__ void planes_bwd(const BwdArgs& a) {
  const Span s = span_of<kWarp>(a.planes, a.n / U, a.cluster);
  if (kWarp && s.plane < 0) return;
  const bool norm = a.flags & kNorm;
  const bool merge = a.flags & kMerge;
  const bool tap = a.flags & kTap;
  const long long row = s.plane / a.channels;
  const int c = static_cast<int>(s.plane % a.channels);
  // Each tensor's pixel stride is 1 wherever U == kVec.
  const T* dout = static_cast<const T*>(a.dout) + row * a.ds.row +
                  c * a.ds.chan;
  const T* x = static_cast<const T*>(a.x) + row * a.xs.row + c * a.xs.chan;
  T* dx = static_cast<T*>(a.dx) + row * a.dxs.row + c * a.dxs.chan;
  const long long dstep = a.ds.pixel, xstep = a.xs.pixel,
                  dxstep = a.dxs.pixel;
  const float gn = tap ? a.g[row * a.g_row + c] * a.inv_n : 0.f;
  const float mu = norm ? a.mean[s.plane] : 0.f;
  const float rstd = norm ? a.rstd[s.plane] : 0.f;

  float sums[2] = {0.f, 0.f};  // sum dy, sum dy * xh
  for (int i = s.first; i < s.end; i += s.step) {
    float d[U];
    load<U>(dout + static_cast<long long>(i) * U * dstep, d);
    if (norm) {
      float v[U];
      load<U>(x + static_cast<long long>(i) * U * xstep, v);
#pragma unroll
      for (int k = 0; k < U; ++k) {
        sums[0] += d[k];
        sums[1] += d[k] * ((v[k] - mu) * rstd);
      }
    } else {
#pragma unroll
      for (int k = 0; k < U; ++k) sums[0] += d[k];
      if (tap) {
#pragma unroll
        for (int k = 0; k < U; ++k) d[k] = d[k] + gn;
        store<U>(dx + static_cast<long long>(i) * U * dxstep, d);
      }
    }
  }
  if (!norm && !merge) return;
  plane_sum<kWarp>(sums, a.cluster);
  if (s.lead) {
    if (norm) {
      a.dw[s.plane] = sums[1];
      a.db[s.plane] = sums[0];
    }
    if (merge) {
      float v[1] = {sums[0]};
      store<1>(static_cast<T*>(a.dm) + s.plane, v);
    }
  }
  if (!norm) return;

  const float scale = rstd * param(a.w, a.flags & kParamBf16, c);
  const float mean_dy = sums[0] * a.inv_n;
  const float mean_dyxh = sums[1] * a.inv_n;
  for (int i = s.first; i < s.end; i += s.step) {
    float d[U], v[U];
    load<U>(dout + static_cast<long long>(i) * U * dstep, d);
    load<U>(x + static_cast<long long>(i) * U * xstep, v);
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const float xh = (v[k] - mu) * rstd;
      float t = scale * ((d[k] - mean_dy) - xh * mean_dyxh);
      if (tap) t = t + gn;
      d[k] = t;
    }
    store<U>(dx + static_cast<long long>(i) * U * dxstep, d);
  }
}

// The channels-last mapping: block (row, group, rank) of a launch, and the
// thread's channel vector and pixel lane in it. A block takes `vecs` vectors
// of 8 channels and kThreads / vecs pixel lanes; the pixels of the row are
// cut into `cluster` equal ranges, one a block of the cluster.
struct ColSpan {
  long long row;
  int c0;       // the thread's first channel
  bool active;  // c0 < channels (a group may run past the last channel)
  int first;    // the thread's first pixel, then every step-th
  int end;
  int step;
  bool lead;    // writes its channels' per-plane results
};

__device__ __forceinline__ ColSpan col_span(int channels, int n, int cluster,
                                            int vecs) {
  const int groups = (channels + vecs * kVec - 1) / (vecs * kVec);
  const int rank = static_cast<int>(blockIdx.x % cluster);
  const long long unit = blockIdx.x / cluster;
  const int j = threadIdx.x % vecs, q = threadIdx.x / vecs;
  ColSpan s;
  s.row = unit / groups;
  s.c0 = static_cast<int>(unit % groups) * vecs * kVec + j * kVec;
  s.active = s.c0 < channels;
  const int chunk = (n + cluster - 1) / cluster;
  const int lo = rank * chunk;
  s.first = lo + q;
  s.end = min(lo + chunk, n);
  s.step = kThreads / vecs;
  s.lead = s.active && q == 0 && rank == 0;
  return s;
}

// The totals of each of the thread's 8 channels, two sums each, in every
// thread: over the warp's pixel lanes, the block's warps in order, then the
// cluster's blocks in rank order. Every thread of the block (and of its
// cluster) must call it.
__device__ __forceinline__ void col_sum(float (&s)[2][kVec], int cluster,
                                        int vecs) {
  for (int off = vecs; off < 32; off <<= 1) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      s[0][e] += __shfl_xor_sync(0xffffffffu, s[0][e], off);
      s[1][e] += __shfl_xor_sync(0xffffffffu, s[1][e], off);
    }
  }
  __shared__ float red[kWarps][2][kMaxGroup];
  __shared__ float part[2][kMaxGroup];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = threadIdx.x % vecs;
  if (lane < vecs) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      red[warp][0][lane * kVec + e] = s[0][e];
      red[warp][1][lane * kVec + e] = s[1][e];
    }
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const int c = j * kVec + e;
    s[0][e] = red[0][0][c];
    s[1][e] = red[0][1][c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      s[0][e] += red[w][0][c];
      s[1][e] += red[w][1][c];
    }
  }
  if (cluster > 1) {
    cg::cluster_group cl = cg::this_cluster();
    if (static_cast<int>(threadIdx.x) < vecs) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        part[0][threadIdx.x * kVec + e] = s[0][e];
        part[1][threadIdx.x * kVec + e] = s[1][e];
      }
    }
    cl.sync();
    for (int r = 0; r < cluster; ++r) {
      const float(*q)[kMaxGroup] = cl.map_shared_rank(part, r);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int c = j * kVec + e;
        s[0][e] = r == 0 ? q[0][c] : s[0][e] + q[0][c];
        s[1][e] = r == 0 ? q[1][c] : s[1][e] + q[1][c];
      }
    }
    cl.sync();
  }
}

template <typename T>
__device__ __forceinline__ void columns_fwd(const FwdArgs& a) {
  const ColSpan s = col_span(a.channels, a.n, a.cluster, a.vecs);
  const bool norm = a.flags & kNorm;
  const bool merge = a.flags & kMerge;
  const long long plane = s.row * a.channels + s.c0;  // the first channel's
  const long long base = s.row * a.xs.row + s.c0;
  const long long step = a.xs.pixel;  // the channels
  const T* x = static_cast<const T*>(a.x) + base;
  T* out = static_cast<T*>(a.out) + base;
  float mv[kVec];
  if (merge && s.active) {
    load<kVec>(static_cast<const T*>(a.m) + plane, mv);
  }
  float sums[2][kVec] = {};
  for (int p = s.first; s.active && p < s.end; p += s.step) {
    float v[kVec];
    load<kVec>(x + p * step, v);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      sums[0][e] += v[e];
      sums[1][e] += v[e] * v[e];
    }
    if (!norm && merge) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[e] = round_to<T>(v[e] + mv[e]);
      store<kVec>(out + p * step, v);
    }
  }
  col_sum(sums, a.cluster, a.vecs);
  float mu[kVec], rstd[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    mu[e] = sums[0][e] * a.inv_n;
    rstd[e] = 0.f;
    if (norm) {
      float var = sums[1][e] * a.inv_n - mu[e] * mu[e];
      var = var < 0.f ? 0.f : var;  // torch.clamp(min=0): NaN stays NaN
      rstd[e] = rsqrtf(var + a.eps);
    }
  }
  if (s.lead) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      a.mean[plane + e] = mu[e];
      if (norm) a.rstd[plane + e] = rstd[e];
    }
  }
  if (!norm || !s.active) return;
  const bool pbf16 = a.flags & kParamBf16;
  float w[kVec], b[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    w[e] = param(a.w, pbf16, s.c0 + e);
    b[e] = param(a.b, pbf16, s.c0 + e);
  }
  for (int p = s.first; p < s.end; p += s.step) {
    float v[kVec];
    load<kVec>(x + p * step, v);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      float y = (v[e] - mu[e]) * rstd[e];
      y = round_to<T>(y * w[e] + b[e]);
      v[e] = merge ? round_to<T>(y + mv[e]) : y;
    }
    store<kVec>(out + p * step, v);
  }
}

template <typename T>
__device__ __forceinline__ void columns_bwd(const BwdArgs& a) {
  const ColSpan s = col_span(a.channels, a.n, a.cluster, a.vecs);
  const bool norm = a.flags & kNorm;
  const bool merge = a.flags & kMerge;
  const bool tap = a.flags & kTap;
  const long long plane = s.row * a.channels + s.c0;
  const T* dout = static_cast<const T*>(a.dout) + s.row * a.ds.row + s.c0;
  const T* x = static_cast<const T*>(a.x) + s.row * a.xs.row + s.c0;
  T* dx = static_cast<T*>(a.dx) + s.row * a.dxs.row + s.c0;
  const long long dstep = a.ds.pixel, xstep = a.xs.pixel,
                  dxstep = a.dxs.pixel;
  float gn[kVec], mu[kVec], rstd[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    gn[e] = tap && s.active ? a.g[s.row * a.g_row + s.c0 + e] * a.inv_n : 0.f;
    mu[e] = norm && s.active ? a.mean[plane + e] : 0.f;
    rstd[e] = norm && s.active ? a.rstd[plane + e] : 0.f;
  }
  float sums[2][kVec] = {};  // sum dy, sum dy * xh
  for (int p = s.first; s.active && p < s.end; p += s.step) {
    float d[kVec];
    load<kVec>(dout + p * dstep, d);
    if (norm) {
      float v[kVec];
      load<kVec>(x + p * xstep, v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        sums[0][e] += d[e];
        sums[1][e] += d[e] * ((v[e] - mu[e]) * rstd[e]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) sums[0][e] += d[e];
      if (tap) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) d[e] = d[e] + gn[e];
        store<kVec>(dx + p * dxstep, d);
      }
    }
  }
  if (!norm && !merge) return;
  col_sum(sums, a.cluster, a.vecs);
  if (s.lead) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      if (norm) {
        a.dw[plane + e] = sums[1][e];
        a.db[plane + e] = sums[0][e];
      }
      if (merge) {
        float v[1] = {sums[0][e]};
        store<1>(static_cast<T*>(a.dm) + plane + e, v);
      }
    }
  }
  if (!norm || !s.active) return;
  const bool pbf16 = a.flags & kParamBf16;
  float scale[kVec], mean_dy[kVec], mean_dyxh[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    scale[e] = rstd[e] * param(a.w, pbf16, s.c0 + e);
    mean_dy[e] = sums[0][e] * a.inv_n;
    mean_dyxh[e] = sums[1][e] * a.inv_n;
  }
  for (int p = s.first; p < s.end; p += s.step) {
    float d[kVec], v[kVec];
    load<kVec>(dout + p * dstep, d);
    load<kVec>(x + p * xstep, v);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float xh = (v[e] - mu[e]) * rstd[e];
      float t = scale[e] * ((d[e] - mean_dy[e]) - xh * mean_dyxh[e]);
      if (tap) t = t + gn[e];
      d[e] = t;
    }
    store<kVec>(dx + p * dxstep, d);
  }
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
norm_merge_fwd_kernel(const FwdArgs a) {
  if constexpr (kMode == kColumns) {
    columns_fwd<T>(a);
  } else if (a.vec) {
    planes_fwd<T, kMode == kPlaneWarp, kVec>(a);
  } else {
    planes_fwd<T, kMode == kPlaneWarp, 1>(a);
  }
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
norm_merge_bwd_kernel(const BwdArgs a) {
  if constexpr (kMode == kColumns) {
    columns_bwd<T>(a);
  } else if (a.vec) {
    planes_bwd<T, kMode == kPlaneWarp, kVec>(a);
  } else {
    planes_bwd<T, kMode == kPlaneWarp, 1>(a);
  }
}

// How a launch maps planes to blocks.
struct Plan {
  int mode;
  int cluster;
  long long blocks;
  int vecs;  // channel vectors a block (channels-last mapping)
};

int sm_count(int device) {
  static int counts[64];
  if (device < 0 || device >= 64) return 0;
  if (counts[device] == 0) {
    cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount,
                           device);
  }
  return counts[device];
}

Plan plan_for(long long planes, int n, int units, int device) {
  if (n <= kWarpPlane) {
    return {kPlaneWarp, 1, (planes + kWarps - 1) / kWarps, 0};
  }
  const long long target = static_cast<long long>(kBlocksPerSm) *
                           sm_count(device);
  int k = 1;
  // Split a plane further while a block's share is larger than kChunk or the
  // blocks are too few to fill the card, as long as every block keeps at
  // least one unit a thread.
  while (k < kMaxCluster &&
         (n > static_cast<long long>(k) * kChunk || planes * k < target) &&
         units >= 2LL * k * kThreads) {
    k *= 2;
  }
  return {kPlaneBlock, k, planes * k, 0};
}

// The channels-last mapping of `rows` rows of `channels` channels and n
// pixels. A block's group of channels is 64 wide, narrowed (down to 16,
// two 32-byte sectors of bf16 a pixel) while the groups are too few to give
// every SM kBlocksPerSm blocks in clusters of kMaxCluster; then, as
// plan_for, its range of pixels is cut while larger than kChunk values or
// the blocks are too few, at least one pixel a lane.
Plan plan_columns(long long rows, int channels, int n, int device) {
  const long long target = static_cast<long long>(kBlocksPerSm) *
                           sm_count(device);
  int vecs = kMaxGroup / kVec;
  auto units = [&](int v) {
    return rows * ((channels + v * kVec - 1) / (v * kVec));
  };
  while (vecs > 2 && units(vecs) * kMaxCluster < target) vecs /= 2;
  const int lanes = kThreads / vecs;
  int k = 1;
  while (k < kMaxCluster &&
         (static_cast<long long>(n) * vecs * kVec >
              static_cast<long long>(k) * kChunk ||
          units(vecs) * k < target) &&
         n >= 2LL * k * lanes) {
    k *= 2;
  }
  return {kColumns, k, units(vecs) * k, vecs};
}

bool aligned(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

// Whether a tensor (absent: nullptr) takes 16-byte steps along its planes:
// its pixels adjacent, its planes and its pointer 16-byte aligned.
bool vectors(const void* p, const Strides& st) {
  return p == nullptr || (st.pixel == 1 && st.row % kVec == 0 &&
                          st.chan % kVec == 0 && aligned(p));
}

// Whether a tensor (absent: nullptr) is channels last and takes 16-byte
// steps along its channels.
bool columns(const void* p, const Strides& st, int channels) {
  return p == nullptr ||
         (st.chan == 1 && st.pixel == channels && channels % kVec == 0 &&
          st.row % kVec == 0 && aligned(p));
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

template <typename Args>
int launch(void (*kernel)(Args), const Plan& plan, const Args& args,
           cudaStream_t stream) {
  if (plan.blocks <= 0) return 0;
  if (plan.blocks > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const unsigned blocks = static_cast<unsigned>(plan.blocks);
  if (plan.cluster == 1) {
    kernel<<<blocks, kThreads, 0, stream>>>(args);
  } else {
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(blocks, 1, 1);
    config.blockDim = dim3(kThreads, 1, 1);
    config.dynamicSmemBytes = 0;
    config.stream = stream;
    cudaLaunchAttribute attribute[1];
    attribute[0].id = cudaLaunchAttributeClusterDimension;
    attribute[0].val.clusterDim.x = plan.cluster;
    attribute[0].val.clusterDim.y = 1;
    attribute[0].val.clusterDim.z = 1;
    config.attrs = attribute;
    config.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&config, kernel, args);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

using FwdKernel = void (*)(FwdArgs);
using BwdKernel = void (*)(BwdArgs);

// The instance of each kernel for a mapping.
template <typename T>
FwdKernel fwd_kernel(int mode) {
  if (mode == kColumns) return norm_merge_fwd_kernel<T, kColumns>;
  if (mode == kPlaneBlock) return norm_merge_fwd_kernel<T, kPlaneBlock>;
  return norm_merge_fwd_kernel<T, kPlaneWarp>;
}

template <typename T>
BwdKernel bwd_kernel(int mode) {
  if (mode == kColumns) return norm_merge_bwd_kernel<T, kColumns>;
  if (mode == kPlaneBlock) return norm_merge_bwd_kernel<T, kPlaneBlock>;
  return norm_merge_bwd_kernel<T, kPlaneWarp>;
}

template <typename Kernel>
int attributes(Kernel kernel, int* registers, int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *registers = attr.numRegs;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                      kThreads, 0);
  return static_cast<int>(err);
}

// The mapping of a launch: a plane's 16-byte steps where its pixels are
// adjacent (vec), channel vectors where every tensor is channels last
// (cols), else a plane's values one by one.
Plan choose(long long planes, int channels, int n, bool vec, bool cols,
            int device) {
  if (!vec && cols) {
    return plan_columns(planes / channels, channels, n, device);
  }
  return plan_for(planes, n, vec ? n / kVec : n, device);
}

}  // namespace

extern "C" {

// The forward of `planes` planes of n values (rows x channels), one launch
// on `stream` of `device`: x with its row, channel and pixel strides (out
// takes the same), the tap into stats[0, planes), rstd into
// stats[planes, 2 planes) with the norm (flags), out written where there is
// a norm or a merge vector. Returns the CUDA error of the launch (0:
// launched).
int svbrdf_norm_merge_fwd(const void* x, long long x_row, long long x_chan,
                          long long x_pixel, const void* w, const void* b,
                          const void* m, void* out, float* stats,
                          long long planes, int channels, long long n,
                          int flags, float eps, int device, void* stream) {
  if (planes < 0 || channels <= 0 || n <= 0 || n > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceScope scope(device);
  FwdArgs a;
  a.x = x;
  a.xs = Strides{x_row, x_chan, x_pixel};
  a.w = w;
  a.b = b;
  a.m = m;
  a.out = out;
  a.mean = stats;
  a.rstd = stats + planes;
  a.planes = planes;
  a.channels = channels;
  a.n = static_cast<int>(n);
  a.flags = flags;
  a.vec = n % kVec == 0 && vectors(x, a.xs) && vectors(out, a.xs);
  a.inv_n = 1.0f / static_cast<float>(n);
  a.eps = eps;
  const bool cols = columns(x, a.xs, channels) &&
                    columns(out, a.xs, channels) &&
                    (m == nullptr || aligned(m));
  const Plan plan = choose(planes, channels, a.n, a.vec, cols, device);
  a.cluster = plan.cluster;
  a.vecs = plan.vecs;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (flags & kBf16) {
    return launch(fwd_kernel<__nv_bfloat16>(plan.mode), plan, a, st);
  }
  return launch(fwd_kernel<float>(plan.mode), plan, a, st);
}

// The backward of the same planes: dout with its strides; g, the tap's
// cotangent, rows g_row apart (with kTap); x with its strides and stats as
// the forward kept them (with the norm); dx, with its strides, written where
// there is a norm or a tap cotangent; dm, the merge vector's cotangent (with
// kMerge); parts[0, planes) the planes' sum(dy * xh) and
// parts[planes, 2 planes) their sum(dy) (with the norm).
int svbrdf_norm_merge_bwd(const void* dout, long long d_row, long long d_chan,
                          long long d_pixel, const float* g, long long g_row,
                          const void* x, long long x_row, long long x_chan,
                          long long x_pixel, const float* stats,
                          const void* w, void* dx, long long dx_row,
                          long long dx_chan, long long dx_pixel, void* dm,
                          float* parts, long long planes, int channels,
                          long long n, int flags, int device, void* stream) {
  if (planes < 0 || channels <= 0 || n <= 0 || n > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceScope scope(device);
  BwdArgs a;
  a.dout = dout;
  a.ds = Strides{d_row, d_chan, d_pixel};
  a.g = g;
  a.g_row = g_row;
  a.x = x;
  a.xs = Strides{x_row, x_chan, x_pixel};
  a.mean = stats;
  a.rstd = stats == nullptr ? nullptr : stats + planes;
  a.w = w;
  a.dx = dx;
  a.dxs = Strides{dx_row, dx_chan, dx_pixel};
  a.dm = dm;
  a.dw = parts;
  a.db = parts == nullptr ? nullptr : parts + planes;
  a.planes = planes;
  a.channels = channels;
  a.n = static_cast<int>(n);
  a.flags = flags;
  a.vec = n % kVec == 0 && vectors(dout, a.ds) && vectors(x, a.xs) &&
          vectors(dx, a.dxs);
  a.inv_n = 1.0f / static_cast<float>(n);
  const bool cols = columns(dout, a.ds, channels) &&
                    columns(x, a.xs, channels) &&
                    columns(dx, a.dxs, channels);
  const Plan plan = choose(planes, channels, a.n, a.vec, cols, device);
  a.cluster = plan.cluster;
  a.vecs = plan.vecs;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (flags & kBf16) {
    return launch(bwd_kernel<__nv_bfloat16>(plan.mode), plan, a, st);
  }
  return launch(bwd_kernel<float>(plan.mode), plan, a, st);
}

// Registers and blocks per SM of one instance: `backward` picks the kernel,
// `bf16` its activations' type, `mode` the mapping (0 a warp a plane, 1 a
// block or cluster a plane, 2 channels last).
// Returns the CUDA error of the queries.
int svbrdf_norm_merge_attributes(int backward, int bf16, int mode,
                                 int* registers, int* blocks_per_sm) {
  if (mode < 0 || mode > kColumns) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (backward) {
    return attributes(bf16 ? bwd_kernel<__nv_bfloat16>(mode)
                           : bwd_kernel<float>(mode),
                      registers, blocks_per_sm);
  }
  return attributes(bf16 ? fwd_kernel<__nv_bfloat16>(mode)
                         : fwd_kernel<float>(mode),
                    registers, blocks_per_sm);
}

}  // extern "C"
