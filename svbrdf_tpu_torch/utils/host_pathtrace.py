"""The path tracer's CUDA kernels (csrc/pathtrace.cu) built for the host
with g++ and run on CPU tensors: their device code, not a transcription.

    python3 -m svbrdf_tpu_torch.utils.host_pathtrace [--size N]
        [--variant NAME]

The kernels' source up to its launch code is compiled as C++ with the CUDA
keywords defined away, a bf16 type that rounds to nearest even, the two
inline-PTX approximations as 1/x and 1/sqrt(x) (IEEE, where the card's
MUFU ops are within an ulp), threadIdx / blockIdx / gridDim as globals and
the VJP's block sum of the scene cotangents as a plain sum. Each block's
threads run in order, twice: the first pass fills the block's shared
memory (__syncthreads does nothing here), the second computes. No FMA is
contracted (-ffp-contract=off, as the card's build is -fmad=false; fmaf
stays fused). So the host build rounds as the card does but for the MUFU
ops, expf and the order of the block sums.

The command holds the host build on bench_setup.pathtrace_case inputs (2
items, N x N, spp 16 / 8; f32 and bf16 SVBRDFs, and scene gradients at
min(N, 16)) against the plain versions and float64 by
bench_setup.pathtrace_agreement (hold_pathtrace_kernels's rules, reported)
and prints one JSON line a case. --variant applies one of VARIANTS' edits
to the source first. Needs g++; builds into svbrdf_tpu_torch/_build/.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json

import torch

from svbrdf_tpu_torch.ops import _build

SOURCE = _build.CSRC / "pathtrace.cu"
CXX_FLAGS = ("-O1", "-std=c++17", "-ffp-contract=off", "-fPIC", "-shared")
# Where the device code ends: the launch code after it stays on the card.
_END = "size_t shade_shared_bytes(int spp)"

_PRELUDE = r"""
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(...)
#define __restrict__ __restrict
struct Dim3 { int x, y, z; };
extern Dim3 threadIdx, blockIdx, gridDim;
inline void __syncthreads() {}
inline float __shfl_down_sync(unsigned, float, int) { return 0.f; }
inline int __float_as_int(float f) {
  int i; std::memcpy(&i, &f, 4); return i;
}
inline float __int_as_float(int i) {
  float f; std::memcpy(&f, &i, 4); return f;
}
struct __nv_bfloat16 { uint16_t bits; };
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = uint32_t(b.bits) << 16; float f; std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u; std::memcpy(&u, &f, 4);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __nv_bfloat16{uint16_t(u >> 16)};
}
"""

# The source's lines that only the card runs, and their host forms.
_SUBSTITUTIONS = (
    ("#include <cuda_bf16.h>\n#include <cuda_runtime.h>\n", _PRELUDE),
    ('asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));', "r = 1.f / x;"),
    ('asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));',
     "r = 1.f / std::sqrt(x);"),
    ("const float total = block_sum(gs[j], scratch);\n"
     "        if (t == 0) dst[j] = total;", "dst[j] += gs[j];"),
)

# The launches on the host (each block's threads in order, twice) and
# their C entries for ctypes, appended to the device code.
_HOST_LAUNCHES = r"""
double smem[1 << 16];
}  // namespace
Dim3 threadIdx, blockIdx, gridDim;

#define IN const void* c, const void* n, const void* d, const void* r, \
    const void* sp, const float* light, const float* nl, const float* tl, \
    const float* bl, const float* em, const float* cam, const float* off, \
    const float* sh
#define FIELDS(F) (const F*)c, (const F*)n, (const F*)d, (const F*)r, \
    (const F*)sp, light, nl, tl, bl, em, cam, off, sh

template <class F>
void run_shade(IN, float* out, int P, int S, int H, int W, int spp,
               double lw, double lh, float area) {
  const int hw = H * W, bx = (hw + kThreads - 1) / kThreads;
  gridDim = {bx, P * S, 1};
  for (int by = 0; by < P * S; ++by)
    for (int b = 0; b < bx; ++b)
      for (int pass = 0; pass < 2; ++pass)
        for (int t = 0; t < kThreads; ++t) {
          blockIdx = {b, by, 0};
          threadIdx = {t, 0, 0};
          shade_kernel<F>(FIELDS(F), out, P, S, hw, spp, lw, lh, area);
        }
}

template <class F, bool kScene>
void run_vjp(IN, const float* ds, float* dn, float* dd, float* dr,
             float* dsp, float* dwo, float* part, int P, int S, int H, int W,
             int spp, double lw, double lh, float area) {
  const int hw = H * W, bx = (hw + kThreads - 1) / kThreads;
  gridDim = {bx, P, 1};
  for (int by = 0; by < P; ++by)
    for (int b = 0; b < bx; ++b)
      for (int pass = 0; pass < 2; ++pass) {
        if (kScene) {
          float* block = part + ((size_t)by * bx + b) * S * kSceneGrads;
          for (int j = 0; j < S * kSceneGrads; ++j) block[j] = 0.f;
        }
        for (int t = 0; t < kThreads; ++t) {
          blockIdx = {b, by, 0};
          threadIdx = {t, 0, 0};
          shade_vjp_kernel<F, kScene>(FIELDS(F), ds, dn, dd, dr, dsp, dwo,
                                      part, P, S, hw, spp, lw, lh, area);
        }
      }
}

extern "C" {
int host_threads() { return kThreads; }
void host_shade(IN, float* out, int P, int S, int H, int W, int spp,
                double lw, double lh, float area, int bf16) {
  if (bf16) {
    run_shade<__nv_bfloat16>(c, n, d, r, sp, light, nl, tl, bl, em, cam, off,
                             sh, out, P, S, H, W, spp, lw, lh, area);
  } else {
    run_shade<float>(c, n, d, r, sp, light, nl, tl, bl, em, cam, off, sh,
                     out, P, S, H, W, spp, lw, lh, area);
  }
}
void host_shade_vjp(IN, const float* ds, float* dn, float* dd, float* dr,
                    float* dsp, float* dwo, float* part, int P, int S, int H,
                    int W, int spp, int scene, double lw, double lh,
                    float area, int bf16) {
#define RUN(F, K) run_vjp<F, K>(c, n, d, r, sp, light, nl, tl, bl, em, cam, \
    off, sh, ds, dn, dd, dr, dsp, dwo, part, P, S, H, W, spp, lw, lh, area)
  if (bf16) {
    if (scene) RUN(__nv_bfloat16, true); else RUN(__nv_bfloat16, false);
  } else {
    if (scene) RUN(float, true); else RUN(float, false);
  }
}
}  // extern "C"
"""

# One-edit variants of the kernels' precision devices, by name: the
# cosines from f32 dot products of wi (in place of the per-view double
# terms), and 1 - n.h as 1 minus the rounded cosine.
VARIANTS = {
    "f32_cosines": (
        "  s.cs_raw = (float)fma(d1, v.nb, fma(d0, v.nt, v.cn)) * s.rsq;\n"
        "  s.cl_raw = -((float)fma(d1, v.lb, fma(d0, v.lt, v.cl)) * s.rsq);",
        "  s.cs_raw = dot3(s.wi, px.n);\n"
        "  s.cl_raw = -dot3(s.wi, scene + 3);"),
    "naive_one_minus_nh": (
        "  return nh < 0.5f * nlen ? 1.f - nh\n"
        "                          : fmaf(cc, rcp_approx(nlen + nh), x0);",
        "  return 1.f - nh;"),
}


def host_source(text: str) -> str:
    """The C++ for the host from the text of pathtrace.cu."""
    if _END not in text:
        raise ValueError(f"no {_END!r} in the source")
    text = text[:text.index(_END)]
    for old, new in _SUBSTITUTIONS:
        if text.count(old) != 1:
            raise ValueError(f"expected {old!r} once in the source")
        text = text.replace(old, new)
    return text + _HOST_LAUNCHES


def apply_variant(text: str, name: str) -> str:
    old, new = VARIANTS[name]
    if text.count(old) != 1:
        raise ValueError(f"variant {name}: expected its line once")
    return text.replace(old, new)


def build(variant: str | None = None) -> ctypes.CDLL:
    """Compile the kernels' device code (with `variant`'s edit) for the
    host, once for each text, and load it."""
    text = SOURCE.read_text()
    if variant is not None:
        text = apply_variant(text, variant)
    return _build.host_build(host_source(text), CXX_FLAGS, "host_pathtrace")


def _pointers(tensors) -> list:
    return [ctypes.c_void_p(t.data_ptr()) for t in tensors]


def _light_args() -> list:
    from svbrdf_tpu_torch.ops import pathtrace as pt

    w, h, area = pt._light_args()
    return [ctypes.c_double(w), ctypes.c_double(h), ctypes.c_float(area)]


def _contiguous(inputs) -> list:
    return [t.contiguous() for t in inputs]


def shade(lib, *inputs) -> torch.Tensor:
    """The forward kernel of the host build `lib` on CPU tensors, with
    ops/pathtrace.shade_cuda's arguments and result."""
    inputs = _contiguous(inputs)
    coords, light, offsets = inputs[0], inputs[5], inputs[11]
    items, scenes = light.shape[:2]
    height, width = coords.shape[:2]
    out = torch.empty((items, scenes, height, width, 3), dtype=torch.float32)
    lib.host_shade(*_pointers(inputs), ctypes.c_void_p(out.data_ptr()),
                   items, scenes, height, width, offsets.shape[0],
                   *_light_args(), int(coords.dtype == torch.bfloat16))
    return out


def shade_vjp(lib, *inputs, scene_grads: bool = False) -> tuple:
    """The VJP kernel of the host build `lib` on CPU tensors, with
    ops/pathtrace.shade_vjp_cuda's arguments (d_sample last) and result:
    the scene cotangents from its per-block partials summed."""
    inputs = _contiguous(inputs)
    coords, light, offsets = inputs[0], inputs[5], inputs[11]
    items, scenes = light.shape[:2]
    height, width = coords.shape[:2]
    maps = [torch.empty((items, 1, height, width, c)) for c in (3, 3, 1, 3)]
    blocks = -(-(height * width) // lib.host_threads())
    d_wo = torch.empty((items, scenes, height, width, 3) if scene_grads
                       else (1,))
    partials = torch.empty((items, blocks, scenes, 15) if scene_grads
                           else (1,))
    lib.host_shade_vjp(*_pointers(inputs + maps + [d_wo, partials]), items,
                       scenes, height, width, offsets.shape[0],
                       int(scene_grads), *_light_args(),
                       int(coords.dtype == torch.bfloat16))
    if not scene_grads:
        return tuple(maps)
    light_s, n_l_s, t_l_s, b_l_s, emission_s = torch.split(
        torch.sum(partials, dim=1), 3, dim=-1)
    return (*maps, light_s, d_wo, n_l_s, t_l_s, b_l_s, emission_s)


@contextlib.contextmanager
def routed(lib):
    """Inside the block, ops/pathtrace's dispatcher `shade` and the VJP
    wrapper `shade_vjp_cuda` run the host build `lib` (what
    bench_setup.pathtrace_agreement calls for the kernels)."""
    from svbrdf_tpu_torch.ops import pathtrace as pt

    saved = pt.shade, pt.shade_vjp_cuda
    pt.shade = lambda *inputs: shade(lib, *inputs)
    pt.shade_vjp_cuda = (lambda *inputs, scene_grads=False:
                         shade_vjp(lib, *inputs, scene_grads=scene_grads))
    try:
        yield
    finally:
        pt.shade, pt.shade_vjp_cuda = saved


def agreement(lib, batch: int, size: int, dtype=torch.float32,
              scene_grads: bool = False, seed: int = 0) -> dict:
    """bench_setup.pathtrace_agreement of the host build `lib` on a CPU
    pathtrace_case (batch items, size x size, spp 16 / 8)."""
    from svbrdf_tpu_torch.utils import bench_setup

    case = bench_setup.pathtrace_case(batch, size, size, (16, 8),
                                      dtype=dtype, seed=seed, device="cpu")
    refs = bench_setup.pathtrace_references(case, scene_grads)
    with routed(lib):
        return bench_setup.pathtrace_agreement(case, refs, scene_grads)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--size", type=int, default=32)
    parser.add_argument("--variant", choices=sorted(VARIANTS))
    args = parser.parse_args(argv)
    torch.set_num_threads(1)
    lib = build(args.variant)
    cases = {"f32": (args.size, torch.float32, False),
             "bf16": (args.size, torch.bfloat16, False),
             "scene_grads": (min(args.size, 16), torch.float32, True)}
    for label, (size, dtype, scene_grads) in cases.items():
        out = agreement(lib, 2, size, dtype, scene_grads)
        print(json.dumps({"case": label, "size": size,
                          "variant": args.variant, **out}), flush=True)


if __name__ == "__main__":
    main()
