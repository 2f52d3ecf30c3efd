"""The styled-conv tail's CUDA kernels (csrc/styled_tail.cu) built for the
host with g++ and run on CPU tensors: their device code, not a
transcription.

The source is compiled as C++20 with the CUDA keywords defined away and a
block emulated as it runs on the card: each thread of a block a std::thread,
__syncthreads a barrier of the block's threads, __shfl_down_sync an exchange
through a buffer between two barriers of the warp's threads, the dynamic
shared memory a buffer filled with a sentinel (so a read of a value never
written shows), the blocks one after another (so the last block to finish,
which adds the partials, is the last in the grid). No FMA is contracted
(-ffp-contract=off, as the card's build is -fmad=false). The launches go
through ops.styled_tail's own launch code (launch_fwd, launch_bwd) with a
plan for `sms` SMs. tests/test_torch_styled_tail.py holds the host build to
the plain version; the card suite holds the card's. Needs g++; builds into
svbrdf_tpu_torch/_build/.
"""

from __future__ import annotations

from svbrdf_tpu_torch.ops import _build
from svbrdf_tpu_torch.ops import styled_tail as st

SOURCE = _build.CSRC / "styled_tail.cu"
CXX_FLAGS = ("-O1", "-std=c++20", "-ffp-contract=off", "-pthread", "-fPIC",
             "-shared")
H100_SMS = 132

_PRELUDE = r"""
#include <algorithm>
#include <barrier>
#include <cstddef>
#include <cstring>
#include <deque>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaSetDevice(int) { return 0; }
inline int cudaGetLastError() { return 0; }
inline int cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return 0;
}
inline std::barrier<>* g_block;
inline std::vector<std::barrier<>*> g_warps;
inline float g_lanes[8][32];
inline std::vector<float> g_smem;
inline void __syncthreads() { g_block->arrive_and_wait(); }
inline void __threadfence() {}
inline float __shfl_down_sync(unsigned, float v, int off) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  g_lanes[warp][lane] = v;
  g_warps[warp]->arrive_and_wait();
  const float r = lane + off < 32 ? g_lanes[warp][lane + off] : v;
  g_warps[warp]->arrive_and_wait();
  return r;
}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  const unsigned old = *p;
  *p += v;
  return old;
}
inline float __ldcg(const float* p) { return *p; }
template <typename Args>
void emulate(void (*kernel)(Args), unsigned blocks, unsigned threads,
             size_t smem, Args a) {
  g_smem.assign(smem / sizeof(float) + 1, -12345.f);
  blockDim = dim3(threads);
  for (unsigned b = 0; b < blocks; ++b) {
    std::barrier<> block(threads);
    std::deque<std::barrier<>> warps;
    g_block = &block;
    g_warps.clear();
    for (unsigned w = 0; w < threads / 32; ++w) {
      warps.emplace_back(32);
      g_warps.push_back(&warps.back());
    }
    std::vector<std::thread> team;
    for (unsigned t = 0; t < threads; ++t) {
      team.emplace_back([=] {
        threadIdx = dim3(t);
        blockIdx = dim3(b);
        kernel(a);
      });
    }
    for (auto& t : team) t.join();
  }
}
"""

# The source's two lines that name the card's memory and launch.
_SUBSTITUTIONS = (
    ("extern __shared__ float smem[];", "float* smem = g_smem.data();"),
    ("kernel<<<blocks, threads, smem, stream>>>(a);",
     "(void)stream; emulate(kernel, blocks, threads, smem, a);"),
)
_LIB = {}


def host_source() -> str:
    """The kernels' source as the host compiles it."""
    text = SOURCE.read_text()
    for old, new in _SUBSTITUTIONS:
        if old not in text:
            raise RuntimeError(f"styled_tail.cu no longer holds {old!r}; "
                               f"update host_styled_tail._SUBSTITUTIONS")
        text = text.replace(old, new)
    text = text.replace("#include <cuda_runtime.h>", _PRELUDE)
    return text


def load() -> dict:
    """The host build's two C entries, compiled at first use."""
    if not _LIB:
        _LIB.update(st.entries(_build.host_build(host_source(), CXX_FLAGS,
                                                 "styled_tail_host")))
    return _LIB


def forward(t, d, bias, noise, strength, up: bool, keep: bool = False,
            sms: int = H100_SMS) -> tuple:
    """The forward kernel on CPU tensors: (out, y) as
    ops.styled_tail.styled_tail_fwd_cuda returns them."""
    b, c, h, w = t.shape[0], t.shape[1], *noise.shape[2:]
    return st.launch_fwd(load()["fwd"], t, d, bias, noise, strength, up,
                         keep, st.plan(b, c, h, w, sms), 0, None)


def backward(g, y, d, bias, noise, strength, up: bool,
             wants: tuple = (True,) * 5, sms: int = H100_SMS) -> tuple:
    """The backward kernel on CPU tensors: the gradients as
    ops.styled_tail.styled_tail_bwd_cuda returns them."""
    return st.launch_bwd(load()["bwd"], g, y, d, bias, noise, strength, up,
                         wants, st.plan(*y.shape, sms), 0, None)
