// The VJP of value_shading.cuh's shading, for the kernel with both
// gradients (rendering_both_kernel in rendering_loss.cu, the TPU kernel
// _fwdgrad_kernel_both of svbrdf_tpu/ops/render_pallas.py): the loss, and
// the gradients of both sides, from one shade of each side per scene.
//
// The forward is value_shading.cuh's algebra, instruction for instruction
// (value_channel computes value_render's r, keeping what the VJP reuses):
//   denom = max(a NH^2 + 1 - NH^2, eps),  sv^2 = a (1 - VN^2) + VN^2,
//   pv = VN + sv, pl = LN + sl,  P = denom^2 pv pl,  R = 1/P,  S = a R,
//   1 - F = (1 - spec) w,  m = (1 - F)(albedo - S) + S,
//   r = m (colour / pi) scale + 0.1,  loss term |log(r_p / r_t)|.
// Its VJP needs no special function beyond the forward's 27 per pixel and
// scene:
// - one reciprocal of r_p r_t gives 1/r_t = r_p / (r_p r_t) for the
//   quotient and both cotangents, u_p = sign / r_p and u_t = -sign / r_t;
// - the VJP of P from R and the products already formed: with
//   k = -dS S = dP P, d/d denom = 2 k (R pv pl) denom, d/d pv = k (R
//   denom^2) pl (and pl), so no 1/denom or 1/(pv pl) is taken;
// - d/d sv^2 = d/d pv / (2 sv), 1/sv being sv^2's rsqrt;
// - then the denominator's clamp, a (summed over scenes, turned into d/d
//   roughness through a = max(rough, eps)^4 once per pixel), and the
//   normal's chain through NH^2, VN, LN, scale and their clamps, with d
//   max(x, k)/dx = [x >= k] as the plain version takes it.
// The plain version (render_fused.rendering_loss_fwdgrad_both_plain) runs
// the same algebra with IEEE rsqrt, reciprocal and log; the kernel is held
// to it at a tolerance, as the value kernels are. Both sides run the same
// instructions, so pred = gt gives a quotient of exactly 1, a log of
// exactly 0, sign 0 and gradients of exactly 0.

#pragma once

#include "value_shading.cuh"

namespace svbrdf {

// One side's pixel as the VJP takes it: ValuePixel and 1 - a per channel.
struct VjpPixel : ValuePixel {
  float oma[3];
  __device__ __forceinline__ explicit VjpPixel(const float* v)
      : ValuePixel(v) {
#pragma unroll
    for (int c = 0; c < 3; ++c) oma[c] = 1.f - a[c];
  }
};

// One side's raw dots n.h, n.v and n.l: the clamps' derivatives read them
// (the same instructions as value_side's, which the compiler shares).
struct ValueDots {
  float nh, vn, ln;
};

__device__ __forceinline__ ValueDots value_dots(const ValuePixel& p,
                                                const ValueGeometry& g) {
  return {dot3(p.n[0], p.n[1], p.n[2], g.hx, g.hy, g.hz),
          dot3(p.n[0], p.n[1], p.n[2], g.vx, g.vy, g.vz),
          dot3(p.n[0], p.n[1], p.n[2], g.lx, g.ly, g.lz)};
}

// Channel c of one side: value_render's r and what its VJP reuses.
struct ValueChannel {
  float denom_raw, denom, isv, isl, pv, pl, dd, ppl, R, S, omF, cs, m, r;
};

__device__ __forceinline__ ValueChannel value_channel(const ValuePixel& p,
                                                      int c,
                                                      const ValueSide& s,
                                                      float w, float cs) {
  ValueChannel k;
  const float a = p.a[c];
  k.denom_raw = fmaf(s.NH2, a, s.omNH2);
  k.denom = fmaxf(k.denom_raw, kEps);
  const float sv2 = fmaf(a, s.omVN2, s.VN2);
  const float sl2 = fmaf(a, s.omLN2, s.LN2);
  k.isv = rsqrt_approx(sv2);
  k.isl = rsqrt_approx(sl2);
  k.pv = fmaf(sv2, k.isv, s.VN);
  k.pl = fmaf(sl2, k.isl, s.LN);
  k.dd = k.denom * k.denom;
  k.ppl = k.pv * k.pl;
  k.R = rcp_approx(k.dd * k.ppl);
  k.S = a * k.R;
  k.omF = p.oms[c] * w;
  k.cs = cs;
  k.m = fmaf(k.omF, p.albedo[c] - k.S, k.S);
  k.r = fmaf(k.m, cs, kEpsRender);
  return k;
}

// The cotangents one side's channels leave for the normal's chain: of
// NH^2, VN, LN and scale.
struct NormalCotangent {
  float NH2 = 0.f, VN = 0.f, LN = 0.f, scale = 0.f;
};

// A side's 12 gradient accumulators in the planes' order (normal, albedo,
// d/da, which the store turns into d/d roughness, specular), in registers.
struct Grad12 {
  float v[12] = {};
  __device__ __forceinline__ float operator[](int i) const { return v[i]; }
  __device__ __forceinline__ void add(int i, float x) { v[i] += x; }
  __device__ __forceinline__ void fma(int i, float x, float y) {
    v[i] = fmaf(x, y, v[i]);
  }
};

// The VJP of u * r_c of one side: adds d/d albedo, d/da and d/d specular
// of channel c to d and the normal-dependent cotangents to nc.
__device__ __forceinline__ void value_channel_vjp(
    float u, const VjpPixel& p, int c, const ValueSide& s,
    const ValueChannel& k, float w, float color_pi, Grad12& d,
    NormalCotangent& nc) {
  const float t = u * k.cs;  // d/dm
  d.fma(3 + c, t, k.omF);
  d.fma(9 + c, -t * (p.albedo[c] - k.S), w);
  const float dS = fmaf(-t, k.omF, t);
  const float kk = -dS * k.S;  // dP * P
  const float d_denom =
      k.denom_raw >= kEps ? 2.f * (kk * (k.R * k.ppl)) * k.denom : 0.f;
  const float qp = kk * (k.R * k.dd);  // d/d pv = qp pl, d/d pl = qp pv
  const float d_pv = qp * k.pl;
  const float d_pl = qp * k.pv;
  const float ev = d_pv * k.isv;  // 2 d/d sv^2
  const float el = d_pl * k.isl;
  d.add(6 + c, fmaf(dS, k.R,
                    fmaf(d_denom, s.NH2,
                         0.5f * fmaf(ev, s.omVN2, el * s.omLN2))));
  nc.NH2 = fmaf(-d_denom, p.oma[c], nc.NH2);
  nc.VN = fmaf(s.VN * p.oma[c], ev, nc.VN + d_pv);
  nc.LN = fmaf(s.LN * p.oma[c], el, nc.LN + d_pl);
  nc.scale = fmaf(u * k.m, color_pi, nc.scale);
}

// The normal's chain of one side after its three channels: through the
// clamps of NH (NH^2 = NH NH, NH = nh where it is not clamped), VN, LN and
// scale = max(ln, 0) / d^2, into d/d normal.
__device__ __forceinline__ void value_normal_vjp(const NormalCotangent& nc,
                                                 const ValueDots& n,
                                                 const ValueGeometry& g,
                                                 Grad12& d) {
  const float d_nh = n.nh >= kEps ? 2.f * n.nh * nc.NH2 : 0.f;
  const float d_vn = n.vn >= kEps ? nc.VN : 0.f;
  const float d_ln = (n.ln >= kEps ? nc.LN : 0.f) +
                     (n.ln >= 0.f ? nc.scale * g.inv_dsq : 0.f);
  d.add(0, fmaf(d_nh, g.hx, fmaf(d_vn, g.vx, d_ln * g.lx)));
  d.add(1, fmaf(d_nh, g.hy, fmaf(d_vn, g.vy, d_ln * g.ly)));
  d.add(2, fmaf(d_nh, g.hz, fmaf(d_vn, g.vz, d_ln * g.lz)));
}

// sum |log(r_p / r_t)| over the S scenes of the block's item and the 3
// colour channels at patch point (x, y), adding each side's VJP to dp and
// dt.
__device__ __forceinline__ float vjp_scene_loop(const VjpPixel& P,
                                                const VjpPixel& T,
                                                const float4* scene_s, int S,
                                                float x, float y, Grad12& dp,
                                                Grad12& dt) {
  float sum = 0.f;
  for (int s = 0; s < S; ++s) {
    const float4* sc = scene_s + kValueSceneVectors * s;
    const ValueGeometry g = value_geometry(sc[0], sc[1], x, y);
    const ValueSide sp = value_side(P, g);
    const ValueSide st = value_side(T, g);
    NormalCotangent np, nt;
    const float4 color = sc[2];
    const float color_pi[3] = {color.x, color.y, color.z};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const ValueChannel kp =
          value_channel(P, c, sp, g.w, color_pi[c] * sp.scale);
      const ValueChannel kt =
          value_channel(T, c, st, g.w, color_pi[c] * st.scale);
      const float inv = rcp_approx(kp.r * kt.r);
      const float lg = log_positive(quotient(kp.r, kt.r, kp.r * inv));
      sum += fabsf(lg);
      const float sgn = sign0(lg);
      value_channel_vjp(sgn * (kt.r * inv), P, c, sp, kp, g.w, color_pi[c],
                        dp, np);
      value_channel_vjp(-sgn * (kp.r * inv), T, c, st, kt, g.w, color_pi[c],
                        dt, nt);
    }
    value_normal_vjp(np, value_dots(P, g), g, dp);
    value_normal_vjp(nt, value_dots(T, g), g, dt);
  }
  return sum;
}

// Writes one side's gradient, scaled by inv_count, to its planes (plane c
// at out[c * hw]): d/da turned into d/d roughness = d/da 4 rough^3 through
// the clamp, with the roughness read again from the side's input planes v.
template <class Plane>
__device__ __forceinline__ void store_gradient(const Grad12& d,
                                               const Plane* __restrict__ v,
                                               int hw, float inv_count,
                                               Plane* __restrict__ out) {
#pragma unroll
  for (int c = 0; c < 12; ++c) {
    float x = d[c];
    if (c >= 6 && c < 9) {
      const float rough = to_f32(v[(size_t)c * hw]);
      x = rough >= kEps ? x * 4.f * rough * rough * rough : 0.f;
    }
    out[(size_t)c * hw] = from_f32<Plane>(x * inv_count);
  }
}

}  // namespace svbrdf
