"""Fused loss kernels: the mixed loss (rendering loss + l1_weight * SVBRDF
L1) and the rendering-only loss, each value and gradient in one kernel.

Counterpart of svbrdf_tpu/ops/render_pallas.py at fold=1. Five CUDA
kernels from two sources replace its five TPU kernels:

- csrc/mixed_loss.cu (`mixed_loss_fused_planes`, the single-view main
  path): `mixed_loss_fwdgrad_cuda` (training: the pre-normalized loss
  partials AND the combined gradient d(mixed)/d(pred planes) from a single
  shade of each side per scene) and `mixed_loss_fwd_cuda` (validation: the
  value only);
- csrc/rendering_loss.cu (`rendering_loss_fused_planes`,
  `rendering_loss_fused`): `rendering_loss_fwdgrad_cuda` (value + dpred),
  `rendering_loss_fwd_cuda` (value only) and
  `rendering_loss_fwdgrad_both_cuda` (value + dpred + dgt, for callers that
  differentiate with respect to the target too).

Each has a plain torch version here (`*_plain`): a whole-image, vectorized
translation of the same hand-VJP math. The two training kernels' follow
csrc/shading.cuh op for op (the kernels are bit-exact against them);
`both`'s runs the value algebra of csrc/value_shading.cuh with its VJP
(csrc/value_vjp.cuh), and it and the value-only kernels are held to their
plain versions at a tolerance. The CPU tests hold the plain versions
against JAX, and the chip smoke test holds the kernels against the plain
versions. The dispatching wrappers use the plain version only for CPU
tensors; for CUDA tensors they launch the kernel or raise.

Planes are f32 or bf16, pred and gt in one dtype, as the JAX entries take
them: every kernel and plain version computes in f32, returns the loss in
f32 and writes dpred and dgt in the planes' dtype.

`_FusedMixed` and `_FusedRendering` (torch.autograd.Functions) launch the
value+gradient kernel in forward and save the gradients; backward is a
scalar scale, so no separate backward kernel exists. Outside autograd the
value-only kernel runs.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from svbrdf_tpu_torch.ops import _build
from svbrdf_tpu_torch.scene import Scene

EPSILON_RENDER = 0.1  # log-space epsilon of the renders
EPSILON_L1 = 0.01     # log-space epsilon of diffuse/specular in the L1 term
_EPS = 0.001
_PI = math.pi


def pack_scenes(scenes: Scene) -> torch.Tensor:
    """Scene with (B, S, 3) fields -> packed (B, S, 9) [cam|light|color]."""
    return torch.cat([scenes.camera_pos, scenes.light_pos,
                      scenes.light_color], dim=-1).float().contiguous()


def _normalizers(batch, n_scenes, height, width, global_height, l1_weight):
    """(inv_render, l1_coef): the render term is a mean over B*S*H*W*3
    elements, each L1 map term a mean over B*H*W*3; sharded callers
    normalize by the GLOBAL height."""
    full_height = global_height or height
    inv_render = 1.0 / (batch * n_scenes * full_height * width * 3)
    l1_coef = l1_weight * (1.0 / (batch * full_height * width * 3))
    return inv_render, l1_coef


def _patch_xy(height, width, row_offset, full_height, device):
    """Patch coordinates of every pixel, the TPU kernel's formula
    x = -1 + 2 col / (W - 1), y = 1 - 2 row / (H - 1) with global rows."""
    col = torch.arange(width, dtype=torch.float32, device=device)
    row = (torch.arange(height, dtype=torch.float32, device=device)
           + float(row_offset))
    x = -1.0 + 2.0 * col / (width - 1)
    y = 1.0 - 2.0 * row / (full_height - 1)
    return x[None, :].expand(height, width), y[:, None].expand(height, width)


# --- Plain versions ----------------------------------------------------------
#
# Per-plane tensors are (B, H, W); scene scalars are (B, 1, 1). Derivative
# conventions at the clamps follow autodiff of the same expressions:
# d max(x, k)/dx = [x >= k], chi+ factors are constants.


def _plain_in_f32(plain):
    """`plain` for planes in any dtype the kernels take: bf16 planes are
    computed on in f32, as the kernels load them, and the gradients rounded
    once to bf16, as the kernels store them. The loss stays f32."""
    @functools.wraps(plain)
    def fn(pred_t, gt_t, scenes9, *args, **kwargs):
        if pred_t.dtype != torch.bfloat16:
            return plain(pred_t, gt_t, scenes9, *args, **kwargs)
        out = plain(pred_t.float(), gt_t.float(), scenes9, *args, **kwargs)
        if not isinstance(out, tuple):
            return out
        return (out[0], *(d.to(torch.bfloat16) for d in out[1:]))

    return fn


def _scene_geometry(sc, x, y):
    """View, light and half vectors, d^2 and (1 - VH)^5 of one scene."""
    vx, vy = sc[0] - x, sc[1] - y
    vz = sc[2].expand_as(vx)
    inv_v = torch.rsqrt(vx * vx + vy * vy + vz * vz)
    vx, vy, vz = vx * inv_v, vy * inv_v, vz * inv_v
    lx, ly = sc[3] - x, sc[4] - y
    lz = sc[5].expand_as(lx)
    dist_sq = lx * lx + ly * ly + lz * lz
    inv_dsq = torch.reciprocal(dist_sq)
    inv_l = torch.rsqrt(dist_sq)
    lx, ly, lz = lx * inv_l, ly * inv_l, lz * inv_l
    hx, hy, hz = (vx + lx) * 0.5, (vy + ly) * 0.5, (vz + lz) * 0.5
    inv_h = torch.rsqrt(hx * hx + hy * hy + hz * hz)
    hx, hy, hz = hx * inv_h, hy * inv_h, hz * inv_h
    VH = torch.clamp(vx * hx + vy * hy + vz * hz, min=_EPS)
    o = 1.0 - VH
    return dict(v=(vx, vy, vz), l=(lx, ly, lz), h=(hx, hy, hz),
                inv_dsq=inv_dsq, omv5=o * o * o * o * o)


def _shade_side(p, g, color):
    """One side's radiance per channel plus what its VJP needs. Each
    quotient is a product with one reciprocal per quantity, as in
    csrc/shading.cuh: the kernel and this version round alike."""
    (vx, vy, vz), (lx, ly, lz), (hx, hy, hz) = g["v"], g["l"], g["h"]
    nx, ny, nz = p[:, 0], p[:, 1], p[:, 2]
    nh_raw = nx * hx + ny * hy + nz * hz
    vn_raw = vx * nx + vy * ny + vz * nz
    ln_raw = lx * nx + ly * ny + lz * nz
    NH = torch.clamp(nh_raw, min=_EPS)
    VN = torch.clamp(vn_raw, min=_EPS)
    LN = torch.clamp(ln_raw, min=_EPS)
    NH_sq = NH * NH
    inv_VN = torch.reciprocal(VN)
    inv_LN = torch.reciprocal(LN)
    inv_NH_sq = torch.reciprocal(NH_sq)
    scale = torch.clamp(ln_raw, min=0.0) * g["inv_dsq"]
    tv = (1.0 - VN * VN) * (inv_VN * inv_VN)
    tl = (1.0 - LN * LN) * (inv_LN * inv_LN)
    tn = (1.0 - NH_sq) * inv_NH_sq
    inv_4vnln = inv_VN * inv_LN * 0.25
    shared = dict(NH=NH, NH_sq=NH_sq, inv_VN=inv_VN, inv_LN=inv_LN,
                  scale=scale, tv=tv, tl=tl, inv_4vnln=inv_4vnln,
                  raw=(nh_raw, vn_raw, ln_raw))
    chans = []
    for c in range(3):
        albedo, rough_raw, spec = p[:, 3 + c], p[:, 6 + c], p[:, 9 + c]
        rough = torch.clamp(rough_raw, min=_EPS)
        r2 = rough * rough
        a = r2 * r2
        denom_raw = NH_sq * (a + tn)
        denom = torch.clamp(denom_raw, min=_EPS)
        inv_denom = torch.reciprocal(denom)
        chi = (NH > 0.0).float()
        D = a * chi * (inv_denom * inv_denom) / _PI
        tv1 = 1.0 + a * tv
        inv_sv = torch.rsqrt(tv1)
        rv = torch.reciprocal(1.0 + tv1 * inv_sv)
        g1v = 2.0 * rv
        tl1 = 1.0 + a * tl
        inv_sl = torch.rsqrt(tl1)
        rl = torch.reciprocal(1.0 + tl1 * inv_sl)
        g1l = 2.0 * rl
        G = g1v * g1l
        spec_base = G * D * inv_4vnln
        F = spec + (1.0 - spec) * g["omv5"]
        f = (1.0 - F) * albedo / _PI + F * spec_base
        chans.append(dict(
            albedo=albedo, rough_raw=rough_raw, rough=rough, a=a,
            denom_raw=denom_raw, denom=denom, inv_denom=inv_denom, chi=chi,
            D=D, inv_sv=inv_sv, rv=rv, g1v=g1v, inv_sl=inv_sl, rl=rl,
            g1l=g1l, G=G, spec_base=spec_base, F=F, f=f,
            out=f * color[c] * scale))
    return shared, chans


def _side_bwd(g, color, shared, chans, u):
    """Gradient of sum_c u[c] * out_c wrt one side's 12 planes, (B, 12, H, W)."""
    (vx, vy, vz), (lx, ly, lz), (hx, hy, hz) = g["v"], g["l"], g["h"]
    NH, NH_sq = shared["NH"], shared["NH_sq"]
    inv_VN, inv_LN = shared["inv_VN"], shared["inv_LN"]
    tv, tl, scale = shared["tv"], shared["tl"], shared["scale"]
    inv_4vnln = shared["inv_4vnln"]
    inv_VN3 = inv_VN * inv_VN * inv_VN
    inv_LN3 = inv_LN * inv_LN * inv_LN
    dalbedo, drough, dspec = [], [], []
    A_NH = A_VN = A_LN = A_lp = 0.0
    for c in range(3):
        k = chans[c]
        a, D, G = k["a"], k["D"], k["G"]
        inv_sv, rv, inv_sl, rl = k["inv_sv"], k["rv"], k["inv_sl"], k["rl"]
        w = u[c] * color[c]
        ws = w * scale
        wsF = ws * k["F"]
        dalbedo.append(ws * (1.0 - k["F"]) / _PI)
        dspec.append(ws * (1.0 - g["omv5"]) * (k["spec_base"]
                                               - k["albedo"] / _PI))
        mask_denom = (k["denom_raw"] >= _EPS).float()
        inv_denom = k["inv_denom"]
        inv_denom3 = inv_denom * inv_denom * inv_denom
        dD_da = (k["chi"] * (k["denom"] - 2.0 * a * NH_sq * mask_denom)
                 * inv_denom3 / _PI)
        dg1v_da = -tv * rv * rv * inv_sv
        dg1l_da = -tl * rl * rl * inv_sl
        dG_da = dg1v_da * k["g1l"] + k["g1v"] * dg1l_da
        dsb_da = (dG_da * D + G * dD_da) * inv_4vnln
        mask_r = (k["rough_raw"] >= _EPS).float()
        rough = k["rough"]
        drough.append(wsF * dsb_da * 4.0 * rough * rough * rough * mask_r)
        dsb_dNH = ((G * inv_4vnln)
                   * (-2.0 * a * k["chi"] * inv_denom3 / _PI)
                   * 2.0 * NH * (a - 1.0) * mask_denom)
        dg1v_dVN = 2.0 * a * rv * rv * inv_sv * inv_VN3
        dsb_dVN = (dg1v_dVN * k["g1l"] * D - G * D * inv_VN) * inv_4vnln
        dg1l_dLN = 2.0 * a * rl * rl * inv_sl * inv_LN3
        dsb_dLN = (k["g1v"] * dg1l_dLN * D - G * D * inv_LN) * inv_4vnln
        A_NH = A_NH + wsF * dsb_dNH
        A_VN = A_VN + wsF * dsb_dVN
        A_LN = A_LN + wsF * dsb_dLN
        A_lp = A_lp + w * k["f"] * g["inv_dsq"]
    nh_raw, vn_raw, ln_raw = shared["raw"]
    cn = A_NH * (nh_raw >= _EPS).float()
    cv = A_VN * (vn_raw >= _EPS).float()
    cl = A_LN * (ln_raw >= _EPS).float() + A_lp * (ln_raw >= 0.0).float()
    dn = [cn * hx + cv * vx + cl * lx, cn * hy + cv * vy + cl * ly,
          cn * hz + cv * vz + cl * lz]
    return torch.stack(dn + dalbedo + drough + dspec, dim=1)


def _l1_terms(pred_t, gt_t):
    """SVBRDF L1 sum over all elements and its gradient wrt pred: plain
    L1 on normals and roughness, L1 of log(x + 0.01) on diffuse/specular."""
    dn = pred_t[:, 0:3] - gt_t[:, 0:3]
    dr = pred_t[:, 6:9] - gt_t[:, 6:9]
    pd = pred_t[:, 3:6] + EPSILON_L1
    ps = pred_t[:, 9:12] + EPSILON_L1
    dd = torch.log(pd) - torch.log(gt_t[:, 3:6] + EPSILON_L1)
    ds = torch.log(ps) - torch.log(gt_t[:, 9:12] + EPSILON_L1)
    l1 = (torch.sum(torch.abs(dn)) + torch.sum(torch.abs(dd))
          + torch.sum(torch.abs(dr)) + torch.sum(torch.abs(ds)))
    grad = torch.cat([torch.sign(dn), torch.sign(dd) * torch.reciprocal(pd),
                      torch.sign(dr), torch.sign(ds) * torch.reciprocal(ps)],
                     dim=1)
    return l1, grad


def _mixed_plain(pred_t, gt_t, scenes9, row_offset, global_height,
                 l1_weight, with_grad):
    batch, _, height, width = pred_t.shape
    n_scenes = scenes9.shape[1]
    inv_render, l1_coef = _normalizers(batch, n_scenes, height, width,
                                       global_height, l1_weight)
    x, y = _patch_xy(height, width, row_offset, global_height or height,
                     pred_t.device)
    total = torch.zeros((), dtype=torch.float32, device=pred_t.device)
    dpred = torch.zeros_like(pred_t) if with_grad else None
    for s in range(n_scenes):
        sc = [scenes9[:, s, k, None, None] for k in range(9)]
        color = sc[6:9]
        g = _scene_geometry(sc, x, y)
        shr_p, ch_p = _shade_side(pred_t, g, color)
        _, ch_t = _shade_side(gt_t, g, color)
        u = []
        for c in range(3):
            rp = ch_p[c]["out"] + EPSILON_RENDER
            diff = torch.log(rp) - torch.log(ch_t[c]["out"] + EPSILON_RENDER)
            total = total + torch.sum(torch.abs(diff))
            u.append(torch.sign(diff) * torch.reciprocal(rp))
        if with_grad:
            dpred = dpred + _side_bwd(g, color, shr_p, ch_p, u)
    l1, dl1 = _l1_terms(pred_t, gt_t)
    loss = total * inv_render + l1_coef * l1
    if not with_grad:
        return loss
    return loss, dpred * inv_render + l1_coef * dl1


@_plain_in_f32
def mixed_loss_fwdgrad_plain(pred_t, gt_t, scenes9, row_offset: int = 0,
                             global_height: int = 0, l1_weight: float = 0.1):
    """Plain version of the value+gradient kernel: (loss, dpred)."""
    return _mixed_plain(pred_t, gt_t, scenes9, row_offset, global_height,
                        l1_weight, with_grad=True)


@_plain_in_f32
def mixed_loss_fwd_plain(pred_t, gt_t, scenes9, row_offset: int = 0,
                         global_height: int = 0, l1_weight: float = 0.1):
    """Plain version of the value-only kernel: loss."""
    return _mixed_plain(pred_t, gt_t, scenes9, row_offset, global_height,
                        l1_weight, with_grad=False)


def _count(batch, n_scenes, height, width, global_height):
    """The rendering loss's normalizer, B*S*H*W*3 with the GLOBAL height:
    a sharded caller's local values over the global count sum to the
    whole image's loss."""
    return batch * n_scenes * (global_height or height) * width * 3


def _rendering_plain(pred_t, gt_t, scenes9, row_offset, global_height,
                     with_grad):
    """_scene_loss_and_grads over every scene: the loss and, as asked,
    dpred scaled by 1/count."""
    batch, _, height, width = pred_t.shape
    n_scenes = scenes9.shape[1]
    count = _count(batch, n_scenes, height, width, global_height)
    x, y = _patch_xy(height, width, row_offset, global_height or height,
                     pred_t.device)
    total = torch.zeros((), dtype=torch.float32, device=pred_t.device)
    dpred = torch.zeros_like(pred_t) if with_grad else None
    for s in range(n_scenes):
        sc = [scenes9[:, s, k, None, None] for k in range(9)]
        color = sc[6:9]
        g = _scene_geometry(sc, x, y)
        shr_p, ch_p = _shade_side(pred_t, g, color)
        _, ch_t = _shade_side(gt_t, g, color)
        u_pred = []
        for c in range(3):
            rp = ch_p[c]["out"] + EPSILON_RENDER
            diff = torch.log(rp) - torch.log(ch_t[c]["out"] + EPSILON_RENDER)
            total = total + torch.sum(torch.abs(diff))
            u_pred.append(torch.sign(diff) * torch.reciprocal(rp))
        if with_grad:
            dpred = dpred + _side_bwd(g, color, shr_p, ch_p, u_pred)
    loss = total / count
    if not with_grad:
        return loss
    return loss, dpred * (1.0 / count)


# The value algebra of csrc/value_shading.cuh and the VJP on it
# (csrc/value_vjp.cuh), for the kernel with both gradients. With the clamps
#   denom = a NH^2 + 1 - NH^2,  pv = VN + sqrt(a (1 - VN^2) + VN^2) (and pl
#   for l),  P = denom^2 pv pl,  R = 1/P,  S = a R = pi * spec_base,
#   1 - F = (1 - spec) w,  w = 1 - (1 - VH)^5,
#   r = ((1 - F)(albedo - S) + S) (colour / pi) scale + 0.1,
# and the loss term |log(r_p / r_t)|.


def _value_geometry(sc, x, y):
    """Unit v, l and h, 1/d^2 = (1/d)^2 and w of one scene."""
    vx, vy = sc[0] - x, sc[1] - y
    inv_v = torch.rsqrt(vx * vx + vy * vy + sc[2] * sc[2])
    lx, ly = sc[3] - x, sc[4] - y
    inv_l = torch.rsqrt(lx * lx + ly * ly + sc[5] * sc[5])
    v = (vx * inv_v, vy * inv_v, sc[2] * inv_v)
    light = (lx * inv_l, ly * inv_l, sc[5] * inv_l)
    h = [vk + lk for vk, lk in zip(v, light)]
    inv_h = torch.rsqrt(h[0] * h[0] + h[1] * h[1] + h[2] * h[2])
    h = tuple(hk * inv_h for hk in h)
    o = 1.0 - torch.clamp(v[0] * h[0] + v[1] * h[1] + v[2] * h[2], min=_EPS)
    o2 = o * o
    return dict(v=v, l=light, h=h, inv_dsq=inv_l * inv_l, w=1.0 - o2 * o2 * o)


def _value_pixel(planes):
    """One side's scene-independent terms: a = max(roughness, eps)^4 and
    1 - specular per channel."""
    rough = torch.clamp(planes[:, 6:9], min=_EPS)
    r2 = rough * rough
    return dict(n=planes[:, 0:3], albedo=planes[:, 3:6], a=r2 * r2,
                oms=1.0 - planes[:, 9:12])


def _dot_n(n, vec):
    return n[:, 0] * vec[0] + n[:, 1] * vec[1] + n[:, 2] * vec[2]


def _value_side(px, g):
    """One side's normal-dependent terms: the raw dots (for the clamps'
    derivatives), the clamped NH, VN, LN and scale = max(LN, 0) / d^2."""
    nh, vn, ln = (_dot_n(px["n"], g[k]) for k in ("h", "v", "l"))
    NH = torch.clamp(nh, min=_EPS)
    VN = torch.clamp(vn, min=_EPS)
    LN = torch.clamp(ln, min=_EPS)
    return dict(nh=nh, vn=vn, ln=ln, NH=NH, NH2=NH * NH, VN=VN, VN2=VN * VN,
                LN=LN, LN2=LN * LN,
                scale=torch.clamp(ln, min=0.0) * g["inv_dsq"])


def _value_channel(px, c, s, w, color_pi):
    """Channel c of one side: r and the intermediates its VJP reuses."""
    a = px["a"][:, c]
    denom_raw = s["NH2"] * a + (1.0 - s["NH2"])
    denom = torch.clamp(denom_raw, min=_EPS)
    sv2 = a * (1.0 - s["VN2"]) + s["VN2"]
    sl2 = a * (1.0 - s["LN2"]) + s["LN2"]
    isv, isl = torch.rsqrt(sv2), torch.rsqrt(sl2)
    pv, pl = sv2 * isv + s["VN"], sl2 * isl + s["LN"]
    dd, ppl = denom * denom, pv * pl
    R = torch.reciprocal(dd * ppl)
    S = a * R
    omF = px["oms"][:, c] * w
    m = omF * (px["albedo"][:, c] - S) + S
    cs = color_pi * s["scale"]
    return dict(a=a, denom_raw=denom_raw, denom=denom, isv=isv, isl=isl,
                pv=pv, pl=pl, dd=dd, ppl=ppl, R=R, S=S, omF=omF, m=m, cs=cs,
                r=m * cs + EPSILON_RENDER)


def _value_channel_vjp(u, px, c, s, k, w, color_pi, d, nc):
    """The VJP of u * r_c of one side: adds d/d albedo, d/da and d/d
    specular of channel c to d["albedo"][c], d["a"][c] and d["spec"][c],
    and the cotangents of NH^2, VN, LN and scale to nc."""
    t = u * k["cs"]
    d["albedo"][c] = d["albedo"][c] + t * k["omF"]
    d["spec"][c] = d["spec"][c] - t * (px["albedo"][:, c] - k["S"]) * w
    dS = t * (1.0 - k["omF"])
    # d/dP = -dS * S * R, times the products already formed: d/d denom =
    # 2 d/dP denom pv pl, d/d pv = d/dP denom^2 pl (and pl), with R pv pl =
    # 1 / denom^2 and R denom^2 = 1 / (pv pl).
    kk = -(dS * k["S"])
    d_denom = torch.where(k["denom_raw"] >= _EPS,
                          2.0 * (kk * (k["R"] * k["ppl"])) * k["denom"], 0.0)
    qp = kk * (k["R"] * k["dd"])
    ev = qp * k["pl"] * k["isv"]  # d/d sv^2 = ev / 2
    el = qp * k["pv"] * k["isl"]
    d["a"][c] = d["a"][c] + (dS * k["R"] + d_denom * s["NH2"]
                             + 0.5 * (ev * (1.0 - s["VN2"])
                                      + el * (1.0 - s["LN2"])))
    oma = 1.0 - k["a"]
    nc["NH2"] = nc["NH2"] - d_denom * oma
    nc["VN"] = nc["VN"] + qp * k["pl"] + s["VN"] * oma * ev
    nc["LN"] = nc["LN"] + qp * k["pv"] + s["LN"] * oma * el
    nc["scale"] = nc["scale"] + u * k["m"] * color_pi


def _value_normal_vjp(nc, s, g, d):
    """The normal's chain of one side: through the clamps of NH, VN, LN
    and scale into d["n"]."""
    d_nh = torch.where(s["nh"] >= _EPS, nc["NH2"] * 2.0 * s["NH"], 0.0)
    d_vn = torch.where(s["vn"] >= _EPS, nc["VN"], 0.0)
    d_ln = (torch.where(s["ln"] >= _EPS, nc["LN"], 0.0)
            + torch.where(s["ln"] >= 0.0, nc["scale"] * g["inv_dsq"], 0.0))
    for i in range(3):
        d["n"][i] = (d["n"][i] + d_nh * g["h"][i] + d_vn * g["v"][i]
                     + d_ln * g["l"][i])


@_plain_in_f32
def rendering_loss_fwdgrad_both_plain(pred_t, gt_t, scenes9,
                                      row_offset: int = 0,
                                      global_height: int = 0):
    """Plain version of the kernel with both gradients: (loss, dpred,
    dgt), on the value algebra with its VJP, one log of each ratio."""
    batch, _, height, width = pred_t.shape
    n_scenes = scenes9.shape[1]
    count = _count(batch, n_scenes, height, width, global_height)
    x, y = _patch_xy(height, width, row_offset, global_height or height,
                     pred_t.device)
    pixels = (_value_pixel(pred_t), _value_pixel(gt_t))
    zero = torch.zeros_like(pred_t[:, 0])
    grads = [{k: [zero] * 3 for k in ("n", "albedo", "a", "spec")}
             for _ in pixels]
    total = torch.zeros((), dtype=torch.float32, device=pred_t.device)
    for s in range(n_scenes):
        sc = [scenes9[:, s, k, None, None] for k in range(9)]
        g = _value_geometry(sc, x, y)
        sides = [_value_side(px, g) for px in pixels]
        cots = [dict.fromkeys(("NH2", "VN", "LN", "scale"), zero)
                for _ in pixels]
        for c in range(3):
            color_pi = sc[6 + c] * (1.0 / _PI)
            kp, kt = (_value_channel(px, c, side, g["w"], color_pi)
                      for px, side in zip(pixels, sides))
            # One reciprocal of r_p r_t gives 1/r_p and 1/r_t.
            inv = torch.reciprocal(kp["r"] * kt["r"])
            diff = torch.log(kp["r"] / kt["r"])
            total = total + torch.sum(torch.abs(diff))
            sign = torch.sign(diff)
            for u, px, side, k, d, nc in zip(
                    (sign * (kt["r"] * inv), -sign * (kp["r"] * inv)),
                    pixels, sides, (kp, kt), grads, cots):
                _value_channel_vjp(u, px, c, side, k, g["w"], color_pi, d,
                                   nc)
        for side, d, nc in zip(sides, grads, cots):
            _value_normal_vjp(nc, side, g, d)
    inv_count = 1.0 / count
    out = []
    for planes, d in zip((pred_t, gt_t), grads):
        # d/d roughness = d/da * 4 rough^3 through the clamp.
        rough = planes[:, 6:9]
        drough = [torch.where(rough[:, c] >= _EPS,
                              d["a"][c] * 4.0 * rough[:, c] * rough[:, c]
                              * rough[:, c], 0.0) for c in range(3)]
        out.append(torch.stack(d["n"] + d["albedo"] + drough + d["spec"],
                               dim=1) * inv_count)
    return (total / count, *out)


# The float64 kink distance (kink_distance) from which on the tests hold
# the kernel with both gradients to float64: ~10x an f32 evaluation's
# rounding of a log ratio or of a clamp's argument.
KINK_MARGIN = 1e-5


def kink_distance(pred_t, gt_t, scenes9, row_offset: int = 0,
                  global_height: int = 0):
    """Per pixel, (B, H, W): how far it lies from the points where the
    rendering loss is not differentiable, the smallest over both sides and
    every scene and channel of |log(r_p / r_t)| (unless exactly 0, as where
    the light reaches neither side: that term is 0 in any precision) and of
    the clamps' arguments' distances from their kinks: n.h, n.v, n.l, the
    denominator and the roughness from eps, n.l from 0. Computed on the
    value algebra in the inputs' dtype. Where a pixel lies closer to one
    than f32 rounding, an f32 evaluation may take either one-sided
    derivative, so the tests of the kernel with both gradients hold its
    gradients to float64 on the pixels at KINK_MARGIN or further (the
    distance evaluated in float64)."""
    height, width = pred_t.shape[2:]
    x, y = _patch_xy(height, width, row_offset, global_height or height,
                     pred_t.device)
    pixels = (_value_pixel(pred_t), _value_pixel(gt_t))
    dist = torch.minimum(*((planes[:, 6:9] - _EPS).abs().amin(dim=1)
                           for planes in (pred_t, gt_t)))
    for s in range(scenes9.shape[1]):
        sc = [scenes9[:, s, k, None, None] for k in range(9)]
        g = _value_geometry(sc, x, y)
        sides = [_value_side(px, g) for px in pixels]
        for side in sides:
            for arg in (side["nh"] - _EPS, side["vn"] - _EPS,
                        side["ln"] - _EPS, side["ln"]):
                dist = torch.minimum(dist, arg.abs())
        for c in range(3):
            color_pi = sc[6 + c] * (1.0 / _PI)
            kp, kt = (_value_channel(px, c, side, g["w"], color_pi)
                      for px, side in zip(pixels, sides))
            log_ratio = torch.log(kp["r"] / kt["r"]).abs()
            dist = torch.minimum(dist, torch.where(
                log_ratio == 0, math.inf, log_ratio))
            for k in (kp, kt):
                dist = torch.minimum(dist, (k["denom_raw"] - _EPS).abs())
    return dist


@_plain_in_f32
def rendering_loss_fwdgrad_plain(pred_t, gt_t, scenes9, row_offset: int = 0,
                                 global_height: int = 0):
    """Plain version of the rendering loss's value+gradient kernel:
    (loss, dpred)."""
    return _rendering_plain(pred_t, gt_t, scenes9, row_offset, global_height,
                            with_grad=True)


@_plain_in_f32
def rendering_loss_fwd_plain(pred_t, gt_t, scenes9, row_offset: int = 0,
                             global_height: int = 0):
    """Plain version of the rendering loss's value-only kernel: loss."""
    return _rendering_plain(pred_t, gt_t, scenes9, row_offset, global_height,
                            with_grad=False)


# --- CUDA kernels ------------------------------------------------------------

# Each kernel's C entry: (source in csrc/, symbol, output planes beside the
# partials, float arguments after the six ints). The symbol takes f32
# planes; <symbol>_bf16 takes bf16 planes and writes bf16 gradients, with
# the same arguments. Beside each entry the library exports
# <symbol>_blocks_per_sm (and <symbol>_bf16_blocks_per_sm).
_ENTRIES = {
    "mixed_fwdgrad": ("mixed_loss", "svbrdf_mixed_loss_fwdgrad", 1, 2),
    "mixed_fwd": ("mixed_loss", "svbrdf_mixed_loss_fwd", 0, 2),
    "render_fwdgrad": ("rendering_loss", "svbrdf_rendering_loss_fwdgrad", 1,
                       1),
    "render_fwd": ("rendering_loss", "svbrdf_rendering_loss_fwd", 0, 0),
    "render_fwdgrad_both": ("rendering_loss",
                            "svbrdf_rendering_loss_fwdgrad_both", 2, 1),
}
# The plane dtypes the kernels take, and the suffix of each one's symbols.
PLANE_DTYPES = {torch.float32: "", torch.bfloat16: "_bf16"}
_FUNCS = {}


def symbol(name: str, dtype: torch.dtype = torch.float32) -> str:
    """The C entry of kernel `name` for planes of `dtype`."""
    return _ENTRIES[name][1] + PLANE_DTYPES[dtype]


def _bind(lib, name, dtype=torch.float32):
    """(C entry, threads per block) of kernel `name` for planes of `dtype`
    in the loaded library `lib`, the signatures declared."""
    source, _, n_planes, n_floats = _ENTRIES[name]
    fn = getattr(lib, symbol(name, dtype))
    # pred, gt, scenes, partials, planes...; B, H, W, S, row_offset,
    # full_height; floats...; stream
    fn.argtypes = ([ctypes.c_void_p] * (4 + n_planes)
                   + [ctypes.c_int] * 6 + [ctypes.c_float] * n_floats
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    threads = getattr(lib, f"svbrdf_{source}_threads")
    threads.argtypes = []
    threads.restype = ctypes.c_int
    return fn, threads()


def _kernel(name, dtype=torch.float32):
    """(C entry, threads per block, blocks-per-SM query) of kernel `name`
    for planes of `dtype`, its library built and loaded at first use and
    the signatures declared."""
    if (name, dtype) not in _FUNCS:
        lib = _build.load(_ENTRIES[name][0])
        per_sm = getattr(lib, f"{symbol(name, dtype)}_blocks_per_sm")
        per_sm.argtypes = [ctypes.c_int]  # S
        per_sm.restype = ctypes.c_int
        _FUNCS[name, dtype] = (*_bind(lib, name, dtype), per_sm)
    return _FUNCS[name, dtype]


def blocks_per_sm(name: str, n_scenes: int,
                  dtype: torch.dtype = torch.float32) -> int:
    """Blocks of kernel `name` for planes of `dtype` that fit one SM of the
    current CUDA device at `n_scenes` scenes
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    n = _kernel(name, dtype)[2](n_scenes)
    if n <= 0:
        raise RuntimeError(f"occupancy query of the {name} kernel failed: "
                           f"CUDA error {-n}")
    return n


def _check(pred_t, gt_t, scenes9):
    if pred_t.dim() != 4 or pred_t.shape[1] != 12:
        raise ValueError(f"pred planes must be (B, 12, H, W), got "
                         f"{tuple(pred_t.shape)}")
    if gt_t.shape != pred_t.shape:
        raise ValueError(f"gt planes {tuple(gt_t.shape)} do not match pred "
                         f"{tuple(pred_t.shape)}")
    if scenes9.dim() != 3 or scenes9.shape[0] != pred_t.shape[0] \
            or scenes9.shape[2] != 9:
        raise ValueError(f"scenes must be (B, S, 9), got "
                         f"{tuple(scenes9.shape)}")
    if pred_t.dtype not in PLANE_DTYPES:
        raise TypeError(f"pred must be float32 or bfloat16, got "
                        f"{pred_t.dtype}")
    if gt_t.dtype != pred_t.dtype:
        raise TypeError(f"gt is {gt_t.dtype} and pred {pred_t.dtype}: the "
                        f"planes must share one dtype")
    if scenes9.dtype != torch.float32:
        raise TypeError(f"scenes must be float32, got {scenes9.dtype}")
    for name, t in (("pred", pred_t), ("gt", gt_t), ("scenes", scenes9)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != pred_t.device:
            raise ValueError(f"{name} is on {t.device}, pred on "
                             f"{pred_t.device}")


def _launch(name, pred_t, gt_t, scenes9, row_offset, global_height, floats,
            kernel=None):
    """Launch kernel `name` on the current stream: (partials, output
    planes...), the partials f32 and the planes in the inputs' dtype.
    `floats` are its float arguments; `kernel` is a (C entry, threads per
    block) pair from _bind, by default the package's own for the inputs'
    dtype."""
    if pred_t.device.type != "cuda":
        raise RuntimeError(f"the {name} kernel needs CUDA tensors, got "
                           f"{pred_t.device}")
    fn, threads = kernel or _kernel(name, pred_t.dtype)[:2]
    batch, _, height, width = pred_t.shape
    blocks = -(-(height * width) // threads)
    partials = torch.empty(batch * blocks, dtype=torch.float32,
                           device=pred_t.device)
    planes = [torch.empty_like(pred_t) for _ in range(_ENTRIES[name][2])]
    args = ([pred_t.data_ptr(), gt_t.data_ptr(), scenes9.data_ptr(),
             partials.data_ptr()] + [t.data_ptr() for t in planes]
            + [batch, height, width, scenes9.shape[1], int(row_offset),
               int(global_height or height), *floats])
    with torch.cuda.device(pred_t.device):
        args.append(torch.cuda.current_stream().cuda_stream)
        rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return (partials, *planes)


def _mixed_floats(pred_t, scenes9, global_height, l1_weight):
    batch, _, height, width = pred_t.shape
    return _normalizers(batch, scenes9.shape[1], height, width, global_height,
                        l1_weight)


def _rendering_count(pred_t, scenes9, global_height):
    batch, _, height, width = pred_t.shape
    return _count(batch, scenes9.shape[1], height, width, global_height)


def _counted(wrapper, pred_t) -> None:
    """One launch of `wrapper`'s kernel, counted in total and by the planes'
    dtype."""
    wrapper.launches += 1
    wrapper.launches_by_dtype[pred_t.dtype] += 1


def mixed_loss_fwdgrad_cuda(pred_t, gt_t, scenes9, row_offset: int = 0,
                            global_height: int = 0, l1_weight: float = 0.1):
    """Launch the mixed loss's value+gradient kernel: (loss, dpred). The
    loss is the sum of one pre-normalized partial per thread block."""
    _check(pred_t, gt_t, scenes9)
    partials, dpred = _launch(
        "mixed_fwdgrad", pred_t, gt_t, scenes9, row_offset, global_height,
        _mixed_floats(pred_t, scenes9, global_height, l1_weight))
    _counted(mixed_loss_fwdgrad_cuda, pred_t)
    return torch.sum(partials), dpred


def mixed_loss_fwd_cuda(pred_t, gt_t, scenes9, row_offset: int = 0,
                        global_height: int = 0, l1_weight: float = 0.1):
    """Launch the mixed loss's value-only kernel: loss."""
    _check(pred_t, gt_t, scenes9)
    partials, = _launch(
        "mixed_fwd", pred_t, gt_t, scenes9, row_offset, global_height,
        _mixed_floats(pred_t, scenes9, global_height, l1_weight))
    _counted(mixed_loss_fwd_cuda, pred_t)
    return torch.sum(partials)


def rendering_loss_fwdgrad_cuda(pred_t, gt_t, scenes9, row_offset: int = 0,
                                global_height: int = 0):
    """Launch the rendering loss's value+gradient kernel: (loss, dpred).
    The loss is the sum of one raw partial per thread block over count."""
    _check(pred_t, gt_t, scenes9)
    count = _rendering_count(pred_t, scenes9, global_height)
    partials, dpred = _launch("render_fwdgrad", pred_t, gt_t, scenes9,
                              row_offset, global_height, (1.0 / count,))
    _counted(rendering_loss_fwdgrad_cuda, pred_t)
    return torch.sum(partials) / count, dpred


def rendering_loss_fwd_cuda(pred_t, gt_t, scenes9, row_offset: int = 0,
                            global_height: int = 0):
    """Launch the rendering loss's value-only kernel: loss."""
    _check(pred_t, gt_t, scenes9)
    count = _rendering_count(pred_t, scenes9, global_height)
    partials, = _launch("render_fwd", pred_t, gt_t, scenes9, row_offset,
                        global_height, ())
    _counted(rendering_loss_fwd_cuda, pred_t)
    return torch.sum(partials) / count


def rendering_loss_fwdgrad_both_cuda(pred_t, gt_t, scenes9,
                                     row_offset: int = 0,
                                     global_height: int = 0):
    """Launch the rendering loss's kernel with both gradients: (loss,
    dpred, dgt)."""
    _check(pred_t, gt_t, scenes9)
    count = _rendering_count(pred_t, scenes9, global_height)
    partials, dpred, dgt = _launch("render_fwdgrad_both", pred_t, gt_t,
                                   scenes9, row_offset, global_height,
                                   (1.0 / count,))
    _counted(rendering_loss_fwdgrad_both_cuda, pred_t)
    return torch.sum(partials) / count, dpred, dgt


CUDA_WRAPPERS = {
    "mixed_fwdgrad": mixed_loss_fwdgrad_cuda,
    "mixed_fwd": mixed_loss_fwd_cuda,
    "render_fwdgrad": rendering_loss_fwdgrad_cuda,
    "render_fwd": rendering_loss_fwd_cuda,
    "render_fwdgrad_both": rendering_loss_fwdgrad_both_cuda,
}
for _wrapper in CUDA_WRAPPERS.values():
    _wrapper.launches = 0
    _wrapper.launches_by_dtype = dict.fromkeys(PLANE_DTYPES, 0)

PLAIN_VERSIONS = {
    "mixed_fwdgrad": mixed_loss_fwdgrad_plain,
    "mixed_fwd": mixed_loss_fwd_plain,
    "render_fwdgrad": rendering_loss_fwdgrad_plain,
    "render_fwd": rendering_loss_fwd_plain,
    "render_fwdgrad_both": rendering_loss_fwdgrad_both_plain,
}


def kernel_floats(name, pred_t, scenes9):
    """The float arguments the wrapper of kernel `name` passes for a whole
    image (no row offset) and the default l1_weight."""
    if name.startswith("mixed"):
        return _mixed_floats(pred_t, scenes9, 0, 0.1)
    if name == "render_fwd":
        return ()
    return (1.0 / _rendering_count(pred_t, scenes9, 0),)


def _dispatch(plain, cuda):
    """A wrapper that runs `plain` for CPU tensors and `cuda` otherwise."""
    def fn(pred_t, gt_t, scenes9, *args, **kwargs):
        if pred_t.device.type == "cpu":
            _check(pred_t, gt_t, scenes9)
            return plain(pred_t, gt_t, scenes9, *args, **kwargs)
        return cuda(pred_t, gt_t, scenes9, *args, **kwargs)

    fn.__doc__ = (f"{cuda.__name__} for CUDA tensors, {plain.__name__} for "
                  f"CPU tensors.")
    return fn


mixed_loss_fwdgrad = _dispatch(mixed_loss_fwdgrad_plain,
                               mixed_loss_fwdgrad_cuda)
mixed_loss_fwd = _dispatch(mixed_loss_fwd_plain, mixed_loss_fwd_cuda)
rendering_loss_fwdgrad = _dispatch(rendering_loss_fwdgrad_plain,
                                   rendering_loss_fwdgrad_cuda)
rendering_loss_fwd = _dispatch(rendering_loss_fwd_plain,
                               rendering_loss_fwd_cuda)
rendering_loss_fwdgrad_both = _dispatch(rendering_loss_fwdgrad_both_plain,
                                        rendering_loss_fwdgrad_both_cuda)


def _scaled(d, grad_output):
    """A saved gradient times the upstream scalar, multiplied in f32 and
    rounded once to the gradient's dtype, as the JAX entries' backward
    (_fused_bwd) takes it: a bf16 gradient is not scaled by a bf16-rounded
    upstream."""
    return (d.float() * grad_output).to(d.dtype)


class _FusedMixed(torch.autograd.Function):
    """Forward runs the value+gradient kernel and keeps dpred; backward
    scales it by the upstream scalar. The target gets no gradient."""

    @staticmethod
    def forward(ctx, pred_t, gt_t, scenes9, row_offset, global_height,
                l1_weight):
        loss, dpred = mixed_loss_fwdgrad(pred_t, gt_t, scenes9, row_offset,
                                         global_height, l1_weight)
        ctx.save_for_backward(dpred)
        return loss

    @staticmethod
    def backward(ctx, grad_output):
        dpred, = ctx.saved_tensors
        return _scaled(dpred, grad_output), None, None, None, None, None


def mixed_loss_fused_planes(pred_t: torch.Tensor, gt_t: torch.Tensor,
                            scenes: Scene, l1_weight: float = 0.1,
                            row_offset: int = 0,
                            global_height: int = 0) -> torch.Tensor:
    """Mixed loss l1_weight * svbrdf_l1 + rendering loss on (B, 12, H, W)
    f32 or bf16 channel planes (pred and gt in one dtype; the loss f32, the
    gradient in the planes' dtype), for per-item scene sets `scenes`
    ((B, S, 3) fields).

    A sharded caller that holds rows [row_offset, row_offset + H) of an
    image `global_height` rows tall passes both: the patch coordinates and
    the normalizers are then the global ones, so the shards' values sum to
    the whole image's loss. The target is treated as data (no gradient).
    """
    gt_t = gt_t.detach()
    scenes9 = pack_scenes(scenes)
    args = (pred_t, gt_t, scenes9, int(row_offset), int(global_height),
            float(l1_weight))
    if torch.is_grad_enabled() and pred_t.requires_grad:
        return _FusedMixed.apply(*args)
    return mixed_loss_fwd(*args)


class _FusedRendering(torch.autograd.Function):
    """Forward runs the value+gradient kernel (with `want_target_grad` the
    one that also gives dgt) and keeps the gradients; backward scales them
    by the upstream scalar."""

    @staticmethod
    def forward(ctx, pred_t, gt_t, scenes9, row_offset, global_height,
                want_target_grad):
        if want_target_grad:
            loss, *grads = rendering_loss_fwdgrad_both(
                pred_t, gt_t, scenes9, row_offset, global_height)
        else:
            loss, *grads = rendering_loss_fwdgrad(pred_t, gt_t, scenes9,
                                                  row_offset, global_height)
        ctx.save_for_backward(*grads)
        return loss

    @staticmethod
    def backward(ctx, grad_output):
        dpred, *dgt = ctx.saved_tensors
        return (_scaled(dpred, grad_output),
                _scaled(dgt[0], grad_output) if dgt else None,
                None, None, None, None)


def rendering_loss_fused_planes(pred_t: torch.Tensor, gt_t: torch.Tensor,
                                scenes: Scene, want_target_grad: bool = False,
                                row_offset: int = 0,
                                global_height: int = 0) -> torch.Tensor:
    """Rendering loss, the mean over B*S*H*W*3 of |log(r_p + 0.1) -
    log(r_t + 0.1)|, on (B, 12, H, W) f32 or bf16 channel planes (as for
    mixed_loss_fused_planes), for per-item scene sets `scenes` ((B, S, 3)
    fields).

    Without `want_target_grad` the target is data: it is detached, as the
    JAX entry stop-gradients it. With it, the target gets its gradient too.
    `row_offset` and `global_height` are as for mixed_loss_fused_planes.
    """
    if not want_target_grad:
        gt_t = gt_t.detach()
    scenes9 = pack_scenes(scenes)
    args = (pred_t, gt_t, scenes9, int(row_offset), int(global_height))
    if torch.is_grad_enabled() and (pred_t.requires_grad
                                    or gt_t.requires_grad):
        return _FusedRendering.apply(*args, bool(want_target_grad))
    return rendering_loss_fwd(*args)


def rendering_loss_fused(pred: torch.Tensor, target: torch.Tensor,
                         scenes: Scene,
                         want_target_grad: bool = False) -> torch.Tensor:
    """rendering_loss_fused_planes on NHWC (B, H, W, 12) SVBRDFs.

    The JAX entry's `tile_h` / `tile_w` choose its TPU tiles and are not
    taken here: the kernels have no tile that must divide the image, and
    the value is the same for any tiling.
    """
    def planes(x):
        return x.float().permute(0, 3, 1, 2).contiguous()

    return rendering_loss_fused_planes(planes(pred), planes(target), scenes,
                                       want_target_grad)
