"""Plain reference of MaterialGAN's generator and of latent capture.

The generator (StyleGAN2 config-f, Karras et al. 2020; MaterialGAN, Guo
et al. 2020) as functions of a parameter dict, in f32 with TF32 off and
the modulated convolutions written literally: a weight for every sample,
scaled by its style and demodulated, in a grouped convolution (the
up-sampling ones transposed, stride 2, then the [1, 3, 3, 1] FIR by
upfirdn2d: zero insertion, padding, correlation). Its parameter names
are the program's (a state dict loads into models.stylegan2).

Capture: renders of the decoded maps under each material's scenes
against the photos by the log-L1 loss, and plain Adam (b1 0.9, b2 0.999,
eps 1e-8, bias-corrected) on W+ and the noise maps. `capture` reads what
the benchmark compares (`gaps`):
- loss_gap: the largest |program - reference| / |reference| of the
  iterations' losses;
- wplus_grad_gap_median: over the rows of the first gradient of W+ (one
  a material and W+ row), the median of ||program - reference|| over the
  larger of the reference row's norm and the median row's;
- noise_grad_gap_median: the same over the first gradient's noise maps
  (a row: one material's map);
- change_gap_median: the same over the change of W+ and the noise maps
  after the iterations (the rows of both).
The gradients are compared as vectors, not as norms: Adam's first steps
are about lr * sign(g), so a wrong direction shows in the change only
through its signs.

`quant` fake-quantizes the input and the weight of every convolution and
dense layer (the lower-precision control).
"""

from __future__ import annotations

import math
import statistics

import torch
from torch.nn import functional as F

from bench_gpu.reference import maps

SQRT2 = math.sqrt(2.0)
LR_MULTIPLIER = 0.01
RGB_CHANNELS = 9
W_AVG_SAMPLES = 4096
BETAS, EPS = (0.9, 0.999), 1e-8


def _identity(t):
    return t


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


# --- The layer plan -------------------------------------------------------------

def resolutions(cfg: dict) -> list:
    return [2 ** i for i in range(2, int(math.log2(cfg["resolution"])) + 1)]


def channels(cfg: dict, res: int) -> int:
    return min(cfg["max_channels"], cfg["channel_base"] // res)


def convs(cfg: dict) -> list:
    """(cin, cout, up) of the styled 3x3 convs, in order."""
    ch = [channels(cfg, r) for r in resolutions(cfg)]
    out = [(ch[0], ch[0], False)]
    for cin, cout in zip(ch, ch[1:]):
        out += [(cin, cout, True), (cout, cout, False)]
    return out


def param_spec(cfg: dict) -> list:
    """(name, shape, init) of every parameter; init is 'normal' (N(0, 1)),
    'mapping' (N(0, 1) / the lr multiplier), 'small' (N(0, 0.1^2)), 'one'
    or 'zero'."""
    w = cfg["w_dim"]
    spec = []
    for i in range(cfg["mapping_layers"]):
        spec += [(f"mapping.{i}.weight", (w, w), "mapping"),
                 (f"mapping.{i}.bias", (w,), "zero")]
    spec.append(("const", (channels(cfg, 4), 4, 4), "normal"))

    def modulated(prefix, cin, cout, k, init):
        return [(f"{prefix}.conv.affine.weight", (cin, w), "normal"),
                (f"{prefix}.conv.affine.bias", (cin,), "one"),
                (f"{prefix}.conv.weight", (cout, cin, k, k), init)]

    for j, (cin, cout, _) in enumerate(convs(cfg)):
        spec += modulated(f"convs.{j}", cin, cout, 3, "normal")
        spec += [(f"convs.{j}.noise_strength", (), "small"),
                 (f"convs.{j}.bias", (cout,), "zero")]
    for k, res in enumerate(resolutions(cfg)):
        spec += modulated(f"to_rgbs.{k}", channels(cfg, res), RGB_CHANNELS,
                          1, "small")
        spec.append((f"to_rgbs.{k}.bias", (RGB_CHANNELS,), "zero"))
    return spec


def make_weights(cfg: dict, seed: int, device) -> dict:
    """name -> f32 tensor: the program's init distributions (noise
    strengths and toRGB weights N(0, 0.1^2), since the trained weights are
    not in the repository) drawn in one draw from `seed`, and w_avg, the
    mean of 4096 mapped z of the same seed."""
    spec = param_spec(cfg)
    drawn = [s for s in spec if s[2] not in ("one", "zero")]
    sizes = [torch.Size(shape).numel() for _, shape, _ in drawn]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    scale = {"normal": 1.0, "mapping": 1.0 / LR_MULTIPLIER, "small": 0.1}
    out = {}
    for (name, shape, init), part in zip(drawn, flat.split(sizes)):
        out[name] = part.view(shape) * scale[init]
    for name, shape, init in spec:
        if init == "one":
            out[name] = torch.ones(shape, device=device)
        elif init == "zero":
            out[name] = torch.zeros(shape, device=device)
    z = torch.randn(W_AVG_SAMPLES, cfg["w_dim"], generator=gen,
                    device=device)
    with tf32_off(), torch.no_grad():
        out["w_avg"] = mapping(out, z, cfg).mean(0)
    return out


class tf32_off:
    """f32 means f32: TF32 off for convolutions and matrix products."""

    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.saved


# --- The network ------------------------------------------------------------------

def dense(p: dict, prefix: str, x, lr_multiplier=1.0, quant=_identity):
    fan_in = p[f"{prefix}.weight"].shape[1]
    weight = p[f"{prefix}.weight"] * (lr_multiplier / math.sqrt(fan_in))
    return F.linear(quant(x), quant(weight),
                    p[f"{prefix}.bias"] * lr_multiplier)


def lrelu(x):
    return F.leaky_relu(x, 0.2) * SQRT2


def mapping(p: dict, z, cfg: dict, quant=_identity):
    """z (N, w_dim) pixel-normalized, then the dense layers."""
    x = z * torch.rsqrt(torch.mean(z * z, dim=1, keepdim=True) + 1e-8)
    for i in range(cfg["mapping_layers"]):
        x = lrelu(dense(p, f"mapping.{i}", x, LR_MULTIPLIER, quant))
    return x


def fir(device) -> torch.Tensor:
    """[1, 3, 3, 1] outer product over its sum (64), times 4: the 2x
    up-sampling's gain."""
    k = torch.tensor([1.0, 3.0, 3.0, 1.0], device=device)
    return torch.outer(k, k) / 64.0 * 4.0


def upfirdn2d(x, kernel, up: int, pad: tuple):
    """StyleGAN2's upfirdn2d without down-sampling: insert up - 1 zeros
    after every sample on both axes, pad (pad[0], pad[1]) on each, and
    correlate every channel with the flipped kernel."""
    b, c, h, w = x.shape
    if up > 1:
        z = x.new_zeros(b, c, h, up, w, up)
        z[:, :, :, 0, :, 0] = x
        x = z.reshape(b, c, h * up, w * up)
    x = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
    k = torch.flip(kernel, (0, 1))[None, None].expand(c, 1, *kernel.shape)
    return F.conv2d(x, k, groups=c)


def modulated_conv(x, weight, styles, demodulate: bool, up: bool,
                   quant=_identity):
    """x (B, Cin, H, W); weight (Cout, Cin, k, k) unscaled; styles (B,
    Cin). Each sample's weight: weight / sqrt(fan_in) * style, over its
    norm per output channel where `demodulate`; one grouped conv."""
    b, cin, h, w = x.shape
    cout, _, k, _ = weight.shape
    ws = weight[None] / math.sqrt(cin * k * k) * styles[:, None, :, None,
                                                         None]
    if demodulate:
        ws = ws * torch.rsqrt(ws.square().sum((2, 3, 4)) + 1e-8)[
            :, :, None, None, None]
    x = quant(x).reshape(1, b * cin, h, w)
    ws = quant(ws)
    if up:
        wt = ws.transpose(1, 2).reshape(b * cin, cout, k, k)
        y = F.conv_transpose2d(x, wt, stride=2, groups=b)
        y = y.reshape(b, cout, *y.shape[-2:])
        return upfirdn2d(y, fir(x.device), 1, (1, 1))
    y = F.conv2d(x, ws.reshape(b * cout, cin, k, k), padding=k // 2,
                 groups=b)
    return y.reshape(b, cout, h, w)


def synthesis(p: dict, wplus, noises, cfg: dict, quant=_identity):
    """W+ (B, num_ws, w_dim) and the noise maps -> the toRGB sum (B, 9, R,
    R)."""
    def styled(j, x, w, noise, up):
        styles = dense(p, f"convs.{j}.conv.affine", w, quant=quant)
        y = modulated_conv(x, p[f"convs.{j}.conv.weight"], styles, True, up,
                           quant)
        y = y + p[f"convs.{j}.noise_strength"] * noise
        return lrelu(y + p[f"convs.{j}.bias"][None, :, None, None])

    def to_rgb(k, x, w):
        styles = dense(p, f"to_rgbs.{k}.conv.affine", w, quant=quant)
        y = modulated_conv(x, p[f"to_rgbs.{k}.conv.weight"], styles, False,
                           False, quant)
        return y + p[f"to_rgbs.{k}.bias"][None, :, None, None]

    batch = wplus.shape[0]
    x = p["const"][None].expand(batch, -1, -1, -1)
    x = styled(0, x, wplus[:, 0], noises[0], False)
    rgb = to_rgb(0, x, wplus[:, 1])
    for b in range(1, len(resolutions(cfg))):
        i = 2 * b - 1
        x = styled(i, x, wplus[:, i], noises[i], True)
        x = styled(i + 1, x, wplus[:, i + 1], noises[i + 1], False)
        rgb = (upfirdn2d(rgb, fir(x.device), 2, (2, 1))
               + to_rgb(b, x, wplus[:, i + 2]))
    return rgb


def to_svbrdf(rgb):
    """(B, 9, R, R) -> clamp to [-1, 1] -> (B, R, R, 12): normal (3 nx,
    3 ny, 1) normalized, roughness replicated, [-1, 1] -> [0, 1] for the
    others."""
    x = torch.clamp(rgb, -1.0, 1.0).permute(0, 2, 3, 1)
    nxy, diffuse, rough, spec = (x[..., 0:2], x[..., 2:5], x[..., 5:6],
                                 x[..., 6:9])
    n = torch.cat([nxy * 3.0, torch.ones_like(nxy[..., :1])], dim=-1)
    n = n / torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True))
    unit = lambda v: (v + 1.0) / 2.0  # noqa: E731
    return maps.pack(n, unit(diffuse), unit(rough.repeat_interleave(3, -1)),
                     unit(spec))


def generate(p: dict, wplus, noises, cfg: dict, quant=_identity):
    return to_svbrdf(synthesis(p, wplus, noises, cfg, quant))


# --- Capture --------------------------------------------------------------------

def capture_loss(svbrdf, photos, scenes: maps.Scene):
    """svbrdf (B, H, W, 12), photos (B, N, H, W, 3), scenes (B, N, 3):
    L1 of log(render + 0.1) against log(photo + 0.1)."""
    renders = maps.render(scenes, svbrdf[:, None])
    return maps.l1(torch.log(renders + maps.EPSILON_RENDER),
                   torch.log(photos + maps.EPSILON_RENDER))


def adam_step(params, moments, t: int, lr: float) -> None:
    b1, b2 = BETAS
    with torch.no_grad():
        for p, (m, v) in zip(params, moments):
            g = p.grad
            m.mul_(b1).add_((1.0 - b1) * g)
            v.mul_(b2).add_((1.0 - b2) * g * g)
            denom = torch.sqrt(v) / math.sqrt(1.0 - b2 ** t) + EPS
            p.sub_(lr / (1.0 - b1 ** t) * m / denom)


def capture(p: dict, cfg: dict, photos, scenes: maps.Scene, wplus, noises,
            steps: int, quant=_identity) -> dict:
    """`steps` iterations from W+ and the noise maps given; the readings
    `gaps` compares: 'losses', the first 'wplus_grad' and 'noise_grads',
    and the 'wplus_change' and 'noise_changes' after the last."""
    leaves = [t.detach().clone().requires_grad_(True)
              for t in [wplus, *noises]]
    moments = [(torch.zeros_like(t), torch.zeros_like(t)) for t in leaves]
    losses, first = [], None
    with tf32_off():
        for t in range(1, steps + 1):
            for leaf in leaves:
                leaf.grad = None
            loss = capture_loss(generate(p, leaves[0], leaves[1:], cfg,
                                         quant), photos, scenes)
            loss.backward()
            if first is None:
                first = [leaf.grad.detach().clone() for leaf in leaves]
            adam_step(leaves, moments, t, cfg["learning_rate"])
            losses.append(float(loss.detach()))
    changes = [a.detach() - b for a, b in zip(leaves, [wplus, *noises])]
    return {"losses": losses, "wplus_grad": first[0],
            "noise_grads": first[1:], "wplus_change": changes[0],
            "noise_changes": changes[1:]}


def _rows(wplus_like, noise_like) -> list:
    """One vector a material and W+ row (wplus_like (B, num_ws, w_dim),
    or None) and a material and noise map (a list of (B, 1, r, r))."""
    rows = []
    if wplus_like is not None:
        rows += list(wplus_like.double().flatten(0, 1))
    for n in noise_like:
        rows += list(n.double().flatten(1))
    return rows


def _row_gap_median(prog: list, ref: list) -> float:
    norms = [float(r.norm()) for r in ref]
    med = statistics.median(norms)
    return statistics.median(float((p - r).norm()) / max(n, med)
                             for p, r, n in zip(prog, ref, norms))


def gaps(prog: dict, ref: dict) -> dict:
    """The numbers of the module docstring, of `prog`'s readings against
    `ref`'s."""
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(prog["losses"], ref["losses"])),
        "wplus_grad_gap_median": _row_gap_median(
            _rows(prog["wplus_grad"], []), _rows(ref["wplus_grad"], [])),
        "noise_grad_gap_median": _row_gap_median(
            _rows(None, prog["noise_grads"]),
            _rows(None, ref["noise_grads"])),
        "change_gap_median": _row_gap_median(
            _rows(prog["wplus_change"], prog["noise_changes"]),
            _rows(ref["wplus_change"], ref["noise_changes"])),
    }
