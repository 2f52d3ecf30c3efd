"""Ho, Jain and Abbeel's DDPM U-Net (arXiv:2006.11239; the release's model
unet2d16b2c112244, github.com/hojonathanho/diffusion), conditioned on a
flash photo, with its noise schedule and a DDIM sampler.

The network predicts the noise eps of x_t = sqrt(abar_t) x0 +
sqrt(1 - abar_t) eps, where x0 is the 9-channel map encoding
(ops/codecs.encode_svbrdf, the inverse of models/single_view.decode_head)
and the photo is concatenated to x_t (image-conditioned diffusion, as in
Saharia et al.'s Palette, arXiv:2111.05826): the input has 12 channels,
NCHW, [x_t | photo mapped to [-1, 1]], and the output 9.

Layer for layer the release's `unet.py`:
  temb = dense1(SiLU(dense0(T_emb(t)))), T_emb the sinusoidal embedding of
    ch channels (timestep_embedding), dense to 4 ch;
  conv_in, 3x3 to ch;
  down: per level of ch_mult, num_res_blocks ResBlocks, each followed by an
    AttnBlock where the level's resolution is in attn_resolutions, then
    (but at the last level) a Downsample: pad (0, 1, 0, 1), stride-2 3x3;
  mid: ResBlock, AttnBlock, ResBlock;
  up: per level from the last, num_res_blocks + 1 ResBlocks on
    concat(h, skip), AttnBlocks as down, then (but at the first level)
    nearest 2x and a 3x3 conv;
  out: GroupNorm, SiLU, 3x3 conv.
  ResBlock(x) = nin(x) + conv2(SiLU(GN(conv1(SiLU(GN(x))) + temb_proj(
    SiLU(temb))))), nin a 1x1 conv where the channel count changes;
  AttnBlock(x) = x + proj_out(attention(q, k, v)), q, k, v 1x1 convs of
    GN(x), one head over the H W positions, softmax(q^T k / sqrt(C)).
GroupNorm: 32 groups, eps 1e-6. Dropout 0 (left out).

Compute dtype: the layers cast their inputs and weights to `dtype` (bf16
on the card by the CLI's default); GroupNorm runs F.group_norm on the
compute dtype, whose CPU and CUDA kernels accumulate the statistics in
f32; the time embedding is computed in f32. Parameters keep their own
dtype (f32, or bf16 masters: parallel/step.master_cast).

Init (Ho et al.): every conv and dense kernel variance-scaled (fan_avg,
uniform) at scale 1, those the release zero-initializes (each ResBlock's
conv2, proj_out, conv_out) at scale 1e-10; zero biases; GroupNorm scale
1, offset 0.

timestep_embedding, group_norm and attention are module-level functions
that the layers look up at each call.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from svbrdf_tpu_torch.device import resolve_device
from svbrdf_tpu_torch.utils import profiling

# Ho et al.'s published widths and diffusion settings.
PUBLISHED = dict(ch=128, ch_mult=(1, 1, 2, 2, 4, 4), num_res_blocks=2,
                 attn_resolutions=(16,), resolution=256, groups=32, eps=1e-6)
TIMESTEPS, BETA_START, BETA_END = 1000, 1e-4, 0.02
CLIP_NORM, EMA_DECAY, SAMPLE_STEPS = 1.0, 0.9999, 50
IN_CHANNELS, OUT_CHANNELS = 12, 9
ZERO_INIT_SCALE = 1e-10


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """(B,) timesteps -> (B, dim) f32: concat(sin, cos) of t * exp(-ln(1e4)
    i / (dim / 2 - 1)), i < dim / 2."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                   device=t.device)
                      * (-math.log(10000.0) / (half - 1)))
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=1)


def group_norm(x, groups: int, weight, bias, eps: float) -> torch.Tensor:
    """GroupNorm in x's dtype (its statistics accumulated in f32)."""
    return F.group_norm(x, groups, weight.to(x.dtype), bias.to(x.dtype), eps)


def attention(q, k, v) -> torch.Tensor:
    """One head over the positions: (B, L, C) each -> softmax(q k^T /
    sqrt(C)) v."""
    return F.scaled_dot_product_attention(q[:, None], k[:, None],
                                          v[:, None])[:, 0]


class Conv(nn.Conv2d):
    """nn.Conv2d that casts its input, weight and bias to `compute_dtype`."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0, *,
                 compute_dtype=torch.float32, init_scale=1.0):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding)
        self.compute_dtype = compute_dtype
        self.init_scale = init_scale

    def forward(self, x):
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt))


class Dense(nn.Linear):
    """nn.Linear that casts its input, weight and bias to `compute_dtype`."""

    def __init__(self, cin, cout, *, compute_dtype=torch.float32,
                 init_scale=1.0):
        super().__init__(cin, cout)
        self.compute_dtype = compute_dtype
        self.init_scale = init_scale

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class GroupNorm(nn.Module):
    def __init__(self, channels: int, groups: int, eps: float):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return group_norm(x, self.groups, self.weight, self.bias, self.eps)


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, temb_ch: int, groups: int,
                 eps: float, dtype):
        super().__init__()
        self.norm1 = GroupNorm(cin, groups, eps)
        self.conv1 = Conv(cin, cout, 3, padding=1, compute_dtype=dtype)
        self.temb_proj = Dense(temb_ch, cout, compute_dtype=dtype)
        self.norm2 = GroupNorm(cout, groups, eps)
        self.conv2 = Conv(cout, cout, 3, padding=1, compute_dtype=dtype,
                          init_scale=ZERO_INIT_SCALE)
        self.nin_shortcut = (Conv(cin, cout, 1, compute_dtype=dtype)
                             if cin != cout else None)

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.temb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    def __init__(self, channels: int, groups: int, eps: float, dtype):
        super().__init__()
        self.norm = GroupNorm(channels, groups, eps)
        self.q = Conv(channels, channels, 1, compute_dtype=dtype)
        self.k = Conv(channels, channels, 1, compute_dtype=dtype)
        self.v = Conv(channels, channels, 1, compute_dtype=dtype)
        self.proj_out = Conv(channels, channels, 1, compute_dtype=dtype,
                             init_scale=ZERO_INIT_SCALE)

    def forward(self, x):
        b, c, hgt, wid = x.shape
        h = self.norm(x)
        rows = lambda y: y.flatten(2).transpose(1, 2)  # noqa: E731
        out = attention(rows(self.q(h)), rows(self.k(h)), rows(self.v(h)))
        out = out.transpose(1, 2).reshape(b, c, hgt, wid)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    def __init__(self, channels: int, dtype):
        super().__init__()
        self.conv = Conv(channels, channels, 3, stride=2, compute_dtype=dtype)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, channels: int, dtype):
        super().__init__()
        self.conv = Conv(channels, channels, 3, padding=1, compute_dtype=dtype)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Level(nn.Module):
    """One resolution of the down or up path: its ResBlocks, AttnBlocks
    and resampling conv."""

    def __init__(self, blocks, attns, resample):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        self.attn = nn.ModuleList(attns)
        if resample is not None:
            setattr(self, "downsample" if isinstance(resample, Downsample)
                    else "upsample", resample)


def variance_scaling_(weight: torch.Tensor, scale: float,
                      generator: torch.Generator) -> None:
    """Ho et al.'s default_init: uniform with variance scale / fan_avg."""
    cout, cin = weight.shape[:2]
    field = weight[0, 0].numel()
    fan_avg = 0.5 * (cin + cout) * field
    limit = math.sqrt(3.0 * scale / fan_avg)
    with torch.no_grad():
        weight.uniform_(-limit, limit, generator=generator)


class DDPMUNet(nn.Module):
    """(x (B, 12, H, W): [x_t | photo], t (B,) int) -> eps (B, 9, H, W) in
    the compute dtype. `sizes` (ch, ch_mult, num_res_blocks,
    attn_resolutions, resolution, groups, eps) default to Ho et al.'s
    published ones; the parameters are made on `device` from `seed`."""

    def __init__(self, *, device="cuda", seed: int = 0, dtype=torch.float32,
                 **sizes):
        super().__init__()
        unknown = set(sizes) - set(PUBLISHED)
        if unknown:
            raise TypeError(f"unexpected sizes {sorted(unknown)}")
        s = {**PUBLISHED, **sizes}
        s["ch_mult"] = tuple(s["ch_mult"])
        s["attn_resolutions"] = tuple(s["attn_resolutions"])
        self.sizes = s
        self.compute_dtype = dtype
        dev = resolve_device(device)
        ch, mult, nrb = s["ch"], s["ch_mult"], s["num_res_blocks"]
        groups, eps = s["groups"], s["eps"]
        temb_ch = 4 * ch
        with dev:
            self.temb = nn.Module()
            self.temb.dense0 = Dense(ch, temb_ch, compute_dtype=dtype)
            self.temb.dense1 = Dense(temb_ch, temb_ch, compute_dtype=dtype)
            self.conv_in = Conv(IN_CHANNELS, ch, 3, padding=1,
                                compute_dtype=dtype)
            res, block_in = s["resolution"], ch
            skips, self.down = [ch], nn.ModuleList()
            for i, m in enumerate(mult):
                blocks, attns = [], []
                for _ in range(nrb):
                    blocks.append(ResBlock(block_in, ch * m, temb_ch, groups,
                                           eps, dtype))
                    block_in = ch * m
                    if res in s["attn_resolutions"]:
                        attns.append(AttnBlock(block_in, groups, eps, dtype))
                    skips.append(block_in)
                down = None
                if i != len(mult) - 1:
                    down = Downsample(block_in, dtype)
                    skips.append(block_in)
                    res //= 2
                self.down.append(_Level(blocks, attns, down))
            self.mid = nn.Module()
            self.mid.block_1 = ResBlock(block_in, block_in, temb_ch, groups,
                                        eps, dtype)
            self.mid.attn_1 = AttnBlock(block_in, groups, eps, dtype)
            self.mid.block_2 = ResBlock(block_in, block_in, temb_ch, groups,
                                        eps, dtype)
            up = []
            for i, m in reversed(list(enumerate(mult))):
                blocks, attns = [], []
                for _ in range(nrb + 1):
                    blocks.append(ResBlock(block_in + skips.pop(), ch * m,
                                           temb_ch, groups, eps, dtype))
                    block_in = ch * m
                    if res in s["attn_resolutions"]:
                        attns.append(AttnBlock(block_in, groups, eps, dtype))
                upsample = None
                if i != 0:
                    upsample = Upsample(block_in, dtype)
                    res *= 2
                up.insert(0, _Level(blocks, attns, upsample))
            self.up = nn.ModuleList(up)
            self.norm_out = GroupNorm(block_in, groups, eps)
            self.conv_out = Conv(block_in, OUT_CHANNELS, 3, padding=1,
                                 compute_dtype=dtype,
                                 init_scale=ZERO_INIT_SCALE)
        if dev.type == "meta":
            return
        gen = torch.Generator(device=dev).manual_seed(seed)
        for module in self.modules():
            if isinstance(module, (Conv, Dense)):
                variance_scaling_(module.weight, module.init_scale, gen)
                with torch.no_grad():
                    module.bias.zero_()

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        ch = self.sizes["ch"]
        temb = self.temb.dense1(F.silu(self.temb.dense0(
            timestep_embedding(t, ch))))
        hs = [self.conv_in(x)]
        for level in self.down:
            for j, block in enumerate(level.block):
                h = block(hs[-1], temb)
                if len(level.attn):
                    h = level.attn[j](h)
                hs.append(h)
            if hasattr(level, "downsample"):
                hs.append(level.downsample(hs[-1]))
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(hs[-1], temb)),
                             temb)
        for level in reversed(self.up):
            for j, block in enumerate(level.block):
                h = block(torch.cat([h, hs.pop()], dim=1), temb)
                if len(level.attn):
                    h = level.attn[j](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))


# --- The noise schedule, the conditioning, DDIM ------------------------------

def alphas_cumprod() -> torch.Tensor:
    """abar_t, t < T, of the linear beta schedule, in float64."""
    betas = np.linspace(BETA_START, BETA_END, TIMESTEPS, dtype=np.float64)
    return torch.from_numpy(np.cumprod(1.0 - betas))


def condition(photos: torch.Tensor) -> torch.Tensor:
    """Photos (B, [N,] H, W, 3), linear RGB in [0, 1] -> the conditioning
    channels (B, 3, H, W) in [-1, 1], of the first view."""
    if photos.dim() == 5:
        photos = photos[:, 0]
    return (photos.permute(0, 3, 1, 2) * 2.0 - 1.0).float()


def ddim_sample(model, photos: torch.Tensor, abar: torch.Tensor, steps: int,
                generator: torch.Generator) -> torch.Tensor:
    """Deterministic DDIM (Song et al., arXiv:2010.02502, eta 0) over
    `steps` evenly spaced timesteps 0, T / steps, ... of the float64
    schedule `abar`: x_T ~ N(0, I) from `generator`; each step's x0 =
    (x_t - sqrt(1 - abar_t) eps) / sqrt(abar_t) and x_prev = sqrt(abar_prev)
    x0 + sqrt(1 - abar_prev) eps, abar_prev 1 after the last. Returns the
    last x0 (B, 9, H, W), f32. Each step is a host span diffusion.sample."""
    cond = condition(photos)
    b, _, h, w = cond.shape
    x = torch.randn((b, OUT_CHANNELS, h, w), generator=generator,
                    device=cond.device)
    seq = list(range(0, len(abar), len(abar) // steps))
    dt = getattr(model, "compute_dtype", torch.float32)
    for i in reversed(range(len(seq))):
        with profiling.span("diffusion.sample"):
            a_t = float(abar[seq[i]])
            a_prev = float(abar[seq[i - 1]]) if i > 0 else 1.0
            t = torch.full((b,), seq[i], dtype=torch.int64,
                           device=cond.device)
            eps = model(torch.cat([x, cond], dim=1).to(dt), t).float()
            x0 = (x - math.sqrt(1.0 - a_t) * eps) / math.sqrt(a_t)
            x = math.sqrt(a_prev) * x0 + math.sqrt(1.0 - a_prev) * eps
    return x
