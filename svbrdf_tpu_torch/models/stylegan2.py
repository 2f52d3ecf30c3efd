"""MaterialGAN's SVBRDF generator: a StyleGAN2 generator (config-f) whose
nine output channels are the four maps.

Guo et al., "MaterialGAN: Reflectance Capture using a Generative SVBRDF
Model" (ACM TOG 39(6), 2020), on Karras et al., "Analyzing and Improving
the Image Quality of StyleGAN" (CVPR 2020). NCHW inside.

- Mapping: z pixel-normalized, then `mapping_layers` equalized-lr dense
  layers w_dim -> w_dim with a learning-rate multiplier of 0.01 and leaky
  ReLU 0.2 times sqrt 2; `w_avg` is the mean w, the capture's start.
- Synthesis at 4^2 ... resolution^2: a learned constant 4x4 input; one 3x3
  modulated conv at 4^2; at each higher resolution an up-sampling
  modulated conv (a transposed 3x3 conv of stride 2, then the [1, 3, 3, 1]
  FIR blur) and a second 3x3 one. Each conv takes a style from its own
  row of W+ by an affine layer (bias 1), demodulates, adds its noise map
  times a learned strength, its bias, and leaky ReLU 0.2 times sqrt 2.
  A 1x1 toRGB conv (no demodulation) at every resolution gives 9
  channels; the lower resolutions' sums are FIR up-sampled and added.
- W+ rows: 2 log2(resolution) - 2; row 0 styles the 4^2 conv, row 1 its
  toRGB; the block at 2^(b+2) takes rows 2b - 1, 2b and 2b + 1 for its
  two convs and its toRGB. Noise maps: one at 4^2, two at every higher
  resolution.
- Output: the toRGB sum clamped to [-1, 1] and decoded 9 -> 12 as the
  single-view network's head (single_view.decode_head): normal xy,
  diffuse, roughness, specular (the channel order is assumed).

Modulation is computed in its shared-weight form: the input scaled by
the style, one cuDNN convolution with the layer's weight for the whole
batch, the output scaled by the demodulation. The literal form (a
per-sample weight, a grouped convolution) is the same arithmetic; the
benchmark's reference computes it so. In this form the gradient of W+
needs no weight gradient of a convolution.

Channels at resolution r: min(max_channels, channel_base // r): config-f
(channel_base 32768, max 512) has 512 up to 64^2, 256 at 128^2, 128 at
256^2.

Init (init_params): the published one, dense and conv weights N(0, 1)
(equalized learning rate scales them when used; the mapping's are
N(0, 1) / 0.01), the affine biases 1, other biases 0, the constant
N(0, 1); with two departures, since the trained weights are not in the
repository: noise strengths N(0, 0.1^2), not 0 (at 0 the capture's noise
maps get no gradient), and toRGB weights N(0, 0.1^2), not N(0, 1) (unit
ones saturate the clamp of the summed output). w_avg is the mean of 4096
mapped z.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from svbrdf_tpu_torch.device import resolve_device
from svbrdf_tpu_torch.models.single_view import decode_head

SQRT2 = math.sqrt(2.0)
LR_MULTIPLIER = 0.01
RGB_CHANNELS = 9
W_AVG_SAMPLES = 4096
_STRENGTH_STD = 0.1
_TO_RGB_STD = 0.1


def fir_kernel(device=None) -> torch.Tensor:
    """The 4x4 FIR of [1, 3, 3, 1] (outer product), summing to 4: the gain
    of a 2x up-sampling."""
    k = torch.tensor([1.0, 3.0, 3.0, 1.0], device=device)
    return torch.outer(k, k) / 16.0


def _depthwise(kernel: torch.Tensor, channels: int) -> torch.Tensor:
    return kernel[None, None].expand(channels, 1, *kernel.shape)


def blur(x: torch.Tensor, fir: torch.Tensor) -> torch.Tensor:
    """The FIR after a transposed conv of stride 2: (2H + 1)^2 -> (2H)^2,
    padded by 1 (upfirdn2d with pad (1, 1))."""
    c = x.shape[1]
    return F.conv2d(x, _depthwise(fir, c), padding=1, groups=c)


def upsample(x: torch.Tensor, fir: torch.Tensor) -> torch.Tensor:
    """2x FIR up-sampling of the toRGB skips (upfirdn2d with up 2, pad
    (2, 1)): zero insertion then the FIR is a transposed depthwise conv of
    stride 2 with padding 1 (the kernel is symmetric)."""
    c = x.shape[1]
    return F.conv_transpose2d(x, _depthwise(fir, c), stride=2, padding=1,
                              groups=c)


def demodulation(weight: torch.Tensor, styles: torch.Tensor) -> torch.Tensor:
    """(B, Cout) 1 / ||weight * style|| of each output channel: weight
    (Cout, Cin, k, k), styles (B, Cin)."""
    return torch.rsqrt(styles.square() @ weight.square().sum((2, 3)).t()
                       + 1e-8)


class Dense(nn.Module):
    """Equalized-lr dense layer: the weight N(0, 1) / lr_multiplier used
    as weight * lr_multiplier / sqrt(fan_in), the bias as bias *
    lr_multiplier; a `gain` scales the output (one addmm)."""

    def __init__(self, fan_in: int, fan_out: int, bias_init: float = 0.0,
                 lr_multiplier: float = 1.0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(fan_out, fan_in))
        self.bias = nn.Parameter(torch.empty(fan_out))
        self.bias_init, self.lr_multiplier = bias_init, lr_multiplier
        self.scale = lr_multiplier / math.sqrt(fan_in)

    def forward(self, x, gain: float = 1.0):
        return torch.addmm(self.bias, x, self.weight.t(),
                           beta=self.lr_multiplier * gain,
                           alpha=self.scale * gain)


class ModulatedConv(nn.Module):
    """A k x k conv modulated by a style that `affine` takes from w, plain
    (padding k // 2) or up-sampling (transposed, stride 2, then the FIR).

    The weight's equalized-lr scale 1 / sqrt(fan_in) is applied to the
    style, so a call scales the input once and convolves with the weight
    as stored. It returns the convolution and, where it demodulates, the
    demodulation (B, Cout) for the caller to apply (StyledConv fuses it
    with its bias); the FIR is per channel, so it may come first."""

    def __init__(self, cin: int, cout: int, kernel: int, w_dim: int,
                 demodulate: bool = True, up: bool = False):
        super().__init__()
        self.affine = Dense(w_dim, cin, bias_init=1.0)
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.scale = 1.0 / math.sqrt(cin * kernel * kernel)
        self.demodulate, self.up = demodulate, up
        if up:
            self.register_buffer("fir", fir_kernel(), persistent=False)

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> tuple:
        styles = self.affine(w, gain=self.scale)
        x = x * styles[:, :, None, None]
        if self.up:
            y = blur(F.conv_transpose2d(x, self.weight.transpose(0, 1),
                                        stride=2), self.fir)
        else:
            y = F.conv2d(x, self.weight, padding=self.weight.shape[-1] // 2)
        if not self.demodulate:
            return y, None
        return y, demodulation(self.weight, styles)


class StyledConv(nn.Module):
    """ModulatedConv demodulated, + strength * noise, + bias, leaky ReLU
    0.2 times sqrt 2."""

    def __init__(self, cin: int, cout: int, w_dim: int, up: bool = False):
        super().__init__()
        self.conv = ModulatedConv(cin, cout, 3, w_dim, up=up)
        self.noise_strength = nn.Parameter(torch.empty(()))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x, w, noise):
        y, d = self.conv(x, w)
        y = torch.addcmul(self.bias[:, None, None], y, d[:, :, None, None])
        y = torch.addcmul(y, noise, self.noise_strength)
        return F.leaky_relu(y, 0.2) * SQRT2


class ToRGB(nn.Module):
    def __init__(self, cin: int, w_dim: int):
        super().__init__()
        self.conv = ModulatedConv(cin, RGB_CHANNELS, 1, w_dim,
                                  demodulate=False)
        self.bias = nn.Parameter(torch.empty(RGB_CHANNELS))

    def forward(self, x, w):
        return self.conv(x, w)[0] + self.bias[:, None, None]


def channels(resolution: int, max_channels: int = 512,
             channel_base: int = 32768) -> int:
    return min(max_channels, channel_base // resolution)


class StyleGAN2Generator(nn.Module):
    """(W+ (B, num_ws, w_dim), noise maps) -> SVBRDF (B, R, R, 12).

    The parameters are made on `device` ("cuda" unless the caller asks for
    the CPU) and drawn from a generator seeded with `seed`; w_avg is
    computed from them."""

    def __init__(self, resolution: int = 256, w_dim: int = 512,
                 mapping_layers: int = 8, max_channels: int = 512,
                 channel_base: int = 32768, *, device="cuda",
                 seed: int = 0):
        super().__init__()
        log2 = int(math.log2(resolution))
        if resolution < 4 or 2 ** log2 != resolution:
            raise ValueError(f"resolution {resolution} is not a power of "
                             "two >= 4")
        dev = resolve_device(device)
        self.w_dim = w_dim
        self.num_ws = 2 * log2 - 2
        res = [2 ** i for i in range(2, log2 + 1)]
        ch = [channels(r, max_channels, channel_base) for r in res]
        with dev:
            self.mapping = nn.ModuleList(
                Dense(w_dim, w_dim, lr_multiplier=LR_MULTIPLIER)
                for _ in range(mapping_layers))
            self.const = nn.Parameter(torch.empty(ch[0], 4, 4))
            convs = [StyledConv(ch[0], ch[0], w_dim)]
            for cin, cout in zip(ch, ch[1:]):
                convs += [StyledConv(cin, cout, w_dim, up=True),
                          StyledConv(cout, cout, w_dim)]
            self.convs = nn.ModuleList(convs)
            self.to_rgbs = nn.ModuleList(ToRGB(c, w_dim) for c in ch)
            self.register_buffer("w_avg", torch.zeros(w_dim))
            self.register_buffer("fir", fir_kernel(), persistent=False)
        self.noise_sizes = [4] + [r for r in res[1:] for _ in range(2)]
        gen = torch.Generator(device=dev).manual_seed(seed)
        init_params(self, gen)
        with torch.no_grad():
            self.w_avg.copy_(self.map(torch.randn(
                W_AVG_SAMPLES, w_dim, generator=gen, device=dev)).mean(0))

    def map(self, z: torch.Tensor) -> torch.Tensor:
        """z (N, w_dim) -> w (N, w_dim)."""
        x = z * torch.rsqrt(z.square().mean(1, keepdim=True) + 1e-8)
        for layer in self.mapping:
            x = F.leaky_relu(layer(x), 0.2) * SQRT2
        return x

    def make_noises(self, batch: int, generator: torch.Generator) -> list:
        """Standard normal noise maps, (batch, 1, r, r) each, in order."""
        dev = self.w_avg.device
        return [torch.randn(batch, 1, r, r, generator=generator, device=dev)
                for r in self.noise_sizes]

    def synthesis(self, wplus: torch.Tensor, noises) -> torch.Tensor:
        """W+ (B, num_ws, w_dim) and the noise maps -> the toRGB sum (B, 9,
        R, R), unclamped."""
        x = self.const.expand(wplus.shape[0], *self.const.shape)
        x = self.convs[0](x, wplus[:, 0], noises[0])
        rgb = self.to_rgbs[0](x, wplus[:, 1])
        for b in range(1, len(self.to_rgbs)):
            i = 2 * b - 1
            x = self.convs[i](x, wplus[:, i], noises[i])
            x = self.convs[i + 1](x, wplus[:, i + 1], noises[i + 1])
            rgb = upsample(rgb, self.fir) + self.to_rgbs[b](x,
                                                            wplus[:, i + 2])
        return rgb

    def forward(self, wplus: torch.Tensor, noises) -> torch.Tensor:
        rgb = self.synthesis(wplus, noises)
        return decode_head(torch.clamp(rgb, -1.0, 1.0).permute(0, 2, 3, 1))


@torch.no_grad()
def init_params(model: StyleGAN2Generator, gen: torch.Generator) -> None:
    """The init of the module docstring, drawn in module order."""
    for module in model.modules():
        if isinstance(module, Dense):
            module.weight.normal_(generator=gen).div_(module.lr_multiplier)
            module.bias.fill_(module.bias_init)
        elif isinstance(module, ModulatedConv):
            module.weight.normal_(generator=gen)
        elif isinstance(module, StyledConv):
            module.noise_strength.normal_(generator=gen).mul_(
                _STRENGTH_STD)
            module.bias.zero_()
        elif isinstance(module, ToRGB):
            module.bias.zero_()
    for to_rgb in model.to_rgbs:
        to_rgb.conv.weight.mul_(_TO_RGB_STD)
    model.const.normal_(generator=gen)
