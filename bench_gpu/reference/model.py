"""Plain reference of the SVBRDF networks, as functions of a parameter dict.

The single-image network of Deschaintre et al. 2018: a U-Net of `depth`
stride-2 4x4 encoder convs (ngf * min(2^i, 8) features) and `depth`
decoder blocks (skip concat, LeakyReLU 0.2, nearest 2x upsample, pad
(1, 2, 1, 2), 4x4 conv, pad, 4x4 conv), instance norm (eps 1e-5) but in
the first and last encoder and the last decoder block, dropout 0.5 after
the first three decoder blocks, and a global track: a dense + SELU layer per
block over the block's pre-norm channel means and the previous global
vector, added back onto each block's features by a dense merge. Its 9
channels become the maps by tanh, a normal (3 nx, 3 ny, 1) renormalized,
roughness replicated and [-1, 1] -> [0, 1] for the colour maps.

The multi-image network of Deschaintre et al. 2019: the same U-Net with 64
output channels shared over the views, max-pooled over them (maps and
global vectors), then a merge and three 3x3 conv blocks 64 -> 32 -> 9 with
their own global track.

`param_spec` lists every parameter with its shape and its initialization,
in the order the parameters are numbered (an optimizer's leaf order).
Compute is f32 (callers turn TF32 off); `quant` fake-quantizes every conv
and dense input and weight (the lower-precision control); `dropout` gives
the masks: a callable shape -> {0, 2} mask, or None for no dropout.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from bench_gpu.reference.maps import head_to_svbrdf

HEAD_FEATURES = (64, 32, 9)


def encoder_features(ngf: int, depth: int) -> list:
    return [ngf * min(2 ** i, 8) for i in range(depth)]


def _generator_spec(prefix, out_ch, ngf, depth, in_ch=3) -> list:
    d, enc = depth, encoder_features(ngf, depth)
    dec = [out_ch if i == d - 1 else enc[d - 2 - i] for i in range(d)]
    gte_out = [enc[i + 1] for i in range(d - 1)] + [dec[0]]
    gtd_out = dec[1:] + [out_ch]
    spec = []

    def conv(name, cin, cout, k):
        spec.append((f"{prefix}{name}", (cout, cin, k, k), "conv"))

    def norm(name, c):
        spec.extend([(f"{prefix}{name}.weight", (c,), "one"),
                     (f"{prefix}{name}.bias", (c,), "zero")])

    def merge(name, c):
        spec.append((f"{prefix}{name}.fully_connected.weight", (c, c),
                     "merge"))

    def track(name, cin, cout):
        spec.extend([(f"{prefix}{name}.fully_connected.weight", (cout, cin),
                      "track"),
                     (f"{prefix}{name}.fully_connected.bias", (cout,),
                      "zero")])

    for i in range(d):
        conv(f"enc{i + 1}.conv.conv.weight", in_ch if i == 0 else enc[i - 1],
             enc[i], 4)
        if 0 < i < d - 1:
            norm(f"enc{i + 1}.conv.norm", enc[i])
        merge(f"enc{i + 1}.conv.merge", enc[i])
    track("gte1", in_ch, gte_out[0])
    for i in range(1, d):
        track(f"gte{i + 1}", gte_out[i - 1] + enc[i], gte_out[i])
    g_dim = gte_out[-1]
    for i in range(d):
        cin = enc[d - 1] if i == 0 else dec[i - 1] + enc[d - 1 - i]
        conv(f"dec{d - i}.deconv.conv.2.weight", cin, dec[i], 4)
        conv(f"dec{d - i}.deconv.conv.4.weight", dec[i], dec[i], 4)
        if i != d - 1:
            norm(f"dec{d - i}.deconv.norm", dec[i])
        merge(f"dec{d - i}.deconv.merge", dec[i])
        track(f"gtd{d - i}", g_dim + dec[i], gtd_out[i])
        g_dim = gtd_out[i]
    return spec


def param_spec(model: str, ngf: int, depth: int) -> list:
    """[(name, shape, init)] in leaf order; init is 'conv' N(0, 0.02),
    'merge' N(0, 0.01 / sqrt(fan_in)), 'track' N(0, 1 / sqrt(fan_in)),
    'zero' or 'one'."""
    if model == "single":
        return _generator_spec("generator.", 9, ngf, depth)
    if model != "multi":
        raise ValueError(f"unknown model {model!r}")
    spec = _generator_spec("generator.", 64, ngf, depth)
    f1, f2, f3 = HEAD_FEATURES
    spec.append(("merge.fully_connected.weight", (64, 64), "merge"))
    for k, (cin, cout, norm) in enumerate(((64, f1, True), (f1, f2, True),
                                           (f2, f3, False)), start=1):
        spec += [(f"gt{k}.fully_connected.weight", (cout, 2 * cin), "track"),
                 (f"gt{k}.fully_connected.bias", (cout,), "zero"),
                 (f"conv{k}.conv.conv.weight", (cout, cin, 3, 3), "conv")]
        if norm:
            spec += [(f"conv{k}.conv.norm.weight", (cout,), "one"),
                     (f"conv{k}.conv.norm.bias", (cout,), "zero")]
        spec.append((f"conv{k}.conv.merge.fully_connected.weight",
                     (cout, cout), "merge"))
    return spec


def fp8(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled float8 (e4m3) fake quantization, straight-through
    in the backward."""
    scale = 448.0 / torch.clamp(x.detach().abs().amax(), min=1e-12)
    q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - x).detach()


class Net:
    """The forward of `model` over parameters `params` (name -> tensor,
    any float dtype; computed in f32)."""

    def __init__(self, model: str, params: dict, depth: int, quant=None,
                 dropout=None):
        self.model, self.p, self.depth = model, params, depth
        self.q = quant or (lambda x: x)
        self.dropout = dropout

    def _w(self, name):
        return self.q(self.p[name].float())

    def _conv(self, x, name, stride, pad):
        return F.conv2d(self.q(x), self._w(name), stride=stride, padding=pad)

    def _dense(self, x, name, bias=True):
        b = self.p[name + ".bias"].float() if bias else None
        return F.linear(self.q(x), self._w(name + ".weight"), b)

    def _norm(self, x, name):
        if name + ".weight" not in self.p:
            return x
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = x.var(dim=(2, 3), unbiased=False, keepdim=True)
        y = (x - mean) / torch.sqrt(var + 1e-5)
        return (y * self.p[name + ".weight"].float()[:, None, None]
                + self.p[name + ".bias"].float()[:, None, None])

    def _merge(self, x, name, g):
        if g is None:
            return x
        return x + self._dense(g, name + ".fully_connected",
                               bias=False)[:, :, None, None]

    def _track(self, name, mean, g):
        h = mean if g is None else torch.cat([g, mean], dim=-1)
        return F.selu(self._dense(h, name + ".fully_connected"))

    def _block(self, x, name, g, stride, pad, act):
        """Encoder or head block: activation, conv, mean tap, norm, merge."""
        if act:
            x = F.leaky_relu(x, 0.2)
        x = self._conv(x, name + ".conv.conv.weight", stride, pad)
        mean = x.mean(dim=(2, 3))
        x = self._norm(x, name + ".conv.norm")
        return self._merge(x, name + ".conv.merge", g), mean

    def generator(self, x, pre="generator."):
        d = self.depth
        g = self._track(pre + "gte1", x.mean(dim=(2, 3)), None)
        h, _ = self._block(x, pre + "enc1", None, 2, 1, act=False)
        skips = [h]
        for i in range(1, d):
            h, mean = self._block(h, f"{pre}enc{i + 1}", g, 2, 1, act=True)
            skips.append(h)
            g = self._track(f"{pre}gte{i + 1}", mean, g)
        for i in range(d):
            name = f"{pre}dec{d - i}.deconv"
            if i > 0:
                h = torch.cat([h, skips[d - 1 - i]], dim=1)
            h = F.leaky_relu(h, 0.2)
            h = h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            h = self._conv(F.pad(h, (1, 2, 1, 2)), name + ".conv.2.weight",
                           1, 0)
            h = self._conv(F.pad(h, (1, 2, 1, 2)), name + ".conv.4.weight",
                           1, 0)
            mean = h.mean(dim=(2, 3))
            h = self._merge(self._norm(h, name + ".norm"), name + ".merge", g)
            if i < 3 and self.dropout is not None:
                h = h * self.dropout(h.shape)
            g = self._track(f"{pre}gtd{d - i}", mean, g)
        return h, g

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3) or (B, N, H, W, 3) linear -> (B, H, W, 12)."""
        if self.model == "single":
            if images.dim() == 5:
                images = images[:, 0]
            sv9, _ = self.generator(images.float().permute(0, 3, 1, 2))
            return head_to_svbrdf(sv9.permute(0, 2, 3, 1))
        if images.dim() == 4:
            images = images[:, None]
        b, n, h, w, _ = images.shape
        spatial, gvec = self.generator(
            images.float().reshape(b * n, h, w, 3).permute(0, 3, 1, 2))
        spatial = torch.amax(spatial.reshape(b, n, *spatial.shape[1:]), 1)
        g = torch.amax(gvec.reshape(b, n, -1), dim=1)
        x = self._merge(spatial, "merge", g)
        g = self._track("gt1", spatial.mean(dim=(2, 3)), g)
        x, mean = self._block(x, "conv1", g, 1, 1, act=False)
        g = self._track("gt2", mean, g)
        x, mean = self._block(x, "conv2", g, 1, 1, act=True)
        g = self._track("gt3", mean, g)
        x, _ = self._block(x, "conv3", g, 1, 1, act=True)
        return head_to_svbrdf(x.permute(0, 2, 3, 1))
