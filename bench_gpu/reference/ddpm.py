"""Plain reference of the DDPM U-Net cell: Ho et al.'s U-Net
(arXiv:2006.11239; the release's `unet.py`), its eps-MSE train step with
the global-norm clip, Adam and the EMA, DDIM, and the seeded weights.

The network as a function of a parameter dict (the program's state dict
names, so the weights load into models.ddpm_unet), in f32 with TF32 off:
GroupNorm by F.group_norm, attention written out (softmax(q^T k /
sqrt(C)) over the positions, one head), the time embedding, the
down-sampling pad and the up-sampling copy as the release writes them.
The input is [x_t | photo * 2 - 1] (12 channels, NCHW), the output the
predicted noise (9 channels).

A train step (train_steps): the batch as the data path's reference
prepares it (maps.prepare), the maps' 9-channel encoding (`encode`, the
single-view head's inverse), t ~ U{0..T-1} and then eps ~ N(0, I) of the
whole batch from the step's generator after preparation's draws,
x_t = sqrt(abar_t) x0 + sqrt(1 - abar_t) eps (abar in float64, cast
once), the loss mean((eps_hat - eps)^2), the gradients clipped to a
global norm of 1 (coefficient min(1, 1 / (norm + 1e-6))), Adam as
reference.adam (bf16-SR masters where the configuration trains them) and
an f32 EMA, ema <- ema + (1 - decay) (p - ema). `quant` fake-quantizes
every conv and dense layer's input and weight and the predicted noise
(the lower-precision control).

The weights (make_weights): Ho et al.'s initialization, every conv and
dense kernel uniform with variance 1 / fan_avg, zero biases, GroupNorm
scale 1 and offset 0, except that the kernels the release initializes at
scale 1e-10 (each ResBlock's conv2, proj_out, conv_out) are drawn at
scale 1 like their neighbours, so that the first gradient reaches every
leaf. One uniform draw on the device from the seed.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch
from torch.nn import functional as F

from bench_gpu import corpus, weights
from bench_gpu.reference import maps
from bench_gpu.reference.adam import Adam, stream_seed
from bench_gpu.reference.check import (WEIGHTS_WORD, _rows, cotangent_norms,
                                       gaps, tf32_off)

IN_CHANNELS, OUT_CHANNELS = 12, 9


def _identity(t):
    return t


# --- The layer plan and the weights ------------------------------------------

def param_spec(cfg: dict) -> list:
    """[(name, shape, kind)] of the network at cfg's widths, in the
    program's order of its leaves (each level's blocks, then its attention
    blocks, then its resampling conv; the up path's levels from the
    first), kind 'kernel' (a conv's or dense layer's), 'zero' (a bias, a
    norm's offset) or 'one' (a norm's scale)."""
    ch, mult = cfg["ch"], list(cfg["ch_mult"])
    nrb, attn = cfg["num_res_blocks"], set(cfg["attn_resolutions"])
    temb = 4 * ch

    def conv(name, cin, cout, k):
        return [(f"{name}.weight", (cout, cin, k, k), "kernel"),
                (f"{name}.bias", (cout,), "zero")]

    def dense(name, cin, cout):
        return [(f"{name}.weight", (cout, cin), "kernel"),
                (f"{name}.bias", (cout,), "zero")]

    def norm(name, c):
        return [(f"{name}.weight", (c,), "one"),
                (f"{name}.bias", (c,), "zero")]

    def res_block(name, cin, cout):
        return (norm(f"{name}.norm1", cin)
                + conv(f"{name}.conv1", cin, cout, 3)
                + dense(f"{name}.temb_proj", temb, cout)
                + norm(f"{name}.norm2", cout)
                + conv(f"{name}.conv2", cout, cout, 3)
                + (conv(f"{name}.nin_shortcut", cin, cout, 1)
                   if cin != cout else []))

    def attn_block(name, c):
        return norm(f"{name}.norm", c) + [
            leaf for part in ("q", "k", "v", "proj_out")
            for leaf in conv(f"{name}.{part}", c, c, 1)]

    def level(path, i, blocks, attns, resample):
        return ([leaf for j, (cin, cout) in enumerate(blocks)
                 for leaf in res_block(f"{path}.{i}.block.{j}", cin, cout)]
                + [leaf for j, c in enumerate(attns)
                   for leaf in attn_block(f"{path}.{i}.attn.{j}", c)]
                + (conv(f"{path}.{i}.{resample}.conv", blocks[-1][1],
                        blocks[-1][1], 3) if resample else []))

    spec = (dense("temb.dense0", ch, temb) + dense("temb.dense1", temb, temb)
            + conv("conv_in", IN_CHANNELS, ch, 3))
    res, block_in, skips = cfg["resolution"], ch, [ch]
    for i, m in enumerate(mult):
        blocks, attns = [], []
        for _ in range(nrb):
            blocks.append((block_in, ch * m))
            block_in = ch * m
            if res in attn:
                attns.append(block_in)
            skips.append(block_in)
        last = i == len(mult) - 1
        if not last:
            skips.append(block_in)
            res //= 2
        spec += level("down", i, blocks, attns, None if last else "downsample")
    spec += (res_block("mid.block_1", block_in, block_in)
             + attn_block("mid.attn_1", block_in)
             + res_block("mid.block_2", block_in, block_in))
    up = {}
    for i in reversed(range(len(mult))):
        blocks, attns = [], []
        for _ in range(nrb + 1):
            blocks.append((block_in + skips.pop(), ch * mult[i]))
            block_in = ch * mult[i]
            if res in attn:
                attns.append(block_in)
        up[i] = level("up", i, blocks, attns, "upsample" if i else None)
        if i != 0:
            res *= 2
    spec += [leaf for i in range(len(mult)) for leaf in up[i]]
    return (spec + norm("norm_out", block_in)
            + conv("conv_out", block_in, OUT_CHANNELS, 3))


def make_weights(cfg: dict, seed: int, device) -> dict:
    """name -> f32 tensor on `device` (module docstring)."""
    spec = param_spec(cfg)
    drawn = [(name, shape) for name, shape, kind in spec if kind == "kernel"]
    sizes = [math.prod(shape) for _, shape in drawn]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape), part in zip(drawn, flat.split(sizes)):
        field = math.prod(shape[2:])
        fan_avg = 0.5 * (shape[0] + shape[1]) * field
        limit = math.sqrt(3.0 / fan_avg)
        out[name] = part.view(shape).mul(2.0 * limit).sub_(limit)
    for name, shape, kind in spec:
        if kind == "one":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zero":
            out[name] = torch.zeros(shape, device=device)
    return {name: out[name] for name, _, _ in spec}


# --- The network -------------------------------------------------------------

def time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    scale = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                   device=t.device) * -scale)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=1)


def unet(p: dict, x: torch.Tensor, t: torch.Tensor, cfg: dict,
         quant=_identity) -> torch.Tensor:
    """eps_hat (B, 9, H, W) of x (B, 12, H, W) at timesteps t (B,)."""
    w = lambda name: p[name].float()  # noqa: E731

    def conv(name, h, stride=1):
        kernel = w(f"{name}.weight")
        pad = kernel.shape[-1] // 2 if stride == 1 else 0
        return F.conv2d(quant(h), quant(kernel), w(f"{name}.bias"),
                        stride=stride, padding=pad)

    def dense(name, h):
        return F.linear(quant(h), quant(w(f"{name}.weight")),
                        w(f"{name}.bias"))

    def norm(name, h):
        return F.group_norm(h, cfg["groups"], w(f"{name}.weight"),
                            w(f"{name}.bias"), cfg["eps"])

    def res_block(name, h, temb):
        out = conv(f"{name}.conv1", F.silu(norm(f"{name}.norm1", h)))
        out = out + dense(f"{name}.temb_proj", F.silu(temb))[:, :, None, None]
        out = conv(f"{name}.conv2", F.silu(norm(f"{name}.norm2", out)))
        if f"{name}.nin_shortcut.weight" in p:
            h = conv(f"{name}.nin_shortcut", h)
        return h + out

    def attn_block(name, h):
        b, c, hgt, wid = h.shape
        n = norm(f"{name}.norm", h)
        q, k, v = (conv(f"{name}.{s}", n).reshape(b, c, hgt * wid)
                   for s in ("q", "k", "v"))
        weights_ = torch.einsum("bci,bcj->bij", q, k) * (c ** -0.5)
        weights_ = torch.softmax(weights_, dim=2)
        out = torch.einsum("bij,bcj->bci", weights_, v)
        return h + conv(f"{name}.proj_out", out.reshape(b, c, hgt, wid))

    mult, nrb = list(cfg["ch_mult"]), cfg["num_res_blocks"]
    attn = set(cfg["attn_resolutions"])
    temb = dense("temb.dense1", F.silu(dense(
        "temb.dense0", time_embedding(t, cfg["ch"]))))
    hs = [conv("conv_in", x)]
    for i in range(len(mult)):
        for j in range(nrb):
            h = res_block(f"down.{i}.block.{j}", hs[-1], temb)
            if h.shape[-1] in attn:
                h = attn_block(f"down.{i}.attn.{j}", h)
            hs.append(h)
        if i != len(mult) - 1:
            hs.append(conv(f"down.{i}.downsample.conv",
                           F.pad(hs[-1], (0, 1, 0, 1)), stride=2))
    h = res_block("mid.block_1", hs[-1], temb)
    h = attn_block("mid.attn_1", h)
    h = res_block("mid.block_2", h, temb)
    for i in reversed(range(len(mult))):
        for j in range(nrb + 1):
            h = res_block(f"up.{i}.block.{j}",
                          torch.cat([h, hs.pop()], dim=1), temb)
            if h.shape[-1] in attn:
                h = attn_block(f"up.{i}.attn.{j}", h)
        if i != 0:
            h = conv(f"up.{i}.upsample.conv",
                     h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3))
    return conv("conv_out", F.silu(norm("norm_out", h)))


# --- Diffusion ---------------------------------------------------------------

def abar(cfg: dict) -> torch.Tensor:
    """The linear beta schedule's cumulative products, float64."""
    betas = np.linspace(cfg["beta_start"], cfg["beta_end"], cfg["timesteps"],
                        dtype=np.float64)
    return torch.from_numpy(np.cumprod(1.0 - betas))


def encode(svbrdf: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 12) maps -> (B, 9, H, W) in [-1, 1]: normal x, y over
    3 z, diffuse, roughness (the channels' mean), specular, each colour
    map 2 v - 1."""
    n, d, r, s = maps.unpack(svbrdf.float())
    nxy = n[..., :2] / torch.clamp(3.0 * n[..., 2:3], min=1e-3)
    x = torch.cat([nxy, 2.0 * d - 1.0, 2.0 * r.mean(-1, keepdim=True) - 1.0,
                   2.0 * s - 1.0], dim=-1)
    return torch.clamp(x, -1.0, 1.0).permute(0, 3, 1, 2)


def conditioning(photos: torch.Tensor) -> torch.Tensor:
    """(B, N, H, W, 3) linear photos -> the first view, NCHW, 2 v - 1."""
    return photos[:, 0].permute(0, 3, 1, 2).float() * 2.0 - 1.0


def ddim(p: dict, photos: torch.Tensor, cfg: dict, steps: int,
         x_t: torch.Tensor) -> torch.Tensor:
    """Deterministic DDIM (eta 0) from x_T = `x_t` over the timesteps 0,
    T / steps, ...: the last x0 (B, 9, H, W)."""
    a = abar(cfg)
    seq = list(range(0, cfg["timesteps"], cfg["timesteps"] // steps))
    cond = conditioning(photos)
    x = x_t.float()
    with torch.no_grad():
        for i in reversed(range(len(seq))):
            a_t = float(a[seq[i]])
            a_prev = float(a[seq[i - 1]]) if i > 0 else 1.0
            t = torch.full((x.shape[0],), seq[i], dtype=torch.int64,
                           device=x.device)
            eps = unet(p, torch.cat([x, cond], dim=1), t, cfg)
            x0 = (x - math.sqrt(1.0 - a_t) * eps) / math.sqrt(a_t)
            x = math.sqrt(a_prev) * x0 + math.sqrt(1.0 - a_prev) * eps
    return x


def draws(shape, timesteps: int, gen) -> tuple:
    """(t, eps) of a batch of x0 `shape` (B, 9, H, W): t ~ U{0..T-1},
    then eps ~ N(0, I), from `gen` (after preparation's draws)."""
    t = torch.randint(0, timesteps, (shape[0],), generator=gen,
                      device=gen.device)
    eps = torch.randn(tuple(shape), generator=gen, device=gen.device)
    return t, eps


def clip_(leaves: list, max_norm: float) -> None:
    """Scale the gradients to a global 2-norm of at most `max_norm`."""
    grads = [q.grad for q in leaves if q.grad is not None]
    total = torch.stack([g.float().norm() for g in grads]).norm()
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in grads:
        g.mul_(coef)


def train_steps(cell: dict, seed: int, strips: np.ndarray, inputs: list,
                device, quant=_identity, made=None,
                keep: bool = False) -> tuple:
    """(readings, unmatched rows): the reference's run of the checked
    steps on the program's raw batches, from the seeded weights (or
    `made`, name -> f32 tensor). With `keep` the readings also hold the
    leaves after the steps ("params"), the EMA ("ema") and the first
    step's clipped gradients ("first_grads"), by name."""
    cfg = cell["config"]
    device = torch.device(device)
    corpus_maps = torch.from_numpy(corpus.strips_to_maps(strips)).to(device)
    if made is None:
        made = make_weights(cfg, stream_seed(seed, WEIGHTS_WORD), device)
    params = {k: v.clone().requires_grad_(True)
              for k, v in weights.as_masters(made, cfg).items()}
    leaves = list(params.values())
    p0 = [q.detach().clone() for q in leaves]
    ema = [q.detach().float().clone() for q in leaves]
    ema0 = [e.clone() for e in ema]
    opt = Adam(leaves, cfg["learning_rate"])
    a = abar(cfg)
    sqrt_a, sqrt_1ma = (a.sqrt().float().to(device),
                        (1.0 - a).sqrt().float().to(device))
    gen = torch.Generator(device=device)
    omb1 = float(np.float32(1.0 - 0.9))
    losses, grads, cotangent, unmatched = [], None, {}, 0
    with tf32_off():
        for k, raw in enumerate(inputs):
            own = _rows(raw["svbrdf"], corpus_maps)
            partner = _rows(raw["partner_svbrdf"], corpus_maps)
            unmatched += sum(i < 0 for i in own + partner)
            pick = lambda idx: corpus_maps[  # noqa: E731
                torch.tensor([max(i, 0) for i in idx], device=device)]
            gen.manual_seed(stream_seed(seed, k + 1))
            photos, target = maps.prepare(pick(own), pick(partner),
                                          cfg["used_image_count"], gen)
            x0 = encode(target)
            t, eps = draws(x0.shape, cfg["timesteps"], gen)
            x_t = (sqrt_a[t].view(-1, 1, 1, 1) * x0
                   + sqrt_1ma[t].view(-1, 1, 1, 1) * eps)
            pred = quant(unet(params, torch.cat([x_t, conditioning(photos)],
                                                dim=1), t, cfg, quant))
            if k == 0:
                pred.retain_grad()
            loss = torch.mean(torch.square(pred - eps))
            for q in leaves:
                q.grad = None
            loss.backward()
            clip_(leaves, cfg["grad_clip"])
            opt.step(k + 1, seed)
            with torch.no_grad():
                for e, q in zip(ema, leaves):
                    e.lerp_(q.float(), 1.0 - cfg["ema_decay"])
            losses.append(float(loss.detach()))
            if k == 0:
                cotangent = cotangent_norms(pred.grad)
                first = ({n: q.grad.detach().clone()
                          for n, q in params.items()} if keep else None)
                grads = [None if opt.first_moment(i) is None else float(
                    (opt.first_moment(i).double() / omb1).norm())
                    for i in range(len(leaves))]
    change = [float((q.detach().double() - q0.double()).norm())
              for q, q0 in zip(leaves, p0)]
    moved = [int((q.detach() != q0).sum()) for q, q0 in zip(leaves, p0)]
    ema_change = [float((e.double() - e0.double()).norm())
                  for e, e0 in zip(ema, ema0)]
    out = {"losses": losses, "grads": grads, "change": change,
           "moved": moved, "ema_change": ema_change, **cotangent}
    if keep:
        out.update(params={n: q.detach() for n, q in params.items()},
                   ema=dict(zip(params, ema)), first_grads=first)
    return out, unmatched


def diffusion_gaps(prog: dict, ref: dict) -> dict:
    """check.gaps, and ema_change_gap_median: over the leaves that gaps
    keeps, the median gap between the norms of the EMA's change over the
    checked steps, over the larger of the reference leaf's and the median
    leaf's."""
    out = gaps(prog, ref)
    med = statistics.median(g for g in ref["grads"] if g is not None)
    keep = [i for i, g in enumerate(ref["grads"])
            if g is not None and g >= 1e-3 * med]
    med_e = statistics.median(ref["ema_change"][i] for i in keep)
    out["ema_change_gap_median"] = statistics.median(
        abs(prog["ema_change"][i] - ref["ema_change"][i])
        / max(ref["ema_change"][i], med_e) for i in keep)
    return out
