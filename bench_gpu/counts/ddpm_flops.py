"""Frozen FLOP plan of Ho et al.'s DDPM U-Net: the yardstick of
`mfu_pct.diffusion`, and its parameter count.

The layer plan of `bench_gpu/reference/ddpm.py` (the release's
`unet.py`), walked at a configuration's widths: per conv its input and
output channels, kernel and output resolution; per dense layer its
widths; per attention block its channels and positions; per GroupNorm
its channels. Multiply-adds (1 MAC = 2 FLOP): a k x k conv at r^2 output
pixels is r^2 k^2 Cin Cout; a dense layer Cin Cout; an attention block's
two matrix products 2 L^2 C at L positions (the q, k, v and output
projections are its 1x1 convs). GroupNorm, SiLU, the time-bias adds, the
residual adds, the softmax, the up-sampling copies, the loss and Adam
are not counted: the count is a floor of the work, so the share it
gives is too.

A train step is three forwards (the forward, the input gradients, the
weight gradients), less conv_in's input gradient (the noisy maps and the
photo want none).
"""

from __future__ import annotations

# Dense bf16 peak of one H100 SXM (NVIDIA's data sheet, without sparsity).
PEAK_BF16_FLOPS = 989e12
IN_CHANNELS, OUT_CHANNELS = 12, 9


def layers(cfg: dict) -> list:
    """The plan: ('conv', cin, cout, k, res), ('dense', cin, cout),
    ('attn', channels, positions), ('norm', channels), in the
    forward's order."""
    ch, mult = cfg["ch"], list(cfg["ch_mult"])
    nrb, attn = cfg["num_res_blocks"], set(cfg["attn_resolutions"])
    temb = 4 * ch
    out = [("dense", ch, temb), ("dense", temb, temb)]

    def res_block(cin, cout, res):
        out.extend([("norm", cin), ("conv", cin, cout, 3, res),
                    ("dense", temb, cout), ("norm", cout),
                    ("conv", cout, cout, 3, res)])
        if cin != cout:
            out.append(("conv", cin, cout, 1, res))

    def attn_block(c, res):
        out.extend([("norm", c)] + [("conv", c, c, 1, res)] * 3
                   + [("attn", c, res * res), ("conv", c, c, 1, res)])

    res = cfg["resolution"]
    out.append(("conv", IN_CHANNELS, ch, 3, res))
    skips, block_in = [ch], ch
    for i, m in enumerate(mult):
        for _ in range(nrb):
            res_block(block_in, ch * m, res)
            block_in = ch * m
            if res in attn:
                attn_block(block_in, res)
            skips.append(block_in)
        if i != len(mult) - 1:
            res //= 2
            out.append(("conv", block_in, block_in, 3, res))
            skips.append(block_in)
    res_block(block_in, block_in, res)
    attn_block(block_in, res)
    res_block(block_in, block_in, res)
    for i in reversed(range(len(mult))):
        for _ in range(nrb + 1):
            res_block(block_in + skips.pop(), ch * mult[i], res)
            block_in = ch * mult[i]
            if res in attn:
                attn_block(block_in, res)
        if i != 0:
            res *= 2
            out.append(("conv", block_in, block_in, 3, res))
    out.extend([("norm", block_in),
                ("conv", block_in, OUT_CHANNELS, 3, res)])
    return out


def parameter_count(cfg: dict) -> int:
    n = 0
    for layer in layers(cfg):
        if layer[0] == "conv":
            _, cin, cout, k, _ = layer
            n += k * k * cin * cout + cout
        elif layer[0] == "dense":
            n += layer[1] * layer[2] + layer[2]
        elif layer[0] == "norm":
            n += 2 * layer[1]
    return n


def _layer_flops(layer) -> int:
    if layer[0] == "conv":
        _, cin, cout, k, res = layer
        return 2 * res * res * k * k * cin * cout
    if layer[0] == "dense":
        return 2 * layer[1] * layer[2]
    if layer[0] == "attn":
        return 2 * 2 * layer[2] * layer[2] * layer[1]
    return 0


def forward_flops(cfg: dict) -> int:
    """One sample's forward."""
    return sum(_layer_flops(layer) for layer in layers(cfg))


def train_step_flops(cfg: dict) -> int:
    """Model FLOPs of one train step of `cfg` (the benchmark's
    configuration file's dict) at its batch size."""
    conv_in = _layer_flops(("conv", IN_CHANNELS, cfg["ch"], 3,
                            cfg["resolution"]))
    return cfg["batch_size"] * (3 * forward_flops(cfg) - conv_in)
