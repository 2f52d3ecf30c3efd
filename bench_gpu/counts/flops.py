"""Frozen FLOP plan of the networks: the yardstick of `mfu_pct`.

Convolution and dense multiply-adds (1 MAC = 2 FLOP) of one forward,
batch 1, counted from the layer plan of the method (the same plan as
`bench_gpu/reference/model.py`); a backward costs twice the forward
(input and weight gradients) and nothing is recomputed, so a train step
is three forwards. Elementwise, normalization, loss and optimizer work is
not counted: the count is a floor of the work, so the share it gives is
too.
"""

from __future__ import annotations

HEAD_FEATURES = (64, 32, 9)
# Dense bf16 peak of one H100 SXM (NVIDIA's data sheet, without sparsity).
PEAK_BF16_FLOPS = 989e12


def generator_forward_flops(image_size: int = 256, in_channels: int = 3,
                            out_channels: int = 9, ngf: int = 64,
                            depth: int = 8) -> int:
    """One U-Net forward: stride-2 4x4 encoder convs, two 4x4 convs a
    decoder block at its output size (the first on the skip concat), and
    the global track's and merges' dense layers."""
    enc = [ngf * min(2 ** i, 8) for i in range(depth)]
    dec = [out_channels if i == depth - 1 else enc[depth - 2 - i]
           for i in range(depth)]
    flops, cin = 0, in_channels
    for i, cout in enumerate(enc):
        res = image_size >> (i + 1)
        flops += 2 * res * res * 16 * cin * cout
        cin = cout
    prev = enc[-1]
    for i, cout in enumerate(dec):
        res = image_size >> (depth - 1 - i)
        cin = prev + (enc[depth - 1 - i] if i > 0 else 0)
        flops += 2 * res * res * 16 * (cin * cout + cout * cout)
        prev = cout
    gte_out = [enc[i + 1] for i in range(depth - 1)] + [dec[0]]
    gtd_out = dec[1:] + [out_channels]
    g_in = in_channels
    for i in range(depth):
        flops += 2 * (g_in + (enc[i] if i > 0 else 0)) * gte_out[i]
        g_in = gte_out[i]
    for i in range(depth):
        flops += 2 * (g_in + dec[i]) * gtd_out[i]
        g_in = gtd_out[i]
    for f in enc[1:] + dec:
        flops += 2 * g_in * f
    return flops


def multi_view_forward_flops(image_size: int = 256, views: int = 3,
                             ngf: int = 64, depth: int = 8,
                             generator_channels: int = 64) -> int:
    """One multi-view forward: the 64-channel generator over every view,
    then the fusion head (a merge, three 3x3 convs 64 -> 64 -> 32 -> 9 and
    three dense global-track layers) at full size."""
    flops = views * generator_forward_flops(
        image_size, out_channels=generator_channels, ngf=ngf, depth=depth)
    c = generator_channels
    flops += 2 * c * c  # merge
    pixels = image_size * image_size
    for cin, cout in zip((c,) + HEAD_FEATURES[:-1], HEAD_FEATURES):
        flops += 2 * pixels * 9 * cin * cout  # 3x3 conv
        flops += 2 * 2 * cin * cout  # global track over concat(g, mean)
        flops += 2 * cout * cout  # the block's merge
    return flops


def train_step_flops(config: dict) -> int:
    """Model FLOPs of one train step of `config` (a benchmark
    configuration file's dict) at its batch: three forwards."""
    size, ngf, depth = (config["image_size"], config["num_filters"],
                        config["model_depth"])
    if config["model_type"] == "single":
        fwd = generator_forward_flops(size, ngf=ngf, depth=depth)
    else:
        fwd = multi_view_forward_flops(size, config["used_image_count"], ngf,
                                       depth)
    return 3 * fwd * config["batch_size"]
