"""Frozen FLOP plan of MaterialGAN's generator: the yardstick of
`mfu_pct.capture`.

Convolution and dense multiply-adds (1 MAC = 2 FLOP) of one material's
synthesis, counted from StyleGAN2's layer plan (the same plan as
`bench_gpu/reference/stylegan2.py`): a 3x3 conv at r^2 is r^2 * 9 * Cin
* Cout MACs; an up-sampling one, transposed with stride 2 from (r/2)^2,
(r/2)^2 * 9 * Cin * Cout; a 1x1 toRGB r^2 * Cin * 9; each conv's affine
w_dim * Cin. The mapping network does not run in a capture step (W+ is
optimized directly). A capture step is one forward and one gradient with
respect to the inputs, which costs what the forward does: twice the
forward. There is no weight gradient (the network is frozen; the
modulation's gradient is elementwise), and modulation, demodulation,
the FIR, noise, activations, the renderer, the loss and Adam are not
counted: the count is a floor of the work, so the share it gives is
too.
"""

from __future__ import annotations

import math

# Dense TF32 peak of one H100 SXM (NVIDIA's data sheet, without sparsity).
PEAK_TF32_FLOPS = 494.7e12
RGB_CHANNELS = 9


def _channels(res: int, max_channels: int, channel_base: int) -> int:
    return min(max_channels, channel_base // res)


def synthesis_flops(resolution: int = 256, w_dim: int = 512,
                    max_channels: int = 512,
                    channel_base: int = 32768) -> int:
    """One material's synthesis forward."""
    res = [2 ** i for i in range(2, int(math.log2(resolution)) + 1)]
    ch = [_channels(r, max_channels, channel_base) for r in res]
    affine = lambda cin: 2 * w_dim * cin  # noqa: E731
    flops = 2 * 16 * 9 * ch[0] * ch[0] + affine(ch[0])
    flops += 2 * 16 * ch[0] * RGB_CHANNELS + affine(ch[0])
    for r, cin, cout in zip(res[1:], ch, ch[1:]):
        flops += 2 * (r // 2) ** 2 * 9 * cin * cout + affine(cin)
        flops += 2 * r * r * 9 * cout * cout + affine(cout)
        flops += 2 * r * r * cout * RGB_CHANNELS + affine(cout)
    return flops


def capture_step_flops(config: dict, materials: int) -> int:
    """Model FLOPs of one capture step of `config` (the benchmark's
    configuration file's dict) over `materials` materials."""
    return 2 * materials * synthesis_flops(
        config["resolution"], config["w_dim"], config["max_channels"],
        config["channel_base"])
