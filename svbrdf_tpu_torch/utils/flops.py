"""Analytic FLOP accounting for the train step, for MFU reporting.

Counterpart of svbrdf_tpu/utils/flops.py. Counts the convolution and dense
MACs of the Generator U-Net plus an estimate of the shading work of the
rendering loss. Convention: 1 MAC = 2 FLOPs; a backward pass costs 2x the
forward conv FLOPs (input gradient + weight gradient), so fwd + bwd = 3x
fwd: the "model FLOPs" basis of MFU (achieved FLOP/s over peak), a lower
bound that leaves out elementwise, norm and optimizer work.

The layer plan mirrors models/generator.py. The port's decoder is the plain
one (nearest 2x upsample, pad, 4x4 conv), so it is counted at that cost:
`folded_decoder` stays an argument so call sites read as the JAX package's,
and only False is accepted (the JAX package's folded form is a TPU layout).

Peaks are per card, from NVIDIA's H100 datasheet (dense, without
sparsity): bf16 on the tensor cores, and f32 on the CUDA cores (the f32
train step runs with TF32 off, device.precision_scope).
"""

from __future__ import annotations

# (a part of torch.cuda.get_device_name, {dtype: peak FLOP/s}); the first
# match wins. The SXM card reports itself as "NVIDIA H100 80GB HBM3".
PEAK_FLOPS = (
    ("H100 PCIe", {"bfloat16": 756e12, "float32": 51e12}),
    ("H100 SXM", {"bfloat16": 989e12, "float32": 67e12}),
    ("H100 80GB HBM3", {"bfloat16": 989e12, "float32": 67e12}),
)


def peak_flops(device_name: str, dtype: str = "bfloat16") -> float:
    """The card's peak FLOP/s for `dtype` ('bfloat16' | 'float32', or a
    torch dtype); an unknown card raises."""
    dtype = str(dtype).replace("torch.", "")
    for key, peaks in PEAK_FLOPS:
        if key in device_name:
            if dtype not in peaks:
                raise ValueError(f"no {dtype} peak for {device_name!r}")
            return peaks[dtype]
    raise ValueError(f"no peak FLOP/s recorded for the card "
                     f"{device_name!r}; known: "
                     f"{[key for key, _ in PEAK_FLOPS]}")


def generator_forward_flops(image_size: int = 256, in_channels: int = 3,
                            out_channels: int = 9, ngf: int = 64,
                            depth: int = 8, folded_decoder: bool = False,
                            use_global_track: bool = True) -> int:
    """Conv + dense MAC FLOPs (2 * MACs) of one Generator forward, batch
    1."""
    if folded_decoder:
        raise ValueError("the port has no folded decoder (a TPU layout of "
                         "the JAX package); count folded_decoder=False")
    enc_feats = [ngf * min(2 ** i, 8) for i in range(depth)]
    dec_feats = [out_channels if i == depth - 1 else enc_feats[depth - 2 - i]
                 for i in range(depth)]
    flops = 0

    # Encoder: stride-2 4x4 convs; enc i outputs at size / 2^(i+1).
    cin = in_channels
    for i, cout in enumerate(enc_feats):
        res = image_size >> (i + 1)
        flops += 2 * res * res * 16 * cin * cout
        cin = cout

    # Decoder block i: input = prev features (+ skip concat for i > 0),
    # conv1 (4x4 on the upsampled input) then conv2 (4x4 stride 1), both at
    # the output resolution.
    prev = enc_feats[-1]
    for i, cout in enumerate(dec_feats):
        res_out = image_size >> (depth - 1 - i)
        cin = prev + (enc_feats[depth - 1 - i] if i > 0 else 0)
        flops += 2 * res_out * res_out * 16 * cin * cout
        flops += 2 * res_out * res_out * 16 * cout * cout
        prev = cout

    if use_global_track:
        # gte/gtd dense layers: in = mean-channels (+ prev global), tiny.
        gte_out = [enc_feats[i + 1] for i in range(depth - 1)] + [dec_feats[0]]
        gtd_out = dec_feats[1:] + [out_channels]
        g_in = in_channels  # gte1 consumes the input image's channel means
        for i in range(depth):
            mean_ch = enc_feats[i] if i > 0 else 0
            flops += 2 * (g_in + mean_ch) * gte_out[i]
            g_in = gte_out[i]
        for i in range(depth):
            flops += 2 * (g_in + dec_feats[i]) * gtd_out[i]
            g_in = gtd_out[i]
        # Merge layers: Dense(global -> features) per block, negligible.
        for f in enc_feats[1:] + dec_feats:
            flops += 2 * g_in * f

    return flops


def shading_flops(image_size: int, n_scenes: int = 9,
                  flops_per_pixel_scene: int = 400) -> int:
    """Rendering-loss shading estimate, batch 1: pred and gt under
    n_scenes, ~400 flops per pixel per scene per SVBRDF (the Cook-Torrance
    chain with its rsqrt and log)."""
    return 2 * n_scenes * image_size * image_size * flops_per_pixel_scene


def train_step_flops(batch: int = 8, image_size: int = 256,
                     folded_decoder: bool = False) -> int:
    """Model FLOPs of one mixed-loss train step (fwd + bwd = 3x fwd)."""
    fwd = generator_forward_flops(image_size, folded_decoder=folded_decoder)
    fwd += shading_flops(image_size)
    return 3 * fwd * batch


def mfu(step_seconds: float, batch: int = 8, image_size: int = 256,
        dtype: str = "bfloat16", folded_decoder: bool = False,
        device_name: str = None) -> float:
    """Model FLOPs utilization in [0, 1] against the peak of the card named
    `device_name` (default: torch.cuda.get_device_name(0), which needs a
    card) for `dtype`."""
    if device_name is None:
        import torch

        device_name = torch.cuda.get_device_name(0)
    flops = train_step_flops(batch, image_size, folded_decoder)
    return flops / step_seconds / peak_flops(device_name, dtype)
