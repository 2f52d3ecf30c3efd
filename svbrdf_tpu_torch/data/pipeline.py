"""On-device batch preparation: decode, material mixing, input synthesis,
gamma.

Counterpart of svbrdf_tpu/data/pipeline.py (spatial target only). Every
random draw comes from the `generator` argument, on the batch's device, and
each can instead be passed in (alphas, input scenes, noise std, noise) so
that tests can give both frameworks the same numbers, and a data-parallel
rank its rows of the global batch's draws (draw_prepare_inputs). The
scaling functions
at the end (center crop, bilinear resize, scale_sample) fit samples to the
model's size on the host, for the dataset's float path.
"""

from __future__ import annotations

import math

import torch

from svbrdf_tpu_torch.ops import codecs, render, sampling
from svbrdf_tpu_torch.scene import Scene

MIN_EPS = 0.001
MAX_EPS = 0.02
FIXED_LIGHT_DISTANCE = 2.197
FIXED_VIEW_DISTANCE = 2.75


def _decode_u8_svbrdf(sv: torch.Tensor) -> torch.Tensor:
    """Raw strip bytes (..., 12) uint8 -> packed f32 SVBRDF: /255, normals
    remapped to [-1, 1]."""
    f = sv.float() / 255.0
    return torch.cat([f[..., :3] * 2.0 - 1.0, f[..., 3:]], dim=-1)


def mix_materials(svbrdf_a: torch.Tensor, svbrdf_b: torch.Tensor,
                  alpha: torch.Tensor) -> torch.Tensor:
    """alpha * a + (1 - alpha) * b, with normals blended in slope space
    (divided by their clamped z) and renormalized. alpha broadcasts against
    (..., H, W, 12), e.g. (B, 1, 1, 1)."""
    a = codecs.unpack_svbrdf(svbrdf_a)
    b = codecs.unpack_svbrdf(svbrdf_b)
    na = a.normals / torch.clamp(a.normals[..., 2:3], min=0.01)
    nb = b.normals / torch.clamp(b.normals[..., 2:3], min=0.01)
    n = alpha * na + (1.0 - alpha) * nb
    n = n / torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True))

    def lerp(x, y):
        return alpha * x + (1.0 - alpha) * y

    return codecs.pack_svbrdf(n, lerp(a.diffuse, b.diffuse),
                              lerp(a.roughness, b.roughness),
                              lerp(a.specular, b.specular))


def generate_input_scenes(batch: int, count: int, use_augmentation: bool = True,
                          *, generator: torch.Generator,
                          device=None) -> Scene:
    """Camera/light configurations for input-photo synthesis, (B, count, 3).

    Scene 0: light xy ~ U(-0.75, 0.75) at z = 2.197, view xy ~
    U(-0.25, 0.25) at z = view distance. Scenes 1..: cosine-hemisphere
    directions scaled by the fixed light distance and the view distance.
    Augmentation: flash intensity |N(20, exp(N(-2, 0.5)))| (one std per
    item), white balance |N(1, 0.03)|, view distance U(0.25, 2.75); without
    it intensity 30 and view distance 2.75.
    """
    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                           device=device)

    def normal(shape):
        return torch.randn(shape, generator=generator, device=device)

    first_light = torch.cat(
        [uniform((batch, 1, 2), -0.75, 0.75),
         torch.full((batch, 1, 1), FIXED_LIGHT_DISTANCE, device=device)], -1)
    light_pos = torch.cat([first_light, sampling.cosine_hemisphere_direction(
        (batch, count - 1), MIN_EPS, MAX_EPS, generator=generator,
        device=device) * FIXED_LIGHT_DISTANCE], dim=1)

    if use_augmentation:
        std = torch.exp(-2.0 + 0.5 * normal((batch, 1, 1)))
        intensity = torch.abs(20.0 + std * normal((batch, count, 1)))
        white_balance = torch.abs(1.0 + 0.03 * normal((batch, count, 3)))
        light_color = intensity * white_balance
        view_distance = uniform((batch, count, 1), 0.25, 2.75)
    else:
        light_color = torch.full((batch, count, 3), 30.0, device=device)
        view_distance = torch.full((batch, count, 1), FIXED_VIEW_DISTANCE,
                                   device=device)

    first_view = torch.cat([uniform((batch, 1, 2), -0.25, 0.25),
                            view_distance[:, :1]], dim=-1)
    view_pos = torch.cat([first_view, sampling.cosine_hemisphere_direction(
        (batch, count - 1), MIN_EPS, MAX_EPS, generator=generator,
        device=device) * view_distance[:, 1:]], dim=1)
    return Scene(view_pos, light_pos, light_color)


def _draw_alphas(batch: int, generator, device) -> torch.Tensor:
    """Mixing weights (B,) ~ U(0.1, 0.9)."""
    return 0.1 + 0.8 * torch.rand(batch, generator=generator, device=device)


def _draw_noise_std(batch: int, count: int, generator,
                    device) -> torch.Tensor:
    """Per-photo noise std (B, count, 1, 1, 1), log-normal around 0.005."""
    return torch.exp(math.log(0.005) + 0.3 * torch.randn(
        (batch, count, 1, 1, 1), generator=generator, device=device))


def draw_prepare_inputs(batch: int, n_read: int, height: int, width: int,
                        used_input_image_count: int, use_augmentation: bool,
                        mix: bool, *, generator: torch.Generator,
                        device=None) -> dict:
    """What prepare_batch draws from `generator` for `batch` items with
    `n_read` photos read of height x width (alphas when `mix`, then the
    synthesis' scenes, noise std and noise for the missing photos), in its
    order, as the keyword arguments that hand prepare_batch those draws."""
    draws = {}
    if mix:
        draws["alphas"] = _draw_alphas(batch, generator, device)
    count = used_input_image_count - n_read
    if count > 0:
        draws["scenes"] = generate_input_scenes(
            batch, count, use_augmentation, generator=generator,
            device=device)
        draws["noise_std"] = _draw_noise_std(batch, count, generator, device)
        draws["noise"] = torch.randn((batch, count, height, width, 3),
                                     generator=generator, device=device)
    return draws


def synthesize_inputs(svbrdf: torch.Tensor, count: int,
                      use_augmentation: bool = True, *,
                      generator: torch.Generator = None, scenes: Scene = None,
                      noise_std: torch.Tensor = None,
                      noise: torch.Tensor = None) -> torch.Tensor:
    """Render `count` flash-lit photos of each SVBRDF (B, H, W, 12) ->
    (B, count, H, W, 3): one render over the scene axis plus Gaussian
    noise of log-normal std exp(N(ln 0.005, 0.3)) per photo, clamped to
    [0, 1]. scenes (B, count, 3), noise_std (B, count, 1, 1, 1) and noise
    (B, count, H, W, 3) are drawn from `generator` unless given."""
    batch, height, width, _ = svbrdf.shape
    dev = svbrdf.device
    if scenes is None:
        scenes = generate_input_scenes(batch, count, use_augmentation,
                                       generator=generator, device=dev)
    renders = render.render(scenes, svbrdf[:, None])
    if noise_std is None:
        noise_std = _draw_noise_std(batch, count, generator, dev)
    if noise is None:
        noise = torch.randn(renders.shape, generator=generator, device=dev)
    return torch.clamp(renders + noise_std * noise, 0.0, 1.0)


def prepare_sample(images: torch.Tensor, svbrdf: torch.Tensor,
                   used_input_image_count: int, use_augmentation: bool = True,
                   is_linear: bool = False, **draws):
    """Gamma-decode the photos read (B, N_read, H, W, 3) and synthesize the
    missing ones from svbrdf (B, H, W, 12). Returns (inputs (B, used, H, W,
    3) linear RGB, svbrdf). `draws` go to synthesize_inputs."""
    if not is_linear and images.shape[1] > 0:
        images = codecs.gamma_decode(images)
    n_missing = used_input_image_count - images.shape[1]
    if n_missing > 0:
        synth = synthesize_inputs(svbrdf, n_missing, use_augmentation,
                                  **draws)
        images = (torch.cat([images, synth], dim=1) if images.shape[1] > 0
                  else synth)
    return images, svbrdf


def prepare_batch(raw_inputs: torch.Tensor, raw_svbrdfs: torch.Tensor,
                  partner_svbrdfs: torch.Tensor = None,
                  used_input_image_count: int = 1,
                  use_augmentation: bool = True, is_linear: bool = False, *,
                  generator: torch.Generator = None,
                  alphas: torch.Tensor = None, **draws) -> dict:
    """Prepare one batch on its device.

    raw_inputs (B, N_read, H, W, 3) and raw_svbrdfs (B, H, W, 12), uint8
    strip bytes or floats; partner_svbrdfs the mixing partners or None.
    Mixing alphas (B,) are U(0.1, 0.9) draws unless given. Returns
    {"inputs": (B, used, H, W, 3), "svbrdf": (B, H, W, 12)}.
    """
    if raw_inputs.dtype == torch.uint8:
        raw_inputs = raw_inputs.float() / 255.0
    if raw_svbrdfs.dtype == torch.uint8:
        raw_svbrdfs = _decode_u8_svbrdf(raw_svbrdfs)
    if partner_svbrdfs is not None:
        if partner_svbrdfs.dtype == torch.uint8:
            partner_svbrdfs = _decode_u8_svbrdf(partner_svbrdfs)
        if alphas is None:
            alphas = _draw_alphas(raw_svbrdfs.shape[0], generator,
                                  raw_svbrdfs.device)
        raw_svbrdfs = mix_materials(raw_svbrdfs, partner_svbrdfs,
                                    alphas.reshape(-1, 1, 1, 1))
    inputs, svbrdfs = prepare_sample(
        raw_inputs, raw_svbrdfs, used_input_image_count, use_augmentation,
        is_linear, generator=generator, **draws)
    return {"inputs": inputs, "svbrdf": svbrdfs}


def center_crop_to_square(images: torch.Tensor) -> torch.Tensor:
    """Center crop of (..., H, W, C) to the short side."""
    h, w = images.shape[-3], images.shape[-2]
    side = min(h, w)
    r0 = (h - side) // 2
    c0 = (w - side) // 2
    return images[..., r0:r0 + side, c0:c0 + side, :]


def resize_bilinear(images: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear resize of (..., H, W, C) to size x size: half-pixel
    centres, edge-replicated, no antialiasing on downsampling (the JAX
    package's separable _resize_axis_bilinear computes the same)."""
    lead, (h, w, c) = images.shape[:-3], images.shape[-3:]
    nchw = images.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    out = torch.nn.functional.interpolate(
        nchw, size=(size, size), mode="bilinear", align_corners=False,
        antialias=False)
    return out.permute(0, 2, 3, 1).reshape(*lead, size, size, c)


def scale_sample(images: torch.Tensor, svbrdf: torch.Tensor, image_size: int,
                 scale_mode: str, crop_anchor=(0, 0)):
    """Fit a sample to image_size by 'crop' (the window at crop_anchor) or
    'resize' (center crop to square, then bilinear down)."""
    if scale_mode == "resize":
        return (resize_bilinear(center_crop_to_square(images), image_size),
                resize_bilinear(center_crop_to_square(svbrdf), image_size))
    if scale_mode == "crop":
        return (codecs.crop_square(images, crop_anchor, image_size),
                codecs.crop_square(svbrdf, crop_anchor, image_size))
    raise ValueError(f"unknown scale mode '{scale_mode}'")
