import torch

from svbrdf_tpu_torch.models.ddpm_unet import DDPMUNet
from svbrdf_tpu_torch.models.generator import Generator
from svbrdf_tpu_torch.models.multi_view import MultiViewModel
from svbrdf_tpu_torch.models.single_view import SingleViewModel
from svbrdf_tpu_torch.models.stylegan2 import StyleGAN2Generator

__all__ = ["DDPMUNet", "Generator", "MultiViewModel", "SingleViewModel",
           "StyleGAN2Generator", "build_model"]


def build_model(model_type: str, use_coords: bool = False, depth: int = 8,
                num_filters: int = 64, device="cuda", seed: int = 0,
                dtype=torch.float32, **sizes):
    """Model factory by name ('single' | 'multi' | 'materialgan' |
    'diffusion'), its parameters made on `device` from `seed` (f32),
    computing in `dtype`. 'materialgan' is MaterialGAN's StyleGAN2
    generator, f32, at config-f unless `sizes` (StyleGAN2Generator's
    resolution, w_dim, mapping_layers, max_channels, channel_base) say
    otherwise; 'diffusion' is Ho et al.'s DDPM U-Net at its published
    widths unless `sizes` (DDPMUNet's ch, ch_mult, num_res_blocks,
    attn_resolutions, resolution, groups, eps) say otherwise. Neither
    takes the U-Nets' arguments."""
    if model_type == "diffusion":
        return DDPMUNet(device=device, seed=seed, dtype=dtype, **sizes)
    if model_type == "materialgan":
        if dtype != torch.float32:
            raise ValueError("the materialgan generator computes in f32")
        return StyleGAN2Generator(device=device, seed=seed, **sizes)
    if sizes:
        raise TypeError(f"unexpected arguments {sorted(sizes)} for model "
                        f"type '{model_type}'")
    if model_type == "single":
        return SingleViewModel(num_filters, depth, use_coords, device=device,
                               seed=seed, dtype=dtype)
    if model_type == "multi":
        return MultiViewModel(num_filters, depth, use_coords=use_coords,
                              device=device, seed=seed, dtype=dtype)
    raise ValueError(f"unknown model type '{model_type}'")
