import torch

from svbrdf_tpu_torch.models.generator import Generator
from svbrdf_tpu_torch.models.multi_view import MultiViewModel
from svbrdf_tpu_torch.models.single_view import SingleViewModel

__all__ = ["Generator", "MultiViewModel", "SingleViewModel", "build_model"]


def build_model(model_type: str, use_coords: bool = False, depth: int = 8,
                num_filters: int = 64, device="cuda", seed: int = 0,
                dtype=torch.float32):
    """Model factory by name ('single' | 'multi'), its parameters made on
    `device` from `seed` (f32), computing in `dtype`."""
    if model_type == "single":
        return SingleViewModel(num_filters, depth, use_coords, device=device,
                               seed=seed, dtype=dtype)
    if model_type == "multi":
        return MultiViewModel(num_filters, depth, use_coords=use_coords,
                              device=device, seed=seed, dtype=dtype)
    raise ValueError(f"unknown model type '{model_type}'")
