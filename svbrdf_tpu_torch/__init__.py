"""PyTorch / CUDA port of svbrdf_tpu for NVIDIA Hopper (H100).

A package of its own beside the JAX reference: it imports torch and numpy,
never jax or svbrdf_tpu. Public functions keep the JAX package's layouts
(NHWC (B, H, W, 12) SVBRDFs, (B, N, H, W, 3) inputs); inside, SVBRDFs travel
as NCHW channel planes (B, 12, H, W).

Entry points run on "cuda" unless the caller passes device="cpu"; without a
card they raise instead of quietly running on the CPU (device.py).
"""

from svbrdf_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
