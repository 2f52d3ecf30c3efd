from svbrdf_tpu_torch.models.generator import Generator
from svbrdf_tpu_torch.models.single_view import SingleViewModel

__all__ = ["Generator", "SingleViewModel"]
