from svbrdf_tpu_torch.models.generator import Generator
from svbrdf_tpu_torch.models.multi_view import MultiViewModel
from svbrdf_tpu_torch.models.single_view import SingleViewModel

__all__ = ["Generator", "MultiViewModel", "SingleViewModel"]
