from svbrdf_tpu_torch.experiments.map_recovery import (  # noqa: F401
    fixed_scene_rendering_loss, recover_maps)
