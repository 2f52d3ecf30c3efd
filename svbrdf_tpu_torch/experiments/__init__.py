from svbrdf_tpu_torch.experiments.map_recovery import (  # noqa: F401
    CaptureStep, fixed_scene_rendering_loss, recover_latent, recover_maps)
