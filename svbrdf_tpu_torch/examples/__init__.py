"""Runnable examples of the port: python -m svbrdf_tpu_torch.examples.<name>
(predict, turntable, renderer_compare, recover_maps)."""
