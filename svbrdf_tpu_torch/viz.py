"""Host-side visualization: the test-time comparison grid.

Counterpart of svbrdf_tpu/viz.py's svbrdf_to_tiles and
save_comparison_grid, written through the port's PNG writer. The
ortho -> perspective homography of that module is not ported yet.
"""

from __future__ import annotations

import numpy as np

from svbrdf_tpu_torch.data import strips


def _to_display(img: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(img, np.float32), 0.0, 1.0)


def svbrdf_to_tiles(svbrdf: np.ndarray) -> list:
    """12-channel map -> display tiles [normals, diffuse, roughness,
    specular]; normals are remapped [-1,1] -> [0,1] for display."""
    normals = (svbrdf[..., 0:3] + 1.0) / 2.0
    return [_to_display(normals), _to_display(svbrdf[..., 3:6]),
            _to_display(svbrdf[..., 6:9]), _to_display(svbrdf[..., 9:12])]


def save_comparison_grid(path: str, input_image: np.ndarray,
                         gt_svbrdf: np.ndarray,
                         pred_svbrdf: np.ndarray) -> None:
    """2-row grid: [gamma-encoded input | 4 GT maps] / [blank | 4
    predictions], as an 8-bit RGB PNG of (2 H, 5 W)."""
    inp = _to_display(np.power(np.clip(input_image, 0.0, None), 1.0 / 2.2))
    gt = svbrdf_to_tiles(np.asarray(gt_svbrdf))
    pred = svbrdf_to_tiles(np.asarray(pred_svbrdf))
    blank = np.zeros_like(inp)
    top = np.concatenate([inp] + gt, axis=1)
    bottom = np.concatenate([blank] + pred, axis=1)
    strips.write_image(path, np.concatenate([top, bottom], axis=0))
