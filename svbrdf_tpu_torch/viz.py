"""Host-side visualization: comparison grids, ortho->perspective mapping.

Counterpart of svbrdf_tpu/viz.py: the test-time comparison grid, written
through the port's PNG writer; a closed-form numpy homography and bilinear
warp (no cv2) that maps an orthographic patch rendering into a perspective
camera; turntable frames rendered on the device; and animations written
as GIFs by the port's own writer (data/gif.py; no Pillow).
"""

from __future__ import annotations

import numpy as np
import torch

from svbrdf_tpu_torch.data import gif, strips
from svbrdf_tpu_torch.device import resolve_device
from svbrdf_tpu_torch.ops import render as render_mod
from svbrdf_tpu_torch.scene import Scene


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


# ---------------------------------------------------------------------------
# Ortho -> perspective mapping (visualization only).
# ---------------------------------------------------------------------------

def _camera_projection(camera_pos, sensor_size) -> np.ndarray:
    """P = K [R|t] looking from camera_pos at the origin, z-up.

    Same camera model as reference renderers.py:110-146: principal axis
    toward the origin, up = patch normal (z), intrinsics chosen so the 2x2
    patch fills the sensor at distance 1.
    """
    C = np.asarray(camera_pos, np.float64)
    cz = -C / np.linalg.norm(C)
    up = np.array([0.0, 0.0, 1.0])
    cx = np.cross(cz, up)
    n = np.linalg.norm(cx)
    cx = np.array([1.0, 0.0, 0.0]) if n == 0.0 else cx / n
    cy = np.cross(cz, cx)

    R = np.stack([cx, cy, cz], axis=0)
    t = -R @ C
    E = np.concatenate([R, t[:, None]], axis=1)  # 3x4

    K = np.eye(3)
    K[0, 0] = K[1, 1] = K[0, 2] = sensor_size[0] / 2.0
    K[1, 2] = sensor_size[1] / 2.0
    return K @ E


def find_homography(src_pts: np.ndarray, dst_pts: np.ndarray) -> np.ndarray:
    """DLT: exact 4-point homography (replaces cv2.findHomography)."""
    A = []
    b = []
    for (x, y), (u, v) in zip(src_pts, dst_pts):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        b.append(u)
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        b.append(v)
    h = np.linalg.solve(np.asarray(A, np.float64), np.asarray(b, np.float64))
    return np.concatenate([h, [1.0]]).reshape(3, 3)


def warp_perspective(image: np.ndarray, H: np.ndarray,
                     dsize: tuple) -> np.ndarray:
    """Bilinear inverse warp (replaces cv2.warpPerspective); zero fill."""
    out_w, out_h = dsize
    Hinv = np.linalg.inv(H)

    us, vs = np.meshgrid(np.arange(out_w), np.arange(out_h))
    ones = np.ones_like(us)
    dst = np.stack([us, vs, ones], axis=-1).reshape(-1, 3).astype(np.float64)
    src = dst @ Hinv.T
    src = src[:, :2] / src[:, 2:3]

    x, y = src[:, 0], src[:, 1]
    h, w = image.shape[:2]
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]

    def sample(yy, xx):
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        vals = np.zeros((len(xx),) + image.shape[2:], image.dtype)
        vals[valid] = image[yy[valid], xx[valid]]
        return vals, valid

    v00, m00 = sample(y0, x0)
    v01, m01 = sample(y0, x0 + 1)
    v10, m10 = sample(y0 + 1, x0)
    v11, m11 = sample(y0 + 1, x0 + 1)
    out = (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
           + v10 * (1 - fx) * fy + v11 * fx * fy)
    return out.reshape(out_h, out_w, *image.shape[2:]).astype(image.dtype)


def turntable_frames(svbrdf, n_frames: int = 60, elevation: float = 2.0,
                     radius: float = 1.5, light_color=(30.0, 30.0, 30.0),
                     sensor_size=(384, 384), render_fn=None,
                     device="cuda") -> list:
    """Orbit a camera+light around the patch; perspective-warped frames.

    svbrdf (H, W, 12), numpy or a tensor, is rendered on `device` by
    `render_fn` (default: the local renderer, ops/render.render); the
    gamma-encoded radiance is warped on the host. Returns a list of (H, W,
    3) float32 images in [0, 1] of `sensor_size`.
    """
    dev = resolve_device(device)
    render_fn = render_fn or render_mod.render
    sv = (svbrdf if isinstance(svbrdf, torch.Tensor)
          else torch.from_numpy(np.asarray(svbrdf, np.float32)))
    sv = sv.to(dev, torch.float32)
    frames = []
    for i in range(n_frames):
        angle = 2.0 * np.pi * i / n_frames
        cam = [radius * np.cos(angle), radius * np.sin(angle), elevation]
        light = [radius * np.cos(angle + 0.5),
                 radius * np.sin(angle + 0.5), elevation + 0.5]
        scene = Scene.make(cam, light, light_color).to(dev)
        with torch.no_grad():
            radiance = render_fn(scene, sv).float().cpu().numpy()
        image = np.clip(radiance, 0.0, 1.0) ** (1.0 / 2.2)
        mapping = OrthoToPerspectiveMapping(cam, sensor_size)
        frames.append(mapping.apply(image.astype(np.float32)))
    return frames


def save_animation(path: str, frames, fps: int = 15) -> None:
    """Write frames ([0,1] float HWC) as a looping animated GIF
    (data/gif.py: a fixed 3-3-2 palette, round(100 / fps) hundredths of a
    second a frame)."""
    gif.write_gif(path, [np.uint8(np.clip(f, 0, 1) * 255) for f in frames],
                  delay_cs=max(1, round(100 / fps)))


def make_training_video(image_paths, out_path: str, fps: int = 10) -> None:
    """Animate per-epoch prediction snapshots into a GIF."""
    save_animation(out_path, [strips.read_image(p) for p in image_paths],
                   fps)


class OrthoToPerspectiveMapping:
    """Map an orthographic patch rendering into a perspective camera view.

    API parity with reference renderers.py:106-173; `t` interpolates
    between identity and the full homography for turntable animations.
    """

    def __init__(self, camera_pos, sensor_size):
        self.sensor_size = tuple(sensor_size)
        P = _camera_projection(camera_pos, self.sensor_size)
        corners = np.array([
            [-1, 1, 0, 1], [-1, -1, 0, 1], [1, -1, 0, 1], [1, 1, 0, 1],
        ], np.float64)
        proj = (P @ corners.T).T
        self._target = proj[:, :2] / proj[:, 2:3]

    def get_homography(self, input_size) -> np.ndarray:
        w, h = input_size
        src = np.array([[0, 0], [0, h], [w, h], [w, 0]], np.float64)
        return find_homography(src, self._target)

    def apply(self, image: np.ndarray, t: float = 1.0) -> np.ndarray:
        h, w = image.shape[:2]
        H = t * self.get_homography((w, h)) + (1.0 - t) * np.eye(3)
        return warp_perspective(image, H, self.sensor_size)
