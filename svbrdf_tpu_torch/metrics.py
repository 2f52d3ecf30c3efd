"""Quantitative SVBRDF quality metrics.

Counterpart of svbrdf_tpu/metrics.py: per-map RMSE, log-space RMSE for
diffuse and specular (log(x + 0.01), the space the L1 loss compares in),
per-map SSIM, and the RMSE between log-tonemapped renders of prediction and
target under a fixed scene set, so numbers are comparable across runs,
checkpoints and the two packages. `--mode test` writes them to metrics.json
next to the PNG grids.
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np
import torch
from torch.nn import functional as F

from svbrdf_tpu_torch.ops import codecs, render
from svbrdf_tpu_torch.ops.render_fused import EPSILON_L1, EPSILON_RENDER
from svbrdf_tpu_torch.scene import Scene

# The evaluation scenes: the JAX package's draw
# generate_loss_scenes(jax.random.key(313), 1, 3, 6), 3 random and 6
# specular scenes, written out because torch cannot reproduce jax.random.
# Rows are [camera xyz | light xyz | light rgb].
METRIC_SCENES = (
    (-0.8122490644454956, -0.0949084535241127, 0.5755378603935242,
     0.24305550754070282, -0.2688806354999542, 0.9320017695426941,
     20.0, 20.0, 20.0),
    (-0.6647831201553345, -0.6369578838348389, 0.3903178870677948,
     -0.4605635702610016, -0.5523617267608643, 0.6948220133781433,
     20.0, 20.0, 20.0),
    (-0.38672927021980286, 0.1553039699792862, 0.9090220928192139,
     -0.4331323504447937, -0.7768503427505493, 0.45705562829971313,
     20.0, 20.0, 20.0),
    (1.8659718036651611, -1.778883457183838, 2.480435848236084,
     0.08540922403335571, -0.7191774249076843, 0.42450737953186035,
     50.0, 50.0, 50.0),
    (-0.06505931913852692, 1.8457248210906982, 2.757103443145752,
     0.03492686152458191, -1.1051597595214844, 0.8455331325531006,
     50.0, 50.0, 50.0),
    (0.460570365190506, 0.8429710268974304, 1.5458078384399414,
     0.45184966921806335, 0.029440850019454956, 1.1465206146240234,
     50.0, 50.0, 50.0),
    (0.372234970331192, 0.2773449718952179, 0.9912703633308411,
     -0.12915506958961487, 0.6739840507507324, 0.8263012170791626,
     50.0, 50.0, 50.0),
    (2.1019904613494873, 0.7024357914924622, 0.7055883407592773,
     -0.6025309562683105, 0.04595769941806793, 0.4337293803691864,
     50.0, 50.0, 50.0),
    (-0.8939218521118164, -1.5629937648773193, 2.9585344791412354,
     0.9376407861709595, 2.166142225265503, 1.6906099319458008,
     50.0, 50.0, 50.0),
)


def metric_scenes(device=None) -> Scene:
    """The evaluation scenes as a Scene with (1, 9, 3) fields."""
    table = torch.tensor(METRIC_SCENES, dtype=torch.float32,
                         device=device)[None]
    return Scene(table[..., 0:3], table[..., 3:6], table[..., 6:9])


def _rmse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(torch.square(a - b)))


def _gaussian_window(size: int = 11, sigma: float = 1.5,
                     device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (
        size - 1) / 2.0
    g = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    g = g / torch.sum(g)
    return torch.outer(g, g)


def ssim(a: torch.Tensor, b: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    """Mean structural similarity (Wang et al. 2004) of (..., H, W, C)
    images: 11x11 Gaussian window (sigma 1.5), K1=0.01, K2=0.03, 'VALID'
    windows (no border inflation), channels treated independently and
    averaged."""
    a = a.float()
    b = b.float()
    h, w, c = a.shape[-3:]
    win = _gaussian_window(device=a.device)[None, None]  # (1, 1, 11, 11)

    def filt(img):
        # Depthwise: every channel of every image is one plane.
        planes = img.reshape(-1, h, w, c).permute(0, 3, 1, 2)
        return F.conv2d(planes.reshape(-1, 1, h, w), win)

    mu_a, mu_b = filt(a), filt(b)
    s_aa = filt(a * a) - mu_a * mu_a
    s_bb = filt(b * b) - mu_b * mu_b
    s_ab = filt(a * b) - mu_a * mu_b
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    num = (2.0 * mu_a * mu_b + c1) * (2.0 * s_ab + c2)
    den = (mu_a * mu_a + mu_b * mu_b + c1) * (s_aa + s_bb + c2)
    return torch.mean(num / den)


@torch.no_grad()
def svbrdf_metrics(pred: torch.Tensor, target: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
    """Per-map + rendering metrics of one sample or a batch (..., H, W, 12).

    Returns scalars: rmse per map, log-space rmse for diffuse/specular,
    ssim per map (normals with data range 2), and rendering_rmse, the RMSE
    between log(render + 0.1) of pred and target under the 9 METRIC_SCENES.
    For one sample this is the JAX package's value; a batch of B > 1 scores
    every item under the same 9 scenes, where the JAX package would draw B
    sets.
    """
    p = codecs.unpack_svbrdf(pred)
    t = codecs.unpack_svbrdf(target)
    out = {
        "rmse_normals": _rmse(p.normals, t.normals),
        "rmse_diffuse": _rmse(p.diffuse, t.diffuse),
        "rmse_roughness": _rmse(p.roughness, t.roughness),
        "rmse_specular": _rmse(p.specular, t.specular),
        "log_rmse_diffuse": _rmse(torch.log(p.diffuse + EPSILON_L1),
                                  torch.log(t.diffuse + EPSILON_L1)),
        "log_rmse_specular": _rmse(torch.log(p.specular + EPSILON_L1),
                                   torch.log(t.specular + EPSILON_L1)),
        "ssim_normals": ssim(p.normals, t.normals, data_range=2.0),
        "ssim_diffuse": ssim(p.diffuse, t.diffuse),
        "ssim_roughness": ssim(p.roughness, t.roughness),
        "ssim_specular": ssim(p.specular, t.specular),
    }
    batched = pred.reshape((-1,) + tuple(pred.shape[-3:]))
    tgt = target.reshape((-1,) + tuple(target.shape[-3:]))
    scenes = metric_scenes(pred.device)
    pred_r = render.render(scenes, batched[:, None])
    tgt_r = render.render(scenes, tgt[:, None])
    out["rendering_rmse"] = _rmse(torch.log(pred_r + EPSILON_RENDER),
                                  torch.log(tgt_r + EPSILON_RENDER))
    return out


def to_python(metric_tree: Dict) -> Dict[str, float]:
    return {k: float(v) for k, v in metric_tree.items()}


def summarize(per_sample: list) -> Dict:
    """Mean over per-sample metric dicts + the samples themselves."""
    if not per_sample:
        return {"mean": {}, "samples": []}
    keys = per_sample[0]["metrics"].keys()
    mean = {k: float(np.mean([s["metrics"][k] for s in per_sample]))
            for k in keys}
    return {"mean": mean, "samples": per_sample}


def write_metrics(path, summary: Dict) -> None:
    with open(path, "w") as f:
        json.dump(summary, f, indent=2)
