"""The comparisons that decide a run's `correct`.

Training: the reference follows the program's first steps from the same
seeded weights, on the same strips (each batch row, and each mixing
partner, must be a strip of the seed's corpus byte for byte), with the
draws worked out again from the step's seed: the mixing alphas, the
synthesized photos' scenes and noise, the loss scenes and the path
tracer's samples from the step's generator, and the dropout masks from
the default generator that the harness seeds before the first step. The
numbers it reads (a cell's limits file names those it holds):
- loss_gap: the largest |program - reference| / |reference| of the
  checked steps' losses; loss_gap_first: the first step's alone;
- grad_gap (grad_gap_median): over the leaves, the largest (the median)
  gap between the norms of the first gradient as the optimizer holds it
  (its first moment after one step over 1 - b1), over the larger of the
  reference leaf's norm and the median leaf's;
- change_gap (change_gap_median): the same for the norm of each leaf's
  change over the checked steps;
- pred_grad_gap (pred_grad_gap_median): over the batch rows, the largest
  (the median) gap between the norms of the first step's cotangent of
  the predicted maps (the loss's gradient with respect to the model's
  output), over the larger of the reference row's norm and the median
  row's. Adam's first updates are about lr * sign(g), blind to the
  gradient's size; this number sees the loss's backward itself (a row
  left out, a scale, a wrong VJP) before the network's conditioning.
  pred_grad_l1_gap_median: the same of the rows' 1-norms, which weigh
  the path tracer's few darkest pixels (whose log-loss terms are large
  and swing with rounding) less than the 2-norm does;
- batch_rows_unmatched: batch rows and partners that are no strip of the
  corpus; stray_leaves: leaves the program updates and the reference
  does not.
Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of the leaf gaps (their updates are round-off
alone); a leaf that the reference updates and the program does not
counts as a gap of 1.

Prediction: each sampled call's written maps against the reference's
maps of the same photo, encoded the same way; the number is the largest
mean absolute byte difference of a call.
"""

from __future__ import annotations

import statistics
import sys

import numpy as np
import torch

from bench_gpu import corpus, pngio, weights
from bench_gpu.reference import maps, pathtrace
from bench_gpu.reference.adam import Adam, stream_seed
from bench_gpu.reference.model import Net, param_spec

# Words that keep the benchmark's seed streams apart: weights, corpus,
# dropout, photos, the check's sample of calls.
WEIGHTS_WORD, CORPUS_WORD, DROPOUT_WORD = 101, 102, 103
PHOTOS_WORD, SAMPLE_WORD = 104, 105
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class tf32_off:
    """f32 means f32: TF32 off for the reference's convs and products."""

    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.saved


def _rows(batch_u8: np.ndarray, corpus_maps: torch.Tensor) -> tuple:
    """The corpus index of each row, or -1 where no strip matches."""
    out = []
    for row in torch.from_numpy(batch_u8).to(corpus_maps.device):
        same = (corpus_maps == row).flatten(1).all(1)
        out.append(int(same.float().argmax()) if bool(same.any()) else -1)
    return out


def cotangent_norms(g: torch.Tensor) -> dict:
    """The 2-norm and the 1-norm of each batch row of the cotangent `g`,
    in float64."""
    rows = g.detach().double().flatten(1)
    return {"pred_grads": rows.norm(dim=1).tolist(),
            "pred_grads_l1": rows.abs().sum(dim=1).tolist()}


def reference_steps(cell: dict, seed: int, strips: np.ndarray, inputs: list,
                    device, quant=None) -> tuple:
    """(readings as the program's, unmatched rows): the reference's own
    run of the checked steps. `quant` runs it in a lower precision (the
    control) wherever the program rounds to its compute dtype: every conv
    and dense layer's inputs and weights, the predicted maps, and the
    target where the local renderer's loss reads it in the maps' dtype."""
    cfg = cell["config"]
    device = torch.device(device)
    corpus_maps = torch.from_numpy(corpus.strips_to_maps(strips)).to(device)
    made = weights.as_masters(
        weights.make(cfg, stream_seed(seed, WEIGHTS_WORD), device), cfg)
    params = {k: v.clone().requires_grad_(True) for k, v in made.items()}
    del made
    leaves = list(params.values())
    p0 = [p.detach().clone() for p in leaves]
    mask_dtype = DTYPES[cfg["dtype"]]

    def dropout(shape):
        ones = torch.ones(shape, dtype=mask_dtype, device=device)
        return torch.nn.functional.dropout(ones, 0.5, True).float()

    net = Net(cfg["model_type"], params, cfg["model_depth"], quant, dropout)
    opt = Adam(leaves, cfg["learning_rate"])
    gen = torch.Generator(device=device)
    batch, size = cfg["batch_size"], cfg["image_size"]
    n_scenes = maps.N_RANDOM_SCENES + maps.N_SPECULAR_SCENES
    omb1 = float(np.float32(1.0 - 0.9))
    losses, grads, cotangent, unmatched = [], None, {}, 0
    torch.manual_seed(stream_seed(seed, DROPOUT_WORD))
    with tf32_off():
        for k, raw in enumerate(inputs):
            own = _rows(raw["svbrdf"], corpus_maps)
            partner = _rows(raw["partner_svbrdf"], corpus_maps)
            unmatched += sum(i < 0 for i in own + partner)
            pick = lambda idx: corpus_maps[  # noqa: E731
                torch.tensor([max(i, 0) for i in idx], device=device)]
            gen.manual_seed(stream_seed(seed, k + 1))
            photos, target = maps.prepare(pick(own), pick(partner),
                                          cfg["used_image_count"], gen)
            pred = net(photos)
            if quant is not None:
                pred = quant(pred)
                if cfg["renderer"] == "local":
                    target = quant(target)
            if k == 0:
                pred.retain_grad()
            scenes = maps.loss_scenes(batch, gen, device)
            render_fn = None
            if cfg["renderer"] == "pathtracing":
                render_fn = pathtrace.make_render_fn(pathtrace.draw_samples(
                    gen, cfg["spp"], (batch, n_scenes), size, size, device))
            loss = maps.loss(cfg["loss"], pred, target, scenes,
                             cfg["l1_weight"], render_fn)
            for p in leaves:
                p.grad = None
            loss.backward()
            opt.step(k + 1, seed)
            losses.append(float(loss.detach()))
            if k == 0:
                cotangent = cotangent_norms(pred.grad)
                grads = [None if opt.first_moment(i) is None else float(
                    (opt.first_moment(i).double() / omb1).norm())
                    for i in range(len(leaves))]
    change = [float((p.detach().double() - q.double()).norm())
              for p, q in zip(leaves, p0)]
    moved = [int((p.detach() != q).sum()) for p, q in zip(leaves, p0)]
    return {"losses": losses, "grads": grads, "change": change,
            "moved": moved, **cotangent}, unmatched


def gaps(prog: dict, ref: dict) -> dict:
    """The numbers of `prog`'s readings against `ref`'s (see the module
    docstring): loss_gap and the first step's alone, the worst and the
    median leaf's grad and change gaps, and leaves only the program
    updates."""
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], ref["losses"]))
    med = statistics.median(g for g in ref["grads"] if g is not None)
    keep = [i for i, g in enumerate(ref["grads"])
            if g is not None and g >= 1e-3 * med]
    med_c = statistics.median(ref["change"][i] for i in keep)
    grad = [1.0 if prog["grads"][i] is None else
            abs(prog["grads"][i] - ref["grads"][i]) / max(ref["grads"][i],
                                                          med)
            for i in keep]
    change = [abs(prog["change"][i] - ref["change"][i])
              / max(ref["change"][i], med_c) for i in keep]
    stray = sum(1 for i, g in enumerate(ref["grads"])
                if g is None and prog["grads"][i] is not None)

    def row_gaps(key):
        med_r = statistics.median(ref[key])
        return [abs(p - r) / max(r, med_r) for p, r in zip(prog[key],
                                                            ref[key])]

    rows = row_gaps("pred_grads")
    return {"loss_gap": loss_gap,
            "loss_gap_first": abs(prog["losses"][0] - ref["losses"][0])
            / abs(ref["losses"][0]),
            "grad_gap": max(grad),
            "grad_gap_median": statistics.median(grad),
            "change_gap": max(change),
            "change_gap_median": statistics.median(change),
            "pred_grad_gap": max(rows),
            "pred_grad_gap_median": statistics.median(rows),
            "pred_grad_l1_gap_median": statistics.median(
                row_gaps("pred_grads_l1")),
            "stray_leaves": stray}


def worst_leaves(prog: dict, ref: dict, names: list) -> dict:
    """For a look at the gaps: the leaves behind the largest grad and
    change gaps, with both sides' norms (and, for the change, the
    elements each side moved)."""
    out = {}
    for key in ("grads", "change"):
        rows = [(abs((p or 0.0) - r) / max(r, 1e-30), names[i], p, r,
                 prog.get("moved", [None] * len(names))[i],
                 ref.get("moved", [None] * len(names))[i])
                for i, (p, r) in enumerate(zip(prog[key], ref[key]))
                if r is not None and ref["grads"][i] is not None]
        out[key] = sorted(rows, reverse=True)[:3]
    return out


def _held(values: dict, limits: dict) -> dict:
    """The numbers the cell's limits name, each beside its limit."""
    return {k: {"value": values[k], "limit": limit}
            for k, limit in limits.items()}


def train(cell, seed, strips, inputs, readings, device) -> dict:
    ref, unmatched = reference_steps(cell, seed, strips, inputs, device)
    cfg = cell["config"]
    names = [n for n, _, _ in param_spec(cfg["model_type"],
                                         cfg["num_filters"],
                                         cfg["model_depth"])]
    values = {"batch_rows_unmatched": unmatched, **gaps(readings, ref)}
    print(f"readings: {values}\nworst leaves: "
          f"{worst_leaves(readings, ref, names)}\ncotangent rows' norms "
          f"(program, reference): {readings['pred_grads']} "
          f"{ref['pred_grads']}", file=sys.stderr)
    return _held(values, cell["limits"])


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def encode_maps(sv: torch.Tensor) -> np.ndarray:
    """(H, W, 12) maps -> the (H, 4 W, 3) bytes of a written map strip:
    normals to [0, 1], values truncated to bytes."""
    n, d, r, s = maps.unpack(sv.float())
    strip = torch.cat([(n + 1.0) / 2.0, d, r, s], dim=1)
    return (torch.clamp(strip, 0.0, 1.0) * 255.0).to(torch.uint8).cpu(
        ).numpy()


def predict_gaps(cell, seed, samples: list, device) -> float:
    """The largest mean absolute byte difference between a sampled call's
    written strip (its PNG bytes) and the reference's, over the samples
    [(photo uint8, written PNG bytes)]."""
    cfg = cell["config"]
    made = weights.make(cfg, stream_seed(seed, WEIGHTS_WORD), device)
    net = Net(cfg["model_type"], made, cfg["model_depth"])
    worst = 0.0
    with tf32_off(), torch.no_grad():
        for photo, written in samples:
            x = (torch.from_numpy(photo).to(device).float() / 255.0) ** 2.2
            ref = encode_maps(net(x[None])[0]).astype(np.int16)
            got = pngio.decode(written).astype(np.int16)
            if got.shape != ref.shape:
                return float("inf")
            worst = max(worst, float(np.abs(got - ref).mean()))
    return worst


def predict(cell, seed, samples, device) -> dict:
    return _held({"map_gap_bytes": predict_gaps(cell, seed, samples,
                                                device)}, cell["limits"])
