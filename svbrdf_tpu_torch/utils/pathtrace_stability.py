"""Stability of mixed-loss training through the path tracer, on the card.

    python -m svbrdf_tpu_torch.utils.pathtrace_stability [--steps N]

Counterpart of scripts/pathtrace_stability.py for the port. Runs N train
steps (default 300) of the single-view model at full width (depth 8, 64
filters, 256^2, batch 8) with the mixed loss over the path tracer (spp
16 / 8) at the CLI's default precision (--dtype auto: bf16 with
bf16-SR masters on the card), on structured synthetic SVBRDFs: a smooth
normal field and banded maps, rolled per item, mixed with the batch
reversed. Prints one JSON record: the ms per step (host clock over the
steps after 3 warm-up steps, ending in a synchronize), the loss every
N/20 steps, whether every fetched loss and every Adam second moment is
finite, whether the loss decreased, and the card's name and power limit
(`nvidia-smi`). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np

WARMUP = 3


def structured_raw_batch(batch: int, size: int) -> dict:
    """The JAX script's structured SVBRDFs as a raw float batch: normals in
    [-1, 1], the other nine maps in [0.2, 0.8], item i rolled by 13 i
    pixels, partners the batch reversed; no photos."""
    ys, xs = np.meshgrid(np.linspace(-1, 1, size), np.linspace(-1, 1, size),
                         indexing="ij")
    nx = 0.4 * np.sin(3 * np.pi * xs)
    ny = 0.4 * np.cos(2 * np.pi * ys)
    nz = np.sqrt(np.clip(1 - nx ** 2 - ny ** 2, 0.1, None))
    normals = np.stack([nx, ny, nz], -1)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    base = np.stack([0.2 + 0.6 * (np.sin(5 * xs + i) * 0.5 + 0.5)
                     for i in range(9)], -1)
    sv = np.concatenate([normals, base], -1).astype(np.float32)
    svbrdf = np.stack([np.roll(sv, 13 * i, axis=1) for i in range(batch)])
    return {"inputs": np.zeros((batch, 0, size, size, 3), np.float32),
            "svbrdf": svbrdf, "partner_svbrdf": svbrdf[::-1].copy()}


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def run(steps: int = 300, batch: int = 8, size: int = 256, depth: int = 8,
        num_filters: int = 64, device="cuda") -> dict:
    """`steps` path-traced mixed-loss train steps at the CLI's default
    precision (--dtype auto) on `device`; the JSON record."""
    import torch

    from svbrdf_tpu_torch.training.loop import resolve_dtype
    from svbrdf_tpu_torch.utils.bench_setup import build_program

    if steps <= WARMUP:
        raise ValueError(f"need more than {WARMUP} steps")
    dt = resolve_dtype("auto", device)
    program = build_program("single", "mixed", batch, size, depth,
                            num_filters, seed=0, device=device, dtype=dt,
                            renderer="pathtracing")
    dev = program.raw["svbrdf"].device
    raw = {k: torch.from_numpy(v).to(dev)
           for k, v in structured_raw_batch(batch, size).items()}
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    every = max(1, steps // 20)
    seen = []
    start = None
    timed = 0
    for i in range(steps):
        loss = program.train_step(raw)
        if i == WARMUP - 1:
            sync()
            start = time.perf_counter()
        elif i >= WARMUP:
            timed += 1
        if (i + 1) % every == 0 or i == steps - 1:
            value = float(loss)
            seen.append([i, value])
            print(f"step {i}: loss {value:.5f}", file=sys.stderr,
                  flush=True)
            if not math.isfinite(value):
                break
    sync()
    step_ms = (time.perf_counter() - start) / max(1, timed) * 1e3
    optimizer = program.train_step.optimizer
    nu_finite = all(bool(torch.isfinite(s["exp_avg_sq"]).all())
                    for s in optimizer.state.values() if "exp_avg_sq" in s)
    return {
        "metric": "pathtracing_stability",
        "card": card() if dev.type == "cuda" else str(dev),
        "steps": steps, "timed_steps": timed, "spp": [16, 8],
        "batch": batch, "size": size, "depth": depth,
        "num_filters": num_filters, "dtype": str(dt).replace("torch.", ""),
        "step_ms": step_ms,
        "losses": seen,
        "all_finite": all(math.isfinite(v) for _, v in seen),
        "adam_nu_finite": nu_finite,
        "loss_decreased": seen[-1][1] < seen[0][1],
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=300)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("pathtrace_stability: needs a CUDA device")
    from svbrdf_tpu_torch.device import precision_scope
    from svbrdf_tpu_torch.parallel.step import master_dtype_scope
    from svbrdf_tpu_torch.training.loop import resolve_dtype

    with master_dtype_scope(), precision_scope(resolve_dtype("auto",
                                                             "cuda")):
        print(json.dumps(run(args.steps)))


if __name__ == "__main__":
    main()
