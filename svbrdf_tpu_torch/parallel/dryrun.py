"""Multi-device dry run: the data-parallel and the spatial training steps
over n ranks.

Counterpart of svbrdf_tpu/parallel/dryrun.py. It checks the multi-device
programs at a tiny size, in n ranks started for them: one card a rank over
NCCL (`python -m svbrdf_tpu_torch.parallel.dryrun 2`; fewer cards than
ranks raises), or on the CPU over gloo when the caller asks (`--cpu`).

The JAX dry run's three programs, here:
  1. the single-step batch-DP program: ported (prepare, forward, mixed
     loss, backward, gradient all-reduce, Adam), with the group's size
     asserted so that a smaller group cannot pass for an n-way run;
  2. the K-step lax.scan program (--device-data-cache): not ported on
     purpose (ROADMAP "Not ported": the chunk programs; the port
     dispatches each step), so K plain data-parallel steps take its place;
  3. the H-sharded spatial step (run_spatial): one spatial train step
     (parallel/spatial) with the height split over the n ranks, the
     replicas then held bit-identical.
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import Optional

import torch
import torch.multiprocessing as mp

from svbrdf_tpu_torch.models import build_model
from svbrdf_tpu_torch.ops import sampling
from svbrdf_tpu_torch.parallel import mesh, spatial
from svbrdf_tpu_torch.parallel import step as step_lib
from svbrdf_tpu_torch.utils import bench_setup

DEPTH, FILTERS, SIZE = 5, 8, 32
K_STEPS = 3


def run(n_devices: int, device_type: str = "cuda",
        timeout: Optional[float] = None) -> float:
    """The data-parallel programs at depth 5, 32^2, 8 filters and a global
    batch of max(n, 2), in n ranks started for them (mesh.spawn, `timeout`
    seconds at most), rank r on cuda:r (NCCL), or on the CPU (gloo) with
    device_type 'cpu': the single-step program, then K_STEPS more steps,
    the replicas then held bit-identical; then, in the same ranks, the
    spatial step (run_spatial's). Returns the first data-parallel step's
    loss (the group's mean)."""
    return _spawn(n_devices, device_type, timeout, (_programs, _spatial))[0]


def run_spatial(n_devices: int, device_type: str = "cuda",
                timeout: Optional[float] = None) -> float:
    """One spatial train step (parallel/spatial.SpatialTrainStep) at depth
    5, 32^2, 8 filters, batch 2, with 1 random and 2 specular loss scenes
    an item, the height split over n ranks started for it, as `run`
    starts them: a finite loss and replicas bit-identical. Returns the
    step's loss (the group's)."""
    return _spawn(n_devices, device_type, timeout, (_spatial,))[0]


def _spawn(n_devices, device_type, timeout, programs) -> list:
    mesh.make_mesh(n_devices, device_type)
    results = mp.get_context("spawn").SimpleQueue()
    mesh.spawn(_rank, n_devices,
               (n_devices, f"tcp://localhost:{mesh.free_port()}",
                device_type, programs, results), timeout)
    return results.get()


def _rank(rank: int, n_devices: int, address: str, device_type: str,
          programs, results) -> None:
    device = "cpu" if device_type == "cpu" else f"cuda:{rank}"
    group = mesh.init_group(n_devices, rank, device, address)
    # A pass on fewer ranks than requested proves nothing.
    if group.world != n_devices:
        raise RuntimeError(f"the group has {group.world} ranks, expected "
                           f"{n_devices}")
    losses = [program(n_devices, group) for program in programs]
    if group.is_main:
        results.put(losses)
    mesh.destroy_group()


def _programs(n_devices: int, group) -> float:
    program = bench_setup.build_program(
        "single", "mixed", max(n_devices, 2), SIZE, DEPTH, FILTERS, seed=0,
        device=group.device, group=group)
    loss = float(program.train_step(program.raw))
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite dry-run loss: {loss}")
    print(f"dryrun_multichip({n_devices}): batch-DP single-step program "
          f"OK, loss={loss:.4f}")
    losses = [float(program.train_step(program.raw))
              for _ in range(K_STEPS)]
    if not all(map(math.isfinite, losses)):
        raise RuntimeError(f"non-finite dry-run losses: {losses}")
    sums = mesh.replica_checksums(program.model.parameters(), group)
    if len(set(sums)) != 1:
        raise RuntimeError(f"replicas differ after {K_STEPS + 1} steps")
    print(f"dryrun_multichip({n_devices}): {K_STEPS} more steps OK (in "
          f"place of the {K_STEPS}-step scan program), losses="
          f"{[round(v, 4) for v in losses]}; replicas bit-identical")
    return loss


def _spatial(n_devices: int, group) -> float:
    """The spatial step on a prepared batch as the JAX dry run gives it:
    photos at 0.5, flat normals, maps at 0.5."""
    dev = group.device
    model = build_model("single", depth=DEPTH, num_filters=FILTERS,
                        device=dev, seed=1)
    optimizer = step_lib.make_optimizer(model.parameters(), 1e-5)
    generator = torch.Generator(device=dev).manual_seed(2)
    step = spatial.SpatialTrainStep(
        model, optimizer, spatial.make_spatial_loss_fn("mixed", group),
        step_lib.PrepConfig(), generator, group)
    batch = {"inputs": torch.full((2, 1, SIZE, SIZE, 3), 0.5, device=dev),
             "svbrdf": torch.cat([
                 torch.zeros((2, SIZE, SIZE, 2), device=dev),
                 torch.ones((2, SIZE, SIZE, 1), device=dev),
                 torch.full((2, SIZE, SIZE, 9), 0.5, device=dev)], dim=-1)}
    scenes = sampling.generate_loss_scenes(2, 1, 2, generator=generator,
                                           device=dev)
    loss = float(step.update(batch, scenes=scenes))
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite spatial dry-run loss: {loss}")
    if len(set(mesh.replica_checksums(model.parameters(), group))) != 1:
        raise RuntimeError("spatial dry run: replicas differ")
    print(f"dryrun_multichip({n_devices}): spatial (H split over "
          f"{group.world} ranks, fused rendering loss at each shard's row "
          f"offset) train step OK, loss={loss:.4f}; replicas "
          f"bit-identical")
    return loss


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Multi-device dry run: the "
                                "data-parallel and spatial steps")
    p.add_argument("n_devices", type=int, nargs="?", default=2)
    p.add_argument("--cpu", action="store_true",
                   help="run the ranks on the CPU (gloo); default one card "
                        "a rank (NCCL)")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    run(args.n_devices, "cpu" if args.cpu else "cuda")


if __name__ == "__main__":
    main()
