"""Multi-device dry run: the data-parallel training step over n ranks.

Counterpart of svbrdf_tpu/parallel/dryrun.py. It checks the data-parallel
program (each rank's rows of the batch, replicated weights, the gradient
all-reduce) at a tiny size, in n ranks started for it: one card a rank over
NCCL (`python -m svbrdf_tpu_torch.parallel.dryrun 2`; fewer cards than
ranks raises), or on the CPU over gloo when the caller asks (`--cpu`).

The JAX dry run's three programs, here:
  1. the single-step batch-DP program: ported (prepare, forward, mixed
     loss, backward, gradient all-reduce, Adam), with the group's size
     asserted so that a smaller group cannot pass for an n-way run;
  2. the K-step lax.scan program (--device-data-cache): not ported on
     purpose (ROADMAP "Not ported": the chunk programs; the port
     dispatches each step), so K plain data-parallel steps take its place;
  3. the H-sharded spatial step (run_spatial): ROADMAP Queue 1 item 15, not
     ported yet; run_spatial raises and run does not call it.
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import Optional

import torch.multiprocessing as mp

from svbrdf_tpu_torch.parallel import mesh
from svbrdf_tpu_torch.utils import bench_setup

DEPTH, FILTERS, SIZE = 5, 8, 32
K_STEPS = 3


def run(n_devices: int, device_type: str = "cuda",
        timeout: Optional[float] = None) -> float:
    """The data-parallel programs at depth 5, 32^2, 8 filters and a global
    batch of max(n, 2), in n ranks started for them (mesh.spawn, `timeout`
    seconds at most), rank r on cuda:r (NCCL), or on the CPU (gloo) with
    device_type 'cpu': the single-step program, then K_STEPS more steps,
    the replicas then held bit-identical. Returns the first step's loss
    (the group's mean)."""
    mesh.make_mesh(n_devices, device_type)
    results = mp.get_context("spawn").SimpleQueue()
    mesh.spawn(_rank, n_devices,
               (n_devices, f"tcp://localhost:{mesh.free_port()}",
                device_type, results), timeout)
    return results.get()


def _rank(rank: int, n_devices: int, address: str, device_type: str,
          results) -> None:
    device = "cpu" if device_type == "cpu" else f"cuda:{rank}"
    group = mesh.init_group(n_devices, rank, device, address)
    loss = _programs(n_devices, group)
    if group.is_main:
        results.put(loss)
    mesh.destroy_group()


def _programs(n_devices: int, group) -> float:
    # A pass on fewer ranks than requested proves nothing.
    if group.world != n_devices:
        raise RuntimeError(f"the group has {group.world} ranks, expected "
                           f"{n_devices}")
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


def run_spatial(n_devices: int) -> float:
    """The H-sharded (--shard-spatial) train step: not ported yet."""
    raise NotImplementedError(
        "the spatially sharded train step is not ported yet: ROADMAP Queue "
        "1 item 15 (spatial H-sharding)")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Data-parallel dry run")
    p.add_argument("n_devices", type=int, nargs="?", default=2)
    p.add_argument("--cpu", action="store_true",
                   help="run the ranks on the CPU (gloo); default one card "
                        "a rank (NCCL)")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    run(args.n_devices, "cpu" if args.cpu else "cuda")


if __name__ == "__main__":
    main()
