"""Multi-process data-parallel training launcher: one process per rank.

Counterpart of svbrdf_tpu/parallel/multihost.py. It joins the process
group, then runs the normal CLI (svbrdf_tpu_torch.main) as this process's
rank. The training loop sees a group of `--num-processes` processes and
switches to per-process file shards (data/dataset.shard_files_for_host,
seed * 1000 + process index), per-process rows of each global batch,
rank-0-only checkpoint and TensorBoard writes, and per-process validation
with the sums reduced over the group.

Launch one process per card (on each host, each with the card it drives
as its --gpu-id; NCCL), or per CPU rank with --gpu-id -1 (gloo):

    python -m svbrdf_tpu_torch.parallel.multihost \\
        --coordinator host0:29500 --num-processes 2 --process-id $i -- \\
        --mode train --input-dir ... --image-count 10 --model-dir ... \\
        --gpu-id $i

The group is made even for one process (no --coordinator needed then: a
free localhost port), so `--num-processes 1` drives the data-parallel step
on one card. A failed initialization, or a rank that fails, raises and the
process exits non-zero.

--virtual-cpu-devices N: JAX forces N virtual CPU devices per process; a
port process drives one device, so N <= 1 is accepted (and changes
nothing) and N > 1 raises.
"""

from __future__ import annotations

import argparse
import sys

from svbrdf_tpu_torch.cli import parse_args
from svbrdf_tpu_torch.device import resolve_device
from svbrdf_tpu_torch.main import main as cli_main
from svbrdf_tpu_torch.parallel import mesh


def main(argv=None):
    """Join the group and run the CLI; returns what the CLI's main
    returns."""
    p = argparse.ArgumentParser(
        description="Multi-process data-parallel launcher",
        epilog="Arguments after `--` go to svbrdf_tpu_torch.main.")
    p.add_argument("--coordinator", default=None,
                   help="rendezvous address host:port (rank 0's host); "
                        "optional for one process")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--virtual-cpu-devices", type=int, default=0,
                   help="accepted for the JAX launcher's flag: a process "
                        "of the port drives one device, so N > 1 raises")
    args, rest = p.parse_known_args(sys.argv[1:] if argv is None else argv)
    if rest and rest[0] == "--":
        rest = rest[1:]
    if args.virtual_cpu_devices > 1:
        raise ValueError(f"--virtual-cpu-devices {args.virtual_cpu_devices}: "
                         f"a process of the port drives one device; start "
                         f"one process per rank instead")
    if not 0 <= args.process_id < args.num_processes:
        raise ValueError(f"--process-id {args.process_id} is not one of "
                         f"{args.num_processes} processes")
    if args.coordinator is None:
        if args.num_processes > 1:
            raise ValueError("--coordinator host:port is needed with more "
                             "than one process")
        args.coordinator = f"localhost:{mesh.free_port()}"

    cli_args = parse_args(rest)
    device = resolve_device("cpu" if cli_args.gpu_id < 0
                            else f"cuda:{cli_args.gpu_id}")
    group = mesh.init_group(args.num_processes, args.process_id, device,
                            f"tcp://{args.coordinator}",
                            process_count=args.num_processes)
    print(f"process {group.rank}/{group.world}: 1 local / {group.world} "
          f"global devices ({group.backend}, {group.device})")
    result = cli_main(rest, group)
    mesh.destroy_group()
    return result


if __name__ == "__main__":
    main()
