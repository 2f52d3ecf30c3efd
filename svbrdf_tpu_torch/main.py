"""Entry point: `python -m svbrdf_tpu_torch.main --mode train ...`.

Counterpart of svbrdf_tpu/main.py: parse the arguments, then train (and
afterwards test on the validation split) or test. The run uses cuda:N for
--gpu-id N >= 0 (the default, 0), raising when there is no CUDA device,
and the CPU for --gpu-id < 0.

Training takes loop.training_world ranks: --num-devices (0: every visible
card) cut to the largest divisor of the batch size. More than one starts
that many local ranks from this command (processes from a `spawn` context,
a rendezvous on a free localhost port): rank r trains on cuda:r over NCCL,
or under --gpu-id -1 on the CPU over gloo, and each reads the whole corpus
and keeps its rows of each global batch (parallel/mesh). A rank that fails
fails the command. Under the launcher (parallel/multihost) the process
group exists already and main runs this process's rank.

With --shard-spatial N training takes N ranks started the same way, which
split the image height (training/spatial_loop); the test pass after it
runs on rank 0 with the unsharded model, as the JAX CLI's does.
"""

from __future__ import annotations

import sys

from svbrdf_tpu_torch.cli import parse_args
from svbrdf_tpu_torch.device import resolve_device
from svbrdf_tpu_torch.parallel import mesh
from svbrdf_tpu_torch.training import loop


def main(argv=None, group=None):
    """Run the CLI as one process, or as rank `group.rank` of a data group
    (parallel/mesh.DataGroup); returns run_training's TrainingRun in train
    mode (None where this command spawned the ranks) and run_test's grid
    paths in test mode."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if group is None:
        device = resolve_device("cpu" if args.gpu_id < 0
                                else f"cuda:{args.gpu_id}")
        if args.mode == "train":
            world = loop.training_world(args, device)
            if world > 1:
                _spawn_ranks(world, argv, device.type, args.gpu_id)
                return None
    else:
        device = group.device
    if args.mode == "train":
        result = loop.run_training(args, device, group)
        # Then visualize the validation split. Test mode makes setup() load
        # the checkpoint just saved (train + retrain would skip it), and the
        # torch-import flag is cleared so that the trained weights, not the
        # imported ones, are shown.
        args.mode = "test"
        args.retrain = False
        args.import_torch_checkpoint = None
        loop.run_test(args, device, validation_split_only=True, group=group)
    else:
        result = loop.run_test(args, device, group=group)
    # Exit together: a rank that left early would meet the others' next
    # collective, while rank 0 may still be writing grids.
    mesh.sync_hosts(group, "pre_exit", mesh.PRE_EXIT_TIMEOUT)
    return result


def _spawn_ranks(world: int, argv: list, device_type: str,
                 gpu_id: int) -> None:
    """Run main(argv) as `world` local ranks, rank r on cuda:r (or the
    CPU); returns when every rank has ended, raises when one failed."""
    if device_type == "cuda" and gpu_id != 0:
        raise ValueError(f"{world} ranks take cuda:0..{world - 1}; pick the "
                         f"cards with CUDA_VISIBLE_DEVICES, not --gpu-id "
                         f"{gpu_id}")
    address = f"tcp://localhost:{mesh.free_port()}"
    print(f"Starting {world} ranks ({device_type}), rendezvous {address}")
    mesh.spawn(_rank_main, world, (world, address, device_type, argv))


def _rank_main(rank: int, world: int, address: str, device_type: str,
               argv: list) -> None:
    device = "cpu" if device_type == "cpu" else f"cuda:{rank}"
    group = mesh.init_group(world, rank, device, address)
    main(argv, group)
    mesh.destroy_group()


if __name__ == "__main__":
    main()
