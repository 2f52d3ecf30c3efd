"""Entry point: `python -m svbrdf_tpu_torch.main --mode train ...`.

Counterpart of svbrdf_tpu/main.py: parse the arguments, then train (and
afterwards test on the validation split) or test. The run uses cuda:N for
--gpu-id N >= 0 (the default, 0), raising when there is no CUDA device,
and the CPU for --gpu-id < 0.
"""

from __future__ import annotations

from svbrdf_tpu_torch.cli import parse_args
from svbrdf_tpu_torch.device import resolve_device
from svbrdf_tpu_torch.training import loop


def main(argv=None):
    """Run the CLI; returns run_training's TrainingRun in train mode and
    run_test's grid paths in test mode."""
    args = parse_args(argv)
    device = resolve_device("cpu" if args.gpu_id < 0
                            else f"cuda:{args.gpu_id}")
    if args.mode == "train":
        result = loop.run_training(args, device)
        # Then visualize the validation split. Test mode makes setup() load
        # the checkpoint just saved (train + retrain would skip it), and the
        # torch-import flag is cleared so that the trained weights, not the
        # imported ones, are shown.
        args.mode = "test"
        args.retrain = False
        args.import_torch_checkpoint = None
        loop.run_test(args, device, validation_split_only=True)
        return result
    return loop.run_test(args, device)


if __name__ == "__main__":
    main()
