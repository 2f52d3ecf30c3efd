"""Command-line interface of the port.

Counterpart of svbrdf_tpu/cli.py: the same flags, names, defaults and
choices, and the same cross-flag checks. Flags that only pick a TPU
mechanism are accepted and have no effect here (their help says so); none
is quietly replaced by something else.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="SVBRDF estimation from images (PyTorch / CUDA port)")

    p.add_argument("--mode", "-M", dest="mode", required=True,
                   choices=["train", "test"],
                   help="Mode in which the program is executed.")
    p.add_argument("--renderer", "-R", dest="renderer",
                   choices=["local", "pathtracing"], default="local",
                   help="Renderer used by the rendering loss: 'local' "
                        "(the in-network Cook-Torrance renderer, fused "
                        "loss kernels) or 'pathtracing' (the quad-light "
                        "path tracer, 16 forward / 8 backward samples, "
                        "unfused).")
    p.add_argument("--input-dir", "-i", dest="input_dir", required=True,
                   help="Directory containing the input data.")
    p.add_argument("--image-count", "-c", dest="image_count", required=True,
                   type=int,
                   help="Number of photographs per sample strip in the "
                        "dataset.")
    p.add_argument("--linear-input", dest="linear_input",
                   action="store_true", default=False,
                   help="Input images are already linear RGB.")
    p.add_argument("--no-svbrdf-input", dest="no_svbrdf_input",
                   action="store_true", default=False,
                   help="Samples contain no SVBRDF maps (photos only).")
    p.add_argument("--used-image-count", "-u", dest="used_image_count",
                   type=int, default=1,
                   help="Number of input images fed to the model; missing "
                        "ones are synthesized on the device.")
    p.add_argument("--image-size", "-s", dest="image_size", type=int,
                   default=256,
                   help="Model input/output resolution.")
    p.add_argument("--scale-mode", dest="scale_mode",
                   choices=["crop", "resize"], default="crop",
                   help="How larger samples are fit to --image-size.")
    p.add_argument("--use-coords", dest="use_coords", action="store_true",
                   default=False,
                   help="Append x/y coordinate channels to the input.")
    p.add_argument("--omit-optimizer-state-save",
                   dest="omit_optimizer_state_save", action="store_true",
                   default=False,
                   help="Smaller checkpoints; resume quality suffers.")
    p.add_argument("--model-dir", "-m", dest="model_dir", required=True,
                   help="Directory for checkpoints and logs.")
    p.add_argument("--model-type", dest="model_type",
                   choices=["single", "multi", "diffusion"], default="single",
                   help="Single-view or multi-view model, or 'diffusion': "
                        "Ho et al.'s DDPM U-Net conditioned on the photo, "
                        "at its published widths (--model-depth and "
                        "--num-filters do not apply), trained on the "
                        "eps-MSE with a global-norm clip of 1 and an EMA "
                        "of 0.9999 "
                        "(Ho et al.'s rate is --learning-rate 2e-5), "
                        "predicting by 50 DDIM steps from the EMA.")
    p.add_argument("--gpu-id", "-g", dest="gpu_id", type=int, default=0,
                   help="CUDA device index (cuda:N); < 0 runs on the CPU.")
    p.add_argument("--save-frequency", dest="save_frequency", type=int,
                   choices=range(1, 1000), default=50, metavar="[1-999]",
                   help="Epochs between checkpoints.")
    p.add_argument("--validation-frequency", dest="validation_frequency",
                   type=int, choices=range(1, 1000), default=25,
                   metavar="[1-999]",
                   help="Epochs between validation passes.")
    p.add_argument("--epochs", "-e", dest="epochs", type=int, default=100,
                   help="Train up to this epoch.")
    p.add_argument("--retrain", dest="retrain", action="store_true",
                   default=False,
                   help="Ignore any checkpoint in the model directory.")

    p.add_argument("--loss", dest="loss", choices=["mixed", "l1", "render"],
                   default="mixed", help="Training objective.")
    p.add_argument("--fused-loss", dest="fused_loss",
                   action=argparse.BooleanOptionalAction, default=None,
                   help="No effect in the port: on the card the mixed and "
                        "rendering losses always run through its CUDA "
                        "kernels (their plain versions on the CPU).")
    p.add_argument("--batch-size", dest="batch_size", type=int, default=8,
                   help="Batch size.")
    p.add_argument("--learning-rate", dest="learning_rate", type=float,
                   default=1e-5, help="Adam learning rate.")
    p.add_argument("--dtype", dest="dtype",
                   choices=["auto", "float32", "bfloat16"], default="auto",
                   help="Model compute dtype (params stay float32 unless "
                        "--master-dtype bf16sr). 'auto' = bfloat16 on a "
                        "CUDA device, float32 on the CPU. float32 runs with "
                        "TF32 off.")
    p.add_argument("--master-dtype", dest="master_dtype",
                   choices=["auto", "f32", "bf16sr"], default="auto",
                   help="Master-parameter storage policy for bf16 models "
                        "(changes the trained artifact: 'bf16sr' stores "
                        ">=2-D leaves bf16, updated with stochastic "
                        "rounding; 'f32' keeps f32 masters). 'auto' = "
                        "SVBRDF_MASTER_DTYPE env var, default bf16sr "
                        "(parity evidence: docs/bf16_parity.md). Recorded "
                        "in the checkpoint and restored on resume.")
    p.add_argument("--upconv", dest="upconv",
                   choices=["auto", "dilated", "fold", "naive"],
                   default="auto",
                   help="No effect in the port: the JAX package's decoder "
                        "rewrites are TPU layouts of one computation, which "
                        "the port runs as upsample + pad + conv.")
    p.add_argument("--num-devices", dest="num_devices", type=int, default=0,
                   help="Devices to train on, data parallel (0 = every "
                        "visible card; the CPU is one device). N > 1 "
                        "starts N local ranks, rank r on cuda:r (NCCL), "
                        "or with --gpu-id -1 on the CPU (gloo); the batch "
                        "size splits over the largest divisor that fits. "
                        "More than the visible cards raises.")
    p.add_argument("--shard-spatial", dest="shard_spatial", type=int,
                   default=0,
                   help="Train with the image height split over N devices "
                        "(0 = off), for images whose activations outgrow "
                        "one card: N local ranks, rank r on cuda:r (NCCL), "
                        "or with --gpu-id -1 on the CPU (gloo); parameters "
                        "replicated, the batch not split, f32 masters. N "
                        "must divide --image-size; the local renderer and "
                        "--loss mixed|render only. Takes precedence over "
                        "--num-devices; more than the visible cards "
                        "raises.")
    p.add_argument("--device-data-cache", dest="device_data_cache",
                   action="store_true", default=False,
                   help="Decode the whole dataset once and keep it on the "
                        "device as uint8; every training batch is a gather "
                        "there (no per-step host assembly or copy). For "
                        "corpora that fit device memory. Requires "
                        "scale-mode=crop.")
    p.add_argument("--model-depth", dest="model_depth", type=int, default=8,
                   help="U-Net depth (8 = reference architecture; inputs "
                        "must be at least 2^depth pixels).")
    p.add_argument("--num-filters", dest="num_filters", type=int, default=64,
                   help="Base filter count ('ngf'); 64 = reference.")
    p.add_argument("--steps-per-call", dest="steps_per_call", type=int,
                   default=0,
                   help="No effect in the port beyond its check: the JAX "
                        "package runs N steps per TPU dispatch with losses "
                        "identical to 1; the port dispatches each step. "
                        "N > 1 requires --device-data-cache.")
    p.add_argument("--log-every", dest="log_every", type=int, default=1,
                   help="Fetch and log the training loss every N steps. "
                        "Each fetch waits for the device; the NaN guard "
                        "checks the fetched losses.")
    p.add_argument("--seed", dest="seed", type=int, default=313,
                   help="Base seed of the weights, the host RNG and the "
                        "per-step random streams.")
    p.add_argument("--profile-dir", dest="profile_dir", default=None,
                   help="If set, write a torch.profiler Chrome trace of "
                        "training steps 2-4 here (trace.json). Its host "
                        "ranges name the step's phases (step.prepare, "
                        "step.forward, step.loss, step.backward, "
                        "step.optimizer) and the data layer's work "
                        "(data.raw_batch; data.decode, one a cache miss).")
    p.add_argument("--import-torch-checkpoint",
                   dest="import_torch_checkpoint", default=None,
                   help="Path to a PyTorch reference checkpoint "
                        "(checkpoint.tar, legacy model.data, or a "
                        "directory holding one) to start from instead of "
                        "--model-dir's.")
    p.add_argument("--export-torch-checkpoint",
                   dest="export_torch_checkpoint", default=None,
                   help="Write the restored model as a PyTorch reference "
                        "checkpoint.tar at this path (test mode).")
    return p


def parse_args(argv=None):
    args = build_parser().parse_args(argv)

    if args.no_svbrdf_input:
        if args.mode == "train":
            raise RuntimeError(
                "Cannot train on samples without SVBRDF maps.")
        if args.image_count == 0:
            raise RuntimeError(
                "No SVBRDF and no image input. What are we supposed to do?")
    return args
