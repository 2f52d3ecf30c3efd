"""Checkpoint persistence with the reference's restore semantics and its
on-disk format.

Counterpart of svbrdf_tpu/training/checkpoint.py. One file,
<model_dir>/checkpoint.tar, written with torch.save: the PyTorch reference's
dict {model_type, use_coords, epoch, model_state_dict[,
optimizer_state_dict]} plus model_depth, num_filters, the master-dtype
policy the run trained with (master_dtype), from a spatial run the
decoder form the JAX package records (upconv 'fold'), and of a diffusion
model its widths (sizes) and the f32 EMA of its weights
(ema_state_dict). The weights are written in f32
whatever their storage dtype (bf16 masters upcast exactly), as the JAX
package's exporter writes them and its reader (.numpy()) needs them. The
model's state_dict keys are the reference's, so the JAX package's
Checkpoint.load picks the file up from a model directory and ports the
weights. The restored architecture arguments override the CLI; loading is
optional (a missing checkpoint is an error only in test mode). A legacy
bare `model.data` state dict, with an optional `state.json` holding the
epoch, is read too. In data-parallel training rank 0 writes the file and
the other ranks wait for it at a barrier; every rank restores.

Restoring across precisions: the weights load into an f32 model, which the
trainer then casts to its master dtypes (parallel/step.master_cast); Adam's
moments are cast to the dtypes of the optimizer in force (torch.optim.Adam
casts them to its parameters', parallel/optimizer.AdamBf16SR to its
state precision's), so a checkpoint of either optimizer resumes under the
other.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Dict, Optional

import torch

from svbrdf_tpu_torch.parallel import mesh

CHECKPOINT_FILE = "checkpoint.tar"
LEGACY_FILE = "model.data"
_META_KEYS = ("model_type", "use_coords", "epoch", "model_depth",
              "num_filters", "master_dtype", "upconv", "sizes")


class Checkpoint:
    """An in-memory view of a loaded checkpoint (or an invalid one)."""

    def __init__(self, model_state: Optional[Dict] = None,
                 meta: Optional[Dict] = None,
                 optimizer_state: Optional[Dict] = None,
                 ema_state: Optional[Dict] = None):
        self._model_state = model_state
        self._meta = meta or {}
        self._optimizer_state = optimizer_state
        self._ema_state = ema_state

    # -- loading --------------------------------------------------------
    @classmethod
    def load(cls, path) -> "Checkpoint":
        """Load from a model directory (its checkpoint.tar, else a legacy
        model.data) or from a checkpoint file; an invalid Checkpoint when
        there is none. A directory holding only the JAX package's Orbax
        state raises: export it with the JAX CLI first."""
        p = pathlib.Path(path)
        if p.is_dir():
            if (p / CHECKPOINT_FILE).exists():
                p = p / CHECKPOINT_FILE
            elif (p / LEGACY_FILE).exists():
                p = p / LEGACY_FILE
            elif (p / "state").exists():
                raise ValueError(
                    f"'{path}' holds a JAX (Orbax) checkpoint, which the "
                    f"port does not read; write it as a checkpoint.tar with "
                    f"the JAX CLI: python -m svbrdf_tpu.main --mode test "
                    f"--model-dir {path} --export-torch-checkpoint "
                    f"{p / CHECKPOINT_FILE} ...")
            else:
                print(f"No checkpoint found in directory '{path}'")
                return cls(None)
        elif not p.exists():
            print(f"No checkpoint found at '{path}'")
            return cls(None)

        blob = torch.load(p, map_location="cpu", weights_only=True)
        meta: Dict[str, Any] = {}
        ema_state = None
        if isinstance(blob, dict) and "model_state_dict" in blob:
            meta = {k: blob[k] for k in _META_KEYS if k in blob}
            model_state = blob["model_state_dict"]
            optimizer_state = blob.get("optimizer_state_dict")
            ema_state = blob.get("ema_state_dict")
        else:  # legacy: the file is the state dict
            model_state, optimizer_state = blob, None
            sidecar = p.parent / "state.json"
            if sidecar.exists():
                meta["epoch"] = json.loads(sidecar.read_text())["epoch"]
                print("Loaded legacy training state")
            print("Loaded legacy model state")
        print(f"Loaded checkpoint '{p}'")
        return cls(model_state, meta, optimizer_state, ema_state)

    # -- saving ---------------------------------------------------------
    @staticmethod
    def save(model_dir, model, optimizer, epoch: int, model_type: str,
             use_coords: bool, omit_optimizer_state: bool = False,
             model_depth: int = 8, num_filters: int = 64,
             master_dtype: Optional[str] = None,
             group=None, upconv: Optional[str] = None,
             sizes: Optional[Dict] = None,
             ema: Optional[Dict] = None) -> pathlib.Path:
        """Write <model_dir>/checkpoint.tar, the weights in f32; returns
        its path. With a group (parallel/mesh.DataGroup) rank 0 writes it
        and every rank returns once it is written. `upconv`, where given,
        is recorded as the JAX package records it (a spatial run's
        'fold'); `sizes` (a diffusion model's widths) and `ema` (its EMA
        by parameter name) where given."""
        d = pathlib.Path(model_dir)
        path = d / CHECKPOINT_FILE
        if group is not None and not group.is_main:
            mesh.sync_hosts(group, "checkpoint_saved")
            return path
        d.mkdir(parents=True, exist_ok=True)
        weights = {k: v.float() if v.is_floating_point() else v
                   for k, v in model.state_dict().items()}
        blob = {"model_type": model_type, "use_coords": bool(use_coords),
                "epoch": int(epoch), "model_state_dict": weights}
        if not omit_optimizer_state and optimizer is not None:
            blob["optimizer_state_dict"] = optimizer.state_dict()
        blob["model_depth"] = int(model_depth)
        blob["num_filters"] = int(num_filters)
        if master_dtype is not None:
            blob["master_dtype"] = master_dtype
        if upconv is not None:
            blob["upconv"] = upconv
        if sizes is not None:
            blob["sizes"] = dict(sizes)
        if ema is not None:
            blob["ema_state_dict"] = {k: v.float() for k, v in ema.items()}
        # Written beside and renamed, so a run killed mid-save keeps the
        # previous checkpoint.
        tmp = path.with_suffix(".tar.tmp")
        torch.save(blob, tmp)
        tmp.replace(path)
        mesh.sync_hosts(group, "checkpoint_saved")
        return path

    # -- queries / selective restore ------------------------------------
    def is_valid(self) -> bool:
        return self._model_state is not None

    def purge(self) -> None:
        """Drop the in-memory state."""
        self._model_state = None
        self._optimizer_state = None
        self._ema_state = None

    def restore_args(self, args):
        """Architecture arguments in the checkpoint override the CLI."""
        if "model_type" in self._meta:
            args.model_type = self._meta["model_type"]
            print(f"Restored model type '{args.model_type}'")
        if "use_coords" in self._meta:
            args.use_coords = self._meta["use_coords"]
            print(f"Restored use coords flag '{args.use_coords}'")
        for extra in ("model_depth", "num_filters"):
            if extra in self._meta:
                setattr(args, extra, self._meta[extra])
        if "sizes" in self._meta:
            args.diffusion_sizes = dict(self._meta["sizes"])
        # Unlike the architecture, an explicit CLI value beats the
        # checkpoint here (either policy restores from either); the
        # recorded value fills in a CLI value left at 'auto'. upconv is
        # recorded by the JAX package and picks a TPU layout, nothing in
        # the port.
        for knob in ("master_dtype", "upconv"):
            if (knob in self._meta
                    and getattr(args, knob, "auto") in ("auto", None)):
                setattr(args, knob, self._meta[knob])
                print(f"Restored {knob} '{self._meta[knob]}'")
        return args

    def restore_params(self, model) -> None:
        """Load the stored weights into `model`, strictly (each cast to the
        dtype of the parameter it fills)."""
        if self._model_state is None:
            print("Failed to restore model state")
            return
        model.load_state_dict(self._model_state, strict=True)
        print("Restored model state")

    def restore_opt_state(self, optimizer) -> None:
        """Load the stored Adam state into `optimizer` when there is one,
        its moments cast to the optimizer's dtypes."""
        if self._optimizer_state is None:
            print("Failed to restore optimizer state")
            return
        optimizer.load_state_dict(self._optimizer_state)
        print("Restored optimizer state")

    def ema_state(self) -> Optional[Dict]:
        """The stored EMA of a diffusion model's weights, or None."""
        return self._ema_state

    def restore_ema_params(self, model) -> None:
        """Load the stored EMA, where there is one, into `model`'s
        weights (a diffusion model predicts from its EMA)."""
        if self._ema_state is not None:
            model.load_state_dict(self._ema_state, strict=True)
            print("Restored EMA weights")

    def restore_epoch(self, epoch: int) -> int:
        if "epoch" in self._meta:
            print(f"Restored epoch {self._meta['epoch']}")
            return int(self._meta["epoch"])
        print("Failed to restore epoch")
        return epoch
