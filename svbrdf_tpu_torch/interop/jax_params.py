"""Carry weights from the JAX package's Flax parameter trees into the port.

`params_from_jax` takes the Flax param tree as nested mappings of numpy
arrays and returns a state_dict that SingleViewModel's or MultiViewModel's
load_state_dict(..., strict=True) accepts. The port's modules carry the PyTorch reference's key
names, so the same state_dict layout also loads reference checkpoints.

The key translation and layout transposes are a copy of
svbrdf_tpu/interop/torch_port.py (_torch_key, export_torch_state_dict): the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_key(path) -> str:
    """Translate a Flax param path to the reference state_dict key."""
    parts = [str(p) for p in path]
    leaf = parts.pop()
    segs = []
    i = 0
    while i < len(parts):
        s = parts[i]
        nxt = parts[i + 1] if i + 1 < len(parts) else None
        if re.fullmatch(r"enc\d", s) or re.fullmatch(r"conv\d", s):
            # EncodingLayer / ConvFeatureLayer wrap a layer called `conv`.
            if nxt == "conv":
                segs += [s, "conv", "conv"]
                i += 2
            elif nxt == "norm":
                segs += [s, "conv", "norm"]
                i += 2
            elif nxt == "merge":
                segs += [s, "conv", "merge", "fully_connected"]
                i += 3  # skip 'merge', 'fc'
            else:
                segs.append(s)
                i += 1
        elif re.fullmatch(r"dec\d", s):
            # DecodingLayer wraps `deconv` whose conv is a Sequential:
            # [upsample, pad, conv, pad, conv].
            if nxt == "conv1":
                segs += [s, "deconv", "conv", "2"]
                i += 2
            elif nxt == "conv2":
                segs += [s, "deconv", "conv", "4"]
                i += 2
            elif nxt == "norm":
                segs += [s, "deconv", "norm"]
                i += 2
            elif nxt == "merge":
                segs += [s, "deconv", "merge", "fully_connected"]
                i += 3
            else:
                segs.append(s)
                i += 1
        elif re.fullmatch(r"gte\d|gtd\d|gt\d", s):
            segs += [s, "fully_connected"]
            i += 2  # skip 'fc'
        elif s == "merge" and nxt == "fc":
            segs += ["merge", "fully_connected"]
            i += 2
        else:
            segs.append(s)
            i += 1
    suffix = {"kernel": "weight", "scale": "weight", "bias": "bias"}[leaf]
    return ".".join(segs + [suffix])


def params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params (nested mappings of arrays) -> reference-layout
    state_dict of f32 CPU tensors.

    Conv kernels go HWIO -> OIHW and Dense kernels (I, O) -> (O, I). The
    first encoder block's merge weight, which Flax never creates (no global
    track reaches it) but the reference model holds, is filled with zeros:
    the forward never reads it.
    """
    out = {}
    for path, val in _flatten(params):
        w = np.asarray(val, dtype=np.float32)
        if path[-1] == "kernel" and w.ndim == 4:
            w = w.transpose(3, 2, 0, 1)
        elif path[-1] == "kernel" and w.ndim == 2:
            w = w.T
        out[_torch_key(path)] = torch.tensor(w)  # a copy: inputs may be read-only
    for key in list(out):
        m = re.fullmatch(r"(.*\.)?enc1\.conv\.conv\.weight", key)
        if m:
            merge_key = ((m.group(1) or "")
                         + "enc1.conv.merge.fully_connected.weight")
            if merge_key not in out:
                c = out[key].shape[0]
                out[merge_key] = torch.zeros((c, c), dtype=torch.float32)
    return out
