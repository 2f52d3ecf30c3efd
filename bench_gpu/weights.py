"""Seeded weights of a configuration, made on the device in one draw.

Both the program and the reference are loaded with these: N(0, 0.02)
conv kernels, N(0, 0.01 / sqrt(fan_in)) merges, N(0, 1 / sqrt(fan_in))
global-track weights with zero biases, unit norm scales and zero norm
biases (the method's initialization), in f32.
"""

from __future__ import annotations

import torch

from bench_gpu.reference.model import param_spec

_STD = {"conv": lambda fan_in: 0.02,
        "merge": lambda fan_in: 0.01 * fan_in ** -0.5,
        "track": lambda fan_in: fan_in ** -0.5}


def make(config: dict, seed: int, device) -> dict:
    """name -> f32 tensor on `device`, in leaf order."""
    spec = param_spec(config["model_type"], config["num_filters"],
                      config["model_depth"])
    drawn = [(name, shape, kind) for name, shape, kind in spec
             if kind in _STD]
    sizes = [torch.Size(shape).numel() for _, shape, _ in drawn]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape, kind), part in zip(drawn, flat.split(sizes)):
        fan_in = torch.Size(shape[1:]).numel()
        out[name] = part.view(shape).mul_(_STD[kind](fan_in))
    for name, shape, kind in spec:
        if kind == "one":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zero":
            out[name] = torch.zeros(shape, device=device)
    return {name: out[name] for name, _, _ in spec}


def as_masters(weights: dict, config: dict) -> dict:
    """The weights in the storage the configuration trains: under bf16
    compute with 'bf16sr' masters every >= 2-D tensor rounds to bf16."""
    if (config["dtype"] == "bfloat16"
            and config.get("master_dtype") == "bf16sr"):
        return {k: v.to(torch.bfloat16) if v.dim() >= 2 else v
                for k, v in weights.items()}
    return dict(weights)
