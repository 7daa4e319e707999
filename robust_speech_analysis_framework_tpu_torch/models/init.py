"""Seeded random initialisation of the port's modules.

Weights are drawn on the CPU from an explicit ``torch.Generator`` and then
moved, so a seed gives the same model on every device.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def init_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init of every parameter, drawn on the CPU.

    Matrices and conv kernels: uniform ±1/sqrt(fan_in) (torch's Linear/Conv
    default bound, and nn.LSTM's ±1/sqrt(H) for the recurrent weights);
    vectors named like norm scales get ones, other vectors (biases) uniform
    with the fan-in of their layer, LSTM biases ±1/sqrt(H). BatchNorm running
    statistics keep mean 0 and variance 1.
    """
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if p.ndim >= 2:
                fan_in = p.shape[1] * math.prod(p.shape[2:])
                if leaf.startswith("weight_hh"):
                    fan_in = p.shape[1]
                bound = 1.0 / math.sqrt(fan_in)
            elif leaf.startswith(("bias_ih", "bias_hh")):
                bound = 1.0 / math.sqrt(p.shape[0] // 4)
            elif _is_norm_scale(module, name):
                p.fill_(1.0)
                continue
            else:
                bound = 1.0 / math.sqrt(max(p.shape[0], 1))
            values = torch.rand(p.shape, generator=generator, dtype=torch.float32)
            p.copy_((values * 2.0 - 1.0) * bound)
    return module


def _is_norm_scale(root: nn.Module, name: str) -> bool:
    owner_name, _, leaf = name.rpartition(".")
    owner = root.get_submodule(owner_name) if owner_name else root
    norm_types = (nn.BatchNorm1d, nn.LayerNorm)
    return (isinstance(owner, norm_types) and leaf == "weight") or leaf == "gn_scale"
