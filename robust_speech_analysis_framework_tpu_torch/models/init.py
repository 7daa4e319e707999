"""Seeded random initialisation of the port's modules.

Weights are drawn on the CPU from an explicit ``torch.Generator`` and then
moved, so a seed gives the same model on every device.

* :func:`init_weights_`: a uniform init for serving and tests (any module).
* :func:`init_training_weights_`: the JAX package's initialisers for the
  CNN-LSTM, so a run trained from scratch starts from the same
  distributions as a JAX run (the values differ: the RNGs do).
"""

from __future__ import annotations

import math

import torch
from torch import nn


def init_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init of every parameter, drawn on the CPU.

    Matrices and conv kernels: uniform ±1/sqrt(fan_in) (torch's Linear/Conv
    default bound, and nn.LSTM's ±1/sqrt(H) for the recurrent weights);
    vectors named like norm scales (and WavLM's gate constants) get ones,
    other vectors (biases) uniform with the fan-in of their layer, LSTM
    biases ±1/sqrt(H). BatchNorm running
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
    # WavLM's per-head gate constants start at one, as transformers starts them
    return (isinstance(owner, norm_types) and leaf == "weight") or leaf in (
        "gn_scale", "gru_rel_pos_const")


# flax's variance_scaling "truncated_normal": the stddev of a unit normal
# truncated to (-2, 2), by which lecun_normal divides its scale
_TRUNC_NORMAL_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    fan_in = math.prod(w.shape[1:])  # conv (out, in, k) and dense (out, in)
    std = math.sqrt(1.0 / fan_in) / _TRUNC_NORMAL_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def init_training_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX ``CNNLSTM``'s initialisers, drawn on the CPU from ``generator``.

    Conv and dense kernels ``lecun_normal`` (flax's default) with zero
    biases; LSTM input weights ``xavier_uniform``, recurrent weights
    ``orthogonal``, biases zero (both ``bias_ih`` and ``bias_hh``: the JAX
    cell has one bias); BatchNorm scale 1, bias 0, running mean 0 and
    variance 1. Transposed shapes have the same fans, so the distributions
    are the JAX package's.
    """
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Conv1d, nn.Linear)):
                _lecun_normal_(module.weight, generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.BatchNorm1d):
                module.reset_parameters()
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.startswith("weight_ih"):
                nn.init.xavier_uniform_(p, generator=generator)
            elif leaf.startswith("weight_hh"):
                nn.init.orthogonal_(p, generator=generator)
            elif leaf.startswith(("bias_ih", "bias_hh")):
                p.zero_()
    return model
