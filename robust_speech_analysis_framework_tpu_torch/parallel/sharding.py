"""Sharding rules: which slice of each parameter, and of each batch, lives
on which device of a (dp, mp) grid.

Counterpart of ``robust_speech_analysis_framework_tpu/parallel/sharding.py``.
The JAX table maps Flax paths to ``PartitionSpec`` s and GSPMD derives the
collectives; here each rule maps a port parameter name (a ``state_dict``
key) to the dimension of the torch tensor that is split over ``mp``, and the
code that runs the split does its own gathers and sums. The meaning is the
JAX table's, in torch's layouts:

* LSTM ``weight_ih``/``weight_hh`` (4H, in): the gate dim;
* Wav2Vec2 ``q``/``k``/``v``/``ff1`` (out, in) and their biases:
  column-parallel (the output dim);
* ``out``/``ff2`` (out, in): row-parallel (the input dim), their partial
  products summed across the mp row;
* the feature encoder's convs and the 512→768 projection: their output dim;
* conv (out, in, k) and dense (out, in) weights of the CNN-LSTM, the
  positional conv and the heads: their output dim.

A parameter matched by no rule, or whose split dim does not divide by
``mp``, is replicated on every device.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from .mesh import DeviceGrid

# (regex over the port's parameter name, torch dim split over mp); the first
# rule that matches decides
DEFAULT_PARAM_RULES: Sequence[Tuple[str, int]] = (
    (r".*lstm\.weight_(ih|hh)_l\d+(_reverse)?$", 0),
    (r".*\.(q|k|v|ff1)\.weight$", 0),
    (r".*\.(q|k|v|ff1)\.bias$", 0),
    (r".*\.(out|ff2)\.weight$", 1),
    (r".*(conv_\d+|feature_projection\.projection)\.weight$", 0),
    (r".*(conv\d*|shortcut\.0|attention_weights|fc)\.weight$", 0),
)


def split_dim(name: str, shape: Sequence[int], mp: int,
              rules: Sequence[Tuple[str, int]] = DEFAULT_PARAM_RULES) -> Optional[int]:
    """The dim of parameter ``name`` split over ``mp`` devices, or None
    (replicated): the first matching rule's dim when its size divides by
    ``mp``. With ``mp`` = 1 nothing is split."""
    if mp <= 1:
        return None
    for pattern, dim in rules:
        if re.match(pattern, name):
            return dim if shape[dim] % mp == 0 else None
    return None


def shard_params(params: Mapping[str, torch.Tensor], mesh: DeviceGrid,
                 rules: Sequence[Tuple[str, int]] = DEFAULT_PARAM_RULES
                 ) -> Dict[str, Optional[int]]:
    """{name: split dim or None} for every tensor of ``params`` on ``mesh``'s
    mp axis (the JAX function's ``NamedSharding`` tree, as dims)."""
    return {name: split_dim(name, t.shape, mesh.mp, rules) for name, t in params.items()}


def param_slice(t: torch.Tensor, dim: Optional[int], c: int, mp: int) -> torch.Tensor:
    """The part of ``t`` that mp index ``c`` holds: chunk ``c`` of ``mp``
    along ``dim``, or the whole tensor when it is replicated."""
    if dim is None:
        return t
    return t.chunk(mp, dim)[c]


def place_params(params: Mapping[str, torch.Tensor], mesh: DeviceGrid,
                 rules: Sequence[Tuple[str, int]] = DEFAULT_PARAM_RULES
                 ) -> Dict[str, List[List[torch.Tensor]]]:
    """{name: [[the slice held at (r, c)] for each dp row r]}: every row holds
    the whole parameter, split over its mp devices or replicated on each.
    The slices are copies on their devices."""
    spec = shard_params(params, mesh, rules)
    out: Dict[str, List[List[torch.Tensor]]] = {}
    for name, t in params.items():
        t = t.detach()
        out[name] = [[param_slice(t, spec[name], c, mesh.mp).to(dev, copy=True).contiguous()
                      for c, dev in enumerate(row)] for row in mesh.rows]
    return out


def gather(row_slices: Sequence[torch.Tensor], dim: Optional[int],
           device: torch.device) -> torch.Tensor:
    """One mp row's slices of a parameter, whole on ``device`` (an
    all-gather; a replicated parameter takes the copy at mp index 0).
    Autograd sends each slice its part of the gradient."""
    if dim is None:
        return row_slices[0].to(device)
    return torch.cat([s.to(device) for s in row_slices], dim)


def batch_sharding(mesh: DeviceGrid, n: int) -> List[slice]:
    """Leading-axis dp split of a batch of ``n``: row r takes the r-th
    contiguous ``n / dp`` items. ``n`` must divide by dp, as a JAX batch
    sharded on dp must."""
    if n % mesh.dp:
        raise ValueError(f"batch of {n} not divisible by dp={mesh.dp}")
    per = n // mesh.dp
    return [slice(r * per, (r + 1) * per) for r in range(mesh.dp)]


def replicate(mesh: DeviceGrid, t: torch.Tensor) -> List[List[torch.Tensor]]:
    """``t`` on every device of the grid, as ``[[t at (r, c)]]``: one copy a
    distinct device, shared by the positions that repeat it."""
    copies: Dict[torch.device, torch.Tensor] = {}
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = t if t.device == dev else t.to(dev)
    return [[copies[dev] for dev in row] for row in mesh.rows]
