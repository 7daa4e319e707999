"""Inclusive prefix sums in one fixed order of float32 additions.

The JAX package's moving averages, peak enhancement and spectral roll-off
difference or threshold a cumulative sum, and on the CPU XLA computes it
blocked: blocks of 16 summed left to right, the block totals prefix-summed
the same way, each block's elements offset by the total before it. Two
sums of different order round differently, and a contour with exact ties
(zero-crossing counts, gated F0) then takes its maxPos/minPos at another
frame. This module computes that order with elementwise additions only, so
the port agrees with the JAX package, and the card with the CPU, bit for
bit on equal inputs (``torch.cumsum`` accumulates in float64 on the CPU and
in a parallel order on the card).
"""

from __future__ import annotations

import torch

_BLOCK = 16


def _sequential(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right prefix sums along the last axis (at most _BLOCK long)."""
    cols = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., i])
    return torch.stack(cols, dim=-1)


def _blocked(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    if n <= _BLOCK:
        return _sequential(x)
    m = -(-n // _BLOCK)
    blocks = torch.nn.functional.pad(x, (0, m * _BLOCK - n)).reshape(*x.shape[:-1], m, _BLOCK)
    inner = _sequential(blocks)
    before = torch.nn.functional.pad(_blocked(inner[..., -1])[..., :-1], (1, 0))
    return (inner + before[..., None]).reshape(*x.shape[:-1], m * _BLOCK)[..., :n]


def cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inclusive prefix sum of ``x`` along ``dim`` in the blocked order."""
    if x.shape[dim] == 0:
        return x.clone()
    return _blocked(x.movedim(dim, -1)).movedim(-1, dim)
