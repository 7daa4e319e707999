"""Contour smoothing, delta regression and statistical functionals.

The tail of the openSMILE DAG (Androids.conf): ``cContourSmoother``
(moving average, window 3 → ``_sma``), ``cDeltaRegression`` (deltawin 2 →
``_de``) and ``cFunctionals`` over the whole file with the Extremes,
Regression and Moments groups as configured (Androids.conf:349-368): 12
functionals per contour. Contours are (T, D); every function also takes a
leading batch axis, (B, T, D) with (B,) lengths for the masked variants.
"""

from __future__ import annotations

from typing import List, Union

import torch

from .prefix_sum import cumsum

FUNCTIONAL_NAMES: List[str] = [
    "max", "min", "range", "maxPos", "minPos", "amean",
    "linregc1", "linregc2", "linregerrQ",
    "stddev", "skewness", "kurtosis",
]

Length = Union[int, torch.Tensor]


def _window_sums(x: torch.Tensor, window: int) -> torch.Tensor:
    """Σ of x[t − half .. t + half] along axis −2, zeros outside, as the
    difference of prefix sums the JAX package takes (in its order of
    additions, see ``prefix_sum``)."""
    half = window // 2
    padded = torch.nn.functional.pad(x, (0, 0, half, half))
    csum = torch.nn.functional.pad(cumsum(padded, dim=-2), (0, 0, 1, 0))
    return csum[..., window:, :] - csum[..., :-window, :]


def smooth_sma(x: torch.Tensor, window: int = 3) -> torch.Tensor:
    """Symmetric moving average over time (cContourSmoother, window 3); the
    edges average over the samples there are."""
    t = x.shape[-2]
    if t == 0 or window <= 1:
        return x
    half = window // 2
    idx = torch.arange(t, device=x.device)
    counts = torch.clamp(idx + half + 1, max=t) - torch.clamp(idx - half, min=0)
    return _window_sums(x, window) / counts.to(x.dtype)[:, None]


def delta_regression(x: torch.Tensor, deltawin: int = 2) -> torch.Tensor:
    """HTK deltas (cDeltaRegression): d_t = Σ_{n=1..W} n·(x_{t+n} − x_{t−n})
    / (2·Σ n²), edges clamped."""
    t = x.shape[-2]
    if t == 0:
        return x
    return delta_regression_masked(x, t, deltawin)


def apply_functionals(x: torch.Tensor) -> torch.Tensor:
    """The 12 functionals per contour column: (..., T, D) → (..., 12, D),
    rows in FUNCTIONAL_NAMES order. maxPos/minPos are frame indices;
    linreg fits value against frame index, linregerrQ its mean squared
    error."""
    return apply_functionals_masked(x, x.shape[-2])


def _lengths(x: torch.Tensor, length: Length) -> torch.Tensor:
    """``length`` as a tensor broadcasting against (..., T, D) → (..., 1, 1)."""
    n = torch.as_tensor(length, device=x.device)
    return n.reshape(n.shape + (1, 1))


def smooth_sma_masked(x: torch.Tensor, length: Length, window: int = 3) -> torch.Tensor:
    """:func:`smooth_sma` of the first ``length`` rows of a padded (…, T, D)
    contour; rows ≥ length hold values the masked consumers never read."""
    t = x.shape[-2]
    half = window // 2
    n = _lengths(x, length)
    idx = torch.arange(t, device=x.device)[:, None]
    xm = x * (idx < n).to(x.dtype)
    counts = torch.clamp(torch.minimum(idx + half + 1, n) - torch.clamp(idx - half, min=0), min=1)
    return _window_sums(xm, window) / counts.to(x.dtype)


def delta_regression_masked(x: torch.Tensor, length: Length, deltawin: int = 2) -> torch.Tensor:
    """:func:`delta_regression` clamping at ``length − 1`` instead of the
    padded end."""
    t = x.shape[-2]
    denom = 2.0 * sum(n * n for n in range(1, deltawin + 1))
    hi = torch.clamp(_lengths(x, length) - 1, min=0)
    idx = torch.arange(t, device=x.device)[:, None]
    out = torch.zeros_like(x)
    for n in range(1, deltawin + 1):
        plus = torch.minimum(torch.clamp(idx + n, min=0), hi).expand(x.shape)
        minus = torch.minimum(torch.clamp(idx - n, min=0), hi).expand(x.shape)
        out = out + n * (torch.gather(x, -2, plus) - torch.gather(x, -2, minus))
    return out / denom


def apply_functionals_masked(x: torch.Tensor, length: Length) -> torch.Tensor:
    """:func:`apply_functionals` over rows [0, length) of (…, T, D)."""
    t = x.shape[-2]
    n_int = _lengths(x, length)
    idx = torch.arange(t, device=x.device)[:, None]
    valid = idx < n_int
    mask = valid.to(x.dtype)
    n = torch.clamp(n_int, min=1).to(x.dtype)

    x_for_max = torch.where(valid, x, float("-inf"))
    x_for_min = torch.where(valid, x, float("inf"))
    mx, max_pos = x_for_max.amax(-2), torch.argmax(x_for_max, dim=-2)  # first maximum
    mn, min_pos = x_for_min.amin(-2), torch.argmin(x_for_min, dim=-2)

    mean = torch.sum(x * mask, dim=-2, keepdim=True) / n
    ti = idx.to(x.dtype)
    t_mean = (n - 1) / 2.0
    t_var = torch.sum(((ti - t_mean) ** 2) * mask, dim=-2, keepdim=True) / n
    cov = torch.sum((ti - t_mean) * (x - mean) * mask, dim=-2, keepdim=True) / n
    slope = cov / torch.clamp(t_var, min=1e-30)
    offset = mean - slope * t_mean
    resid = (x - (slope * ti + offset)) * mask
    err_q = torch.sum(resid * resid, dim=-2, keepdim=True) / n

    var = torch.sum(((x - mean) ** 2) * mask, dim=-2, keepdim=True) / n
    std = torch.sqrt(var)
    std_safe = torch.clamp(std, min=1e-6)
    degenerate = std < 1e-8
    zero = torch.zeros_like(std)
    skew = torch.where(
        degenerate, zero, torch.sum(((x - mean) ** 3) * mask, dim=-2, keepdim=True) / n / std_safe**3)
    kurt = torch.where(
        degenerate, zero, torch.sum(((x - mean) ** 4) * mask, dim=-2, keepdim=True) / n / std_safe**4)

    rows = [mx, mn, mx - mn, max_pos.to(x.dtype), min_pos.to(x.dtype)]
    rows += [r.squeeze(-2) for r in (mean, slope, offset, err_q, std, skew, kurt)]
    return torch.stack(rows, dim=-2)
