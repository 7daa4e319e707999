"""Candidate-level Viterbi: the hand-written CUDA kernels and their plain
PyTorch versions.

Counterpart of ``robust_speech_analysis_framework_tpu/ops/pallas/viterbi.py``.
Both pitch path finders (openSMILE's cPitchSmootherViterbi in
``ops/shs_pitch.py``, Praat's in the MSHDS extractor) share one recurrence
over per-frame candidate states, inputs lf (log2 frequency), v (> 0 where
the state is voiced) and local (cost), each (B, T, C) float32:

    c[0][j] = local[0][j]
    c[t][j] = min_i( c[t-1][i] + trans[i][j] ) + local[t][j]
    trans[i][j] = w_vv·|lf[t-1][i] − lf[t][j]|  both voiced
                  w_same                        same voicing
                  w_diff                        voicing changes

* :func:`viterbi_forward_costs` (K6): → c (B, T, C), one launch of
  ``csrc/viterbi.cu``'s cost kernel on CUDA: one block a file and direction,
  whose producer warps lay the transition costs out in shared memory ahead
  of the one warp that walks the T dependent steps.
* :func:`viterbi_path` (K7): the same recurrence on the time-flipped
  inputs gives e, and the state per frame is argmin_j c + (flip(e) − local),
  (B, T) int64. On CUDA: one launch of the cost kernel for both directions
  (counted as a K6 launch), then one of the argmin kernel.

The kernels equal their plain versions bit for bit (same operations in the
same order, no FMA contraction). Dispatch goes by the tensors' device: CPU
tensors take the plain version, CUDA tensors launch the kernel or raise.
There is no fallback between them. Each wrapper counts its kernel's
launches in ``.launches``.
"""

from __future__ import annotations

import torch

from ._build import call as _call

MAX_STATES = 32  # one lane of the chain's warp per state


def _transitions(lf, v, w_vv, w_same, w_diff) -> torch.Tensor:
    """trans (B, T−1, C, C): step t−1 → t, from state i (axis −2) to j."""
    voiced = v > 0
    both = voiced[:, :-1, :, None] & voiced[:, 1:, None, :]
    same = voiced[:, :-1, :, None] == voiced[:, 1:, None, :]
    jump = (lf[:, :-1, :, None] - lf[:, 1:, None, :]).abs()
    fixed = torch.where(same, torch.tensor(w_same, dtype=lf.dtype, device=lf.device),
                        torch.tensor(w_diff, dtype=lf.dtype, device=lf.device))
    return torch.where(both, w_vv * jump, fixed)


def viterbi_forward_costs_reference(lf, v, local, w_vv, w_same, w_diff) -> torch.Tensor:
    """Plain forward costs c (B, T, C): the transitions at once, then a
    Python loop over t for the min-plus recurrence."""
    trans = _transitions(lf, v, w_vv, w_same, w_diff)
    out = torch.empty_like(local)
    cost = local[:, 0]
    out[:, 0] = cost
    for t in range(1, local.shape[1]):
        cost = (cost[:, :, None] + trans[:, t - 1]).amin(dim=1) + local[:, t]
        out[:, t] = cost
    return out


def _path_from_costs(c: torch.Tensor, e_flipped: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """argmin_j c + (flip(e) − local): the first minimum, as the kernel."""
    return (c + (e_flipped - local)).argmin(dim=-1)


def viterbi_path_reference(lf, v, local, w_vv, w_same, w_diff) -> torch.Tensor:
    """Plain globally-optimal state per frame, (B, T) int64."""
    c = viterbi_forward_costs_reference(lf, v, local, w_vv, w_same, w_diff)
    e = viterbi_forward_costs_reference(lf.flip(1), v.flip(1), local.flip(1),
                                        w_vv, w_same, w_diff)
    return _path_from_costs(c, e.flip(1), local)


def _check(lf, v, local) -> None:
    if lf.ndim != 3 or lf.shape != v.shape or lf.shape != local.shape:
        raise ValueError(f"expected three (B, T, C) tensors, got {tuple(lf.shape)}, "
                         f"{tuple(v.shape)}, {tuple(local.shape)}")
    if not (lf.device == v.device == local.device):
        raise ValueError(f"inputs on {lf.device}, {v.device}, {local.device}")
    if not (lf.dtype == v.dtype == local.dtype == torch.float32):
        raise TypeError(f"expected float32, got {lf.dtype}, {v.dtype}, {local.dtype}")
    b, t, c = lf.shape
    if t < 1 or not 1 <= c <= MAX_STATES:
        raise ValueError(f"the Viterbi kernels take T >= 1 and 1 <= C <= {MAX_STATES}, "
                         f"got T={t}, C={c}")


def _unsupported(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")


def _launch_costs(lf, v, local, w_vv, w_same, w_diff, ndir: int) -> torch.Tensor:
    """One launch of the cost kernel on CUDA tensors: (ndir, B, T, C), the
    forward costs and, with ndir = 2, flip(e) of the time-flipped inputs."""
    b, t, c = lf.shape
    lf, v, local = lf.contiguous(), v.contiguous(), local.contiguous()
    out = torch.empty((ndir, b, t, c), device=lf.device, dtype=torch.float32)
    if out.numel():
        _call("viterbi", "viterbi_costs_f32", lf.device, lf, v, local, out, b, t, c, ndir,
              float(w_vv), float(w_same), float(w_diff))
        viterbi_forward_costs.launches += 1
    return out


def viterbi_forward_costs(lf, v, local, w_vv, w_same, w_diff) -> torch.Tensor:
    """K6: forward costs c (B, T, C) for (B, T, C) candidate stacks; the
    weights are Python floats."""
    _check(lf, v, local)
    if lf.device.type == "cpu":
        return viterbi_forward_costs_reference(lf, v, local, w_vv, w_same, w_diff)
    _unsupported(lf)
    return _launch_costs(lf, v, local, w_vv, w_same, w_diff, ndir=1)[0]


def viterbi_path(lf, v, local, w_vv, w_same, w_diff) -> torch.Tensor:
    """K7: the globally-optimal state per frame, (B, T) int64."""
    _check(lf, v, local)
    if lf.device.type == "cpu":
        return viterbi_path_reference(lf, v, local, w_vv, w_same, w_diff)
    _unsupported(lf)
    b, t, c = lf.shape
    costs = _launch_costs(lf, v, local, w_vv, w_same, w_diff, ndir=2)
    path = torch.empty((b, t), device=lf.device, dtype=torch.int64)
    if path.numel():
        _call("viterbi", "viterbi_argmin_f32", lf.device, costs, local.contiguous(), path,
              b, t, c)
        viterbi_path.launches += 1
    return path


viterbi_forward_costs.launches = 0
viterbi_path.launches = 0
