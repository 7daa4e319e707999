"""openSMILE's pitch-period march: the hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of the JAX package's ``_march_periods_device``
(``robust_speech_analysis_framework_tpu/ops/jitter.py:111-312``), a vmapped
``lax.while_loop``. Each row of a (B, N) float32 waveform stack marches
pitch periods through its voiced frames, guided by its (T,) frame F0
(0 = unvoiced), from sample 0 while ``pos < n − 16``, the lane unbroken and
fewer than ``p_max`` periods found:

* a voiced frame: the expected period ``t0 = sr / max(f0, f0_min)`` (float32)
  gives the lag band ``[max(int(t0·(1−srr)), 8), int(t0·(1+srr)) + 1]`` and
  the template length ``round(t0)``; the lag of the highest normalised
  correlation of the template with the window a lag on (the first on ties;
  0 where either energy is negligible against the window's) is the period;
  its row is (start, length, peak |x|, correlation); a band that runs past
  the file ends the lane;
* an unvoiced frame: the cursor jumps to the first half-hop grid point at or
  past the next voiced frame.

The lag scores are float64 sums over the float32 samples (the numpy
oracle's precision; the JAX march scores in float32 through DFT
correlations).

* :func:`march_periods`: → (starts, lengths int32 (B, P); amps, corrs
  float32 (B, P); counts int32 (B,)), rows past a lane's count zero. On
  CUDA: one launch of ``csrc/period_march.cu`` a call, one block a file,
  the whole loop on the card;
* :func:`march_periods_reference`: the same function as torch ops, the lanes
  in lockstep, one Python step a substep.

Dispatch goes by the tensors' device: CPU tensors take the plain version,
CUDA tensors launch the kernel or raise. ``march_periods.launches`` counts
the kernel's launches. :func:`march_plan` sizes the kernel's shared memory
(a waveform ring and its running sums of squares, the row queue) and raises
where a block cannot hold it; :func:`march_periods_profile` runs the kernel's profile
build, which adds up SM clocks by phase of a step (card only, no count).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ._build import call as _call

MarchArrays = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def march_geometry(sr: float, srr: float, f0_min: float) -> Tuple[int, int, int]:
    """(W0, HI, GW): the longest template, one past the longest lag band's
    end, and the window read at each voiced substep (template + band + 8),
    as the JAX march sizes them."""
    t0_max = sr / f0_min
    w0 = int(round(t0_max)) + 1
    hi = int(t0_max * (1 + srr)) + 2
    return w0, hi, hi + w0 + 8


# samples a refill copies; rows the compute warps may queue for the row warp
CHUNK, QUEUE = 1024, 64
# shared memory a block can have on the H100 (227 KB); the widest band the
# kernel searches (8 lags a thread of its 256)
SMEM_LIMIT, MAX_BAND = 232_448, 2048
# the profile build's slots: SM clocks of the march and of each phase of a
# step, then voiced steps · 2^32 + unvoiced steps
PHASES = ("f0 and decision", "window", "dots", "argmax", "row", "unvoiced")


@dataclasses.dataclass(frozen=True)
class MarchPlan:
    """The kernel's shared-memory plan: the window geometry of
    :func:`march_geometry`, a ring of ``ring`` samples refilled ``chunk`` at a
    time, ``queue`` rows in flight to the row warp, and the bytes a block
    needs (``period_march_smem_bytes``)."""

    w0: int
    hi: int
    gw: int
    ring: int
    chunk: int
    queue: int
    smem_bytes: int


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def march_smem_bytes(ring: int, chunk: int, queue: int) -> int:
    """Bytes of shared memory a block takes, as ``csrc/period_march.cu``
    counts them: the float64 ring and its running sums of squares, the
    chunks' totals, the 8 compute warps' slice sums (2 (32 · 8 + 32)
    doubles each), the two parities of the warps' argmax slots and of their
    winners' (corr, e), the row queue (32 B a row), two float32 staging
    chunks with a float of padding every 32, the unvoiced search's slots and
    the control words."""
    return (8 * (2 * ring + ring // chunk + 8 * 2 * (32 * 8 + 32)) + 2 * 8 * 16 + 2 * 8 * 16
            + 32 * queue + 4 * 2 * (chunk + chunk // 32) + 4 * (2 * 8 + 8))


def march_band_max(sr: float, srr: float, f0_min: float) -> int:
    """An upper bound on the lags of one band, hi − lo + 1, over every F0:
    the widest band is the lowest F0's, plus one for float32 rounding (the
    kernel's launch applies the same bound)."""
    _, hi, _ = march_geometry(sr, srr, f0_min)
    return hi - max(int(sr / f0_min * (1 - srr)), 8) + 2


def march_plan(sr: float, srr: float, f0_min: float, hop: int) -> MarchPlan:
    """The kernel's plan at these settings: a ring of the least power of two
    that holds a window and four chunks of lead; raises ``ValueError`` where
    a block cannot hold it or a band has more lags than the kernel takes
    (``hop`` is checked, as the kernel reads F0 a frame of ``hop`` samples)."""
    w0, hi, gw = march_geometry(sr, srr, f0_min)
    if int(hop) < 1:
        raise ValueError(f"the period march needs a hop of at least one sample, got {hop}")
    ring = _pow2(gw + 4 * CHUNK)
    smem = march_smem_bytes(ring, CHUNK, QUEUE)
    band = march_band_max(sr, srr, f0_min)
    if band > MAX_BAND:
        raise ValueError(f"the period march at sr={sr}, srr={srr}, f0_min={f0_min} searches "
                         f"bands of up to {band} lags; the kernel takes at most {MAX_BAND}")
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"the period march at sr={sr}, srr={srr}, f0_min={f0_min} needs {smem} B of shared "
            f"memory a block (a ring of {ring} samples for windows of {gw}); a block has "
            f"{SMEM_LIMIT}")
    return MarchPlan(w0, hi, gw, ring, CHUNK, QUEUE, smem)


def _f32(v: float) -> float:
    return float(np.float32(v))


def march_periods_reference(x, f0, ns, nf, sr: float, hop: int, srr: float, f0_min: float,
                            p_max: int) -> MarchArrays:
    """Plain march over the lanes in lockstep: each substep gathers every
    lane's window, unfolds it into its (HI, W0) lag windows and scores them
    in float64."""
    b, n_samples = x.shape
    t = f0.shape[1]
    dev = x.device
    w0_max, hi_max, gw = march_geometry(sr, srr, f0_min)
    skip = max(hop // 2, 1)
    n = ns.to(torch.int64)
    nfr = nf.to(torch.int64)
    xpad = torch.nn.functional.pad(x, (0, gw)).to(torch.float64)
    # next voiced frame at or after each frame, frames past nf − 1 reading nf − 1
    fidx = torch.arange(t, device=dev)
    vmask = f0.gather(1, torch.minimum(fidx[None, :], nfr[:, None] - 1)) > 0
    nv = torch.where(vmask, fidx, t).flip(1).cummin(1).values.flip(1)

    sr32, f0_min32 = (torch.tensor(_f32(v), device=dev) for v in (sr, f0_min))
    m_lo, m_hi = (torch.tensor(_f32(v), device=dev) for v in (1 - srr, 1 + srr))
    offs = torch.arange(gw, device=dev)
    lags = torch.arange(hi_max, device=dev)
    tpos = torch.arange(w0_max, device=dev)
    pos = torch.zeros(b, dtype=torch.int64, device=dev)
    k = torch.zeros_like(pos)
    broken = torch.zeros(b, dtype=torch.bool, device=dev)
    outs = [torch.zeros(b, p_max, dtype=dt, device=dev)
            for dt in (torch.int32, torch.int32, torch.float32, torch.float32)]
    while True:
        live = (pos < n - 16) & ~broken & (k < p_max)
        if not bool(live.any()):
            break
        fi = torch.minimum(pos // hop, nfr - 1)
        f0v = f0.gather(1, fi[:, None])[:, 0]
        voiced = f0v > 0
        t0 = sr32 / torch.maximum(f0v, f0_min32)
        lo = torch.clamp((t0 * m_lo).to(torch.int64), min=8)
        hi = (t0 * m_hi).to(torch.int64) + 1
        w0 = torch.round(t0).to(torch.int64)
        fits = pos + 2 * hi < n

        g = xpad.gather(1, pos[:, None] + offs)  # (B, GW)
        win = g.unfold(1, w0_max, 1)[:, :hi_max].contiguous()  # win[b, L, i] = g[b, L + i]
        tmask = tpos[None, :] < w0[:, None]
        a = torch.where(tmask, g[:, :w0_max], 0.0)
        corr = (win * a[:, None, :]).sum(-1)
        e = (win * win * tmask[:, None, :]).sum(-1)
        ea = (a * a).sum(-1)
        ethr = 1e-6 * (g * g).sum(-1) + 1e-30
        score = torch.where((e > ethr[:, None]) & (ea > ethr)[:, None],
                            corr / torch.sqrt(torch.clamp(ea[:, None] * e, min=1e-30)), 0.0)
        score = torch.where((lags >= lo[:, None]) & (lags <= hi[:, None]), score, float("-inf"))
        best_len = score.argmax(1)
        cj = corr.gather(1, best_len[:, None])[:, 0]
        ej = e.gather(1, best_len[:, None])[:, 0]
        row = (pos, best_len,
               torch.where(offs[None, :] < best_len[:, None], g.abs(), 0.0).amax(1),
               cj / torch.sqrt(torch.clamp(ea * ej, min=1e-30)))

        emit = voiced & fits & live
        slot = torch.clamp(k, max=p_max - 1)[:, None]
        for out, value in zip(outs, row):
            old = out.gather(1, slot)[:, 0]
            out.scatter_(1, slot, torch.where(emit, value.to(out.dtype), old)[:, None])
        k = k + emit.to(torch.int64)
        g_nv = nv.gather(1, fi[:, None])[:, 0]
        target = torch.where(g_nv >= nfr, n - 16, g_nv * hop)
        jump = torch.clamp((target - pos + skip - 1) // skip, min=1) * skip
        pos = pos + torch.where(live, torch.where(emit, best_len, jump), 0)
        broken = torch.where(live, voiced & ~fits, broken)
    return (*outs, k.to(torch.int32))


def _check(x, f0, ns, nf) -> None:
    if x.ndim != 2 or f0.ndim != 2 or f0.shape[0] != x.shape[0] \
            or ns.shape != (x.shape[0],) or nf.shape != (x.shape[0],):
        raise ValueError(f"expected x (B, N), f0 (B, T), ns and nf (B,), got {tuple(x.shape)}, "
                         f"{tuple(f0.shape)}, {tuple(ns.shape)}, {tuple(nf.shape)}")
    if not (x.device == f0.device == ns.device == nf.device):
        raise ValueError(f"inputs on {x.device}, {f0.device}, {ns.device}, {nf.device}")
    if not (x.dtype == f0.dtype == torch.float32 and ns.dtype == nf.dtype == torch.int32):
        raise TypeError(f"expected float32 x and f0 and int32 ns and nf, got {x.dtype}, "
                        f"{f0.dtype}, {ns.dtype}, {nf.dtype}")


def _launch(entry: str, x, f0, ns, nf, sr, hop, srr, f0_min, p_max, *extra):
    """Allocate the outputs and launch ``entry`` of ``csrc/period_march.cu``
    on CUDA tensors (``extra``: buffers passed after the counts)."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    plan = march_plan(sr, srr, f0_min, hop)
    b, n_samples = x.shape
    x, f0, ns, nf = x.contiguous(), f0.contiguous(), ns.contiguous(), nf.contiguous()
    starts = torch.empty((b, p_max), dtype=torch.int32, device=x.device)
    lengths = torch.empty_like(starts)
    amps = torch.empty((b, p_max), dtype=torch.float32, device=x.device)
    corrs = torch.empty_like(amps)
    counts = torch.empty(b, dtype=torch.int32, device=x.device)
    if b:
        _call("period_march", entry, x.device, x, f0, ns, nf, starts, lengths, amps, corrs,
              counts, *extra, b, n_samples, f0.shape[1], p_max, _f32(sr), int(hop),
              max(int(hop) // 2, 1), _f32(1 - srr), _f32(1 + srr), _f32(f0_min), plan.gw,
              plan.hi, plan.ring, plan.chunk, plan.queue)
    return starts, lengths, amps, corrs, counts


def march_periods(x, f0, ns, nf, sr: float, hop: int, srr: float, f0_min: float,
                  p_max: int) -> MarchArrays:
    """The period march over a (B, N) float32 stack with (B, T) float32 F0,
    (B,) int32 sample and frame counts; ``hop`` in samples; at most ``p_max``
    periods a file."""
    _check(x, f0, ns, nf)
    if x.device.type == "cpu":
        return march_periods_reference(x, f0, ns, nf, sr, hop, srr, f0_min, p_max)
    out = _launch("period_march_f32", x, f0, ns, nf, sr, hop, srr, f0_min, p_max)
    if x.shape[0]:
        march_periods.launches += 1
    return out


march_periods.launches = 0


def march_periods_profile(x, f0, ns, nf, sr: float, hop: int, srr: float, f0_min: float,
                          p_max: int) -> Tuple[MarchArrays, torch.Tensor]:
    """The kernel's profile build on CUDA tensors: the march's outputs (equal
    to :func:`march_periods`'s) and a (B, 8) int64 tensor of SM clocks, read
    by thread 0 of each block with ``clock64()``: the march, then each of
    :data:`PHASES` summed over its steps, then voiced steps · 2^32 + unvoiced
    steps. For measurement only: not counted in ``march_periods.launches``,
    and there is no plain version (it raises on CPU tensors)."""
    _check(x, f0, ns, nf)
    if x.device.type == "cpu":
        raise ValueError("the profile build reads the card's SM clocks; it runs on CUDA "
                         "tensors only")
    prof = torch.zeros((x.shape[0], 8), dtype=torch.int64, device=x.device)
    out = _launch("period_march_profile_f32", x, f0, ns, nf, sr, hop, srr, f0_min, p_max,
                  prof)
    return out, prof


def profile_breakdown(prof) -> Dict[str, np.ndarray]:
    """The profile buffer as arrays by lane: ``total`` clocks, one array a
    phase of :data:`PHASES`, ``voiced_steps`` and ``unvoiced_steps``."""
    p = np.asarray(prof.cpu() if isinstance(prof, torch.Tensor) else prof, dtype=np.int64)
    out = {"total": p[:, 0]}
    out.update({name: p[:, 1 + i] for i, name in enumerate(PHASES)})
    out["voiced_steps"], out["unvoiced_steps"] = p[:, 7] >> 32, p[:, 7] & 0xFFFFFFFF
    return out
