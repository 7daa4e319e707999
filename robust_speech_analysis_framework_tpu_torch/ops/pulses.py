"""Glottal pulse marking and interval segmentation (TextGrid-style).

Counterpart of ``robust_speech_analysis_framework_tpu/ops/pulses.py``:

* :func:`point_process_cc`: Praat ``[Sound, Pitch]: To PointProcess (cc)``,
  period-synchronous peak picking guided by a pitch track, numpy float64 on
  the host (the oracle of the batched march);
* :func:`point_process_cc_batch`: the same march for every voiced stretch
  of a corpus at once, as lanes of torch operations on the buffer's device;
* :func:`vuv_intervals`, :func:`silence_intervals`, :func:`label_at_time`:
  voiced/unvoiced and silent/sounding segmentation on the host.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .bucketing import bucket_size
from .framing import Deferred, _to_host, rows32_gather
from .intensity import IntensityContour
from .pitch import PitchTrack


def point_process_cc(x: np.ndarray, sr: float, pitch: PitchTrack) -> np.ndarray:
    """Glottal pulse times from waveform peaks guided by the pitch track.

    Within each voiced stretch, successive pulses are the absolute waveform
    peak in a window of 0.8·T to 1.25·T from the last (T the local period),
    marched forward and backward from a seed at the largest peak within one
    period of the stretch's start.
    """
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    x_abs = np.abs(x)
    times = pitch.times
    f0 = np.asarray(pitch.f0, dtype=np.float64)
    n = len(times)
    n_x = len(x)
    # scalar interpolator matching PitchTrack.value_at_time (linear between
    # voiced frames, NaN in unvoiced spans), called once per pulse
    f0_list = np.where(f0 > 0, f0, np.nan).tolist()
    t0 = float(times[0]) if n else 0.0
    dt = float(times[1] - times[0]) if n > 1 else 1.0
    t_last = float(times[-1]) if n else 0.0

    def f_at(t: float) -> float:
        if t < t0 or t > t_last:
            return float("nan")
        pos = (t - t0) / dt
        i0 = min(max(int(pos), 0), n - 1)
        i1 = i0 + 1 if i0 + 1 < n else n - 1
        w = min(max(pos - i0, 0.0), 1.0)
        # a frame-center hit must not touch the other neighbour (0·NaN = NaN
        # at a stretch's first/last voiced frame); pos carries ~1 ulp of
        # rounding, so snap within an epsilon
        if w < 1e-9:
            return f0_list[i0]
        if w > 1.0 - 1e-9:
            return f0_list[i1]
        return (1 - w) * f0_list[i0] + w * f0_list[i1]

    pulses: List[float] = []
    i = 0
    while i < n:
        if f0[i] <= 0:
            i += 1
            continue
        j = i
        while j < n and f0[j] > 0:
            j += 1
        t_start, t_end = float(times[i]), float(times[j - 1])
        period = 1.0 / f0[i]
        a = int(max(0.0, (t_start - period) * sr))
        b = int(min(n_x, (t_start + period) * sr))
        if b <= a:
            i = j
            continue
        seed = (a + int(np.argmax(x_abs[a:b]))) / sr
        head: List[float] = []
        tail: List[float] = [seed]
        # pitch queries clamp into [t_start, t_end]: the seed often precedes
        # the stretch's first frame center
        t = seed
        while True:
            f_here = f_at(min(max(t, t_start), t_end))
            if not (f_here > 0):
                break
            period = 1.0 / f_here
            lo = t + 0.8 * period
            if lo > t_end + period:
                break
            a = int(lo * sr)
            b = min(int((t + 1.25 * period) * sr) + 1, n_x)
            if b <= a:
                break
            t = (a + int(np.argmax(x_abs[a:b]))) / sr
            tail.append(t)
        t = seed
        while True:
            f_here = f_at(min(max(t, t_start), t_end))
            if not (f_here > 0):
                break
            period = 1.0 / f_here
            hi = t - 0.8 * period
            if hi < t_start - period:
                break
            a = max(int((t - 1.25 * period) * sr), 0)
            b = int(hi * sr) + 1
            if b <= a:
                break
            t = (a + int(np.argmax(x_abs[a:b]))) / sr
            head.append(t)
        head.reverse()
        pulses.extend(head)
        pulses.extend(tail)
        i = j
    return np.asarray(sorted(set(np.round(np.asarray(pulses), 9))))


# ---------------------------------------------------------------------------
# Corpus-batched pulse marking (device)
# ---------------------------------------------------------------------------
#
# The march is sequential only through the current pulse, and the forward
# and backward marches of every voiced stretch are independent (the host
# sorts and deduplicates the pulse set at the end). So (track, stretch
# chunk, direction) become lanes, and every lane's cursor advances in one
# step of torch operations over all lanes: the window reads are one index
# gather from the corpus buffer. Pulse positions are integer sample
# indices, so the index arithmetic matches the host's float64 int()
# truncations; the 1/f0 interpolation and the window-end comparisons are
# float32, written as the JAX package writes them.

_W_SEED = 1088  # ≥ 2·sr/f0_min samples (f0_min 30 Hz @ 16 kHz → 1067)
_W_MARCH = 256  # ≥ 0.45·sr/f0_min + 2
_SPLIT_SEC = 0.5  # voiced stretches are marched in chunks of at most this
_SYNC_EVERY = 16  # steps between two reads of "is any lane alive" on the host


def _march_lanes(x_cat, f0_pad, t0s, nfs, base, nx, f0row, seed_a, seed_b, t_start, t_end,
                 direction, sr: float, dt: float, p_max: int):
    """Every lane's march, stepped together; returns (seeds, bufs, ks):
    the seed sample of each forward lane (−1 elsewhere), the (lanes, p_max)
    pulse samples and each lane's count.

    A host loop runs the step and reads ``alive.any()`` every
    ``_SYNC_EVERY`` steps only: a dead lane's step changes nothing (its
    ``ok`` is false), so the result equals a check after every step. The
    last march's step and synchronisation counts are left in
    ``_march_lanes.steps`` and ``.syncs``.
    """
    dev = x_cat.device
    s_lanes = base.shape[0]
    f0nan = torch.where(f0_pad > 0, f0_pad, float("nan"))
    t_dim = f0_pad.shape[1]
    total32 = -(-(x_cat.shape[0] + _W_SEED + 64) // 32) * 32
    x32 = torch.nn.functional.pad(x_cat, (0, total32 - x_cat.shape[0])).reshape(-1, 32)
    march_cols = torch.arange(_W_MARCH, device=dev)

    # divisors as tensors: CUDA multiplies by the reciprocal of a Python
    # scalar divisor where the CPU divides, and the card should step as the CPU
    sr_t, dt_t = (torch.tensor(v, dtype=torch.float32, device=dev) for v in (sr, dt))
    row_t0, row_n = t0s[f0row], nfs[f0row]
    # the last frame center rounded once (exact in float64, then float32),
    # as the fused multiply-add XLA emits for t0 + (n−1)·dt: rounded twice it
    # can fall below the float32 stretch end, and the query clamped there
    # at a track's last voiced frame would read NaN and drop its last pulse
    row_t_last = (row_t0.double() + (row_n - 1).double() * np.float32(dt).item()).float()

    def f_at(t):
        pos = (t - row_t0) / dt_t
        i0 = torch.minimum(torch.clamp(pos.to(torch.int32), min=0), row_n - 1)
        i1 = torch.minimum(i0 + 1, row_n - 1)
        w = torch.clamp(pos - i0, 0.0, 1.0)
        v0 = f0nan[f0row, torch.clamp(i0, 0, t_dim - 1).long()]
        v1 = f0nan[f0row, torch.clamp(i1, 0, t_dim - 1).long()]
        # a frame-center hit must not touch the other neighbour (mirrors the
        # host f_at); the epsilon absorbs the float32 grid-division rounding
        val = torch.where(w < 1e-3, v0, torch.where(w > 1.0 - 1e-3, v1, (1 - w) * v0 + w * v1))
        return torch.where((t < row_t0) | (t > row_t_last), float("nan"), val)

    # seeds: the peak of |x| in the host's [seed_a, seed_b) windows
    wseed = rows32_gather(x32, (base + seed_a).long(), _W_SEED)
    wseed = torch.where(torch.arange(_W_SEED, device=dev)[None, :] < (seed_b - seed_a)[:, None],
                        wseed.abs(), -1.0)
    seeds = seed_a + torch.argmax(wseed, dim=1).to(torch.int32)
    valid = seed_b > seed_a
    is_fwd = direction > 0
    lane_ids = torch.arange(s_lanes, device=dev)

    t_samp = seeds
    k = torch.zeros(s_lanes, dtype=torch.int32, device=dev)
    alive = valid
    bufs = torch.zeros((s_lanes, p_max), dtype=torch.int32, device=dev)
    steps = syncs = 0
    while True:
        if steps % _SYNC_EVERY == 0:
            syncs += 1
            if not bool(alive.any()):
                break
        steps += 1
        t_sec = t_samp.to(torch.float32) / sr_t
        # clamp queries into the stretch in both directions (the forward
        # seed often precedes the first frame center)
        f = f_at(torch.minimum(torch.maximum(t_sec, t_start), t_end))
        ok = alive & (f > 0)  # NaN-safe
        period = 1.0 / torch.where(f > 0, f, 1.0)
        ok &= torch.where(is_fwd, t_sec + 0.8 * period <= t_end + period,
                          t_sec - 0.8 * period >= t_start - period)
        a = torch.where(
            is_fwd,
            t_samp + (0.8 * period * sr).to(torch.int32),
            torch.clamp(torch.floor(t_samp - 1.25 * period * sr).to(torch.int32), min=0),
        )
        b = torch.where(
            is_fwd,
            torch.minimum(nx, t_samp + (1.25 * period * sr).to(torch.int32) + 1),
            torch.floor(t_samp - 0.8 * period * sr).to(torch.int32) + 1,
        )
        ok &= b > a
        a0 = torch.clamp(a, min=0)
        # a lane that takes no step reads from sample 0: its window is masked
        # out, and its own start may lie past the buffer
        w = rows32_gather(x32, torch.where(ok, base + a0, 0).long(), _W_MARCH)
        w = torch.where(march_cols[None, :] < torch.where(ok, b - a, 0)[:, None], w.abs(), -1.0)
        t_new = a0 + torch.argmax(w, dim=1).to(torch.int32)
        slot = torch.clamp(k, max=p_max - 1).long()  # a full lane is dead: no write lands
        bufs[lane_ids, slot] = torch.where(ok, t_new, bufs[lane_ids, slot])
        t_samp = torch.where(ok, t_new, t_samp)
        alive = ok & (k + 1 < p_max)
        k = k + ok.to(torch.int32)
    _march_lanes.steps, _march_lanes.syncs = steps, syncs
    # only forward lanes report the seed (one per pair)
    return torch.where(valid & is_fwd, seeds, -1), bufs, k


def _compact_pulse_buf(bufs, ks, off, cap, out_size: int) -> torch.Tensor:
    """The first min(ks, cap) entries of every lane's march buffer, each
    lane's at its host-assigned offset of one flat (out_size,) array."""
    p_max = bufs.shape[1]
    kk = torch.arange(p_max, dtype=torch.int32, device=bufs.device)[None, :]
    keep = kk < torch.minimum(ks, cap)[:, None]
    idx = torch.where(keep, off[:, None] + kk, out_size).reshape(-1).long()
    flat = torch.zeros(out_size + 1, dtype=torch.int32, device=bufs.device)
    flat[idx] = bufs.reshape(-1)  # dropped entries land in the extra slot
    return flat[:out_size]


_march_lanes.steps = _march_lanes.syncs = 0


def march_windows(sr: float, tracks) -> Tuple[int, int]:
    """(seed, march) gather windows, in samples, that the lowest voiced f0
    of the tracks the march takes (two frames or more) needs at ``sr``;
    (0, 0) when nothing is voiced. The device march's fixed windows
    (``_W_SEED``, ``_W_MARCH``) are sized for speech floors at sr ≤ 16 kHz,
    and :func:`point_process_cc_batch` raises when a batch needs more."""
    voiced = [float(np.min(tr.f0[tr.f0 > 0])) for tr in tracks
              if tr is not None and len(tr.times) > 1 and np.any(tr.f0 > 0)]
    if not voiced:
        return 0, 0
    min_f0 = min(voiced)
    return int(2.0 * sr / min_f0) + 2, int(0.45 * sr / min_f0) + 2


def march_windows_fit(sr: float, tracks) -> bool:
    """Whether the device march can take ``tracks`` at ``sr``."""
    need = march_windows(sr, tracks)
    return need[0] <= _W_SEED and need[1] <= _W_MARCH


def point_process_cc_batch(xs, sr: float, tracks, buf=None, defer: bool = False,
                           device: DeviceLike = "cuda"):
    """:func:`point_process_cc` for many (file, track) pairs at once.

    ``tracks``: one PitchTrack (or None) per file of ``xs`` (or ``buf``), or
    several such lists concatenated (``len(tracks)`` a multiple of the file
    count; entry k belongs to file ``k % n_files``), so several track
    families march in one program. Each voiced stretch is cut into chunks
    of at most ``_SPLIT_SEC`` s; each chunk is a forward and a backward lane
    that keeps only the pulses it owns. The waveform comes from ``buf`` on
    its device, or from ``xs`` uploaded to ``device``. Returns one
    pulse-time array per entry of ``tracks`` (or a ``Deferred`` of them).
    """
    if buf is not None:
        xs = buf.xs
    n_files = len(xs)
    lens = [len(np.asarray(x)) for x in xs]
    n_tracks = len(tracks)
    if n_files == 0 or n_tracks % n_files:
        raise ValueError(f"{n_tracks} tracks not a multiple of {n_files} files")

    rows_meta = []  # per track: its f0 row, or None
    f0_list, t0_list, nf_list = [], [], []
    for tr in tracks:
        if tr is None or len(tr.times) < 2:
            rows_meta.append(None)
            continue
        rows_meta.append(len(f0_list))
        f0_list.append(np.asarray(tr.f0, np.float32))
        t0_list.append(float(tr.times[0]))
        nf_list.append(len(tr.times))
    empty = [np.zeros(0) for _ in range(n_tracks)]
    if not f0_list:
        return Deferred.ready(empty) if defer else empty
    usable = [tr for tr in tracks if tr is not None and len(tr.times) > 1]
    dt = float(usable[0].times[1] - usable[0].times[0])
    # one dt serves every lane's grid arithmetic
    for tr in usable:
        tr_dt = float(tr.times[1] - tr.times[0])
        if abs(tr_dt - dt) > 1e-9:
            raise ValueError(f"mixed pitch-track time steps in one batch: {dt} vs {tr_dt}; "
                             "call point_process_cc_batch per step family")
    if not march_windows_fit(sr, usable):
        raise ValueError(
            f"sr={sr} with the tracks' lowest f0 needs gather windows "
            f"{march_windows(sr, usable)} exceeding the march's ({_W_SEED}, {_W_MARCH}); "
            "resample to ≤16 kHz or use the host point_process_cc oracle")
    t_max = max(len(f) for f in f0_list)
    f0_pad = np.zeros((len(f0_list), t_max), np.float32)
    for i, f in enumerate(f0_list):
        f0_pad[i, : len(f)] = f

    # lanes: (track, row, seed_a, seed_b, c0, c1, keep_lo, keep_hi, cap); host
    # decision logic with exact float64 seed windows
    lanes = []
    for ti, tr in enumerate(tracks):
        row = rows_meta[ti]
        if row is None:
            continue
        fi = ti % n_files
        f0 = np.asarray(tr.f0)
        times = tr.times
        n = len(times)
        i = 0
        while i < n:
            if f0[i] <= 0:
                i += 1
                continue
            j = i
            while j < n and f0[j] > 0:
                j += 1
            t_start, t_end = float(times[i]), float(times[j - 1])
            seg = f0[i:j]
            f0_hi, f0_lo = float(seg.max()), float(seg.min())
            n_chunks = max(1, int(np.ceil((t_end - t_start) / _SPLIT_SEC)))
            edges = np.linspace(t_start, t_end, n_chunks + 1)
            for ci in range(n_chunks):
                c0, c1 = float(edges[ci]), float(edges[ci + 1])
                # f0 at the chunk start (nearest voiced frame in [i, j))
                fi0 = min(max(i, int(round((c0 - float(times[0])) / dt))), j - 1)
                period = 1.0 / float(f0[fi0]) if f0[fi0] > 0 else 1.0 / float(f0[i])
                a = int(max(0.0, (c0 - period) * sr))
                b = int(min(lens[fi], (c0 + period) * sr))
                if b <= a:
                    continue
                keep_lo = -np.inf if ci == 0 else c0
                keep_hi = np.inf if ci == n_chunks - 1 else c1
                # pulse-count bound: ≥ 0.8·T ≥ 0.8/f0_hi a pulse over at most
                # (c1 − c0) + 2·T_max (the march's ±T overshoot)
                cap = int(((c1 - c0) + 2.0 / max(f0_lo, 1.0)) * f0_hi / 0.8) + 8
                lanes.append((ti, row, a, b, c0, c1, keep_lo, keep_hi, cap))
            i = j

    if not lanes:
        return Deferred.ready(empty) if defer else empty

    if buf is not None:
        offsets, x_cat, tail_pad = buf.offsets, buf.x_cat, buf.pad
    else:
        pieces, offsets = [], np.zeros(n_files, np.int64)
        off = 0
        for i, x in enumerate(xs):
            offsets[i] = off
            pieces.append(np.pad(np.asarray(x, np.float64), (0, _W_SEED)).astype(np.float32))
            off += lens[i] + _W_SEED
        x_cat = torch.from_numpy(np.concatenate(pieces)).to(resolve_device(device))
        tail_pad = _W_SEED
    if tail_pad < _W_SEED:
        raise ValueError(f"corpus buffer pad {tail_pad} < seed window {_W_SEED}")
    dev = x_cat.device

    max_dur = max(lane[5] - lane[4] for lane in lanes)
    # advance ≥ 0.8·T ≥ 0.8·sr/620 ≈ 20 samples per pulse
    p_max = bucket_size(int(max_dur * sr / 16) + 8)

    def column(k, dtype):
        return np.asarray([lane[k] for lane in lanes], dtype)

    track_of = column(0, np.int64)
    lane_files = track_of % n_files
    # one forward and one backward lane per chunk, padded to a bucket with
    # dummy lanes (empty seed window)
    n_lanes2 = 2 * len(lanes)
    s_pad = bucket_size(n_lanes2, min_bucket=8)

    def lane_tensor(per_chunk, dtype, fill=0):
        both = np.concatenate([per_chunk, per_chunk])
        return torch.from_numpy(
            np.pad(both, (0, s_pad - n_lanes2), constant_values=fill).astype(dtype)).to(dev)

    direction = np.pad(np.repeat([1, -1], len(lanes)), (0, s_pad - n_lanes2), constant_values=1)
    seeds_dev, bufs_dev, ks_dev = _march_lanes(
        x_cat, torch.from_numpy(f0_pad).to(dev),
        torch.as_tensor(np.asarray(t0_list, np.float32)).to(dev),
        torch.as_tensor(np.asarray(nf_list, np.int32)).to(dev),
        lane_tensor(offsets[lane_files], np.int32),
        lane_tensor(np.asarray([lens[f] for f in lane_files]), np.int32, fill=1),
        lane_tensor(column(1, np.int64), np.int64),
        lane_tensor(column(2, np.int64), np.int32),
        lane_tensor(column(3, np.int64), np.int32),  # pad b == 0 == a → invalid lane
        lane_tensor(column(4, np.float64), np.float32),
        lane_tensor(column(5, np.float64), np.float32, fill=-1.0),
        torch.from_numpy(direction.astype(np.int32)).to(dev),
        float(sr), float(dt), int(p_max),
    )

    keep_lo = np.concatenate([column(6, np.float64)] * 2)
    keep_hi = np.concatenate([column(7, np.float64)] * 2)
    track_of2 = np.concatenate([track_of, track_of])
    # The march buffer is almost all padding; each lane's count is bounded
    # by its cap, so the buffer is compacted on the device into Σ caps
    # entries before the one transfer. A cap overflow (only if the f0
    # interpolation escaped the stretch's [min, max]) is caught in finalize
    # from the fetched counts and refetches the whole buffer.
    caps = np.minimum(np.pad(np.concatenate([column(8, np.int64)] * 2), (0, s_pad - n_lanes2)),
                      p_max).astype(np.int32)
    offs = np.zeros(len(caps) + 1, np.int64)
    np.cumsum(caps, out=offs[1:])
    flat_cap = bucket_size(int(offs[-1]), min_bucket=64)
    flat_dev = _compact_pulse_buf(bufs_dev, ks_dev,
                                  torch.from_numpy(offs[:-1].astype(np.int32)).to(dev),
                                  torch.from_numpy(caps).to(dev), int(flat_cap))

    def _finalize(host):
        seeds, ks, flat = host
        overflow = bool((np.minimum(ks, p_max) > caps).any())
        full = _to_host(bufs_dev) if overflow else None
        per_track: List[List[float]] = [[] for _ in range(n_tracks)]
        for li in range(n_lanes2):
            samp = [int(seeds[li])] if seeds[li] >= 0 else []
            if overflow:
                samp.extend(int(v) for v in full[li, : int(ks[li])])
            else:
                o = int(offs[li])
                samp.extend(int(v) for v in flat[o : o + min(int(ks[li]), int(caps[li]))])
            lo, hi = keep_lo[li], keep_hi[li]
            per_track[int(track_of2[li])].extend(t for t in (s / sr for s in samp) if lo <= t < hi)
        return [np.asarray(sorted(set(np.round(np.asarray(p), 9).tolist()))) for p in per_track]

    d = Deferred((seeds_dev, ks_dev, flat_dev), _finalize)
    return d if defer else d.result()


def vuv_intervals(pulses: np.ndarray, total_duration: float, max_period: float = 0.02,
                  mean_period: float = 0.01) -> List[Tuple[float, float, str]]:
    """Voiced/unvoiced segmentation from pulse gaps (Praat ``PointProcess:
    To TextGrid (vuv)``): pulses with gaps ≤ ``max_period`` chain into one
    voiced interval [t_first − mean_period/2, t_last + mean_period/2];
    overlapping padded spans stay separate intervals, the later starting
    where the earlier ended. Returns [(tmin, tmax, 'V'|'U'), ...] covering
    [0, total_duration]."""
    out: List[Tuple[float, float, str]] = []
    n = len(pulses)
    if n == 0:
        return [(0.0, total_duration, "U")]
    half = 0.5 * mean_period
    begin_voiceless = 0.0
    i = 0
    while i < n:
        end_voiceless = pulses[i] - half
        if end_voiceless <= begin_voiceless:
            end_voiceless = begin_voiceless
        else:
            out.append((begin_voiceless, end_voiceless, "U"))
        j = i
        while j + 1 < n and pulses[j + 1] - pulses[j] <= max_period:
            j += 1
        v_end = min(pulses[j] + half, total_duration)
        if v_end > end_voiceless:
            out.append((end_voiceless, v_end, "V"))
        begin_voiceless = v_end
        i = j + 1
    if begin_voiceless < total_duration:
        out.append((begin_voiceless, total_duration, "U"))
    return out


def silence_intervals(intensity: IntensityContour, silence_threshold_db: float,
                      min_silent_duration: float = 0.3, min_sounding_duration: float = 0.1,
                      total_duration: Optional[float] = None) -> List[Tuple[float, float, str]]:
    """Silent/sounding segmentation of an intensity contour (Praat
    ``Intensity: To TextGrid (silences)``): a frame is silent below
    ``max + silence_threshold_db``; runs shorter than their minimum
    duration flip and merge with their neighbours. Interior boundaries sit
    at frame midpoints, the outer intervals reach 0 and ``total_duration``
    (default: half a step past the last center). Returns
    [(tmin, tmax, 'silent'|'sounding'), ...]."""
    v = intensity.values_db
    t = intensity.times
    if len(v) == 0:
        return []
    silent = v < v.max() + silence_threshold_db
    dt = t[1] - t[0] if len(t) > 1 else 0.0
    right = t[-1] + dt / 2 if total_duration is None else max(
        total_duration, t[-1] + dt / 2 if len(t) > 1 else t[-1])
    bounds = np.concatenate([[0.0], (t[1:] + t[:-1]) / 2, [right]])
    runs: List[Tuple[float, float, bool]] = []
    k = 0
    for m in range(1, len(v) + 1):
        if m == len(v) or silent[m] != silent[k]:
            runs.append((bounds[k], bounds[m], bool(silent[k])))
            k = m

    def merge(runs):
        merged = []
        for r in runs:
            if merged and merged[-1][2] == r[2]:
                merged[-1] = (merged[-1][0], r[1], r[2])
            else:
                merged.append((r[0], r[1], r[2]))
        return merged

    changed = True
    while changed:
        changed = False
        runs = merge(runs)
        for idx, (a, b, is_sil) in enumerate(runs):
            min_dur = min_silent_duration if is_sil else min_sounding_duration
            if b - a < min_dur and len(runs) > 1:
                runs[idx] = (a, b, not is_sil)
                changed = True
                break
    runs = merge(runs)
    return [(a, b, "silent" if s else "sounding") for a, b, s in runs]


def label_at_time(intervals: List[Tuple[float, float, str]], t: float) -> str:
    for a, b, lab in intervals:
        if a <= t <= b:
            return lab
    return intervals[-1][2] if intervals else ""
