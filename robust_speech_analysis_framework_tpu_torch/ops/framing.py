"""The shared corpus buffer, frame gathers, and results left on the device.

Counterpart of ``robust_speech_analysis_framework_tpu/ops/framing.py``:

* :class:`CorpusBuffer` / :func:`corpus_buffer`: every file of a corpus
  concatenated, zero-padded and uploaded once, shared by every batched
  analysis (pitch, intensity, harmonicity, pulses);
* :func:`gather_frames`: (N,) start indices → (N, win) frames, one index
  gather on the device (the JAX package's row gather + shift select was a
  TPU lowering and has no counterpart);
* :func:`resample_buffer`: the whole buffer resampled on the device;
* :class:`Deferred` / :func:`collect`: a result whose kernels are queued,
  fetched with others behind ONE synchronisation, so a level of independent
  stages waits for the card once, not once per stage;
  :func:`queue_fetch`: a result whose copy to the host is queued at once and
  waited for alone, so chains queued after it keep the card busy;
* :func:`upload` / :func:`upload_pcm_f32`: host arrays to the device without
  waiting for the work queued there (through pinned buffers), the latter at
  half the bytes for 16-bit PCM.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..utils.profiling import span


def _map_tensors(tree: Any, fn: Callable[[torch.Tensor], Any]) -> Any:
    """``tree`` (a tensor, or lists/tuples of them, nested) with ``fn``
    applied to every tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(node, fn) for node in tree)
    return tree


def _stage(tree: Any):
    """(``tree`` with each CUDA tensor's copy into a pinned host buffer
    queued without blocking, the CUDA devices those tensors lie on)."""
    on_card: List[torch.device] = []

    def stage(t: torch.Tensor) -> torch.Tensor:
        t = t.detach()
        if t.device.type != "cuda":
            return t
        if t.device not in on_card:
            on_card.append(t.device)
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)

    return _map_tensors(tree, stage), on_card


def _to_host(tree: Any) -> Any:
    """``tree`` with every tensor as a numpy array. CUDA tensors are copied
    into pinned buffers without blocking, then each device they lie on is
    synchronised once for all of them (the span ``fetch.wait``)."""
    staged, on_card = _stage(tree)
    with span("fetch.wait"):
        for dev in on_card:
            torch.cuda.synchronize(dev)
    return _map_tensors(staged, torch.Tensor.numpy)


class Deferred:
    """A queued-but-unfetched result: ``arrays`` holds the tensors still on
    the device, ``finalize`` turns their host copies (numpy arrays in the
    same nesting) into the operation's normal return value."""

    __slots__ = ("arrays", "finalize")

    def __init__(self, arrays: Any, finalize: Callable[[Any], Any]):
        self.arrays = arrays
        self.finalize = finalize

    def result(self):
        return self.finalize(_to_host(self.arrays))

    @staticmethod
    def ready(value) -> "Deferred":
        """A Deferred wrapping an already-final value."""
        return Deferred((), lambda _: value)


def collect(deferreds: List[Deferred]) -> List[Any]:
    """Every Deferred's result, in order: all their tensors are copied to
    the host behind one synchronisation, then each finalizer runs."""
    host = _to_host([d.arrays for d in deferreds])
    return [d.finalize(h) for d, h in zip(deferreds, host)]


def queue_fetch(arrays: Any, finalize: Callable[[Any], Any]) -> Deferred:
    """A :class:`Deferred` whose device→host copies are queued now, into
    pinned buffers behind the work queued so far, and whose result waits for
    those copies alone (an event), not for work queued after them: a caller
    that keeps several chains in flight reads the oldest while the card runs
    the others."""
    staged, on_card = _stage(arrays)
    if not on_card:
        return Deferred(staged, finalize)
    done = []
    for dev in on_card:  # behind the copies on each device's current stream
        done.append(torch.cuda.Event())
        done[-1].record(torch.cuda.current_stream(dev))

    def after_copies(host):
        for event in done:
            event.synchronize()
        return finalize(host)

    return Deferred(staged, after_copies)


def upload(a, device: torch.device) -> torch.Tensor:
    """A host array or CPU tensor, copied to ``device``. To the card it goes
    through a pinned buffer without blocking: a blocking copy would first
    wait for every kernel queued on the stream."""
    t = torch.as_tensor(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device, copy=True)


def _pcm_int16(a: np.ndarray) -> Optional[np.ndarray]:
    """``a`` × 32768 as int16 when every sample is exactly n/32768 with n in
    [−32768, 32767] (16-bit PCM), else None."""
    q = a * 32768.0
    qi = np.round(q)
    if a.size and abs(float(qi.max(initial=0.0))) <= 32767 \
            and abs(float(qi.min(initial=0.0))) <= 32768 \
            and bool((q == qi).all()):
        return qi.astype(np.int16)
    return None


def upload_pcm_f32(a: np.ndarray, device: DeviceLike = "cuda") -> torch.Tensor:
    """A float32 array on ``device``, uploaded as int16 and scaled by 2^-15
    there when it is 16-bit PCM (half the bytes), as float32 otherwise. The
    scaling is exact in float32, so both routes give the same bits."""
    dev = resolve_device(device)
    a = np.ascontiguousarray(a, np.float32)
    q = _pcm_int16(a)
    if q is None:
        return upload(a, dev)
    return upload(q, dev).to(torch.float32) * (1.0 / 32768.0)


def gather_frames(x_cat: torch.Tensor, starts: torch.Tensor, win_len: int) -> torch.Tensor:
    """(N,) start indices → (N, win_len) frames ``x_cat[s : s + win_len]``.

    Every start must leave ``win_len`` samples inside ``x_cat``: the JAX
    package's CPU path clamps a start that runs past the end and its TPU
    path reads zeros there, so its callers (and these) raise first when a
    window or lag extension exceeds the buffer's pad.
    """
    offsets = torch.arange(win_len, device=x_cat.device, dtype=starts.dtype)
    return x_cat[starts[:, None] + offsets]


def rows32_gather(x32: torch.Tensor, starts: torch.Tensor, win_len: int) -> torch.Tensor:
    """:func:`gather_frames` over a buffer held as (-1, 32) rows, zero-padded
    at least ``win_len`` samples past the largest start (the pulse march's
    form of the waveform)."""
    return gather_frames(x32.reshape(-1), starts, win_len)


class CorpusBuffer(NamedTuple):
    """The corpus waveform concatenation, uploaded to the device ONCE and
    shared by every batched analysis stage.

    Each file is zero-padded by ``pad`` samples (at least) inside the
    concatenation, so an analysis whose window extends at most ``pad``
    samples past a file's end (window + largest lag) reads nothing of the
    next file.
    """

    xs: List[np.ndarray]  # original host waveforms (float64)
    offsets: np.ndarray  # (n_files,) start of each file in x_cat
    pad: int
    x_cat: torch.Tensor  # device-resident concatenation (float32)


def corpus_buffer(xs, pad: int = 4096, align: int = 8, device: DeviceLike = "cuda") -> CorpusBuffer:
    """Build and upload the shared corpus concatenation to ``device``.

    ``align`` rounds each file's padded extent up to a multiple, so file
    offsets stay on rational-resampling phase boundaries (see
    :func:`resample_buffer`). A 16-bit-PCM corpus (every sample n/32768)
    goes up as int16, half the bytes, and is scaled by 2^-15 on the device:
    exact in float32, so ``x_cat`` equals the float32 upload bit for bit.
    """
    dev = resolve_device(device)
    xs = [np.asarray(x, dtype=np.float64).reshape(-1) for x in xs]
    offsets = np.zeros(len(xs), np.int64)
    pieces = []
    offset = 0
    for i, x in enumerate(xs):
        offsets[i] = offset
        extra = (-(len(x) + pad)) % align
        pieces.append(np.pad(x, (0, pad + extra)).astype(np.float32))
        offset += len(x) + pad + extra
    cat = np.concatenate(pieces) if pieces else np.zeros(0, np.float32)
    return CorpusBuffer(xs, offsets, pad, upload_pcm_f32(cat, dev))


class _LengthOnly(np.ndarray):
    """Zero-filled stand-in carrying only a length (device-resident corpora
    whose host copies were never materialized)."""


def _length_view(n: int) -> np.ndarray:
    return np.zeros(max(int(n), 0), np.float64).view(_LengthOnly)


def resample_buffer(buf: CorpusBuffer, up: int, down: int, preemphasis: float = 0.0) -> CorpusBuffer:
    """Rational-resample a whole corpus buffer on its device (one strided
    convolution over the concatenation), with optional preemphasis.

    Every file offset must be divisible by ``down`` (``corpus_buffer(...,
    align=down·k)``): output sample ``o`` sits at input position
    ``o·down/up``, so file i's region starts at ``offsets[i]·up/down``
    exactly, and the pad zeros between files make each region equal to
    resampling that file alone. The returned buffer's ``xs`` are zero-filled
    length-only views: their lengths give frame grids, their samples are
    not the audio. The preemphasis sees a zero before sample 0 of the
    buffer (x[0] − k·0), as in the JAX package.
    """
    from ..audio.resample import resample_poly

    g = math.gcd(up, down)
    up, down = up // g, down // g
    for off in buf.offsets:
        if off % down:
            raise ValueError("buffer offsets not aligned to resample ratio")
    y = resample_poly(buf.x_cat, up, down)
    if preemphasis > 0.0:
        y = y - preemphasis * torch.cat([y.new_zeros(1), y[:-1]])
    new_offsets = (buf.offsets * up) // down
    new_xs = [_length_view(-(-len(x) * up // down)) for x in buf.xs]
    new_pad = (buf.pad * up) // down - up  # conservative: resample tail blur
    return CorpusBuffer(new_xs, new_offsets, new_pad, y)
