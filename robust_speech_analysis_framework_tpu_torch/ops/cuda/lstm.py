"""LSTM recurrence: the hand-written CUDA kernels and their plain PyTorch versions.

Counterpart of ``robust_speech_analysis_framework_tpu/ops/pallas/lstm.py``.
The input projections ``x @ Wx + b`` for all gates and time steps are one
large matmul outside the kernels; the kernels run the strictly sequential
part,

    z_t = g_t + h_{t-1} @ Wh;   (i, f, g, o) = split(z_t);   c, h update,

with the whole time loop inside one launch.

Inference (``csrc/lstm_scan.cu``):

* :func:`lstm_scan_grouped` (K1): gates (T, G, B, 4H), wh (G, H, 4H) →
  hs (T, G, B, H); G recurrences in lockstep (both directions of a biLSTM
  layer in one launch).
* :func:`lstm_scan` (K2): the same kernel at G = 1; gates (T, B, 4H),
  wh (H, 4H) → hs (T, B, H).

Training (``csrc/lstm_scan.cu`` with c saved, ``csrc/lstm_train.cu``):

* :func:`lstm_scan_fwd_res_grouped` (K3): K1's recurrence, also returning
  every c_t: → hs, cs (T, G, B, H).
* :func:`lstm_scan_bwd_grouped` (K4): the reverse sweep, gates, hs, cs, wh,
  dhout → dgates (T, G, B, 4H), dwh (G, H, 4H), as three hand-written
  kernels: :func:`lstm_gate_acts_grouped` recomputes the activated gates
  i, f, g, o of every step at once (a parallel pre-pass, written into the
  dgates buffer), the sweep walks t = T-1 .. 0 over them and overwrites
  them with dz, and :func:`lstm_dwh_grouped` reduces dgates and the shifted
  hs to dwh (the rows split into slices, the slices' sums added in order).
* :class:`LSTMRecurrenceGrouped` (K5): the ``torch.autograd.Function``
  pairing K3 with K4; :func:`lstm_recurrence_grouped` and, at G = 1,
  :func:`lstm_recurrence` are its functional forms.

Like the TPU kernels, none freezes state past a sequence's length: the
padded tail computes values that callers never read, and (given a zero
``dhout`` there) contributes nothing to the gradients.

Dispatch goes by the tensors' device: CPU tensors take the plain version,
CUDA tensors launch the kernel or raise. There is no fallback between them.
Each kernel's wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ._build import call as _call


def lstm_scan_fwd_res_reference_grouped(
    gates: torch.Tensor, wh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch recurrence: (T, G, B, 4H) + (G, H, 4H) → hs, cs (T, G, B, H)."""
    t_len, g, b, four_h = gates.shape
    h_dim = four_h // 4
    h = gates.new_zeros((g, b, h_dim))
    c = gates.new_zeros((g, b, h_dim))
    hs = gates.new_empty((t_len, g, b, h_dim))
    cs = gates.new_empty((t_len, g, b, h_dim))
    for t in range(t_len):
        z = gates[t] + torch.bmm(h, wh)
        i = torch.sigmoid(z[..., :h_dim])
        f = torch.sigmoid(z[..., h_dim : 2 * h_dim])
        g_ = torch.tanh(z[..., 2 * h_dim : 3 * h_dim])
        o = torch.sigmoid(z[..., 3 * h_dim :])
        c = f * c + i * g_
        h = o * torch.tanh(c)
        hs[t] = h
        cs[t] = c
    return hs, cs


def lstm_scan_reference_grouped(gates: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch recurrence: (T, G, B, 4H) + (G, H, 4H) → (T, G, B, H)."""
    return lstm_scan_fwd_res_reference_grouped(gates, wh)[0]


def lstm_dwh_reference_grouped(hs: torch.Tensor, dgates: torch.Tensor) -> torch.Tensor:
    """Plain dWh: Σ over t ≥ 1 and b of hs[t-1]ᵀ dgates[t] → (G, H, 4H)."""
    return torch.einsum("tgbk,tgbj->gkj", hs[:-1], dgates[1:])


def lstm_scan_bwd_reference_grouped(
    gates: torch.Tensor, hs: torch.Tensor, cs: torch.Tensor, wh: torch.Tensor,
    dhout: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain reverse sweep (the TPU kernel's arithmetic, step by step).

    gates (T, G, B, 4H), hs/cs/dhout (T, G, B, H), wh (G, H, 4H) →
    dgates (T, G, B, 4H), dwh (G, H, 4H). h_{-1} = c_{-1} = 0.
    """
    t_len, g, b, four_h = gates.shape
    h_dim = four_h // 4
    zeros = gates.new_zeros((g, b, h_dim))
    dh, dc = zeros, zeros
    wh_t = wh.transpose(1, 2)
    dgates = torch.empty_like(gates)
    for t in reversed(range(t_len)):
        hp = hs[t - 1] if t > 0 else zeros
        cp = cs[t - 1] if t > 0 else zeros
        z = gates[t] + torch.bmm(hp, wh)
        i = torch.sigmoid(z[..., :h_dim])
        f = torch.sigmoid(z[..., h_dim : 2 * h_dim])
        g_ = torch.tanh(z[..., 2 * h_dim : 3 * h_dim])
        o = torch.sigmoid(z[..., 3 * h_dim :])
        tc = torch.tanh(cs[t])
        dht = dhout[t] + dh
        dct = dc + dht * o * (1.0 - tc * tc)
        dz = torch.cat([
            dct * g_ * i * (1.0 - i),
            dct * cp * f * (1.0 - f),
            dct * i * (1.0 - g_ * g_),
            dht * tc * o * (1.0 - o),
        ], dim=-1)
        dgates[t] = dz
        dh = torch.bmm(dz, wh_t)
        dc = dct * f
    return dgates, lstm_dwh_reference_grouped(hs, dgates)


def lstm_gate_acts_reference_grouped(
    gates: torch.Tensor, hs: torch.Tensor, wh: torch.Tensor
) -> torch.Tensor:
    """Plain gate recompute: the activated gates of every step,
    ``[σ(z_i), σ(z_f), tanh(z_g), σ(z_o)]`` with ``z_t = gates_t + h_{t-1} @ Wh``
    and h_{-1} = 0. gates (T, G, B, 4H), hs (T, G, B, H), wh (G, H, 4H) →
    acts (T, G, B, 4H). One product a step, as the plain sweep takes it."""
    t_len, g, b, four_h = gates.shape
    h_dim = four_h // 4
    zeros = gates.new_zeros((g, b, h_dim))
    acts = torch.empty_like(gates)
    for t in range(t_len):
        z = gates[t] + torch.bmm(hs[t - 1] if t > 0 else zeros, wh)
        acts[t, ..., : 2 * h_dim] = torch.sigmoid(z[..., : 2 * h_dim])
        acts[t, ..., 2 * h_dim : 3 * h_dim] = torch.tanh(z[..., 2 * h_dim : 3 * h_dim])
        acts[t, ..., 3 * h_dim :] = torch.sigmoid(z[..., 3 * h_dim :])
    return acts


def lstm_sweep_from_acts_reference_grouped(
    acts: torch.Tensor, cs: torch.Tensor, wh: torch.Tensor, dhout: torch.Tensor
) -> torch.Tensor:
    """Plain reverse sweep over activated gates: the loop of
    :func:`lstm_scan_bwd_reference_grouped` without its recompute.
    acts (T, G, B, 4H), cs/dhout (T, G, B, H), wh (G, H, 4H) → dgates."""
    t_len, g, b, four_h = acts.shape
    h_dim = four_h // 4
    zeros = acts.new_zeros((g, b, h_dim))
    dh, dc = zeros, zeros
    wh_t = wh.transpose(1, 2)
    dgates = torch.empty_like(acts)
    for t in reversed(range(t_len)):
        i, f, g_, o = acts[t].split(h_dim, dim=-1)
        cp = cs[t - 1] if t > 0 else zeros
        tc = torch.tanh(cs[t])
        dht = dhout[t] + dh
        dct = dc + dht * o * (1.0 - tc * tc)
        dz = torch.cat([
            dct * g_ * i * (1.0 - i),
            dct * cp * f * (1.0 - f),
            dct * i * (1.0 - g_ * g_),
            dht * tc * o * (1.0 - o),
        ], dim=-1)
        dgates[t] = dz
        dh = torch.bmm(dz, wh_t)
        dc = dct * f
    return dgates


def lstm_scan_reference(gates: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch recurrence: (T, B, 4H) + (H, 4H) → (T, B, H)."""
    return lstm_scan_reference_grouped(gates[:, None], wh[None])[:, 0]


def _check(gates: torch.Tensor, wh: torch.Tensor, gates_ndim: int,
           cpu_float64: bool = False) -> None:
    """Shapes, device and type; float64 passes only on the CPU and only
    where ``cpu_float64`` (the training functions, for gradcheck)."""
    if gates.ndim != gates_ndim or wh.ndim != gates_ndim - 1:
        raise ValueError(
            f"expected gates with {gates_ndim} dims and wh with {gates_ndim - 1}, "
            f"got {tuple(gates.shape)} and {tuple(wh.shape)}"
        )
    if gates.device != wh.device:
        raise ValueError(f"gates on {gates.device} but wh on {wh.device}")
    dtypes = (torch.float32, torch.float64) if cpu_float64 and gates.is_cpu else (torch.float32,)
    if gates.dtype not in dtypes or wh.dtype != gates.dtype:
        raise TypeError(f"expected float32, got {gates.dtype} and {wh.dtype}")
    four_h = gates.shape[-1]
    h_dim = four_h // 4
    if four_h != 4 * h_dim or tuple(wh.shape[-2:]) != (h_dim, four_h):
        raise ValueError(
            f"wh {tuple(wh.shape)} does not match gates {tuple(gates.shape)}"
        )


def _check_like(gates: torch.Tensor, **tensors: torch.Tensor) -> None:
    """Each tensor is (T, G, B, H) for gates (T, G, B, 4H), on its device and type."""
    t_len, g, b, four_h = gates.shape
    for name, x in tensors.items():
        if tuple(x.shape) != (t_len, g, b, four_h // 4):
            raise ValueError(f"{name} {tuple(x.shape)} does not match gates {tuple(gates.shape)}")
        if x.device != gates.device or x.dtype != gates.dtype:
            raise ValueError(f"{name} is {x.dtype} on {x.device}, gates {gates.dtype} on {gates.device}")


# Largest batch tile of the forward scan and of the reverse sweep: beside the
# part of Wh (Whᵀ) a thread keeps in registers, more rows' state would spill,
# and a spilling tile ran slower than two passes of the next smaller one.
SCAN_LARGEST_TILE = 2
SWEEP_LARGEST_TILE = 4


def _pick_batch_tile(g: int, b: int, n_sms: int, largest: int) -> int:
    """Batch rows per block: the fewest that keep every block on its own SM.

    A block holds its direction's Wh in registers and most of an SM's shared
    memory, so an SM runs one block at a time; every row a block carries
    beside the first lengthens its step, so more blocks go faster until they
    outnumber the SMs. Past ``largest`` rows a block the grid runs in more
    than one wave.
    """
    tile = 1
    while tile < largest and g * -(-b // tile) > n_sms:
        tile *= 2
    return tile


def _pack_wh(wh: torch.Tensor) -> torch.Tensor:
    """(G, H, 4H) → (G, 8·NK, 4H, 4) with NK = ⌈H / 32⌉, the layout the
    forward kernel reads. Thread p of a block is lane ``l = p % 8`` of the
    group ``j = p // 8`` that owns units 2j and 2j+1; it sums rows
    ``l·4NK .. (l+1)·4NK`` of Wh (zero rows past H) against the group's eight
    columns, column m being gate ``m % 4`` of unit ``2j + m // 4``:

        packed[g, 8·k4 + m, p, r] = wh[g, l·4NK + 4·k4 + r, (m % 4)·H + 2j + m // 4].
    """
    g, h_dim, four_h = wh.shape
    nk = -(-h_dim // 32)
    w = torch.nn.functional.pad(wh, (0, 0, 0, 32 * nk - h_dim))
    w = w.reshape(g, 8, nk, 4, 4, h_dim // 2, 2)  # [g, l, k4, r, gate, j, unit of the pair]
    return w.permute(0, 2, 6, 4, 5, 1, 3).reshape(g, 8 * nk, four_h, 4).contiguous()


def _pack_wh_t(wh: torch.Tensor) -> torch.Tensor:
    """(G, H, 4H) → (G, H/4, 4H, 4) for ``dz @ Whᵀ``: thread p of a block
    reads row ``p // 4`` of Wh, columns ``(p % 4) * H + 4j .. 4j + 3`` as the
    j-th float4: packed[g, j, p, r] = wh[g, p // 4, (p % 4) * H + 4j + r]."""
    g, h_dim, four_h = wh.shape
    w = wh.reshape(g, h_dim, 4, h_dim // 4, 4)  # [g, u, q, j, r]
    return w.permute(0, 3, 1, 2, 4).reshape(g, h_dim // 4, four_h, 4).contiguous()


def _kernel_shape(gates: torch.Tensor) -> Tuple[int, int, int, int]:
    t_len, g, b, four_h = gates.shape
    h_dim = four_h // 4
    if h_dim % 8 or h_dim > 128:
        raise ValueError(f"the CUDA LSTM kernels take H % 8 == 0 and H <= 128, got H={h_dim}")
    return t_len, g, b, h_dim


def _contiguous(**tensors: torch.Tensor) -> None:
    for name, x in tensors.items():
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _tile(g: int, b: int, device: torch.device, batch_tile: int, largest: int) -> int:
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    return batch_tile or _pick_batch_tile(g, b, n_sms, largest)


def _launch(gates: torch.Tensor, wh: torch.Tensor, batch_tile: int = 0,
            save_c: bool = False):
    """Launch the forward kernel on (T, G, B, 4H) + (G, H, 4H) CUDA tensors:
    hs, or (hs, cs) with ``save_c``. Its batch tile is 1 or 2 (0: chosen from
    the shape); neither the tile nor ``save_c`` changes a row's arithmetic."""
    t_len, g, b, h_dim = _kernel_shape(gates)
    _contiguous(gates=gates)
    hs = torch.empty((t_len, g, b, h_dim), device=gates.device, dtype=torch.float32)
    cs = torch.empty_like(hs) if save_c else None
    if hs.numel():
        tile = _tile(g, b, gates.device, batch_tile, SCAN_LARGEST_TILE)
        if save_c:
            _call("lstm_scan", "lstm_scan_fwd_res_grouped_f32", gates.device,
                  gates, _pack_wh(wh), hs, cs, t_len, g, b, h_dim, tile)
        else:
            _call("lstm_scan", "lstm_scan_grouped_f32", gates.device,
                  gates, _pack_wh(wh), hs, t_len, g, b, h_dim, tile)
    return (hs, cs) if save_c else hs


def _launch_sweep(dgates, cs, wh, dhout, batch_tile: int = 0) -> None:
    """Launch the reverse sweep on CUDA tensors, in place: ``dgates`` comes
    in holding the activated gates (T, G, B, 4H) and leaves holding dz. Its
    batch tile is 1, 2 or 4: the kernel keeps part of Whᵀ in registers, and
    eight rows' state beside it would spill."""
    t_len, g, b, h_dim = _kernel_shape(dgates)
    _contiguous(dgates=dgates, cs=cs, dhout=dhout)
    if dgates.numel():
        _call("lstm_train", "lstm_bwd_sweep_grouped_f32", dgates.device,
              dgates, cs, dhout, _pack_wh_t(wh), t_len, g, b, h_dim,
              _tile(g, b, dgates.device, batch_tile, SWEEP_LARGEST_TILE))


def _unsupported(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")


def lstm_scan_grouped(gates: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """K1: (T, G, B, 4H) + (G, H, 4H) → (T, G, B, H), one launch on CUDA."""
    _check(gates, wh, 4)
    if gates.device.type == "cpu":
        return lstm_scan_reference_grouped(gates, wh)
    _unsupported(gates)
    hs = _launch(gates, wh)
    lstm_scan_grouped.launches += 1
    return hs


def lstm_scan(gates: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """K2: (T, B, 4H) + (H, 4H) → (T, B, H); the K1 kernel at G = 1."""
    _check(gates, wh, 3)
    if gates.device.type == "cpu":
        return lstm_scan_reference(gates, wh)
    _unsupported(gates)
    hs = _launch(gates[:, None], wh[None])[:, 0]
    lstm_scan.launches += 1
    return hs


def lstm_scan_fwd_res_grouped(
    gates: torch.Tensor, wh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (T, G, B, 4H) + (G, H, 4H) → hs, cs (T, G, B, H), one launch on CUDA."""
    _check(gates, wh, 4, cpu_float64=True)
    if gates.device.type == "cpu":
        return lstm_scan_fwd_res_reference_grouped(gates, wh)
    _unsupported(gates)
    out = _launch(gates, wh, save_c=True)
    lstm_scan_fwd_res_grouped.launches += 1
    return out


# csrc/lstm_train.cu's kDwhRows and kDwhCols: rows the dWh kernel stages at a
# time, and columns of dWh[g] a block owns
DWH_CHUNK = 32
DWH_COLS = 128


def _dwh_split(n_rows: int, g: int, h_dim: int, n_sms: int = 132) -> Tuple[int, int]:
    """How the dWh kernel cuts the ``n_rows = (T-1)·B`` rows of a direction:
    (slices, rows a slice). Slice ``s`` sums rows ``s·rows .. min(n_rows,
    (s+1)·rows)``; each of the ``⌈4H/128⌉·G`` output tiles gets one block a
    slice, so the slices are as many as keep all blocks within one wave of
    the SMs, never more than there are chunks of rows, and a slice is whole
    chunks (only the last one may end short). No rows: one empty slice, whose
    blocks write zeros."""
    if n_rows <= 0:
        return 1, 0
    tiles = -(-4 * h_dim // DWH_COLS) * g
    chunks = -(-n_rows // DWH_CHUNK)
    slices = max(1, min(n_sms // tiles, chunks))
    rows = -(-chunks // slices) * DWH_CHUNK
    return -(-n_rows // rows), rows


# csrc/lstm_train.cu's kActRows, kActCols, kActK, kActStages and kActLd:
# the pre-pass's row tile, column group, chunk of k, ring depth and padded
# hs row (floats)
ACTS_ROWS = 128
ACTS_COLS = 128
ACTS_K = 32
ACTS_STAGES = 3
ACTS_LD = ACTS_K + 4


class GateActsPlan(NamedTuple):
    """How the pre-pass's launch walks its items (column group, row tile):
    block ``i`` takes items ``i·per .. min(items, (i+1)·per)``, column
    groups outermost; ``smem_bytes`` is a block's dynamic shared memory."""

    grid: int
    per: int
    row_tiles: int
    col_tiles: int
    smem_bytes: int


def _acts_plan(n_rows: int, g: int, h_dim: int, n_sms: int = 132) -> GateActsPlan:
    """The plan the pre-pass's C launcher makes for ``n_rows = T·B`` rows
    (``lstm_gate_acts_grid`` and ``lstm_gate_acts_smem_bytes`` of the kernel
    file): a block's shared memory holds Wh's column tile (k padded to whole
    chunks), the ring of hs chunks and the tile's gate inputs, so an SM holds
    one block, and the items are spread over at most ``n_sms`` blocks, as
    few a block as that allows."""
    row_tiles = -(-n_rows // ACTS_ROWS)
    col_tiles = -(-4 * h_dim // ACTS_COLS)
    items = g * col_tiles * row_tiles
    per = max(1, -(-items // n_sms))
    k_rows = -(-h_dim // ACTS_K) * ACTS_K
    smem = 4 * (k_rows * ACTS_COLS + ACTS_STAGES * ACTS_ROWS * ACTS_LD + ACTS_ROWS * ACTS_COLS)
    return GateActsPlan(-(-items // per), per, row_tiles, col_tiles, smem)


def lstm_dwh_grouped(hs: torch.Tensor, dgates: torch.Tensor) -> torch.Tensor:
    """dWh (G, H, 4H) = Σ over t ≥ 1 and b of hs[t-1]ᵀ dgates[t]; hs
    (T, G, B, H), dgates (T, G, B, 4H). On CUDA the hand-written split
    product (not a library product): one launch that sums each slice of the
    rows (:func:`_dwh_split`) into its own partial dWh, and, with more than
    one slice, one that adds the partial sums in slice order, so the result
    is the same bits on every call."""
    _check_like(dgates, hs=hs)
    if dgates.device.type == "cpu":
        return lstm_dwh_reference_grouped(hs, dgates)
    _unsupported(dgates)
    if dgates.dtype != torch.float32:
        raise TypeError(f"expected float32, got {dgates.dtype}")
    t_len, g, b, h_dim = _kernel_shape(dgates)
    _contiguous(hs=hs, dgates=dgates)
    dwh = torch.empty((g, h_dim, 4 * h_dim), device=dgates.device, dtype=torch.float32)
    if dwh.numel():
        n_sms = torch.cuda.get_device_properties(dgates.device).multi_processor_count
        slices, rows = _dwh_split((t_len - 1) * b, g, h_dim, n_sms)
        partial = dwh if slices == 1 else torch.empty(
            (slices, *dwh.shape), device=dgates.device, dtype=torch.float32)
        _call("lstm_train", "lstm_dwh_grouped_f32", dgates.device,
              hs, dgates, partial, dwh, t_len, g, b, h_dim, slices, rows)
    lstm_dwh_grouped.launches += 1
    return dwh


def lstm_gate_acts_grouped(
    gates: torch.Tensor, hs: torch.Tensor, wh: torch.Tensor
) -> torch.Tensor:
    """K4's pre-pass: the activated gates i, f, g, o of every step at once,
    gates (T, G, B, 4H), hs (T, G, B, H), wh (G, H, 4H) → (T, G, B, 4H).
    On CUDA one launch of the hand-written fp32 product (not a library
    product): persistent blocks over the items of :func:`_acts_plan`."""
    _check(gates, wh, 4, cpu_float64=True)
    _check_like(gates, hs=hs)
    if gates.device.type == "cpu":
        return lstm_gate_acts_reference_grouped(gates, hs, wh)
    _unsupported(gates)
    t_len, g, b, h_dim = _kernel_shape(gates)
    _contiguous(gates=gates, hs=hs)
    acts = torch.empty_like(gates)
    if acts.numel():
        _call("lstm_train", "lstm_gate_acts_grouped_f32", gates.device,
              gates, hs, wh.contiguous(), acts, t_len, g, b, h_dim)
    lstm_gate_acts_grouped.launches += 1
    return acts


# the pre-pass's profile build: SM clocks a block (thread 0's clock64), the
# block's total and then each phase summed over its items
GATE_ACTS_PHASES = ("wait", "item", "fma", "epilogue", "copies")


def lstm_gate_acts_profile(
    gates: torch.Tensor, hs: torch.Tensor, wh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pre-pass's profile build on CUDA tensors: its output (equal to
    :func:`lstm_gate_acts_grouped`'s) and a (grid, 6) int64 tensor of SM
    clocks a block of :func:`_acts_plan`'s grid: the total, then waiting for
    a chunk, an item's start, the FMAs, the epilogue and issuing a chunk's
    copies (:data:`GATE_ACTS_PHASES`). For measurement only: not counted in
    ``lstm_gate_acts_grouped.launches``, and there is no plain version (it
    raises on CPU tensors)."""
    _check(gates, wh, 4)
    _check_like(gates, hs=hs)
    _unsupported(gates)
    t_len, g, b, h_dim = _kernel_shape(gates)
    _contiguous(gates=gates, hs=hs)
    n_sms = torch.cuda.get_device_properties(gates.device).multi_processor_count
    plan = _acts_plan(t_len * b, g, h_dim, n_sms)
    acts = torch.empty_like(gates)
    prof = torch.zeros((plan.grid, 1 + len(GATE_ACTS_PHASES)), dtype=torch.int64,
                       device=gates.device)
    if acts.numel():
        _call("lstm_train", "lstm_gate_acts_profile_f32", gates.device,
              gates, hs, wh.contiguous(), acts, prof, t_len, g, b, h_dim)
    return acts, prof


def lstm_scan_bwd_grouped(
    gates: torch.Tensor, hs: torch.Tensor, cs: torch.Tensor, wh: torch.Tensor,
    dhout: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: the reverse sweep → dgates (T, G, B, 4H), dwh (G, H, 4H).

    On CUDA: :func:`lstm_gate_acts_grouped` fills dgates with the activated
    gates, one launch of the sweep turns them into dz in place, then
    :func:`lstm_dwh_grouped`.
    """
    _check(gates, wh, 4, cpu_float64=True)
    _check_like(gates, hs=hs, cs=cs, dhout=dhout)
    if gates.device.type == "cpu":
        return lstm_scan_bwd_reference_grouped(gates, hs, cs, wh, dhout)
    _unsupported(gates)
    dgates = lstm_gate_acts_grouped(gates, hs, wh)
    _launch_sweep(dgates, cs, wh, dhout)
    lstm_scan_bwd_grouped.launches += 1
    return dgates, lstm_dwh_grouped(hs, dgates)


class LSTMRecurrenceGrouped(torch.autograd.Function):
    """K5: the differentiable grouped recurrence, gates (T, G, B, 4H) and
    wh (G, H, 4H) → hs (T, G, B, H). The forward runs K3 and saves hs and
    cs; the backward runs K4. (``lstm_recurrence_grouped``'s custom_vjp in
    the JAX package.)"""

    @staticmethod
    def forward(ctx, gates: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
        hs, cs = lstm_scan_fwd_res_grouped(gates, wh)
        ctx.save_for_backward(gates, wh, hs, cs)
        return hs

    @staticmethod
    def backward(ctx, dhs: torch.Tensor):
        gates, wh, hs, cs = ctx.saved_tensors
        return lstm_scan_bwd_grouped(gates, hs, cs, wh, dhs.contiguous())


def lstm_recurrence_grouped(gates: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """K5: differentiable (T, G, B, 4H) + (G, H, 4H) → (T, G, B, H)."""
    return LSTMRecurrenceGrouped.apply(gates, wh)


def lstm_recurrence(gates: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """K5 at G = 1: differentiable (T, B, 4H) + (H, 4H) → (T, B, H)."""
    _check(gates, wh, 3, cpu_float64=True)
    return LSTMRecurrenceGrouped.apply(gates[:, None], wh[None])[:, 0]


lstm_scan_grouped.launches = 0
lstm_scan.launches = 0
lstm_scan_fwd_res_grouped.launches = 0
lstm_gate_acts_grouped.launches = 0
lstm_scan_bwd_grouped.launches = 0
lstm_dwh_grouped.launches = 0
