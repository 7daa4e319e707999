"""LSTM recurrence: the hand-written CUDA kernel and its plain PyTorch version.

Counterpart of ``robust_speech_analysis_framework_tpu/ops/pallas/lstm.py``
(inference half). The input projections ``x @ Wx + b`` for all gates and
time steps are one large matmul outside the kernel; the kernel runs the
strictly sequential part,

    z_t = g_t + h_{t-1} @ Wh;   (i, f, g, o) = split(z_t);   c, h update,

with the whole time loop inside one launch (``csrc/lstm_scan.cu``).

* :func:`lstm_scan_grouped` (K1): gates (T, G, B, 4H), wh (G, H, 4H) →
  hs (T, G, B, H); G recurrences in lockstep (both directions of a biLSTM
  layer in one launch).
* :func:`lstm_scan` (K2): the same kernel at G = 1; gates (T, B, 4H),
  wh (H, 4H) → hs (T, B, H).

Like the TPU kernel, neither freezes state past a sequence's length: the
padded tail computes values that callers never read.

Dispatch goes by the tensors' device: CPU tensors take the plain version,
CUDA tensors launch the kernel or raise. There is no fallback between them.
Each wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes

import torch


def lstm_scan_reference_grouped(gates: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch recurrence: (T, G, B, 4H) + (G, H, 4H) → (T, G, B, H)."""
    t_len, g, b, four_h = gates.shape
    h_dim = four_h // 4
    h = gates.new_zeros((g, b, h_dim))
    c = gates.new_zeros((g, b, h_dim))
    out = gates.new_empty((t_len, g, b, h_dim))
    for t in range(t_len):
        z = gates[t] + torch.bmm(h, wh)
        i = torch.sigmoid(z[..., :h_dim])
        f = torch.sigmoid(z[..., h_dim : 2 * h_dim])
        g_ = torch.tanh(z[..., 2 * h_dim : 3 * h_dim])
        o = torch.sigmoid(z[..., 3 * h_dim :])
        c = f * c + i * g_
        h = o * torch.tanh(c)
        out[t] = h
    return out


def lstm_scan_reference(gates: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch recurrence: (T, B, 4H) + (H, 4H) → (T, B, H)."""
    return lstm_scan_reference_grouped(gates[:, None], wh[None])[:, 0]


def _check(gates: torch.Tensor, wh: torch.Tensor, gates_ndim: int) -> None:
    if gates.ndim != gates_ndim or wh.ndim != gates_ndim - 1:
        raise ValueError(
            f"expected gates with {gates_ndim} dims and wh with {gates_ndim - 1}, "
            f"got {tuple(gates.shape)} and {tuple(wh.shape)}"
        )
    if gates.device != wh.device:
        raise ValueError(f"gates on {gates.device} but wh on {wh.device}")
    if gates.dtype != torch.float32 or wh.dtype != torch.float32:
        raise TypeError(f"expected float32, got {gates.dtype} and {wh.dtype}")
    four_h = gates.shape[-1]
    h_dim = four_h // 4
    if four_h != 4 * h_dim or tuple(wh.shape[-2:]) != (h_dim, four_h):
        raise ValueError(
            f"wh {tuple(wh.shape)} does not match gates {tuple(gates.shape)}"
        )


def _pick_batch_tile(g: int, b: int, n_sms: int) -> int:
    """Batch rows per block: the fewest that keep every block on its own SM.

    A step's time is set by the latency of its matvec, not by the rows it
    carries, so more blocks go faster until they outnumber the SMs.
    """
    tile = 1
    while tile < 8 and g * -(-b // tile) > n_sms:
        tile *= 2
    return tile


def _pack_wh(wh: torch.Tensor) -> torch.Tensor:
    """(G, H, 4H) → (G, H/4, 4H, 4): thread p of a block reads column
    ``(p % 4) * H + p // 4`` as one float4 per four rows of Wh."""
    g, h_dim, four_h = wh.shape
    p = torch.arange(four_h, device=wh.device)
    cols = (p % 4) * h_dim + p // 4
    return (
        wh[:, :, cols].reshape(g, h_dim // 4, 4, four_h).transpose(2, 3).contiguous()
    )


def _launch(gates: torch.Tensor, wh: torch.Tensor, batch_tile: int = 0) -> torch.Tensor:
    """Launch the kernel on (T, G, B, 4H) + (G, H, 4H) CUDA tensors."""
    from ._build import load

    t_len, g, b, four_h = gates.shape
    h_dim = four_h // 4
    if h_dim % 8 or h_dim > 128:
        raise ValueError(f"the CUDA LSTM kernel takes H % 8 == 0 and H <= 128, got H={h_dim}")
    if not gates.is_contiguous():
        raise ValueError("gates must be contiguous")
    hs = torch.empty((t_len, g, b, h_dim), device=gates.device, dtype=torch.float32)
    if hs.numel() == 0:
        return hs
    whp = _pack_wh(wh)
    fn = load("lstm_scan").lstm_scan_grouped_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n_sms = torch.cuda.get_device_properties(gates.device).multi_processor_count
    with torch.cuda.device(gates.device):
        stream = torch.cuda.current_stream(gates.device).cuda_stream
        err = fn(
            gates.data_ptr(), whp.data_ptr(), hs.data_ptr(),
            t_len, g, b, h_dim, batch_tile or _pick_batch_tile(g, b, n_sms), stream,
        )
    if err != 0:
        raise RuntimeError(f"lstm_scan_grouped_f32 launch failed: cudaError {err}")
    return hs


def lstm_scan_grouped(gates: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """K1: (T, G, B, 4H) + (G, H, 4H) → (T, G, B, H), one launch on CUDA."""
    _check(gates, wh, 4)
    if gates.device.type == "cpu":
        return lstm_scan_reference_grouped(gates, wh)
    if gates.device.type != "cuda":
        raise ValueError(f"unsupported device {gates.device}")
    hs = _launch(gates, wh)
    lstm_scan_grouped.launches += 1
    return hs


def lstm_scan(gates: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """K2: (T, B, 4H) + (H, 4H) → (T, B, H); the K1 kernel at G = 1."""
    _check(gates, wh, 3)
    if gates.device.type == "cpu":
        return lstm_scan_reference(gates, wh)
    if gates.device.type != "cuda":
        raise ValueError(f"unsupported device {gates.device}")
    hs = _launch(gates[:, None], wh[None])[:, 0]
    lstm_scan.launches += 1
    return hs


lstm_scan_grouped.launches = 0
lstm_scan.launches = 0
