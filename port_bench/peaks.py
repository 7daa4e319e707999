"""The yardstick's fixed arithmetic: published H100 peaks and the least time
each hand-written LSTM kernel could take.

Frozen copies of the smoke test's ``bound_ms``, ``lstm_bound_ms``,
``lstm_bwd_bound_ms``, ``gate_acts_bound_ms`` and ``dwh_bound_ms``
(``chip_smoke.py``), kept here so that a change to the program cannot move
the bounds it is measured against.
"""

from __future__ import annotations

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def bound_ms(bytes_moved: float, ops: float) -> tuple:
    """The larger of bytes over the HBM rate and operations over the fp32
    CUDA-core peak, with which of the two it is."""
    t_bytes = bytes_moved / PEAK_HBM_BYTES * 1e3
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def lstm_bound_ms(t: int, g: int, b: int, h: int, save_c: bool = False) -> tuple:
    """Least time for the recurrence (K1/K2; K3 with ``save_c``): gates in,
    Wh in, hs (and cs) out once; per row and step a (H × 4H) matvec (2 ops a
    term), the gate add (4H) and the cell update (about 5H)."""
    n_out = 2 if save_c else 1
    bytes_moved = 4 * (t * g * b * 4 * h + g * h * 4 * h + n_out * t * g * b * h)
    return bound_ms(bytes_moved, t * g * b * (2 * h * 4 * h + 4 * h + 5 * h))


def lstm_bwd_bound_ms(t: int, g: int, b: int, h: int) -> tuple:
    """Least time for the reverse sweep with dWh (K4): gates, hs, cs, dhout
    and Wh in, dgates and dWh out once; per row and step three (H × 4H)
    products (z recomputed, dz @ Whᵀ, the dWh term) and about 25H of
    elementwise work."""
    bytes_moved = 4 * (2 * t * g * b * 4 * h + 3 * t * g * b * h + 2 * g * h * 4 * h)
    return bound_ms(bytes_moved, t * g * b * (3 * 2 * h * 4 * h + 25 * h))


def gate_acts_bound_ms(t: int, g: int, b: int, h: int) -> tuple:
    """Least time for K4's gate pre-pass: gates, hs and Wh in, the activated
    gates out once; per row and step one (H × 4H) product, the gate add (4H)
    and about four operations an activation."""
    bytes_moved = 4 * (2 * t * g * b * 4 * h + t * g * b * h + g * h * 4 * h)
    return bound_ms(bytes_moved, t * g * b * (2 * h * 4 * h + 4 * h + 4 * 4 * h))


def dwh_bound_ms(t: int, g: int, b: int, h: int) -> tuple:
    """Least time for dWh alone: hs and dgates in, dWh out once; one
    (H × 4H) outer product per row and step after the first."""
    bytes_moved = 4 * (t * g * b * h + t * g * b * 4 * h + g * h * 4 * h)
    return bound_ms(bytes_moved, 2 * (t - 1) * g * b * h * 4 * h)
