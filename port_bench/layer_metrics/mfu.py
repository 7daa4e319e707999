"""The whole window's share of the card's float32 peak: the model FLOPs
the window's inputs need (``port_bench/flops.py``, real lengths) over the
traced window's seconds and the published 67 TFLOP/s."""

from port_bench.peaks import PEAK_FP32_FLOPS


def read(ctx):
    t, flops = ctx.trace, ctx.work.get("flops", 0.0)
    if t is None or t.window_s <= 0 or not flops:
        return None
    return 100.0 * flops / t.window_s / PEAK_FP32_FLOPS
