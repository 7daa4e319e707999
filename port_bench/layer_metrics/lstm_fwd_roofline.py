"""K1's share of its roofline: the sum of its launches' least times
(``peaks.lstm_bound_ms`` at the rows' real lengths) over its device time,
by kernel name (the forward scan built without saving c)."""


def is_k1(name: str) -> bool:
    return "lstm_scan_grouped_kernel" in name and "true" not in name


def read(ctx):
    bound_ms = ctx.work.get("lstm_fwd_bound_ms")
    seconds = ctx.trace.kernel_s(is_k1) if ctx.trace is not None else 0.0
    if not bound_ms or seconds <= 0:
        return None
    return 100.0 * bound_ms / 1e3 / seconds
