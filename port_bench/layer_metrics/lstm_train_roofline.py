"""The training recurrence's share of its roofline: K3 (the forward scan
saving c) and K4 (gate pre-pass, reverse sweep, dWh's partial products and
reduce), their least times (``peaks.lstm_bound_ms`` with c saved, plus
``peaks.lstm_bwd_bound_ms``, at the rows' real lengths) over their device
time by kernel name."""

KERNELS = ("lstm_gate_acts_kernel", "lstm_bwd_sweep_kernel", "lstm_dwh_partial_kernel",
           "lstm_dwh_reduce_kernel")


def is_train_lstm(name: str) -> bool:
    if "lstm_scan_grouped_kernel" in name:
        return "true" in name
    return any(k in name for k in KERNELS)


def read(ctx):
    bound_ms = ctx.work.get("lstm_train_bound_ms")
    seconds = ctx.trace.kernel_s(is_train_lstm) if ctx.trace is not None else 0.0
    if not bound_ms or seconds <= 0:
        return None
    return 100.0 * bound_ms / 1e3 / seconds
