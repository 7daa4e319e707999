"""Share of the traced window in which nothing ran on the device: kernels
and copies merged into one busy interval set."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
