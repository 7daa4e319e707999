"""Device kernels launched in the traced window (copies and memsets left
out) per lane step, the steps counted from K3's launch counter."""


def read(ctx):
    steps = ctx.work.get("lane_steps", 0)
    if ctx.trace is None or steps <= 0:
        return None
    return ctx.trace.kernel_count() / steps
