"""Mean host wall milliseconds of a train step under the profiler (the span
``train.step`` inside ``Trainer.train_step_lanes``). It holds the time to
queue the step's kernels, the profiler's own cost per op, and any time the
host spent blocked in a CUDA runtime call, as when the launch queue is
full: it is an upper bound on the step's launch cost, not that cost."""

from port_bench.spans import durations_us


def read(ctx):
    if ctx.trace is None:
        return None
    walls = durations_us(ctx.trace, "train.step")
    if not walls:
        return None
    return sum(walls) / len(walls) / 1e3
