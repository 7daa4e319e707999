"""The Conformer's conv modules' share of the device's busy time: device time
of the kernels queued from inside the program's ``conformer.conv_module``
spans (the launching call's thread and time), over busy time. None where no
such span ran (a program without the Conformer, or one whose spans are off)."""


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    conv_s = t.op_device_s(["conformer.conv_module"])
    busy = t.busy_s
    if conv_s is None or busy <= 0:
        return None
    return 100.0 * conv_s / busy
