"""The convolutions' share of the device's busy time: device time under
the convolution ops and their backward, by the profiler's attribution of
kernels to the host op that launched them."""

OPS = ("aten::convolution", "aten::_convolution", "aten::cudnn_convolution",
       "aten::convolution_backward", "aten::cudnn_convolution_backward")


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    conv_s = t.op_device_s(OPS)
    busy = t.busy_s
    if conv_s is None or busy <= 0:
        return None
    return 100.0 * conv_s / busy
