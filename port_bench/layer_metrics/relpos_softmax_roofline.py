"""The WavLM relative-position softmax kernel's share of its roofline: its
least time over the window's chunks (``wavlm_counts.relpos_softmax_bound_ms``:
8 bytes a real (query, key) pair, head and layer at the HBM rate) over the
device time of the kernels named ``wavlm_relpos_softmax_kernel``. Padded
pairs are not counted in the bound, so padding caps the share."""


def is_relpos_softmax(name: str) -> bool:
    return "wavlm_relpos_softmax_kernel" in name


def read(ctx):
    bound_ms = ctx.work.get("relpos_softmax_bound_ms")
    seconds = ctx.trace.kernel_s(is_relpos_softmax) if ctx.trace is not None else 0.0
    if not bound_ms or seconds <= 0:
        return None
    return 100.0 * bound_ms / 1e3 / seconds
