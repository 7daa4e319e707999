"""The Conformer's relative-position score kernel's share of its roofline:
the stage's least time over the window's chunks
(``conformer_counts.relpos_score_bound_ms``: the larger of 8 bytes a real
(query, key) pair, head and layer at the HBM rate and the pair's position dot
product at the fp32 peak) over the device time of the kernels named
``conformer_relpos_softmax_kernel``. Padded pairs are not counted in the
bound, so padding caps the share."""


def is_relpos_score(name: str) -> bool:
    return "conformer_relpos_softmax_kernel" in name


def read(ctx):
    bound_ms = ctx.work.get("relpos_score_bound_ms")
    seconds = ctx.trace.kernel_s(is_relpos_score) if ctx.trace is not None else 0.0
    if not bound_ms or seconds <= 0:
        return None
    return 100.0 * bound_ms / 1e3 / seconds
