"""Share of the traced window in which the device idled while the host
copied downloads out of pinned memory (``w2v2.fetch``'s self time, its
wait left out), dequantised and trimmed them (``w2v2.assemble``) or stacked
each file's chunks (``w2v2.stack``)."""

from port_bench.spans import idle_pct

SPANS = ("w2v2.fetch", "w2v2.assemble", "w2v2.stack")


def read(ctx):
    return idle_pct(ctx.trace, SPANS)
