"""Share of the traced window in which the device idled while the host
waited for a batch's download (``w2v2.wait``): the extractor's pipeline
ran dry."""

from port_bench.spans import idle_pct

SPANS = ("w2v2.wait",)


def read(ctx):
    return idle_pct(ctx.trace, SPANS)
