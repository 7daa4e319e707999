"""Share of the traced window in which the device idled at the end of an
epoch: the one fetch of the lanes' losses (``train.fetch``) and their
books, rates and snapshots (``train.books``)."""

from port_bench.spans import idle_pct

SPANS = ("train.fetch", "train.books")


def read(ctx):
    return idle_pct(ctx.trace, SPANS)
