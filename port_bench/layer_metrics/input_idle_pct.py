"""Share of the traced window in which the device idled while the host
chunked, packed or uploaded Wav2Vec2 batches (self time of the spans
``w2v2.gather``, ``w2v2.pack`` and ``w2v2.upload``)."""

from port_bench.spans import idle_pct

SPANS = ("w2v2.gather", "w2v2.pack", "w2v2.upload")


def read(ctx):
    return idle_pct(ctx.trace, SPANS)
