"""Share of the traced window in which the device idled between a round's
epochs and around them: the lanes' start (``train.init``), the fold's
operands (``train.operands``), queueing the eval pass (``train.eval``) and
waiting for its logits (``fetch.wait``)."""

from port_bench.spans import idle_pct

SPANS = ("train.init", "train.operands", "train.eval", "fetch.wait")


def read(ctx):
    return idle_pct(ctx.trace, SPANS)
