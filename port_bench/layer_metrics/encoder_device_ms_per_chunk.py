"""Device busy milliseconds per Wav2Vec2 chunk encoded in the traced
window, the chunks counted from the waveforms' lengths."""


def read(ctx):
    chunks = ctx.work.get("chunks", 0)
    busy = ctx.trace.busy_s if ctx.trace is not None else 0.0
    if chunks <= 0 or busy <= 0:
        return None
    return 1e3 * busy / chunks
