"""Share of the (query, key) pairs the encoder's attention ran on that were
padding: the program's counters ``w2v2.attn_pad_pairs`` over it plus
``w2v2.attn_pairs`` (Σ t² of each batch's real chunks), which count only
while tracing is on, so in a traced run the window's batches alone. A
short last batch's filler rows count as padding."""


def read(ctx):
    try:
        from robust_speech_analysis_framework_tpu_torch.utils.profiling import counters
    except ImportError:  # a program without counters
        return None
    seen = counters()
    real, pad = seen.get("w2v2.attn_pairs", 0), seen.get("w2v2.attn_pad_pairs", 0)
    if real <= 0:
        return None
    return 100.0 * pad / (real + pad)
