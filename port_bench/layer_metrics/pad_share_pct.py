"""Share of the samples the Wav2Vec2 encoder ran on that were padding: the
program's counters ``w2v2.pad_samples`` over it plus ``w2v2.samples``,
which count only while tracing is on, so in a traced run the window's
batches alone."""


def read(ctx):
    try:
        from robust_speech_analysis_framework_tpu_torch.utils.profiling import counters
    except ImportError:  # a program without counters
        return None
    seen = counters()
    real, pad = seen.get("w2v2.samples", 0), seen.get("w2v2.pad_samples", 0)
    if real <= 0:
        return None
    return 100.0 * pad / (real + pad)
