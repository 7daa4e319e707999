"""The benchmark's reading of the program's spans and counters on the CPU:
a span opened inside ``trace.profiled`` is a host op of the ``Trace``;
``spans.py`` and the seven span and counter readers give the values worked
out by hand on hand-built traces with known gaps and nested spans, and
nothing where the program has no spans (an older commit); the padding
share at the extraction cell's own lengths."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from port_bench import run as harness
from port_bench import spans as bench_spans
from port_bench.common import fixed_lengths
from port_bench.tests.tiny import REPO
from port_bench.trace import Trace, profiled
from robust_speech_analysis_framework_tpu_torch.features.wav2vec2 import Wav2Vec2Extractor
from robust_speech_analysis_framework_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from robust_speech_analysis_framework_tpu_torch.utils import profiling

READERS = ("input_idle_pct.extract", "output_idle_pct.extract", "wait_idle_pct.extract",
           "pad_share_pct.extract", "host_ms_per_step.train", "epoch_idle_pct.train",
           "round_idle_pct.train")


@pytest.fixture(autouse=True)
def clean_tables():
    profiling.span_report(reset=True)
    profiling.counters(reset=True)
    yield
    profiling.span_report(reset=True)
    profiling.counters(reset=True)


def test_span_inside_profiled_is_a_host_op_of_the_trace():
    """The span reads ``torch.autograd.profiler._is_profiler_enabled``: true
    while ``trace.profiled`` records, so the span opens a ``record_function``
    that ``reduce`` keeps among the host ops, nested as it ran and on the
    caller's thread."""
    assert torch.autograd.profiler._is_profiler_enabled is False
    with profiled() as out:
        assert torch.autograd.profiler._is_profiler_enabled is True
        with profiling.span("w2v2.fetch"):
            with profiling.span("w2v2.wait"):
                torch.ones(8).add_(1)
        profiling.count("w2v2.samples", 4)
    assert torch.autograd.profiler._is_profiler_enabled is False
    ops = {name: (thread, a, b) for name, thread, a, b in out["trace"].host_ops
           if name.startswith("w2v2.")}
    assert set(ops) == {"w2v2.fetch", "w2v2.wait"}
    (t_out, a_out, b_out), (t_in, a_in, b_in) = ops["w2v2.fetch"], ops["w2v2.wait"]
    assert t_out == t_in and a_out <= a_in < b_in <= b_out
    assert profiling.counters() == {"w2v2.samples": 4}


def _extract_trace() -> Trace:
    """Device busy 0–100, 300–400, 700–1000 µs (gaps 100–300, 400–700). Input
    spans on two threads overlap (their union counts once); ``w2v2.wait``
    nests in ``w2v2.fetch``; an op that is not the program's takes nothing
    from ``w2v2.upload``."""
    host = [("w2v2.extract", 1, 0.0, 1000.0), ("w2v2.gather", 1, 20.0, 90.0),
            ("w2v2.pack", 1, 120.0, 180.0), ("w2v2.upload", 1, 180.0, 250.0),
            ("aten::copy_", 1, 190.0, 200.0), ("w2v2.pack", 2, 200.0, 260.0),
            ("w2v2.fetch", 1, 420.0, 600.0), ("w2v2.wait", 1, 450.0, 550.0),
            ("w2v2.assemble", 1, 600.0, 650.0), ("w2v2.stack", 1, 650.0, 800.0)]
    kernels = [("k", 0.0, 100.0), ("k", 300.0, 400.0), ("Memcpy DtoH", 700.0, 1000.0)]
    return Trace(0.0, 1000.0, kernels, sorted(host, key=lambda s: s[2]))


def _train_trace() -> Trace:
    """Device busy 0–100, 200–300, 600–1000 µs (gaps 100–200, 300–600); a
    round: init, operands, an epoch of two steps, its fetch and books, the
    eval and the wait for its logits."""
    host = [("train.trials", 7, 0.0, 1000.0), ("train.init", 7, 0.0, 150.0),
            ("train.operands", 7, 150.0, 180.0), ("train.epoch", 7, 180.0, 500.0),
            ("train.step", 7, 180.0, 230.0), ("train.step", 7, 230.0, 290.0),
            ("train.val", 7, 290.0, 320.0), ("train.fetch", 7, 320.0, 400.0),
            ("train.books", 7, 400.0, 450.0), ("train.eval", 7, 500.0, 560.0),
            ("fetch.wait", 7, 560.0, 620.0)]
    kernels = [("k", 0.0, 100.0), ("k", 200.0, 300.0), ("k", 600.0, 1000.0)]
    return Trace(0.0, 1000.0, kernels, sorted(host, key=lambda s: s[2]))


def test_self_intervals_leave_out_nested_spans():
    own = bench_spans.self_intervals(bench_spans.program_spans(_extract_trace()))
    assert own["w2v2.fetch"] == [(420.0, 450.0), (550.0, 600.0)]
    assert own["w2v2.wait"] == [(450.0, 550.0)]
    assert own["w2v2.upload"] == [(180.0, 250.0)]
    assert own["w2v2.extract"] == [(0.0, 20.0), (90.0, 120.0), (250.0, 420.0), (800.0, 1000.0)]
    # its own time in the gaps: 100–120, 250–300 and 400–420
    assert bench_spans.idle_s(_extract_trace(), ("w2v2.extract",)) == pytest.approx(90.0 / 1e6)


@pytest.mark.parametrize("metric, trace, expected", [
    ("input_idle_pct.extract", _extract_trace, 14.0),  # 120–260 under pack ∪ upload ∪ pack
    ("output_idle_pct.extract", _extract_trace, 18.0),  # fetch's own 30 + 50, assemble 50, stack 50
    ("wait_idle_pct.extract", _extract_trace, 10.0),
    ("host_ms_per_step.train", _train_trace, 0.055),  # steps of 50 and 60 µs
    ("epoch_idle_pct.train", _train_trace, 13.0),  # fetch 80, books 50
    ("round_idle_pct.train", _train_trace, 18.0),  # init 50, operands 30, eval 60, wait 40
])
def test_span_readers_on_a_hand_built_trace(metric, trace, expected):
    read = harness.reader_for(metric, REPO)
    assert read(SimpleNamespace(trace=trace(), work={})) == pytest.approx(expected, rel=1e-12)


def test_pad_share_reads_the_counters():
    read = harness.reader_for("pad_share_pct.extract", REPO)
    with profiling.tracing():
        profiling.count("w2v2.samples", 300)
        profiling.count("w2v2.pad_samples", 100)
    assert read(SimpleNamespace(trace=None, work={})) == pytest.approx(25.0)


@pytest.mark.parametrize("metric", READERS)
def test_readers_give_nothing_without_the_programs_spans(metric):
    """As on a commit before the spans: host ops and kernels, no span, no
    counter; and no trace at all."""
    read = harness.reader_for(metric, REPO)
    bare = Trace(0.0, 1000.0, [("k", 0.0, 100.0)],
                 [("aten::mm", 1, 10.0, 90.0), ("python", 1, 200.0, 300.0)])
    assert read(SimpleNamespace(trace=bare, work={})) is None
    assert read(SimpleNamespace(trace=None, work={})) is None


def test_pad_share_at_the_extraction_cells_lengths():
    """The cell's lengths are the same for every seed: 253 chunks in 16
    batches of 16 × 80,000 samples, 14.78 % of them padding. Packed (not
    encoded) by the program, counted by its counters, read by the reader."""
    small = Wav2Vec2Config(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                           conv_dim=(16,) * 7, pos_conv_kernel=16, pos_conv_groups=4)
    with pytest.warns(UserWarning, match="RANDOM"):
        ex = Wav2Vec2Extractor(config=small, allow_random_init=True, seed=3, device="cpu",
                               batch_size=16)
    mix = {"reading": [8, 20.0, 88.0], "interview": [64, 3.0, 12.0]}
    silent = {f"f{i:03d}": np.broadcast_to(np.float32(0.0), int(s * 16000))
              for i, s in enumerate(fixed_lengths(mix, 2**31 + 5, 6))}
    with profiling.tracing():
        _, _, data = ex._gather_chunks(silent, verbose=False)
        for start in range(0, len(data), ex.batch_size):
            ex._pack(data, range(start, min(start + ex.batch_size, len(data))))
    assert len(data) == 253 and profiling.span_report()["w2v2.pack"]["calls"] == 16
    share = harness.reader_for("pad_share_pct.extract", REPO)(SimpleNamespace(trace=None))
    assert round(share, 2) == 14.78
