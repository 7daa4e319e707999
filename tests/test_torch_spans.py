"""The port's spans and counters (``utils/profiling``), and the spans that
the extractor, the lane trainer, the fetches and the ``Predictor`` open, on
the CPU.

* Off, ``span`` is one shared no-op that reads no clock and enters no
  ``record_function``; ``count`` adds nothing.
* On (a ``tracing()`` block, or a ``torch.profiler`` recording), spans
  aggregate calls, wall and self time, nested per thread; under the
  profiler each span is a ``record_function`` range of the profiler's
  trace.
* The program's spans fire once a batch, step, epoch or call, and its
  outputs are bit-equal with tracing on and off.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from robust_speech_analysis_framework_tpu_torch.audio.io import write_wav
from robust_speech_analysis_framework_tpu_torch.features.wav2vec2 import Wav2Vec2Extractor
from robust_speech_analysis_framework_tpu_torch.models.cnn_lstm import CNNLSTM, build_cnn_lstm
from robust_speech_analysis_framework_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from robust_speech_analysis_framework_tpu_torch.serving import Predictor
from robust_speech_analysis_framework_tpu_torch.train import loops
from robust_speech_analysis_framework_tpu_torch.utils import profiling
from tests.test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)

SMALL = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
             conv_dim=(16,) * 7, pos_conv_kernel=16, pos_conv_groups=4)


@pytest.fixture(autouse=True)
def clean_tables():
    profiling.span_report(reset=True)
    profiling.counters(reset=True)
    assert not _on()
    yield
    profiling.span_report(reset=True)
    profiling.counters(reset=True)


def _on() -> bool:
    """Whether spans record: off, every span is the one shared no-op."""
    return profiling.span("probe") is not profiling.span("probe")


def _calls(report):
    return {name: row["calls"] for name, row in report.items()}


# --- spans and counters ---------------------------------------------------------------


def test_off_span_is_the_shared_noop_and_reads_only_flags(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("called while tracing is off")

    monkeypatch.setattr(profiling, "perf_counter", refuse)
    monkeypatch.setattr(profiling, "record_function", refuse)
    monkeypatch.setattr(profiling, "_Span", refuse)
    first = profiling.span("w2v2.pack")
    assert first is profiling.span("train.step")
    with first, profiling.span("outer"):
        with profiling.span("inner"):
            profiling.count("w2v2.samples", 5)
    assert profiling.span_report() == {} and profiling.counters() == {}


def test_tracing_switches_on_nests_and_restores():
    assert not _on()
    with profiling.tracing():
        with profiling.tracing():
            assert _on()
        assert _on()
        with pytest.raises(ValueError):
            with profiling.tracing():
                raise ValueError("left through an error")
        assert _on()
    assert not _on()


def test_nested_spans_aggregate_per_thread():
    """Thread A opens ``outer`` around two ``inner``; thread B opens ``solo``
    while A's ``outer`` is open. ``solo`` has no parent (a stack a thread),
    so it takes nothing from ``outer``'s self time."""
    both_open = threading.Barrier(2, timeout=30)
    b_done = threading.Event()

    def a():
        with profiling.span("outer"):
            both_open.wait()
            for _ in range(2):
                with profiling.span("inner"):
                    time.sleep(0.01)
            b_done.wait(timeout=30)

    def b():
        both_open.wait()
        with profiling.span("solo"):
            time.sleep(0.05)
        b_done.set()

    with profiling.tracing():
        threads = [threading.Thread(target=fn) for fn in (a, b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    rep = profiling.span_report()
    assert _calls(rep) == {"outer": 1, "inner": 2, "solo": 1}
    assert rep["solo"]["seconds"] >= 0.05 and rep["solo"]["self_seconds"] == rep["solo"]["seconds"]
    assert rep["inner"]["seconds"] >= 0.02 and rep["outer"]["seconds"] >= rep["solo"]["seconds"]
    assert rep["outer"]["self_seconds"] == pytest.approx(
        rep["outer"]["seconds"] - rep["inner"]["seconds"], abs=1e-9)
    assert list(rep)[0] == "outer"  # largest first


def test_concurrent_spans_and_counts_lose_nothing():
    workers, each = 16, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(each):
                with profiling.span("step"):
                    profiling.count("n", 1)
                    profiling.count("m", 2)

        with profiling.tracing():
            threads = [threading.Thread(target=work) for _ in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert profiling.counters() == {"n": workers * each, "m": 2 * workers * each}
    assert profiling.span_report()["step"]["calls"] == workers * each


def test_counters_count_only_while_tracing():
    profiling.count("w2v2.samples", 7)
    assert profiling.counters() == {}
    with profiling.tracing():
        profiling.count("w2v2.samples", 7)
        profiling.count("w2v2.samples")
        profiling.count("w2v2.pad_samples", 3)
    profiling.count("w2v2.samples", 100)
    assert profiling.counters(reset=True) == {"w2v2.samples": 8, "w2v2.pad_samples": 3}
    assert profiling.counters() == {}


def test_span_report_resets():
    with profiling.tracing():
        for _ in range(3):
            with profiling.span("a"):
                pass
    assert _calls(profiling.span_report(reset=True)) == {"a": 3}
    assert profiling.span_report() == {}


def test_span_under_the_profiler_is_a_range_of_its_trace():
    """The span reads ``torch.autograd.profiler._is_profiler_enabled``: true
    while a ``torch.profiler`` records, so the span opens a
    ``record_function`` whose range lies in the profiler's events, nested as
    it ran and on the caller's thread; it records itself besides."""
    from torch.profiler import ProfilerActivity, profile

    assert torch.autograd.profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert torch.autograd.profiler._is_profiler_enabled is True
        assert _on()
        with profiling.span("w2v2.fetch"):
            with profiling.span("w2v2.wait"):
                torch.ones(8).add_(1)
        profiling.count("w2v2.samples", 4)
    assert torch.autograd.profiler._is_profiler_enabled is False
    assert not _on()
    ranges = {e.name: e for e in prof.events() if e.name.startswith("w2v2.")}
    assert set(ranges) == {"w2v2.fetch", "w2v2.wait"}
    outer, inner = ranges["w2v2.fetch"].time_range, ranges["w2v2.wait"].time_range
    assert ranges["w2v2.fetch"].thread == ranges["w2v2.wait"].thread
    assert outer.start <= inner.start < inner.end <= outer.end
    assert _calls(profiling.span_report()) == {"w2v2.fetch": 1, "w2v2.wait": 1}
    assert profiling.counters() == {"w2v2.samples": 4}


def test_spanned_makes_each_call_a_span():
    @profiling.spanned("train.step")
    def step(x, *, scale=2):
        """Doubles."""
        return x * scale

    assert step.__name__ == "step" and step.__doc__ == "Doubles."
    assert step(3) == 6  # off: runs, records nothing
    assert profiling.span_report() == {}
    with profiling.tracing():
        assert [step(i, scale=3) for i in range(4)] == [0, 3, 6, 9]
    assert _calls(profiling.span_report()) == {"train.step": 4}


def test_spanned_off_path_opens_no_span(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("called while tracing is off")

    @profiling.spanned("w2v2.pack")
    def pack():
        return "packed"

    monkeypatch.setattr(profiling, "perf_counter", refuse)
    monkeypatch.setattr(profiling, "record_function", refuse)
    monkeypatch.setattr(profiling, "_Span", refuse)
    assert pack() == "packed"


def test_span_left_through_an_error_is_recorded_and_unwound():
    """A span that an exception leaves is recorded and popped, so the next
    span of the thread has no stale parent."""
    with profiling.tracing():
        with pytest.raises(ValueError):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    raise ValueError("fails inside")
        with profiling.span("after"):
            pass
    rep = profiling.span_report()
    assert _calls(rep) == {"outer": 1, "inner": 1, "after": 1}
    assert rep["after"]["self_seconds"] == rep["after"]["seconds"]
    assert profiling._local.stack == []


# --- the program's spans ---------------------------------------------------------------


def _extractor(**kwargs) -> Wav2Vec2Extractor:
    with pytest.warns(UserWarning, match="RANDOM"):
        return Wav2Vec2Extractor(config=Wav2Vec2Config(**SMALL), allow_random_init=True,
                                 seed=3, device="cpu", **kwargs)


def _waves():
    """At 1 s chunks with 0.5 s overlap (none under 0.5 s kept): 2 + 1 + 2
    chunks; the last file is too short to extract."""
    rng = np.random.default_rng(4)
    return {name: (0.1 * rng.normal(size=n)).astype(np.float32)
            for name, n in (("a", 16000), ("b", 9000), ("c", 20000), ("short", 100))}


def _expected_counts(ex, waves):
    chunks = [len(c) for w in waves.values() if len(w) >= ex.min_samples for c in ex._chunk(w)]
    batches = -(-len(chunks) // ex.batch_size)
    pairs = sum(ex._frames(n) ** 2 for n in chunks)  # attention's (query, key) pairs
    return chunks, batches, {"w2v2.samples": sum(chunks),
                             "w2v2.pad_samples": batches * ex.batch_size * ex.chunk_size
                             - sum(chunks),
                             "w2v2.attn_pairs": pairs,
                             "w2v2.attn_pad_pairs": batches * ex.batch_size
                             * ex._frames(ex.chunk_size) ** 2 - pairs}


ENTRIES = {
    "sequences": lambda ex, w: ex.extract_sequences(w, verbose=False),
    "resident": lambda ex, w: ex.extract_sequences_resident(w, verbose=False, align=16).x,
    "embeddings": lambda ex, w: ex.extract_embeddings_arrays(w, verbose=False)[1],
}


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_extractor_spans_a_batch_and_counts_its_padding(entry):
    ex = _extractor(chunk_seconds=1.0, overlap_seconds=0.5, batch_size=4)
    waves = _waves()
    off = ENTRIES[entry](ex, waves)
    with profiling.tracing():
        on = ENTRIES[entry](ex, waves)
    chunks, batches, counts = _expected_counts(ex, waves)
    assert (len(chunks), batches) == (5, 2)
    want = {"w2v2.extract": 1, "w2v2.gather": 1, "w2v2.pack": batches, "w2v2.upload": batches,
            "w2v2.encode": batches, "w2v2.download": batches, "w2v2.fetch": batches}
    if entry == "sequences":
        want.update({"w2v2.assemble": batches, "w2v2.stack": 1})
        assert sorted(on) == sorted(off) and all(np.array_equal(on[n], off[n]) for n in off)
    elif entry == "resident":
        assert torch.equal(on, off)
    else:
        assert np.array_equal(on, off)
    assert _calls(profiling.span_report()) == want  # no w2v2.wait: nothing is waited for on the CPU
    assert profiling.counters() == counts
    # 8 slots of a chunk, 5 filled
    seen = profiling.counters()
    assert seen["w2v2.samples"] + seen["w2v2.pad_samples"] == 8 * ex.chunk_size


def _split():
    rng = np.random.default_rng(3)
    seqs = [rng.normal(size=(int(rng.integers(16, 40)), 10)).astype(np.float32) for _ in range(12)]
    labels = np.arange(12) % 2
    return seqs[:8], labels[:8], seqs[8:], labels[8:]


def test_lane_trainer_spans_a_round():
    """2 lanes, 2 epochs of 8 rows in batches of 4: 4 steps, each epoch its
    val pass, fetch and books, the books once more at the end; the eval pass
    and the wait for its logits."""
    trainer = loops.Trainer(CNNLSTM(input_dim=10, cnn_out_channels=8, lstm_hidden_dim=8),
                            device="cpu")
    cfg = loops.TrainConfig(learning_rate=1e-3, epochs=2, patience=3, batch_size=4, seed=2,
                            dropout_rate=0.3, use_plateau=False, restore_best=False)
    train_x, train_y, val_x, val_y = _split()

    def round_():
        states, hists = loops.train_trials_device(trainer, train_x, train_y, val_x, val_y, cfg,
                                                  [1e-3, 3e-3], [0.2, 0.4])
        logits = trainer.eval_logits_trials_deferred(states, val_x, cfg).result()
        return hists.result(), logits, states.optimizer.flat.clone()

    off = round_()
    with profiling.tracing():
        on = round_()
    assert on[0] == off[0] and np.array_equal(on[1], off[1]) and torch.equal(on[2], off[2])
    assert _calls(profiling.span_report()) == {
        "train.trials": 1, "train.init": 1, "train.operands": 1, "train.epoch": 2,
        "train.step": 4, "train.val": 2, "train.fetch": 2, "train.books": 3, "train.eval": 1,
        "fetch.wait": 2}  # the histories' ready Deferred and the logits


def test_fold_trainer_spans_its_epochs():
    trainer = loops.Trainer(CNNLSTM(input_dim=10, cnn_out_channels=8, lstm_hidden_dim=8),
                            device="cpu")
    cfg = loops.TrainConfig(learning_rate=1e-3, epochs=2, patience=3, batch_size=4, seed=2,
                            dropout_rate=0.3)
    off = loops.train_model(trainer, *_split(), cfg)
    with profiling.tracing():
        on = loops.train_model(trainer, *_split(), cfg)
    assert on[1:] == off[1:]
    for name, v in off[0].model.state_dict().items():
        assert torch.equal(on[0].model.state_dict()[name], v)
    assert _calls(profiling.span_report()) == {
        "train.operands": 1, "train.epoch": 2, "train.step": 4, "train.val": 2,
        "train.fetch": 2, "train.books": 2}


def test_predictor_spans_its_calls(tmp_path):
    ex = _extractor(chunk_seconds=1.0, overlap_seconds=0.5, batch_size=2)
    predictor = Predictor(build_cnn_lstm(input_dim=32, cnn_out_channels=8, lstm_hidden_dim=8,
                                         seed=1, device="cpu"), extractor=ex, device="cpu")
    wave = _waves()["a"]
    path = str(tmp_path / "a.wav")
    write_wav(path, wave, 16000)

    def calls():
        return predictor.predict(wave), predictor.predict_files([path])["a.wav"]

    off = calls()
    with profiling.tracing():
        on = calls()
    for a, b in zip(on, off):
        assert a.label == b.label and np.array_equal(a.logits, b.logits)
    rep = _calls(profiling.span_report())
    assert {k: rep[k] for k in ("serve.predict", "serve.classify", "serve.decode",
                                "w2v2.extract")} == {
        "serve.predict": 1, "serve.classify": 2, "serve.decode": 1, "w2v2.extract": 2}
