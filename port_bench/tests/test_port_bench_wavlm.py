"""The WavLM extraction cell at tiny sizes on the CPU: the plain reference
against the program, whole runs that reach their result line, planted faults
in the timed path that read not correct, and the new readers with nothing to
read."""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from port_bench import run as harness
from port_bench import wavlm_counts
from port_bench.reference import wavlm as ref_wavlm
from port_bench.reference.weights import make_weights
from port_bench.tests.tiny import _edit, tiny_root

CELL = "wavlm-large-extract-reading16s"
TINY = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64, conv_dim=[16] * 7,
            pos_conv_kernel=8, pos_conv_groups=4, num_buckets=32, max_bucket_distance=40,
            chunk_seconds=3.0, overlap_seconds=1.0, extract_batch_size=4)
CFG = dict(TINY, conv_kernel=[10, 3, 3, 3, 3, 2, 2], conv_stride=[5, 2, 2, 2, 2, 2, 2],
           conv_bias=False, layer_norm_eps=1e-5, sample_rate=16000, min_seconds=0.5)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    tmp = tiny_root(str(tmp_path_factory.mktemp("tiny_wavlm")))
    _edit(os.path.join(tmp, "port_bench", "configs", "wavlm-large.json"), **TINY)
    _edit(os.path.join(tmp, "port_bench", "workloads", CELL + ".json"),
          params={"mix": {"reading": [3, 2.0, 7.5]}, "check": 2})
    return tmp


def _run(root: str, trace: int = 0, seed: int = 2**31 + 77) -> dict:
    args = harness.parse_args(["--workload", CELL, "--seed", str(seed), "--seconds", "0.5",
                               "--trace", str(trace)])
    return harness.run(args, root=root, device="cpu")


def test_spec_matches_the_programs_encoder():
    from robust_speech_analysis_framework_tpu_torch.models.wavlm import WavLMModel

    from port_bench.traffic.extract_wavlm import encoder_config

    with open(os.path.join(os.path.dirname(harness.__file__), "configs", "wavlm-large.json")) as fh:
        large = json.load(fh)
    for cfg in (CFG, dict(CFG, conv_bias=True)):
        sd = WavLMModel(encoder_config(cfg)).state_dict()
        assert {n: tuple(v.shape) for n, v in sd.items()} == {
            n: s for n, s, *_ in ref_wavlm.wavlm_spec(cfg)}
    with torch.device("meta"):
        sd = WavLMModel(encoder_config(large)).state_dict()
    assert {n: tuple(v.shape) for n, v in sd.items()} == {
        n: s for n, s, *_ in ref_wavlm.wavlm_spec(large)}
    assert sum(np.prod(s) for _, s, *_ in ref_wavlm.wavlm_spec(large)) == pytest.approx(316e6, rel=0.01)


def test_reference_matches_the_programs_extraction():
    """The program's batched ragged extraction (chunks of three lengths in
    one batch) against the reference's unpadded chunks: float32 on the CPU,
    summation orders only (atol 1e-4 on unit-scale hidden states)."""
    from port_bench.traffic.extract_wavlm import encoder_config
    from robust_speech_analysis_framework_tpu_torch.features.wav2vec2 import Wav2Vec2Extractor

    w = make_weights(ref_wavlm.wavlm_spec(CFG), 5, "cpu")
    ex = Wav2Vec2Extractor(params=w, config=encoder_config(CFG), chunk_seconds=3.0,
                           overlap_seconds=1.0, batch_size=4, device="cpu")
    rng = np.random.default_rng(0)
    waves = {f"f{i}": (0.1 * rng.standard_normal(n)).astype(np.float32)
             for i, n in enumerate((70000, 30000, 12000))}
    program = ex.extract_sequences(waves, verbose=False)
    ref = ref_wavlm.sequences(w, waves, CFG, "cpu")
    for name in waves:
        assert program[name].shape == ref[name].shape == (ref[name].shape[0], 32)
        np.testing.assert_allclose(program[name], ref[name], atol=1e-4)


def test_sound_run_is_correct_and_reports_its_metrics(root):
    result = _run(root)
    assert result["correct"], result["compared"]
    assert result["attempted"] > 0 and result["attempted"] % 3 == 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "extract_audio_s_per_s"}
    json.dumps(result)


def test_traced_run_reads_the_new_metrics_on_the_cpu(root):
    result = _run(root, trace=1)
    assert result["correct"]
    names = {m["name"] for m in harness.load_cell(CELL, root).per_layer}
    shared = {f"{m}.extract" for m in ("idle_pct", "mfu", "encoder_device_ms_per_chunk",
                                       "input_idle_pct", "output_idle_pct", "wait_idle_pct",
                                       "pad_share_pct")}
    assert names == shared | {"relpos_softmax_roofline.wavlm", "attn_pad_share_pct.wavlm"}
    # no device kernel on the CPU: the roofline finds no kernel time
    assert "relpos_softmax_roofline.wavlm" not in result["metrics"]
    assert 0 < result["metrics"]["attn_pad_share_pct.wavlm"]["value"] < 100
    # the shared extraction pipeline's counters read on either encoder
    assert 0 < result["metrics"]["pad_share_pct.extract"]["value"] < 100


def _ungated(monkeypatch):
    from robust_speech_analysis_framework_tpu_torch.models import wavlm

    monkeypatch.setattr(wavlm.WavLMLayer, "gates",
                        lambda self, u: torch.ones(u.shape[0], self.num_heads, u.shape[1]))


def _post_norm(monkeypatch):
    """Post-norm layers (Wav2Vec2-base's order) in the pre-norm model's place."""
    import torch.nn.functional as F

    from robust_speech_analysis_framework_tpu_torch.models import wavlm
    from robust_speech_analysis_framework_tpu_torch.models.wav2vec2 import _attention, _linear
    from robust_speech_analysis_framework_tpu_torch.ops.cuda.wavlm import relpos_softmax

    def forward(self, x, table, buckets, key_lengths):
        f32 = torch.float32
        gates = self.gates(x)
        ctx = _attention(x, (self.q.weight, self.q.bias), (self.k.weight, self.k.bias),
                         (self.v.weight, self.v.bias), self.num_heads, self.q_scale, f32, None,
                         lambda s: relpos_softmax(s, gates, table, buckets, key_lengths))
        x = self.attn_norm(x + _linear(ctx, self.out.weight, self.out.bias, f32))
        ff = _linear(F.gelu(_linear(x, self.ff1.weight, self.ff1.bias, f32)), self.ff2.weight,
                     self.ff2.bias, f32)
        return self.ff_norm(x + ff)

    monkeypatch.setattr(wavlm.WavLMLayer, "forward", forward)


@pytest.mark.parametrize("fault", [_ungated, _post_norm], ids=["ungated", "post_norm"])
def test_broken_timed_path_is_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    result = _run(root)
    assert not result["correct"]
    c = result["compared"]["sequence_err"]
    assert c["value"] > c["limit"]


@pytest.mark.parametrize("fault", ["ungated", "post_norm"])
def test_reference_faults_differ_from_the_reference(fault):
    w = make_weights(ref_wavlm.wavlm_spec(CFG), 9, "cpu")
    wav = {"a": (0.1 * np.random.default_rng(1).standard_normal(40000)).astype(np.float32)}
    ref = ref_wavlm.sequences(w, wav, CFG, "cpu")["a"]
    planted = ref_wavlm.sequences(w, wav, CFG, "cpu", gate=fault != "ungated",
                                  pre_norm=fault != "post_norm")["a"]
    assert np.abs(planted - ref).max() > 1e-2 * np.abs(ref).max()


def test_readers_return_none_without_their_inputs(monkeypatch):
    from robust_speech_analysis_framework_tpu_torch.utils import profiling

    roofline = harness.reader_for("relpos_softmax_roofline.wavlm")
    pad = harness.reader_for("attn_pad_share_pct.wavlm")
    trace = SimpleNamespace(kernel_s=lambda match: 0.0, busy_s=1.0, window_s=1.0, kernels=[])
    assert roofline(SimpleNamespace(trace=None, work={"relpos_softmax_bound_ms": 1.0})) is None
    assert roofline(SimpleNamespace(trace=trace, work={"relpos_softmax_bound_ms": 1.0})) is None
    assert roofline(SimpleNamespace(trace=trace, work={})) is None
    timed = SimpleNamespace(kernel_s=lambda match: 0.004 if match(
        "void (anonymous namespace)::wavlm_relpos_softmax_kernel<32>(float*, ...)") else 0.0)
    assert roofline(SimpleNamespace(trace=timed, work={"relpos_softmax_bound_ms": 2.0})) == 50.0
    monkeypatch.setattr(profiling, "_counts", {})
    assert pad(SimpleNamespace(trace=None, work={})) is None
    monkeypatch.setattr(profiling, "_counts", {"w2v2.attn_pairs": 30, "w2v2.attn_pad_pairs": 10})
    assert pad(SimpleNamespace(trace=None, work={})) == 25.0


def test_counts_at_the_published_widths():
    """At the published widths a full 16 s chunk is 799 frames and about
    0.638 TFLOP; the kernel's bound counts 8 bytes a real pair, head and layer."""
    with open(os.path.join(os.path.dirname(harness.__file__), "configs", "wavlm-large.json")) as fh:
        large = json.load(fh)
    assert wavlm_counts.frames(large, 256000) == 799
    assert wavlm_counts.chunk_flops(large, 256000) == pytest.approx(0.638e12, rel=0.01)
    bound = wavlm_counts.relpos_softmax_bound_ms(large, [799, 10])
    assert bound == pytest.approx(8 * (799**2 + 100) * 16 * 24 / 3.35e12 * 1e3)
