"""The Conformer extraction cell at tiny sizes on the CPU: the plain reference
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

from port_bench import conformer_counts
from port_bench import run as harness
from port_bench.reference import conformer as ref_conformer
from port_bench.reference.weights import make_weights
from port_bench.tests.tiny import _edit, tiny_root

CELL = "w2v2-conformer-extract-reading16s"
CONFIG = "w2v2-conformer-relpos-large"
TINY = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128, conv_dim=[16] * 7,
            conv_depthwise_kernel_size=7, chunk_seconds=3.0, overlap_seconds=1.0,
            extract_batch_size=4)
CFG = dict(TINY, conv_kernel=[10, 3, 3, 3, 3, 2, 2], conv_stride=[5, 2, 2, 2, 2, 2, 2],
           conv_bias=True, layer_norm_eps=1e-5, sample_rate=16000, min_seconds=0.5,
           max_source_positions=5000, pos_conv_kernel=128, pos_conv_groups=16,
           position_embeddings_type="relative")


def _published(name: str = CONFIG) -> dict:
    with open(os.path.join(os.path.dirname(harness.__file__), "configs", name + ".json")) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    tmp = tiny_root(str(tmp_path_factory.mktemp("tiny_conformer")))
    _edit(os.path.join(tmp, "port_bench", "configs", CONFIG + ".json"), **TINY)
    _edit(os.path.join(tmp, "port_bench", "workloads", CELL + ".json"),
          params={"mix": {"reading": [3, 2.0, 7.5]}, "check": 2})
    return tmp


def _run(root: str, trace: int = 0, seed: int = 2**31 + 77) -> dict:
    args = harness.parse_args(["--workload", CELL, "--seed", str(seed), "--seconds", "0.5",
                               "--trace", str(trace)])
    return harness.run(args, root=root, device="cpu")


def test_spec_matches_the_programs_encoder():
    from robust_speech_analysis_framework_tpu_torch.models.conformer import ConformerModel

    from port_bench.traffic.extract_conformer import encoder_config

    sd = ConformerModel(encoder_config(CFG)).state_dict()
    assert {n: tuple(v.shape) for n, v in sd.items()} == {
        n: s for n, s, *_ in ref_conformer.conformer_spec(CFG)}
    large = _published()
    with torch.device("meta"):
        sd = ConformerModel(encoder_config(large)).state_dict()
    spec = ref_conformer.conformer_spec(large)
    assert {n: tuple(v.shape) for n, v in sd.items()} == {n: s for n, s, *_ in spec}
    params = sum(np.prod(s) for n, s, *_ in spec
                 if not n.endswith(("running_mean", "running_var", "num_batches_tracked")))
    assert params == pytest.approx(610.2e6, rel=1e-3)


def test_reference_matches_the_programs_extraction():
    """The program's batched ragged extraction (chunks of three lengths in
    one batch) against the reference's unpadded chunks: float32 on the CPU,
    summation orders only (atol 1e-4 on unit-scale hidden states)."""
    from port_bench.traffic.extract_conformer import encoder_config
    from robust_speech_analysis_framework_tpu_torch.features.wav2vec2 import Wav2Vec2Extractor

    w = make_weights(ref_conformer.conformer_spec(CFG), 5, "cpu")
    ex = Wav2Vec2Extractor(params=w, config=encoder_config(CFG), chunk_seconds=3.0,
                           overlap_seconds=1.0, batch_size=4, device="cpu")
    rng = np.random.default_rng(0)
    waves = {f"f{i}": (0.1 * rng.standard_normal(n)).astype(np.float32)
             for i, n in enumerate((70000, 30000, 12000))}
    program = ex.extract_sequences(waves, verbose=False)
    ref = ref_conformer.sequences(w, waves, CFG, "cpu")
    for name in waves:
        assert program[name].shape == ref[name].shape == (ref[name].shape[0], 64)
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
    assert names == shared | {"relpos_score_roofline.conformer",
                              "conv_module_device_pct.conformer", "attn_pad_share_pct.wavlm"}
    # no device kernel on the CPU: the roofline and the conv modules' share find no device time
    assert "relpos_score_roofline.conformer" not in result["metrics"]
    assert 0 < result["metrics"]["pad_share_pct.extract"]["value"] < 100
    # the attention-pair counters count for this encoder too
    assert 0 < result["metrics"]["attn_pad_share_pct.wavlm"]["value"] < 100


def _mirrored(monkeypatch):
    """The position term of distance j − i in the program: its table reversed."""
    from robust_speech_analysis_framework_tpu_torch.models import conformer

    table = conformer.relative_position_table
    monkeypatch.setattr(conformer, "relative_position_table",
                        lambda t, d: torch.flip(table(t, d), [0]))


def _full_ffn(monkeypatch):
    """Both FFNs added whole: the macaron ½ left out."""
    import torch.nn.functional as F

    from robust_speech_analysis_framework_tpu_torch.models import conformer
    from robust_speech_analysis_framework_tpu_torch.models.wav2vec2 import _linear

    def forward(self, x, pe, key_lengths, valid):
        def ffn(y, w1, w2):
            return _linear(F.silu(_linear(y, w1.weight, w1.bias, torch.float32)), w2.weight,
                           w2.bias, torch.float32)

        x = x + ffn(self.ff1_norm(x), self.ff1_in, self.ff1_out)
        x = x + self.attention(self.attn_norm(x), pe, key_lengths)
        x = x + self.conv_module(x, valid)
        x = x + ffn(self.ff2_norm(x), self.ff2_in, self.ff2_out)
        return self.final_norm(x)

    monkeypatch.setattr(conformer.ConformerLayer, "forward", forward)


@pytest.mark.parametrize("fault", [_mirrored, _full_ffn], ids=["mirrored", "full_ffn"])
def test_broken_timed_path_is_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    result = _run(root)
    assert not result["correct"]
    c = result["compared"]["sequence_err"]
    assert c["value"] > c["limit"]


@pytest.mark.parametrize("fault", ["mirrored", "full_ffn"])
def test_reference_faults_differ_from_the_reference(fault):
    w = make_weights(ref_conformer.conformer_spec(CFG), 9, "cpu")
    wav = {"a": (0.1 * np.random.default_rng(1).standard_normal(40000)).astype(np.float32)}
    ref = ref_conformer.sequences(w, wav, CFG, "cpu")["a"]
    planted = ref_conformer.sequences(w, wav, CFG, "cpu", mirrored=fault == "mirrored",
                                      macaron=fault != "full_ffn")["a"]
    assert np.abs(planted - ref).max() > 1e-2 * np.abs(ref).max()


def test_readers_return_none_without_their_inputs():
    roofline = harness.reader_for("relpos_score_roofline.conformer")
    conv = harness.reader_for("conv_module_device_pct.conformer")
    trace = SimpleNamespace(kernel_s=lambda match: 0.0, busy_s=1.0, window_s=1.0, kernels=[],
                            op_device_s=lambda names: None)
    assert roofline(SimpleNamespace(trace=None, work={"relpos_score_bound_ms": 1.0})) is None
    assert roofline(SimpleNamespace(trace=trace, work={"relpos_score_bound_ms": 1.0})) is None
    assert roofline(SimpleNamespace(trace=trace, work={})) is None
    timed = SimpleNamespace(kernel_s=lambda match: 0.004 if match(
        "void (anonymous namespace)::conformer_relpos_softmax_kernel<32>(float*, ...)") else 0.0)
    assert roofline(SimpleNamespace(trace=timed, work={"relpos_score_bound_ms": 2.0})) == 50.0
    assert conv(SimpleNamespace(trace=None, work={})) is None
    assert conv(SimpleNamespace(trace=trace, work={})) is None
    spanned = SimpleNamespace(busy_s=2.0, op_device_s=lambda names: 0.5 if names == [
        "conformer.conv_module"] else None)
    assert conv(SimpleNamespace(trace=spanned, work={})) == 25.0


def test_counts_at_the_published_widths():
    """At the published widths a full 16 s chunk is 799 frames and about
    1.1 TFLOP; the score stage's bound is the larger of 8 bytes a real pair
    at the HBM rate and 128 operations a pair at the fp32 peak (bytes here)."""
    large = _published()
    assert conformer_counts.frames(large, 256000) == 799
    assert conformer_counts.chunk_flops(large, 256000) == pytest.approx(1.10e12, rel=0.01)
    assert conformer_counts.batch_flops(large, 799) == pytest.approx(
        24 * 2 * 1597 * 1024 ** 2)
    bound = conformer_counts.relpos_score_bound_ms(large, [799, 10])
    pairs = (799**2 + 100) * 16 * 24
    assert bound == pytest.approx(8 * pairs / 3.35e12 * 1e3)
    assert bound > 128 * pairs / 67e12 * 1e3
    assert conformer_counts.relpos_score_bound(large, [799, 10]) == (bound, "bytes")
