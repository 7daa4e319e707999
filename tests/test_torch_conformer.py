"""The port's Wav2Vec2-Conformer encoder (``models/conformer.py``), its shifted
relative-position softmax (``ops/cuda/conformer.py``) and its extraction
route, at a tiny size on the CPU: against the benchmark's plain reference
(``port_bench/reference/conformer.py``) on seeded weights, against
``transformers``' own Conformer (skipped where ``transformers`` is absent),
and ragged batches against each chunk alone. The tests marked ``cuda`` hold
the kernel to its plain version on the card (this file imports no JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_conformer.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from port_bench.reference import conformer as ref_conformer
from port_bench.reference.weights import make_weights
from robust_speech_analysis_framework_tpu_torch.features import wav2vec2 as w2v_features
from robust_speech_analysis_framework_tpu_torch.features.wav2vec2 import Wav2Vec2Extractor
from robust_speech_analysis_framework_tpu_torch.models import conformer as conformer_model
from robust_speech_analysis_framework_tpu_torch.models.conformer import (
    ConformerConfig,
    ConformerModel,
    port_hf_conformer_state_dict,
    relative_position_table,
)
from robust_speech_analysis_framework_tpu_torch.models.init import init_weights_
from robust_speech_analysis_framework_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model
from robust_speech_analysis_framework_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
from robust_speech_analysis_framework_tpu_torch.ops.cuda import conformer as conformer_ops
from robust_speech_analysis_framework_tpu_torch.parallel.mesh import make_mesh
from robust_speech_analysis_framework_tpu_torch.utils import profiling

# float32 on the CPU, the same operations in other orders (batched GEMMs,
# a ragged batch's padded shapes, the bias added to q before or after its
# product): hidden states after the final LayerNorm are near unit scale, so
# 1e-4 absolute holds a few hundred roundings
ATOL = 1e-4
SMALL = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
             conv_dim=(16,) * 7, conv_depthwise_kernel_size=7)
REF_CFG = dict(SMALL, conv_dim=[16] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2],
               conv_stride=[5, 2, 2, 2, 2, 2, 2], conv_bias=True, layer_norm_eps=1e-5,
               max_source_positions=5000, sample_rate=16000, chunk_seconds=2.0,
               overlap_seconds=0.5, min_seconds=0.5)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # summation orders that do not depend on the host's cores
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    return make_weights(ref_conformer.conformer_spec(REF_CFG), 7, "cpu")


@pytest.fixture(scope="module")
def model(weights):
    m = ConformerModel(ConformerConfig(**SMALL)).eval()
    m.load_state_dict(weights)
    return m


def _waves(*lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in lengths]


def _batch(waves):
    batch = torch.zeros(len(waves), max(len(w) for w in waves))
    for i, w in enumerate(waves):
        batch[i, : len(w)] = torch.from_numpy(w)
    return batch, torch.tensor([len(w) for w in waves])


def test_config_keeps_wav2vec2s_fields_and_publishes_the_large_widths():
    names = [f.name for f in dataclasses.fields(Wav2Vec2Config)]
    assert names == ["hidden_size", "num_layers", "num_heads", "intermediate_size", "conv_dim",
                     "conv_kernel", "conv_stride", "pos_conv_kernel", "pos_conv_groups",
                     "layer_norm_eps", "compute_dtype"]
    large = ConformerConfig()
    assert (large.hidden_size, large.num_layers, large.num_heads, large.intermediate_size,
            large.conv_depthwise_kernel_size, large.conv_bias) == (1024, 24, 16, 4096, 31, True)
    assert large.output_length(256000) == 799
    with torch.device("meta"):
        n = sum(p.numel() for p in ConformerModel(large).parameters())
    assert n == pytest.approx(610.2e6, rel=1e-3)  # the forward pass's parameters


# relative positions are a constant of the model: the config has no knob for them
@pytest.mark.parametrize("change,error,match", [
    (dict(position_embeddings_type="rotary"), TypeError, "position_embeddings_type"),
    (dict(position_embeddings_type=None), TypeError, "position_embeddings_type"),
    (dict(compute_dtype="bfloat16"), ValueError, "float32 only"),
    (dict(conv_depthwise_kernel_size=8), ValueError, "odd"),
], ids=["rotary", "none", "bfloat16", "even-kernel"])
def test_config_refuses_what_is_not_ported(change, error, match):
    with pytest.raises(error, match=match):
        ConformerConfig(**dict(SMALL, **change))


def test_extractor_refuses_bfloat16_and_an_mp_split():
    with pytest.raises(ValueError, match="float32 only"):
        Wav2Vec2Extractor(config=ConformerConfig(**SMALL), compute_dtype="bfloat16",
                          allow_random_init=True, device="cpu")
    grid = make_mesh(devices=[torch.device("cpu")] * 2, mp=2)
    with pytest.raises(ValueError, match="mp > 1"):
        Wav2Vec2Extractor(config=ConformerConfig(**SMALL), allow_random_init=True, device="cpu",
                          mesh=grid, batch_size=2)


def test_extractor_picks_the_encoder_its_config_class_names():
    @dataclasses.dataclass(frozen=True)
    class Narrower(ConformerConfig):
        pass

    assert w2v_features.encoder_class(Wav2Vec2Config()) is Wav2Vec2Model
    assert w2v_features.encoder_class(WavLMConfig()) is WavLMModel
    assert w2v_features.encoder_class(ConformerConfig()) is ConformerModel
    assert w2v_features.encoder_class(Narrower()) is ConformerModel
    ex = Wav2Vec2Extractor(config=Narrower(**SMALL), allow_random_init=True, device="cpu")
    assert type(ex.model) is ConformerModel


def test_encoder_matches_the_plain_reference(model, weights):
    wav = torch.from_numpy(np.stack(_waves(20000, 20000, seed=1)))
    with torch.no_grad():
        got, n = model(wav)
        ref = ref_conformer.encode(weights, wav, REF_CFG)
    assert n is None and got.shape == ref.shape == (2, 62, 64)
    torch.testing.assert_close(got, ref, rtol=0, atol=ATOL)


def test_ragged_batch_equals_each_chunk_alone(model):
    waves = _waves(24000, 13000, 6000, seed=2)
    batch, lengths = _batch(waves)
    with torch.no_grad():
        hidden, frames = model(batch, lengths)
        for i, w in enumerate(waves):
            alone, _ = model(torch.from_numpy(w)[None])
            assert alone.shape[1] == int(frames[i])
            torch.testing.assert_close(hidden[i, : int(frames[i])], alone[0], rtol=0, atol=ATOL)


def test_ragged_batch_needs_the_mask_before_the_depthwise_conv(model, monkeypatch):
    """Without the mask the conv module's reach past a chunk's end reads the
    padded frames' GLU output: the last K // 2 frames of a short chunk move."""
    waves = _waves(24000, 13000, seed=3)
    batch, lengths = _batch(waves)
    with torch.no_grad():
        alone, _ = model(torch.from_numpy(waves[1])[None])
        conv_module = conformer_model.ConformerLayer.conv_module
        monkeypatch.setattr(conformer_model.ConformerLayer, "conv_module",
                            lambda self, x, valid: conv_module(self, x, None))
        unmasked, frames = model(batch, lengths)
    n = int(frames[1])
    gap = (unmasked[1, :n] - alone[0]).abs().amax(-1)
    assert gap.max() > 100 * ATOL
    k = SMALL["conv_depthwise_kernel_size"]
    # the first layer's leak reaches the last K // 2 frames; later layers spread it
    assert gap[n - k // 2:].min() > 100 * ATOL


def _published_shift(scores, q, pos, lengths):
    """``transformers``' ``_apply_relative_embeddings`` steps 4-6 (without
    the 1/√d, which ``q`` carries) and its additive key mask, then softmax."""
    b, h, t, _ = scores.shape
    scores_bd = torch.matmul(q, pos.permute(1, 2, 0))
    zero_pad = torch.zeros((*scores_bd.size()[:3], 1), dtype=scores_bd.dtype)
    padded = torch.cat([zero_pad, scores_bd], dim=-1)
    padded = padded.view(*scores_bd.size()[:2], scores_bd.shape[3] + 1, scores_bd.shape[2])
    scores_bd = padded[:, :, 1:].view_as(scores_bd)[:, :, :, : scores_bd.size(-1) // 2 + 1]
    mask = torch.arange(t)[None, :] < lengths[:, None]
    bias = (1.0 - mask[:, None, None, :].float()) * torch.finfo(torch.float32).min
    return torch.softmax(scores + scores_bd + bias, dim=-1), mask


@pytest.mark.parametrize("t,lengths", [(1, (1, 1)), (9, (9, 9)), (9, (9, 4)), (16, (16, 1))],
                         ids=["T1", "odd", "masked", "one-key"])
def test_plain_version_equals_the_published_shift(t, lengths):
    gen = torch.Generator().manual_seed(t)
    b, h, d = 2, 3, 8
    scores = torch.randn(b, h, t, t, generator=gen)
    q = torch.randn(b, h, t, d, generator=gen)
    pos = torch.randn(2 * t - 1, h, d, generator=gen)
    lens = torch.tensor(lengths, dtype=torch.int32)
    before = scores.clone()
    got = conformer_ops.relpos_shift_softmax(scores, q, pos, lens)
    assert torch.equal(scores, before)  # the CPU returns a new tensor
    want, valid = _published_shift(before, q, pos, lens)
    torch.testing.assert_close(got, torch.where(valid[:, None, None, :], want, 0.0),
                               rtol=0, atol=1e-6)
    # key j of query i takes distance i - j: row T - 1 - i + j of pos
    i, j = t - 1, 0
    logit = before[0, 1, i, j] + q[0, 1, i] @ pos[t - 1 - i + j, 1]
    x = before[0, 1, i] + torch.stack([q[0, 1, i] @ pos[t - 1 - i + k, 1] for k in range(t)])
    assert torch.isclose(logit, x[j]) and torch.allclose(got[0, 1, i], torch.softmax(x, -1),
                                                         atol=1e-6)


def test_a_row_with_no_valid_key_is_zeros():
    scores, q = torch.randn(1, 2, 5, 5), torch.randn(1, 2, 5, 4)
    got = conformer_ops.relpos_shift_softmax(scores, q, torch.randn(9, 2, 4),
                                             torch.tensor([0], dtype=torch.int32))
    assert torch.all(got == 0)


class _FakeCard:
    """The wrapper's card route on CPU tensors: every check it makes and the
    launch replaced by the plain version written in place."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(conformer_ops, "_uses_kernel", lambda device, dtype: True)
        monkeypatch.setattr(conformer_ops, "_call", self.launch)

    def launch(self, lib, fn, device, scores, q_rows, pos, lengths, b, h, t):
        self.calls.append((lib, fn, b, h, t, q_rows.shape, q_rows.is_contiguous()))
        scores.copy_(conformer_ops.relpos_shift_softmax_reference(
            scores.clone(), q_rows.transpose(1, 2), pos, lengths))


def test_wrapper_launches_in_place_up_to_the_kernels_length(monkeypatch):
    card = _FakeCard(monkeypatch)
    gen = torch.Generator().manual_seed(1)
    b, h, t = 2, 2, 6
    scores = torch.randn(b, h, t, t, generator=gen)
    q_rows = torch.randn(b, t, h, 64, generator=gen)  # the projection's layout
    pos = torch.randn(2 * t - 1, h, 64, generator=gen)
    lengths = torch.tensor([6, 3], dtype=torch.int32)
    want = conformer_ops.relpos_shift_softmax_reference(scores, q_rows.transpose(1, 2), pos,
                                                        lengths)
    before = conformer_ops.relpos_shift_softmax.launches
    got = conformer_ops.relpos_shift_softmax(scores, q_rows.transpose(1, 2), pos, lengths)
    assert got is scores and torch.equal(got, want)
    assert conformer_ops.relpos_shift_softmax.launches == before + 1
    assert card.calls == [("conformer_relpos", "conformer_relpos_softmax_f32", b, h, t,
                           (b, t, h, 64), True)]


def test_wrapper_refuses_a_length_over_the_kernels_limit(monkeypatch):
    card = _FakeCard(monkeypatch)
    t = conformer_ops.MAX_T + 1
    scores, q = torch.zeros(1, 1, t, t), torch.zeros(1, 1, t, 64)
    with pytest.raises(ValueError, match=f"at most {conformer_ops.MAX_T} frames"):
        conformer_ops.relpos_shift_softmax(scores, q, torch.zeros(2 * t - 1, 1, 64),
                                           torch.tensor([t]))
    assert card.calls == []


def test_extractor_refuses_chunks_over_the_kernels_frames_on_a_card(monkeypatch):
    cfg = ConformerConfig(**SMALL)
    assert (cfg.output_length(328000), cfg.output_length(328160)) == (1024, 1025)
    make = lambda seconds: Wav2Vec2Extractor(  # noqa: E731
        config=cfg, allow_random_init=True, device="cpu", chunk_seconds=seconds,
        overlap_seconds=1.0)
    make(30.0)  # the CPU takes the plain version at any length
    monkeypatch.setattr(conformer_ops, "_uses_kernel", lambda device, dtype: True)
    make(20.5)
    with pytest.raises(ValueError, match=f"at most {conformer_ops.MAX_T} frames"):
        make(20.51)


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    _FakeCard(monkeypatch)
    s, q, p, n = (torch.zeros(1, 2, 5, 5), torch.zeros(1, 2, 5, 64), torch.zeros(9, 2, 64),
                  torch.tensor([5]))
    with pytest.raises(ValueError, match="heads of 64"):
        conformer_ops.relpos_shift_softmax(s, q[..., :32], p[..., :32], n)
    with pytest.raises(ValueError, match="contiguous"):
        conformer_ops.relpos_shift_softmax(s.transpose(2, 3), q, p, n)
    with pytest.raises(TypeError):
        conformer_ops.relpos_shift_softmax(s, q.double(), p, n)
    with pytest.raises(ValueError, match="position rows"):
        conformer_ops.relpos_shift_softmax(s, q, p[:8], n)
    with pytest.raises(RuntimeError, match="no backward"):
        conformer_ops.relpos_shift_softmax(s, q.requires_grad_(), p, n)


def test_position_table_equals_the_published_one():
    d = 64
    for t in (1, 62, 799):
        ours = relative_position_table(t, d)
        assert ours.shape == (2 * t - 1, d) and ours.dtype == torch.float32
        assert torch.equal(ours, ref_conformer.position_table(t, REF_CFG))
    modeling = pytest.importorskip(
        "transformers.models.wav2vec2_conformer.modeling_wav2vec2_conformer")
    transformers = pytest.importorskip("transformers")
    published = modeling.Wav2Vec2ConformerRelPositionalEmbedding(
        transformers.Wav2Vec2ConformerConfig(hidden_size=d))
    for t in (1, 62, 799):
        assert torch.equal(relative_position_table(t, d), published(torch.zeros(1, t, d))[0])


def test_position_table_built_once_per_length_under_a_span(model):
    model._tables.clear()
    profiling.span_report(reset=True)
    with profiling.tracing():
        first = model.position_table(37, torch.device("cpu"))
        again = model.position_table(37, torch.device("cpu"))
        model.position_table(12, torch.device("cpu"))
    report = profiling.span_report(reset=True)
    assert first is again and first.shape == (73, 64)
    assert report["conformer.position_table"]["calls"] == 2
    assert torch.equal(first, relative_position_table(37, 64))


def test_conv_module_is_a_span_a_block(model):
    profiling.span_report(reset=True)
    with profiling.tracing(), torch.no_grad():
        model(torch.from_numpy(np.stack(_waves(9000, seed=4))))
    report = profiling.span_report(reset=True)
    assert report["conformer.conv_module"]["calls"] == SMALL["num_layers"]


def _hf_model(tmp_path=None):
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.Wav2Vec2ConformerConfig(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
        conv_dim=(16,) * 7, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        feat_extract_norm="layer", conv_bias=True, hidden_act="swish",
        position_embeddings_type="relative", conv_depthwise_kernel_size=7)
    torch.manual_seed(0)
    hf = transformers.Wav2Vec2ConformerModel(hf_cfg).eval()
    with torch.no_grad():  # away from the init's zeros and ones
        for p in hf.parameters():
            p.add_(0.1 * torch.randn_like(p))
        for m in hf.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.normal_(0.0, 0.1)
                m.running_var.uniform_(0.5, 2.0)
    if tmp_path is not None:
        hf.save_pretrained(tmp_path)
    return hf


def test_hf_checkpoint_matches_transformers_on_each_chunk(tmp_path):
    hf = _hf_model(tmp_path)
    ex = Wav2Vec2Extractor.from_hf_checkpoint(str(tmp_path), device="cpu", chunk_seconds=2.0,
                                              overlap_seconds=0.5, batch_size=2)
    assert isinstance(ex.model, ConformerModel)
    assert ex.config.conv_depthwise_kernel_size == 7 and ex.config.conv_bias
    with torch.no_grad():
        for w in _waves(32000, 14000, seed=5):
            wav = torch.from_numpy(w)[None]
            want = hf(wav).last_hidden_state
            got, _ = ex.model(wav)
            torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    sd = port_hf_conformer_state_dict({"wav2vec2_conformer." + k: v
                                       for k, v in hf.state_dict().items()})
    assert set(sd) == set(ex.model.state_dict())
    assert "masked_spec_embed" in hf.state_dict()  # dropped, with pos_conv_embed.*
    assert sd["layer_1.batch_norm.num_batches_tracked"].dtype == torch.int64
    with pytest.raises(ValueError, match="Wav2Vec2ConformerModel"):
        port_hf_conformer_state_dict({"feature_extractor.conv_layers.0.conv.weight": 0})


def test_reference_matches_transformers_on_each_chunk():
    hf = _hf_model()
    w = port_hf_conformer_state_dict(hf.state_dict())
    with torch.no_grad():
        for w_ in _waves(20000, 9000, seed=6):
            wav = torch.from_numpy(w_)[None]
            torch.testing.assert_close(ref_conformer.encode(w, wav, REF_CFG),
                                       hf(wav).last_hidden_state, rtol=0, atol=ATOL)


def test_hf_config_refuses_rotary():
    transformers = pytest.importorskip("transformers")
    with pytest.raises(ValueError, match="relative"):
        conformer_model.conformer_config_from_hf(transformers.Wav2Vec2ConformerConfig(
            position_embeddings_type="rotary", feat_extract_norm="layer", hidden_act="swish"))


ENTRIES = {
    "sequences": lambda ex, w: ex.extract_sequences(w, verbose=False),
    "resident": lambda ex, w: dict(ex.extract_sequences_resident(w, verbose=False, align=16).items()),
    "embeddings": lambda ex, w: dict(zip(*ex.extract_embeddings_arrays(w, verbose=False))),
}


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_extractor_entry_points_and_counters(weights, entry):
    ex = Wav2Vec2Extractor(params=weights, config=ConformerConfig(**SMALL), chunk_seconds=2.0,
                           overlap_seconds=0.5, batch_size=2, device="cpu")
    names = ("a", "b", "c")
    waves = dict(zip(names, _waves(45000, 20000, 9000, seed=7)))
    profiling.counters(reset=True)
    off = ENTRIES[entry](ex, waves)
    with profiling.tracing():
        on = ENTRIES[entry](ex, waves)
    seen = profiling.counters(reset=True)
    profiling.span_report(reset=True)
    assert sorted(off) == sorted(on) == list(names)
    for n in names:
        assert np.array_equal(off[n], on[n])  # tracing moves no bit
    ref = ref_conformer.sequences(weights, waves, REF_CFG, "cpu")
    for n in names:
        if entry == "embeddings":
            assert off[n].shape == (64,)
            np.testing.assert_allclose(off[n], ref[n].mean(0), rtol=0, atol=ATOL)
        else:
            assert off[n].shape == ref[n].shape and off[n].shape[1] == 64
            np.testing.assert_allclose(off[n], ref[n], rtol=0, atol=ATOL)
    chunks = [len(c) for w in waves.values() for c in ex._chunk(w)]
    slots = -(-len(chunks) // 2) * 2
    pairs = sum(ex._frames(c) ** 2 for c in chunks)
    assert seen["w2v2.samples"] == sum(chunks)
    assert seen["w2v2.pad_samples"] == slots * ex.chunk_size - sum(chunks)
    assert seen["w2v2.attn_pairs"] == pairs
    assert seen["w2v2.attn_pad_pairs"] == slots * ex._frames(ex.chunk_size) ** 2 - pairs


def test_outputs_equal_under_the_profiler(weights):
    ex = Wav2Vec2Extractor(params=weights, config=ConformerConfig(**SMALL), chunk_seconds=2.0,
                           overlap_seconds=0.5, batch_size=2, device="cpu")
    waves = dict(zip("ab", _waves(40000, 7000, seed=8)))
    off = ex.extract_sequences(waves, verbose=False)
    ex.model._tables.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        on = ex.extract_sequences(waves, verbose=False)
    assert all(np.array_equal(off[n], on[n]) for n in off)
    seen = {e.name for e in prof.events()}
    assert {"conformer.position_table", "conformer.conv_module"} <= seen
    profiling.span_report(reset=True)
    profiling.counters(reset=True)


def test_a_dp_grid_equals_one_device(weights):
    """Rows of a (dp, 1) grid run the model with their own copies of its
    parameters and BatchNorm statistics."""
    waves = dict(zip("abc", _waves(30000, 20000, 9000, seed=9)))
    kwargs = dict(params=weights, config=ConformerConfig(**SMALL), chunk_seconds=2.0,
                  overlap_seconds=0.5, batch_size=2, device="cpu")
    one = Wav2Vec2Extractor(**kwargs).extract_sequences(waves, verbose=False)
    grid = make_mesh(devices=[torch.device("cpu")] * 2, mp=1)
    split = Wav2Vec2Extractor(**dict(kwargs, device=None), mesh=grid)
    assert "layer_0.batch_norm.running_var" in split._sharded.slices
    two = split.extract_sequences(waves, verbose=False)
    for n in waves:
        np.testing.assert_allclose(two[n], one[n], rtol=0, atol=ATOL)


def test_random_init_covers_the_new_parameters():
    m = ConformerModel(ConformerConfig(**SMALL))
    init_weights_(m, torch.Generator().manual_seed(1))
    layer = m.layer_1
    assert torch.all(layer.batch_norm.weight == 1.0) and torch.all(layer.final_norm.weight == 1.0)
    assert torch.all(layer.batch_norm.running_var > 0)
    for p in (layer.pos_bias_u, layer.pos_bias_v, layer.depthwise.weight, layer.pos.weight):
        assert p.std() > 0 and p.abs().max() <= 1.0


# --- the kernel on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    return torch.device("cuda")


# the position term's 64-term dot products and exp take other orders than
# the plain version's cuBLAS product and torch.softmax: a probability
# differs by a few float32 roundings of its logit's scale
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t,lengths", [
    (2, 16, 799, (799, 649)), (3, 4, 249, (249, 100, 1)), (1, 2, 33, (33,)), (2, 3, 1, (1, 0)),
    (2, 2, 1024, (1024, 517)), (16, 16, 799, (799,) * 12 + (649, 400, 150, 24)),
], ids=["16s", "5s", "ragged-tile", "T1", "max-T", "extraction-batch"])
def test_kernel_equals_plain_version(cuda_device, b, h, t, lengths):
    gen = torch.Generator(device=cuda_device).manual_seed(t)
    scores = 2.0 * torch.randn(b, h, t, t, generator=gen, device=cuda_device)
    q_rows = 0.5 * torch.randn(b, t, h, 64, generator=gen, device=cuda_device)
    pos = 0.5 * torch.randn(2 * t - 1, h, 64, generator=gen, device=cuda_device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    q = q_rows.transpose(1, 2)
    want = conformer_ops.relpos_shift_softmax_reference(scores, q, pos, lens)
    before = conformer_ops.relpos_shift_softmax.launches
    got = conformer_ops.relpos_shift_softmax(scores, q, pos, lens)
    torch.cuda.synchronize()
    assert got.data_ptr() == scores.data_ptr()  # in place
    assert conformer_ops.relpos_shift_softmax.launches == before + 1
    torch.testing.assert_close(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    for i, n in enumerate(lengths):
        assert torch.all(got[i, :, :, n:] == 0)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    s = torch.zeros(1, 2, 5, 5, device=cuda_device)
    q, p = torch.zeros(1, 2, 5, 64, device=cuda_device), torch.zeros(9, 2, 64, device=cuda_device)
    n = torch.tensor([5], device=cuda_device)
    with pytest.raises(ValueError, match="heads of 64"):
        conformer_ops.relpos_shift_softmax(s, q[..., :16], p[..., :16], n)
    with pytest.raises(ValueError, match="contiguous"):
        conformer_ops.relpos_shift_softmax(s.transpose(2, 3), q, p, n)
    with pytest.raises(TypeError):
        conformer_ops.relpos_shift_softmax(s, q, p.double(), n)
    t = conformer_ops.MAX_T + 1
    before = conformer_ops.relpos_shift_softmax.launches
    with pytest.raises(ValueError, match=f"at most {conformer_ops.MAX_T} frames"):
        conformer_ops.relpos_shift_softmax(
            torch.zeros(1, 1, t, t, device=cuda_device),
            torch.zeros(1, 1, t, 64, device=cuda_device),
            torch.zeros(2 * t - 1, 1, 64, device=cuda_device), torch.tensor([t], device=cuda_device))
    assert conformer_ops.relpos_shift_softmax.launches == before


@pytest.mark.cuda
def test_encoder_on_card_matches_cpu(cuda_device):
    """A tiny encoder with heads of 64, the kernel on every layer, against the CPU."""
    cfg = ConformerConfig(**dict(SMALL, hidden_size=128, num_heads=2, intermediate_size=256))
    m = ConformerModel(cfg).eval()
    init_weights_(m, torch.Generator().manual_seed(3))
    batch, lengths = _batch(_waves(24000, 13000, seed=10))
    before = conformer_ops.relpos_shift_softmax.launches
    with torch.no_grad():
        cpu, frames = m(batch, lengths)
        card, _ = m.to(cuda_device)(batch.to(cuda_device), lengths.to(cuda_device))
    assert conformer_ops.relpos_shift_softmax.launches == before + cfg.num_layers
    for i in range(2):
        n = int(frames[i])
        torch.testing.assert_close(card[i, :n].cpu(), cpu[i, :n], rtol=0, atol=ATOL)
