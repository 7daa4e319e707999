"""The port's WavLM encoder (``models/wavlm.py``), its relative-position
softmax (``ops/cuda/wavlm.py``) and its extraction route, at a tiny size on
the CPU: against the benchmark's plain reference (``port_bench/reference/
wavlm.py``) on seeded weights, against ``transformers``' own WavLM (skipped
where ``transformers`` is absent), and ragged batches against each chunk
alone. The tests marked ``cuda`` hold the kernel to its plain version on the
card (this file imports no JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_wavlm.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from port_bench.reference import wavlm as ref_wavlm
from port_bench.reference.weights import make_weights
from robust_speech_analysis_framework_tpu_torch.features.wav2vec2 import Wav2Vec2Extractor
from robust_speech_analysis_framework_tpu_torch.models.init import init_weights_
from robust_speech_analysis_framework_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from robust_speech_analysis_framework_tpu_torch.models.wavlm import (
    WavLMConfig,
    WavLMModel,
    port_hf_wavlm_state_dict,
    relative_position_buckets,
)
from robust_speech_analysis_framework_tpu_torch.ops.cuda import wavlm as wavlm_ops
from robust_speech_analysis_framework_tpu_torch.parallel.mesh import make_mesh
from robust_speech_analysis_framework_tpu_torch.utils import profiling

# float32 on the CPU, the same operations in other orders (batched GEMMs,
# a ragged batch's padded shapes): hidden states after the final LayerNorm
# are near unit scale, so 1e-4 absolute holds a few hundred roundings
ATOL = 1e-4
SMALL = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
             conv_dim=(16,) * 7, pos_conv_kernel=16, pos_conv_groups=4,
             num_buckets=32, max_bucket_distance=40)
REF_CFG = dict(SMALL, conv_dim=[16] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2],
               conv_stride=[5, 2, 2, 2, 2, 2, 2], conv_bias=False, layer_norm_eps=1e-5,
               sample_rate=16000, chunk_seconds=2.0, overlap_seconds=0.5, min_seconds=0.5)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # summation orders that do not depend on the host's cores
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    return make_weights(ref_wavlm.wavlm_spec(REF_CFG), 7, "cpu")


@pytest.fixture(scope="module")
def model(weights):
    m = WavLMModel(WavLMConfig(**SMALL)).eval()
    m.load_state_dict(weights)
    return m


def _waves(*lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in lengths]


def test_config_adds_fields_and_wav2vec2_keeps_its_own():
    names = [f.name for f in dataclasses.fields(Wav2Vec2Config)]
    assert names == ["hidden_size", "num_layers", "num_heads", "intermediate_size", "conv_dim",
                     "conv_kernel", "conv_stride", "pos_conv_kernel", "pos_conv_groups",
                     "layer_norm_eps", "compute_dtype"]
    large = WavLMConfig()
    assert (large.hidden_size, large.num_layers, large.num_heads, large.intermediate_size,
            large.num_buckets, large.max_bucket_distance, large.conv_bias) == (
        1024, 24, 16, 4096, 320, 800, False)
    assert large.output_length(256000) == 799


def test_float32_only_and_no_mp_split():
    with pytest.raises(ValueError, match="float32 only"):
        WavLMConfig(**SMALL, compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="float32 only"):
        Wav2Vec2Extractor(config=WavLMConfig(**SMALL), compute_dtype="bfloat16",
                          allow_random_init=True, device="cpu")
    grid = make_mesh(devices=[torch.device("cpu")] * 2, mp=2)
    with pytest.raises(ValueError, match="mp > 1"):
        Wav2Vec2Extractor(config=WavLMConfig(**SMALL), allow_random_init=True, device="cpu",
                          mesh=grid, batch_size=2)


def test_encoder_matches_the_plain_reference(model, weights):
    wav = torch.from_numpy(np.stack(_waves(20000, 20000, seed=1)))
    with torch.no_grad():
        got, n = model(wav)
        ref = ref_wavlm.encode(weights, wav, REF_CFG)
    assert n is None and got.shape == ref.shape == (2, 62, 32)
    torch.testing.assert_close(got, ref, rtol=0, atol=ATOL)


def test_ragged_batch_equals_each_chunk_alone(model):
    waves = _waves(24000, 13000, 6000, seed=2)
    lengths = torch.tensor([len(w) for w in waves])
    batch = torch.zeros(3, 24000)
    for i, w in enumerate(waves):
        batch[i, : len(w)] = torch.from_numpy(w)
    with torch.no_grad():
        hidden, frames = model(batch, lengths)
        for i, w in enumerate(waves):
            alone, _ = model(torch.from_numpy(w)[None])
            assert alone.shape[1] == int(frames[i])
            torch.testing.assert_close(hidden[i, : int(frames[i])], alone[0], rtol=0, atol=ATOL)


def test_bucket_function_equals_the_published_one():
    modeling = pytest.importorskip("transformers.models.wavlm.modeling_wavlm")
    d = torch.arange(-1000, 1001)
    for buckets, distance in ((320, 800), (32, 40)):
        published = modeling.WavLMAttention(64, 4, num_buckets=buckets, max_distance=distance)
        assert torch.equal(relative_position_buckets(d, buckets, distance),
                           published._relative_positions_bucket(d))
    # the benchmark's reference takes the same buckets over a 16 s chunk's pairs and more
    pos = torch.arange(1001)
    assert torch.equal(ref_wavlm.buckets(1001, {"num_buckets": 320, "max_bucket_distance": 800}),
                       relative_position_buckets(pos[None, :] - pos[:, None], 320, 800))


def test_position_buckets_built_once_per_length_under_a_span(model):
    model._buckets.clear()
    profiling.span_report(reset=True)
    with profiling.tracing():
        first = model.position_buckets(37, torch.device("cpu"))
        again = model.position_buckets(37, torch.device("cpu"))
        model.position_buckets(12, torch.device("cpu"))
    report = profiling.span_report(reset=True)
    assert first is again and first.dtype == torch.int32 and first.shape == (73,)
    assert report["wavlm.position_bias"]["calls"] == 2
    assert torch.equal(first.long(), relative_position_buckets(torch.arange(-36, 37), 32, 40))


def test_relpos_softmax_plain_version_masks_keys_and_sums_to_one():
    gen = torch.Generator().manual_seed(0)
    b, h, t, nb = 3, 2, 9, 6
    scores = torch.randn(b, h, t, t, generator=gen)
    gates = 1.0 + torch.rand(b, h, t, generator=gen)
    table = torch.randn(nb, h, generator=gen)
    buckets = torch.randint(0, nb, (2 * t - 1,), generator=gen, dtype=torch.int32)
    lengths = torch.tensor([9, 4, 0], dtype=torch.int32)
    before = scores.clone()
    probs = wavlm_ops.relpos_softmax(scores, gates, table, buckets, lengths)
    assert torch.equal(scores, before)  # the CPU returns a new tensor
    i = 2  # row 1's query 2 by the formula, over its 4 valid keys
    dist = buckets.long()[torch.arange(4) - i + t - 1]
    logits = before[1, 1, i, :4] + gates[1, 1, i] * table[dist, 1]
    # float32 softmax of 4 logits, two orders of the same sum
    torch.testing.assert_close(probs[1, 1, i, :4], torch.softmax(logits, -1), rtol=0, atol=1e-6)
    assert torch.all(probs[1, :, :, 4:] == 0) and torch.all(probs[2] == 0)  # masked / no key
    torch.testing.assert_close(probs[:2].sum(-1), torch.ones(2, h, t), rtol=0, atol=1e-6)


def test_hf_checkpoint_matches_transformers(tmp_path):
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.WavLMConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        conv_dim=(16,) * 7, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        num_buckets=32, max_bucket_distance=40, do_stable_layer_norm=True,
        feat_extract_norm="layer", conv_bias=False)
    torch.manual_seed(0)
    hf = transformers.WavLMModel(hf_cfg).eval()
    with torch.no_grad():  # away from the init's zeros and ones
        for p in hf.parameters():
            p.add_(0.1 * torch.randn_like(p))
    hf.save_pretrained(tmp_path)
    ex = Wav2Vec2Extractor.from_hf_checkpoint(str(tmp_path), device="cpu", chunk_seconds=2.0,
                                              overlap_seconds=0.5, batch_size=2)
    assert isinstance(ex.model, WavLMModel) and ex.config.num_buckets == 32
    waves = _waves(32000, 14000, seed=3)
    mask = torch.zeros(2, 32000, dtype=torch.long)
    padded = torch.zeros(2, 32000)
    for i, w in enumerate(waves):
        padded[i, : len(w)] = torch.from_numpy(w)
        mask[i, : len(w)] = 1
    with torch.no_grad():
        want = hf(padded, attention_mask=mask).last_hidden_state
        got, frames = ex.model(padded, mask.sum(1))
    for i in range(2):
        n = int(frames[i])
        torch.testing.assert_close(got[i, :n], want[i, :n], rtol=0, atol=ATOL)
    sd = port_hf_wavlm_state_dict({"wavlm." + k: v for k, v in hf.state_dict().items()})
    assert set(sd) == set(ex.model.state_dict())
    with pytest.raises(ValueError, match="Large layout"):
        port_hf_wavlm_state_dict({"feature_extractor.conv_layers.0.conv.weight": 0})


ENTRIES = {
    "sequences": lambda ex, w: ex.extract_sequences(w, verbose=False),
    "resident": lambda ex, w: dict(ex.extract_sequences_resident(w, verbose=False, align=16).items()),
    "embeddings": lambda ex, w: dict(zip(*ex.extract_embeddings_arrays(w, verbose=False))),
}


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_extractor_entry_points_give_hidden_width_rows(weights, entry):
    ex = Wav2Vec2Extractor(params=weights, config=WavLMConfig(**SMALL), chunk_seconds=2.0,
                           overlap_seconds=0.5, batch_size=2, device="cpu")
    names = ("a", "b", "c")
    waves = dict(zip(names, _waves(45000, 20000, 9000, seed=4)))
    profiling.counters(reset=True)
    off = ENTRIES[entry](ex, waves)
    with profiling.tracing():
        on = ENTRIES[entry](ex, waves)
    seen = profiling.counters(reset=True)
    assert sorted(off) == sorted(on) == list(names)
    for n in names:
        assert np.array_equal(off[n], on[n])  # tracing moves no bit
    ref = ref_wavlm.sequences(weights, waves, REF_CFG, "cpu")
    for n in names:
        if entry == "embeddings":
            assert off[n].shape == (32,)
            np.testing.assert_allclose(off[n], ref[n].mean(0), rtol=0, atol=ATOL)
        else:
            assert off[n].shape == ref[n].shape and off[n].shape[1] == 32
            np.testing.assert_allclose(off[n], ref[n], rtol=0, atol=ATOL)
    chunks = [len(c) for w in waves.values() for c in ex._chunk(w)]
    pairs = sum(ex._frames(c) ** 2 for c in chunks)
    slots = -(-len(chunks) // 2) * 2
    assert seen["w2v2.attn_pairs"] == pairs
    assert seen["w2v2.attn_pad_pairs"] == slots * ex._frames(ex.chunk_size) ** 2 - pairs


def test_outputs_equal_under_the_profiler(weights):
    ex = Wav2Vec2Extractor(params=weights, config=WavLMConfig(**SMALL), chunk_seconds=2.0,
                           overlap_seconds=0.5, batch_size=2, device="cpu")
    waves = dict(zip("ab", _waves(40000, 7000, seed=5)))
    off = ex.extract_sequences(waves, verbose=False)
    ex.model._buckets.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        on = ex.extract_sequences(waves, verbose=False)
    assert all(np.array_equal(off[n], on[n]) for n in off)
    assert "wavlm.position_bias" in {e.name for e in prof.events()}
    profiling.span_report(reset=True)
    profiling.counters(reset=True)


def test_random_init_covers_the_new_parameters():
    m = WavLMModel(WavLMConfig(**SMALL))
    init_weights_(m, torch.Generator().manual_seed(1))
    assert torch.all(m.layer_1.gru_rel_pos_const == 1.0)
    assert torch.all(m.feature_encoder.norm_3.weight == 1.0)
    assert m.rel_attn_embed.weight.abs().max() <= 0.5 and m.rel_attn_embed.weight.std() > 0.1


@pytest.mark.parametrize("masked", [True, False], ids=["lengths", "no-lengths"])
@pytest.mark.parametrize("conv_bias", [False, True], ids=["no-bias", "bias"])
def test_layer_mode_stack_equals_the_former_inline_stack(monkeypatch, conv_bias, masked):
    """The conv stack's output on the CPU is its former code's bit for bit
    (each conv on (B, C, T), LayerNorm and GELU on its (B, T, C) view, with
    or without the convs' bias), with the former strides; conv_1 ... go
    through ``feature_conv`` (six calls, no GELU, the conv's bias)."""
    import torch.nn.functional as F

    from robust_speech_analysis_framework_tpu_torch.device import conv1d
    from robust_speech_analysis_framework_tpu_torch.models import wavlm as wavlm_model

    calls = []
    feature_conv = wavlm_model.feature_conv

    def spy(x, weight, bias, stride, gelu, *args, **kwargs):
        calls.append((stride, gelu, bias is None))
        return feature_conv(x, weight, bias, stride, gelu, *args, **kwargs)

    monkeypatch.setattr(wavlm_model, "feature_conv", spy)
    torch.manual_seed(0)
    cfg = WavLMConfig(**dict(SMALL, conv_bias=conv_bias))
    encoder = wavlm_model.LayerNormFeatureEncoder(cfg)
    init_weights_(encoder, torch.Generator().manual_seed(2))
    wav = torch.zeros(2, 7000)
    for i, w in enumerate(_waves(7000, 5100, seed=4)):
        wav[i, :len(w)] = torch.from_numpy(w)
    lengths = torch.tensor([7000, 5100]) if masked else None
    with torch.no_grad():
        got, got_lens = encoder(wav, lengths)
        h, cur = wav[:, None, :], lengths
        for i, (k, st) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride)):
            if cur is not None:
                cur = torch.div(cur - k, st, rounding_mode="floor") + 1
            conv, norm = getattr(encoder, f"conv_{i}"), getattr(encoder, f"norm_{i}")
            h = conv1d(h, conv.weight, conv.bias, torch.float32, stride=st)
            h = F.gelu(F.layer_norm(h.transpose(1, 2), (h.shape[1],), norm.weight, norm.bias,
                                    norm.eps)).transpose(1, 2)
        former = h.transpose(1, 2)
    assert torch.equal(got, former) and got.stride() == former.stride()
    assert calls == [(2, False, not conv_bias)] * 6
    if masked:
        assert torch.equal(got_lens, cur)


# --- the kernel on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    return torch.device("cuda")


# the logits are bit-equal (the same two roundings); exp and the sums'
# order differ: a probability differs by a few float32 roundings of itself
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-7


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t", [(3, 16, 799), (2, 4, 137), (2, 3, 300), (1, 2, 1100)])
def test_relpos_kernel_equals_plain_version(cuda_device, b, h, t):
    gen = torch.Generator(device=cuda_device).manual_seed(t)
    scores = 4.0 * torch.randn(b, h, t, t, generator=gen, device=cuda_device)
    gates = 1.0 + torch.rand(b, h, t, generator=gen, device=cuda_device)
    table = torch.randn(320, h, generator=gen, device=cuda_device)
    buckets = relative_position_buckets(torch.arange(-(t - 1), t), 320, 800).to(
        torch.int32).to(cuda_device)
    lengths = torch.tensor([t, t // 3, 1][:b], dtype=torch.int32, device=cuda_device)
    want = wavlm_ops.relpos_softmax_reference(scores, gates, table, buckets, lengths)
    before = wavlm_ops.relpos_softmax.launches
    got = wavlm_ops.relpos_softmax(scores, gates, table, buckets, lengths)
    torch.cuda.synchronize()
    assert got.data_ptr() == scores.data_ptr()  # in place
    assert wavlm_ops.relpos_softmax.launches == before + 1
    torch.testing.assert_close(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    for i, n in enumerate(lengths.tolist()):
        assert torch.all(got[i, :, :, n:] == 0)


@pytest.mark.cuda
def test_relpos_kernel_rejects_what_it_does_not_take(cuda_device):
    s = torch.zeros(1, 2, 5, 5, device=cuda_device)
    g, tab = torch.ones(1, 2, 5, device=cuda_device), torch.zeros(4, 2, device=cuda_device)
    bk, n = torch.zeros(9, dtype=torch.int32, device=cuda_device), torch.tensor([5], device=cuda_device)
    with pytest.raises(TypeError):
        wavlm_ops.relpos_softmax(s, g, tab, bk.long(), n)
    with pytest.raises(ValueError):
        wavlm_ops.relpos_softmax(s.transpose(2, 3), g, tab, bk, n)
    with pytest.raises(ValueError):
        wavlm_ops.relpos_softmax(s, g[:, :, :4], tab, bk, n)


@pytest.mark.cuda
def test_encoder_on_card_matches_cpu(cuda_device, weights):
    """The whole tiny encoder, the kernel on every layer, against the CPU."""
    m = WavLMModel(WavLMConfig(**SMALL)).eval()
    m.load_state_dict(weights)
    waves = _waves(24000, 13000, seed=6)
    batch = torch.zeros(2, 24000)
    for i, w in enumerate(waves):
        batch[i, : len(w)] = torch.from_numpy(w)
    lengths = torch.tensor([24000, 13000])
    before = wavlm_ops.relpos_softmax.launches
    with torch.no_grad():
        cpu, frames = m(batch, lengths)
        card, _ = m.to(cuda_device)(batch.to(cuda_device), lengths.to(cuda_device))
    assert wavlm_ops.relpos_softmax.launches == before + SMALL["num_layers"]
    for i in range(2):
        n = int(frames[i])
        torch.testing.assert_close(card[i, :n].cpu(), cpu[i, :n], rtol=0, atol=ATOL)
