"""Port's Wav2Vec2 encoder and extractor vs the JAX package's, on the CPU.

A small config (hidden 32, 2 layers, 4 heads, conv_dim 16, positional
kernel 16 / groups 4) with perturbed JAX weights carried over by
``wav2vec2_state_dict_from_flat``. Tolerance: atol 1e-4 on hidden states
(float32 conv stack + 2 post-norm layers, different summation orders;
LayerNorm keeps the values near unit scale).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from robust_speech_analysis_framework_tpu.features.wav2vec2 import (
    Wav2Vec2Extractor as JaxExtractor,
)
from robust_speech_analysis_framework_tpu.models.wav2vec2 import (
    Wav2Vec2Config as JaxConfig,
    Wav2Vec2Model as JaxModel,
    port_hf_state_dict as jax_port_hf,
)
from robust_speech_analysis_framework_tpu.train.checkpoints import flatten_params
from robust_speech_analysis_framework_tpu_torch.features.wav2vec2 import Wav2Vec2Extractor
from robust_speech_analysis_framework_tpu_torch.models.wav2vec2 import (
    Wav2Vec2Config,
    Wav2Vec2Model,
    port_hf_state_dict,
)
from robust_speech_analysis_framework_tpu_torch.models.weights import (
    wav2vec2_state_dict_from_flat,
)

ATOL = 1e-4
SMALL = dict(
    hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
    conv_dim=(16,) * 7, pos_conv_kernel=16, pos_conv_groups=4,
)


@pytest.fixture(scope="module")
def jax_params():
    model = JaxModel(JaxConfig(**SMALL))
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4000)))
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), params
    )


@pytest.fixture(scope="module")
def port_model(jax_params):
    model = Wav2Vec2Model(Wav2Vec2Config(**SMALL))
    model.load_state_dict(wav2vec2_state_dict_from_flat(flatten_params(jax_params)))
    return model.eval()


def test_ragged_batch_matches_jax_on_valid_frames(jax_params, port_model):
    rng = np.random.default_rng(1)
    wav = (rng.normal(size=(3, 8000)) * 0.1).astype(np.float32)
    lengths = np.array([8000, 5000, 3300], np.int32)
    for i, n in enumerate(lengths):
        wav[i, n:] = 0.0
    ref, ref_lens = JaxModel(JaxConfig(**SMALL)).apply(
        jax_params, jnp.asarray(wav), lengths=jnp.asarray(lengths)
    )
    with torch.no_grad():
        ours, our_lens = port_model(torch.from_numpy(wav), torch.from_numpy(lengths))
    np.testing.assert_array_equal(our_lens.numpy(), np.asarray(ref_lens))
    for i, n in enumerate(np.asarray(ref_lens)):
        np.testing.assert_allclose(ours[i, :n].numpy(), np.asarray(ref)[i, :n], atol=ATOL)


def test_unmasked_forward_matches_jax(jax_params, port_model):
    wav = (np.random.default_rng(2).normal(size=(2, 6000)) * 0.1).astype(np.float32)
    ref, _ = JaxModel(JaxConfig(**SMALL)).apply(jax_params, jnp.asarray(wav))
    with torch.no_grad():
        ours, lens = port_model(torch.from_numpy(wav))
    assert lens is None
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)


def _synthetic_hf_state_dict(rng, prefix=""):
    d, f, k, groups = 32, 64, 16, 4
    sd = {}

    def put(name, shape):
        sd[prefix + name] = (rng.normal(size=shape) * 0.1).astype(np.float32)

    for i in range(7):
        put(f"feature_extractor.conv_layers.{i}.conv.weight",
            (16, 1 if i == 0 else 16, JaxConfig().conv_kernel[i]))
    put("feature_extractor.conv_layers.0.layer_norm.weight", (16,))
    put("feature_extractor.conv_layers.0.layer_norm.bias", (16,))
    put("feature_projection.layer_norm.weight", (16,))
    put("feature_projection.layer_norm.bias", (16,))
    put("feature_projection.projection.weight", (d, 16))
    put("feature_projection.projection.bias", (d,))
    put("encoder.pos_conv_embed.conv.weight_g", (1, 1, k))
    put("encoder.pos_conv_embed.conv.weight_v", (d, d // groups, k))
    put("encoder.pos_conv_embed.conv.bias", (d,))
    put("encoder.layer_norm.weight", (d,))
    put("encoder.layer_norm.bias", (d,))
    put("masked_spec_embed", (d,))  # unused by inference: must be ignored
    for i in range(2):
        pre = f"encoder.layers.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            put(pre + f"attention.{proj}.weight", (d, d))
            put(pre + f"attention.{proj}.bias", (d,))
        for ln in ("layer_norm", "final_layer_norm"):
            put(pre + f"{ln}.weight", (d,))
            put(pre + f"{ln}.bias", (d,))
        put(pre + "feed_forward.intermediate_dense.weight", (f, d))
        put(pre + "feed_forward.intermediate_dense.bias", (f,))
        put(pre + "feed_forward.output_dense.weight", (d, f))
        put(pre + "feed_forward.output_dense.bias", (d,))
    return sd


@pytest.mark.parametrize("prefix", ["", "wav2vec2."], ids=["backbone", "ctc_head"])
def test_port_hf_state_dict_matches_jax(prefix):
    hf = _synthetic_hf_state_dict(np.random.default_rng(3), prefix)
    carried = wav2vec2_state_dict_from_flat(flatten_params(jax_port_hf(hf)))
    ours = port_hf_state_dict(hf)
    assert set(ours) == set(carried)
    for key in ours:
        torch.testing.assert_close(ours[key], carried[key], rtol=0, atol=1e-7)
    model = Wav2Vec2Model(Wav2Vec2Config(**SMALL))
    model.load_state_dict(ours)  # strict: every parameter named and shaped
    with pytest.raises(ValueError, match="feature_extractor"):
        port_hf_state_dict({"foo.weight": np.zeros(3)})


def test_extract_sequences_matches_jax(jax_params):
    rng = np.random.default_rng(4)
    waves = {
        "short.wav": (rng.normal(size=4800) * 0.1).astype(np.float32),  # 0.3 s: skipped
        "one.wav": (rng.normal(size=19200) * 0.1).astype(np.float32),  # 1.2 s: one chunk
        "long.wav": (rng.normal(size=152000) * 0.1).astype(np.float32),  # 9.5 s: 3 chunks
    }
    jax_ex = JaxExtractor(params=jax_params, config=JaxConfig(**SMALL), batch_size=3)
    sd = wav2vec2_state_dict_from_flat(flatten_params(jax_params))
    ex = Wav2Vec2Extractor(params=sd, config=Wav2Vec2Config(**SMALL), batch_size=3, device="cpu")
    assert ex.pretrained
    ref = jax_ex.extract_sequences(waves, verbose=False)
    ours = ex.extract_sequences(waves, verbose=False)
    assert sorted(ours) == sorted(ref) == ["long.wav", "one.wav"]
    cfg = Wav2Vec2Config(**SMALL)
    # overlaps are kept: 5 s + 5 s + 1.5 s chunks
    assert ours["long.wav"].shape == (2 * cfg.output_length(80000) + cfg.output_length(24000), 32)
    for name in ref:
        assert ours[name].dtype == np.float32
        np.testing.assert_allclose(ours[name], ref[name], atol=ATOL)
    assert ex.extract_sequences({"short.wav": waves["short.wav"]}, verbose=False) == {}


def test_extractor_guards():
    with pytest.raises(ValueError, match="without weights"):
        Wav2Vec2Extractor(config=Wav2Vec2Config(**SMALL), device="cpu")
    with pytest.raises(ValueError, match="overlap_seconds"):
        Wav2Vec2Extractor(config=Wav2Vec2Config(**SMALL), overlap_seconds=5.0,
                          allow_random_init=True, device="cpu")
    with pytest.warns(UserWarning, match="RANDOM"):
        a = Wav2Vec2Extractor(config=Wav2Vec2Config(**SMALL), allow_random_init=True,
                              seed=5, device="cpu")
    with pytest.warns(UserWarning):
        b = Wav2Vec2Extractor(config=Wav2Vec2Config(**SMALL), allow_random_init=True,
                              seed=5, device="cpu")
    assert not a.pretrained
    for va, vb in zip(a.model.state_dict().values(), b.model.state_dict().values()):
        assert torch.equal(va, vb)


def test_from_hf_checkpoint_matches_transformers_and_jax(tmp_path):
    """A tiny HF checkpoint on disk loads into the port; its hidden states
    match ``transformers`` itself and its sequences match the JAX extractor."""
    from transformers import Wav2Vec2Config as HFConfig, Wav2Vec2Model as HFModel

    torch.manual_seed(0)
    hf = HFModel(HFConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        conv_dim=(16,) * 7, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        feat_extract_norm="group", do_stable_layer_norm=False,
    )).eval()
    hf.save_pretrained(str(tmp_path))
    ex = Wav2Vec2Extractor.from_hf_checkpoint(
        str(tmp_path), config=Wav2Vec2Config(**SMALL), batch_size=2, device="cpu")
    wav = (np.random.default_rng(5).normal(size=19200) * 0.1).astype(np.float32)
    with torch.no_grad():
        ref = hf(torch.from_numpy(wav)[None]).last_hidden_state[0].numpy()
        ours, _ = ex.model(torch.from_numpy(wav)[None])
    np.testing.assert_allclose(ours[0].numpy(), ref, atol=ATOL)

    jax_ex = JaxExtractor.from_hf_checkpoint(str(tmp_path), config=JaxConfig(**SMALL),
                                             batch_size=2)
    waves = {"one.wav": wav}
    np.testing.assert_allclose(
        ex.extract_sequences(waves, verbose=False)["one.wav"],
        jax_ex.extract_sequences(waves, verbose=False)["one.wav"], atol=ATOL,
    )


def _conv0_inputs(seed, b=3, n=23_004, c=16):
    rng = np.random.default_rng(seed)
    wav = (0.1 * rng.normal(size=(b, n))).astype(np.float32)
    samples = np.array([n, 8_000, 12_347][:b])
    for i, m in enumerate(samples):
        wav[i, m:] = 0.0
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return (f32(wav), torch.from_numpy(((samples - 10) // 5 + 1).astype(np.int32)),
            f32(rng.normal(size=(c, 1, 10)) / np.sqrt(10)), f32(1 + 0.2 * rng.normal(size=c)),
            f32(0.1 * rng.normal(size=c)))


@pytest.mark.parametrize("masked", [True, False], ids=["lengths", "no-lengths"])
def test_conv0_plain_version_equals_the_former_inline_block(masked):
    """The first block's plain version, and the wrapper on CPU tensors, give
    the encoder's former inline code bit for bit."""
    from robust_speech_analysis_framework_tpu_torch.device import conv1d
    from robust_speech_analysis_framework_tpu_torch.ops.cuda.wav2vec2 import (
        conv0_norm_gelu,
        conv0_norm_gelu_reference,
    )

    wav, frames, weight, scale, bias = _conv0_inputs(8)
    lengths = frames if masked else None
    # the feature encoder's first block as it was written inline
    h = conv1d(wav[:, None, :], weight, None, torch.float32, stride=5).float()
    if lengths is None:
        mean = h.mean(dim=2, keepdim=True)
        var = h.var(dim=2, unbiased=False, keepdim=True)
    else:
        t = torch.arange(h.shape[2])
        mask = (t[None, None, :] < lengths[:, None, None]).to(h.dtype)
        n = mask.sum(dim=2, keepdim=True).clamp(min=1.0)
        mean = (h * mask).sum(dim=2, keepdim=True) / n
        var = (((h - mean) * mask) ** 2).sum(dim=2, keepdim=True) / n
    h = (h - mean) * torch.rsqrt(var + 1e-5)
    former = torch.nn.functional.gelu(h * scale[:, None] + bias[:, None])
    assert torch.equal(conv0_norm_gelu_reference(wav, weight, scale, bias, lengths, 1e-5), former)
    assert torch.equal(conv0_norm_gelu(wav, weight, scale, bias, lengths, 1e-5), former)


@pytest.mark.parametrize("masked", [True, False], ids=["lengths", "no-lengths"])
def test_conv0_patch_moments_give_the_masked_norm_statistics(masked):
    """The kernel's statistics, in float64 on the CPU: the patches' mean and
    centred covariance by segment of ``SEGMENT_FRAMES`` frames, merged in
    order by Chan's formula, give each channel's masked mean and variance of
    the conv's output (w·m, wᵀSw)."""
    SEGMENT_FRAMES = 2048  # csrc/feature_conv0.cu: kSegFrames

    wav, frames, weight, _, _ = _conv0_inputs(9, n=3 * SEGMENT_FRAMES * 5 + 777)
    x = wav.double().numpy()
    w = weight[:, 0].double().numpy()
    t_all = (x.shape[1] - 10) // 5 + 1
    for b in range(x.shape[0]):
        n = int(frames[b]) if masked else t_all
        count, mean, m2 = 0, np.zeros(10), np.zeros((10, 10))
        for t0 in range(0, t_all, SEGMENT_FRAMES):
            ns = max(0, min(SEGMENT_FRAMES, n - t0))
            if ns == 0:
                continue
            p = x[b][(t0 + np.arange(ns))[:, None] * 5 + np.arange(10)]
            m = p.mean(0)
            d = p - m
            delta = m - mean
            f = ns / (count + ns)
            m2 = m2 + d.T @ d + np.outer(delta, delta) * count * f
            mean, count = mean + delta * f, count + ns
        conv = np.stack([x[b][t * 5: t * 5 + 10] @ w.T for t in range(n)])  # (n, C)
        np.testing.assert_allclose(w @ mean, conv.mean(0), rtol=0, atol=1e-12)
        np.testing.assert_allclose(np.einsum("cj,jk,ck->c", w, m2 / count, w), conv.var(0),
                                   rtol=1e-10, atol=0)


def test_conv0_wrapper_guards():
    from robust_speech_analysis_framework_tpu_torch.ops.cuda.wav2vec2 import conv0_norm_gelu

    wav, frames, weight, scale, bias = _conv0_inputs(10)
    with pytest.raises(ValueError, match="shorter than"):
        conv0_norm_gelu(wav[:, :9], weight, scale, bias, None, 1e-5)
    with pytest.raises(ValueError, match="gn_scale"):
        conv0_norm_gelu(wav, weight, scale[:3], bias, frames, 1e-5)
    with pytest.raises(ValueError, match="lengths"):
        conv0_norm_gelu(wav, weight, scale, bias, frames[:2], 1e-5)
    with pytest.raises(ValueError, match=r"\(C, 1, K\)"):
        conv0_norm_gelu(wav, weight[:, 0], scale, bias, frames, 1e-5)


def test_conv0_dispatch_keeps_cpu_tensors_off_the_build(monkeypatch, port_model):
    """On CPU tensors the wrapper, and the float32 encoder through it, never
    reach the CUDA build or count a launch."""
    from robust_speech_analysis_framework_tpu_torch.ops.cuda import _build
    from robust_speech_analysis_framework_tpu_torch.ops.cuda import wav2vec2 as w2v_ops

    def no_build(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the CUDA build")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "call", no_build)
    monkeypatch.setattr(w2v_ops, "_call", no_build)
    monkeypatch.setattr(w2v_ops, "_load", no_build)
    before = w2v_ops.conv0_norm_gelu.launches
    wav, frames, weight, scale, bias = _conv0_inputs(11)
    w2v_ops.conv0_norm_gelu(wav, weight, scale, bias, frames, 1e-5)
    with torch.no_grad():
        port_model(wav[:, :8000], torch.tensor([8000, 6000, 4000], dtype=torch.int32))
    assert w2v_ops.conv0_norm_gelu.launches == before


def _spy_routes(monkeypatch, plain_name: str) -> dict:
    """Spies inside ``ops/cuda/wav2vec2.py``: each routing decision (device
    type, compute dtype, whether the kernel would launch on a CUDA tensor)
    and the compute dtype of each call of the plain version ``plain_name``."""
    from robust_speech_analysis_framework_tpu_torch.ops.cuda import wav2vec2 as w2v_ops

    calls = {"route": [], "plain": []}
    route, plain = w2v_ops._uses_kernel, getattr(w2v_ops, plain_name)

    def spy_route(device, cdt):
        calls["route"].append((device.type, cdt, route(torch.device("cuda"), cdt)))
        return route(device, cdt)

    def spy_plain(*args):
        calls["plain"].append(args[-1])
        return plain(*args)

    monkeypatch.setattr(w2v_ops, "_uses_kernel", spy_route)
    monkeypatch.setattr(w2v_ops, plain_name, spy_plain)
    return calls


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_feature_encoder_routes_its_first_block_by_compute_dtype(monkeypatch, compute_dtype):
    """The encoder hands its compute dtype to ``conv0_norm_gelu``, which
    decides: float32 takes the kernel on a CUDA tensor (the plain version on
    the CPU), the bfloat16 preset its first block's plain version with its
    conv in bfloat16; the other six convs go through ``feature_conv``, which
    decides by the same rule."""
    from robust_speech_analysis_framework_tpu_torch.models import wav2vec2 as w2v_model

    calls = _spy_routes(monkeypatch, "conv0_norm_gelu_reference")
    calls["conv"] = 0
    conv = w2v_model.feature_conv

    def spy_conv(*args, **kwargs):
        calls["conv"] += 1
        return conv(*args, **kwargs)

    monkeypatch.setattr(w2v_model, "feature_conv", spy_conv)
    torch.manual_seed(0)
    encoder = w2v_model.FeatureEncoder(Wav2Vec2Config(**SMALL, compute_dtype=compute_dtype))
    wav = torch.from_numpy((0.1 * np.random.default_rng(12).normal(size=(2, 6000)))
                           .astype(np.float32))
    with torch.no_grad():
        feats, lens = encoder(wav, torch.tensor([6000, 4100], dtype=torch.int32))
    assert feats.shape == (2, Wav2Vec2Config(**SMALL).output_length(6000), 16)
    cdt = torch.float32 if compute_dtype == "float32" else torch.bfloat16
    assert calls == {"conv": 6, "route": [("cpu", cdt, compute_dtype == "float32")] * 7,
                     "plain": [cdt]}


@pytest.mark.parametrize("masked", [True, False], ids=["lengths", "no-lengths"])
def test_conv0_plain_version_in_bfloat16_equals_the_former_inline_block(masked):
    """The bfloat16 preset's first block, now the plain version with its
    conv in bfloat16, gives the encoder's former inline code bit for bit:
    the conv's output rounded to bfloat16, then the norm in float32."""
    from robust_speech_analysis_framework_tpu_torch.device import conv1d
    from robust_speech_analysis_framework_tpu_torch.ops.cuda.wav2vec2 import (
        conv0_norm_gelu_reference,
        masked_channel_norm,
    )

    wav, frames, weight, scale, bias = _conv0_inputs(13)
    lengths = frames if masked else None
    h = conv1d(wav[:, None, :], weight, None, torch.bfloat16, stride=5)
    assert h.dtype == torch.bfloat16
    h = masked_channel_norm(h.float(), lengths, 1e-5)
    former = torch.nn.functional.gelu(h * scale[:, None] + bias[:, None])
    got = conv0_norm_gelu_reference(wav, weight, scale, bias, lengths, 1e-5, cdt=torch.bfloat16)
    assert got.dtype == torch.float32
    assert torch.equal(got, former)


# --- conv_1 ... conv_6: plain version, the kernel's arithmetic, plan, dispatch ------------

FEAT_CASES = {  # (B, T_in, C_in, C_out, K, stride)
    "k3": (3, 41, 16, 64, 3, 2),
    "k2": (2, 30, 32, 64, 2, 2),
    "k3-odd-t": (2, 24, 16, 128, 3, 2),
    "one-frame": (1, 3, 16, 64, 3, 2),
    "narrow": (2, 33, 20, 12, 3, 2),  # K C_in = 60: a last stage of 12 floats
}


def _feat_inputs(seed, b, t, c_in, c_out, k, stride):
    """x as the encoder hands it over: a (B, T, C_in) view of a (B, C_in, T)
    tensor; weight (C_out, C_in, K); bias (C_out,)."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    x = f32(rng.normal(size=(b, c_in, t))).transpose(1, 2)
    return (x, f32(rng.normal(size=(c_out, c_in, k)) / np.sqrt(c_in * k)),
            f32(0.1 * rng.normal(size=c_out)))


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["no-bias", "bias"])
@pytest.mark.parametrize("gelu", [True, False], ids=["group-mode", "layer-mode"])
def test_feature_conv_plain_version_equals_the_former_inline_code(gelu, with_bias, cdt):
    """The plain version gives the encoders' former inline conv bit for bit:
    group mode ``F.gelu(conv1d(h, ...))`` and layer mode ``conv1d(h, ...)``
    on the (B, C, T) tensor, in the compute dtype; it returns the (B, T, C)
    view of that result. On CPU tensors the wrapper is the plain version."""
    from robust_speech_analysis_framework_tpu_torch.device import conv1d
    from robust_speech_analysis_framework_tpu_torch.ops.cuda.wav2vec2 import (
        feature_conv,
        feature_conv_reference,
    )

    x, weight, bias = _feat_inputs(40, *FEAT_CASES["k3"])
    bias = bias if with_bias else None
    h = conv1d(x.transpose(1, 2), weight, bias, cdt, stride=2)
    former = torch.nn.functional.gelu(h) if gelu else h
    got = feature_conv_reference(x, weight, bias, 2, gelu, cdt)
    assert got.dtype == cdt and got.shape == (3, 20, 64)
    assert torch.equal(got.transpose(1, 2), former) and got.transpose(1, 2).is_contiguous()
    assert torch.equal(feature_conv(x, weight, bias, 2, gelu, cdt=cdt), got)


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("case", sorted(FEAT_CASES))
def test_feature_conv_kernel_rows_and_weights_emulated(case, splits):
    """The kernel's arithmetic in float64: each row b's overlapping A rows
    (``as_strided`` of the (T_in, C_in) row with row stride s C_in, K C_in
    wide) times the weights as the wrapper lays them out ((K C_in, C_out)),
    the reduction cut into the plan's splits of whole 16-float stages and
    added in split order, with the bias and GELU, give the plain version's
    output (K = 2 and 3 at stride 2, a T_in whose last frame no output reads,
    one output frame). The rows past B T_out of the last tile read the last
    row (the kernel's clamp) and stay inside x."""
    from robust_speech_analysis_framework_tpu_torch.ops.cuda.wav2vec2 import (
        FEAT_BK,
        _feature_conv_weights,
        feature_conv_reference,
    )

    b, t, c_in, c_out, k, s = FEAT_CASES[case]
    x, weight, bias = _feat_inputs(41, b, t, c_in, c_out, k, s)
    x = x.contiguous()  # the kernel reads (B, T, C) contiguous
    wt = _feature_conv_weights(weight)
    assert wt.shape == (k * c_in, c_out) and wt.is_contiguous()
    assert torch.equal(wt[2 * c_in + 5], weight[:, 5, 2]) if k == 3 else True
    t_out = (t - k) // s + 1
    kc, m, bm = k * c_in, b * t_out, 64
    rows = torch.cat([x[i].reshape(-1).as_strided((t_out, kc), (s * c_in, 1)) for i in range(b)])
    # the kernel's per-thread pointers: row m of a tile -> (b, t), clamped to the last row
    mm = torch.clamp(torch.arange(-(-m // bm) * bm), max=m - 1)
    offsets = ((mm // t_out) * t + s * (mm % t_out)) * c_in
    assert int(offsets.max()) + kc <= x.numel()
    gathered = x.reshape(-1)[offsets[:, None] + torch.arange(kc)]
    assert torch.equal(gathered[:m], rows)
    n_stages = -(-kc // FEAT_BK)  # a last stage past K C_in reads zeros
    while (splits - 1) * -(-n_stages // splits) >= n_stages:
        splits -= 1  # the plans leave no split empty
    per = -(-n_stages // splits)
    edges = [min(kc, i * per * FEAT_BK) for i in range(splits + 1)]
    assert edges[-1] == kc and all(lo < hi for lo, hi in zip(edges, edges[1:]))
    a, w64 = rows.double(), wt.double()
    y = sum(a[:, lo:hi] @ w64[lo:hi] for lo, hi in zip(edges, edges[1:])) + bias.double()
    emulated = torch.nn.functional.gelu(y).reshape(b, t_out, c_out)
    ref = feature_conv_reference(x, weight, bias, s, True).double()
    assert float((emulated - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


FEAT_BATCHES = {  # each conv's (B, T_in): both encoders' extraction batches, one chunk
    "wav2vec2-base": [(16, t) for t in (15_999, 7_999, 3_999, 1_999, 999, 499)],
    "wavlm-large": [(16, t) for t in (51_199, 25_599, 12_799, 6_399, 3_199, 1_599)],
    "serving": [(1, t) for t in (15_999, 7_999, 3_999, 1_999, 999, 499)],
    "wavlm-serving": [(1, t) for t in (51_199, 25_599, 12_799, 6_399, 3_199, 1_599)],
}


@pytest.mark.parametrize("batch", sorted(FEAT_BATCHES))
def test_feature_conv_plan_fills_the_sms(batch):
    """At both encoders' batches and at one chunk, every conv's plan is a
    tile the kernel builds, fits a block's shared memory, leaves no split
    empty, splits only tiles that do not fill a round, and gives at least 95 %
    of the H100's 132 SMs a block (128 blocks of 64 × 128 at one chunk's
    conv_3 ran within 3 % of every other plan there)."""
    from robust_speech_analysis_framework_tpu_torch.ops.cuda.wav2vec2 import (
        FEAT_BK,
        FEAT_TILES,
        SMEM_BLOCK,
        feature_conv_plan,
        feature_conv_smem_bytes,
    )

    for (b, t), k in zip(FEAT_BATCHES[batch], (3, 3, 3, 3, 2, 2)):
        m, kc = b * ((t - k) // 2 + 1), 512 * k
        bm, bn, splits = feature_conv_plan(m, 512, kc, 132)
        assert (bm, bn) in FEAT_TILES and feature_conv_smem_bytes(bm, bn) <= SMEM_BLOCK
        per = -(-(kc // FEAT_BK) // splits)
        assert (splits - 1) * per < kc // FEAT_BK
        tiles = -(-m // bm) * (512 // bn)
        assert splits == 1 or tiles < 132 * FEAT_TILES[(bm, bn)]
        assert tiles * splits >= 0.95 * 132, (batch, t, (bm, bn, splits))
    assert feature_conv_plan(1000, 12, 60, 132)[:2] in FEAT_TILES  # channels no tile divides


def test_feature_conv_wrapper_guards():
    from robust_speech_analysis_framework_tpu_torch.ops.cuda.wav2vec2 import feature_conv

    x, weight, bias = _feat_inputs(42, *FEAT_CASES["k3"])
    with pytest.raises(ValueError, match=r"\(B, T, C_in\)"):
        feature_conv(x[0], weight, bias, 2, True)
    with pytest.raises(ValueError, match=r"\(B, T, C_in\)"):
        feature_conv(x[:, :, :8], weight, bias, 2, True)
    with pytest.raises(ValueError, match="bias"):
        feature_conv(x, weight, bias[:8], 2, True)
    with pytest.raises(ValueError, match="stride"):
        feature_conv(x, weight, bias, 0, True)
    with pytest.raises(ValueError, match="fewer than"):
        feature_conv(x[:, :2], weight, bias, 2, True)
    with pytest.raises(ValueError, match="unsupported device"):
        feature_conv(x.to("meta"), weight.to("meta"), bias.to("meta"), 2, True)


def test_feature_conv_dispatch_keeps_cpu_tensors_off_the_build(monkeypatch, port_model):
    """On CPU tensors the strided convs' wrapper, and the float32 encoder
    through it, never reach the CUDA build or count a launch."""
    from robust_speech_analysis_framework_tpu_torch.ops.cuda import _build
    from robust_speech_analysis_framework_tpu_torch.ops.cuda import wav2vec2 as w2v_ops

    def no_build(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the CUDA build")

    for name in ("load", "call"):
        monkeypatch.setattr(_build, name, no_build)
    for name in ("_call", "_load", "_launch_feature_conv", "feature_conv_plan"):
        monkeypatch.setattr(w2v_ops, name, no_build)
    before = w2v_ops.feature_conv.launches
    x, weight, bias = _feat_inputs(43, *FEAT_CASES["k2"])
    with torch.no_grad():
        w2v_ops.feature_conv(x, weight, bias, 2, False)
        port_model(torch.zeros(2, 8000), torch.tensor([8000, 6000], dtype=torch.int32))
    assert w2v_ops.feature_conv.launches == before


@pytest.mark.parametrize("masked", [True, False], ids=["lengths", "no-lengths"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_feature_encoder_output_equals_the_former_inline_stack(compute_dtype, masked):
    """The encoder's output on the CPU is its former code's bit for bit: the
    first block, then each conv in the compute dtype on (B, C, T) with GELU,
    then float32 (B, T, C); and it keeps the former strides."""
    from robust_speech_analysis_framework_tpu_torch.device import conv1d
    from robust_speech_analysis_framework_tpu_torch.models import wav2vec2 as w2v_model
    from robust_speech_analysis_framework_tpu_torch.ops.cuda.wav2vec2 import (
        conv0_norm_gelu_reference,
    )

    torch.manual_seed(0)
    cfg = Wav2Vec2Config(**SMALL, compute_dtype=compute_dtype)
    encoder = w2v_model.FeatureEncoder(cfg)
    wav = torch.from_numpy((0.1 * np.random.default_rng(44).normal(size=(2, 7000)))
                           .astype(np.float32))
    lengths = torch.tensor([7000, 5100], dtype=torch.int32) if masked else None
    with torch.no_grad():
        got, got_lens = encoder(wav, lengths)
        cur = lengths
        for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride)):
            if cur is not None:
                cur = torch.div(cur - k, s, rounding_mode="floor") + 1
            if i > 0:
                h = torch.nn.functional.gelu(
                    conv1d(h, getattr(encoder, f"conv_{i}").weight, None, cfg.cdtype, stride=s))
            else:
                h = conv0_norm_gelu_reference(wav, encoder.conv_0.weight, encoder.gn_scale,
                                              encoder.gn_bias, cur, cfg.layer_norm_eps,
                                              stride=s, cdt=cfg.cdtype)
        former = h.float().transpose(1, 2)
    assert torch.equal(got, former) and got.stride() == former.stride()
    assert (got_lens is None) == (not masked)
    if masked:
        assert torch.equal(got_lens, cur)


# --- the positional conv: plain version, the kernel's arithmetic, dispatch ---------------

POS_CASES = {  # (B, T, C, groups, K, valid frames of each row or None)
    "cg48": (3, 61, 96, 2, 128, (61, 40, 0)),
    "cg64": (2, 45, 128, 2, 128, (45, 17)),
    "small": (3, 30, 32, 4, 16, (30, 11, 1)),
}


def _pos_conv_inputs(seed, b, t, c, groups, k, frames):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, c))
    for i, n in enumerate(frames or ()):
        x[i, n:] = 0.0  # padded frames, zeroed as the encoder zeroes them
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    cg = c // groups
    return f32(x), f32(rng.normal(size=(c, cg, k)) / np.sqrt(cg * k)), f32(0.1 * rng.normal(size=c))


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [True, False], ids=["zeroed-tails", "no-padding"])
@pytest.mark.parametrize("case", sorted(POS_CASES))
def test_pos_conv_plain_version_equals_the_former_inline_code(case, masked, cdt):
    """The plain version gives the encoder's former inline positional conv
    (conv1d in the compute dtype, the extra frame dropped, GELU, transpose)
    bit for bit; on CPU tensors the float32 wrapper is the plain version."""
    from robust_speech_analysis_framework_tpu_torch.device import conv1d
    from robust_speech_analysis_framework_tpu_torch.ops.cuda.wav2vec2 import (
        pos_conv_gelu,
        pos_conv_gelu_reference,
    )

    b, t, c, groups, k, frames = POS_CASES[case]
    x, weight, bias = _pos_conv_inputs(20, b, t, c, groups, k, frames if masked else None)
    h = conv1d(x.transpose(1, 2), weight, bias, cdt, padding=(k // 2,), groups=groups).float()
    former = torch.nn.functional.gelu(h[:, :, :t]).transpose(1, 2)
    got = pos_conv_gelu_reference(x, weight, bias, groups, cdt=cdt)
    assert got.shape == (b, t, c) and got.dtype == torch.float32
    assert torch.equal(got, former)
    if cdt == torch.float32:
        assert torch.equal(pos_conv_gelu(x, weight, bias, groups), former)


@pytest.mark.parametrize("b,t,c,groups,k", [(2, 61, 96, 2, 128), (2, 45, 128, 2, 128),
                                            (1, 1, 64, 2, 128), (3, 5, 32, 4, 16),
                                            (2, 9, 16, 2, 15), (1, 20, 24, 1, 18)])
def test_pos_conv_kernel_layout_and_window_emulated(b, t, c, groups, k):
    """The kernel's arithmetic in float64: its weights as the wrapper lays
    them out ((G, Kp, in, out), zero taps up to a multiple of 4) against the
    window of frames t − K // 2 … t − K // 2 + Kp − 1 (zero outside the row)
    give the plain version's output (odd K, K not a multiple of 4, T = 1,
    T below K)."""
    from robust_speech_analysis_framework_tpu_torch.ops.cuda.wav2vec2 import (
        POS_TAPS,
        _pos_conv_weights,
        pos_conv_gelu_reference,
    )

    x, weight, bias = _pos_conv_inputs(21, b, t, c, groups, k, None)
    wt = _pos_conv_weights(weight, groups)
    cg, kp = c // groups, -(-k // POS_TAPS) * POS_TAPS
    assert wt.shape == (groups, kp, cg, cg) and wt.is_contiguous()
    assert torch.all(wt[:, k:] == 0)
    xp = torch.nn.functional.pad(x.double(), (0, 0, k // 2, kp))
    win = xp.unfold(1, kp, 1)[:, :t].reshape(b, t, groups, cg, kp)  # [b, t, g, i, tap]
    y = torch.einsum("btgik,gkio->btgo", win, wt.double()).reshape(b, t, c) + bias.double()
    emulated = torch.nn.functional.gelu(y)
    ref = pos_conv_gelu_reference(x, weight, bias, groups).double()
    assert float((emulated - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_pos_conv_tile_plan():
    """Every planned tile fits a block's shared memory and covers the row;
    a wider group or a longer kernel never plans a block that does not fit."""
    from robust_speech_analysis_framework_tpu_torch.ops.cuda.wav2vec2 import (
        POS_TILES,
        SMEM_BLOCK,
        pos_conv_smem_bytes,
        pos_conv_tile,
    )

    for b, t, groups, cg, kp in [(16, 249, 16, 48, 128), (16, 799, 16, 64, 128),
                                 (1, 249, 16, 48, 128), (1, 1, 16, 64, 128), (3, 30, 4, 8, 16),
                                 (64, 5000, 16, 64, 128), (2, 63, 1, 64, 256)]:
        tile = pos_conv_tile(b, t, groups, cg, kp, 132)
        assert tile in POS_TILES and pos_conv_smem_bytes(cg, kp, tile) <= SMEM_BLOCK
    with pytest.raises(ValueError, match="fits"):
        pos_conv_tile(1, 10, 1, 64, 1024, 132)


def test_pos_conv_wrapper_guards():
    from robust_speech_analysis_framework_tpu_torch.ops.cuda.wav2vec2 import pos_conv_gelu

    x, weight, bias = _pos_conv_inputs(22, *POS_CASES["small"])
    with pytest.raises(ValueError, match=r"\(B, T, C\)"):
        pos_conv_gelu(x[0], weight, bias, 4)
    with pytest.raises(ValueError, match="do not divide"):
        pos_conv_gelu(x, weight, bias, 5)
    with pytest.raises(ValueError, match="expected weight"):
        pos_conv_gelu(x, weight, bias, 2)
    with pytest.raises(ValueError, match="bias"):
        pos_conv_gelu(x, weight, bias[:8], 4)
    with pytest.raises(TypeError, match="float32"):
        pos_conv_gelu(x.double(), weight, bias, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        pos_conv_gelu(x.to("meta"), weight.to("meta"), bias.to("meta"), 4)


def test_pos_conv_dispatch_keeps_cpu_tensors_off_the_build(monkeypatch, port_model):
    """On CPU tensors the positional conv's wrapper, and the float32 encoder
    through it, never reach the CUDA build or count a launch."""
    from robust_speech_analysis_framework_tpu_torch.ops.cuda import _build
    from robust_speech_analysis_framework_tpu_torch.ops.cuda import wav2vec2 as w2v_ops

    def no_build(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the CUDA build")

    for name in ("load", "call"):
        monkeypatch.setattr(_build, name, no_build)
    for name in ("_call", "_load", "_launch_pos_conv"):
        monkeypatch.setattr(w2v_ops, name, no_build)
    before = w2v_ops.pos_conv_gelu.launches
    x, weight, bias = _pos_conv_inputs(23, *POS_CASES["small"])
    with torch.no_grad():
        w2v_ops.pos_conv_gelu(x, weight, bias, 4)
        port_model(torch.zeros(2, 8000), torch.tensor([8000, 6000], dtype=torch.int32))
    assert w2v_ops.pos_conv_gelu.launches == before


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_positional_conv_routes_by_compute_dtype(monkeypatch, compute_dtype):
    """The module hands its compute dtype to ``pos_conv_gelu``, which
    decides: float32 takes the kernel on a CUDA tensor (the plain version on
    the CPU), the bfloat16 preset the plain version with its conv in
    bfloat16 (cuDNN's arithmetic, as before). The module's output is the
    former inline code's."""
    from robust_speech_analysis_framework_tpu_torch.device import conv1d
    from robust_speech_analysis_framework_tpu_torch.models import wav2vec2 as w2v_model

    calls = _spy_routes(monkeypatch, "pos_conv_gelu_reference")
    torch.manual_seed(0)
    cfg = Wav2Vec2Config(**SMALL, compute_dtype=compute_dtype)
    module = w2v_model.PositionalConvEmbedding(cfg)
    x, _, _ = _pos_conv_inputs(24, 2, 33, 32, 4, 16, (33, 20))
    with torch.no_grad():
        got = module(x)
        conv = module.conv
        h = conv1d(x.transpose(1, 2), conv.weight, conv.bias, cfg.cdtype, padding=conv.padding,
                   groups=conv.groups).float()
        former = torch.nn.functional.gelu(h[:, :, :33]).transpose(1, 2)
    assert torch.equal(got, former)
    cdt = torch.float32 if compute_dtype == "float32" else torch.bfloat16
    assert calls == {"route": [("cpu", cdt, compute_dtype == "float32")], "plain": [cdt]}


def test_the_kernel_or_plain_rule():
    """One rule decides both wrappers' route: the kernel for float32 on a
    CUDA device; the plain version on the CPU or at any other compute dtype
    (whatever the device); float32 elsewhere raises."""
    from robust_speech_analysis_framework_tpu_torch.ops.cuda.wav2vec2 import _uses_kernel

    cuda, cpu, meta = torch.device("cuda"), torch.device("cpu"), torch.device("meta")
    assert _uses_kernel(cuda, torch.float32)
    assert not any(_uses_kernel(d, c) for d, c in [(cuda, torch.bfloat16), (cpu, torch.float32),
                                                    (cpu, torch.bfloat16), (meta, torch.bfloat16)])
    with pytest.raises(ValueError, match="unsupported device"):
        _uses_kernel(meta, torch.float32)


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("block", ["conv0", "pos_conv"])
def test_wrappers_at_a_compute_dtype_equal_their_plain_versions(block, cdt):
    """On CPU tensors ``conv0_norm_gelu(..., cdt=)`` and ``pos_conv_gelu(...,
    cdt=)`` give their plain versions at that compute dtype bit for bit."""
    from robust_speech_analysis_framework_tpu_torch.ops.cuda import wav2vec2 as w2v_ops

    if block == "conv0":
        wav, frames, weight, scale, bias = _conv0_inputs(31)
        args = (wav, weight, scale, bias, frames, 1e-5)
        got = w2v_ops.conv0_norm_gelu(*args, cdt=cdt)
        want = w2v_ops.conv0_norm_gelu_reference(*args, cdt=cdt)
    else:
        x, weight, bias = _pos_conv_inputs(32, *POS_CASES["small"])
        got = w2v_ops.pos_conv_gelu(x, weight, bias, 4, cdt=cdt)
        want = w2v_ops.pos_conv_gelu_reference(x, weight, bias, 4, cdt=cdt)
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("groups", [1, 4], ids=["whole", "split-by-groups"])
def test_sharded_positional_conv_equals_the_plain_version(groups, cdt):
    """``ShardedWav2Vec2._pos_conv`` on a dp 1 × mp 2 grid over the CPU: whole
    (1 group does not split over 2 devices) and split by whole groups (each
    device its 2 of 4 groups' channels), bit for bit the plain version."""
    from robust_speech_analysis_framework_tpu_torch.models.wav2vec2 import ShardedWav2Vec2
    from robust_speech_analysis_framework_tpu_torch.ops.cuda.wav2vec2 import (
        pos_conv_gelu_reference,
    )
    from robust_speech_analysis_framework_tpu_torch.parallel import make_mesh

    compute_dtype = "float32" if cdt == torch.float32 else "bfloat16"
    torch.manual_seed(0)
    model = Wav2Vec2Model(Wav2Vec2Config(**dict(SMALL, pos_conv_groups=groups),
                                         compute_dtype=compute_dtype))
    sharded = ShardedWav2Vec2(model, make_mesh(devices=[torch.device("cpu")] * 2, mp=2))
    assert (sharded.spec["pos_conv.conv.weight"] is not None) and sharded.mesh.mp == 2
    x, _, _ = _pos_conv_inputs(33, 2, 37, 32, groups, 16, (37, 20))
    conv = model.pos_conv.conv
    with torch.no_grad():
        got = sharded._pos_conv(0, x)
        want = pos_conv_gelu_reference(x, conv.weight, conv.bias, groups, cdt)
    assert got.shape == (2, 37, 32) and torch.equal(got, want)
