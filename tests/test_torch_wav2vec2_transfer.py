"""The port's Wav2Vec2 transfer dtypes and bfloat16 preset vs the JAX
package's, and vs the port's own float32 path, on the CPU.

The SMALL config of ``tests/test_torch_wav2vec2.py`` (hidden 32, 2 layers)
with the same perturbed JAX weights carried over. Tolerances:

* port vs JAX with the same arguments: per element, one quantisation step
  of the frame's largest magnitude (int16: 1/32767; int8: 1/127; int24:
  1/(32767·254); float16: 2^-10) plus 1e-5: the two encoders differ by
  float32 summation order (~3e-6 here), which can move a rounded value by
  one step;
* against the port's own float32 path, the JAX package's contracts
  (``tests/test_wav2vec2.py:172-318``): the int16 upload bit-equal on the
  PCM lattice; int16 download Frobenius ≤ 1e-4 and per element
  ≤ fmax·(1/65534 + 2e-6) + 1e-9; int24 max relative error ≤ 1e-4 (floored
  at 1e-3 of the largest magnitude); int8 ≤ fmax/254 + 1e-3·fmax + 1e-7 and
  cosine > 0.9999; float16 download and bfloat16 compute within 1e-2 of
  cosine distance;
* bfloat16 compute vs the JAX package's bfloat16: cosine distance ≤ 1e-2
  (both round every product to bfloat16, in other places).
"""

import numpy as np
import pytest

import torch

from robust_speech_analysis_framework_tpu.features.wav2vec2 import (
    Wav2Vec2Extractor as JaxExtractor,
)
from robust_speech_analysis_framework_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from robust_speech_analysis_framework_tpu.train.checkpoints import flatten_params
from robust_speech_analysis_framework_tpu_torch.features.wav2vec2 import (
    Wav2Vec2Extractor,
    dequantize_sequences,
    quantize_sequences,
)
from robust_speech_analysis_framework_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from robust_speech_analysis_framework_tpu_torch.models.weights import (
    wav2vec2_state_dict_from_flat,
)
from tests.test_torch_wav2vec2 import SMALL, jax_params  # noqa: F401  (fixture)

SR = 16000
# one quantisation step, relative to the frame's largest magnitude
STEP = {"int16": 1 / 32767, "int8": 1 / 127, "int24": 1 / (32767 * 254), "float16": 2.0**-10}
TRANSFERS = {"int16": np.int16, "int8": np.int8, "int24": "int24", "float16": np.float16}


def _waves(seed: int = 13):
    rng = np.random.default_rng(seed)
    return {
        "a.wav": (rng.normal(size=SR) * 0.1).astype(np.float32),
        "b.wav": (rng.normal(size=int(8.9 * SR)) * 0.05).astype(np.float32),  # 3 chunks
    }


def _lattice(seed: int = 11):
    """16-bit PCM samples as audio.io decodes them: x / 32768."""
    rng = np.random.default_rng(seed)
    return {"pcm.wav": (rng.integers(-20000, 20000, size=int(6.5 * SR)) / 32768.0)
            .astype(np.float32)}


def _port(jax_params, **kw):
    sd = wav2vec2_state_dict_from_flat(flatten_params(jax_params))
    return Wav2Vec2Extractor(params=sd, config=Wav2Vec2Config(**SMALL), batch_size=3,
                             device="cpu", **kw)


def _jax(jax_params, **kw):
    return JaxExtractor(params=jax_params, config=JaxConfig(**SMALL), batch_size=3, **kw)


def _cos(a, b) -> float:
    a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.fixture(scope="module")
def port_f32(jax_params):
    return _port(jax_params).extract_sequences(_waves(), verbose=False)


@pytest.mark.parametrize("transfer", sorted(TRANSFERS))
def test_sequence_transfer_matches_jax(jax_params, transfer):
    kw = dict(sequence_transfer_dtype=TRANSFERS[transfer])
    ours = _port(jax_params, **kw).extract_sequences(_waves(), verbose=False)
    ref = _jax(jax_params, **kw).extract_sequences(_waves(), verbose=False)
    assert sorted(ours) == sorted(ref) == ["a.wav", "b.wav"]
    for name in ref:
        assert ours[name].dtype == np.float32 and ours[name].shape == ref[name].shape
        fmax = np.abs(ref[name]).max(axis=1, keepdims=True)
        assert (np.abs(ours[name] - ref[name]) <= fmax * STEP[transfer] + 1e-5).all()


def test_int16_upload_matches_jax(jax_params):
    """The upload changes no arithmetic on the device: within the float32
    tolerance of the two encoders (1e-5) on and off the PCM lattice."""
    waves = {**_waves(), **_lattice()}
    ours = _port(jax_params, upload_dtype=np.int16).extract_sequences(waves, verbose=False)
    ref = _jax(jax_params, upload_dtype=np.int16).extract_sequences(waves, verbose=False)
    assert sorted(ours) == sorted(ref)
    for name in ref:
        np.testing.assert_allclose(ours[name], ref[name], rtol=0, atol=1e-5)


def test_int16_upload_is_lossless_on_pcm_lattice(jax_params):
    a = _port(jax_params).extract_sequences(_lattice(), verbose=False)["pcm.wav"]
    b = _port(jax_params, upload_dtype=np.int16).extract_sequences(
        _lattice(), verbose=False)["pcm.wav"]
    np.testing.assert_array_equal(a, b)


def test_int16_download_meets_contract(jax_params, port_f32):
    q16 = _port(jax_params, sequence_transfer_dtype=np.int16).extract_sequences(
        _waves(), verbose=False)
    for name, a in port_f32.items():
        b = q16[name]
        assert b.dtype == np.float32 and a.shape == b.shape
        assert np.linalg.norm(a - b) / np.linalg.norm(a) <= 1e-4
        fmax = np.abs(a).max(axis=1, keepdims=True)
        assert (np.abs(a - b) <= fmax * (1.0 / 65534.0 + 2e-6) + 1e-9).all()


def test_int24_download_meets_elementwise_contract(jax_params, port_f32):
    q24 = _port(jax_params, sequence_transfer_dtype="int24").extract_sequences(
        _waves(), verbose=False)
    for name, a in port_f32.items():
        b = q24[name]
        floor = 1e-3 * float(np.abs(a).max())
        assert float(np.max(np.abs(a - b) / np.maximum(np.abs(a), floor))) <= 1e-4


def test_int8_download_close_to_f32(jax_params, port_f32):
    q8 = _port(jax_params, sequence_transfer_dtype=np.int8).extract_sequences(
        _waves(), verbose=False)
    for name, a in port_f32.items():
        b = q8[name]
        fmax = np.abs(a).max(axis=1, keepdims=True)
        assert (np.abs(a - b) <= fmax / 254.0 + 1e-3 * fmax + 1e-7).all()
        assert _cos(a, b) > 0.9999


@pytest.mark.parametrize("preset", ["float16", "bfloat16", "fastest"])
def test_reduced_precision_close_to_f32(jax_params, port_f32, preset):
    """float16 download, bfloat16 compute, and both with the int16 upload
    (the JAX package's fast preset): float32 out, within 1e-2 of cosine
    distance of the strict path."""
    kw = {"float16": dict(sequence_transfer_dtype=np.float16),
          "bfloat16": dict(compute_dtype="bfloat16"),
          "fastest": dict(compute_dtype="bfloat16", sequence_transfer_dtype=np.float16,
                          upload_dtype=np.int16)}[preset]
    ex = _port(jax_params, **kw)
    out = ex.extract_sequences(_waves(), verbose=False)
    for name, a in port_f32.items():
        assert out[name].dtype == np.float32 and out[name].shape == a.shape
        assert 1.0 - _cos(a, out[name]) <= 1e-2
    if "compute_dtype" in kw:
        assert ex.config.compute_dtype == "bfloat16"
        assert ex.model.layer_0.q.weight.dtype == torch.float32  # weights stay float32


def test_bf16_compute_matches_jax_bf16(jax_params):
    waves = _waves()
    ours = _port(jax_params, compute_dtype="bfloat16").extract_sequences(waves, verbose=False)
    ref = _jax(jax_params, compute_dtype="bfloat16").extract_sequences(waves, verbose=False)
    assert sorted(ours) == sorted(ref)
    for name in ref:
        assert ours[name].shape == ref[name].shape
        assert 1.0 - _cos(ours[name], ref[name]) <= 1e-2
    # the pooled embeddings under the same preset (the JAX test's bounds)
    names, emb = _port(jax_params, compute_dtype="bfloat16").extract_embeddings_arrays(
        waves, verbose=False)
    df = _jax(jax_params, compute_dtype="bfloat16").extract_embeddings(waves, verbose=False)
    assert names == list(df["filename"])
    np.testing.assert_allclose(emb, df[[f"dim_{k}" for k in range(32)]].to_numpy(),
                               atol=0.05, rtol=0.05)


@pytest.mark.parametrize("transfer", ["float32", *sorted(TRANSFERS)])
def test_quantize_round_trip(transfer):
    """Device quantisation and host dequantisation alone, on float32 frames
    with a zero frame (its scale is floored at 1e-12)."""
    rng = np.random.default_rng(3)
    hidden = torch.from_numpy(rng.normal(size=(2, 5, 32)).astype(np.float32))
    hidden[1, 2] = 0.0
    payload = quantize_sequences(hidden, transfer)
    if transfer in ("int8", "int16"):
        assert payload[0].dtype == getattr(torch, transfer)
        assert payload[1].dtype == (torch.float16 if transfer == "int8" else torch.float32)
    back = dequantize_sequences(tuple(t.numpy() for t in payload)).astype(np.float32)
    a = hidden.numpy()
    fmax = np.abs(a).max(axis=-1, keepdims=True)
    # half a step, and float32 arithmetic (int8: the float16 scale's rounding)
    half = {"float32": 0.0, "int8": 0.5 / 127 + 1e-3}.get(transfer, 0.5 * STEP.get(transfer, 0))
    assert (np.abs(back - a) <= fmax * (half + 2e-6 * (transfer != "float32"))).all()
    assert (back[1, 2] == 0.0).all()


def test_guards(jax_params):
    with pytest.raises(ValueError, match="normalize"):
        _port(jax_params, upload_dtype=np.int16, normalize=True)
    for bad in (np.int32, np.float64, "int12", torch.float16):
        with pytest.raises(ValueError, match="sequence_transfer_dtype"):
            _port(jax_params, sequence_transfer_dtype=bad)
    with pytest.raises(ValueError, match="upload_dtype"):
        _port(jax_params, upload_dtype=np.int8)
    with pytest.raises(ValueError, match="compute_dtype"):
        _port(jax_params, compute_dtype="float16")
