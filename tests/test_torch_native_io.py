"""The port's native WAV decoder (built here with g++) vs the JAX package's
Python codec, and the serving path that decodes through it, on the CPU.

Decodes must equal ``audio/io.read_wav``'s mono mixdown of the JAX package
to float32 rounding (atol 1e-7: the decoder mixes channels in double, the
codec in float32; on the PCM lattice both are exact), and 16 kHz results of
``load_corpus_mono_16k`` must equal the JAX package's ``load_mono_16k``
(atol 1e-6: the same float64 polyphase filter). ``Predictor.predict_files``
must give the logits the Python codec gave before (bit for bit from PCM
files).
"""

import os
import struct

import numpy as np
import pytest

from robust_speech_analysis_framework_tpu.audio import io as jax_io
from robust_speech_analysis_framework_tpu.train.checkpoints import flatten_params
from robust_speech_analysis_framework_tpu_torch.audio import native_io
from robust_speech_analysis_framework_tpu_torch.audio.io import load_files_mono_16k, write_wav
from robust_speech_analysis_framework_tpu_torch.features.wav2vec2 import Wav2Vec2Extractor
from robust_speech_analysis_framework_tpu_torch.models.cnn_lstm import build_cnn_lstm
from robust_speech_analysis_framework_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from robust_speech_analysis_framework_tpu_torch.models.weights import (
    wav2vec2_state_dict_from_flat,
)
from robust_speech_analysis_framework_tpu_torch.serving import Predictor
from tests.test_torch_wav2vec2 import SMALL, jax_params  # noqa: F401  (fixture)


def write_float_wav(path: str, samples: np.ndarray, sample_rate: int, bits: int = 32) -> None:
    """IEEE-float WAV (format 3), mono or (frames, channels)."""
    x = np.asarray(samples, np.float32 if bits == 32 else np.float64)
    x = x[:, None] if x.ndim == 1 else x
    data = x.astype("<f4" if bits == 32 else "<f8").tobytes()
    ch, width = x.shape[1], bits // 8
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVEfmt ")
        fh.write(struct.pack("<IHHIIHH", 16, 3, ch, sample_rate, sample_rate * ch * width,
                             ch * width, bits))
        fh.write(b"data" + struct.pack("<I", len(data)) + data)


def _files(tmp_path, stereo_seconds: float = 0.1):
    rng = np.random.default_rng(0)
    n44 = int(44100 * stereo_seconds)
    specs = {
        "pcm16.wav": lambda p: write_wav(p, rng.normal(size=16000) * 0.2, 16000),
        # short: the JAX package resamples by np.convolve of the whole stuffed signal
        "stereo44k.wav": lambda p: write_wav(p, rng.normal(size=(n44, 2)) * 0.2, 44100),
        "float32.wav": lambda p: write_float_wav(p, rng.normal(size=12000) * 0.3, 16000),
        "float64_stereo.wav": lambda p: write_float_wav(p, rng.normal(size=(8000, 2)) * 0.3,
                                                        8000, bits=64),
    }
    paths = []
    for name, write in specs.items():
        path = str(tmp_path / name)
        write(path)
        paths.append(path)
    return paths


@pytest.mark.parametrize("kind", ["pcm16", "stereo44k", "float32", "float64_stereo"])
def test_decode_matches_jax_codec(tmp_path, kind):
    path = [p for p in _files(tmp_path) if os.path.basename(p).startswith(kind + ".")][0]
    ours, sr = native_io.decode_mono(path)
    ref, ref_sr = jax_io.read_wav(path)
    assert sr == ref_sr and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref.mean(axis=1), rtol=0, atol=1e-7)
    if kind == "pcm16":
        np.testing.assert_array_equal(ours, ref[:, 0])


def test_batch_decode_and_resample_match_jax(tmp_path):
    paths = _files(tmp_path)
    corrupt = tmp_path / "corrupt.wav"
    corrupt.write_bytes(b"RIFF\x00\x00\x00\x00WAVEjunkjunk")
    decoded = native_io.decode_batch_mono(paths + [str(corrupt), str(tmp_path / "absent.wav")],
                                          n_threads=3)
    assert decoded[-2] is None and decoded[-1] is None
    for path, item in zip(paths, decoded):
        np.testing.assert_array_equal(item[0], native_io.decode_mono(path)[0])
    with pytest.raises(ValueError, match="native decode failed"):
        native_io.decode_mono(str(corrupt))
    assert native_io.decode_batch_mono([]) == []

    waves = native_io.load_corpus_mono_16k(paths + [str(corrupt)])
    assert sorted(waves) == sorted(os.path.basename(p) for p in paths)  # corrupt left out
    for path in paths:
        ref = jax_io.load_mono_16k(path)
        got = waves[os.path.basename(path)]
        assert got.dtype == np.float32 and got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="duplicate basenames"):
        native_io.load_corpus_mono_16k([paths[0], paths[0]])


@pytest.mark.parametrize("fault", ["missing-compiler", "compile-error"])
def test_failed_build_raises(tmp_path, monkeypatch, fault):
    """No quiet fallback to the Python codec: a build that cannot run or
    fails raises, with the compiler's message."""
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "BUILD_DIR", str(tmp_path / "build"))
    if fault == "missing-compiler":
        monkeypatch.setattr(native_io, "CXX", str(tmp_path / "no-such-g++"))
        match = "cannot run the C\\+\\+ compiler"
    else:
        monkeypatch.setattr(native_io, "CXX_FLAGS",
                            [*native_io.CXX_FLAGS, "-DRAF_BREAK", "-include", "no_such.h"])
        match = "no_such.h"
    with pytest.raises(RuntimeError, match=match):
        native_io.decode_mono(_files(tmp_path)[0])
    assert not os.listdir(tmp_path / "build")  # nothing half-built is left to load


def test_library_is_built_into_the_build_directory():
    lib = native_io.load_library()
    assert lib.raf_version() == b"raf-audio 1.0"
    path = native_io._library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path).endswith(os.path.join("build", "native"))


def test_predict_files_unchanged(jax_params, tmp_path):
    """``predict_files`` (native decode) gives the logits of the Python
    codec's decode through the same extractor and model: bit for bit from
    PCM files, within 1e-6 from IEEE-float files (the codec rounds each
    channel to float32 before the mixdown, the decoder after it)."""
    ex = Wav2Vec2Extractor(params=wav2vec2_state_dict_from_flat(flatten_params(jax_params)),
                           config=Wav2Vec2Config(**SMALL), batch_size=2, device="cpu")
    predictor = Predictor(build_cnn_lstm(input_dim=32, cnn_out_channels=8, lstm_hidden_dim=8,
                                         seed=1, device="cpu"), extractor=ex, device="cpu")
    paths = _files(tmp_path, stereo_seconds=0.75)
    ours = predictor.predict_files(paths)
    before = ex.extract_sequences(load_files_mono_16k(paths), verbose=False)
    assert sorted(ours) == sorted(before)
    for name, seq in before.items():
        want = predictor.predict_sequence(seq).logits
        if name.startswith("float"):
            np.testing.assert_allclose(ours[name].logits, want, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(ours[name].logits, want)
