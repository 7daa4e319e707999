"""Port's Predictor vs the JAX package's, on the CPU.

One checkpoint written by the JAX package's ``save_model_checkpoint`` loads
into both predictors; both share a small Wav2Vec2 (hidden 32, 2 layers)
carried from the same JAX weights. Tolerance: logits atol 1e-4 (the
encoder and classifier in float32, summed in other orders), probabilities
atol 1e-5.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from robust_speech_analysis_framework_tpu.features.wav2vec2 import (
    Wav2Vec2Extractor as JaxExtractor,
)
from robust_speech_analysis_framework_tpu.models import CNNLSTM as JaxCNNLSTM
from robust_speech_analysis_framework_tpu.models.wav2vec2 import (
    Wav2Vec2Config as JaxConfig,
    Wav2Vec2Model as JaxModel,
)
from robust_speech_analysis_framework_tpu.serving import Predictor as JaxPredictor
from robust_speech_analysis_framework_tpu.train.checkpoints import (
    flatten_params,
    save_model_checkpoint,
)
from robust_speech_analysis_framework_tpu_torch.audio.io import write_wav
from robust_speech_analysis_framework_tpu_torch.features.wav2vec2 import Wav2Vec2Extractor
from robust_speech_analysis_framework_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from robust_speech_analysis_framework_tpu_torch.models.weights import (
    wav2vec2_state_dict_from_flat,
)
from robust_speech_analysis_framework_tpu_torch.serving import Predictor

ATOL = 1e-4
SMALL = dict(
    hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
    conv_dim=(16,) * 7, pos_conv_kernel=16, pos_conv_groups=4,
)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX predictor, port predictor, checkpoint path) over shared weights."""
    enc = JaxModel(JaxConfig(**SMALL)).init(jax.random.PRNGKey(0), jnp.zeros((1, 4000)))
    jax_ex = JaxExtractor(params=enc, config=JaxConfig(**SMALL), batch_size=2)
    ex = Wav2Vec2Extractor(
        params=wav2vec2_state_dict_from_flat(flatten_params(enc)),
        config=Wav2Vec2Config(**SMALL), batch_size=2, device="cpu",
    )
    model = JaxCNNLSTM(input_dim=32, cnn_out_channels=8, lstm_hidden_dim=8)
    variables = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 32)), train=False)
    path = str(tmp_path_factory.mktemp("m") / "model.pkl")
    save_model_checkpoint(
        path,
        {"input_dim": 32, "cnn_out_channels": 8, "lstm_hidden_dim": 8,
         "dropout_rate": 0.3, "activation_fn": "gelu", "learning_rate": 1e-4},
        variables, [1.0, 0.5], [1.1, 0.6],
    )
    return (
        JaxPredictor.from_checkpoint(path, extractor=jax_ex),
        Predictor.from_checkpoint(path, extractor=ex, device="cpu"),
        path,
    )


def _same(ours, ref):
    assert ours.label == ref.label
    np.testing.assert_allclose(ours.logits, ref.logits, atol=ATOL)
    assert abs(ours.probability - ref.probability) < 1e-5
    assert ours.latency_seconds > 0


def test_predict_sequence_matches_jax(pair):
    jax_p, p, _ = pair
    assert p.model.activation_fn == "gelu" and not p.model.training
    seq = np.random.default_rng(0).normal(size=(300, 32)).astype(np.float32)
    _same(p.predict_sequence(seq), jax_p.predict_sequence(seq))


def test_predict_waveform_matches_jax(pair):
    jax_p, p, _ = pair
    wav = (np.random.default_rng(1).normal(size=2 * 16000) * 0.1).astype(np.float32)
    _same(p.predict(wav), jax_p.predict(wav))
    with pytest.raises(ValueError, match="too short"):
        p.predict(np.zeros(1000, np.float32))  # < 0.5 s


def test_predict_files_matches_jax(pair, tmp_path):
    jax_p, p, _ = pair
    rng = np.random.default_rng(2)
    paths = []
    for name, sr, seconds in [("a16k.wav", 16000, 1.5), ("b8k.wav", 8000, 6.2)]:
        path = str(tmp_path / name)
        write_wav(path, (rng.normal(size=int(sr * seconds)) * 0.1).astype(np.float32), sr)
        paths.append(path)
    ours, ref = p.predict_files(paths), jax_p.predict_files(paths)
    assert set(ours) == set(ref) == {"a16k.wav", "b8k.wav"}
    for name in ref:
        _same(ours[name], ref[name])

    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as fh:
        fh.write(b"not a wav")
    with pytest.raises(ValueError, match="bad.wav"):
        p.predict_files(paths + [bad])
    assert set(p.predict_files(paths + [bad], skip_failed=True)) == set(ref)
    with pytest.raises(ValueError, match="duplicate"):
        p.predict_files([paths[0], paths[0]])


def test_from_reference_checkpoint_matches_jax(pair, tmp_path):
    """A reference-style .pt (torch state dict in the reference names)
    loads into both packages and gives the same logits."""
    jax_p, p, _ = pair
    payload = {
        "hyperparameters": {"dropout_rate": 0.4, "activation_fn": "gelu"},
        "model_state_dict": p.model.state_dict(),
        "train_loss_history": [],
        "val_loss_history": [],
    }
    path = str(tmp_path / "ref.pt")
    torch.save(payload, path)
    ours = Predictor.from_reference_checkpoint(path, device="cpu")
    ref = JaxPredictor.from_reference_checkpoint(path)
    seq = np.random.default_rng(3).normal(size=(100, 32)).astype(np.float32)
    _same(ours.predict_sequence(seq), ref.predict_sequence(seq))
    _same(ours.predict_sequence(seq), p.predict_sequence(seq))
    with pytest.raises(ValueError, match="Wav2Vec2Extractor"):
        ours.predict(np.zeros(16000, np.float32))
