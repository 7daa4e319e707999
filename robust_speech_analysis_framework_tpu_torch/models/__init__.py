"""Models of the port: CNN-LSTM, Wav2Vec2-base, WavLM-Large, Wav2Vec2-Conformer-Large,
weight carry from JAX."""

from .cnn_lstm import CNNLSTM, build_cnn_lstm, stability_probe
from .conformer import ConformerConfig, ConformerModel, port_hf_conformer_state_dict
from .wav2vec2 import Wav2Vec2Config, Wav2Vec2Model, port_hf_state_dict
from .wavlm import WavLMConfig, WavLMModel, port_hf_wavlm_state_dict

__all__ = [
    "CNNLSTM",
    "ConformerConfig",
    "ConformerModel",
    "Wav2Vec2Config",
    "Wav2Vec2Model",
    "WavLMConfig",
    "WavLMModel",
    "build_cnn_lstm",
    "port_hf_conformer_state_dict",
    "port_hf_state_dict",
    "port_hf_wavlm_state_dict",
    "stability_probe",
]
