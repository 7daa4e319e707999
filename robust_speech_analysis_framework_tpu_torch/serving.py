"""Single-call inference: audio file(s) → classification (PyTorch).

Counterpart of ``robust_speech_analysis_framework_tpu/serving.py``: a
:class:`Predictor` owns the Wav2Vec2 feature extractor and a trained
CNN-LSTM, loads weights from the JAX package's checkpoints
(``train/checkpoints.py`` pickle schema) or the reference's torch ``.pt``
artifacts, and serves ``predict(waveform)``, ``predict_files(paths)`` and
``predict_sequence(sequence)`` with bucketed padding (``min_bucket=256``).
On the card the CNN-LSTM's biLSTM runs the hand-written CUDA kernel.
"""

from __future__ import annotations

import os
import pickle
import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .audio.native_io import load_corpus_mono_16k
from .data.batching import pad_batch
from .device import DeviceLike, resolve_device
from .features.wav2vec2 import Wav2Vec2Extractor
from .models.cnn_lstm import CNNLSTM
from .models.weights import cnn_lstm_state_dict_from_flat, infer_architecture
from .utils.profiling import span, spanned

LABELS = {0: "Control", 1: "Patient"}


@dataclass
class Prediction:
    label: str
    probability: float  # P(Patient)
    logits: np.ndarray
    latency_seconds: float


def _model_for(state_dict, hp) -> CNNLSTM:
    arch = infer_architecture(state_dict)
    model = CNNLSTM(
        input_dim=arch["input_dim"],
        num_classes=arch["num_classes"],
        cnn_out_channels=arch["cnn_out_channels"],
        lstm_hidden_dim=arch["lstm_hidden_dim"],
        lstm_layers=arch["lstm_layers"],
        dropout_rate=float(hp.get("dropout_rate", 0.5)),
        activation_fn=str(hp.get("activation_fn", "silu")),
    )
    model.load_state_dict(state_dict)
    return model


class Predictor:
    def __init__(
        self,
        model: CNNLSTM,
        extractor: Optional[Wav2Vec2Extractor] = None,
        min_bucket: int = 256,
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        # may be None: predict_sequence() works on precomputed embeddings;
        # the waveform entry points check via _require_extractor
        self.extractor = extractor
        self.min_bucket = min_bucket

    # --- constructors ------------------------------------------------------

    @classmethod
    def from_checkpoint(cls, path: str, extractor=None, **kwargs) -> "Predictor":
        """Load a JAX-package checkpoint (train/checkpoints.py pickle schema).

        The file is a pickle: load only checkpoints you trust.
        """
        with open(path, "rb") as fh:
            payload = pickle.load(fh)
        state_dict = cnn_lstm_state_dict_from_flat(payload["model_state_dict"])
        model = _model_for(state_dict, payload["hyperparameters"])
        return cls(model, extractor, **kwargs)

    @classmethod
    def from_reference_checkpoint(cls, path: str, extractor=None, **kwargs) -> "Predictor":
        """Load a reference torch ``final_tuned_cnn_lstm_*.pt`` artifact.

        The file is a full pickle (hyperparameters beside the weights): load
        only checkpoints you trust.
        """
        payload = torch.load(path, map_location="cpu", weights_only=False)
        sd = payload["model_state_dict"] if "model_state_dict" in payload else payload
        hp = payload.get("hyperparameters", {}) if isinstance(payload, dict) else {}
        return cls(_model_for(sd, hp), extractor, **kwargs)

    # --- inference ---------------------------------------------------------

    def _require_extractor(self) -> Wav2Vec2Extractor:
        if self.extractor is None:
            raise ValueError(
                "Predicting from audio needs a Wav2Vec2Extractor with "
                "pretrained weights (the classifier consumes "
                "wav2vec2-base-960h embeddings; random weights would give "
                "garbage predictions). Build one with "
                "Wav2Vec2Extractor.from_hf_checkpoint(path) and pass it to "
                "the Predictor, or call predict_sequence() with precomputed "
                "embeddings."
            )
        return self.extractor

    @spanned("serve.classify")
    def predict_sequence(self, sequence: np.ndarray) -> Prediction:
        """Classify a precomputed (T, D) embedding sequence."""
        t0 = time.perf_counter()
        batch, lengths = pad_batch([np.asarray(sequence, np.float32)],
                                   min_bucket=self.min_bucket)
        with torch.inference_mode():
            logits = self.model(
                torch.from_numpy(batch).to(self.device),
                torch.from_numpy(lengths).to(self.device),
            )
        logits = logits[0].cpu().numpy()
        probs = np.exp(logits - logits.max())
        probs = probs / probs.sum()
        return Prediction(
            label=LABELS[int(np.argmax(logits))],
            probability=float(probs[1]),
            logits=logits,
            latency_seconds=time.perf_counter() - t0,
        )

    @spanned("serve.predict")
    def predict(self, waveform: np.ndarray) -> Prediction:
        """Classify a 16 kHz mono waveform (extraction + model)."""
        t0 = time.perf_counter()
        seqs = self._require_extractor().extract_sequences(
            {"_": waveform}, verbose=False
        )
        if "_" not in seqs:
            raise ValueError("audio too short for feature extraction (<0.5 s)")
        pred = self.predict_sequence(seqs["_"])
        pred.latency_seconds = time.perf_counter() - t0
        return pred

    def predict_files(
        self, paths: Sequence[str], skip_failed: bool = False
    ) -> Dict[str, Prediction]:
        """Batch-classify WAV files (decoded by the native batch decoder and
        resampled to 16 kHz mono, as the JAX package's ``serving.py:144``).

        Raises ValueError naming any file that could not be decoded or was
        too short for feature extraction (<0.5 s); pass ``skip_failed=True``
        to omit such files from the result instead.
        """
        with span("serve.decode"):
            waves = load_corpus_mono_16k(paths)
        seqs = self._require_extractor().extract_sequences(waves, verbose=False)
        failed = [os.path.basename(p) for p in paths
                  if os.path.basename(p) not in seqs]
        if failed and not skip_failed:
            raise ValueError(
                f"{len(failed)} file(s) could not be classified (decode failure "
                f"or <0.5 s audio): {failed[:5]}; pass skip_failed=True to omit"
            )
        return {name: self.predict_sequence(seq) for name, seq in seqs.items()}
