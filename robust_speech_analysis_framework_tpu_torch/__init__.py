"""robust_speech_analysis_framework_tpu_torch — the PyTorch/CUDA port.

A second package beside the JAX one (``robust_speech_analysis_framework_tpu``,
the reference it is tested against), laid out the same way so each module's
counterpart is easy to find. It imports torch and numpy, never JAX or the JAX
package. Every kernel the JAX package wrote in Pallas for the TPU becomes a
hand-written CUDA kernel under ``csrc/``, built with nvcc at first use; what
XLA computed becomes plain PyTorch.

This slice holds the serving path:

  audio/      WAV IO and polyphase resampling (numpy)
  data/       bucketed batching (numpy)
  ops/cuda/   the LSTM recurrence kernel (csrc/lstm_scan.cu) + plain version
  models/     CNN-LSTM, Wav2Vec2-base, weight carry from the JAX package
  features/   Wav2Vec2 sequence extraction
  serving.py  Predictor: waveform / files / sequence → classification

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without a CUDA device and without that argument they raise.
"""

__version__ = "0.1.0"
