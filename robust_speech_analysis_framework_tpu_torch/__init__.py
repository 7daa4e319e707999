"""robust_speech_analysis_framework_tpu_torch — the PyTorch/CUDA port.

A second package beside the JAX one (``robust_speech_analysis_framework_tpu``,
the reference it is tested against), laid out the same way so each module's
counterpart is easy to find. It imports torch and numpy, never JAX or the JAX
package. Every kernel the JAX package wrote in Pallas for the TPU becomes a
hand-written CUDA kernel under ``csrc/``, built with nvcc at first use; what
XLA computed becomes plain PyTorch.

Ported so far: the serving path, CNN-LSTM training and its cross-validation
engines, openSMILE-912 and MSHDS-25 extraction:

  audio/      WAV IO, polyphase resampling (torch and numpy), the STFT/mel/MFCC
              front end
  data/       bucketed batching (numpy)
  ops/        spectral LLDs, functionals, SHS pitch, the host period march; the
              corpus buffer and deferred results (framing.py), Praat pitch,
              intensity, harmonicity, the glottal-pulse march, spectral
              moments, Burg formants, pitch-corrected LTAS and CPPS
  ops/cuda/   the LSTM kernels (csrc/lstm_scan.cu, csrc/lstm_train.cu) and the
              Viterbi path finder (csrc/viterbi.cu), each with its plain version
  models/     CNN-LSTM, Wav2Vec2-base, weight carry from the JAX package
  features/   Wav2Vec2 sequences, openSMILE-912 and MSHDS-25 features, the conf
              parser
  train/      the fold trainer (streaming and device-resident) and checkpoints
  eval/       splits, metrics and the CNN-LSTM cross-validation engines
  tune/       the TPE sampler
  serving.py  Predictor: waveform / files / sequence → classification

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without a CUDA device and without that argument they raise.
"""

__version__ = "0.1.0"
