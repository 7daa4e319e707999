"""The port stands alone: no JAX, no JAX package, CUDA by default.

Every module of ``robust_speech_analysis_framework_tpu_torch`` is imported in
a fresh interpreter, which must end with neither ``jax``, ``flax``,
``optax``, the JAX package nor ``pandas`` (absent on the card's machine) in
``sys.modules``. Entry points built without
``device=`` use the card, and raise where there is none.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from robust_speech_analysis_framework_tpu_torch.device import resolve_device
from robust_speech_analysis_framework_tpu_torch.eval import dl_cv
from robust_speech_analysis_framework_tpu_torch.features.mshds import (
    extract_mshds_arrays,
    extract_mshds_single,
)
from robust_speech_analysis_framework_tpu_torch.features.opensmile import OpenSmileExtractor
from robust_speech_analysis_framework_tpu_torch.features.wav2vec2 import Wav2Vec2Extractor
from robust_speech_analysis_framework_tpu_torch.models.cnn_lstm import build_cnn_lstm
from robust_speech_analysis_framework_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from robust_speech_analysis_framework_tpu_torch.ops.cepstrum import cpps_segments_batch
from robust_speech_analysis_framework_tpu_torch.ops.formants import formant_track_burg_batch
from robust_speech_analysis_framework_tpu_torch.ops.framing import corpus_buffer
from robust_speech_analysis_framework_tpu_torch.ops.harmonicity import harmonicity_cc_batch
from robust_speech_analysis_framework_tpu_torch.ops.intensity import intensity_contour_batch
from robust_speech_analysis_framework_tpu_torch.ops.pitch import (
    PitchParams,
    PitchTrack,
    pitch_track_batch,
)
from robust_speech_analysis_framework_tpu_torch.ops.pulses import point_process_cc_batch
from robust_speech_analysis_framework_tpu_torch.ops.spectral import voiced_mean_moments_batch
from robust_speech_analysis_framework_tpu_torch.serving import Predictor
from robust_speech_analysis_framework_tpu_torch.train.loops import (
    DeviceCorpus,
    ResidentCorpus,
    Trainer,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import robust_speech_analysis_framework_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
banned = ("jax", "jaxlib", "flax", "optax", "robust_speech_analysis_framework_tpu", "pandas")
leaked = sorted(m for m in sys.modules if m.split(".")[0] in banned)
print(len(names), leaked)
sys.exit(1 if leaked else 0)
"""

SMALL = dict(
    hidden_size=32, num_layers=1, num_heads=4, intermediate_size=64,
    conv_dim=(16,) * 7, pos_conv_kernel=16, pos_conv_groups=4,
)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 48  # every module of the port so far was imported


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: chip_smoke.py would run in full")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def _tiny_cv_inputs():
    seqs = [np.zeros((4, 8), np.float32)] * 20
    return seqs, np.arange(20) % 2


@pytest.mark.parametrize(
    "entry", ["extractor", "cnn_lstm", "predictor", "trainer", "device", "opensmile",
              "device_corpus", "resident_corpus", "standard_cv", "nested_cv", "corpus_buffer",
              "pitch_batch", "intensity_batch", "harmonicity_batch", "pulses_batch",
              "moments_batch", "formants_batch", "cpps_batch", "mshds_arrays", "mshds_single"])
def test_entry_points_default_to_cuda(entry):
    hp = {"learning_rate": 1e-3, "cnn_out_channels": 8, "lstm_hidden_dim": 8}
    wave = [np.sin(np.arange(4000) / 10.0)]  # 0.25 s at 16 kHz
    track = PitchTrack(np.arange(0.02, 0.23, 0.005), np.full(43, 160.0), np.ones(43))
    build = {
        "extractor": lambda: Wav2Vec2Extractor(
            config=Wav2Vec2Config(**SMALL), allow_random_init=True).device,
        "cnn_lstm": lambda: next(
            build_cnn_lstm(input_dim=8, cnn_out_channels=8, lstm_hidden_dim=8).parameters()
        ).device,
        "predictor": lambda: Predictor(
            build_cnn_lstm(input_dim=8, cnn_out_channels=8, lstm_hidden_dim=8, device="cpu")
        ).device,
        "trainer": lambda: Trainer(
            build_cnn_lstm(input_dim=8, cnn_out_channels=8, lstm_hidden_dim=8, device="cpu")
        ).device,
        "device": lambda: resolve_device(),
        "opensmile": lambda: OpenSmileExtractor().device,
        "device_corpus": lambda: DeviceCorpus(_tiny_cv_inputs()[0]).x.device,
        "resident_corpus": lambda: ResidentCorpus(
            {"a": np.zeros((4, 8), np.float32)}).device_corpus().x.device,
        "standard_cv": lambda: torch.device("cuda") if dl_cv.standard_kfold_cv(
            *_tiny_cv_inputs(), hp, n_splits=2, epochs=1) else None,
        "nested_cv": lambda: torch.device("cuda") if dl_cv.nested_cv(
            *_tiny_cv_inputs(), n_splits_outer=2, n_splits_inner=2, n_trials=1, epochs=1,
            inner_epochs=1, search_space={k: ("categorical", [v]) for k, v in hp.items()},
        ) else None,
        # the MSHDS ops: the buffer, and the batch ops given waveforms (no buffer)
        "corpus_buffer": lambda: corpus_buffer(wave).x_cat.device,
        "pitch_batch": lambda: torch.device("cuda") if pitch_track_batch(
            wave, 16000, PitchParams()) else None,
        "intensity_batch": lambda: torch.device("cuda") if intensity_contour_batch(
            wave, 16000) else None,
        "harmonicity_batch": lambda: torch.device("cuda") if harmonicity_cc_batch(
            wave, 16000) else None,
        "pulses_batch": lambda: torch.device("cuda") if point_process_cc_batch(
            wave, 16000, [track]) else None,
        # the MSHDS second half and the whole extractor
        "moments_batch": lambda: torch.device("cuda") if voiced_mean_moments_batch(
            wave, 16000, [lambda t: np.ones(len(t), bool)]) else None,
        "formants_batch": lambda: torch.device("cuda") if formant_track_burg_batch(
            wave, 16000) else None,
        "cpps_batch": lambda: torch.device("cuda") if cpps_segments_batch(
            [(wave[0], [(0.0, 0.25)])], 10000.0) else None,
        "mshds_arrays": lambda: torch.device("cuda") if extract_mshds_arrays(wave).size else None,
        "mshds_single": lambda: torch.device("cuda") if extract_mshds_single(wave[0]) else None,
    }[entry]
    if torch.cuda.is_available():
        assert build().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_opensmile_front_door_defaults_to_cuda():
    import pandas as pd

    from robust_speech_analysis_framework_tpu_torch.features.opensmile import (
        extract_opensmile_features,
    )

    empty = pd.DataFrame({"filepath": []})
    if torch.cuda.is_available():
        assert extract_opensmile_features(empty).empty
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            extract_opensmile_features(empty)


@pytest.mark.parametrize("engine", ["standard", "nested"])
def test_cv_front_doors_default_to_cuda(engine):
    """The DataFrame front doors refuse before they touch their inputs."""
    import pandas as pd

    meta = pd.DataFrame({"unique_participant_id": [], "label": []})
    run = {"standard": lambda: dl_cv.run_dl_standard_kfold_cv({}, meta, {}),
           "nested": lambda: dl_cv.run_dl_nested_cv({}, meta)}[engine]
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="no overlap"):
            run()
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run()


def test_cpu_must_be_asked_for():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
