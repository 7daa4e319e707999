"""The port stands alone: no JAX, no JAX package, CUDA by default.

Every module of ``robust_speech_analysis_framework_tpu_torch`` is imported in
a fresh interpreter, which must end with neither ``jax``, ``flax``,
``optax``, the JAX package, ``pandas`` nor ``matplotlib`` (the last two
absent on the card's machine) in ``sys.modules``. Entry points built without
``device=`` use the card, and raise where there is none.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from robust_speech_analysis_framework_tpu_torch import experiments
from robust_speech_analysis_framework_tpu_torch.device import resolve_device
from robust_speech_analysis_framework_tpu_torch.entry import entry as flagship_entry
from robust_speech_analysis_framework_tpu_torch.eval import dl_cv, svm_cv
from robust_speech_analysis_framework_tpu_torch.features.mshds import (
    extract_mshds_arrays,
    extract_mshds_single,
)
from robust_speech_analysis_framework_tpu_torch.features.opensmile import OpenSmileExtractor
from robust_speech_analysis_framework_tpu_torch.features.wav2vec2 import Wav2Vec2Extractor
from robust_speech_analysis_framework_tpu_torch.models.cnn_lstm import build_cnn_lstm
from robust_speech_analysis_framework_tpu_torch.models.svm_device import smo_linear_batch
from robust_speech_analysis_framework_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from robust_speech_analysis_framework_tpu_torch.ops.cepstrum import cpps_segments_batch
from robust_speech_analysis_framework_tpu_torch.ops.formants import formant_track_burg_batch
from robust_speech_analysis_framework_tpu_torch.ops.framing import corpus_buffer, upload_pcm_f32
from robust_speech_analysis_framework_tpu_torch.ops.harmonicity import harmonicity_cc_batch
from robust_speech_analysis_framework_tpu_torch.ops.intensity import intensity_contour_batch
from robust_speech_analysis_framework_tpu_torch.ops.jitter import mark_periods_batch
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
banned = ("jax", "jaxlib", "flax", "optax", "robust_speech_analysis_framework_tpu", "pandas",
          "matplotlib")
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
    assert n_modules >= 60  # every module of the port so far was imported


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: chip_smoke.py would run in full")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def _tiny_svm_lanes():
    return np.ones((1, 4, 2), np.float32), np.array([[1, 1, -1, -1]], np.float32), \
        np.ones((1, 4), bool)


def _tiny_svm_inputs():
    x = np.arange(40, dtype=np.float64).reshape(20, 2)
    return x, np.arange(20) % 2


def _tiny_cv_inputs():
    seqs = [np.zeros((4, 8), np.float32)] * 20
    return seqs, np.arange(20) % 2


@pytest.mark.parametrize(
    "entry", ["extractor", "extractor_bf16_int8", "cnn_lstm", "predictor", "trainer", "device", "opensmile",
              "device_corpus", "resident_corpus", "standard_cv", "nested_cv", "corpus_buffer",
              "pitch_batch", "intensity_batch", "harmonicity_batch", "pulses_batch",
              "moments_batch", "formants_batch", "cpps_batch", "mshds_arrays", "mshds_single",
              "smo_batch", "standard_svm", "nested_svm", "host_svm", "extract_tables",
              "svm_experiments", "cnn_lstm_experiments", "flagship_entry", "upload_pcm_f32",
              "march_batch"])
def test_entry_points_default_to_cuda(entry):
    hp = {"learning_rate": 1e-3, "cnn_out_channels": 8, "lstm_hidden_dim": 8}
    wave = [np.sin(np.arange(4000) / 10.0)]  # 0.25 s at 16 kHz
    track = PitchTrack(np.arange(0.02, 0.23, 0.005), np.full(43, 160.0), np.ones(43))
    build = {
        "extractor": lambda: Wav2Vec2Extractor(
            config=Wav2Vec2Config(**SMALL), allow_random_init=True).device,
        # the transfer dtypes and the bfloat16 preset change nothing of the device
        "extractor_bf16_int8": lambda: Wav2Vec2Extractor(
            config=Wav2Vec2Config(**SMALL), allow_random_init=True, compute_dtype="bfloat16",
            sequence_transfer_dtype=np.int8, upload_dtype=np.int16).device,
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
        # the SVM solver and engines (the host solver too: nothing is chosen
        # by the hardware present), the experiment cores and the entry
        "smo_batch": lambda: torch.device("cuda") if smo_linear_batch(
            *_tiny_svm_lanes()) is not None else None,
        "standard_svm": lambda: torch.device("cuda") if svm_cv.standard_svm_cv(
            *_tiny_svm_inputs(), n_splits=2) else None,
        "nested_svm": lambda: torch.device("cuda") if svm_cv.nested_svm_cv(
            *_tiny_svm_inputs(), n_splits_outer=2, n_splits_inner=2) else None,
        "host_svm": lambda: torch.device("cuda") if svm_cv.standard_svm_cv(
            *_tiny_svm_inputs(), n_splits=2, solver="host") else None,
        "extract_tables": lambda: torch.device("cuda") if experiments.extract_tables(
            [], [], []) else None,
        "svm_experiments": lambda: torch.device("cuda") if experiments.svm_experiments(
            {"d": experiments.SvmDataset(_tiny_svm_inputs()[0], ["a", "b"], _tiny_svm_inputs()[1],
                                         ["p"] * 20)}, verbose=False) else None,
        "cnn_lstm_experiments": lambda: torch.device("cuda") if experiments.cnn_lstm_experiments(
            {}, [], "unwritten") is not None else None,
        "flagship_entry": lambda: flagship_entry()[1][1].device,
        # openSMILE's device chain given host arrays
        "upload_pcm_f32": lambda: upload_pcm_f32(np.float32(wave)).device,
        "march_batch": lambda: mark_periods_batch(
            np.float32(wave), 16000, np.full((1, 23), 160.0, np.float32), [4000], [23],
            defer=True).arrays[0].device,
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


@pytest.mark.parametrize("door", ["sequences", "embeddings"])
def test_wav2vec2_front_doors_default_to_cuda(door):
    """A front door that builds its own extractor builds it on the card."""
    import pandas as pd

    from robust_speech_analysis_framework_tpu_torch.features import wav2vec2

    run = {"sequences": wav2vec2.extract_wav2vec2_sequences,
           "embeddings": wav2vec2.extract_wav2vec2_embeddings}[door]
    df = pd.DataFrame({"filepath": ["unread.wav"]})
    kw = dict(config=Wav2Vec2Config(**SMALL), allow_random_init=True, waveforms={})
    if torch.cuda.is_available():
        assert len(run(df, **kw)) == 0
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run(df, **kw)


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


_IMPORT_MULTI_DEVICE = r"""
import importlib, sys
for name in ("parallel", "parallel.mesh", "parallel.sharding", "parallel.distributed", "utils",
             "utils.profiling", "utils.logging", "utils.reliability"):
    importlib.import_module("robust_speech_analysis_framework_tpu_torch." + name)
banned = ("jax", "jaxlib", "flax", "optax", "robust_speech_analysis_framework_tpu", "pandas")
leaked = sorted(m for m in sys.modules if m.split(".")[0] in banned)
print(leaked)
sys.exit(1 if leaked else 0)
"""


def test_multi_device_modules_import_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_MULTI_DEVICE], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("entry", ["make_mesh", "dryrun_multichip"])
def test_grid_entry_points_default_to_cuda(entry):
    """Without ``devices=`` the grid lies over the CUDA devices, and there
    is none to lie over on a host without a card."""
    from robust_speech_analysis_framework_tpu_torch.entry import dryrun_multichip
    from robust_speech_analysis_framework_tpu_torch.parallel import make_mesh

    build = {"make_mesh": lambda: make_mesh().devices[0],
             "dryrun_multichip": lambda: dryrun_multichip(2, verbose=False)["grid"].lead}[entry]
    if torch.cuda.is_available():
        if entry == "dryrun_multichip" and torch.cuda.device_count() < 2:
            with pytest.raises(ValueError, match="asked for 2 devices"):
                build()
        else:
            assert build().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="devices="):
            build()


def test_initialize_distributed_picks_gloo_only_when_asked_for_the_cpu(monkeypatch):
    import torch.distributed as dist

    from robust_speech_analysis_framework_tpu_torch.parallel import distributed

    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **kw: calls.append(backend))
    kw = dict(init_method="file:///nowhere", world_size=2, rank=0)
    assert distributed.initialize_distributed(**kw, device="cpu") is True
    assert calls == ["gloo"]
    if torch.cuda.is_available():
        assert distributed.initialize_distributed(**kw) is True
        assert calls == ["gloo", "nccl"]
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            distributed.initialize_distributed(**kw)
        assert calls == ["gloo"]
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert distributed.initialize_distributed() is False  # a world of one: nothing to join
