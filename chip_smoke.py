"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check every phase.

    python3 chip_smoke.py                        # every phase
    python3 chip_smoke.py --march [DIR]          # phase 8's period march
    python3 chip_smoke.py --train-kernels [DIR]  # phase 3's training and lanes kernels
    python3 chip_smoke.py --conv0                # phase 8's Wav2Vec2 first block
    python3 chip_smoke.py --featconv             # phase 8's strided convs, encoder batches
    python3 chip_smoke.py --posconv              # phase 8's positional conv, encoder batches
    python3 chip_smoke.py --wavlm                # phase 8's WavLM part and phase 15
    python3 chip_smoke.py --conformer            # phase 8's Conformer part and phase 16

Needs one CUDA device and ``nvcc`` (CUDA_HOME or PATH); exits non-zero
without them. DIR holds every ``csrc`` source the phase builds: another
version of a kernel, with the same C entry points. The options print their
kernel's record. Phases, each of which raises on failure (its function's
docstring says what it checks):

1. card: name and power limit (``run``);
2. build and TF32: every kernel compiled with nvcc, the port's convolutions
   in IEEE float32 under torch's defaults (``tf32_phase``), TF32 off after;
3. kernels: K1/K2, K3, K4, its pre-pass and dWh against their plain
   versions (``kernel_phase``, ``train_kernel_phase``, ``lanes_kernel_phase``);
4. flagship forward (``flagship_phase``);
5. serving, the main path (``serving_phase``);
6. training, the second main path (``training_phase``);
7. train-step parity, card against CPU (``parity_phase``);
8. K6/K7, the period march, Wav2Vec2's first block, strided convs and
   positional conv, WavLM's biased softmax and the Conformer's shifted
   softmax against their plain versions (``viterbi_kernel_phase``,
   ``march_kernel_phase``, ``conv0_kernel_phase``, ``featconv_kernel_phase``,
   ``posconv_kernel_phase``, ``wavlm_kernel_phase``, ``conformer_kernel_phase``);
9. checkpoint and openSMILE, the third main path (``checkpoint_phase``,
   ``opensmile_phase``);
10. cv, both CV engines and the lane-batched trials (``cv_phase``);
11. mshds, the whole MSHDS-25 extractor (``mshds_phase``);
12. w2v, the extraction that feeds the main path (``w2v_phase``);
13. experiments, the reference's whole workflow (``experiments_phase``);
14. multidevice, the multi-device code over one card (``multidevice_phase``);
15. wavlm, WavLM-Large extraction (``wavlm_phase``);
16. conformer, Wav2Vec2-Conformer-Large extraction (``conformer_phase``).

A phase counts every kernel wrapper's launches with :func:`count_launches`
and holds them to the units of work it ran with :func:`check_launches`
(``UNIT_LAUNCHES``). The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import functools
import hashlib
import importlib
import json
import os
import pkgutil
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from robust_speech_analysis_framework_tpu_torch.audio.io import write_wav
from robust_speech_analysis_framework_tpu_torch.eval import dl_cv
from robust_speech_analysis_framework_tpu_torch.eval.metrics import classification_metrics
from robust_speech_analysis_framework_tpu_torch.eval.splits import (
    StratifiedKFold,
    train_test_indices,
)
from robust_speech_analysis_framework_tpu_torch.features import opensmile as opensmile_mod
from robust_speech_analysis_framework_tpu_torch.features.wav2vec2 import Wav2Vec2Extractor
from robust_speech_analysis_framework_tpu_torch.features.wav2vec2 import (
    _transfer_name as w2v_transfer_name,
)
from robust_speech_analysis_framework_tpu_torch.models.cnn_lstm import (
    CNNLSTM,
    build_cnn_lstm,
    stability_probe,
)
from robust_speech_analysis_framework_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from robust_speech_analysis_framework_tpu_torch.features import mshds as mshds_mod
from robust_speech_analysis_framework_tpu_torch.ops import formants as mshds_formants
from robust_speech_analysis_framework_tpu_torch.ops import pitch as mshds_pitch
from robust_speech_analysis_framework_tpu_torch.ops import pulses as mshds_pulses
from robust_speech_analysis_framework_tpu_torch.ops import spectral as mshds_spectral
from robust_speech_analysis_framework_tpu_torch.ops import framing as framing_ops
from robust_speech_analysis_framework_tpu_torch.ops import jitter as jitter_ops
from robust_speech_analysis_framework_tpu_torch.ops import cuda as cuda_ops
from robust_speech_analysis_framework_tpu_torch.ops.cuda import _build
from robust_speech_analysis_framework_tpu_torch.ops.cuda import jitter as march_ops
from robust_speech_analysis_framework_tpu_torch.ops.cuda import lstm as lstm_ops
from robust_speech_analysis_framework_tpu_torch.ops.cuda import viterbi as viterbi_ops
from robust_speech_analysis_framework_tpu_torch.ops.cuda import wav2vec2 as w2v_ops
from robust_speech_analysis_framework_tpu_torch.ops.cuda import wavlm as wavlm_ops
from robust_speech_analysis_framework_tpu_torch.ops.cuda import conformer as conformer_ops
from robust_speech_analysis_framework_tpu_torch.serving import Predictor
from robust_speech_analysis_framework_tpu_torch.train import loops

from port_bench import conformer_counts, wavlm_counts
from port_bench.peaks import (
    PEAK_FP32_FLOPS,
    PEAK_HBM_BYTES,
    bound_ms,
    dwh_bound_ms,
    gate_acts_bound_ms,
    lstm_bound_ms,
    lstm_bwd_bound_ms,
)
from port_bench.trace import union_us

KERNEL_TOL = 1e-5  # fp32 kernel vs fp32 plain version: summation order only
DWH_TOL = 1e-4  # dWh sums T·B = 32k products per element: relative to its scale
FLAGSHIP_TOL = 1e-4  # logits after convs + 2 biLSTM layers over 2240 steps
SERVING_TOL = 1e-3  # logits after a 12-layer random-init encoder + classifier
RESAMPLE_TOL = 1e-5  # resample_poly of 16-bit PCM: a 161-tap float32 filter, summation order
# one train step card vs CPU: loss and BN statistics absolute; gradients
# relative to each tensor's largest element; parameters after one Adam step
# of lr 1e-3 absolute (1 % of a step). Adam's first step is lr·g/(|g| + eps):
# at the default eps 1e-8 an element with a gradient near 1e-8 turns a
# rounding difference in g into a large difference in its step, so the
# parity step takes eps 1e-3, where the step is at most as sensitive as g.
PARITY_LOSS_TOL, PARITY_GRAD_TOL, PARITY_PARAM_TOL = 1e-5, 1e-4, 1e-5
PARITY_ADAM_EPS = 1e-3

FRAMES_PER_SECOND = 49.9
SEQ_LEN, PAD_LEN, DIM, BATCH = 4378, 4480, 768, 128

TRAIN_SHAPE = (4096, 2, 8, 128)  # T, G, B, H: a 4378-frame batch after the max-pool
N_SEQS, MIN_FRAMES = 40, 1000
TRAIN_EPOCHS = 3
CV_TRIAL_SHAPE = (PAD_LEN // 2, 2, 4, 64)  # T, G, B, H: an inner-fold batch of a narrow trial
CV_TOL = 1e-5  # first-epoch losses, resident fold vs streaming fold on the card
FLAGSHIP_HP = {"learning_rate": 1e-3, "dropout_rate": 0.5, "cnn_out_channels": 128,
               "lstm_hidden_dim": 128, "activation_fn": "silu"}
CV_STANDARD = dict(n_splits=2, epochs=2, patience=25, batch_size=8, seed=42)
CV_NESTED = dict(n_splits_outer=2, n_splits_inner=2, n_trials=3, epochs=2, patience=10,
                 batch_size=8, inner_epochs=2, inner_batch_size=4, seed=42)
CV_BUCKET = 4096  # the one bucket of the resident-vs-streaming fold
# lane-batched trials: a round of 8 trials trained together, and the kernels'
# shapes in one of its inner-fold steps (T after the max-pool of the CV
# corpus's padded length, 4352; G = 8 lanes x 2 directions; batch 4)
LANES = 8
LANES_SHAPES = {"h64": (4352 // 2, 2 * LANES, 4, 64), "h128": (4352 // 2, 2 * LANES, 4, 128)}
CV_LANES_NESTED = dict(CV_NESTED, n_trials=LANES, trial_batch=LANES)
# one train_trials_device call of 4 lanes vs train_model of each trial: lr and
# dropout rate inside the default search space, a searched architecture
LANE_PARITY_HP = {"cnn_out_channels": 128, "lstm_hidden_dim": 64, "activation_fn": "gelu"}
LANE_PARITY_LRS, LANE_PARITY_RATES = (1e-4, 3e-4, 1e-3, 3e-5), (0.2, 0.3, 0.5, 0.4)
LANE_TOL = 1e-4  # relative, per-lane histories: grouped cuDNN convs add in another order

SCAN_TILES = (1, 2)  # the forward scan's batch tiles, timed at the flagship shape

SOURCE = "robust_speech_analysis_framework_tpu_torch/csrc/lstm_scan.cu"
TRAIN_SOURCE = "robust_speech_analysis_framework_tpu_torch/csrc/lstm_train.cu"
VITERBI_SOURCE = "robust_speech_analysis_framework_tpu_torch/csrc/viterbi.cu"
MARCH_SOURCE = "robust_speech_analysis_framework_tpu_torch/csrc/period_march.cu"
# the JAX package's device march: a lax.while_loop that XLA lowers, not Pallas
JAX_MARCH = "robust_speech_analysis_framework_tpu/ops/jitter.py:111"
CONV0_SOURCE = "robust_speech_analysis_framework_tpu_torch/csrc/feature_conv0.cu"
JAX_CONV0 = "robust_speech_analysis_framework_tpu/models/wav2vec2.py:102"
WAVLM_SOURCE = "robust_speech_analysis_framework_tpu_torch/csrc/wavlm_relpos.cu"
JAX_WAVLM = "none: the JAX package has no WavLM"
CONFORMER_SOURCE = "robust_speech_analysis_framework_tpu_torch/csrc/conformer_relpos.cu"
JAX_CONFORMER = "none: the JAX package has no Conformer"
# an extraction batch: 16 chunks of 5 s at 16 kHz, ragged as the cell's
CONV0_SAMPLES = (80_000,) * 9 + (8_000, 43_217, 79_999, 12_345, 65_536, 8_000, 8_000)
CONV0_CHANNELS = 512
POSCONV_SOURCE = "robust_speech_analysis_framework_tpu_torch/csrc/pos_conv.cu"
JAX_POSCONV = "robust_speech_analysis_framework_tpu/models/wav2vec2.py:133"
# B, T, C, groups, taps and each row's valid frames (the rest zeroed, as the
# encoder zeroes its padded frames): an extraction batch of either encoder,
# its last rows short chunks and a filler row
POSCONV_SHAPES = {
    "wav2vec2-base": ((16, 249, 768, 16, 128), (249,) * 12 + (200, 97, 12, 0)),
    "wavlm-large": ((16, 799, 1024, 16, 128), (799,) * 12 + (649, 400, 150, 24)),
}
POSCONV_SERVING = (1, 249, 768, 16, 128)  # one 5 s chunk: a short request
FEATCONV_SOURCE = "robust_speech_analysis_framework_tpu_torch/csrc/feature_conv.cu"
JAX_FEATCONV = "robust_speech_analysis_framework_tpu/models/wav2vec2.py:101"
# conv_1 ... conv_6 of each encoder: (B, conv_0's output frames, channels, GELU
# fused (group mode) or not (layer mode)) at an extraction batch and one chunk
FEATCONV_CASES = {
    "wav2vec2-base": (16, 15_999, 512, True),  # 16 x 80,000 samples
    "wavlm-large": (16, 51_199, 512, False),  # 16 x 256,000 samples
    "serving": (1, 15_999, 512, True),  # one 5 s chunk
}
FEATCONV_TAPS = ((3, 2),) * 4 + ((2, 2),) * 2  # (K, stride) of conv_1 ... conv_6
PALLAS = "robust_speech_analysis_framework_tpu/ops/pallas/lstm.py"
PALLAS_VITERBI = "robust_speech_analysis_framework_tpu/ops/pallas/viterbi.py"

# Viterbi weight schemes: openSMILE's (wTvv, wTuu, wTvuv of ShsParams) and
# Praat's at a 10 ms step (octave-jump 0.35, voiced/unvoiced 0.14, w_same 0)
OPENSMILE_W = (10.0, 0.0, 10.0)
PRAAT_W = (0.35, 0.0, 0.14)
VITERBI_SHAPES = {  # B, T, C, weights
    "ragged-opensmile": (3, 37, 7, OPENSMILE_W),
    "ragged-praat": (3, 37, 7, PRAAT_W),
    "ragged-c32": (1, 300, 32, PRAAT_W),  # every lane a state, 19 chunks of 16 frames
    "ragged-c1": (2, 129, 1, OPENSMILE_W),  # one state; 128 steps: two whole chunks
    # one 60 s file's bucket: bucket_size(960000, 8000) = 1037971 samples
    "opensmile": (4, 6485, 7, OPENSMILE_W),
    # 60 s at Praat's 10 ms step with its 40 ms window: 5997 frames
    "praat": (8, 5997, 15, PRAAT_W),
}
SR = 16000
OS_FILES, OS_MIN_S, OS_MAX_S = 16, 20.0, 60.0
# the period march kernel against its plain version (both float64 sums, in
# other orders: a near-tie may break apart) and against the numpy oracle
# (window energies as prefix-sum differences there)
MARCH_SAME, MARCH_ORACLE_SAME, MARCH_TOL = 0.999, 0.99, 1e-6
# H100 SXM float64 peak outside the tensor cores, 34 TFLOP/s (NVIDIA data
# sheet, 700 W). The data sheet's 67 TFLOP/s float64 tensor-core rate is for
# matrix products (DMMA tiles m8n8k4); the march's lag scores are one
# matrix-vector product a substep (one template against its lag windows,
# and the next substep's template depends on this one's winner), which
# fills one of a tile's eight columns: at most 67 / 8 TFLOP/s there, so the
# vector rate is the higher one this work can reach
PEAK_FP64_FLOPS = 34e12
CKPT_TOL = 3e-7  # a train step's run-to-run spread on the card (cuDNN's backward)
# card vs CPU on extraction: the JAX package's batched-vs-serial families
OS_MEDIAN_TOL, OS_MEAN_TOL, OS_VQ_MEAN_TOL = 1e-5, 2e-4, 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Device time of ``fn``, per run, over a CUDA graph of ``reps`` runs
    captured after one warm-up: the host's cost of each call (Python, the
    wrapper, the launch) is left out, which ``cuda_ms`` counts whenever it
    exceeds the device time of a call."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = cuda_ms(graph.replay, 3) / reps
    del graph
    return ms


# What one unit of work launches, kernel by kernel. A width that the unit's
# config sets is named by its attribute there (``check_launches``'s config).
LSTM_LAYERS = 2  # every CNN-LSTM here: build_cnn_lstm's and the search space's
STEP_KERNELS = ("lstm_scan_fwd_res_grouped", "lstm_scan_bwd_grouped", "lstm_gate_acts_grouped",
                "lstm_dwh_grouped")
UNIT_LAUNCHES = {
    # a CNN-LSTM eval forward (of one model or of its lanes): K1 once a biLSTM layer
    "cnnlstm-eval": {"lstm_scan_grouped": LSTM_LAYERS},
    # a train step (of one model or of its lanes): K3, K4, its pre-pass and dWh, likewise
    "cnnlstm-step": dict.fromkeys(STEP_KERNELS, LSTM_LAYERS),
    # a float32 encoder batch: conv_1 ... conv_6 one launch each
    "w2v2-batch": {"conv0_norm_gelu": 1, "feature_conv": 6, "pos_conv_gelu": 1},
    "w2v2-batch-bf16": {},
    "wavlm-batch": {"feature_conv": 6, "pos_conv_gelu": 1, "relpos_softmax": "num_layers"},
    "conformer-batch": {"feature_conv": 6, "relpos_shift_softmax": "num_layers"},
    "opensmile-sub-batch": {"viterbi_forward_costs": 1, "viterbi_path": 1, "march_periods": 1},
    "mshds-pitch-pass": {"viterbi_forward_costs": 1, "viterbi_path": 1},
}


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port by name: each module-level callable
    of ``ops.cuda.*`` with an integer ``launches`` attribute."""
    found = {}
    for info in pkgutil.iter_modules(cuda_ops.__path__):
        module = importlib.import_module(f"{cuda_ops.__name__}.{info.name}")
        found.update((name, fn) for name, fn in vars(module).items()
                     if callable(fn) and type(getattr(fn, "launches", None)) is int)
    return found


@contextlib.contextmanager
def count_launches():
    """Zeroes every kernel wrapper's count; the dict it gives holds
    ``{kernel: launches}`` over the block once the block ends."""
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    counts = {}
    yield counts
    counts.update((name, fn.launches) for name, fn in wrappers.items())


def expected_launches(units: dict, config=None) -> dict:
    """Each kernel's launches over ``units`` ({unit: how many}) by
    ``UNIT_LAUNCHES``; a width named there is read from ``config``."""
    want = collections.Counter()
    for unit, n in units.items():
        for kernel, per in UNIT_LAUNCHES[unit].items():
            want[kernel] += n * (getattr(config, per) if isinstance(per, str) else per)
    return dict(want)


def check_launches(label: str, counts: dict, units: dict, config=None) -> None:
    """A phase's launches (``count_launches``) against the table's sum over
    the units of work it ran, kernel by kernel and exactly: a kernel that
    none of them launches must read 0."""
    want = expected_launches(units, config)
    wrong = sorted(k for k in set(counts) | set(want) if counts.get(k, 0) != want.get(k, 0))
    log(f"[{label}] launches {({k: n for k, n in counts.items() if n})} over {units}"
        + (f"; expected {want}, {wrong} differ" if wrong else ", as the table says"))
    if wrong:
        raise AssertionError(f"the {label} path's launches of {wrong} differ from its units'")


def _added(*counts: dict) -> dict:
    """Launch counts of several runs, kernel by kernel."""
    return {name: sum(c[name] for c in counts) for name in counts[0]}


def kernel_phase(dev: torch.device) -> dict:
    """K1 (``lstm_scan_grouped``) and K2 (``lstm_scan``) against their plain
    PyTorch versions on the card at a ragged shape, a CV trial's width
    (H=64, B=4), the flagship batch shape and the serving shape, with their
    times (and microseconds a step of the time loop) beside the plain
    version's, the cuDNN ``nn.LSTM`` yardstick and the card's bound; K1 at
    each batch tile its kernel has, bit-equal to one another."""
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = {"ragged": (37, 3, 8), "cv-trial": (CV_TRIAL_SHAPE[0], *CV_TRIAL_SHAPE[2:]), "flagship": (2240, 128, 128),
              "serving": (4096, 1, 128)}
    records = {"lstm_scan_grouped": {"max_abs_err": 0.0}, "lstm_scan": {"max_abs_err": 0.0}}
    for label, (t, b, h) in shapes.items():
        gates = torch.randn(t, 2, b, 4 * h, device=dev, generator=gen) * 0.5
        wh = (torch.rand(2, h, 4 * h, device=dev, generator=gen) * 2 - 1) / h**0.5
        g1, w1 = gates[:, 0].contiguous(), wh[0].contiguous()
        cases = {
            "lstm_scan_grouped": (lstm_ops.lstm_scan_grouped, lstm_ops.lstm_scan_reference_grouped,
                                  (gates, wh), 2, True),
            "lstm_scan": (lstm_ops.lstm_scan, lstm_ops.lstm_scan_reference, (g1, w1), 1, False),
        }
        for name, (kernel, plain, args, g, bidir) in cases.items():
            out = kernel(*args)
            torch.cuda.synchronize()
            ref = plain(*args)
            err = float((out - ref).abs().max())
            log(f"[kernels] {name} {label} T={t} G={g} B={b} H={h}: max|d|={err:.3e} "
                f"(tol {KERNEL_TOL})")
            if not err <= KERNEL_TOL:
                raise AssertionError(f"{name} disagrees with its plain version at {label}")
            rec = records[name]
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if label in ("ragged", "cv-trial"):
                continue
            reps = 5
            ms = cuda_ms(lambda: kernel(*args), reps)
            plain_ms = cuda_ms(lambda: plain(*args), 2)
            lib = torch.nn.LSTM(h, h, bidirectional=bidir).to(dev).eval()
            x = torch.randn(t, b, h, device=dev, generator=gen)
            with torch.no_grad():
                library_ms = cuda_ms(lambda: lib(x), reps)
            bound_ms, bound_by = lstm_bound_ms(t, g, b, h)
            timing = {"shape": f"T={t} G={g} B={b} H={h}", "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
            log(f"[kernels] {name} {label}: kernel {ms:.4f} ms ({ms / t * 1e3:.3f} us a step), "
                f"plain {plain_ms:.4f} ms, "
                f"cuDNN nn.LSTM({h}, {h}, bidirectional={bidir}) one layer incl. its input "
                f"projection {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
            if label == "flagship":
                rec.update(timing)
            else:
                rec["serving"] = timing
        if label == "flagship":
            ref = lstm_ops.lstm_scan_grouped(gates, wh)
            for tile in SCAN_TILES:
                out = lstm_ops._launch(gates, wh, tile)
                err = float((out - ref).abs().max())
                ms = cuda_ms(lambda: lstm_ops._launch(gates, wh, tile), 3)
                log(f"[kernels] lstm_scan_grouped flagship batch_tile={tile}: {ms:.4f} ms "
                    f"({ms / t * 1e3:.3f} us a step); max|d| to the wrapper's own tile {err:.3e}")
                if err != 0.0:
                    raise AssertionError(f"the scan at batch tile {tile} differs from the wrapper's")
    return records


def flagship_phase(dev: torch.device) -> None:
    """The flagship forward: CNNLSTM(768, 128, 128), batch 128 × 4480 × 768,
    lengths 4378, one unit of eval launches (``UNIT_LAUNCHES``); logits of two
    rows against the same model on the CPU; median time and a profile."""
    model = build_cnn_lstm(DIM, 128, 128, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(BATCH, PAD_LEN, DIM, device=dev, generator=gen)
    x[:, SEQ_LEN:] = 0.0
    lengths = torch.full((BATCH,), SEQ_LEN, dtype=torch.int32, device=dev)
    with count_launches() as launched, torch.inference_mode():
        logits = model(x, lengths)
    torch.cuda.synchronize()
    check_launches("flagship", launched, {"cnnlstm-eval": 1})
    if logits.shape != (BATCH, 2) or not torch.isfinite(logits).all():
        raise AssertionError(f"bad flagship logits {tuple(logits.shape)}")

    cpu_model = copy.deepcopy(model).cpu()
    with torch.inference_mode():
        cpu_logits = cpu_model(x[:2].cpu(), lengths[:2].cpu())
    err = float((logits[:2].cpu() - cpu_logits).abs().max())
    log(f"[flagship] logits rows 0-1 card vs CPU: max|d|={err:.3e} (tol {FLAGSHIP_TOL})")
    if not err <= FLAGSHIP_TOL:
        raise AssertionError("flagship logits on the card disagree with the CPU")

    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        with torch.inference_mode():
            model(x, lengths)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    median = statistics.median(times)
    audio_s = BATCH * SEQ_LEN / FRAMES_PER_SECOND
    log(f"[flagship] forward median {median * 1e3:.3f} ms over {len(times)} runs "
        f"({[round(t * 1e3, 3) for t in times]} ms); {audio_s / median:.1f} audio-s/s")
    profile_forward(model, x, lengths)


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def _on_device(e) -> bool:
    """Whether a profiler event (or row) is the device's own work: a kernel
    or a copy, not the device-side mirror of a ``record_function`` range
    (the program's spans open one while the profiler records), which spans
    the whole range."""
    from torch.autograd import DeviceType

    return e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)


def _device_rows(prof) -> list:
    """The profile's device kernel rows, longest first (an operator's row
    repeats its kernels' time, so only the device's own)."""
    rows = [e for e in prof.key_averages() if _on_device(e)]
    return sorted(rows, key=_device_us, reverse=True)


def _log_top_kernels(rows: list, top: int) -> None:
    for e in rows[:top]:
        log(f"[profile]   {_device_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")


def profile_device(label: str, fn, top: int) -> None:
    """Device time by kernel over one call of ``fn`` (torch.profiler), with
    the device's idle share of the window."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    rows = _device_rows(prof)
    total_ms = sum(_device_us(e) for e in rows) / 1e3
    if total_ms == 0:
        log("[profile] the profiler recorded no device time")
        return
    log(f"[profile] {label}: {wall_ms:.3f} ms wall, {total_ms:.3f} ms device "
        f"(device idle {max(0.0, 1 - total_ms / wall_ms):.1%} of the window)")
    _log_top_kernels(rows, top)


def profile_forward(model, x, lengths) -> None:
    """Device time by kernel over one flagship forward."""

    def forward():
        with torch.inference_mode():
            model(x, lengths)

    profile_device("one flagship forward", forward, 8)


def serving_phase(dev: torch.device, tmp: str) -> dict:
    """The main path: a Predictor with a full-width random-init
    Wav2Vec2-base and the flagship CNN-LSTM answers three waveform requests,
    one predict_files call (16 kHz and 8 kHz WAVs) and one predict_sequence:
    an eval unit a request and a Wav2Vec2 batch a predict() and the files'
    call; one request's Wav2Vec2 sequence and logits against the same
    predictor on the CPU. Returns the launches."""
    rng = np.random.default_rng(0)
    extractor = Wav2Vec2Extractor(config=Wav2Vec2Config(), allow_random_init=True,
                                  seed=0, device=dev)
    predictor = Predictor(build_cnn_lstm(DIM, 128, 128, seed=0, device=dev),
                          extractor=extractor, device=dev)

    def speechlike(seconds: float, sr: int = 16000) -> np.ndarray:
        t = np.arange(int(seconds * sr)) / sr
        x = 0.3 * np.sin(2 * np.pi * 140 * t) * (1 + np.sin(2 * np.pi * 3 * t))
        return (x + 0.02 * rng.normal(size=t.shape)).astype(np.float32)

    waves = {f"{s}s": speechlike(s) for s in (2, 12, 31)}
    paths = [os.path.join(tmp, "req16k.wav"), os.path.join(tmp, "req8k.wav")]
    write_wav(paths[0], speechlike(7.0), 16000)
    write_wav(paths[1], speechlike(9.0, 8000), 8000)
    sequence = rng.normal(size=(SEQ_LEN, DIM)).astype(np.float32)

    with count_launches() as launches:
        preds = {f"predict({k})": predictor.predict(w) for k, w in waves.items()}
        for name, pred in predictor.predict_files(paths).items():
            preds[f"predict_files({name})"] = pred
        preds["predict_sequence(4378x768)"] = predictor.predict_sequence(sequence)
        torch.cuda.synchronize()

    for name, pred in preds.items():
        log(f"[serving] {name}: {pred.label} p(Patient)={pred.probability:.6f} "
            f"latency {pred.latency_seconds * 1e3:.3f} ms")
        if pred.logits.shape != (2,) or not np.isfinite(pred.logits).all():
            raise AssertionError(f"bad logits for {name}")
    n_batches = len(waves) + 1  # an encoder batch a predict(), one for predict_files' files
    check_launches("serving", launches, {"cnnlstm-eval": len(preds), "w2v2-batch": n_batches})

    cpu_extractor = Wav2Vec2Extractor(
        params={k: v.cpu() for k, v in extractor.model.state_dict().items()},
        config=Wav2Vec2Config(), batch_size=1, device="cpu",
    )
    cpu_predictor = Predictor(copy.deepcopy(predictor.model).cpu(), extractor=cpu_extractor,
                              device="cpu")
    seq = extractor.extract_sequences({"2s": waves["2s"]}, verbose=False)["2s"]
    cpu_seq = cpu_extractor.extract_sequences({"2s": waves["2s"]}, verbose=False)["2s"]
    seq_err = float(np.abs(seq - cpu_seq).max())
    log(f"[serving] 2s request Wav2Vec2 sequence {seq.shape} card vs CPU: "
        f"max|d|={seq_err:.3e} (tol {SERVING_TOL})")
    cpu_pred = cpu_predictor.predict_sequence(cpu_seq)
    err = float(np.abs(cpu_pred.logits - preds["predict(2s)"].logits).max())
    log(f"[serving] predict(2s) logits card vs CPU: max|d|={err:.3e} (tol {SERVING_TOL})")
    if not (seq_err <= SERVING_TOL and err <= SERVING_TOL):
        raise AssertionError("serving on the card disagrees with the CPU")
    return launches


SWEEP_TILE_SHAPE = (1024, 2, 64, 128)  # T, G, B, H for the sweep's batch-tile times


def _train_kernel_inputs(dev, gen, t, g, b, h):
    gates = torch.randn(t, g, b, 4 * h, device=dev, generator=gen) * 0.5
    wh = (torch.rand(g, h, 4 * h, device=dev, generator=gen) * 2 - 1) / h**0.5
    dhout = torch.randn(t, g, b, h, device=dev, generator=gen)
    return gates, wh, dhout


def _sweep_alone_ms(acts, cs, wh, dhout, tile: int, reps: int) -> float:
    """Time of K4's sweep alone. It works in place, so each run gets a fresh
    copy of the activations and the copy's own time is taken off."""
    copy_ms = cuda_ms(acts.clone, reps)
    both = cuda_ms(lambda: lstm_ops._launch_sweep(acts.clone(), cs, wh, dhout, tile), reps)
    return both - copy_ms


# T, G, B, H of the dWh kernel's ragged cases: no rows; one step; rows that
# end inside a chunk; H below, between and at the tile's k halves; B = 1; a
# last slice that ends short (5083 rows in 16 slices of 320)
DWH_RAGGED_SHAPES = ((1, 2, 3, 16), (2, 2, 3, 8), (64, 1, 9, 40), (33, 2, 5, 24),
                     (48, 2, 67, 64), (1000, 3, 1, 64), (300, 2, 17, 128))


def dwh_ragged_checks(dev: torch.device, gen: torch.Generator) -> float:
    """The dWh kernel alone against its plain version at the ragged shapes;
    returns the largest error."""
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst = 0.0
    for t, g, b, h in DWH_RAGGED_SHAPES:
        hs = torch.rand(t, g, b, h, device=dev, generator=gen) * 2 - 1
        dg = torch.randn(t, g, b, 4 * h, device=dev, generator=gen)
        dwh = lstm_ops.lstm_dwh_grouped(hs, dg)
        again = lstm_ops.lstm_dwh_grouped(hs, dg)
        torch.cuda.synchronize()
        ref = lstm_ops.lstm_dwh_reference_grouped(hs, dg)
        scale = float(ref.abs().max()) if ref.numel() else 0.0
        err = float((dwh - ref).abs().max())
        slices, rows = lstm_ops._dwh_split((t - 1) * b, g, h, n_sms)
        log(f"[train-kernels] dWh ragged T={t} G={g} B={b} H={h}: {(t - 1) * b} rows in "
            f"{slices} slices of {rows}; max|d|={err:.3e} of max|dWh| {scale:.3e} "
            f"(tol {DWH_TOL} x max(1, max|dWh|)); two calls bit-equal: "
            f"{torch.equal(dwh, again)}")
        if not (err <= DWH_TOL * max(1.0, scale) and torch.equal(dwh, again)
                and (t > 1 or not dwh.any())):
            raise AssertionError(f"the dWh kernel fails at T={t} G={g} B={b} H={h}")
        worst = max(worst, err)
    return worst


# T, G, B, H and a factor on the gate inputs of the pre-pass's ragged cases:
# T = 1 and fewer rows than a tile; T·B not a multiple of the tile; B = 1;
# B = 67 at G = 3 (312 items: blocks walk runs that cross column groups);
# G = 16 at H = 64 and 128; gate inputs of up to ~±200, where sigmoid's
# divisor reaches 2^126 and inf (its exact division) and its outputs are
# subnormal
GATE_ACTS_RAGGED_SHAPES = ((1, 1, 5, 8, 1), (2, 2, 1, 8, 1), (37, 2, 3, 24, 1), (700, 1, 1, 64, 1),
                           (48, 3, 67, 128, 1), (300, 16, 4, 64, 1), (97, 16, 3, 128, 1),
                           (37, 2, 3, 64, 100))


def gate_acts_ragged_checks(dev: torch.device, gen: torch.Generator) -> float:
    """The pre-pass alone against its plain version at the ragged shapes;
    returns the largest error."""
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst = 0.0
    for t, g, b, h, factor in GATE_ACTS_RAGGED_SHAPES:
        gates, wh, _ = _train_kernel_inputs(dev, gen, t, g, b, h)
        gates *= factor
        hs = torch.rand(t, g, b, h, device=dev, generator=gen) * 2 - 1
        acts = lstm_ops.lstm_gate_acts_grouped(gates, hs, wh)
        again = lstm_ops.lstm_gate_acts_grouped(gates, hs, wh)
        torch.cuda.synchronize()
        err = float((acts - lstm_ops.lstm_gate_acts_reference_grouped(gates, hs, wh)).abs().max())
        plan = lstm_ops._acts_plan(t * b, g, h, n_sms)
        digest = hashlib.sha256(acts.cpu().numpy().tobytes()).hexdigest()
        log(f"[train-kernels] pre-pass ragged T={t} G={g} B={b} H={h} gates x{factor}: "
            f"{plan.row_tiles} row tiles x {plan.col_tiles} column tiles x {g} on {plan.grid} "
            f"blocks of {plan.per} items; max|d|={err:.3e} (tol {KERNEL_TOL}); two calls "
            f"bit-equal: {torch.equal(acts, again)}; output sha256 {digest}")
        if not (err <= KERNEL_TOL and torch.equal(acts, again)):
            raise AssertionError(f"the pre-pass fails at T={t} G={g} B={b} H={h}")
        worst = max(worst, err)
    return worst


def gate_acts_report(label: str, gates, hs, wh, acts: torch.Tensor, ms: float,
                     bound: float) -> dict:
    """The pre-pass's rate, share of its bound and output digest at a timed
    shape (the digest holds two builds' outputs equal bit for bit), and its
    profile build's clocks by phase: its output bit-equal to the timed
    build's, each phase's share of all blocks' clocks and its clocks an
    item, beside an item's FMA issue alone (128 FMAs a clock an SM)."""
    from robust_speech_analysis_framework_tpu_torch.tools import warp_latency

    t, g, b, four_h = acts.shape
    h = four_h // 4
    tflops = 2 * t * g * b * h * four_h / ms / 1e9
    digest = hashlib.sha256(acts.cpu().numpy().tobytes()).hexdigest()
    plan = lstm_ops._acts_plan(t * b, g, h, torch.cuda.get_device_properties(
        acts.device).multi_processor_count)
    log(f"[train-kernels] pre-pass {label} T={t} G={g} B={b} H={h}: {ms:.4f} ms, "
        f"{tflops:.1f} TFLOP/s fp32, {bound / ms:.1%} of its bound ({bound:.4f} ms); "
        f"output sha256 {digest}")
    result = {"tflops": tflops, "share_of_bound": bound / ms, "sha256": digest}
    if not hasattr(_build.load("lstm_train"), "lstm_gate_acts_profile_f32"):
        log(f"[train-kernels] pre-pass {label}: no profile build in this build of "
            f"lstm_train.cu (an older version's, --train-kernels DIR)")
        return result
    (out, prof), prof_ms = timed_once(lambda: lstm_ops.lstm_gate_acts_profile(gates, hs, wh))
    if not torch.equal(out, acts):
        raise AssertionError(f"the pre-pass's profile build disagrees with its timed build "
                             f"at {label}")
    prof = prof.cpu().numpy()
    total = prof[:, 0]
    items = np.array([min(plan.per, g * plan.col_tiles * plan.row_tiles - i * plan.per)
                      for i in range(plan.grid)])
    ghz, _ = warp_latency.sm_clock_ghz()
    fma_issue = -(-h // lstm_ops.ACTS_K) * lstm_ops.ACTS_K * lstm_ops.ACTS_ROWS  # clocks an item
    phases = {name: float(prof[:, 1 + i].sum() / items.sum())
              for i, name in enumerate(lstm_ops.GATE_ACTS_PHASES)}
    item_clocks = float(total.sum() / items.sum())
    log(f"[train-kernels] pre-pass {label} profile build {prof_ms:.4f} ms, output bit-equal to "
        f"the timed build's; {plan.grid} blocks of {plan.per} items, {plan.smem_bytes} B of "
        f"shared memory a block; SM clock {ghz:.3f} GHz; slowest block {int(total.max())} clocks "
        f"({total.max() / ghz / 1e6:.4f} ms); an item {item_clocks:.0f} clocks "
        f"({item_clocks / ghz / 1e3:.3f} us), its FMA issue alone {fma_issue}; by phase, "
        f"clocks an item and share: " + ", ".join(
            f"{name} {v:.0f} ({v / item_clocks:.1%})" for name, v in phases.items()))
    result["phases"] = {"sm_ghz": ghz, "item_clocks": item_clocks, "fma_issue_clocks": fma_issue,
                        "slowest_block_clocks": int(total.max()), "profile_ms": prof_ms,
                        "clocks_an_item": phases}
    return result


def train_kernel_phase(dev: torch.device) -> dict:
    """K3 (``lstm_scan_fwd_res_grouped``: hs, cs), K4
    (``lstm_scan_bwd_grouped``: dgates, dWh), its gate pre-pass
    (``lstm_gate_acts_grouped``) and the dWh kernel (``lstm_dwh_grouped``)
    against their plain versions at a ragged shape, a CV trial's shape
    (T=2240, G=2, B=4, H=64) and the training shape (T=4096, G=2, B=8,
    H=128), timed beside cuDNN's biLSTM forward (K3) and backward (K4),
    ``torch.baddbmm`` with the activations (pre-pass) and ``torch.einsum``
    (dWh); K1's hs bit-equal to K3's; how far the pre-pass's gates lie from
    the ones K3 used (printed); K4's sweep alone, and at batch tiles 1/2/4
    at B=64; the dWh kernel alone at ragged shapes (T=1: all zeros; T=2; B=1
    and 3; H=24, 40, 64; rows that do not fill the last slice) with its row
    split printed and two calls bit-equal; the pre-pass alone at ragged
    shapes (T=1; T*B not a multiple of its 128-row tile or below it; B=1 and
    67; G=1, 2, 3 and 16; H=8, 24, 64 and 128) with its plan printed and two
    calls bit-equal; the pre-pass's TFLOP/s, share of its bound, output
    digest and profile build's phases at each timed shape."""
    gen = torch.Generator(device=dev).manual_seed(2)
    records = {name: {"max_abs_err": 0.0} for name in
               ("lstm_scan_fwd_res_grouped", "lstm_scan_bwd_grouped", "lstm_gate_acts_grouped",
                "lstm_dwh_grouped")}
    for label, (t, g, b, h) in {"ragged": (37, 2, 3, 8), "cv-trial": CV_TRIAL_SHAPE,
                                "training": TRAIN_SHAPE}.items():
        gates, wh, dhout = _train_kernel_inputs(dev, gen, t, g, b, h)
        hs, cs = lstm_ops.lstm_scan_fwd_res_grouped(gates, wh)
        dg, dwh = lstm_ops.lstm_scan_bwd_grouped(gates, hs, cs, wh, dhout)
        acts = lstm_ops.lstm_gate_acts_grouped(gates, hs, wh)
        dwh_alone = lstm_ops.lstm_dwh_grouped(hs, dg)
        torch.cuda.synchronize()
        ref_hs, ref_cs = lstm_ops.lstm_scan_fwd_res_reference_grouped(gates, wh)
        ref_dg, ref_dwh = lstm_ops.lstm_scan_bwd_reference_grouped(gates, hs, cs, wh, dhout)
        ref_acts = lstm_ops.lstm_gate_acts_reference_grouped(gates, hs, wh)
        scale = float(ref_dwh.abs().max())
        errs = {
            "lstm_scan_fwd_res_grouped": max(float((hs - ref_hs).abs().max()),
                                             float((cs - ref_cs).abs().max())),
            "lstm_scan_bwd_grouped": float((dg - ref_dg).abs().max()),
            "lstm_gate_acts_grouped": float((acts - ref_acts).abs().max()),
            "lstm_dwh_grouped": float((dwh - ref_dwh).abs().max()),
        }
        log(f"[train-kernels] {label} T={t} G={g} B={b} H={h}: K3 hs/cs max|d|="
            f"{errs['lstm_scan_fwd_res_grouped']:.3e} (tol {KERNEL_TOL}); K4 dgates max|d|="
            f"{errs['lstm_scan_bwd_grouped']:.3e} (tol {KERNEL_TOL}); its pre-pass max|d|="
            f"{errs['lstm_gate_acts_grouped']:.3e} (tol {KERNEL_TOL}); dWh max|d|="
            f"{errs['lstm_dwh_grouped']:.3e} of max|dWh| {scale:.3e} "
            f"(tol {DWH_TOL} x max(1, max|dWh|))")
        if not (errs["lstm_scan_fwd_res_grouped"] <= KERNEL_TOL
                and errs["lstm_scan_bwd_grouped"] <= KERNEL_TOL
                and errs["lstm_gate_acts_grouped"] <= KERNEL_TOL
                and errs["lstm_dwh_grouped"] <= DWH_TOL * max(1.0, scale)
                and torch.equal(dwh, dwh_alone)):
            raise AssertionError(f"a training kernel disagrees with its plain version at {label}")
        for name, err in errs.items():
            records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
        # K1 and K3 are one kernel template: the same hs, bit for bit
        if not torch.equal(lstm_ops.lstm_scan_grouped(gates, wh), hs):
            raise AssertionError(f"K1's hs and K3's hs differ at {label}")
        # K4's pre-pass recomputes z in its own order of additions: how far its
        # gates lie from the ones K3 used, seen through K3's own c_t and h_t
        i_, f_, g_, o_ = acts.split(h, dim=-1)
        c_prev = torch.cat([torch.zeros_like(cs[:1]), cs[:-1]])
        dc = float((f_ * c_prev + i_ * g_ - cs).abs().max())
        dh = float((o_ * torch.tanh(cs) - hs).abs().max())
        log(f"[train-kernels] {label}: K1 hs = K3 hs bit for bit; K4's pre-pass against K3: "
            f"max|f*c_(t-1) + i*g - c_t|={dc:.3e}, max|o*tanh(c_t) - h_t|={dh:.3e} (printed, "
            f"no tolerance: the sweep does not need them equal)")
        if label != "training":
            continue

        reps = 10
        lib = torch.nn.LSTM(h, h, bidirectional=True).to(dev).train()
        x = torch.randn(t, b, h, device=dev, generator=gen, requires_grad=True)
        out, _ = lib(x)
        grad_out = torch.randn_like(out)
        # direction-major copies for the pre-pass's yardstick, made outside its time
        gates_gm = gates.transpose(0, 1).reshape(g, t * b, 4 * h)
        hprev_gm = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]]).transpose(0, 1).reshape(
            g, t * b, h)

        def baddbmm_acts():
            z = torch.baddbmm(gates_gm, hprev_gm, wh)
            z[..., : 2 * h].sigmoid_()
            z[..., 2 * h : 3 * h].tanh_()
            z[..., 3 * h :].sigmoid_()
            return z

        cases = {
            "lstm_scan_fwd_res_grouped": (
                lambda: lstm_ops.lstm_scan_fwd_res_grouped(gates, wh),
                lambda: lstm_ops.lstm_scan_fwd_res_reference_grouped(gates, wh),
                lambda: lib(x), "cuDNN nn.LSTM(128, 128, bidirectional=True) train-mode "
                "forward incl. its input projection", lstm_bound_ms(t, g, b, h, save_c=True)),
            "lstm_scan_bwd_grouped": (
                lambda: lstm_ops.lstm_scan_bwd_grouped(gates, hs, cs, wh, dhout),
                lambda: lstm_ops.lstm_scan_bwd_reference_grouped(gates, hs, cs, wh, dhout),
                lambda: torch.autograd.grad(out, [x, *lib.parameters()], grad_out,
                                            retain_graph=True),
                "cuDNN backward of that layer (dx and every weight)",
                lstm_bwd_bound_ms(t, g, b, h)),
            "lstm_gate_acts_grouped": (
                lambda: lstm_ops.lstm_gate_acts_grouped(gates, hs, wh),
                lambda: lstm_ops.lstm_gate_acts_reference_grouped(gates, hs, wh),
                baddbmm_acts, "torch.baddbmm (cuBLAS) over direction-major copies, then "
                "sigmoid_/tanh_ of the column blocks", gate_acts_bound_ms(t, g, b, h)),
            "lstm_dwh_grouped": (
                lambda: lstm_ops.lstm_dwh_grouped(hs, dg),
                lambda: lstm_ops.lstm_dwh_reference_grouped(hs, dg),
                lambda: torch.einsum("tgbk,tgbj->gkj", hs[:-1], dg[1:]),
                "torch.einsum (cuBLAS) over the shifted hs and dgates", dwh_bound_ms(t, g, b, h)),
        }
        for name, (kernel, plain, library, lib_label, (bound, bound_by)) in cases.items():
            ms = cuda_ms(kernel, reps)
            plain_ms = cuda_ms(plain, 1)
            library_ms = cuda_ms(library, reps)
            records[name].update({
                "shape": f"T={t} G={g} B={b} H={h}", "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": bound_by, "library_ms": library_ms,
            })
            per_step = f" ({ms / t * 1e3:.3f} us a step)" if name == "lstm_scan_fwd_res_grouped" else ""
            log(f"[train-kernels] {name} {label}: kernel {ms:.4f} ms{per_step}, plain "
                f"{plain_ms:.4f} ms, {lib_label} {library_ms:.4f} ms, bound {bound:.4f} ms "
                f"({bound_by})")
        pre = records["lstm_gate_acts_grouped"]
        pre.update(gate_acts_report(label, gates, hs, wh, acts, pre["ms"], pre["bound_ms"]))
        sweep_ms = _sweep_alone_ms(acts, cs, wh, dhout, 0, 5)
        records["lstm_scan_bwd_grouped"]["sweep_ms"] = sweep_ms
        log(f"[train-kernels] K4 {label} by part: pre-pass "
            f"{records['lstm_gate_acts_grouped']['ms']:.4f} ms + sweep alone {sweep_ms:.4f} ms "
            f"({sweep_ms / t * 1e3:.3f} us a step) + dWh {records['lstm_dwh_grouped']['ms']:.4f} "
            f"ms; K4 whole {records['lstm_scan_bwd_grouped']['ms']:.4f} ms")

    pre = records["lstm_gate_acts_grouped"]
    pre["max_abs_err"] = max(pre["max_abs_err"], gate_acts_ragged_checks(dev, gen))
    rec = records["lstm_dwh_grouped"]
    rec["max_abs_err"] = max(rec["max_abs_err"], dwh_ragged_checks(dev, gen))
    t, g, b, h = TRAIN_SHAPE
    rec["split"] = lstm_ops._dwh_split(
        (t - 1) * b, g, h, torch.cuda.get_device_properties(dev).multi_processor_count)
    log(f"[train-kernels] dWh training: {(t - 1) * b} rows in {rec['split'][0]} slices of "
        f"{rec['split'][1]}; {2 * (t - 1) * b * g * h * 4 * h / rec['ms'] / 1e9:.1f} "
        f"TFLOP/s fp32 of {PEAK_FP32_FLOPS / 1e12:.0f}")

    t, g, b, h = SWEEP_TILE_SHAPE
    gates, wh, dhout = _train_kernel_inputs(dev, gen, t, g, b, h)
    hs, cs = lstm_ops.lstm_scan_fwd_res_grouped(gates, wh)
    dg, _ = lstm_ops.lstm_scan_bwd_grouped(gates, hs, cs, wh, dhout)
    acts = lstm_ops.lstm_gate_acts_grouped(gates, hs, wh)
    for tile in (1, 2, 4):
        buf = acts.clone()
        lstm_ops._launch_sweep(buf, cs, wh, dhout, tile)
        err = float((buf - dg).abs().max())
        ms = _sweep_alone_ms(acts, cs, wh, dhout, tile, 3)
        log(f"[train-kernels] K4 sweep alone T={t} G={g} B={b} H={h} batch_tile={tile}: "
            f"{ms:.4f} ms; max|d| to the wrapper's own tile {err:.3e} (tol {KERNEL_TOL})")
        if not err <= KERNEL_TOL:
            raise AssertionError(f"the sweep at batch tile {tile} disagrees with the wrapper's")
    return records


def timed_once(fn):
    """(result, device ms) of one call of ``fn``: for the plain versions,
    whose one call for the check is also their time."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def lanes_kernel_phase(dev: torch.device) -> dict:
    """Every LSTM kernel at a round of 8 lanes (G = 16) against its plain
    version, timed, at H = 64 and 128: the shapes where the batch tile and
    the dWh split take other branches than at G = 2. Returns, by kernel, its
    timings by shape (the records' ``lanes`` entry)."""
    gen = torch.Generator(device=dev).manual_seed(6)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lanes = {}
    for label, (t, g, b, h) in LANES_SHAPES.items():
        gates, wh, dhout = _train_kernel_inputs(dev, gen, t, g, b, h)
        hs, cs = lstm_ops.lstm_scan_fwd_res_grouped(gates, wh)
        dg, dwh = lstm_ops.lstm_scan_bwd_grouped(gates, hs, cs, wh, dhout)
        acts = lstm_ops.lstm_gate_acts_grouped(gates, hs, wh)
        swept = acts.clone()
        lstm_ops._launch_sweep(swept, cs, wh, dhout)
        cases = {  # name: (kernel, its output now, plain version, bound)
            "lstm_scan_grouped": (lambda: lstm_ops.lstm_scan_grouped(gates, wh),
                                  lstm_ops.lstm_scan_grouped(gates, wh),
                                  lambda: lstm_ops.lstm_scan_reference_grouped(gates, wh),
                                  lstm_bound_ms(t, g, b, h)),
            "lstm_scan_fwd_res_grouped": (
                lambda: lstm_ops.lstm_scan_fwd_res_grouped(gates, wh), (hs, cs),
                lambda: lstm_ops.lstm_scan_fwd_res_reference_grouped(gates, wh),
                lstm_bound_ms(t, g, b, h, save_c=True)),
            "lstm_scan_bwd_grouped": (
                lambda: lstm_ops.lstm_scan_bwd_grouped(gates, hs, cs, wh, dhout), (dg, dwh),
                lambda: lstm_ops.lstm_scan_bwd_reference_grouped(gates, hs, cs, wh, dhout),
                lstm_bwd_bound_ms(t, g, b, h)),
            "lstm_gate_acts_grouped": (
                lambda: lstm_ops.lstm_gate_acts_grouped(gates, hs, wh), acts,
                lambda: lstm_ops.lstm_gate_acts_reference_grouped(gates, hs, wh),
                gate_acts_bound_ms(t, g, b, h)),
            "sweep": (
                lambda: _sweep_alone_ms(acts, cs, wh, dhout, 0, 3), swept,
                lambda: lstm_ops.lstm_sweep_from_acts_reference_grouped(acts, cs, wh, dhout),
                lstm_bwd_bound_ms(t, g, b, h)),
            "lstm_dwh_grouped": (lambda: lstm_ops.lstm_dwh_grouped(hs, dg),
                                 lstm_ops.lstm_dwh_grouped(hs, dg),
                                 lambda: lstm_ops.lstm_dwh_reference_grouped(hs, dg),
                                 dwh_bound_ms(t, g, b, h)),
        }
        timings = {}
        for name, (kernel, out, plain, (bound, bound_by)) in cases.items():
            ref, plain_ms = timed_once(plain)
            outs = out if isinstance(out, tuple) else (out,)
            refs = ref if isinstance(ref, tuple) else (ref,)
            errs = [float((o - r).abs().max()) for o, r in zip(outs, refs)]
            # K4 whole: dgates to KERNEL_TOL, its dWh to DWH_TOL of its scale
            tols = [DWH_TOL * max(1.0, float(r.abs().max())) if r.dim() == 3 else KERNEL_TOL
                    for r in refs]
            if not all(e <= tol for e, tol in zip(errs, tols)):
                raise AssertionError(f"{name} disagrees with its plain version at lanes {label}: "
                                     f"max|d| {errs}, tolerances {tols}")
            ms = kernel() if name == "sweep" else cuda_ms(kernel, 5)
            timings[name] = {"shape": f"T={t} G={g} B={b} H={h}", "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bound, "bound_by": bound_by, "max_abs_err": max(errs)}
            log(f"[train-kernels] lanes {label} {name} T={t} G={g} B={b} H={h}: max|d|="
                f"{max(errs):.3e} (tol {max(tols):.3g}); kernel {ms:.4f} ms ({ms / t * 1e3:.3f} us "
                f"a step), plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({bound_by})")
        pre = timings["lstm_gate_acts_grouped"]
        pre.update(gate_acts_report(f"lanes {label}", gates, hs, wh, acts, pre["ms"],
                                    pre["bound_ms"]))
        lib = cuda_ms(lambda: torch.einsum("tgbk,tgbj->gkj", hs[:-1], dg[1:]), 5)
        timings["lstm_dwh_grouped"]["library_ms"] = lib
        timings["lstm_scan_bwd_grouped"]["sweep_ms"] = timings.pop("sweep")["ms"]
        slices = lstm_ops._dwh_split((t - 1) * b, g, h, n_sms)
        tiles = (lstm_ops._pick_batch_tile(g, b, n_sms, lstm_ops.SCAN_LARGEST_TILE),
                 lstm_ops._pick_batch_tile(g, b, n_sms, lstm_ops.SWEEP_LARGEST_TILE))
        log(f"[train-kernels] lanes {label} at G={g}: scan batch tile {tiles[0]} "
            f"({g * -(-b // tiles[0])} blocks), sweep batch tile {tiles[1]} "
            f"({g * -(-b // tiles[1])} blocks) on {n_sms} SMs; dWh {(t - 1) * b} rows in "
            f"{slices[0]} slices of {slices[1]} over {-(-4 * h // lstm_ops.DWH_COLS) * g} output "
            f"tiles; torch.einsum for dWh {lib:.4f} ms")
        timings["lstm_scan_grouped"]["batch_tile"] = tiles[0]
        timings["lstm_scan_bwd_grouped"]["batch_tile"] = tiles[1]
        timings["lstm_dwh_grouped"]["split"] = slices
        for name, timing in timings.items():
            lanes.setdefault(name, {})[label] = timing
    return lanes


def _synthetic_corpus(seed: int):
    """N_SEQS Wav2Vec2-width sequences of MIN_FRAMES to SEQ_LEN frames,
    balanced labels, class 1 shifted a little on a few dimensions."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(MIN_FRAMES, SEQ_LEN + 1, size=N_SEQS)
    labels = np.arange(N_SEQS) % 2
    seqs = []
    for n, y in zip(lengths, labels):
        x = rng.standard_normal((n, DIM), dtype=np.float32)
        x[:, :16] += 0.3 * y
        seqs.append(x)
    return seqs, labels


def training_phase(dev: torch.device) -> tuple:
    """The second main path: fold 0 of StratifiedKFold(5, seed 42) over a
    seeded synthetic corpus of 40 Wav2Vec2-width sequences (1000 to 4378
    frames), the inner 80/20 split, ``train_model`` of the flagship
    CNNLSTM(768, 128, 128) (batch 8, Adam 1e-3, dropout 0.5, plateau decay,
    early stop, best-weight restore) on the streaming path
    (``device_fold="off"``) for 3 epochs, then ``evaluate_model`` and the
    fold's metrics; a step unit a train step and an eval unit an eval batch;
    loss per epoch, step time, audio-seconds trained per second, peak memory
    and a profile of one train step. Returns the launches and the median
    train step in ms."""
    t0 = time.perf_counter()
    seqs, y = _synthetic_corpus(0)
    log(f"[training] corpus: {N_SEQS} x (T, {DIM}), T in [{min(map(len, seqs))}, "
        f"{max(map(len, seqs))}], made in {time.perf_counter() - t0:.2f} s")
    train_idx, test_idx = next(StratifiedKFold(5, shuffle=True, random_state=42).split(seqs, y))
    tr, val = train_test_indices(y[train_idx], n_splits=5, seed=42)
    tr, val = train_idx[tr], train_idx[val]
    pick = lambda idx: [seqs[i] for i in idx]  # noqa: E731
    cfg = loops.TrainConfig(learning_rate=1e-3, epochs=TRAIN_EPOCHS, batch_size=8, seed=42,
                            dropout_rate=0.5, device_fold="off")
    trainer = loops.Trainer(CNNLSTM(DIM, 2, 128, 128, dropout_rate=0.5), device=dev)

    # harness-side timing of each step (synchronised) around the trainer's own
    step_ms, step_frames = [], []
    real_step = trainer.train_step

    def timed_step(state, batch, lengths, *args):
        torch.cuda.synchronize()
        start = time.perf_counter()
        loss = real_step(state, batch, lengths, *args)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - start) * 1e3)
        step_frames.append(int(np.sum(lengths)))
        return loss

    trainer.train_step = timed_step
    torch.cuda.reset_peak_memory_stats(dev)
    with count_launches() as launches:
        t0 = time.perf_counter()
        state, train_hist, val_hist = loops.train_model(
            trainer, pick(tr), y[tr], pick(val), y[val], cfg)
        y_true, y_pred, y_prob = loops.evaluate_model(trainer, state, pick(test_idx),
                                                      y[test_idx], cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    trainer.train_step = real_step

    n_epochs = len(train_hist)
    n_steps = len(step_ms)
    n_eval = n_epochs * -(-len(val) // cfg.batch_size) + -(-len(test_idx) // cfg.batch_size)
    for e, (a, b) in enumerate(zip(train_hist, val_hist)):
        log(f"[training] epoch {e + 1}: train loss {a:.6f} val loss {b:.6f}")
    steady = step_ms[1:] or step_ms
    audio_s = sum(step_frames) / FRAMES_PER_SECOND
    log(f"[training] fold 0: {len(tr)} train / {len(val)} val / {len(test_idx)} test; "
        f"{n_steps} steps in {n_epochs} epochs, {wall:.3f} s for train_model + evaluate_model")
    log(f"[training] train step: first {step_ms[0]:.3f} ms, then median "
        f"{statistics.median(steady):.3f} ms (min {min(steady):.3f}, max {max(steady):.3f}, "
        f"all {[round(v, 3) for v in step_ms]}); {audio_s / (sum(step_ms) / 1e3):.1f} "
        f"audio-s trained per s of step time; peak memory {peak_gib:.3f} GiB")
    check_launches("training", launches, {"cnnlstm-step": n_steps, "cnnlstm-eval": n_eval})

    metrics = classification_metrics(y_true, y_pred, y_prob)
    weights = stability_probe(state.model).cpu().numpy()
    log(f"[training] fold 0 test metrics: {json.dumps(metrics)}; stability vector "
        f"{weights.shape}, mean {weights.mean():.6f}")
    if not (np.isfinite(train_hist + val_hist).all() and np.isfinite(y_prob).all()
            and y_prob.shape == (len(test_idx),) and weights.shape == (DIM,)):
        raise AssertionError("training produced non-finite or misshapen results")
    profile_train_step(trainer, state, pick(tr[:cfg.batch_size]), y[tr[:cfg.batch_size]], cfg)
    return launches, statistics.median(steady)


class _CvProbe:
    """Harness-side instrumentation of every Trainer the CV engines build:
    each train step (plain or of lanes) timed (synchronised) with its batch
    shape, eval batches counted, and the size of every host array that goes
    to the device through ``Trainer._tensor`` recorded."""

    def __init__(self):
        self.steps, self.lane_steps, self.uploads = [], [], []  # the wrappers append to these
        self.eval_batches = self.lane_eval_batches = 0
        self._real = {name: getattr(loops.Trainer, name) for name in (
            "train_step", "eval_step", "train_step_lanes", "eval_step_lanes", "_tensor")}

    def __enter__(self):
        probe, real = self, self._real

        def timed(name, steps):
            def step(self, state, batch, *args, **kwargs):
                torch.cuda.synchronize()
                start = time.perf_counter()
                loss = real[name](self, state, batch, *args, **kwargs)
                torch.cuda.synchronize()
                steps.append(((time.perf_counter() - start) * 1e3, tuple(batch.shape)))
                return loss
            return step

        def counted(name, attr):
            def step(self, *args, **kwargs):
                setattr(probe, attr, getattr(probe, attr) + 1)
                return real[name](self, *args, **kwargs)
            return step

        def _tensor(self, a, dtype):
            if not isinstance(a, torch.Tensor):
                probe.uploads.append(np.asarray(a).nbytes)
            return real["_tensor"](self, a, dtype)

        for name, fn in (("train_step", timed("train_step", self.steps)),
                         ("train_step_lanes", timed("train_step_lanes", self.lane_steps)),
                         ("eval_step", counted("eval_step", "eval_batches")),
                         ("eval_step_lanes", counted("eval_step_lanes", "lane_eval_batches")),
                         ("_tensor", _tensor)):
            setattr(loops.Trainer, name, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self._real.items():
            setattr(loops.Trainer, name, fn)

    def reset(self):
        for records in (self.steps, self.lane_steps, self.uploads):
            records.clear()
        self.eval_batches = self.lane_eval_batches = 0


def _check_cv_launches(label: str, launches: dict, probe: _CvProbe) -> None:
    """A CV run's launches: its train steps and lane steps (whatever their
    lanes) are step units, its eval batches and lane eval batches eval units."""
    n_steps = len(probe.steps) + len(probe.lane_steps)
    n_eval = probe.eval_batches + probe.lane_eval_batches
    if not (n_steps > 0 and n_eval > 0):
        raise AssertionError(f"the {label} CV engine ran no train step or no eval batch")
    check_launches(f"cv {label}", launches, {"cnnlstm-step": n_steps, "cnnlstm-eval": n_eval})


def cv_phase(dev: torch.device, streaming_step_ms: float) -> dict:
    """The training half of the main path, whole: the corpus of the training
    phase uploaded once as a ResidentCorpus, then over that one tensor the
    standard engine (``standard_kfold_cv``: 2 folds, 2 epochs, the flagship
    hyperparameters) and the nested engine (``nested_cv``: 2 outer folds, 3
    TPE trials of 2 inner folds and 2 epochs at batch 4 over the default
    search space, 2 final epochs), each held to its step and eval units; no
    upload through ``Trainer._tensor`` larger than a label vector or a batch
    plan; finite results of the right shapes; upload time, the resident
    fold's train step beside the streaming fold's, wall per fold and per
    trial, peak memory; one fold of one-bucket sequences through the
    resident and the streaming path, first-epoch losses within CV_TOL. Then
    the lane-batched trials over the same tensor (``lane_parity``,
    ``nested_lanes``) and profiles of a resident step and a lane step.
    Returns the engines' launches and the lanes'."""
    seqs, y = _synthetic_corpus(0)
    named = {f"p{i:02d}": s for i, s in enumerate(seqs)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    resident = loops.ResidentCorpus(named, device=dev)
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) * 1e3
    corpus = resident.device_corpus()
    X = loops.DeviceCorpus.from_resident(resident).view(np.arange(len(seqs)))
    t_pad = corpus.x.shape[1]
    log(f"[cv] resident corpus {tuple(corpus.x.shape)} {corpus.x.dtype}, "
        f"{corpus.x.numel() * corpus.x.element_size() / 1e9:.3f} GB, padded and uploaded "
        f"once in {upload_ms:.1f} ms")

    with _CvProbe() as probe:
        # --- the standard engine
        with count_launches() as standard:
            t0 = time.perf_counter()
            results, preds, hists, weights = dl_cv.standard_kfold_cv(
                X, y, FLAGSHIP_HP, device=dev, **CV_STANDARD)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        _check_cv_launches("standard", standard, probe)
        # the counts from the splits themselves: 2 epochs, no early stop
        want_steps = want_eval = 0
        folds = StratifiedKFold(CV_STANDARD["n_splits"], shuffle=True, random_state=42)
        for train_idx, test_idx in folds.split(seqs, y):
            tr, val = train_test_indices(y[train_idx], n_splits=5, seed=42)
            bs, epochs = CV_STANDARD["batch_size"], CV_STANDARD["epochs"]
            want_steps += epochs * -(-len(tr) // bs)
            want_eval += epochs * -(-len(val) // bs) + -(-len(test_idx) // bs)
        if (len(probe.steps), probe.eval_batches) != (want_steps, want_eval):
            raise AssertionError(f"standard engine: {len(probe.steps)} steps and "
                                 f"{probe.eval_batches} eval batches, expected {want_steps} "
                                 f"and {want_eval}")
        n_folds = CV_STANDARD["n_splits"]
        step_ms = [ms for ms, _ in probe.steps]
        shapes = sorted({shape for _, shape in probe.steps})
        log(f"[cv] standard engine: {n_folds} folds x {CV_STANDARD['epochs']} epochs in "
            f"{wall:.3f} s ({wall / n_folds:.3f} s a fold); batches {shapes}")
        log(f"[cv] resident train step: first {step_ms[0]:.3f} ms, then median "
            f"{statistics.median(step_ms[1:]):.3f} ms (min {min(step_ms[1:]):.3f}, max "
            f"{max(step_ms[1:]):.3f}, all {[round(v, 3) for v in step_ms]}) at {t_pad} frames "
            f"a row; the streaming fold's median was {streaming_step_ms:.3f} ms at each "
            f"batch's own bucket")
        for r, h in zip(results, hists):
            log(f"[cv] standard fold {r['fold']}: {json.dumps(r)}; train {h['train']} "
                f"val {h['val']}")
        ok = (len(results) == len(preds) == len(hists) == n_folds
              and weights.shape == (n_folds, DIM) and np.isfinite(weights).all()
              and all(np.isfinite(h["train"] + h["val"]).all() for h in hists)
              and all(np.isfinite(p["y_prob"]).all() and p["y_prob"].shape == p["y_true"].shape
                      for p in preds)
              and sum(len(p["y_true"]) for p in preds) == len(seqs))
        if not ok:
            raise AssertionError("the standard engine's results are non-finite or misshapen")
        uploads = list(probe.uploads)

        # --- the nested engine
        probe.reset()
        trial_s = []
        real_score = dl_cv._inner_cv_score

        def timed_score(*args, **kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            score = real_score(*args, **kwargs)
            torch.cuda.synchronize()
            trial_s.append(time.perf_counter() - start)
            return score

        dl_cv._inner_cv_score = timed_score
        try:
            with count_launches() as nested:
                t0 = time.perf_counter()
                results, preds, weights = dl_cv.nested_cv(X, y, device=dev, **CV_NESTED)
        finally:
            dl_cv._inner_cv_score = real_score
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _check_cv_launches("nested", nested, probe)
        total = _added(standard, nested)
        n_outer = CV_NESTED["n_splits_outer"]
        widths = sorted({(r["best_params"]["cnn_out_channels"],
                          r["best_params"]["lstm_hidden_dim"]) for r in results})
        log(f"[cv] nested engine: {n_outer} outer folds x {CV_NESTED['n_trials']} trials x "
            f"{CV_NESTED['n_splits_inner']} inner folds in {wall:.3f} s "
            f"({wall / n_outer:.3f} s an outer fold); a trial "
            f"{[round(v, 3) for v in trial_s]} s; batches "
            f"{sorted({shape for _, shape in probe.steps})}; best widths {widths}")
        for r in results:
            log(f"[cv] nested fold {r['fold']}: {json.dumps(r)}")
        ok = (len(results) == len(preds) == n_outer and len(trial_s) == n_outer * CV_NESTED["n_trials"]
              and weights.shape == (n_outer, DIM) and np.isfinite(weights).all()
              and all(set(r["best_params"]) == set(dl_cv.DEFAULT_SEARCH_SPACE) for r in results)
              and all(np.isfinite(p["y_prob"]).all() for p in preds)
              and sum(len(p["y_true"]) for p in preds) == len(seqs))
        if not ok:
            raise AssertionError("the nested engine's results are non-finite or misshapen")
        uploads += probe.uploads
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30

        # --- lane-batched trials over the same tensor
        probe.reset()
        lane_parity(dev, X, y, probe)
        uploads += probe.uploads
        probe.reset()
        lanes = nested_lanes(dev, X, y, probe, trial_s)
        uploads += probe.uploads

    # nothing larger than a label vector or a batch plan went to the device
    limit = 8 * len(seqs) * max(CV_STANDARD["epochs"], CV_NESTED["epochs"],
                                CV_NESTED["inner_epochs"])
    log(f"[cv] host-to-device uploads during the folds: {len(uploads)} arrays, largest "
        f"{max(uploads)} B (limit {limit} B: int64 labels or plan of {len(seqs)} rows); "
        f"peak memory of both engines {peak_gib:.3f} GiB, corpus included")
    if max(uploads) > limit:
        raise AssertionError("a CV fold uploaded more than its labels and batch plan")
    log(f"[cv] main-path launches: {total}; with lane-batched trials: {lanes}")

    profile_resident_step(dev, corpus, y)
    profile_lane_step(dev, corpus, y)
    resident_vs_streaming(dev)
    return total, lanes


def _inner_split(X, y: np.ndarray):
    """Inner fold 0 of outer fold 0 of the nested engine's splits."""
    tv, _ = next(StratifiedKFold(CV_NESTED["n_splits_outer"], shuffle=True,
                                 random_state=42).split(X, y))
    X_tv, y_tv = X.subset(tv), y[tv]
    tr, va = next(StratifiedKFold(CV_NESTED["n_splits_inner"], shuffle=True,
                                  random_state=42).split(X_tv, y_tv))
    return X_tv.subset(tr), y_tv[tr], X_tv.subset(va), y_tv[va]


def lane_parity(dev: torch.device, X, y: np.ndarray, probe: _CvProbe) -> None:
    """One train_trials_device call of 4 lanes (4 learning and dropout
    rates, 2 epochs at batch 4) against train_model of each of its trials
    (histories to LANE_TOL relative), dropout on, over the resident corpus."""
    split = _inner_split(X, y)
    trainer = dl_cv._TrainerCache(DIM, device=dev).get(LANE_PARITY_HP)
    cfg = loops.TrainConfig(
        learning_rate=LANE_PARITY_LRS[0], epochs=CV_NESTED["inner_epochs"],
        patience=CV_NESTED["inner_epochs"] + 1, batch_size=CV_NESTED["inner_batch_size"], seed=42,
        dropout_rate=LANE_PARITY_RATES[0], use_plateau=False, restore_best=False)
    with count_launches() as launches:
        t0 = time.perf_counter()
        states, hist = loops.train_trials_device(trainer, *split, cfg, LANE_PARITY_LRS,
                                                 LANE_PARITY_RATES)
        torch.cuda.synchronize()
        lane_wall = time.perf_counter() - t0
    _check_cv_launches("lane-parity", launches, probe)
    worst, walls = 0.0, []
    for i, (lr, rate) in enumerate(zip(LANE_PARITY_LRS, LANE_PARITY_RATES)):
        t0 = time.perf_counter()
        _, th, vh = loops.train_model(trainer, *split, dataclasses.replace(
            cfg, learning_rate=lr, dropout_rate=rate))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        lane_th, lane_vh = hist.result()[i]
        if (len(lane_th), len(lane_vh)) != (len(th), len(vh)):
            raise AssertionError(f"lane {i} ran {len(lane_th)} epochs, its trial {len(th)}")
        worst = max(worst, *(abs(a - b) / abs(b) for a, b in zip(lane_th + lane_vh, th + vh)))
        log(f"[cv] lane {i} (lr {lr:g}, dropout {rate}): train {lane_th} val {lane_vh}; "
            f"train_model of the trial: train {th} val {vh}")
    log(f"[cv] lane parity, 4 lanes of {LANE_PARITY_HP} over {len(split[0])} train / "
        f"{len(split[2])} val rows: histories max rel |d| {worst:.3e} (tol {LANE_TOL}); "
        f"train_trials_device {lane_wall:.3f} s, the 4 trials one by one "
        f"{sum(walls):.3f} s ({[round(w, 3) for w in walls]})")
    if not worst <= LANE_TOL:
        raise AssertionError("a lane of train_trials_device disagrees with its trial's train_model")


def nested_lanes(dev: torch.device, X, y: np.ndarray, probe: _CvProbe, trial_s: list) -> dict:
    """The nested engine with trial_batch=8 over the resident corpus: one
    round of 8 lanes an outer fold, held to its step and eval units, the
    lane steps recounted from the splits (one trial's schedule a round); wall
    per round and per trial beside the sequential nested run's trial, the
    median lane step, peak memory. Returns its launches."""
    rounds = []
    real_round = dl_cv._inner_cv_scores_batch

    def timed_round(*args, **kwargs):
        torch.cuda.synchronize()
        start = time.perf_counter()
        scores = real_round(*args, **kwargs)
        torch.cuda.synchronize()
        rounds.append(time.perf_counter() - start)
        return scores

    dl_cv._inner_cv_scores_batch = timed_round
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        with count_launches() as launches:
            t0 = time.perf_counter()
            results, preds, weights = dl_cv.nested_cv(X, y, device=dev, **CV_LANES_NESTED)
    finally:
        dl_cv._inner_cv_scores_batch = real_round
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    _check_cv_launches("nested trial_batch=8", launches, probe)
    # recounted from the splits: a round is one architecture, so each inner
    # fold trains its lanes on ONE trial's schedule; no early stop at 2 epochs
    cfg = CV_LANES_NESTED
    n_rounds = -(-cfg["n_trials"] // cfg["trial_batch"])
    ibs, bs = cfg["inner_batch_size"], cfg["batch_size"]
    want = dict(lane_steps=0, lane_eval=0, steps=0, eval=0)
    outer = StratifiedKFold(cfg["n_splits_outer"], shuffle=True, random_state=42)
    for tv, test in outer.split(X, y):
        inner = StratifiedKFold(cfg["n_splits_inner"], shuffle=True, random_state=42)
        for tr, va in inner.split(tv, y[tv]):
            want["lane_steps"] += n_rounds * cfg["inner_epochs"] * -(-len(tr) // ibs)
            want["lane_eval"] += n_rounds * (cfg["inner_epochs"] + 1) * -(-len(va) // ibs)
        tr, va = train_test_indices(y[tv], n_splits=5, seed=42)
        want["steps"] += cfg["epochs"] * -(-len(tr) // bs)
        want["eval"] += cfg["epochs"] * -(-len(va) // bs) + -(-len(test) // bs)
    got = dict(lane_steps=len(probe.lane_steps), lane_eval=probe.lane_eval_batches,
               steps=len(probe.steps), eval=probe.eval_batches)
    if got != want:
        raise AssertionError(f"nested trial_batch=8: {got}, expected {want}")
    n_outer = cfg["n_splits_outer"]
    lane_ms = [ms for ms, _ in probe.lane_steps]
    seq_trial = statistics.median(trial_s)
    log(f"[cv] nested engine, trial_batch={LANES}: {n_outer} outer folds x 1 round of {LANES} "
        f"trials x {cfg['n_splits_inner']} inner folds in {wall:.3f} s; a round "
        f"{[round(v, 3) for v in rounds]} s, {[round(v / LANES, 3) for v in rounds]} s a trial, "
        f"beside {seq_trial:.3f} s a trial (median) in the sequential nested run; lane batches "
        f"{sorted({shape for _, shape in probe.lane_steps})}, lane step first {lane_ms[0]:.3f} ms "
        f"then median {statistics.median(lane_ms[1:]):.3f} ms (min {min(lane_ms[1:]):.3f}, max "
        f"{max(lane_ms[1:]):.3f}); peak memory {peak_gib:.3f} GiB, corpus included")
    for r in results:
        log(f"[cv] nested trial_batch={LANES} fold {r['fold']}: {json.dumps(r)}")
    ok = (len(results) == len(preds) == n_outer and len(rounds) == n_outer * n_rounds
          and weights.shape == (n_outer, DIM) and np.isfinite(weights).all()
          and all(set(r["best_params"]) == set(dl_cv.DEFAULT_SEARCH_SPACE) for r in results)
          and all(np.isfinite(p["y_prob"]).all() for p in preds)
          and sum(len(p["y_true"]) for p in preds) == len(y))
    if not ok:
        raise AssertionError("the nested engine's lane rounds gave non-finite or misshapen results")
    return launches


def profile_lane_step(dev: torch.device, corpus, y: np.ndarray) -> None:
    """One train step of 8 lanes at the flagship widths on a batch of 4
    gathered from the resident corpus, beside 8 sequential steps of one
    trial on the same batch; then its device time by kernel."""
    trainer = loops.Trainer(CNNLSTM(DIM, 2, 128, 128, dropout_rate=0.5), device=dev)
    single = trainer.init_state(0, 1e-3)
    states = loops.LaneTrainState.replicate(
        trainer.init_state(0, 1e-3), torch.full((LANES,), 1e-3, dtype=torch.float64, device=dev))
    rates = torch.linspace(0.2, 0.5, LANES, dtype=torch.float64, device=dev)
    rows = torch.arange(CV_NESTED["inner_batch_size"], device=dev)
    labels = trainer._tensor(y[: len(rows)], torch.int64)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = (corpus.x[rows], corpus.lengths[rows], labels, gen, True)

    def lane_step():
        trainer.train_step_lanes(states, *batch, rates)

    def one_step():
        trainer.train_step(single, *batch, 0.5)

    medians = {}
    for name, step in (("lanes", lane_step), ("one", one_step)):
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        medians[name] = statistics.median(times[1:])
    log(f"[cv] lane train step, {LANES} lanes of CNNLSTM({DIM}, 128, 128) at "
        f"{(len(rows), *corpus.x.shape[1:])}: median {medians['lanes']:.3f} ms, "
        f"{medians['lanes'] / LANES:.3f} ms a trial, beside one trial's step {medians['one']:.3f} "
        f"ms ({LANES} of them {LANES * medians['one']:.3f} ms)")
    profile_device(f"one lane train step ({LANES} lanes) at {(len(rows), *corpus.x.shape[1:])}",
                   lane_step, 16)


def profile_resident_step(dev: torch.device, corpus, y: np.ndarray) -> None:
    """Device time by kernel over one flagship train step whose batch is
    gathered from the resident corpus, after one warm-up step."""
    trainer = loops.Trainer(CNNLSTM(DIM, 2, 128, 128, dropout_rate=0.5), device=dev)
    state = trainer.init_state(0, 1e-3)
    rows = torch.arange(CV_STANDARD["batch_size"], device=dev)
    labels = trainer._tensor(y[: len(rows)], torch.int64)
    gen = torch.Generator(device=dev).manual_seed(0)

    def step():
        trainer.train_step(state, corpus.x[rows], corpus.lengths[rows], labels, gen, True, 0.5)

    step()
    torch.cuda.synchronize()
    profile_device(f"one resident train step at {(len(rows), *corpus.x.shape[1:])}", step, 16)


def resident_vs_streaming(dev: torch.device) -> None:
    """One fold whose sequences share one bucket, through the resident and
    the streaming path from the same seed: the gathered batches are the
    padded batches, so the first epoch's losses agree."""
    rng = np.random.default_rng(5)
    lengths = rng.integers(CV_BUCKET // 2 + 1, CV_BUCKET + 1, size=12)
    seqs = [rng.standard_normal((n, DIM), dtype=np.float32) for n in lengths]
    labels = np.arange(12) % 2
    corpus = loops.DeviceCorpus(seqs, align=CV_BUCKET, device=dev)
    views = (corpus.view(np.arange(8)), labels[:8], corpus.view(np.arange(8, 12)), labels[8:])
    lists = (seqs[:8], labels[:8], seqs[8:], labels[8:])
    hist = {}
    for fold, args in (("on", views), ("off", lists)):
        trainer = loops.Trainer(CNNLSTM(DIM, 2, 128, 128, dropout_rate=0.5), device=dev)
        cfg = loops.TrainConfig(learning_rate=1e-3, epochs=1, batch_size=4, seed=7,
                                dropout_rate=0.5, device_fold=fold)
        _, train_hist, val_hist = loops.train_model(trainer, *args, cfg)
        hist[fold] = (train_hist[0], val_hist[0])
    err = max(abs(a - b) for a, b in zip(hist["on"], hist["off"]))
    log(f"[cv] one-bucket fold ({CV_BUCKET} frames, dropout 0.5): first-epoch train/val loss "
        f"resident {hist['on']} vs streaming {hist['off']}: max|d|={err:.3e} (tol {CV_TOL})")
    if not err <= CV_TOL:
        raise AssertionError("the resident fold disagrees with the streaming fold")


def profile_train_step(trainer, state, seqs, labels, cfg) -> None:
    """Device time by kernel over one train step, after one warm-up step."""
    from robust_speech_analysis_framework_tpu_torch.data.batching import pad_batch

    batch, lengths = pad_batch(seqs, min_bucket=cfg.min_bucket)
    gen = torch.Generator(device=trainer.device).manual_seed(0)

    def step():
        trainer.train_step(state, batch, lengths, labels, gen, True, cfg.dropout_rate)

    step()
    torch.cuda.synchronize()
    profile_device(f"one train step at {tuple(batch.shape)}", step, 16)


ZERO_GRAD = ("res_block1.conv1.bias", "res_block1.conv2.bias", "res_block1.shortcut.0.bias",
             "res_block2.conv1.bias", "res_block2.conv2.bias",
             "attention_pooling.attention_weights.bias")


def parity_phase(dev: torch.device) -> None:
    """One train step of the flagship model (B=2, T=512, dropout off) on the
    card and through the plain path on the CPU from the same weights: loss,
    gradients, updated parameters and BatchNorm statistics."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 512, DIM), dtype=np.float32)
    lengths = np.array([512, 377], np.int32)
    x[1, 377:] = 0.0
    labels = np.array([0, 1])
    template = CNNLSTM(DIM, 2, 128, 128, dropout_rate=0.0)
    template.res_block1.dropout = template.res_block2.dropout = 0.0
    weights = loops.Trainer(template, device="cpu").init_state(7, 1e-3).model.state_dict()

    def one_step(where):
        trainer = loops.Trainer(template, adam_eps=PARITY_ADAM_EPS, device=where)
        state = trainer.init_state(7, 1e-3, weights)
        loss = float(trainer.train_step(state, x, lengths, labels, None))
        grads = {n: p.grad.cpu() for n, p in state.model.named_parameters() if p.grad is not None}
        return loss, grads, {k: v.cpu() for k, v in state.model.state_dict().items()}

    (l_card, g_card, s_card), (l_cpu, g_cpu, s_cpu) = one_step(dev), one_step("cpu")
    loss_err = abs(l_card - l_cpu)
    grad_err = max(float((g_card[k] - g_cpu[k]).abs().max() / g_cpu[k].abs().max().clamp_min(1e-12))
                   for k in g_cpu if k not in ZERO_GRAD)
    zero_grad = max(float(g_card[k].abs().max()) for k in ZERO_GRAD)
    param_err = max(float((s_card[k] - s_cpu[k]).abs().max()) for k in s_cpu
                    if "running" not in k and k not in ZERO_GRAD and "num_batches" not in k)
    zero_step = max(float((s_card[k] - weights[k]).abs().max()) for k in ZERO_GRAD)
    stats_err = max(float((s_card[k] - s_cpu[k]).abs().max()) for k in s_cpu if "running" in k)
    log(f"[parity] one flagship train step B=2 T=512 (Adam eps {PARITY_ADAM_EPS}), card vs "
        f"CPU: loss {l_card:.7f} vs "
        f"{l_cpu:.7f} (|d|={loss_err:.3e}, tol {PARITY_LOSS_TOL}); gradients max rel "
        f"{grad_err:.3e} (tol {PARITY_GRAD_TOL}); params after Adam max|d|={param_err:.3e} "
        f"(tol {PARITY_PARAM_TOL}); BN running stats max|d|={stats_err:.3e} "
        f"(tol {PARITY_LOSS_TOL}); the six zero-gradient biases: max|grad| {zero_grad:.3e}, "
        f"step <= lr: {zero_step:.3e}")
    if not (loss_err <= PARITY_LOSS_TOL and grad_err <= PARITY_GRAD_TOL
            and param_err <= PARITY_PARAM_TOL and stats_err <= PARITY_LOSS_TOL
            and zero_step <= 1e-3 * (1 + 1e-5)):
        raise AssertionError("the train step on the card disagrees with the CPU")


def viterbi_bound_ms(b: int, t: int, c: int, path: bool) -> tuple:
    """Least time for K6 (forward costs) or K7 (the path): lf, v, local in
    and c (K6) or the int64 path (K7) out once; per step and file C² pairs
    of sub, abs, mul, add, min and C adds, twice for K7 (both directions),
    which also takes C subs, adds and compares per frame."""
    steps = b * (t - 1) * (5 * c * c + c)
    if path:
        return bound_ms(4 * 3 * b * t * c + 8 * b * t, 2 * steps + 3 * b * t * c)
    return bound_ms(4 * 4 * b * t * c, steps)


def _viterbi_inputs(dev, gen, b, t, c):
    """Candidate stacks like the pitch chains': 30 % unvoiced slots, log2 of
    60–500 Hz, local costs in [-1, 3)."""
    voiced = torch.rand(b, t, c, device=dev, generator=gen) >= 0.3
    freqs = 60 + 440 * torch.rand(b, t, c, device=dev, generator=gen)
    lf = torch.log2(torch.where(voiced, freqs, 1.0))
    local = 4 * torch.rand(b, t, c, device=dev, generator=gen) - 1
    return lf, voiced.float(), local


def viterbi_kernel_phase(dev: torch.device) -> dict:
    """K6 (``viterbi_forward_costs``) and K7 (``viterbi_path``) against their
    plain versions on the card, bit for bit (max |Δc| = 0, identical paths),
    at ragged shapes (B=3, T=37, C=7, both weight schemes; C=32; C=1), the
    openSMILE shape (B=4, T=6485, C=7: a 60 s file's bucket) and the Praat
    shape (B=8, T=5997, C=15), with times (and microseconds a step) beside
    the plain version's and the card's bound."""
    gen = torch.Generator(device=dev).manual_seed(4)
    records = {"viterbi_forward_costs": {"max_abs_err": 0.0},
               "viterbi_path": {"max_abs_err": 0.0}}
    for label, (b, t, c, w) in VITERBI_SHAPES.items():
        lf, v, local = _viterbi_inputs(dev, gen, b, t, c)
        costs = viterbi_ops.viterbi_forward_costs(lf, v, local, *w)
        path = viterbi_ops.viterbi_path(lf, v, local, *w)
        torch.cuda.synchronize()
        ref_costs = viterbi_ops.viterbi_forward_costs_reference(lf, v, local, *w)
        ref_path = viterbi_ops.viterbi_path_reference(lf, v, local, *w)
        err = float((costs - ref_costs).abs().max())
        same = float((path == ref_path).float().mean())
        log(f"[viterbi-kernels] {label} B={b} T={t} C={c} w={w}: K6 max|dc|={err:.3e}, "
            f"K7 paths identical on {same:.6%} of frames (required: 0 and 100 %)")
        if err != 0.0 or not torch.equal(path, ref_path):
            raise AssertionError(f"a Viterbi kernel differs from its plain version at {label}")
        if label.startswith("ragged"):
            continue
        args = (lf, v, local, *w)
        for name, kernel, plain, is_path in (
            ("viterbi_forward_costs", viterbi_ops.viterbi_forward_costs,
             viterbi_ops.viterbi_forward_costs_reference, False),
            ("viterbi_path", viterbi_ops.viterbi_path, viterbi_ops.viterbi_path_reference, True),
        ):
            ms = cuda_ms(lambda: kernel(*args), 5)
            plain_ms = cuda_ms(lambda: plain(*args), 1)
            bound, bound_by = viterbi_bound_ms(b, t, c, is_path)
            timing = {"shape": f"B={b} T={t} C={c}", "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound, "bound_by": bound_by, "library_ms": None}
            log(f"[viterbi-kernels] {name} {label}: kernel {ms:.4f} ms "
                f"({ms / t * 1e3:.4f} us a step), plain {plain_ms:.4f} ms, "
                f"bound {bound:.6f} ms ({bound_by}); no single PyTorch call computes a "
                f"min-plus Viterbi")
            if label == "opensmile":
                records[name].update(timing)
            else:
                records[name]["praat"] = timing
    return records


def _speech(seconds: float, f0: float, seed: int, sr: int = SR) -> np.ndarray:
    """Speech-like audio at ``sr`` (16 kHz by default): 11 harmonics with 3 Hz
    vibrato, syllable gating, a little noise, quantised to 16-bit PCM (the
    recipe of benchmarks/suite.py:31-43, with the vibrato's phase integrated)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    # 3 Hz vibrato of ±1 % as a true frequency modulation: the benchmark's
    # phase f0·(1 + 0.01·sin)·t sweeps ±0.19·f0·t Hz, so its files stop
    # being voiced after a few seconds
    phase = f0 * (t + 0.01 * (1 - np.cos(2 * np.pi * 3 * t)) / (2 * np.pi * 3))
    v = sum(np.sin(2 * np.pi * k * phase) / k for k in range(1, 12))
    gate = np.where((t % 0.6) < 0.42, 1.0, 0.02)
    x = 0.3 * gate * v / np.abs(v).max() + 0.002 * rng.normal(size=len(t))
    return (np.clip(np.round(x * 32768.0), -32768, 32767) / 32768.0).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _opensmile_corpus() -> dict:
    """The openSMILE phase's seeded corpus: OS_FILES speech-like 16-bit PCM
    files of OS_MIN_S–OS_MAX_S seconds, made once."""
    lengths = np.linspace(OS_MIN_S, OS_MAX_S, OS_FILES)
    return {f"s{i:02d}.wav": _speech(s, 110 + 9 * i, i) for i, s in enumerate(lengths)}


def march_bound_ms(stack: np.ndarray, f0: np.ndarray, nf, counts: np.ndarray,
                   starts: np.ndarray, p_max: int, hop: int, srr: float = 0.25,
                   f0_min: float = 40.0) -> tuple:
    """Least time for the march on these inputs: the stack, F0 and counts
    read once and the four (B, P) buffers written once; per period found
    (this run's data, from its starts) the float64 work its substep needs:
    one FMA per template sample and lag for the correlations, and the
    energies as sums of squares: the template's e_a (w0 FMAs), the first
    lag window's e(lo) (w0) and each further lag's e(L) slid from it (two
    FMAs: the sample in, the sample out), the window's e_tot (GW)."""
    b, n = stack.shape
    _, _, gw = march_ops.march_geometry(SR, srr, f0_min)
    flops = 0.0
    for i in range(b):
        st = starts[i, : counts[i]]
        fv = np.maximum(f0[i, np.minimum(st // hop, nf[i] - 1)], np.float32(f0_min))
        t0 = np.float32(SR) / fv
        lo = np.maximum((t0 * np.float32(1 - srr)).astype(np.int64), 8)
        hi = (t0 * np.float32(1 + srr)).astype(np.int64) + 1
        w0 = np.round(t0).astype(np.int64)
        lags = np.maximum(hi - lo + 1, 1)
        flops += float((2 * w0 * lags + 2 * w0 + 2 * w0 + 4 * (lags - 1) + 2 * gw).sum())
    bytes_moved = 4 * (stack.size + f0.size + 2 * b + 4 * b * p_max + b)
    t_bytes = bytes_moved / PEAK_HBM_BYTES * 1e3
    t_ops = flops / PEAK_FP64_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def conv0_bound_ms(b: int, n: int, c: int) -> tuple:
    """Least time for Wav2Vec2's first block: the (B, L) input read and the
    (B, C, T) output written once; 10 FMAs an output."""
    t = (n - 10) // 5 + 1
    return bound_ms(4.0 * (b * n + b * c * t), 20.0 * b * c * t)


def conv0_kernel_phase(dev: torch.device) -> dict:
    """Wav2Vec2's first block (``conv0_norm_gelu``: conv_0, masked channel
    norm, affine, GELU) at an extraction batch (16 x 80,000 samples, ragged)
    against its plain version on the card (KERNEL_TOL of max |ref|), one
    count a call, with its time, the plain version's, cuDNN's conv_0 and
    the norm chain alone, its bound and a profile of one call (the
    statistics and main launches)."""
    from robust_speech_analysis_framework_tpu_torch.device import conv1d

    rng = np.random.default_rng(22)
    b, n, c = len(CONV0_SAMPLES), max(CONV0_SAMPLES), CONV0_CHANNELS
    samples = np.array(CONV0_SAMPLES)
    wav = 0.1 * rng.normal(size=(b, n))
    for i, m in enumerate(samples):
        wav[i, m:] = 0.0
    wav[-1] = 0.0  # a batch's padded tail row
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    wav, weight = f32(wav), f32(rng.normal(size=(c, 1, 10)) / np.sqrt(10))
    scale, bias = f32(1 + 0.2 * rng.normal(size=c)), f32(0.1 * rng.normal(size=c))
    frames = torch.from_numpy(((samples - 10) // 5 + 1).astype(np.int32)).to(dev)
    args = (wav, weight, scale, bias, frames, 1e-5)
    with torch.inference_mode():
        ref = w2v_ops.conv0_norm_gelu_reference(*args)
        with count_launches() as launched:
            got = w2v_ops.conv0_norm_gelu(*args)
        torch.cuda.synchronize()
        counted = launched["conv0_norm_gelu"]
        abs_err = float((got - ref).abs().max())
        err = abs_err / float(ref.abs().max())
        same = torch.equal(w2v_ops.conv0_norm_gelu(*args), got)
        log(f"[conv0] B={b} L={n} C={c} T={got.shape[2]}: kernel vs plain version max|d| / "
            f"max|ref| = {err:.3e} (tol {KERNEL_TOL}); {counted} count a call; two calls "
            f"bit-equal: {same}")
        if not (err <= KERNEL_TOL and counted == 1 and same):
            raise AssertionError("conv0_norm_gelu disagrees with its plain version")
        del ref, got
        ms = cuda_ms(lambda: w2v_ops.conv0_norm_gelu(*args), 50)
        plain_ms = cuda_ms(lambda: w2v_ops.conv0_norm_gelu_reference(*args), 10)

        conv = lambda: conv1d(wav[:, None, :], weight, None, torch.float32, stride=5)  # noqa: E731
        h = conv()
        conv_ms = cuda_ms(conv, 10)
        chain_ms = cuda_ms(lambda: w2v_ops.channel_norm_gelu(h, frames, scale, bias, 1e-5), 10)
        del h
        bound, by = conv0_bound_ms(b, n, c)
        log(f"[conv0] kernel {ms:.4f} ms ({bound / ms:.1%} of its bound {bound:.4f} ms by {by}); "
            f"plain version {plain_ms:.3f} ms = cuDNN's conv_0 {conv_ms:.3f} ms + the norm "
            f"chain {chain_ms:.3f} ms")
        profile_device("one conv0_norm_gelu call", lambda: w2v_ops.conv0_norm_gelu(*args), 4)
    torch.cuda.empty_cache()
    return {"conv0_norm_gelu": {
        "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": conv_ms + chain_ms, "conv_ms": conv_ms, "chain_ms": chain_ms,
        "shape": f"B={b} L={n} C={c}"}}


def posconv_bound_ms(b: int, t: int, c: int, groups: int, k: int) -> tuple:
    """Least time for the positional conv: every tap of every frame, 2 K C/G
    operations an output, at the fp32 FMA rate; x read, the output written
    and the weights read once."""
    cg = c // groups
    return bound_ms(4.0 * (2 * b * t * c + c * cg * k + c), 2.0 * b * t * c * cg * k)


def _posconv_inputs(dev, rng, shape, frames=None) -> tuple:
    b, t, c, groups, k = shape
    x = rng.normal(size=(b, t, c))
    for i, n in enumerate(frames or ()):
        x[i, n:] = 0.0
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    cg = c // groups
    return (f32(x), f32(rng.normal(size=(c, cg, k)) / np.sqrt(cg * k)),
            f32(0.1 * rng.normal(size=c)), groups)


def _posconv_tiles(args) -> dict:
    """The kernel's ms at every frame tile that fits a block (bit-equal to
    the planned tile's output: the sums' order does not depend on it)."""
    x, weight, bias, groups = args
    b, t, c = x.shape
    wt = w2v_ops._pos_conv_weights(weight, groups)
    want = w2v_ops.pos_conv_gelu(*args)
    times = {}
    for tile in w2v_ops.POS_TILES:
        if w2v_ops.pos_conv_smem_bytes(c // groups, wt.shape[1], tile) > w2v_ops.SMEM_BLOCK:
            continue
        out = torch.empty_like(want)
        launch = lambda: w2v_ops._launch_pos_conv(x, wt, bias, out, weight.shape[2] // 2,  # noqa: E731
                                                  tile)
        times[tile] = round(cuda_ms(launch, 10), 4)
        if not torch.equal(out, want):
            raise AssertionError(f"the positional conv's kernel at tile {tile} differs from "
                                 f"the planned tile's output")
    return times


def posconv_kernel_phase(dev: torch.device) -> dict:
    """Wav2Vec2's positional conv (``pos_conv_gelu``) at an extraction batch
    of each encoder and at one serving chunk against its plain version on
    the card: one count a call, two calls bit-equal, its time at the planned
    tile and at every tile, its bound, the plain version's time and cuDNN's
    conv alone (``library_ms``), and a profile of one call."""
    from robust_speech_analysis_framework_tpu_torch.device import conv1d

    rng = np.random.default_rng(24)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    records = {}
    cases = [(label, shape, frames) for label, (shape, frames) in POSCONV_SHAPES.items()]
    cases.append(("serving", POSCONV_SERVING, None))
    for label, shape, frames in cases:
        b, t, c, groups, k = shape
        args = _posconv_inputs(dev, rng, shape, frames)
        x, weight, bias, _ = args
        with torch.inference_mode():
            ref = w2v_ops.pos_conv_gelu_reference(*args)
            with count_launches() as launched:
                got = w2v_ops.pos_conv_gelu(*args)
            torch.cuda.synchronize()
            counted = launched["pos_conv_gelu"]
            abs_err = float((got - ref).abs().max())
            err = abs_err / float(ref.abs().max())
            same = torch.equal(w2v_ops.pos_conv_gelu(*args), got)
            kp = -(-k // w2v_ops.POS_TAPS) * w2v_ops.POS_TAPS
            tile = w2v_ops.pos_conv_tile(b, t, groups, c // groups, kp, n_sms)
            log(f"[posconv] {label} B={b} T={t} C={c} G={groups} K={k} (tile {tile}): kernel vs "
                f"plain version max|d| / max|ref| = {err:.3e} (tol {KERNEL_TOL}); {counted} count "
                f"a call; two calls bit-equal: {same}")
            if not (err <= KERNEL_TOL and counted == 1 and same):
                raise AssertionError("pos_conv_gelu disagrees with its plain version")
            del ref, got
            ms = cuda_ms(lambda: w2v_ops.pos_conv_gelu(*args), 20)
            plain_ms = cuda_ms(lambda: w2v_ops.pos_conv_gelu_reference(*args), 5)
            library_ms = cuda_ms(lambda: conv1d(x.transpose(1, 2), weight, bias, torch.float32,
                                                padding=(k // 2,), groups=groups), 5)
            tiles = _posconv_tiles(args)
            bound, by = posconv_bound_ms(*shape)
            tflops = 2.0 * b * t * c * (c // groups) * k / (ms * 1e-3) / 1e12
            log(f"[posconv] {label}: kernel {ms:.4f} ms, {tflops:.2f} TFLOP/s ({bound / ms:.1%} of "
                f"its bound {bound:.4f} ms by {by}); plain version {plain_ms:.3f} ms; cuDNN's "
                f"conv alone {library_ms:.3f} ms; by tile {tiles}")
            if label != "serving":
                profile_device(f"one pos_conv_gelu call ({label})",
                               lambda: w2v_ops.pos_conv_gelu(*args), 4)
                profile_device(f"its plain version ({label})",
                               lambda: w2v_ops.pos_conv_gelu_reference(*args), 6)
        records[label] = {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound, "bound_by": by, "library_ms": library_ms,
                          "tflops": tflops, "tile": tile, "tiles": tiles,
                          "shape": f"B={b} T={t} C={c} G={groups} K={k}"}
        del args, x, weight, bias
    torch.cuda.empty_cache()
    rec = dict(records["wav2vec2-base"])
    rec["max_abs_err"] = max(r["max_abs_err"] for r in records.values())
    rec["wavlm"], rec["serving"] = records["wavlm-large"], records["serving"]
    return {"pos_conv_gelu": rec}


def encoder_batches(dev: torch.device, tag: str, swaps: tuple) -> dict:
    """One encoder batch of each model (Wav2Vec2-base at 16 × 5 s, WavLM-Large
    at 16 × 16 s, float32, random weights) with the kernels and with the plain
    versions of ``swaps`` ((module, name, plain version) each) in their place,
    turn about: device ms each, the batch's launches (one encoder-batch unit),
    and a profile of the batch with the kernels."""
    from robust_speech_analysis_framework_tpu_torch.models import wav2vec2 as w2v_model
    from robust_speech_analysis_framework_tpu_torch.models.init import init_weights_
    from robust_speech_analysis_framework_tpu_torch.models.wavlm import WavLMConfig, WavLMModel

    rng = np.random.default_rng(25)
    out = {}
    for label, unit, make, n in (
            ("wav2vec2-base", "w2v2-batch", lambda: w2v_model.Wav2Vec2Model(Wav2Vec2Config()),
             80_000),
            ("wavlm-large", "wavlm-batch", lambda: WavLMModel(WavLMConfig()), 256_000)):
        model = make()
        init_weights_(model, torch.Generator().manual_seed(0))
        model = model.to(dev).eval()
        samples = np.array([n] * 13 + [n * 3 // 4, n // 3, n // 10])
        wav = (0.1 * rng.normal(size=(len(samples), n))).astype(np.float32)
        for i, m in enumerate(samples):
            wav[i, m:] = 0.0
        wav, lengths = torch.from_numpy(wav).to(dev), torch.from_numpy(samples).to(dev)

        def encode():
            with torch.inference_mode():
                return model(wav, lengths)

        with count_launches() as launches:
            encode()
        torch.cuda.synchronize()
        check_launches(f"{tag} {label}", launches, {unit: 1}, model.config)
        times = {"kernel": [], "plain": []}
        kernels = [(module, name, getattr(module, name)) for module, name, _ in swaps]
        for turn in ("plain", "kernel", "kernel", "plain"):
            if turn == "plain":
                for module, name, plain in swaps:
                    setattr(module, name, plain)
            try:
                times[turn].append(cuda_ms(encode, 3))
            finally:
                for module, name, kernel in kernels:
                    setattr(module, name, kernel)
        kernel_ms, plain_ms = statistics.mean(times["kernel"]), statistics.mean(times["plain"])
        log(f"[{tag}] {label} encoder batch {len(samples)} x {n}: {kernel_ms:.3f} ms with the "
            f"kernels ({times['kernel']}), {plain_ms:.3f} ms with {[n for _, n, _ in swaps]}'s "
            f"plain versions ({times['plain']})")
        profile_device(f"one {label} encoder batch", encode, 12)
        out[label] = {"kernel_ms": kernel_ms, "plain_ms": plain_ms}
        del model, wav
        torch.cuda.empty_cache()
    return out


def featconv_bound_ms(b: int, t: int, c_in: int, c_out: int, k: int, stride: int) -> tuple:
    """Least time for a strided conv: 2 K C_in operations an output at the
    fp32 FMA rate; x read, the output written and the weights read once."""
    t_out = (t - k) // stride + 1
    return bound_ms(4.0 * (b * t * c_in + b * t_out * c_out + c_out * c_in * k),
                    2.0 * b * t_out * c_out * c_in * k)


def _featconv_plans(x, weight, stride: int, gelu: bool, ref, n_sms: int, timer) -> dict:
    """The kernel's ms (by ``timer``) at every plan the wrapper weighs
    (``feature_conv_plans``), each output within KERNEL_TOL of the plain
    version's."""
    b, t, c_in = x.shape
    c_out, _, k = weight.shape
    wt = w2v_ops._feature_conv_weights(weight)
    scale = float(ref.abs().max())
    times = {}
    for plan in w2v_ops.feature_conv_plans(ref.shape[0] * ref.shape[1], c_out, k * c_in, n_sms):
        out = torch.empty_like(ref, memory_format=torch.contiguous_format)
        launch = lambda: w2v_ops._launch_feature_conv(x, wt, None, out, stride,  # noqa: E731
                                                      plan, gelu)
        times["{}x{}/{}".format(*plan)] = round(timer(launch, 3), 4)
        err = float((out - ref).abs().max()) / scale
        if err > KERNEL_TOL:
            raise AssertionError(f"the feature conv's kernel at plan {plan} is {err:.3e} of "
                                 f"max |ref| from its plain version")
    return times


def featconv_kernel_phase(dev: torch.device) -> dict:
    """The strided convs conv_1 ... conv_6 (``feature_conv``) of each encoder's
    extraction batch and of one serving chunk against their plain version on
    the card (KERNEL_TOL of max |ref|), one count a call, two calls
    bit-equal; each conv's time, its plan, the plain version's (cuDNN on the
    (B, C, T) view, GELU), cuDNN's on a contiguous (B, C, T) as the encoders
    ran it before the kernel (+ GELU: ``library_ms``), an unfold +
    ``torch.matmul`` (+ GELU) that the port never calls (``matmul_ms``), its
    bound, and every plan's time; the six's sums; a profile of conv_1. At
    one chunk a call's device time is under its host time, so there the
    times are device times (``graph_ms``), and the kernel's and cuDNN's
    calls are also timed back to back with their host cost (``calls_ms``,
    ``library_calls_ms``)."""
    from robust_speech_analysis_framework_tpu_torch.device import conv1d

    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(26)
    records = {}
    for label, (b, t, c, gelu) in FEATCONV_CASES.items():
        reps, timer = (50, graph_ms) if b == 1 else (5, cuda_ms)
        convs = []
        for i, (k, s) in enumerate(FEATCONV_TAPS, start=1):
            x = torch.randn((b, t, c), device=dev, generator=gen)
            weight = torch.randn((c, c, k), device=dev, generator=gen) / float(np.sqrt(c * k))
            t_out = (t - k) // s + 1
            act = F.gelu if gelu else (lambda h: h)
            with torch.inference_mode():
                ref = w2v_ops.feature_conv_reference(x, weight, None, s, gelu)
                with count_launches() as launched:
                    got = w2v_ops.feature_conv(x, weight, None, s, gelu)
                torch.cuda.synchronize()
                counted = launched["feature_conv"]
                abs_err = float((got - ref).abs().max())
                err = abs_err / float(ref.abs().max())
                same = torch.equal(w2v_ops.feature_conv(x, weight, None, s, gelu), got)
                plan = w2v_ops.feature_conv_plan(b * t_out, c, k * c, n_sms)
                log(f"[featconv] {label} conv_{i} B={b} T={t}->{t_out} C={c} K={k} (plan "
                    f"{plan}): kernel vs plain version max|d| / max|ref| = {err:.3e} (tol "
                    f"{KERNEL_TOL}); {counted} count a call; two calls bit-equal: {same}")
                if not (err <= KERNEL_TOL and counted == 1 and same):
                    raise AssertionError("feature_conv disagrees with its plain version")
                del got
                kernel = lambda: w2v_ops.feature_conv(x, weight, None, s, gelu)  # noqa: E731
                ms = timer(kernel, reps)
                plain_ms = timer(lambda: w2v_ops.feature_conv_reference(x, weight, None, s,
                                                                        gelu), reps)
                xc = x.transpose(1, 2).contiguous()
                library = lambda: act(conv1d(xc, weight, None, torch.float32,  # noqa: E731
                                             stride=s))
                library_ms = timer(library, reps)
                calls = {"calls_ms": cuda_ms(kernel, reps),
                         "library_calls_ms": cuda_ms(library, reps)} if b == 1 else {}
                del xc
                wmat = weight.reshape(c, c * k).t()
                matmul_ms = timer(lambda: act(torch.matmul(
                    x.unfold(1, k, s).reshape(b * t_out, c * k), wmat)), reps)
                plans = _featconv_plans(x, weight, s, gelu, ref, n_sms, timer)
                if label != "serving" and i == 1:
                    profile_device(f"one feature_conv call ({label} conv_1)",
                                   lambda: w2v_ops.feature_conv(x, weight, None, s, gelu), 4)
            bound, by = featconv_bound_ms(b, t, c, c, k, s)
            tflops = 2.0 * b * t_out * c * c * k / (ms * 1e-3) / 1e12
            fastest = min(plans, key=plans.get)
            log(f"[featconv] {label} conv_{i}: kernel {ms:.4f} ms, {tflops:.2f} TFLOP/s "
                f"({bound / ms:.1%} of its bound {bound:.4f} ms by {by}); plain version "
                f"{plain_ms:.4f} ms; cuDNN (B, C, T) {library_ms:.4f} ms; unfold + matmul "
                f"{matmul_ms:.4f} ms; {calls or ''} fastest plan {fastest} {plans[fastest]} ms; "
                f"plans {plans}")
            convs.append({"conv": i, "t_in": t, "t_out": t_out, "k": k, "plan": list(plan),
                          "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
                          "library_ms": library_ms, "matmul_ms": matmul_ms, "bound_ms": bound,
                          "tflops": tflops, "plans": plans, **calls})
            del x, weight, ref
            torch.cuda.empty_cache()
            t = t_out
        total = {key: sum(r[key] for r in convs)
                 for key in ("ms", "plain_ms", "library_ms", "matmul_ms", "bound_ms")}
        share = total["bound_ms"] / total["ms"]
        log(f"[featconv] {label} conv_1-6: kernel {total['ms']:.3f} ms ({share:.1%} of the "
            f"bound {total['bound_ms']:.3f} ms); plain version "
            f"{total['plain_ms']:.3f}; cuDNN (B, C, T) {total['library_ms']:.3f}; unfold + "
            f"matmul {total['matmul_ms']:.3f}; each conv no slower than cuDNN's: "
            f"{all(r['ms'] <= r['library_ms'] for r in convs)}")
        records[label] = dict(total, max_abs_err=max(r["max_abs_err"] for r in convs),
                              bound_by="operations", convs=convs,
                              shape=f"B={b} T={convs[0]['t_in']}->{t} C={c} K=3,3,3,3,2,2 s=2",
                              tflops=sum(2.0 * b * r["t_out"] * c * c * r["k"] for r in convs)
                              / (total["ms"] * 1e-3) / 1e12)
    rec = dict(records["wav2vec2-base"])
    rec["max_abs_err"] = max(r["max_abs_err"] for r in records.values())
    rec["wavlm"], rec["serving"] = records["wavlm-large"], records["serving"]
    return {"feature_conv": rec}


WAVLM_SHAPE = (16, 16, 799)  # B, heads, T: an extraction batch of 16 s chunks
WAVLM_FRAMES = (799,) * 12 + (649, 400, 150, 24)  # valid keys a row: full and last chunks


def relpos_bound_ms(frames, heads: int) -> float:
    """Least time for one call of WavLM's relative-position softmax over
    rows of ``frames`` real frames: the benchmark's bound
    (``port_bench.wavlm_counts``) for one layer, by bytes."""
    return wavlm_counts.relpos_softmax_bound_ms({"num_heads": heads, "num_layers": 1}, frames)


def wavlm_kernel_phase(dev: torch.device) -> dict:
    """WavLM's relative-position softmax at an extraction batch's shape
    against its plain version, with times and bound, then one WavLM-Large
    encoder batch of 16 × 16 s: device ms, memory peak, its launches (one
    encoder-batch unit), and a profile by kernel."""
    from robust_speech_analysis_framework_tpu_torch.models.init import init_weights_
    from robust_speech_analysis_framework_tpu_torch.models.wavlm import (
        WavLMConfig, WavLMModel, relative_position_buckets)

    b, h, t = WAVLM_SHAPE
    gen = torch.Generator(device=dev).manual_seed(23)
    scores = 4.0 * torch.randn(b, h, t, t, generator=gen, device=dev)
    gates = 1.0 + torch.rand(b, h, t, generator=gen, device=dev)
    table = torch.randn(320, h, generator=gen, device=dev)
    buckets = relative_position_buckets(torch.arange(-(t - 1), t), 320, 800).to(
        torch.int32).to(dev)
    lengths = torch.tensor(WAVLM_FRAMES, dtype=torch.int32, device=dev)
    args = (gates, table, buckets, lengths)
    with torch.inference_mode():
        ref = wavlm_ops.relpos_softmax_reference(scores, *args)
        work = scores.clone()
        with count_launches() as launched:
            got = wavlm_ops.relpos_softmax(work, *args)
        torch.cuda.synchronize()
        counted = launched["relpos_softmax"]
        abs_err = float((got - ref).abs().max())
        again = wavlm_ops.relpos_softmax(scores.clone(), *args)
        same = torch.equal(again, got)
        log(f"[wavlm] B={b} H={h} T={t}: kernel vs plain version max|d| = {abs_err:.3e} "
            f"(tol {KERNEL_TOL}); {counted} count a call; two calls bit-equal: {same}")
        if not (abs_err <= KERNEL_TOL and counted == 1 and same):
            raise AssertionError("relpos_softmax disagrees with its plain version")
        del ref, again
        # in place: each timed call overwrites the same buffer, as the encoder's does
        ms = cuda_ms(lambda: wavlm_ops.relpos_softmax(work, *args), 50)
        plain_ms = cuda_ms(lambda: wavlm_ops.relpos_softmax_reference(scores, *args), 5)
        bound, by = relpos_bound_ms(WAVLM_FRAMES, h), "bytes"
        full = relpos_bound_ms((t,) * b, h)
        log(f"[wavlm] kernel {ms:.4f} ms ({bound / ms:.1%} of its bound {bound:.4f} ms by {by} "
            f"over real pairs; {full / ms:.1%} of {full:.4f} ms over every pair); plain "
            f"version {plain_ms:.3f} ms")
        profile_device("one relpos_softmax call", lambda: wavlm_ops.relpos_softmax(work, *args), 4)
        del scores, work, got
    torch.cuda.empty_cache()

    model = WavLMModel(WavLMConfig())
    init_weights_(model, torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    rng = np.random.default_rng(23)
    samples = np.array([256000] * 12 + [208000, 128000, 48000, 8000])
    wav = torch.from_numpy((0.1 * rng.normal(size=(len(samples), 256000))).astype(np.float32))
    for i, n in enumerate(samples):
        wav[i, n:] = 0.0
    wav, n_samples = wav.to(dev), torch.from_numpy(samples).to(dev)

    def encode():
        with torch.inference_mode():
            return model(wav, n_samples)

    encode()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with count_launches() as launches:
        hidden, frames = encode()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    finite = bool(torch.isfinite(hidden).all())
    del hidden
    batch_ms = cuda_ms(encode, 3)
    log(f"[wavlm] encoder batch 16 x 256,000 (WavLM-Large, fp32): {batch_ms:.2f} ms, memory "
        f"peak {peak / 1e9:.2f} GB, frames {frames.tolist()}, finite {finite}")
    check_launches("wavlm encoder batch", launches, {"wavlm-batch": 1}, model.config)
    if not finite:
        raise AssertionError("the WavLM encoder batch is not finite")
    profile_device("one WavLM-Large encoder batch", encode, 14)
    del model
    torch.cuda.empty_cache()
    return {"relpos_softmax": {
        "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": None, "bound_every_pair_ms": full, "shape": f"B={b} H={h} T={t}",
        "encoder_batch_ms": batch_ms, "encoder_peak_bytes": peak}}


# B, heads, T and each row's valid keys: the Conformer cell's extraction batch of
# 16 s chunks, and one of 5 s chunks (the extractor's default)
CONFORMER_SHAPES = ((16, 16, 799, WAVLM_FRAMES),
                    (16, 16, 249, (249,) * 12 + (199, 124, 49, 24)))


def conformer_bound_ms(frames, heads: int) -> tuple:
    """Least time for one call of the Conformer's shifted softmax over rows of
    ``frames`` real frames: the benchmark's bound (``port_bench.
    conformer_counts``) for one layer, and which of bytes or operations
    sets it."""
    cfg = {"num_heads": heads, "num_layers": 1, "hidden_size": heads * conformer_ops.HEAD_SIZE}
    return conformer_counts.relpos_score_bound(cfg, frames)


def conformer_kernel_phase(dev: torch.device) -> dict:
    """The Conformer's shifted relative-position softmax at each of
    ``CONFORMER_SHAPES`` against its plain version (the published full
    product, zero column, shifting view, mask and softmax), with times, its
    bound, the plain version's time and the "library" chain (``transformers``'
    own steps: the full product, ``cat``/``view`` shift, the sum with an
    additive key mask, ``torch.softmax``), then one Wav2Vec2-Conformer-Large
    encoder batch of 16 × 16 s: device ms, memory peak, its launches (one
    encoder-batch unit) and a profile by kernel."""
    from robust_speech_analysis_framework_tpu_torch.models.conformer import (
        ConformerConfig, ConformerModel)
    from robust_speech_analysis_framework_tpu_torch.models.init import init_weights_

    shapes = {}
    for b, h, t, frames in CONFORMER_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(t)
        scores = 2.0 * torch.randn(b, h, t, t, generator=gen, device=dev)
        q = (0.5 * torch.randn(b, t, h, conformer_ops.HEAD_SIZE, generator=gen, device=dev)
             ).transpose(1, 2)  # the projection's layout, as the encoder hands it over
        pos = 0.5 * torch.randn(2 * t - 1, h, conformer_ops.HEAD_SIZE, generator=gen, device=dev)
        lengths = torch.tensor(frames, dtype=torch.int32, device=dev)
        mask_bias = torch.where(torch.arange(t, device=dev)[None, :] < lengths[:, None].long(),
                                0.0, torch.finfo(torch.float32).min)[:, None, None, :]

        def library():
            bd = torch.matmul(q, pos.permute(1, 2, 0))
            padded = torch.cat([torch.zeros(b, h, t, 1, device=dev), bd], dim=-1)
            bd = padded.view(b, h, 2 * t, t)[:, :, 1:].view_as(bd)[..., :t]
            return torch.softmax(scores + bd + mask_bias, dim=-1)

        with torch.inference_mode():
            ref = conformer_ops.relpos_shift_softmax_reference(scores, q, pos, lengths)
            work = scores.clone()
            with count_launches() as launched:
                got = conformer_ops.relpos_shift_softmax(work, q, pos, lengths)
            torch.cuda.synchronize()
            counted = launched["relpos_shift_softmax"]
            abs_err = float((got - ref).abs().max())
            lib_err = float((library() - ref).abs().max())
            again = conformer_ops.relpos_shift_softmax(scores.clone(), q, pos, lengths)
            same = torch.equal(again, got)
            log(f"[conformer] B={b} H={h} T={t}: kernel vs plain version max|d| = {abs_err:.3e} "
                f"(tol {KERNEL_TOL}; the library chain {lib_err:.3e}); {counted} count a call; "
                f"two calls bit-equal: {same}")
            if not (abs_err <= KERNEL_TOL and counted == 1 and same):
                raise AssertionError("relpos_shift_softmax disagrees with its plain version")
            del ref, again
            # in place: each timed call overwrites the same buffer, as the encoder's does
            ms = cuda_ms(lambda: conformer_ops.relpos_shift_softmax(work, q, pos, lengths), 50)
            plain_ms = cuda_ms(lambda: conformer_ops.relpos_shift_softmax_reference(
                scores, q, pos, lengths), 5)
            library_ms = cuda_ms(library, 5)
            bound, by = conformer_bound_ms(frames, h)
            full, _ = conformer_bound_ms((t,) * b, h)
            log(f"[conformer] kernel {ms:.4f} ms ({bound / ms:.1%} of its bound {bound:.4f} ms "
                f"by {by} over real pairs; {full / ms:.1%} of {full:.4f} ms over every pair); "
                f"plain version {plain_ms:.3f} ms; library chain {library_ms:.3f} ms")
            profile_device(f"one relpos_shift_softmax call at T={t}",
                           lambda: conformer_ops.relpos_shift_softmax(work, q, pos, lengths), 4)
            del scores, work, got
        torch.cuda.empty_cache()
        shapes[f"B={b} H={h} T={t}"] = {
            "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound, "bound_by": by, "bound_every_pair_ms": full}

    model = ConformerModel(ConformerConfig())
    init_weights_(model, torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    rng = np.random.default_rng(27)
    samples = np.array([256000] * 12 + [208000, 128000, 48000, 8000])
    wav = torch.from_numpy((0.1 * rng.normal(size=(len(samples), 256000))).astype(np.float32))
    for i, n in enumerate(samples):
        wav[i, n:] = 0.0
    wav, n_samples = wav.to(dev), torch.from_numpy(samples).to(dev)

    def encode():
        with torch.inference_mode():
            return model(wav, n_samples)

    encode()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with count_launches() as launches:
        hidden, frames = encode()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    finite = bool(torch.isfinite(hidden).all())
    del hidden
    batch_ms = cuda_ms(encode, 3)
    log(f"[conformer] encoder batch 16 x 256,000 (Wav2Vec2-Conformer-Large, fp32): "
        f"{batch_ms:.2f} ms, memory peak {peak / 1e9:.2f} GB, frames {frames.tolist()}, "
        f"finite {finite}")
    check_launches("conformer encoder batch", launches, {"conformer-batch": 1}, model.config)
    if not finite:
        raise AssertionError("the Conformer encoder batch is not finite")
    profile_device("one Wav2Vec2-Conformer-Large encoder batch", encode, 16)
    del model
    torch.cuda.empty_cache()
    first, rec = next(iter(shapes.items()))  # the cell's batch
    return {"relpos_shift_softmax": {
        **rec, "max_abs_err": max(r["max_abs_err"] for r in shapes.values()), "shape": first,
        "shapes": shapes, "encoder_batch_ms": batch_ms, "encoder_peak_bytes": peak}}


def march_kernel_phase(dev: torch.device) -> dict:
    """The period march kernel (``march_periods``) at the openSMILE corpus's
    largest sub-batch (4 files of 44–52 s, their F0 from the pitch chain on
    the card) against its plain version on the card (≥ MARCH_SAME of
    boundaries equal, amplitudes and correlations within MARCH_TOL where
    they agree) and the numpy float64 oracle (≥ MARCH_ORACLE_SAME), with its
    time, µs a period of the longest lane, the plain version's time and its
    bound; then its profile build on the same inputs (outputs bit-equal to
    the timed build's, phase sums within the total): SM clocks and ns of
    each phase of a voiced step and of an unvoiced step, the SM clock
    measured against the global timer (tools/warp_latency)."""
    extractor = opensmile_mod.OpenSmileExtractor(device=dev)
    cfg = extractor.config.frontend
    corpus = _opensmile_corpus()
    bucket = max(extractor._bucket_of(len(x)) for x in corpus.values())
    waves = [x for x in corpus.values()
             if extractor._bucket_of(len(x)) == bucket][: extractor.pipeline_rows]
    stack = extractor._stack(bucket, waves)
    x = framing_ops.upload_pcm_f32(stack, dev)
    mag, _, energy, _, _, _, vpow = extractor.frame_stage(x)
    f0, _ = opensmile_mod.shs_pitch_batch(mag, cfg.sample_rate, energy, extractor.config.shs,
                                          extractor.config.energy_gate, win_len=cfg.frame_len,
                                          voicing_power=vpow)
    nts = [opensmile_mod.num_frames(len(w), cfg.frame_len, cfg.hop) for w in waves]
    ns = torch.tensor([len(w) for w in waves], dtype=torch.int32, device=dev)
    nf = torch.tensor(nts, dtype=torch.int32, device=dev)
    p_max = max(bucket // 16, 4)
    args = (x, f0, ns, nf, float(SR), cfg.hop, extractor.config.jitter_search_range, 40.0, p_max)
    card = [t.cpu().numpy() for t in march_ops.march_periods(*args)]
    plain_out, plain_ms = timed_once(lambda: march_ops.march_periods_reference(*args))
    plain = [t.cpu().numpy() for t in plain_out]
    f0_host = f0.cpu().numpy()
    worst_same, worst_oracle, err, faults = 1.0, 1.0, 0.0, []
    for i, w in enumerate(waves):
        k = int(min(card[4][i], plain[4][i]))
        # a lane ended early (a wrong break or cap, a lost jump near the end)
        # shows in its count; rows past the count stay zero
        if abs(int(card[4][i]) - int(plain[4][i])) > max(1, k // 1000):
            faults.append(f"file {i}: {card[4][i]} periods, plain version {plain[4][i]}")
        if any(a[i, card[4][i]:].any() for a in card[:4]):
            faults.append(f"file {i}: rows past its count {card[4][i]} are not zero")
        same = card[0][i, :k] == plain[0][i, :k]
        err = max(err, float(np.abs(card[2][i, :k] - plain[2][i, :k])[same].max()),
                  float(np.abs(card[3][i, :k] - plain[3][i, :k])[same].max()))
        oracle = jitter_ops.mark_periods(w.astype(np.float64), SR, f0_host[i, : nts[i]],
                                         hop_s=cfg.hop_seconds)
        m = min(len(oracle.starts), int(card[4][i]))
        if abs(int(card[4][i]) - len(oracle.starts)) > max(1, m // 1000):
            faults.append(f"file {i}: {card[4][i]} periods, oracle {len(oracle.starts)}")
        by_oracle = float(np.mean(card[0][i, :m] == oracle.starts[:m]))
        worst_same, worst_oracle = min(worst_same, float(same.mean())), min(worst_oracle, by_oracle)
        log(f"[march-kernel] file {i} ({len(w) / SR:.1f} s): kernel {card[4][i]} periods, plain "
            f"{plain[4][i]}, oracle {len(oracle.starts)}; equal starts {same.mean():.6%} of the "
            f"plain version's, {by_oracle:.6%} of the oracle's")
    ms = cuda_ms(lambda: march_ops.march_periods(*args), 3)
    bound, bound_by = march_bound_ms(stack, f0_host, nts, card[4], card[0], p_max, cfg.hop)
    longest = int(card[4].max())
    phases = march_profile(args, card, int(np.argmax(card[4])))
    log(f"[march-kernel] B={len(waves)} N={bucket} P={p_max}: kernel {ms:.4f} ms "
        f"({ms / longest * 1e3:.3f} us a period of the longest lane, {longest} periods), plain "
        f"{plain_ms:.4f} ms, bound {bound:.6f} ms ({bound_by}); no single PyTorch call marches "
        f"periods; max|d| of amplitudes and correlations where starts agree {err:.3e} (tol "
        f"{MARCH_TOL}); equal starts: worst {worst_same:.6%} of the plain version's (required "
        f"{MARCH_SAME:.1%}), {worst_oracle:.6%} of the oracle's (required {MARCH_ORACLE_SAME:.0%})")
    if faults:
        log(f"[march-kernel] period counts or tails wrong: {faults}")
    if not (worst_same >= MARCH_SAME and worst_oracle >= MARCH_ORACLE_SAME and err <= MARCH_TOL
            and (card[4] > 0).all() and not faults):
        raise AssertionError("the period march kernel disagrees with its plain version or "
                             "the oracle")
    return {"march_periods": {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": bound_by, "library_ms": None, "shape": f"B={len(waves)} N={bucket} P={p_max}",
        "boundaries_equal": worst_same, "periods_longest_lane": longest,
        "us_a_period": ms / longest * 1e3, "phases": phases}}


def march_profile(args, card, lane: int) -> dict:
    """The march kernel's profile build on ``args``: its outputs bit-equal
    to the timed build's (``card``), its phase sums within its total, and
    the breakdown of lane ``lane`` logged in SM clocks and in ns (the SM
    clock measured against the global timer, ``tools/warp_latency``): each
    voiced phase a voiced step, the unvoiced search an unvoiced step."""
    from robust_speech_analysis_framework_tpu_torch.tools import warp_latency

    (out, prof), prof_ms = timed_once(lambda: march_ops.march_periods_profile(*args))
    out = [t.cpu().numpy() for t in out]
    if not all(np.array_equal(a, b) for a, b in zip(out, card)):
        raise AssertionError("the march kernel's profile build disagrees with its timed build")
    bd = march_ops.profile_breakdown(prof)
    sums = sum(bd[name] for name in march_ops.PHASES)
    if not (sums <= bd["total"]).all():
        raise AssertionError(f"phase sums {sums} exceed the march's clocks {bd['total']}")
    ghz, _ = warp_latency.sm_clock_ghz()
    voiced, unvoiced = int(bd["voiced_steps"][lane]), int(bd["unvoiced_steps"][lane])
    per = {}
    for name in march_ops.PHASES:
        steps = unvoiced if name == "unvoiced" else voiced
        per[name] = float(bd[name][lane]) / max(steps, 1)
    total = int(bd["total"][lane])
    log(f"[march-profile] profile build {prof_ms:.4f} ms, outputs bit-equal to the timed "
        f"build's; SM clock {ghz:.3f} GHz; lane {lane}: {voiced} voiced and {unvoiced} "
        f"unvoiced steps, {total} clocks ({total / ghz / 1e6:.4f} ms), phases "
        f"{int(sums[lane])} clocks ({sums[lane] / total:.1%})")
    for name in march_ops.PHASES:
        share = bd[name][lane] / total
        log(f"[march-profile]   {name:16s} {per[name]:9.1f} clocks {per[name] / ghz:8.1f} ns "
            f"a{'n unvoiced' if name == 'unvoiced' else ' voiced'} step; {share:6.1%} of the "
            f"march")
    voiced_ns = sum(v for k, v in per.items() if k != "unvoiced") / ghz
    log(f"[march-profile]   a voiced step {voiced_ns:.1f} ns by phases; all lanes' voiced steps "
        f"{bd['voiced_steps'].tolist()}, unvoiced {bd['unvoiced_steps'].tolist()}")
    return {"sm_ghz": ghz, "lane": lane, "voiced_steps": voiced, "unvoiced_steps": unvoiced,
            "total_clocks": total, "profile_ms": prof_ms,
            "clocks_a_step": per, "voiced_step_ns": voiced_ns}


def profile_opensmile_sub_batch(extractor, bucket: int, waves, top: int) -> dict:
    """One sub-batch chain profiled from its dispatch to its fetch: wall,
    the device's busy time and idle share of that window, the march
    kernel's device time, the host↔device copies (exactly the two
    functional fetches down: no read between upload and fetch), and its
    ``top`` kernels by device time, logged."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("opensmile:sub-batch"):
            extractor._dispatch(bucket, waves).result()
    events = prof.events()
    (window,) = [e for e in events if e.name == "opensmile:sub-batch"
                 and e.device_type == DeviceType.CPU]
    lo, hi = window.time_range.start, window.time_range.end
    device = [e for e in events if _on_device(e) and not e.name.startswith("opensmile:")]
    busy_us = union_us([(e.time_range.start, e.time_range.end) for e in device], lo, hi)
    march_us = sum(e.time_range.elapsed_us() for e in device if "period_march" in e.name)
    down = [e for e in device if "DtoH" in e.name or "Device -> Pinned" in e.name
            or "Device -> Pageable" in e.name]
    up = [e for e in device if "HtoD" in e.name]
    _log_top_kernels([e for e in _device_rows(prof) if not e.key.startswith("opensmile:")], top)
    return {"wall_ms": (hi - lo) / 1e3, "busy_ms": busy_us / 1e3,
            "idle": 1 - busy_us / max(hi - lo, 1e-9), "march_ms": march_us / 1e3,
            "down": len(down), "up": len(up), "device_events": len(device)}


def opensmile_phase(dev: torch.device) -> dict:
    """The third main path: a seeded corpus of 16 speech-like 16 kHz files of
    20–60 s (three length buckets) through OpenSmileExtractor.extract_arrays
    on the card, a sub-batch unit of launches each; first-pass and steady
    wall time (median of 3), audio-s/s, peak memory; one sub-batch chain
    dispatched under torch's sync debug mode at "error" (no read of the card
    between its upload and its fetch), its uploaded bytes, and its profile:
    wall, device busy and idle share, the march kernel's time, the copies
    (two down: the functional fetches); 16 × 912 finite values; two short
    files card vs CPU within the tolerance families of the JAX package's
    batched-vs-serial test. Returns the launches."""
    t0 = time.perf_counter()
    corpus = _opensmile_corpus()
    audio_s = sum(len(x) for x in corpus.values()) / SR
    extractor = opensmile_mod.OpenSmileExtractor(device=dev)
    buckets = sorted({extractor._bucket_of(len(x)) for x in corpus.values()})
    log(f"[opensmile] corpus: {OS_FILES} files, {OS_MIN_S}–{OS_MAX_S} s, {audio_s:.1f} audio-s "
        f"in buckets {buckets} samples, made in {time.perf_counter() - t0:.2f} s")

    def extract():
        start = time.perf_counter()
        names, feats = extractor.extract_arrays(corpus, verbose=False)
        torch.cuda.synchronize()
        return names, feats, time.perf_counter() - start

    torch.cuda.reset_peak_memory_stats(dev)
    with count_launches() as launches:
        names, feats, first_s = extract()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    walls = [extract()[2] for _ in range(3)]
    median = statistics.median(walls)
    per_bucket = collections.Counter(extractor._bucket_of(len(x)) for x in corpus.values())
    n_sub = sum(-(-n // extractor.pipeline_rows) for n in per_bucket.values())
    log(f"[opensmile] first pass {first_s:.3f} s ({audio_s / first_s:.1f} audio-s/s); steady "
        f"median {median:.3f} s of {[round(w, 3) for w in walls]} s, {audio_s / median:.1f} "
        f"audio-s/s; {opensmile_mod._MAX_INFLIGHT} sub-batch chains in flight; peak memory "
        f"{peak_gib:.3f} GiB")
    check_launches("opensmile", launches, {"opensmile-sub-batch": n_sub})
    if feats.shape != (OS_FILES, 912) or not np.isfinite(feats).all() or sorted(names) != sorted(corpus):
        raise AssertionError(f"bad openSMILE features {feats.shape}")
    col = opensmile_mod.feature_columns().index("F0final_sma_amean")
    log(f"[opensmile] {feats.shape} finite; F0final_sma_amean over files "
        f"{feats[:, col].min():.2f}–{feats[:, col].max():.2f} Hz")

    # one sub-batch of the largest bucket: no synchronising call (no read of
    # the card) from its upload to its fetch, then its profile
    big = [x for x in corpus.values() if extractor._bucket_of(len(x)) == buckets[-1]]
    part = big[: extractor.pipeline_rows]
    stack = extractor._stack(buckets[-1], part)
    pcm = framing_ops._pcm_int16(stack) is not None
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        chain = extractor._dispatch(buckets[-1], part)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    chain.result()
    log(f"[profile] one openSMILE sub-batch ({len(part)} files, bucket {buckets[-1]}), its "
        f"kernels by device time:")
    prof = profile_opensmile_sub_batch(extractor, buckets[-1], part, 12)
    log(f"[opensmile] one sub-batch ({len(part)} files, bucket {buckets[-1]}): dispatched with "
        f"torch's sync debug mode at 'error' (no synchronising call); uploaded "
        f"{stack.size * (2 if pcm else 4)} B of waveforms ({'int16' if pcm else 'float32'}; "
        f"{stack.size * 4} B as float32); profiled: wall {prof['wall_ms']:.3f} ms, device busy "
        f"{prof['busy_ms']:.3f} ms (idle {prof['idle']:.1%}), period march kernel "
        f"{prof['march_ms']:.3f} ms, copies {prof['up']} up and {prof['down']} down "
        f"(the two functional fetches)")
    if prof["device_events"] and prof["down"] != 2:
        raise AssertionError(f"{prof['down']} device→host copies in one sub-batch chain, "
                             "expected only its two functional fetches")

    # the two files of tests/test_torch_cuda.py::test_opensmile_on_card_matches_cpu:
    # steady harmonics without vibrato. Positional functionals of a contour
    # with exact ties are decided by rounding: on corpus-recipe files
    # voicing clips to exactly 1.0 on many frames, and which frame is the
    # first at 1.0 moved 150 frames between card and CPU (PERF.md)
    rng = np.random.default_rng(0)
    short = {}
    for i, seconds in enumerate((1.3, 2.2)):
        t = np.arange(int(seconds * SR)) / SR
        voiced = sum(np.sin(2 * np.pi * k * (125 + 20 * i) * t) / k for k in range(1, 12))
        x = 0.3 * np.where((t % 0.6) < 0.42, 1.0, 0.02) * voiced / np.abs(voiced).max()
        short[f"w{i}.wav"] = (x + 0.002 * rng.normal(size=len(t))).astype(np.float32)
    card_names, card = extractor.extract_arrays(short, verbose=False)
    cpu_names, cpu = opensmile_mod.OpenSmileExtractor(device="cpu").extract_arrays(
        short, verbose=False)
    rel = np.abs(card - cpu) / np.maximum(np.abs(cpu), 1e-3)
    vq = np.array([any(k in c for k in ("jitter", "shimmer", "logHNR"))
                   for c in opensmile_mod.feature_columns()])
    stats = (float(np.median(rel)), float(rel[:, ~vq].mean()), float(rel[:, vq].mean()))
    log(f"[opensmile] 1.3 s + 2.2 s files card vs CPU: median rel {stats[0]:.3e} (tol "
        f"{OS_MEDIAN_TOL}), mean rel off voice quality {stats[1]:.3e} (tol {OS_MEAN_TOL}), "
        f"on it {stats[2]:.3e} (tol {OS_VQ_MEAN_TOL}); max rel {rel.max():.3e} at "
        f"{opensmile_mod.feature_columns()[int(rel.max(0).argmax())]}")
    if not (card_names == cpu_names and stats[0] < OS_MEDIAN_TOL and stats[1] < OS_MEAN_TOL
            and stats[2] < OS_VQ_MEAN_TOL):
        raise AssertionError("openSMILE features on the card disagree with the CPU")
    return launches


def checkpoint_phase(dev: torch.device, tmp: str) -> None:
    """A whole train state of the flagship model saved after two steps on
    the card and restored into a fresh state: the next step matches the
    uninterrupted run's within CKPT_TOL (parameters, BatchNorm statistics,
    Adam moments), with the same rate and step counts."""
    from robust_speech_analysis_framework_tpu_torch.train import checkpoints

    rng = np.random.default_rng(11)
    batches = []
    for _ in range(3):
        x = rng.standard_normal((2, 512, DIM), dtype=np.float32)
        x[1, 377:] = 0.0
        batches.append((x, np.array([512, 377], np.int32), np.array([0, 1])))
    trainer = loops.Trainer(CNNLSTM(DIM, 2, 128, 128), device=dev)

    def step(state, i):
        x, lengths, y = batches[i]
        trainer.train_step(state, x, lengths, y,
                           torch.Generator(device=dev).manual_seed(i), dropout_rate=0.5)

    whole = trainer.init_state(7, 1e-3)
    step(whole, 0)
    step(whole, 1)
    whole.lr = 1e-4  # as after a plateau decay
    checkpoints.save_train_state(tmp, whole, step=2)
    resumed = checkpoints.restore_train_state(tmp, trainer.init_state(8, 0.5), step=2)
    step(whole, 2)
    step(resumed, 2)
    torch.cuda.synchronize()
    sa, sb = whole.model.state_dict(), resumed.model.state_dict()
    state_err = max(float((sa[k].double() - sb[k].double()).abs().max()) for k in sa)
    oa, ob = whole.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    adam_err = max(float((oa[i][key] - ob[i][key]).abs().max())
                   for i in oa for key in ("exp_avg", "exp_avg_sq"))
    steps = {float(v["step"]) for v in (*oa.values(), *ob.values())}
    log(f"[checkpoint] flagship train state after 2 steps (B=2 T=512), saved and restored into "
        f"a fresh state, then step 3 on both: model max|d|={state_err:.3e}, Adam moments "
        f"max|d|={adam_err:.3e} (tol {CKPT_TOL}); rate {resumed.lr} vs {whole.lr}; Adam steps "
        f"{sorted(steps)}")
    if not (state_err <= CKPT_TOL and adam_err <= CKPT_TOL and resumed.lr == whole.lr
            and steps == {3.0} and oa.keys() == ob.keys()):
        raise AssertionError("a resumed train state does not take the uninterrupted step")


# ---------------------------------------------------------------------------
# mshds: the whole MSHDS-25 extractor (features/mshds.py)
# ---------------------------------------------------------------------------

MSHDS_FILES, MSHDS_MIN_S, MSHDS_MAX_S = 16, 20.0, 60.0
MSHDS_F0 = (95.0, 230.0)  # spread over both range groups, (60, 250) and (100, 500)
MSHDS_CPU_FILES = 4  # the shortest files, run again on the CPU
# card vs CPU, feature by feature: (rtol, atol). The pitch passes agree by
# frame share (cuFFT and pocketfft round r(τ) apart, so near-ties in the path
# may flip a frame), and every later feature reads those tracks or the
# pulses marched on them; HNR's 10·log10(r/(1−r)) and the CPPS log-cepstrum
# amplify float32 differences into hundredths of a dB
MSHDS_TOL = {
    **dict.fromkeys(mshds_mod._TEMPORAL, (1e-6, 0.0)),
    "mean_F0": (1e-4, 0.0), "stdev_F0_Semitone": (0.0, 1e-3),
    "mean_dB": (1e-4, 0.0), "range_ratio_dB": (1e-4, 0.0), "HNR_dB": (0.0, 0.05),
    "Spectral_Slope": (1e-3, 0.0), "Spectral_Tilt": (1e-3, 0.0),
    "Cepstral_Peak_Prominence": (0.0, 0.05),
    **{f"{s}_{k}_Loc": (1e-3, 0.0) for s in ("mean", "std") for k in ("F1", "B1", "F2", "B2")},
    # means over the frames the main pitch track calls voiced: one frame's
    # voicing flipped between card and CPU, among ~3,000 voiced ones, moves
    # each mean by up to ~1/3,000 of that frame's distance from it
    **dict.fromkeys(["Spectral_Gravity", "Spectral_Std_Dev", "Spectral_Skewness",
                     "Spectral_Kurtosis"], (5e-3, 0.0)),
}
# the moments stage alone, card against CPU on the same voiced frames (the
# recipe's open syllable gates): float32 spectra summed in another order
MSHDS_MOMENTS_STAGE_RTOL = 1e-4
# the tail's stages, each timed on the device under its own profiler range
MSHDS_TAIL_STAGES = (("moments", mshds_mod, "voiced_mean_moments_batch"),
                     ("formants", mshds_mod, "formant_track_burg_batch"),
                     ("durand-kerner", mshds_formants, "durand_kerner_roots"),
                     ("ltas", mshds_mod, "ltas_pitch_corrected_batch"),
                     ("cpps", mshds_mod, "cpps_segments_batch"))


class _MshdsProbe:
    """Times the extractor's levels by wrapping the calls that end them (the
    three ``collect`` calls: L0, L1, the tail; the device pulse march), and,
    with ``ranges``, marks each tail stage with a profiler range. The
    extractor's code runs as it is."""

    def __init__(self, ranges: bool = False):
        self.ends, self.patched = [], []
        self.wrap(mshds_mod, "collect", "collect")
        self.wrap(mshds_mod, "point_process_cc_batch", "pulses")
        if ranges:
            for label, module, name in MSHDS_TAIL_STAGES:
                self.wrap(module, name, label, mark_end=False)

    def wrap(self, module, name, label, mark_end=True):
        from torch.profiler import record_function

        real = getattr(module, name)

        def wrapped(*args, **kwargs):
            with record_function(f"mshds:{label}"):
                out = real(*args, **kwargs)
            if mark_end:
                self.ends.append(time.perf_counter())
            return out

        self.patched.append((module, name, real))
        setattr(module, name, wrapped)

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.stop = time.perf_counter()
        for module, name, real in self.patched:
            setattr(module, name, real)

    def walls(self) -> dict:
        """Seconds of each level: L0 (upload, resample, three passes), L1
        (the speech-rate host logic under the queued range passes), pulses
        (the device march), tail, and the host rows after it; the pulses
        and the tail as one when the march ran on the host."""
        names = {4: ("L0", "L1", "pulses", "tail", "rows"), 3: ("L0", "L1", "pulses+tail", "rows")}
        if len(self.ends) not in names:
            raise AssertionError(f"expected 3 collects and at most one device march, saw "
                                 f"{len(self.ends)} calls")
        marks = [self.start, *self.ends, self.stop]
        return {k: b - a for k, a, b in zip(names[len(self.ends)], marks, marks[1:])}


def mshds_extract(xs, device):
    """One extraction through the port's entry point, with its level walls."""
    with _MshdsProbe() as probe:
        feats = mshds_mod.extract_mshds_arrays(xs, SR, device=device)
        if device != "cpu":
            torch.cuda.synchronize()
    return feats, probe.stop - probe.start, probe.walls()


def profile_mshds_tail(xs, dev: torch.device) -> None:
    """One profiled extraction: each tail stage's device time (its kernels,
    by profiler range), Durand–Kerner's share, launches and host time, and
    the device's idle share of the tail's window (from the end of the pulse
    march to the end of the tail's collect)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with _MshdsProbe(ranges=True):
            mshds_mod.extract_mshds_arrays(xs, SR, device=dev)
            torch.cuda.synchronize()
    events = prof.events()
    ranges = collections.defaultdict(list)
    for e in events:
        if e.name.startswith("mshds:") and e.device_type == DeviceType.CPU:
            ranges[e.name[6:]].append(e)
    if len(ranges["collect"]) != 3 or len(ranges["pulses"]) != 1:
        raise AssertionError(f"profiled ranges: {({k: len(v) for k, v in ranges.items()})}")
    lo = ranges["pulses"][0].time_range.end
    hi = ranges["collect"][2].time_range.end
    # the device's own work: kernels and copies, not the device-side
    # mirrors of the profiler ranges
    kernels = [(e.time_range.start, e.time_range.end) for e in events
               if _on_device(e) and not e.name.startswith("mshds:")]
    busy_us = union_us(kernels, lo, hi)
    if busy_us == 0:
        log("[mshds] the profiler recorded no device time in the tail's window")
        return

    def launches(e) -> int:
        return len(e.kernels) + sum(launches(c) for c in e.cpu_children)

    parts = []
    for label, _, _ in MSHDS_TAIL_STAGES:
        (e,) = ranges[label]
        parts.append(f"{label} {e.device_time_total / 1e3:.3f} ms device, {launches(e)} launches, "
                     f"{e.time_range.elapsed_us() / 1e3:.3f} ms host")
    log(f"[mshds] tail profile: window {(hi - lo) / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} "
        f"ms, idle {1 - busy_us / (hi - lo):.1%}; by stage (durand-kerner inside formants): "
        + "; ".join(parts))


def mshds_phase(dev: torch.device, records: dict) -> dict:
    """The whole MSHDS-25 extractor: 16 speech-like 16-bit PCM files of
    20–60 s (f0 95–230 Hz, both range groups) through the port's entry point
    ``features.mshds.extract_mshds_arrays`` on the card, a pitch-pass unit of
    launches each (wide, speech-rate, and main, CPP and cc in each range
    group); first-pass and steady wall time (the same bits every pass), each
    level's (L0, L1, pulses, tail, host rows: timed by wrapping the calls
    that end them), the march's steps and host syncs, peak memory; K6/K7 bit
    for bit against their plain versions on the candidate stacks of a
    main-pass call and of the largest call, timed there with their bound;
    the 4 shortest files again on the CPU against the card, all 25 features
    each to its tolerance (MSHDS_TOL) with equal NaN masks, and the moments
    stage alone on the same voiced frames card vs CPU; one profiled
    extraction: each tail stage's device time (moments, formants with
    Durand–Kerner's share, LTAS, CPPS), launches and host time, and the
    device's idle share of the tail's window. Adds K6/K7's times at this
    path's shape to ``records`` and returns the launches."""
    t0 = time.perf_counter()
    seconds = np.linspace(MSHDS_MIN_S, MSHDS_MAX_S, MSHDS_FILES)
    f0s = np.linspace(*MSHDS_F0, MSHDS_FILES)
    xs = [_speech(s, f0, 100 + i).astype(np.float64) for i, (s, f0) in enumerate(zip(seconds, f0s))]
    audio_s = sum(len(x) for x in xs) / SR
    log(f"[mshds] corpus: {MSHDS_FILES} files, {MSHDS_MIN_S}–{MSHDS_MAX_S} s, f0 "
        f"{MSHDS_F0[0]}–{MSHDS_F0[1]} Hz, {audio_s:.1f} audio-s of 16-bit PCM, made in "
        f"{time.perf_counter() - t0:.2f} s")

    calls = []  # the arguments of every path-finder call of the first pass
    real_path = mshds_pitch.viterbi_path

    def recording_path(*args):
        calls.append(args)
        return real_path(*args)

    torch.cuda.reset_peak_memory_stats(dev)
    with count_launches() as launches:
        mshds_pitch.viterbi_path = recording_path
        try:
            card, first_wall, first_walls = mshds_extract(xs, dev)
        finally:
            mshds_pitch.viterbi_path = real_path
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    if "pulses" not in first_walls:
        raise AssertionError("the corpus did not take the device pulse march")
    n_passes = 2 + 3 * 2  # wide + speech-rate; main, CPP and cc per range group
    if len(calls) != n_passes:
        raise AssertionError(f"the MSHDS extractor made {len(calls)} pitch passes, expected "
                             f"{n_passes}")
    check_launches("mshds", launches, {"mshds-pitch-pass": n_passes})
    if card.shape != (MSHDS_FILES, 25) or np.isfinite(card).sum() < 0.95 * card.size:
        raise AssertionError(f"MSHDS features misshapen or mostly NaN: {card.shape}, "
                             f"{int(np.isfinite(card).sum())} finite")

    steady = [mshds_extract(xs, dev) for _ in range(3)]
    walls = [w for _, w, _ in steady]
    median = steady[walls.index(statistics.median(walls))]
    log(f"[mshds] first pass {first_wall:.3f} s ({audio_s / first_wall:.1f} audio-s/s); "
        f"steady median {median[1]:.3f} s of {[round(w, 3) for w in walls]} s, "
        f"{audio_s / median[1]:.1f} audio-s/s; levels (first / steady median) "
        + ", ".join(f"{k} {first_walls[k]:.3f} / {median[2][k]:.3f} s" for k in first_walls)
        + f"; march {mshds_pulses._march_lanes.steps} steps, {mshds_pulses._march_lanes.syncs} "
        f"host syncs; peak memory {peak_gib:.3f} GiB")
    for feats, _, _ in steady:
        np.testing.assert_array_equal(feats, card)  # the same bits on every pass

    # K7 on real candidate stacks: a slab of a main pass (the first call of
    # L1), then every K7 call's inputs timed at the largest (the wide pass)
    largest = max(calls, key=lambda a: a[0].numel())
    for label, args in (("main-pass slab", calls[2]), ("largest slab", largest)):
        b, t, c = args[0].shape
        path = viterbi_ops.viterbi_path(*args)
        costs = viterbi_ops.viterbi_forward_costs(*args)
        ref_path, plain_ms = timed_once(lambda: viterbi_ops.viterbi_path_reference(*args))
        ref_costs, plain_k6_ms = timed_once(
            lambda: viterbi_ops.viterbi_forward_costs_reference(*args))
        same = float((path == ref_path).float().mean())
        log(f"[mshds] K7 on the {label} B={b} T={t} C={c} (Praat weights w_vv="
            f"{args[3]:.4f}, w_diff={args[5]:.4f}): paths identical on {same:.6%} of frames, "
            f"K6 max|dc|={float((costs - ref_costs).abs().max()):.3e} (required: 100 % and 0)")
        if not (torch.equal(path, ref_path) and torch.equal(costs, ref_costs)):
            raise AssertionError(f"K6/K7 differ from their plain versions on the {label}")
    b, t, c = largest[0].shape
    for name, kernel, is_path, plain in (("viterbi_forward_costs", viterbi_ops.viterbi_forward_costs,
                                          False, plain_k6_ms),
                                         ("viterbi_path", viterbi_ops.viterbi_path, True, plain_ms)):
        ms = cuda_ms(lambda: kernel(*largest), 5)
        bound, bound_by = viterbi_bound_ms(b, t, c, is_path)
        records[name]["mshds"] = {"shape": f"B={b} T={t} C={c}", "ms": ms, "plain_ms": plain,
                                  "bound_ms": bound, "bound_by": bound_by, "library_ms": None}
        log(f"[mshds] {name} at the largest slab B={b} T={t} C={c}: kernel {ms:.4f} ms "
            f"({ms / t * 1e3:.4f} us a step), plain {plain:.4f} ms, bound {bound:.6f} ms "
            f"({bound_by})")

    t0 = time.perf_counter()
    cpu, cpu_wall, _ = mshds_extract(xs[:MSHDS_CPU_FILES], "cpu")
    log(f"[mshds] the {MSHDS_CPU_FILES} shortest files on the CPU: {cpu_wall:.3f} s")
    mshds_card_vs_cpu(card[:MSHDS_CPU_FILES], cpu, seconds, f0s)
    moments_stage_card_vs_cpu(xs[:MSHDS_CPU_FILES], dev)
    profile_mshds_tail(xs, dev)
    return launches


def _open_gate(t):
    """Voiced where the corpus recipe's syllable gate is open."""
    return (np.atleast_1d(t) % 0.6) < 0.42


def moments_stage_card_vs_cpu(xs, dev: torch.device) -> None:
    """The spectral-moments stage alone on the card and on the CPU, fed the
    same voiced frames: what is left of the extractor's moment differences
    once the main pitch track's voicing is taken out of them."""
    fns = [_open_gate] * len(xs)
    card = np.asarray(mshds_spectral.voiced_mean_moments_batch(xs, SR, fns, device=dev))
    cpu = np.asarray(mshds_spectral.voiced_mean_moments_batch(xs, SR, fns, device="cpu"))
    rel = float((np.abs(card - cpu) / np.abs(cpu)).max())
    log(f"[mshds] the moments stage alone, the same voiced frames, card vs CPU: max rel "
        f"{rel:.3e} (tol {MSHDS_MOMENTS_STAGE_RTOL})")
    if not rel <= MSHDS_MOMENTS_STAGE_RTOL:
        raise AssertionError("the spectral-moments stage on the card disagrees with the CPU")


def mshds_card_vs_cpu(card: np.ndarray, cpu: np.ndarray, seconds, f0s,
                      labels: tuple = ("card", "CPU")) -> None:
    """The shortest files' 25 features, card beside CPU (or the two runs
    ``labels`` names), each held to its tolerance; NaN masks equal."""
    bad = []
    for k, name in enumerate(mshds_mod.FEATURE_NAMES):
        rtol, atol = MSHDS_TOL[name]
        a, b = card[:, k], cpu[:, k]
        both = np.isfinite(a) & np.isfinite(b)
        err = np.abs(a - b)
        rel = err / np.maximum(np.abs(b), 1e-30)
        worst = float((rel if rtol else err)[both].max(initial=0.0))
        ok = np.array_equal(np.isnan(a), np.isnan(b)) and bool(
            (err[both] <= atol + rtol * np.abs(b[both])).all())
        log(f"[mshds] {name:26s} worst {'rel' if rtol else 'abs'} {worst:.3e} "
            f"(tol {rtol or atol}){'' if ok else '  <-- FAILS'}")
        if not ok:
            bad.append(name)
    for i in range(len(cpu)):
        log(f"[mshds] file {i} ({seconds[i]:.1f} s, f0 {f0s[i]:.1f} Hz), {labels[0]} / "
            f"{labels[1]}: " + ", ".join(f"{n} {a:.6g} / {b:.6g}" for n, a, b in
                                         zip(mshds_mod.FEATURE_NAMES, card[i], cpu[i])))
    if bad:
        raise AssertionError(f"MSHDS features, {labels[0]} vs {labels[1]}, disagree: {bad}")


# --- w2v: the extraction that feeds the main path -------------------------------

W2V_PARTICIPANTS = 24  # 12 Control, 12 Patient
W2V_READING_S = (20.0, 40.0)
W2V_CLIP_S = (3.0, 12.0)
W2V_SHORT_CHUNK_S = 8.9  # chunks of 5, 4.9 and 0.9 s: a short chunk that is not the last
W2V_CONFIG = Wav2Vec2Config()  # Wav2Vec2-base at its full width: 12 layers, 768 wide
W2V_BATCH = 16
W2V_CV = dict(n_splits=2, epochs=2, patience=25, batch_size=8, seed=42)
W2V_RESIDENT_TOL = 1e-6  # resident buffer vs the float32 download: the same batches, copies
W2V_CV_TOL = 1e-5  # first-epoch losses: the extractor's resident corpus vs an upload
W2V_EMB_TOL = 1e-5  # embeddings vs the per-file mean of the float32 sequences
W2V_PREDICT_TOL = 1e-6  # predict_files (native decode) vs the Python codec, a PCM file
W2V_TRANSFERS = {"int16": np.int16, "int24": "int24", "int8": np.int8, "float16": np.float16}


def _write_float_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """A mono IEEE-float32 WAV (format code 3)."""
    data = np.asarray(samples, "<f4").tobytes()
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVEfmt ")
        fh.write(struct.pack("<IHHIIHH", 16, 3, 1, sample_rate, 4 * sample_rate, 4, 32))
        fh.write(b"data" + struct.pack("<I", len(data)) + data)


def _androids_tree(root: str) -> dict:
    """A seeded synthetic Androids corpus under ``root``: W2V_PARTICIPANTS
    sessions (Control and Patient in turn), one reading WAV of 20–40 s each,
    2–3 interview clips of 3–12 s each (participant 01's first is 8.9 s), a
    two-header-row fold-lists.csv (the interview columns repeat the reading
    ones, as pandas-mangled ``foldN.1``). Mostly 16 kHz 16-bit mono; every
    sixth reading file and some clips 44.1 kHz 16-bit stereo; one reading
    file and one clip IEEE float32. Returns each file's format by name."""
    rng = np.random.default_rng(12)
    formats, folds = {}, [[] for _ in range(10)]

    def write(path: str, seconds: float, fmt: str) -> None:
        f0, seed = float(rng.uniform(95, 230)), int(rng.integers(1 << 30))
        if fmt == "stereo44k":
            x = _speech(seconds, f0, seed, sr=44100)
            write_wav(path, np.stack([x, 0.8 * x], axis=1), 44100)
        elif fmt == "float32":
            x = _speech(seconds, f0, seed) + 1e-5 * rng.standard_normal(int(seconds * SR))
            _write_float_wav(path, x.astype(np.float32), SR)
        else:
            write_wav(path, _speech(seconds, f0, seed), SR)
        formats[os.path.basename(path)] = fmt

    for k in range(W2V_PARTICIPANTS):
        cond = "CP"[k % 2]
        session = f"{k + 1:02d}_{cond}{'MF'[k % 3 > 0]}{20 + k:02d}_{k % 5 + 1}"
        rdir = os.path.join(root, "Reading-Task", "audio", "HC" if cond == "C" else "PT")
        os.makedirs(rdir, exist_ok=True)
        fmt = "stereo44k" if k % 6 == 1 else "float32" if k == 4 else "pcm16"
        write(os.path.join(rdir, session + ".wav"), float(rng.uniform(*W2V_READING_S)), fmt)
        cdir = os.path.join(root, "Interview-Task", "audio_clip", session)
        os.makedirs(cdir, exist_ok=True)
        for c in range(2 + k % 2):
            seconds = W2V_SHORT_CHUNK_S if k == c == 0 else float(rng.uniform(*W2V_CLIP_S))
            fmt = ("stereo44k" if k % 6 == 3 and c == 1 else
                   "float32" if k == 7 and c == 0 else "pcm16")
            write(os.path.join(cdir, f"{session}_{c}.wav"), seconds, fmt)
        folds[k % 5].append(session + ".wav")
        folds[5 + k % 5].append(session)
    with open(os.path.join(root, "fold-lists.csv"), "w") as fh:
        fh.write("Androids corpus folds\n" + ",".join([f"fold{j}" for j in range(1, 6)] * 2) + "\n")
        for i in range(max(map(len, folds))):
            fh.write(",".join(col[i] if i < len(col) else "" for col in folds) + "\n")
    return formats


def _synced(fn):
    """(result, wall seconds) of ``fn`` between two synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def w2v_phase(dev: torch.device, tmp: str) -> dict:
    """The extraction that feeds the main path: a synthetic Androids corpus
    loaded through the array core, decoded natively, its interview clips
    extracted by a full-width Wav2Vec2-base straight into a device buffer,
    regrouped per participant on the device and adopted by the standard CV
    engine; checked against the float32 download, host aggregation, the
    transfer dtypes' contracts, the embeddings and predict_files. The
    extractions are float32 encoder-batch units (as many a pass as the
    first pass launched) and bfloat16 ones, the CV run step and eval units.
    Returns the launches of the extractions and of the CV run."""
    from robust_speech_analysis_framework_tpu_torch.audio import native_io
    from robust_speech_analysis_framework_tpu_torch.audio.io import load_files_mono_16k
    from robust_speech_analysis_framework_tpu_torch.data.aggregate import (
        concat_groups,
        participant_clips,
    )
    from robust_speech_analysis_framework_tpu_torch.data.corpus import load_androids_rows

    t0 = time.perf_counter()
    formats = _androids_tree(tmp)
    reading, interview = load_androids_rows(tmp, verbose=False)
    log(f"[w2v] corpus: {len(reading)} reading files, {len(interview)} interview clips "
        f"({collections.Counter(formats.values())}), written and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    if not (len(reading) == W2V_PARTICIPANTS and len(interview) == len(formats) - len(reading)
            and all(r["fold"] > 0 for r in reading + interview)):
        raise AssertionError("the corpus rows do not match the tree written")

    # --- native decode
    t0 = time.perf_counter()
    native_io.load_library()
    log(f"[w2v] native decoder built and loaded in {time.perf_counter() - t0:.2f} s "
        f"({os.path.relpath(native_io._library_path())})")
    paths = [r["filepath"] for r in reading + interview]
    t0 = time.perf_counter()
    decoded = native_io.decode_batch_mono(paths)
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    waves = native_io.load_corpus_mono_16k(paths)
    load_s = time.perf_counter() - t0
    audio_s = sum(len(w) for w in waves.values()) / SR
    log(f"[w2v] decode_batch_mono: {len(paths)} files in {decode_s:.3f} s "
        f"({len(paths) / decode_s:.1f} files/s, {audio_s / decode_s:.1f} audio-s/s); "
        f"load_corpus_mono_16k (decode + resample to 16 kHz): {load_s:.3f} s "
        f"({len(paths) / load_s:.1f} files/s, {audio_s / load_s:.1f} audio-s/s)")
    if any(d is None for d in decoded) or len(waves) != len(paths):
        raise AssertionError("the native decoder failed on a file of the corpus")
    clips = {r["filename"]: waves[r["filename"]] for r in interview}
    clip_s = sum(len(w) for w in clips.values()) / SR

    # --- extraction at every transfer dtype
    extractor = Wav2Vec2Extractor(config=W2V_CONFIG, allow_random_init=True, seed=0,
                                  batch_size=W2V_BATCH, device=dev)
    params = extractor.model.state_dict()

    def variant(**kw):
        return Wav2Vec2Extractor(params=params, config=W2V_CONFIG, batch_size=W2V_BATCH,
                                 device=dev, **kw)

    downloaded = [0]
    real_download = Wav2Vec2Extractor._download

    def counting_download(self, payload, stream):
        downloaded[0] += sum(t.numel() * t.element_size() for t in payload)
        return real_download(self, payload, stream)

    variants = {"float32": {}, "int16-upload": {"upload_dtype": np.int16},
                **{k: {"sequence_transfer_dtype": v} for k, v in W2V_TRANSFERS.items()},
                "bfloat16": {"compute_dtype": "bfloat16"}}
    torch.cuda.reset_peak_memory_stats(dev)
    with count_launches() as first:
        _, first_s = _synced(lambda: extractor.extract_sequences(clips, verbose=False))
    per_pass = first["conv0_norm_gelu"]  # one an encoder batch
    out, walls = {}, {}
    Wav2Vec2Extractor._download = counting_download
    with count_launches() as rest:
        try:
            for label, kw in variants.items():
                ex = variant(**kw)
                if label == "bfloat16":  # cuDNN's and cuBLAS's bfloat16 plans, outside the timing
                    ex.extract_sequences(dict(list(clips.items())[:2]), verbose=False)
                downloaded[0] = 0
                out[label], walls[label] = _synced(lambda: ex.extract_sequences(clips,
                                                                                verbose=False))
                log(f"[w2v] extract_sequences {label}: {walls[label]:.3f} s, "
                    f"{clip_s / walls[label]:.1f} audio-s/s, {downloaded[0] / clip_s:.1f} bytes "
                    f"downloaded per audio-s ({len(clips)} clips, {clip_s:.1f} audio-s)")
        finally:
            Wav2Vec2Extractor._download = real_download
        f32 = out["float32"]
        log(f"[w2v] first float32 extraction (cold): {first_s:.3f} s")

        # --- the resident path, beside extract_sequences + a ResidentCorpus upload
        res, res_s = _synced(lambda: extractor.extract_sequences_resident(clips, verbose=False))
    uploaded, up_s = _synced(lambda: loops.ResidentCorpus(f32, device=dev).device_corpus())
    err = float((res.x - uploaded.x).abs().max()) if res.x.shape == uploaded.x.shape else np.inf
    log(f"[w2v] extract_sequences_resident: {res_s:.3f} s ({clip_s / res_s:.1f} audio-s/s) "
        f"into {tuple(res.x.shape)}; extract_sequences {walls['float32']:.3f} s + ResidentCorpus "
        f"upload {up_s:.3f} s = {walls['float32'] + up_s:.3f} s into "
        f"{tuple(uploaded.x.shape)}; max|d|={err:.3e} (tol {W2V_RESIDENT_TOL})")
    if not (res.names == list(f32) and err <= W2V_RESIDENT_TOL):
        raise AssertionError("the resident buffer disagrees with the float32 download")
    extract_launches = _added(first, rest)
    n_f32 = len(variants) + 1  # the first pass, every float32 variant, the resident pass
    if not per_pass > 0:
        raise AssertionError("the first float32 extraction launched no encoder batch's kernels")
    # the bfloat16 pass's batches (and its warm-up's) launch nothing
    check_launches("w2v extractions", extract_launches,
                   {"w2v2-batch": n_f32 * per_pass, "w2v2-batch-bf16": per_pass})
    groups = participant_clips(interview)
    grp, regroup_s = _synced(lambda: res.regroup(groups))
    host = concat_groups(f32, groups)
    want = loops.ResidentCorpus(host, device=dev).device_corpus()
    equal = grp.names == list(host) and torch.equal(grp.x, want.x)
    log(f"[w2v] regroup into {len(grp)} participants {tuple(grp.x.shape)}: {regroup_s * 1e3:.3f} "
        f"ms; equal to the host concatenation of the downloads, uploaded: {equal}")
    if not equal:
        raise AssertionError("the regrouped buffer differs from host aggregation")
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"[w2v] peak memory of the extractions: {peak_gib:.3f} GiB")

    # --- the CV engine on the extractor's corpus
    label_of = {r["unique_participant_id"]: r["label"] for r in interview}
    y = np.asarray([label_of[p] == "Patient" for p in grp.names], np.int64)
    X = loops.DeviceCorpus.from_resident(grp).view(np.arange(len(grp)))
    with _CvProbe() as probe:
        with count_launches() as launches:
            (results, preds, hists, weights), cv_s = _synced(
                lambda: dl_cv.standard_kfold_cv(X, y, FLAGSHIP_HP, device=dev, **W2V_CV))
        _check_cv_launches("w2v", launches, probe)
        uploads = list(probe.uploads)
    limit = 8 * len(y) * W2V_CV["epochs"]
    log(f"[w2v] standard_kfold_cv over the extractor's corpus: {cv_s:.3f} s; uploads during "
        f"the folds: {len(uploads)} arrays, largest {max(uploads)} B (limit {limit} B)")
    if max(uploads) > limit:
        raise AssertionError("a CV fold uploaded more than its labels and batch plan")
    ok = (len(results) == W2V_CV["n_splits"] and np.isfinite(weights).all()
          and all(np.isfinite(h["train"] + h["val"]).all() for h in hists)
          and sum(len(p["y_true"]) for p in preds) == len(y))
    if not ok:
        raise AssertionError("the CV results over the extractor's corpus are not finite")
    _, _, hists_up, _ = dl_cv.standard_kfold_cv(want.view(np.arange(len(grp))), y, FLAGSHIP_HP,
                                                device=dev, **dict(W2V_CV, epochs=1))
    first = (hists[0]["train"][0], hists[0]["val"][0])
    again = (hists_up[0]["train"][0], hists_up[0]["val"][0])
    err = max(abs(a - b) for a, b in zip(first, again))
    log(f"[w2v] fold 1 first-epoch train/val loss: extractor's corpus {first}, uploaded "
        f"sequences {again}: max|d|={err:.3e} (tol {W2V_CV_TOL})")
    if not err <= W2V_CV_TOL:
        raise AssertionError("training on the extractor's corpus differs from the upload")

    # --- the transfer dtypes against the card's own float32 path
    def cos(a, b):
        a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
        return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))

    bad = []
    for name, a in f32.items():
        fmax = np.abs(a).max(axis=1, keepdims=True)
        d16 = np.abs(a - out["int16"][name])
        if not (np.linalg.norm(d16) / np.linalg.norm(a) <= 1e-4
                and (d16 <= fmax * (1.0 / 65534.0 + 2e-6) + 1e-9).all()):
            bad.append(("int16", name))
        floor = 1e-3 * float(np.abs(a).max())
        if not np.max(np.abs(a - out["int24"][name]) / np.maximum(np.abs(a), floor)) <= 1e-4:
            bad.append(("int24", name))
        if not ((np.abs(a - out["int8"][name]) <= fmax / 254.0 + 1e-3 * fmax + 1e-7).all()
                and cos(a, out["int8"][name]) > 0.9999):
            bad.append(("int8", name))
        for label in ("float16", "bfloat16"):
            if not 1.0 - cos(a, out[label][name]) <= 1e-2:
                bad.append((label, name))
    worst = {label: min(cos(a, out[label][n]) for n, a in f32.items())
             for label in ("int8", "float16", "bfloat16")}
    lattice = {n: w for n, w in clips.items() if formats[n] == "pcm16"}
    a = extractor.extract_sequences(lattice, verbose=False)
    b = variant(upload_dtype=np.int16).extract_sequences(lattice, verbose=False)
    upload_equal = all(np.array_equal(a[n], b[n]) for n in a)
    log(f"[w2v] transfer contracts vs the float32 path: {len(bad)} violations {bad[:4]}; "
        f"lowest cosine {worst}; int16 upload bit-equal on {len(lattice)} PCM clips: "
        f"{upload_equal}")
    if bad or not upload_equal:
        raise AssertionError("a transfer dtype breaks its contract")

    # --- embeddings and one predict_files request
    (names, means), emb_s = _synced(lambda: extractor.extract_embeddings_arrays(clips,
                                                                                verbose=False))
    err = float(np.abs(means - np.stack([f32[n].mean(0) for n in names])).max())
    log(f"[w2v] extract_embeddings_arrays: {emb_s:.3f} s ({clip_s / emb_s:.1f} audio-s/s), "
        f"{means.shape}; vs the float32 sequences' means max|d|={err:.3e} (tol {W2V_EMB_TOL})")
    if not (names == list(f32) and err <= W2V_EMB_TOL):
        raise AssertionError("the embeddings disagree with the sequences' means")
    predictor = Predictor(build_cnn_lstm(W2V_CONFIG.hidden_size, 128, 128, seed=0, device=dev),
                          extractor=extractor, device=dev)
    row = next(r for r in interview if formats[r["filename"]] == "stereo44k")
    native = predictor.predict_files([row["filepath"]])[row["filename"]].logits
    seq = extractor.extract_sequences(load_files_mono_16k([row["filepath"]]),
                                      verbose=False)[row["filename"]]
    codec = predictor.predict_sequence(seq).logits
    err = float(np.abs(native - codec).max())
    log(f"[w2v] predict_files({row['filename']}, 44.1 kHz stereo): logits {native} via the "
        f"native decoder, {codec} via the Python codec: max|d|={err:.3e} (tol {W2V_PREDICT_TOL})")
    if not err <= W2V_PREDICT_TOL:
        raise AssertionError("predict_files through the native decoder changed its answer")

    # --- where an encoder batch spends the card's time
    rng = np.random.default_rng(0)
    batch = torch.from_numpy(rng.standard_normal((W2V_BATCH, extractor.chunk_size),
                                                 dtype=np.float32) * 0.1).to(dev)
    lengths = torch.full((W2V_BATCH,), extractor.chunk_size, dtype=torch.int32, device=dev)

    def encode():
        with torch.no_grad():
            extractor.model(batch, lengths)

    encode_ms = cuda_ms(encode, 3)
    log(f"[w2v] one encoder batch ({W2V_BATCH} x {extractor.chunk_size} samples, float32): "
        f"{encode_ms:.3f} ms (CUDA events, mean of 3), "
        f"{W2V_BATCH * extractor.chunk_size / SR / (encode_ms / 1e3):.1f} audio-s/s")
    profile_device(f"one encoder batch ({W2V_BATCH} x {extractor.chunk_size} samples, float32)",
                   encode, 14)
    return _added(extract_launches, launches)


# --- wavlm: WavLM-Large extraction ------------------------------------------------

# reading recordings in 16 s chunks every 15 s: 21 chunks, two encoder batches
# of 16, short last chunks (13, 10, 7, 7, 5 and 9.5 s)
WAVLM_READING_S = (88.0, 70.0, 52.0, 37.0, 20.0, 9.5)


def wavlm_phase(dev: torch.device) -> dict:
    """WavLM-Large extraction (the WavLM cell's path): :func:`large_extraction_phase`
    with a full-width ``WavLMConfig``, a WavLM encoder-batch unit of launches
    a batch (the biased softmax once a layer, the positional conv once).
    Returns the launches."""
    from robust_speech_analysis_framework_tpu_torch.models.wavlm import WavLMConfig

    return large_extraction_phase(dev, "wavlm", WavLMConfig(), "wavlm-batch")


def conformer_phase(dev: torch.device) -> dict:
    """Wav2Vec2-Conformer-Large extraction (the Conformer cell's path):
    :func:`large_extraction_phase` with a full-width ``ConformerConfig``, a
    Conformer encoder-batch unit of launches a batch (the shifted softmax once
    a layer, conv_1–6 once each). Returns the launches."""
    from robust_speech_analysis_framework_tpu_torch.models.conformer import ConformerConfig

    return large_extraction_phase(dev, "conformer", ConformerConfig(), "conformer-batch")


def large_extraction_phase(dev: torch.device, label: str, config, unit: str) -> dict:
    """A full-width random-init extractor of ``config`` (16 s chunks every
    15 s, batches of 16, float32) over six speech-like reading recordings
    through ``extract_sequences``, ``extract_sequences_resident`` and
    ``extract_embeddings_arrays``, ``unit`` of launches (``UNIT_LAUNCHES``)
    each encoder batch; (T, hidden) rows; the resident buffer and the
    embeddings against the sequences; walls and peak memory. Returns the
    launches."""
    extractor = Wav2Vec2Extractor(config=config, chunk_seconds=16.0, overlap_seconds=1.0,
                                  batch_size=W2V_BATCH, allow_random_init=True, seed=0,
                                  device=dev)
    waves = {f"r{i}": _speech(sec, 100 + 20 * i, 40 + i) for i, sec in enumerate(WAVLM_READING_S)}
    audio_s = sum(WAVLM_READING_S)
    _, first_s = _synced(lambda: extractor.extract_sequences(waves, verbose=False))
    encodes = [0]
    real_encode = extractor._encode

    def counting_encode(*args):
        encodes[0] += 1
        return real_encode(*args)

    torch.cuda.reset_peak_memory_stats(dev)
    with count_launches() as launches:
        extractor._encode = counting_encode
        try:
            seqs, seq_s = _synced(lambda: extractor.extract_sequences(waves, verbose=False))
            res, res_s = _synced(lambda: extractor.extract_sequences_resident(waves,
                                                                              verbose=False))
            (names, means), emb_s = _synced(lambda: extractor.extract_embeddings_arrays(
                waves, verbose=False))
        finally:
            del extractor._encode  # the bound method again
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[{label}] {len(waves)} reading recordings ({audio_s:.1f} audio-s) in 16 s chunks: "
        f"extract_sequences {seq_s:.3f} s ({audio_s / seq_s:.1f} audio-s/s; first, cold "
        f"{first_s:.3f} s), extract_sequences_resident {res_s:.3f} s, "
        f"extract_embeddings_arrays {emb_s:.3f} s; peak memory {peak / 1e9:.2f} GB")
    if not encodes[0] > 0:
        raise AssertionError(f"the {label} extractions ran no encoder batch")
    check_launches(label, launches, {unit: encodes[0]}, config)
    shapes = {n: seqs[n].shape for n in waves}
    frames = {n: int(res.lengths[res.row(n)]) for n in waves}
    res_err = max(float(np.abs(res[n] - seqs[n]).max()) for n in waves)
    emb_err = float(np.abs(means - np.stack([seqs[n].mean(0) for n in names])).max())
    log(f"[{label}] sequences {shapes}; resident rows vs the sequences max|d|={res_err:.3e} (tol "
        f"{W2V_RESIDENT_TOL}); embeddings {means.shape} vs the sequences' means "
        f"max|d|={emb_err:.3e} (tol {W2V_EMB_TOL})")
    if not (all(shapes[n] == (frames[n], config.hidden_size) for n in waves)
            and all(np.isfinite(seqs[n]).all() for n in waves) and names == list(waves)
            and res_err <= W2V_RESIDENT_TOL and emb_err <= W2V_EMB_TOL):
        raise AssertionError(f"the {label} entry points disagree with one another")
    del extractor, res
    torch.cuda.empty_cache()
    return launches


# --- experiments: the battery end to end ------------------------------------------

# The CNN-LSTM half's depth, cut from the JAX package's defaults (5 folds,
# 25 trials in rounds of 8, 3 inner folds of 15 epochs, 50/100 epochs):
# one round of 8 trials, 2 folds everywhere, 2 epochs
EXP_CUT = dict(n_trials=8, trial_batch=8, nested_epochs=2, nested_patience=10,
               standard_epochs=2, standard_patience=25, batch_size=8, n_splits=2,
               n_splits_outer=2, n_splits_inner=2, inner_epochs=2)
# the card's batched SMO vs the float64 host solver, per fold: metrics
# (no prediction flips) and AUC as tests/test_svm_cv.py:80-121 bound the JAX
# package's device solver, selections equal. Probabilities: SVM_PROB_TOL,
# not that test's 2e-4. The float32 and float64 solvers stop at different
# points inside the stopping rule's 1e-3 band and Platt's slope scales the
# decision values' difference (tests/test_torch_svm_cv.py: on separable data
# the JAX package's own device run lies 0.134 from its host run); on this
# corpus the card's batched run lay 3.482e-4 from the host run (H100)
SVM_METRIC_TOL, SVM_AUC_TOL = 1e-9, 1e-6
SVM_PROB_TOL = 2e-3


class _SmoProbe:
    """Records each batched SMO call of the SVM engines: lanes, per-lane
    iterations, the loop's steps and host reads, and its wall time
    (synchronised)."""

    def __init__(self):
        from robust_speech_analysis_framework_tpu_torch.eval import svm_cv
        from robust_speech_analysis_framework_tpu_torch.models import svm_device

        self.module, self.solver, self.real = svm_cv, svm_device, svm_cv.smo_linear_batch
        self.calls = []

    def __enter__(self):
        def timed(X, *args, **kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = self.real(X, *args, **kwargs)
            torch.cuda.synchronize()
            self.calls.append({"lanes": X.shape[0], "shape": X.shape, "iters": out[2],
                               "steps": self.solver.smo_linear_batch.steps,
                               "syncs": self.solver.smo_linear_batch.syncs,
                               "ms": (time.perf_counter() - start) * 1e3,
                               "call": (X, args, kwargs), "out": out})
            return out

        self.module.smo_linear_batch = timed
        return self

    def __exit__(self, *exc):
        self.module.smo_linear_batch = self.real


def _svm_rows_agree(name, card, host):
    """(worst metric, worst AUC, worst probability) differences of one
    experiment; an AssertionError where the selections differ."""
    worst = [0.0, 0.0, 0.0]
    for a, b in zip(card["results_df"], host["results_df"]):
        if a["selected_features"] != b["selected_features"] or \
                a.get("best_k_found") != b.get("best_k_found"):
            raise AssertionError(f"{name}: the card's SMO selected other features or k")
        worst[0] = max(worst[0], *(abs(a[m] - b[m]) for m in
                                   ("accuracy", "f1_score", "precision", "recall")))
        worst[1] = max(worst[1], abs(a["auc"] - b["auc"]))
    for p, q in zip(card["predictions"], host["predictions"]):
        worst[2] = max(worst[2], float(np.abs(p["y_prob"] - q["y_prob"]).max()))
    return worst


def experiments_phase(dev: torch.device, tmp: str) -> dict:
    """The reference's whole workflow on the card through the experiment
    cores: the w2v phase's corpus → MSHDS-25, openSMILE-912 and a full-width
    Wav2Vec2-base of both tasks (a pitch-pass unit of launches a pitch pass
    of MSHDS, a sub-batch unit an openSMILE sub-batch, a float32
    encoder-batch unit as many as the first-block kernel counts) → the 9 SVM
    datasets and the 18 SVM experiments on the batched SMO on the card (no
    kernel launched; each SMO call's lanes, iterations, host syncs and ms a
    step) against the float64 host solver (metrics SVM_METRIC_TOL, AUC
    SVM_AUC_TOL, probabilities SVM_PROB_TOL, selections equal) and
    bit-equal with TF32 allowed → the 6 CNN-LSTM experiments at the
    flagship's input width with ``trial_batch=8`` and the 3 final models,
    depth cut (EXP_CUT; step and eval units), 24 complete finite results and
    3 final models that ``Predictor.from_checkpoint`` loads; the wall of each
    extraction, of the SVM half and of each CNN-LSTM experiment, and peak
    memory. Returns each kernel's launches over the phase."""
    from robust_speech_analysis_framework_tpu_torch import experiments as exp_mod
    from robust_speech_analysis_framework_tpu_torch.audio import native_io
    from robust_speech_analysis_framework_tpu_torch.data.corpus import load_androids_rows
    from robust_speech_analysis_framework_tpu_torch.ops import shs_pitch

    phase_t0 = time.perf_counter()
    reading, interview = load_androids_rows(tmp, verbose=False)
    extractor = Wav2Vec2Extractor(config=W2V_CONFIG, allow_random_init=True, seed=0,
                                  batch_size=W2V_BATCH, device=dev)

    # --- extraction half, one core call: every extractor call timed
    # (synchronised), K6/K7 once per pitch pass (MSHDS) or sub-batch (openSMILE)
    calls = collections.defaultdict(list)  # label → (wall s, result) per call, reading first
    passes = {"mshds": [], "opensmile": []}

    def timed(label, fn):
        def call(*args, **kwargs):
            out, wall = _synced(lambda: fn(*args, **kwargs))
            calls[label].append((wall, out))
            return out
        return call

    def counted(label, fn):
        def path(*args, **kwargs):
            passes[label].append(args[0].shape)
            return fn(*args, **kwargs)
        return path

    real_arrays = opensmile_mod.OpenSmileExtractor.extract_arrays
    patched = [(native_io, "load_corpus_mono_16k", timed("decode", native_io.load_corpus_mono_16k)),
               (mshds_mod, "extract_mshds_arrays", timed("mshds", mshds_mod.extract_mshds_arrays)),
               (opensmile_mod.OpenSmileExtractor, "extract_arrays",
                lambda self, *a, **k: timed("opensmile", real_arrays)(self, *a, **k)),
               (extractor, "extract_sequences", timed("wav2vec2", extractor.extract_sequences)),
               (mshds_pitch, "viterbi_path", counted("mshds", mshds_pitch.viterbi_path)),
               (shs_pitch, "viterbi_path", counted("opensmile", shs_pitch.viterbi_path))]
    real = [getattr(obj, name) for obj, name, _ in patched]
    torch.cuda.reset_peak_memory_stats(dev)
    with count_launches() as extract_launches:
        for obj, name, fn in patched:
            setattr(obj, name, fn)
        try:
            artifacts = [*exp_mod.TABLE_ARTIFACTS.values(), *exp_mod.SEQUENCE_ARTIFACTS.values()]
            (tables, seqs), extract_s = _synced(lambda: exp_mod.extract_tables(
                reading, interview, artifacts, wav2vec2_extractor=extractor, verbose=False,
                device=dev))
        finally:
            for (obj, name, _), fn in zip(patched, real):
                setattr(obj, name, fn)
            del extractor.extract_sequences  # the bound method again
    peak_extract = torch.cuda.max_memory_allocated(dev) / 2**30
    waves = {**calls["decode"][0][1], **calls["decode"][1][1]}
    audio_s = {task: sum(len(waves[r["filename"]]) for r in rows) / SR
               for task, rows in (("reading", reading), ("interview", interview))}
    log(f"[experiments] corpus: {len(reading)} reading files ({audio_s['reading']:.1f} "
        f"audio-s), {len(interview)} interview clips ({audio_s['interview']:.1f} audio-s); "
        f"extract_tables of every artifact {extract_s:.3f} s, of it native decode "
        f"{sum(w for w, _ in calls['decode']):.3f} s")
    for fs in exp_mod.FEATURE_SETS:
        for task, (wall, _) in zip(exp_mod.TASKS, calls[fs]):
            tab = tables[exp_mod.TABLE_ARTIFACTS[fs, task]]
            log(f"[experiments] extract {fs}/{task}: {wall:.3f} s ({audio_s[task] / wall:.1f} "
                f"audio-s/s), table {tab.values.shape}, "
                f"{int(np.isnan(tab.values).sum())} NaN values")
    opensmile = opensmile_mod.OpenSmileExtractor(device=dev)
    n_sub = 0
    for rows in (reading, interview):
        per_bucket = collections.Counter(opensmile._bucket_of(len(waves[r["filename"]]))
                                         for r in rows)
        n_sub += sum(-(-n // opensmile.pipeline_rows) for n in per_bucket.values())
    n_encoder = extract_launches["conv0_norm_gelu"]  # one an encoder batch
    log(f"[experiments] pitch passes: MSHDS {len(passes['mshds'])} in {len(calls['mshds'])} "
        f"calls (2 + 3 a range group each), openSMILE {len(passes['opensmile'])} (expected "
        f"{n_sub} sub-batches); {n_encoder} Wav2Vec2 encoder batches; peak memory "
        f"{peak_extract:.3f} GiB")
    if not (n_encoder > 0 and len(passes["opensmile"]) == n_sub and len(calls["mshds"]) == 2
            and len(passes["mshds"]) in (10, 13, 16)):
        raise AssertionError("the extractions ran no Wav2Vec2 encoder batch, or not one pitch "
                             "pass an openSMILE sub-batch and 2 + 3 a range group of MSHDS")
    check_launches("experiments extraction", extract_launches, {
        "mshds-pitch-pass": len(passes["mshds"]), "opensmile-sub-batch": n_sub,
        "w2v2-batch": n_encoder})
    rows_of = {"reading": len(reading), "interview": len({r["unique_participant_id"]
                                                         for r in interview})}
    for (fs, task), name in exp_mod.TABLE_ARTIFACTS.items():
        if len(tables[name].meta) != rows_of[task] or not np.isfinite(tables[name].values).any():
            raise AssertionError(f"the {fs}/{task} table is misshapen or empty")

    # --- SVM half: 9 datasets, 18 experiments on the card's batched SMO
    t0 = time.perf_counter()
    datasets = exp_mod.svm_datasets(
        {fs: tables[exp_mod.TABLE_ARTIFACTS[fs, "reading"]] for fs in exp_mod.FEATURE_SETS},
        {fs: tables[exp_mod.TABLE_ARTIFACTS[fs, "interview"]] for fs in exp_mod.FEATURE_SETS})
    log(f"[experiments] 9 SVM datasets in {time.perf_counter() - t0:.3f} s: "
        + ", ".join(f"{k} {d.X.shape}" for k, d in datasets.items()))
    with count_launches() as svm_launches, _SmoProbe() as smo:
        card, svm_s = _synced(lambda: exp_mod.svm_experiments(datasets, device=dev,
                                                              verbose=False))
    check_launches("experiments svm", svm_launches, {})
    for i, c in enumerate(smo.calls):
        it = c["iters"]
        log(f"[experiments] SMO call {i}: {c['lanes']} lanes {tuple(c['shape'])}, iterations "
            f"median {float(np.median(it)):.0f} max {int(it.max())}, {c['steps']} steps, "
            f"{c['syncs']} host syncs, {c['ms']:.3f} ms ({c['ms'] / c['steps']:.4f} ms a step)")
    smo_ms = sum(c["ms"] for c in smo.calls)
    log(f"[experiments] SVM half (18 experiments, batched SMO on the card): {svm_s:.3f} s, "
        f"of it {len(smo.calls)} SMO calls {smo_ms / 1e3:.3f} s")
    # the longest call again, its steps launched one by one instead of
    # replayed as CUDA graphs: the same bits, and what the graphs save
    longest = max(smo.calls, key=lambda c: c["steps"])
    X, args, kwargs = longest["call"]
    real_loop = smo.solver._loop_graph
    smo.solver._loop_graph = smo.solver._loop_eager
    try:
        eager, eager_s = _synced(lambda: smo.real(X, *args, **kwargs))
    finally:
        smo.solver._loop_graph = real_loop
    same = all(np.array_equal(a, b) for a, b in zip(eager, longest["out"]))
    log(f"[experiments] the longest SMO call ({longest['steps']} steps) eager: "
        f"{eager_s * 1e3:.3f} ms ({eager_s * 1e3 / longest['steps']:.4f} ms a step) against "
        f"{longest['ms']:.3f} ms replayed as graphs; bit-equal: {same}")
    if not same:
        raise AssertionError("the SMO's CUDA graphs changed its result")
    host, host_s = _synced(lambda: exp_mod.svm_experiments(datasets, solver="host", device=dev,
                                                           verbose=False))
    log(f"[experiments] the same 18 on the float64 host solver: {host_s:.3f} s")
    diffs = {name: _svm_rows_agree(name, card[name], host[name]) for name in host}
    worst = np.max(list(diffs.values()), axis=0)
    top = sorted(diffs, key=lambda k: -diffs[k][2])[:4]
    log(f"[experiments] card SMO vs host: max |d| metrics {worst[0]:.3e} (tol "
        f"{SVM_METRIC_TOL}), AUC {worst[1]:.3e} (tol {SVM_AUC_TOL}), y_prob {worst[2]:.3e} (tol "
        f"{SVM_PROB_TOL}; largest: " + ", ".join(f"{k} {diffs[k][2]:.3e}" for k in top)
        + "); selected features and best k equal")
    if not (worst[0] <= SVM_METRIC_TOL and worst[1] <= SVM_AUC_TOL and worst[2] <= SVM_PROB_TOL):
        raise AssertionError("the card's batched SMO disagrees with the host solver")
    saved = _tf32_flags()
    torch.backends.cuda.matmul.fp32_precision = "tf32"
    torch.backends.cudnn.conv.fp32_precision = "tf32"
    try:
        tf32 = exp_mod.svm_experiments(datasets, device=dev, verbose=False)
    finally:
        torch.backends.cuda.matmul.fp32_precision, torch.backends.cudnn.conv.fp32_precision = \
            saved[:2]
    same = all(a["results_df"] == b["results_df"] and all(
        np.array_equal(p["y_prob"], q["y_prob"]) for p, q in zip(a["predictions"],
                                                                b["predictions"]))
        for a, b in zip(card.values(), tf32.values()))
    log(f"[experiments] the battery with TF32 allowed is bit-equal to IEEE float32: {same}")
    n_folds = {"standard": 5, "nested": 5}
    ok = (len(card) == 18 and same and all(
        len(r["results_df"]) == n_folds[k.rsplit("_", 1)[1]] and all(
            np.isfinite([row[m] for m in ("accuracy", "f1_score", "auc")]).all()
            for row in r["results_df"]) for k, r in card.items()))
    if not ok:
        raise AssertionError("the SVM battery is incomplete, not finite or changed under TF32")
    for name in ("mshds_reading", "opensmile_combined", "wav2vec2_interview"):
        for mode in ("standard", "nested"):
            rows = card[f"{name}_{mode}"]["results_df"]
            log(f"[experiments] {name}_{mode}: accuracy "
                f"{np.mean([r['accuracy'] for r in rows]):.3f}, AUC "
                f"{np.mean([r['auc'] for r in rows]):.3f}")

    # --- CNN-LSTM half: 6 experiments and 3 final models on the lane-batched engines
    sets, meta = exp_mod.sequence_sets(reading, interview,
                                       seqs[exp_mod.SEQUENCE_ARTIFACTS["reading"]],
                                       seqs[exp_mod.SEQUENCE_ARTIFACTS["interview"]])
    log(f"[experiments] sequence sets: " + ", ".join(
        f"{k} {len(v)} x (T, {W2V_CONFIG.hidden_size}) T in [{min(map(len, v.values()))}, "
        f"{max(map(len, v.values()))}]" for k, v in sets.items())
        + f"; depth cut to {EXP_CUT}")
    exp_walls = []
    real_engines = (dl_cv.nested_cv, dl_cv.standard_kfold_cv, exp_mod._train_final_model)

    def timed(label, real):
        def run(*args, **kwargs):
            out, wall = _synced(lambda: real(*args, **kwargs))
            exp_walls.append((label, wall))
            return out
        return run

    dl_cv.nested_cv = timed("tuned", real_engines[0])
    dl_cv.standard_kfold_cv = timed("standard", real_engines[1])
    exp_mod._train_final_model = timed("final model", real_engines[2])
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        with _CvProbe() as probe, count_launches() as dl_launches:
            results, dl_s = _synced(lambda: exp_mod.cnn_lstm_experiments(
                sets, meta, os.path.join(tmp, "results"), models_dir=os.path.join(tmp, "models"),
                verbose=False, device=dev, **EXP_CUT))
        _check_cv_launches("experiments", dl_launches, probe)
    finally:
        dl_cv.nested_cv, dl_cv.standard_kfold_cv, exp_mod._train_final_model = real_engines
    peak_dl = torch.cuda.max_memory_allocated(dev) / 2**30
    kinds = list(sets)
    for i, (label, wall) in enumerate(exp_walls):
        log(f"[experiments] {label} {kinds[i // 3]}: {wall:.3f} s")
    log(f"[experiments] CNN-LSTM half: {dl_s:.3f} s, {len(probe.lane_steps)} lane steps, "
        f"{len(probe.steps)} train steps; peak memory {peak_dl:.3f} GiB")
    want = {"tuned": EXP_CUT["n_splits_outer"], "standard": EXP_CUT["n_splits"]}
    for key, r in results.items():
        rows = r["results_df"]
        if not (len(rows) == want[key.split("_")[0]] and all(
                np.isfinite([row[m] for m in ("accuracy", "f1_score", "auc")]).all()
                for row in rows) and np.isfinite(r["weights"]).all()):
            raise AssertionError(f"the {key} CNN-LSTM experiment is incomplete or not finite")
        log(f"[experiments] {key}: f1 {np.mean([row['f1_score'] for row in rows]):.3f}, AUC "
            f"{np.mean([row['auc'] for row in rows]):.3f}"
            + (f", best params {exp_mod.best_params(rows)}" if key.startswith("tuned") else ""))
    probe_seq = next(iter(sets["reading"].values()))
    for kind in kinds:
        path = os.path.join(tmp, "models", f"final_tuned_cnn_lstm_{kind}.pkl")
        pred = Predictor.from_checkpoint(path, device=dev).predict_sequence(probe_seq)
        if not np.isfinite(pred.logits).all():
            raise AssertionError(f"the final {kind} model does not load or predict")
        log(f"[experiments] final model {kind}: loaded by Predictor.from_checkpoint, "
            f"P(Patient) of a reading sequence {pred.probability:.4f}")
    if len(results) != 6:
        raise AssertionError("the CNN-LSTM battery did not run its 6 experiments")
    log(f"[experiments] phase wall {time.perf_counter() - phase_t0:.3f} s")
    return _added(extract_launches, dl_launches)


# ---------------------------------------------------------------------------
# multidevice: the multi-device code over one card, repeated
# ---------------------------------------------------------------------------

MD_N = 4  # dryrun_multichip(4): dp 2 x mp 2 over [cuda:0] * 4
# the sharded flagship step vs the single-device step, Adam eps PARITY_ADAM_EPS
# (a near-zero gradient's first Adam step would otherwise amplify its last
# bits): loss, parameters (floor: the rate) and BatchNorm statistics relative
# to each tensor's scale, Adam moments to the model's largest; gradients and
# statistics summed in another order, cuDNN at 1 sequence a shard vs 4
MD_STEP_TOL = 1e-5
MD_STEPS = 3  # timed steps of each, after the compared one
MD_LANES = 8
MD_SEQS, MD_FRAMES = 16, (256, 1024)
MD_OS_FILES = 8  # the openSMILE corpus's 8 shortest files: its first sub-batches
MD_MSHDS_FILES = 4  # the MSHDS corpus's longest files: a sub-corpus of 2 keeps the device march
MD_W2V_CLIPS = (3.0, 5.5, 8.9, 12.0)  # seconds: 9 chunks, one batch of W2V_BATCH
# full-width Wav2Vec2-base at dp 2 x mp 2 vs mesh=None, relative to the
# largest magnitude: row-parallel partial products summed over 12 layers
MD_W2V_TOL = 1e-4
MD_W2V_BF16_COS = 0.999  # bf16: partial products each rounded to bfloat16
MD_FILES = [f"f{i}.wav" for i in range(5)]
# the units of work dryrun_multichip, the lanes and the extractors run: no
# encoder batch (the grid's Wav2Vec2 is _md_w2v's, at mp 2 on cuDNN's route)
MD_UNITS = ("cnnlstm-eval", "cnnlstm-step", "opensmile-sub-batch", "mshds-pitch-pass")


def _md_timed(fn):
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - start


def _md_step_check(dev: torch.device, grid) -> None:
    """The sharded flagship step against the single-device step, from the
    same weights, batch and dropout generator; walls of both."""
    from robust_speech_analysis_framework_tpu_torch import entry as entry_mod

    x, lengths, y = entry_mod.dryrun_batch(MD_N)
    trainer = loops.Trainer(CNNLSTM(**entry_mod.FLAGSHIP), adam_eps=PARITY_ADAM_EPS, device=dev)
    sd = {k: v.detach().clone() for k, v in trainer.init_state(0, 1e-3).model.state_dict().items()}
    sharded = loops.ShardedTrainState.shard(trainer.init_state(0, 1e-3, sd), grid)
    single = trainer.init_state(0, 1e-3, sd)

    def gen():
        return torch.Generator(device=dev).manual_seed(1)

    loss_sh = float(loops.sharded_train_step(sharded, x, lengths, y, gen()))
    loss_1 = float(trainer.train_step(single, x, lengths, y, gen()))
    ours, ref = sharded.state_dict(), single.model.state_dict()
    worst = {"loss": abs(loss_sh - loss_1) / abs(loss_1)}
    for name, v in ref.items():
        if v.dtype.is_floating_point:
            floor = 1e-3 if "running" not in name else 1e-30
            worst[name] = float((ours[name] - v).abs().max()) / max(float(v.abs().max()), floor)
    params = dict(single.model.named_parameters())
    moments = sharded.moments()
    for k, key in enumerate(("exp_avg", "exp_avg_sq")):
        scale = max(float(single.optimizer.state[params[n]][key].abs().max()) for n in moments)
        for n, pair in moments.items():
            worst[f"{n}:{key}"] = float(
                (pair[k] - single.optimizer.state[params[n]][key]).abs().max()) / scale
    name = max(worst, key=worst.get)
    walls_sh = [_md_timed(lambda: loops.sharded_train_step(sharded, x, lengths, y, gen()))[1]
                for _ in range(MD_STEPS)]
    walls_1 = [_md_timed(lambda: trainer.train_step(single, x, lengths, y, gen()))[1]
               for _ in range(MD_STEPS)]
    log(f"[multidevice] sharded flagship step (dp 2 x mp 2, B={MD_N} T=32, dropout on, Adam eps "
        f"{PARITY_ADAM_EPS}) vs the single-device step: loss {loss_sh:.7f} vs {loss_1:.7f}; worst "
        f"relative difference {worst[name]:.3e} at {name} over {len(worst)} checks (tol "
        f"{MD_STEP_TOL}); step wall median {statistics.median(walls_sh) * 1e3:.3f} ms sharded vs "
        f"{statistics.median(walls_1) * 1e3:.3f} ms single")
    if worst[name] > MD_STEP_TOL:
        raise AssertionError("the sharded train step disagrees with the single-device step")


def _md_trials(dev: torch.device, grid) -> None:
    """8 lanes over dp = 2 against dp = 1, lane by lane."""
    rng = np.random.default_rng(11)
    seqs = [rng.standard_normal((int(n), DIM), dtype=np.float32)
            for n in rng.integers(MD_FRAMES[0], MD_FRAMES[1] + 1, size=MD_SEQS)]
    labels = np.arange(MD_SEQS) % 2
    for s, lab in zip(seqs, labels):
        s[:, :16] += 0.3 * lab
    view = loops.DeviceCorpus(seqs, device=dev).view(np.arange(MD_SEQS))
    tr, va = view.subset(np.arange(12)), view.subset(np.arange(12, MD_SEQS))
    trainer = loops.Trainer(CNNLSTM(input_dim=DIM, cnn_out_channels=128, lstm_hidden_dim=64,
                                    activation_fn="gelu"), adam_eps=PARITY_ADAM_EPS, device=dev)
    lrs = list(np.geomspace(1e-4, 1e-3, MD_LANES))
    rates = list(np.linspace(0.2, 0.5, MD_LANES))
    cfg = loops.TrainConfig(learning_rate=lrs[0], epochs=2, patience=3, batch_size=4, seed=7,
                            dropout_rate=rates[0], use_plateau=False, restore_best=False)
    out = {}
    for label, mesh in (("dp 1", None), ("dp 2", grid)):
        def run():
            states, hist = loops.train_trials_device(trainer, tr, labels[:12], va, labels[12:],
                                                     cfg, lrs, rates, mesh=mesh)
            logits = trainer.eval_logits_trials_deferred(states, va, cfg).result()
            return hist.result(), logits
        out[label] = _md_timed(run)
    (h1, l1), w1 = out["dp 1"]
    (h2, l2), w2 = out["dp 2"]
    hist_err = max(abs(a - b) / abs(b) for (th1, vh1), (th2, vh2) in zip(h1, h2)
                   for a, b in zip(th2 + vh2, th1 + vh1))
    logit_err = float(np.abs(l2 - l1).max() / np.abs(l1).max())
    log(f"[multidevice] train_trials_device {MD_LANES} lanes (cnn 128, lstm 64, {MD_SEQS} seqs of "
        f"{MD_FRAMES[0]}–{MD_FRAMES[1]} x {DIM}, 2 epochs): dp 2 (two groups of "
        f"{MD_LANES // 2}) vs dp 1: histories max rel {hist_err:.3e}, eval logits max rel "
        f"{logit_err:.3e} (tol {LANE_TOL}); wall {w2:.3f} s vs {w1:.3f} s")
    if not (len(h1) == len(h2) == MD_LANES and hist_err <= LANE_TOL and logit_err <= LANE_TOL
            and all(len(a[0]) == len(b[0]) for a, b in zip(h1, h2))):
        raise AssertionError("lanes split over dp disagree with the single-device lanes")


def _md_extractors(dev: torch.device, grid2) -> None:
    """openSMILE and MSHDS split over two entries of the card against one."""
    corpus = _opensmile_corpus()
    first = dict(sorted(corpus.items(), key=lambda kv: len(kv[1]))[:MD_OS_FILES])
    ex = opensmile_mod.OpenSmileExtractor(device=dev)
    ex.extract_arrays(first, verbose=False)  # first pass: every shape once
    (names1, f1), w1 = _md_timed(lambda: ex.extract_arrays(first, verbose=False))
    (names2, f2), w2 = _md_timed(lambda: ex.extract_arrays(first, verbose=False, mesh=grid2))
    log(f"[multidevice] openSMILE extract_arrays, {MD_OS_FILES} files "
        f"({sum(len(x) for x in first.values()) / SR:.1f} audio-s), mesh dp 2 (a stream each) "
        f"vs none: rows equal {names1 == names2 and np.array_equal(f1, f2)} (max|d| "
        f"{float(np.abs(f1 - f2).max()):.3e}); wall {w2:.3f} s vs {w1:.3f} s")
    if not (names1 == names2 and np.array_equal(f1, f2) and np.isfinite(f2).all()):
        raise AssertionError("openSMILE rows split over dp differ from the single-device rows")

    seconds = np.linspace(MSHDS_MIN_S, MSHDS_MAX_S, MSHDS_FILES)[-MD_MSHDS_FILES:]
    f0s = np.linspace(*MSHDS_F0, MSHDS_FILES)[-MD_MSHDS_FILES:]
    xs = [_speech(s, f0, 200 + i).astype(np.float64) for i, (s, f0) in enumerate(zip(seconds, f0s))]
    mshds_mod.extract_mshds_arrays(xs, SR, device=dev)  # first pass
    m1, w1 = _md_timed(lambda: mshds_mod.extract_mshds_arrays(xs, SR, device=dev))
    m2, w2 = _md_timed(lambda: mshds_mod.extract_mshds_arrays(xs, SR, devices=[dev, dev]))
    log(f"[multidevice] MSHDS-25, {MD_MSHDS_FILES} files of {seconds[0]:.1f}–{seconds[-1]:.1f} s, "
        f"devices=[{dev}] * 2 (a sub-corpus and a host thread each) vs one device, feature by "
        f"feature (MSHDS_TOL): wall {w2:.3f} s vs {w1:.3f} s")
    mshds_card_vs_cpu(m2, m1, seconds, f0s, labels=("2 devices", "1 device"))


def _md_w2v(dev: torch.device, grid) -> None:
    """The full-width Wav2Vec2-base extractor at dp 2 x mp 2 against
    mesh=None at every transfer dtype, the resident buffer and bf16."""
    clips = {f"c{i}.wav": _speech(s, 120 + 20 * i, 300 + i) for i, s in enumerate(MD_W2V_CLIPS)}
    for cdt in ("float32", "bfloat16"):
        kw = dict(config=W2V_CONFIG, allow_random_init=True, batch_size=W2V_BATCH,
                  compute_dtype=cdt)
        one = Wav2Vec2Extractor(device=dev, **kw)
        split = Wav2Vec2Extractor(mesh=grid, **kw)
        transfers = {"float32": np.float32, **W2V_TRANSFERS} if cdt == "float32" \
            else {"float32": np.float32}
        for tname, tdtype in transfers.items():
            one.transfer = split.transfer = w2v_transfer_name(tdtype)
            split.extract_sequences(clips, verbose=False)  # first pass
            a, w1 = _md_timed(lambda: one.extract_sequences(clips, verbose=False))
            b, w2 = _md_timed(lambda: split.extract_sequences(clips, verbose=False))
            ref = np.concatenate([a[k] for k in sorted(a)])
            got = np.concatenate([b[k] for k in sorted(b)])
            scale = float(np.abs(ref).max())
            err = float(np.abs(got - ref).max()) / scale
            cos = float((ref * got).sum() / np.sqrt((ref * ref).sum() * (got * got).sum()))
            step = {"int16": 1 / 32767, "int24": 1 / (32767 * 254), "int8": 1 / 127,
                    "float16": 2.0 ** -11}.get(tname, 0.0)
            ok = sorted(a) == sorted(b) and (cos >= MD_W2V_BF16_COS if cdt == "bfloat16"
                                             else err <= MD_W2V_TOL + step)
            log(f"[multidevice] Wav2Vec2-base {cdt}, {tname} download, dp 2 x mp 2 vs mesh=None "
                f"over {len(clips)} clips ({sum(MD_W2V_CLIPS):.1f} s): max|d| / max {err:.3e}, "
                f"cosine {cos:.9f} (tol {MD_W2V_BF16_COS if cdt == 'bfloat16' else MD_W2V_TOL + step:.3g}); "
                f"wall {w2:.3f} s vs {w1:.3f} s{'' if ok else '  <-- FAILS'}")
            if not ok:
                raise AssertionError(f"Wav2Vec2 split over the grid disagrees ({cdt}, {tname})")
        if cdt == "float32":
            one.transfer = split.transfer = "float32"
            ra = one.extract_sequences_resident(clips, verbose=False)
            rb = split.extract_sequences_resident(clips, verbose=False)
            r_err = float((rb.x - ra.x).abs().max()) / float(ra.x.abs().max())
            log(f"[multidevice] resident buffer through the grid: {tuple(rb.x.shape)} on "
                f"{rb.x.device}, max|d| / max {r_err:.3e} (tol {MD_W2V_TOL})")
            if not (rb.x.shape == ra.x.shape and r_err <= MD_W2V_TOL):
                raise AssertionError("the resident Wav2Vec2 buffer through the grid disagrees")
        del one, split
        torch.cuda.empty_cache()


def _md_multihost(dev: torch.device, tmp: str) -> None:
    """The multi-host helpers over a world of one, over NCCL."""
    import torch.distributed as dist

    from robust_speech_analysis_framework_tpu_torch.parallel import distributed

    saved = os.environ.get("WORLD_SIZE")
    os.environ["WORLD_SIZE"] = "1"
    try:
        joined = distributed.initialize_distributed()
    finally:
        if saved is None:
            del os.environ["WORLD_SIZE"]
        else:
            os.environ["WORLD_SIZE"] = saved
    if joined:
        raise AssertionError("initialize_distributed joined a world of one")
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'store')}",
                            world_size=1, rank=0, device_id=dev)
    try:
        gathered = distributed.all_gather_host_objects({"rank": 0, "files": len(MD_FILES)})
        files = distributed.shard_file_list(MD_FILES)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    log(f"[multidevice] initialize_distributed with WORLD_SIZE=1: False; a world of one over "
        f"{backend}: all_gather_host_objects {gathered}, shard_file_list kept {len(files)} of "
        f"{len(MD_FILES)} files; group destroyed")
    if not (backend == "nccl" and gathered == [{"rank": 0, "files": len(MD_FILES)}]
            and files == MD_FILES):
        raise AssertionError("the multi-host helpers over a world of one")


def multidevice_phase(dev: torch.device, tmp: str) -> dict:
    """The multi-device code on one card: the grid repeats the card, so each
    split is cut, run and gathered for real, and each wall beside its
    single-device wall measures the code's overhead, not multi-GPU speed.
    ``dryrun_multichip(4)`` over ``[cuda:0] * 4`` (a dp 2 x mp 2 sharded
    flagship train step, a dp-split openSMILE frame stage, lane-split
    trials, the CLI's extraction core over the grid), the lanes and the
    extractors below launch every kernel of the units in MD_UNITS and none
    that no unit launches; the sharded step against the single-device step
    from the same weights (MD_STEP_TOL) with both walls;
    ``train_trials_device`` of 8 lanes over dp 2 against dp 1 (LANE_TOL);
    openSMILE ``extract_arrays`` of the corpus's first sub-batches over dp 2
    (rows bit-equal) and MSHDS ``devices=[cuda:0] * 2`` over four files
    (MSHDS_TOL); the full-width Wav2Vec2-base at dp 2 x mp 2 against
    ``mesh=None`` at every transfer dtype, its resident buffer, and bf16;
    ``initialize_distributed`` with ``WORLD_SIZE=1`` and the multi-host
    helpers over an NCCL world of one opened on a ``file://`` store."""
    from robust_speech_analysis_framework_tpu_torch import entry as entry_mod
    from robust_speech_analysis_framework_tpu_torch.parallel import make_mesh

    log("[multidevice] every grid below repeats one card: its walls measure the split's "
        "overhead beside the single-device walls, not multi-GPU speed")
    grid = make_mesh(devices=[dev] * MD_N, mp=2)
    grid2 = make_mesh(devices=[dev] * 2)
    with count_launches() as launches:
        out, wall = _md_timed(lambda: entry_mod.dryrun_multichip(MD_N, devices=[dev] * MD_N,
                                                                 verbose=False))
        log(f"[multidevice] dryrun_multichip({MD_N}) over {[str(d) for d in grid.devices]}: "
            f"mesh {out['grid'].shape}, sharded flagship step loss {out['loss']:.4f}, lane "
            f"logits {out['lane_logits'].shape}, extract rows {out['cli_extract_rows']}; wall "
            f"{wall:.3f} s")
        _md_trials(dev, grid2)
        _md_extractors(dev, grid2)
    log(f"[multidevice] launches over dryrun_multichip, the lanes and the extractors: {launches}")
    ran = {k for unit in MD_UNITS for k in UNIT_LAUNCHES[unit]}
    tabled = {k for per in UNIT_LAUNCHES.values() for k in per}
    missing = sorted(k for k in ran if not launches.get(k))
    stray = sorted(k for k, n in launches.items() if n and k not in tabled)
    if missing or stray:
        raise AssertionError(f"the multi-device path did not launch {missing} (or launched "
                             f"{stray}, which no unit of work launches)")
    _md_step_check(dev, grid)
    _md_w2v(dev, grid)
    _md_multihost(dev, tmp)
    return launches


def ptxas_report(text: str) -> list:
    """One line per kernel of ptxas's verbose output: its name with the
    integer template arguments, its registers and its spill bytes."""
    lines, name, spill = [], "?", ""
    for line in text.splitlines():
        line = line.strip()
        if "Function properties for" in line:
            found = re.search(r"\d([a-z_]+_kernel)(?:I((?:L[ib]\d+E)+)E)?", line)
            name = line.rsplit(" ", 1)[-1]
            if found:
                args = re.findall(r"L[ib](\d+)E", found.group(2) or "")
                name = found.group(1) + (f"<{', '.join(args)}>" if args else "")
        elif "spill" in line:
            spill = line
        elif "registers" in line:
            lines.append(f"{name}: {line.replace('ptxas info    : ', '')}; {spill}")
    return lines


def _tf32_flags() -> tuple:
    """(matmul, cuDNN conv, cuDNN RNN) float32 precisions, torch's
    fp32_precision API (the legacy allow_tf32 flags are never read: torch
    raises where they are read after the new API set them)."""
    return (torch.backends.cuda.matmul.fp32_precision, torch.backends.cudnn.conv.fp32_precision,
            torch.backends.cudnn.rnn.fp32_precision)


def tf32_phase(dev: torch.device) -> None:
    """Under torch's default flags (cuDNN convolutions allowed TF32) the
    port's convolutions run in IEEE float32 on their own: the flagship
    logits of two 4378-frame rows hold to the CPU (FLAGSHIP_TOL), and
    resample_poly of a 60 s file (16 kHz → 10 kHz) holds to the CPU within
    RESAMPLE_TOL; the flags are the same after each call. The same calls
    with the port's switch taken out show what TF32 would have done."""
    from robust_speech_analysis_framework_tpu_torch.audio import resample as resample_mod
    from robust_speech_analysis_framework_tpu_torch.models import cnn_lstm as cnn_lstm_mod

    defaults = _tf32_flags()
    log(f"[tf32] torch's flags (matmul, cuDNN conv, cuDNN RNN): {defaults}")
    if defaults[1] != "tf32":
        raise AssertionError("torch's default no longer lets cuDNN convolutions use TF32: "
                             "this check would prove nothing")
    model = build_cnn_lstm(DIM, 128, 128, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(2, PAD_LEN, DIM, device=dev, generator=gen)
    x[:, SEQ_LEN:] = 0.0
    lengths = torch.tensor([SEQ_LEN, 3000], dtype=torch.int32, device=dev)
    with torch.inference_mode():
        card = model(x, lengths).cpu()
        after_forward = _tf32_flags()
        cpu = copy.deepcopy(model).cpu()(x.cpu(), lengths.cpu())
    err = float((card - cpu).abs().max())
    wave = torch.from_numpy(_speech(60.0, 150.0, 7))
    y_cpu = resample_mod.resample_poly(wave, 5, 8)
    y_card = resample_mod.resample_poly(wave.to(dev), 5, 8).cpu()
    after_resample = _tf32_flags()
    r_err = float((y_card - y_cpu).abs().max())
    # the same two calls with the port's switch taken out: TF32 where cuDNN
    # takes it
    real_switches = (cnn_lstm_mod.fp32_convs, resample_mod.fp32_convs)
    cnn_lstm_mod.fp32_convs = resample_mod.fp32_convs = contextlib.nullcontext
    try:
        with torch.inference_mode():
            tf32_err = float((model(x, lengths).cpu() - cpu).abs().max())
        tf32_r_err = float((resample_mod.resample_poly(wave.to(dev), 5, 8).cpu()
                            - y_cpu).abs().max())
    finally:
        cnn_lstm_mod.fp32_convs, resample_mod.fp32_convs = real_switches
    log(f"[tf32] under torch's defaults: flagship logits card vs CPU max|d|={err:.3e} (tol "
        f"{FLAGSHIP_TOL}; without the port's switch {tf32_err:.3e}); resample_poly max|d|="
        f"{r_err:.3e} (tol {RESAMPLE_TOL}; without the switch {tf32_r_err:.3e}); flags after "
        f"each call {after_forward}, {after_resample}")
    if not (err <= FLAGSHIP_TOL and r_err <= RESAMPLE_TOL
            and after_forward == after_resample == defaults):
        raise AssertionError("the port's convolutions are not float32 under torch's default "
                             "flags, or a call changed the caller's flags")


def run(dev: torch.device, smi: str) -> None:
    """Every phase on ``dev``: the card's name and power limit (nvidia-smi),
    every kernel under ``csrc`` built with nvcc (its ptxas report printed),
    the TF32 check, then TF32 off for matmuls and cuDNN, so that the card
    computes in full float32 like the CPU it is compared with; prints the
    kernels' record (launches by path) and the result line."""
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(dev)}; TF32 off in every phase after the tf32 check")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] nvcc for {_build.sources()}: {time.perf_counter() - t0:.2f} s")
    for name, text in _build.build_logs.items():
        for line in ptxas_report(text):
            log(f"[build] {name}: {line}")
    tf32_phase(dev)
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    torch.backends.cudnn.rnn.fp32_precision = "ieee"

    records = kernel_phase(dev)
    records.update(train_kernel_phase(dev))
    for name, by_shape in lanes_kernel_phase(dev).items():
        records[name]["lanes"] = by_shape
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"],
                                           *(t["max_abs_err"] for t in by_shape.values()))
    records.update(viterbi_kernel_phase(dev))
    records.update(march_kernel_phase(dev))
    records.update(conv0_kernel_phase(dev))
    records.update(posconv_kernel_phase(dev))
    records.update(featconv_kernel_phase(dev))
    records.update(wavlm_kernel_phase(dev))
    records.update(conformer_kernel_phase(dev))
    flagship_phase(dev)
    with tempfile.TemporaryDirectory() as tmp:
        serving = serving_phase(dev, tmp)
    training, streaming_step_ms = training_phase(dev)
    cv, cv_lanes = cv_phase(dev, streaming_step_ms)
    with tempfile.TemporaryDirectory() as tmp:
        w2v = w2v_phase(dev, tmp)
        experiments = experiments_phase(dev, tmp)
    wavlm = wavlm_phase(dev)
    conformer = conformer_phase(dev)
    parity_phase(dev)
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint_phase(dev, tmp)
    opensmile = opensmile_phase(dev)
    mshds = mshds_phase(dev, records)
    with tempfile.TemporaryDirectory() as tmp:
        multidevice = multidevice_phase(dev, tmp)

    kernels = []
    for name, source, replaces in (
        ("lstm_scan_grouped", SOURCE, f"{PALLAS}:180"), ("lstm_scan", SOURCE, f"{PALLAS}:81"),
        ("lstm_scan_fwd_res_grouped", SOURCE, f"{PALLAS}:342"),
        ("lstm_scan_bwd_grouped", TRAIN_SOURCE, f"{PALLAS}:383"),
        ("lstm_gate_acts_grouped", TRAIN_SOURCE, f"{PALLAS}:296"),
        ("lstm_dwh_grouped", TRAIN_SOURCE, f"{PALLAS}:319"),
        ("viterbi_forward_costs", VITERBI_SOURCE, f"{PALLAS_VITERBI}:93"),
        ("viterbi_path", VITERBI_SOURCE, f"{PALLAS_VITERBI}:135"),
        ("march_periods", MARCH_SOURCE, JAX_MARCH),
        ("conv0_norm_gelu", CONV0_SOURCE, JAX_CONV0),
        ("feature_conv", FEATCONV_SOURCE, JAX_FEATCONV),
        ("pos_conv_gelu", POSCONV_SOURCE, JAX_POSCONV),
        ("relpos_softmax", WAVLM_SOURCE, JAX_WAVLM),
        ("relpos_shift_softmax", CONFORMER_SOURCE, JAX_CONFORMER),
    ):
        rec = records[name]
        by_path = {"serving": serving[name], "training": training[name], "cv": cv[name],
                   "cv-lanes": cv_lanes[name], "opensmile": opensmile[name],
                   "mshds": mshds[name], "w2v": w2v[name], "experiments": experiments[name],
                   "multidevice": multidevice[name], "wavlm": wavlm[name],
                   "conformer": conformer[name]}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "shape": rec["shape"],
            "on_main_path": name != "lstm_scan",
            **{k: rec[k] for k in ("serving", "praat", "mshds", "sweep_ms", "split", "lanes",
                                   "boundaries_equal", "periods_longest_lane", "us_a_period",
                                   "phases", "conv_ms", "chain_ms", "bound_every_pair_ms",
                                   "encoder_batch_ms", "encoder_peak_bytes", "tflops", "tile",
                                   "tiles", "wavlm", "convs", "matmul_ms", "shapes")
               if k in rec},
        })
    log(f"[card] {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(dev),
        "count": torch.cuda.device_count()}}))


def march_only(csrc: str = None) -> None:
    """``--march [DIR]``: the march-kernel phase alone, with its profile,
    building ``period_march.cu`` from DIR (another version's kernel sources,
    with the same C entry points) when one is given; prints its record."""
    if csrc:
        _build.CSRC_DIR = os.path.abspath(csrc)
    t0 = time.perf_counter()
    _build.load("period_march")
    log(f"[build] period_march from {_build.CSRC_DIR}: {time.perf_counter() - t0:.2f} s")
    for line in ptxas_report(_build.build_logs.get("period_march", "")):
        log(f"[build] period_march: {line}")
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    print(json.dumps(march_kernel_phase(torch.device("cuda", 0))))


def train_kernels_only(csrc: str = None) -> None:
    """``--train-kernels [DIR]``: the training kernels' phase and the lanes
    kernel phase alone, building the sources from DIR (another version's
    ``lstm_train.cu`` beside the ``lstm_scan.cu`` the phases also run, with
    the same C entry points) when one is given; prints the pre-pass's record."""
    if csrc:
        _build.CSRC_DIR = os.path.abspath(csrc)
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] {_build.sources()} from {_build.CSRC_DIR}: {time.perf_counter() - t0:.2f} s")
    for line in ptxas_report(_build.build_logs.get("lstm_train", "")):
        log(f"[build] lstm_train: {line}")
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    torch.backends.cudnn.rnn.fp32_precision = "ieee"
    dev = torch.device("cuda", 0)
    records = train_kernel_phase(dev)
    rec = records["lstm_gate_acts_grouped"]
    rec["lanes"] = lanes_kernel_phase(dev)["lstm_gate_acts_grouped"]
    print(json.dumps({"lstm_gate_acts_grouped": rec}))


def conv0_only() -> None:
    """``--conv0``: Wav2Vec2's first-block kernel phase alone; prints its record."""
    t0 = time.perf_counter()
    _build.load("feature_conv0")
    log(f"[build] feature_conv0: {time.perf_counter() - t0:.2f} s")
    for line in ptxas_report(_build.build_logs.get("feature_conv0", "")):
        log(f"[build] feature_conv0: {line}")
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    print(json.dumps(conv0_kernel_phase(torch.device("cuda", 0))))


def posconv_only() -> None:
    """``--posconv``: the positional conv's kernel phase and one encoder
    batch of each model with and without it; prints the kernel's record."""
    from robust_speech_analysis_framework_tpu_torch.models import wav2vec2 as w2v_model

    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] nvcc for {_build.sources()}: {time.perf_counter() - t0:.2f} s")
    for line in ptxas_report(_build.build_logs.get("pos_conv", "")):
        log(f"[build] pos_conv: {line}")
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    dev = torch.device("cuda", 0)
    record = posconv_kernel_phase(dev)
    record["pos_conv_gelu"]["encoder_batches"] = encoder_batches(
        dev, "posconv", ((w2v_model, "pos_conv_gelu", w2v_ops.pos_conv_gelu_reference),))
    print(json.dumps(record))


def featconv_only() -> None:
    """``--featconv``: the strided convs' kernel phase and one encoder batch
    of each model with and without it; prints the kernel's record."""
    from robust_speech_analysis_framework_tpu_torch.models import wav2vec2 as w2v_model
    from robust_speech_analysis_framework_tpu_torch.models import wavlm as wavlm_model

    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] nvcc for {_build.sources()}: {time.perf_counter() - t0:.2f} s")
    for line in ptxas_report(_build.build_logs.get("feature_conv", "")):
        log(f"[build] feature_conv: {line}")
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    dev = torch.device("cuda", 0)
    record = featconv_kernel_phase(dev)
    plain = w2v_ops.feature_conv_reference
    record["feature_conv"]["encoder_batches"] = encoder_batches(
        dev, "featconv", ((w2v_model, "feature_conv", plain), (wavlm_model, "feature_conv", plain)))
    print(json.dumps(record))


def wavlm_only() -> None:
    """``--wavlm``: WavLM's kernel and encoder batch phase and its extraction
    path (phase 8's last part and phase 15 alone); prints the kernel's
    record with the path's launches."""
    t0 = time.perf_counter()
    _build.load("wavlm_relpos")
    log(f"[build] wavlm_relpos: {time.perf_counter() - t0:.2f} s")
    for line in ptxas_report(_build.build_logs.get("wavlm_relpos", "")):
        log(f"[build] wavlm_relpos: {line}")
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    dev = torch.device("cuda", 0)
    record = wavlm_kernel_phase(dev)
    record["relpos_softmax"]["launches_by_path"] = {"wavlm": wavlm_phase(dev)["relpos_softmax"]}
    print(json.dumps(record))


def conformer_only() -> None:
    """``--conformer``: the Conformer's kernel and encoder batch phase and
    its extraction path (phase 8's last part and phase 16 alone); prints the
    kernel's record with the path's launches."""
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] nvcc for {_build.sources()}: {time.perf_counter() - t0:.2f} s")
    for line in ptxas_report(_build.build_logs.get("conformer_relpos", "")):
        log(f"[build] conformer_relpos: {line}")
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    dev = torch.device("cuda", 0)
    record = conformer_kernel_phase(dev)
    record["relpos_shift_softmax"]["launches_by_path"] = {
        "conformer": conformer_phase(dev)["relpos_shift_softmax"]}
    print(json.dumps(record))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one CUDA device",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    if len(sys.argv) > 1 and sys.argv[1] == "--march":
        log(f"[card] {smi}")
        march_only(sys.argv[2] if len(sys.argv) > 2 else None)
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--conv0":
        log(f"[card] {smi}")
        conv0_only()
        log(f"[card] {smi}")
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--featconv":
        log(f"[card] {smi}")
        featconv_only()
        log(f"[card] {smi}")
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--posconv":
        log(f"[card] {smi}")
        posconv_only()
        log(f"[card] {smi}")
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--wavlm":
        log(f"[card] {smi}")
        wavlm_only()
        log(f"[card] {smi}")
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--conformer":
        log(f"[card] {smi}")
        conformer_only()
        log(f"[card] {smi}")
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--train-kernels":
        log(f"[card] {smi}")
        train_kernels_only(sys.argv[2] if len(sys.argv) > 2 else None)
        log(f"[card] {smi}")
        return 0
    run(torch.device("cuda", 0), smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
