"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check every phase.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc`` (CUDA_HOME or PATH); exits non-zero
without them. Phases, each of which raises on failure:

1. card: name and power limit (nvidia-smi);
2. build: every kernel under robust_speech_analysis_framework_tpu_torch/csrc
   compiled with nvcc (ptxas report printed); then, under torch's default
   flags (cuDNN convolutions allowed TF32), the flagship logits of two rows
   and resample_poly of a 60 s file against the CPU, with the flags the
   same after each call (the port runs its convolutions in IEEE float32
   itself); from here on TF32 is switched off for every phase (matmul and
   cuDNN), so the card computes in full float32 like the CPU it is
   compared with;
3. kernels: K1 (lstm_scan_grouped) and K2 (lstm_scan) against their plain
   PyTorch versions on the card at a ragged shape, the flagship batch shape
   and the serving shape, with their times (and microseconds a step of the
   time loop) beside the plain version's, the cuDNN ``nn.LSTM`` yardstick
   and the card's bound, K1 at each batch tile its kernel has (bit-equal
   to one another), and both at a trial's width in the CV search (H=64,
   B=4); then the training
   kernels K3 (lstm_scan_fwd_res_grouped: hs, cs), K4
   (lstm_scan_bwd_grouped: dgates, dWh), its gate pre-pass
   (lstm_gate_acts_grouped) and the dWh kernel (lstm_dwh_grouped) the same
   way at a ragged shape, a CV trial's shape (T=2240, G=2, B=4, H=64) and
   the training shape (T=4096, G=2, B=8, H=128),
   with cuDNN's biLSTM forward (K3) and backward (K4), ``torch.baddbmm``
   with the activations (pre-pass) and ``torch.einsum`` (dWh) as
   yardsticks; K1's hs bit-equal to K3's; how far the pre-pass's gates lie
   from the ones K3 used (printed); K4's sweep alone, and at batch tiles
   1/2/4 at B=64; the dWh kernel alone at ragged shapes (T=1: all zeros;
   T=2; B=1 and 3; H=24, 40, 64; rows that do not fill the last slice) with
   its row split printed and two calls bit-equal; and every LSTM kernel
   (K1, K3, K4 whole, its pre-pass, its sweep alone, dWh) at the lanes
   shape of a round of 8 trials at the CV corpus's length (T=2176, G=16:
   8 lanes x 2 directions, B=4, H=64 and H=128) against its plain version,
   with times, bounds and the batch tiles and dWh split chosen at G=16;
4. flagship forward: CNNLSTM(768, 128, 128), batch 128 × 4480 × 768,
   lengths 4378; two kernel launches per forward; logits of two rows agree
   with the same model on the CPU; median time and a profiler breakdown;
5. serving (the main path): a Predictor with a full-width random-init
   Wav2Vec2-base and the flagship CNN-LSTM answers three waveform requests,
   one predict_files call (16 kHz and 8 kHz WAVs) and one predict_sequence;
   the launch counters are reset just before and read just after; one
   request's Wav2Vec2 sequence and logits agree with the same predictor on
   the CPU;
6. training (the second main path): fold 0 of StratifiedKFold(5, seed 42)
   over a seeded synthetic corpus of 40 Wav2Vec2-width sequences (1000 to
   4378 frames), the inner 80/20 split, ``train_model`` of the flagship
   CNNLSTM(768, 128, 128) (batch 8, Adam 1e-3, dropout 0.5, plateau decay,
   early stop, best-weight restore) on the streaming path
   (``device_fold="off"``) for 3 epochs, then ``evaluate_model``
   and the fold's metrics; counters reset just before and read just after
   (two launches each of K3, K4, its pre-pass and dWh per train step, two
   K1 per eval batch); loss per epoch, step time, audio-seconds trained per second,
   peak memory, and a profile of one train step;
7. train-step parity: one step of the flagship model (B=2, T=512, dropout
   off) on the card and through the plain path on the CPU from the same
   weights: loss, gradients, updated parameters and BatchNorm statistics;
8. viterbi-kernels: K6 (viterbi_forward_costs) and K7 (viterbi_path)
   against their plain versions on the card, bit for bit (max |Δc| = 0,
   identical paths), at ragged shapes (B=3, T=37, C=7, both weight
   schemes; C=32; C=1), the openSMILE shape (B=4, T=6485, C=7: a 60 s
   file's bucket) and the Praat shape of the next slice (B=8, T=5997,
   C=15), with times (and microseconds a step) beside the plain version's
   and the card's bound;
9. opensmile (the third main path): a seeded corpus of 16 speech-like
   16 kHz files of 20–60 s (three length buckets) through
   OpenSmileExtractor.extract_arrays on the card, counters reset just
   before and read just after (one K6 and one K7 launch per sub-batch);
   first-pass and steady wall time (median of 3), audio-s/s, the host
   period march's time and share, peak memory, a profile of one sub-batch;
   16 × 912 finite values; two short files card vs CPU within the
   tolerance families of the JAX package's batched-vs-serial test;
10. cv (the training half of the main path, whole): the corpus of phase 6
    uploaded once as a ResidentCorpus, then over that one tensor the
    standard engine (``standard_kfold_cv``: 2 folds, 2 epochs, the flagship
    hyperparameters) and the nested engine (``nested_cv``: 2 outer folds, 3
    TPE trials of 2 inner folds and 2 epochs at batch 4 over the default
    search space, 2 final epochs); counters reset just before each engine
    and read just after (two launches each of K3, K4, its pre-pass and dWh
    per train step, two K1 per eval batch, no K2); no upload through
    ``Trainer._tensor`` larger than a label vector or a batch plan; finite
    results of the right shapes; upload time, the resident fold's train
    step beside the streaming fold's, wall per fold and per trial, peak
    memory; and one fold of one-bucket sequences through the resident and
    the streaming path, whose first-epoch losses agree to 1e-5. Then the
    lane-batched trials over the same tensor: one ``train_trials_device``
    call of 4 lanes (4 learning and dropout rates, 2 epochs at batch 4)
    against ``train_model`` of each of its trials (histories to 1e-4
    relative), and the nested engine with ``trial_batch=8`` (2 outer folds,
    one round of 8 trials each, 2 inner folds x 2 epochs at batch 4, 2 final
    epochs); counters reset just before and read just after (K3, K4, its
    pre-pass and dWh twice per lane step and per final step, K1 twice per
    eval batch, the lane steps recounted from the splits: one trial's
    schedule a round); no upload beyond labels, rates and batch plans; wall
    per round and per trial beside the sequential nested run's trial, the
    median lane step, peak memory, a lane step at the flagship widths (8
    lanes, 4 x 4352 x 768) beside 8 sequential batch-4 steps, and its profile;
11. mshds (the whole MSHDS-25 extractor): 16 speech-like 16-bit PCM files
    of 20–60 s (f0 95–230 Hz, both range groups) through the port's entry
    point ``features.mshds.extract_mshds_arrays`` on the card; counters reset just before and read just after (one K7 and
    one K6 launch per pitch pass: wide, speech-rate, and main, CPP and cc in
    each range group, nothing else); first-pass and steady wall time (the
    same bits every pass), each level's (L0, L1, pulses, tail, host rows:
    timed by wrapping the calls that end them), the march's steps and host
    syncs, peak memory; K6/K7 bit for bit against their plain versions on
    the candidate stacks of a main-pass call and of the largest call, timed
    there with their bound; the 4 shortest files again on the CPU against
    the card, all 25 features each to its tolerance (MSHDS_TOL) with equal
    NaN masks, printed card beside CPU, and the moments stage alone on the
    same voiced frames card vs CPU; one profiled extraction: each tail
    stage's device time (moments, formants with Durand–Kerner's share,
    LTAS, CPPS), launches and host time, and the device's idle share of
    the tail's window.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from robust_speech_analysis_framework_tpu_torch.audio.io import write_wav
from robust_speech_analysis_framework_tpu_torch.eval import dl_cv
from robust_speech_analysis_framework_tpu_torch.eval.metrics import classification_metrics
from robust_speech_analysis_framework_tpu_torch.eval.splits import (
    StratifiedKFold,
    train_test_indices,
)
from robust_speech_analysis_framework_tpu_torch.features import opensmile as opensmile_mod
from robust_speech_analysis_framework_tpu_torch.features.wav2vec2 import Wav2Vec2Extractor
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
from robust_speech_analysis_framework_tpu_torch.ops.cuda import _build
from robust_speech_analysis_framework_tpu_torch.ops.cuda import lstm as lstm_ops
from robust_speech_analysis_framework_tpu_torch.ops.cuda import viterbi as viterbi_ops
from robust_speech_analysis_framework_tpu_torch.serving import Predictor
from robust_speech_analysis_framework_tpu_torch.train import loops

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

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


def bound_ms(bytes_moved: float, ops: float) -> tuple:
    """The larger of bytes over the HBM rate and operations over the fp32
    CUDA-core peak, with which of the two it is."""
    t_bytes = bytes_moved / PEAK_HBM_BYTES * 1e3
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def lstm_bound_ms(t: int, g: int, b: int, h: int, save_c: bool = False) -> tuple:
    """Least time for the recurrence (K1/K2; K3 with ``save_c``): gates in,
    Wh in, hs (and cs) out once; per row and step a (H × 4H) matvec (2 ops a
    term), the gate add (4H) and the cell update (about 5H)."""
    n_out = 2 if save_c else 1
    bytes_moved = 4 * (t * g * b * 4 * h + g * h * 4 * h + n_out * t * g * b * h)
    return bound_ms(bytes_moved, t * g * b * (2 * h * 4 * h + 4 * h + 5 * h))


def lstm_bwd_bound_ms(t: int, g: int, b: int, h: int) -> tuple:
    """Least time for the reverse sweep with dWh (K4): gates, hs, cs, dhout
    and Wh in, dgates and dWh out once; per row and step three (H × 4H)
    products (z recomputed, dz @ Whᵀ, the dWh term) and about 25H of
    elementwise work."""
    bytes_moved = 4 * (2 * t * g * b * 4 * h + 3 * t * g * b * h + 2 * g * h * 4 * h)
    return bound_ms(bytes_moved, t * g * b * (3 * 2 * h * 4 * h + 25 * h))


def gate_acts_bound_ms(t: int, g: int, b: int, h: int) -> tuple:
    """Least time for K4's gate pre-pass: gates, hs and Wh in, the activated
    gates out once; per row and step one (H × 4H) product, the gate add (4H)
    and about four operations an activation."""
    bytes_moved = 4 * (2 * t * g * b * 4 * h + t * g * b * h + g * h * 4 * h)
    return bound_ms(bytes_moved, t * g * b * (2 * h * 4 * h + 4 * h + 4 * 4 * h))


def dwh_bound_ms(t: int, g: int, b: int, h: int) -> tuple:
    """Least time for dWh alone: hs and dgates in, dWh out once; one
    (H × 4H) outer product per row and step after the first."""
    bytes_moved = 4 * (t * g * b * h + t * g * b * 4 * h + g * h * 4 * h)
    return bound_ms(bytes_moved, 2 * (t - 1) * g * b * h * 4 * h)


def kernel_phase(dev: torch.device) -> dict:
    """K1/K2 against their plain versions; times at the batch and serving shapes."""
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
    """Batch-128 flagship forward on the card; two rows against the CPU."""
    model = build_cnn_lstm(DIM, 128, 128, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(BATCH, PAD_LEN, DIM, device=dev, generator=gen)
    x[:, SEQ_LEN:] = 0.0
    lengths = torch.full((BATCH,), SEQ_LEN, dtype=torch.int32, device=dev)
    before = lstm_ops.lstm_scan_grouped.launches
    with torch.inference_mode():
        logits = model(x, lengths)
    torch.cuda.synchronize()
    launched = lstm_ops.lstm_scan_grouped.launches - before
    log(f"[flagship] lstm_scan_grouped launches per forward: {launched}")
    if launched != 2:
        raise AssertionError("the flagship forward did not launch K1 once per biLSTM layer")
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


def profile_device(label: str, fn, top: int) -> None:
    """Device time by kernel over one call of ``fn`` (torch.profiler), with
    the device's idle share of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # only the device's own kernel rows: an operator's row repeats its kernels' time
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=device_us, reverse=True)
    total_ms = sum(device_us(e) for e in rows) / 1e3
    if total_ms == 0:
        log("[profile] the profiler recorded no device time")
        return
    log(f"[profile] {label}: {wall_ms:.3f} ms wall, {total_ms:.3f} ms device "
        f"(device idle {max(0.0, 1 - total_ms / wall_ms):.1%} of the window)")
    for e in rows[:top]:
        log(f"[profile]   {device_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")


def profile_forward(model, x, lengths) -> None:
    """Device time by kernel over one flagship forward."""

    def forward():
        with torch.inference_mode():
            model(x, lengths)

    profile_device("one flagship forward", forward, 8)


def serving_phase(dev: torch.device, tmp: str) -> dict:
    """The main path: a Predictor answering waveform, file and sequence requests."""
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

    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    preds = {f"predict({k})": predictor.predict(w) for k, w in waves.items()}
    for name, pred in predictor.predict_files(paths).items():
        preds[f"predict_files({name})"] = pred
    preds["predict_sequence(4378x768)"] = predictor.predict_sequence(sequence)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}

    for name, pred in preds.items():
        log(f"[serving] {name}: {pred.label} p(Patient)={pred.probability:.6f} "
            f"latency {pred.latency_seconds * 1e3:.3f} ms")
        if pred.logits.shape != (2,) or not np.isfinite(pred.logits).all():
            raise AssertionError(f"bad logits for {name}")
    log(f"[serving] kernel launches on the main path: {launches}")
    if launches["lstm_scan_grouped"] != 2 * len(preds) or sum(launches.values()) != 2 * len(preds):
        raise AssertionError("the serving path did not run K1, and only K1, for every "
                             "biLSTM layer")

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


def train_kernel_phase(dev: torch.device) -> dict:
    """K3, K4, its gate pre-pass and the dWh kernel against their plain
    versions; times at the training shape beside cuDNN's biLSTM forward and
    backward; K4's sweep alone and by batch tile."""
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

        reps = 3
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
        sweep_ms = _sweep_alone_ms(acts, cs, wh, dhout, 0, 5)
        records["lstm_scan_bwd_grouped"]["sweep_ms"] = sweep_ms
        log(f"[train-kernels] K4 {label} by part: pre-pass "
            f"{records['lstm_gate_acts_grouped']['ms']:.4f} ms + sweep alone {sweep_ms:.4f} ms "
            f"({sweep_ms / t * 1e3:.3f} us a step) + dWh {records['lstm_dwh_grouped']['ms']:.4f} "
            f"ms; K4 whole {records['lstm_scan_bwd_grouped']['ms']:.4f} ms")

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


def _counters():
    counters = {name: getattr(lstm_ops, name) for name in (
        "lstm_scan_grouped", "lstm_scan", "lstm_scan_fwd_res_grouped",
        "lstm_scan_bwd_grouped", "lstm_gate_acts_grouped", "lstm_dwh_grouped")}
    counters.update({name: getattr(viterbi_ops, name)
                     for name in ("viterbi_forward_costs", "viterbi_path")})
    return counters


def training_phase(dev: torch.device) -> tuple:
    """The second main path: one CV fold of flagship training on the
    streaming path and its eval; returns the launches and the median train
    step in ms."""
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
    counters = _counters()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    state, train_hist, val_hist = loops.train_model(
        trainer, pick(tr), y[tr], pick(val), y[val], cfg)
    y_true, y_pred, y_prob = loops.evaluate_model(trainer, state, pick(test_idx), y[test_idx], cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
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
    log(f"[training] main-path launches: {launches}; expected 2 x {n_steps} steps of "
        f"K3/K4/pre-pass/dWh and 2 x {n_eval} eval batches of K1")
    if not (launches["lstm_scan_fwd_res_grouped"] == launches["lstm_scan_bwd_grouped"]
            == launches["lstm_gate_acts_grouped"] == launches["lstm_dwh_grouped"] == 2 * n_steps
            and launches["lstm_scan_grouped"] == 2 * n_eval and launches["lstm_scan"] == 0):
        raise AssertionError("the training path did not launch the kernels as expected")

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
    """K3, K4, its pre-pass and dWh twice per train step (a lane step
    counts once, whatever its lanes), K1 twice per eval batch."""
    n_steps = len(probe.steps) + len(probe.lane_steps)
    n_eval = probe.eval_batches + probe.lane_eval_batches
    log(f"[cv] {label} launches: {launches}; {len(probe.steps)} train steps + "
        f"{len(probe.lane_steps)} lane steps, {probe.eval_batches} eval batches + "
        f"{probe.lane_eval_batches} lane eval batches")
    if not (n_steps > 0 and n_eval > 0
            and launches["lstm_scan_fwd_res_grouped"] == launches["lstm_scan_bwd_grouped"]
            == launches["lstm_gate_acts_grouped"] == launches["lstm_dwh_grouped"] == 2 * n_steps
            and launches["lstm_scan_grouped"] == 2 * n_eval and launches["lstm_scan"] == 0
            and launches["viterbi_forward_costs"] == launches["viterbi_path"] == 0):
        raise AssertionError(f"the {label} CV engine did not launch the kernels as expected")


def cv_phase(dev: torch.device, streaming_step_ms: float) -> dict:
    """The training half of the main path, whole: both CV engines over one
    resident corpus at the flagship's input width."""
    seqs, y = _synthetic_corpus(0)
    named = {f"p{i:02d}": s for i, s in enumerate(seqs)}
    counters = _counters()
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

    total = {name: 0 for name in counters}
    with _CvProbe() as probe:
        # --- the standard engine
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        results, preds, hists, weights = dl_cv.standard_kfold_cv(
            X, y, FLAGSHIP_HP, device=dev, **CV_STANDARD)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        _check_cv_launches("standard", launches, probe)
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
        for name in total:
            total[name] += launches[name]
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
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        try:
            results, preds, weights = dl_cv.nested_cv(X, y, device=dev, **CV_NESTED)
        finally:
            dl_cv._inner_cv_score = real_score
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        _check_cv_launches("nested", launches, probe)
        for name in total:
            total[name] += launches[name]
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
    """One train_trials_device call of 4 lanes against train_model of each
    of its trials, dropout on, over the resident corpus."""
    split = _inner_split(X, y)
    trainer = dl_cv._TrainerCache(DIM, device=dev).get(LANE_PARITY_HP)
    cfg = loops.TrainConfig(
        learning_rate=LANE_PARITY_LRS[0], epochs=CV_NESTED["inner_epochs"],
        patience=CV_NESTED["inner_epochs"] + 1, batch_size=CV_NESTED["inner_batch_size"], seed=42,
        dropout_rate=LANE_PARITY_RATES[0], use_plateau=False, restore_best=False)
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    states, hist = loops.train_trials_device(trainer, *split, cfg, LANE_PARITY_LRS,
                                             LANE_PARITY_RATES)
    torch.cuda.synchronize()
    lane_wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
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
    round of 8 lanes an outer fold. Returns its launches."""
    counters = _counters()
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
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    try:
        results, preds, weights = dl_cv.nested_cv(X, y, device=dev, **CV_LANES_NESTED)
    finally:
        dl_cv._inner_cv_scores_batch = real_round
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
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
    """One flagship train step on the card and on the CPU from the same weights."""
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
    """K6/K7 against their plain versions (bit-exact) at the ragged,
    openSMILE and Praat shapes, with times and bounds."""
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


def _speech(seconds: float, f0: float, seed: int) -> np.ndarray:
    """Speech-like 16 kHz audio: 11 harmonics with 3 Hz vibrato, syllable
    gating, a little noise, quantised to 16-bit PCM (the recipe of
    benchmarks/suite.py:31-43, with the vibrato's phase integrated)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    # 3 Hz vibrato of ±1 % as a true frequency modulation: the benchmark's
    # phase f0·(1 + 0.01·sin)·t sweeps ±0.19·f0·t Hz, so its files stop
    # being voiced after a few seconds
    phase = f0 * (t + 0.01 * (1 - np.cos(2 * np.pi * 3 * t)) / (2 * np.pi * 3))
    v = sum(np.sin(2 * np.pi * k * phase) / k for k in range(1, 12))
    gate = np.where((t % 0.6) < 0.42, 1.0, 0.02)
    x = 0.3 * gate * v / np.abs(v).max() + 0.002 * rng.normal(size=len(t))
    return (np.clip(np.round(x * 32768.0), -32768, 32767) / 32768.0).astype(np.float32)


def opensmile_phase(dev: torch.device) -> dict:
    """The third main path: openSMILE-912 extraction of a 16-file corpus."""
    t0 = time.perf_counter()
    lengths = np.linspace(OS_MIN_S, OS_MAX_S, OS_FILES)
    corpus = {f"s{i:02d}.wav": _speech(s, 110 + 9 * i, i) for i, s in enumerate(lengths)}
    audio_s = sum(len(x) for x in corpus.values()) / SR
    extractor = opensmile_mod.OpenSmileExtractor(device=dev)
    buckets = sorted({extractor._bucket_of(len(x)) for x in corpus.values()})
    log(f"[opensmile] corpus: {OS_FILES} files, {OS_MIN_S}–{OS_MAX_S} s, {audio_s:.1f} audio-s "
        f"in buckets {buckets} samples, made in {time.perf_counter() - t0:.2f} s")

    march_s = []  # the host period march, timed per file
    real_march = opensmile_mod.jitter_shimmer_llds

    def timed_march(*args, **kwargs):
        start = time.perf_counter()
        out = real_march(*args, **kwargs)
        march_s.append(time.perf_counter() - start)
        return out

    def extract():
        march_s.clear()
        start = time.perf_counter()
        names, feats = extractor.extract_arrays(corpus, verbose=False)
        torch.cuda.synchronize()
        return names, feats, time.perf_counter() - start, sum(march_s)

    opensmile_mod.jitter_shimmer_llds = timed_march
    try:
        counters = _counters()
        torch.cuda.reset_peak_memory_stats(dev)
        for fn in counters.values():
            fn.launches = 0
        names, feats, first_s, first_march = extract()
        launches = {name: fn.launches for name, fn in counters.items()}
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
        steady = [extract()[2:] for _ in range(3)]
    finally:
        opensmile_mod.jitter_shimmer_llds = real_march

    walls = [s[0] for s in steady]
    median = statistics.median(walls)
    march = steady[walls.index(median)][1]
    per_bucket = collections.Counter(extractor._bucket_of(len(x)) for x in corpus.values())
    n_sub = sum(-(-n // extractor.pipeline_rows) for n in per_bucket.values())
    log(f"[opensmile] first pass {first_s:.3f} s ({audio_s / first_s:.1f} audio-s/s; host march "
        f"{first_march:.3f} s, {first_march / first_s:.1%}); steady median {median:.3f} s of "
        f"{[round(w, 3) for w in walls]} s, {audio_s / median:.1f} audio-s/s; host march "
        f"{march:.3f} s = {march / median:.1%} of the extraction; peak memory {peak_gib:.3f} GiB")
    log(f"[opensmile] main-path launches: {launches}; expected one K6 and one K7 per "
        f"sub-batch, {n_sub} sub-batches")
    if not (launches["viterbi_forward_costs"] == launches["viterbi_path"] == n_sub
            and sum(launches.values()) == 2 * n_sub):
        raise AssertionError("the openSMILE path did not launch K6/K7, and only them, "
                             "once per sub-batch")
    if feats.shape != (OS_FILES, 912) or not np.isfinite(feats).all() or sorted(names) != sorted(corpus):
        raise AssertionError(f"bad openSMILE features {feats.shape}")
    col = opensmile_mod.feature_columns().index("F0final_sma_amean")
    log(f"[opensmile] {feats.shape} finite; F0final_sma_amean over files "
        f"{feats[:, col].min():.2f}–{feats[:, col].max():.2f} Hz")

    big = [x for x in corpus.values() if extractor._bucket_of(len(x)) == buckets[-1]]
    profile_device(f"one openSMILE sub-batch ({min(len(big), extractor.pipeline_rows)} files, "
                   f"bucket {buckets[-1]})",
                   lambda: extractor._sub_batch(buckets[-1], big[: extractor.pipeline_rows]), 12)

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


def _union_us(intervals, lo, hi) -> float:
    """Microseconds of [lo, hi] covered by the union of the intervals."""
    busy, cur_a, cur_b = 0.0, None, None
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi):
        if cur_b is None or a > cur_b:
            busy += 0.0 if cur_b is None else cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    return busy + (0.0 if cur_b is None else cur_b - cur_a)


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
               if e.device_type == DeviceType.CUDA and not e.name.startswith("mshds:")]
    busy_us = _union_us(kernels, lo, hi)
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
    """The whole MSHDS-25 extractor over a 16-file corpus on the card:
    launches, wall times by level, K7 on a real slab against its plain
    version and timed at the largest, the card against the CPU on the
    shortest files feature by feature, the tail's profile. Adds K6/K7's
    times at this path's shape to ``records`` and returns the launches."""
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

    counters = _counters()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters.values():
        fn.launches = 0
    mshds_pitch.viterbi_path = recording_path
    try:
        card, first_wall, first_walls = mshds_extract(xs, dev)
    finally:
        mshds_pitch.viterbi_path = real_path
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    if "pulses" not in first_walls:
        raise AssertionError("the corpus did not take the device pulse march")
    n_passes = 2 + 3 * 2  # wide + speech-rate; main, CPP and cc per range group
    log(f"[mshds] main-path launches: {launches}; expected {n_passes} of K7 and of K6 (wide, "
        f"speech-rate, and main, CPP and cc in each of the 2 range groups), no other kernel")
    if not (launches["viterbi_path"] == launches["viterbi_forward_costs"] == n_passes
            and sum(launches.values()) == 2 * n_passes and len(calls) == n_passes):
        raise AssertionError("the MSHDS extractor did not launch K6/K7, and only them, once per "
                             "pitch pass over both range groups")
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


def mshds_card_vs_cpu(card: np.ndarray, cpu: np.ndarray, seconds, f0s) -> None:
    """The shortest files' 25 features, card beside CPU, each held to its
    tolerance; NaN masks equal."""
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
        log(f"[mshds] file {i} ({seconds[i]:.1f} s, f0 {f0s[i]:.1f} Hz), card / CPU: "
            + ", ".join(f"{n} {a:.6g} / {b:.6g}" for n, a, b in
                        zip(mshds_mod.FEATURE_NAMES, card[i], cpu[i])))
    if bad:
        raise AssertionError(f"MSHDS features on the card disagree with the CPU: {bad}")


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
    from contextlib import nullcontext

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
    cnn_lstm_mod.fp32_convs = resample_mod.fp32_convs = nullcontext
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
    """Every phase on ``dev``; prints the kernels' record and the result line."""
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
    flagship_phase(dev)
    with tempfile.TemporaryDirectory() as tmp:
        serving = serving_phase(dev, tmp)
    training, streaming_step_ms = training_phase(dev)
    cv, cv_lanes = cv_phase(dev, streaming_step_ms)
    parity_phase(dev)
    opensmile = opensmile_phase(dev)
    mshds = mshds_phase(dev, records)

    kernels = []
    for name, source, replaces in (
        ("lstm_scan_grouped", SOURCE, f"{PALLAS}:180"), ("lstm_scan", SOURCE, f"{PALLAS}:81"),
        ("lstm_scan_fwd_res_grouped", SOURCE, f"{PALLAS}:342"),
        ("lstm_scan_bwd_grouped", TRAIN_SOURCE, f"{PALLAS}:383"),
        ("lstm_gate_acts_grouped", TRAIN_SOURCE, f"{PALLAS}:296"),
        ("lstm_dwh_grouped", TRAIN_SOURCE, f"{PALLAS}:319"),
        ("viterbi_forward_costs", VITERBI_SOURCE, f"{PALLAS_VITERBI}:93"),
        ("viterbi_path", VITERBI_SOURCE, f"{PALLAS_VITERBI}:135"),
    ):
        rec = records[name]
        by_path = {"serving": serving[name], "training": training[name], "cv": cv[name],
                   "cv-lanes": cv_lanes[name], "opensmile": opensmile[name],
                   "mshds": mshds[name]}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "shape": rec["shape"],
            "on_main_path": name != "lstm_scan",
            **{k: rec[k] for k in ("serving", "praat", "mshds", "sweep_ms", "split", "lanes")
               if k in rec},
        })
    log(f"[card] {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(dev),
        "count": torch.cuda.device_count()}}))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one CUDA device",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    run(torch.device("cuda", 0), smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
