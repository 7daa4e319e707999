"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check every phase.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc`` (CUDA_HOME or PATH); exits non-zero
without them. Phases, each of which raises on failure:

1. card: name and power limit (nvidia-smi), TF32 switched off for every
   phase (matmul and cuDNN), so the card computes in full float32 like the
   CPU it is compared with;
2. build: every kernel under robust_speech_analysis_framework_tpu_torch/csrc
   compiled with nvcc (ptxas report printed);
3. kernels: K1 (lstm_scan_grouped) and K2 (lstm_scan) against their plain
   PyTorch versions on the card at a ragged shape, the flagship batch shape
   and the serving shape, with their times beside the plain version's, the
   cuDNN ``nn.LSTM`` yardstick and the card's bound;
4. flagship forward: CNNLSTM(768, 128, 128), batch 128 × 4480 × 768,
   lengths 4378; two kernel launches per forward; logits of two rows agree
   with the same model on the CPU; median time and a profiler breakdown;
5. serving (the main path): a Predictor with a full-width random-init
   Wav2Vec2-base and the flagship CNN-LSTM answers three waveform requests,
   one predict_files call (16 kHz and 8 kHz WAVs) and one predict_sequence;
   the launch counters are reset just before and read just after; one
   request's Wav2Vec2 sequence and logits agree with the same predictor on
   the CPU.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from robust_speech_analysis_framework_tpu_torch.audio.io import write_wav
from robust_speech_analysis_framework_tpu_torch.features.wav2vec2 import Wav2Vec2Extractor
from robust_speech_analysis_framework_tpu_torch.models.cnn_lstm import build_cnn_lstm
from robust_speech_analysis_framework_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from robust_speech_analysis_framework_tpu_torch.ops.cuda import _build
from robust_speech_analysis_framework_tpu_torch.ops.cuda import lstm as lstm_ops
from robust_speech_analysis_framework_tpu_torch.serving import Predictor

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

KERNEL_TOL = 1e-5  # fp32 kernel vs fp32 plain version: summation order only
FLAGSHIP_TOL = 1e-4  # logits after convs + 2 biLSTM layers over 2240 steps
SERVING_TOL = 1e-3  # logits after a 12-layer random-init encoder + classifier

FRAMES_PER_SECOND = 49.9
SEQ_LEN, PAD_LEN, DIM, BATCH = 4378, 4480, 768, 128

SOURCE = "robust_speech_analysis_framework_tpu_torch/csrc/lstm_scan.cu"
PALLAS = "robust_speech_analysis_framework_tpu/ops/pallas/lstm.py"


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


def lstm_bound_ms(t: int, g: int, b: int, h: int) -> tuple:
    """Least time for the recurrence: gates in, Wh in, hs out once; per row
    and step a (H × 4H) matvec (2 ops a term), the gate add (4H) and the
    cell update (about 5H), at the fp32 CUDA-core peak."""
    bytes_moved = 4 * (t * g * b * 4 * h + g * h * 4 * h + t * g * b * h)
    ops = t * g * b * (2 * h * 4 * h + 4 * h + 5 * h)
    t_bytes = bytes_moved / PEAK_HBM_BYTES * 1e3
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_phase(dev: torch.device) -> dict:
    """K1/K2 against their plain versions; times at the batch and serving shapes."""
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = {"ragged": (37, 3, 8), "flagship": (2240, 128, 128), "serving": (4096, 1, 128)}
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
            if label == "ragged":
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
            log(f"[kernels] {name} {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"cuDNN nn.LSTM({h}, {h}, bidirectional={bidir}) one layer incl. its input "
                f"projection {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
            if label == "flagship":
                rec.update(timing)
            else:
                rec["serving"] = timing
        if label == "flagship":
            for tile in (1, 2, 4, 8):
                ms = cuda_ms(lambda: lstm_ops._launch(gates, wh, tile), 3)
                log(f"[kernels] lstm_scan_grouped flagship batch_tile={tile}: {ms:.4f} ms")
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


def profile_forward(model, x, lengths) -> None:
    """Device time by kernel over one flagship forward (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.inference_mode():
            model(x, lengths)
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
    log(f"[profile] one flagship forward: {wall_ms:.3f} ms wall, {total_ms:.3f} ms device "
        f"(device idle {max(0.0, 1 - total_ms / wall_ms):.1%} of the window)")
    for e in rows[:8]:
        log(f"[profile]   {device_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")


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

    lstm_ops.lstm_scan_grouped.launches = 0
    lstm_ops.lstm_scan.launches = 0
    preds = {f"predict({k})": predictor.predict(w) for k, w in waves.items()}
    for name, pred in predictor.predict_files(paths).items():
        preds[f"predict_files({name})"] = pred
    preds["predict_sequence(4378x768)"] = predictor.predict_sequence(sequence)
    torch.cuda.synchronize()
    launches = {"lstm_scan_grouped": lstm_ops.lstm_scan_grouped.launches,
                "lstm_scan": lstm_ops.lstm_scan.launches}

    for name, pred in preds.items():
        log(f"[serving] {name}: {pred.label} p(Patient)={pred.probability:.6f} "
            f"latency {pred.latency_seconds * 1e3:.3f} ms")
        if pred.logits.shape != (2,) or not np.isfinite(pred.logits).all():
            raise AssertionError(f"bad logits for {name}")
    log(f"[serving] kernel launches on the main path: {launches}")
    if launches["lstm_scan_grouped"] != 2 * len(preds):
        raise AssertionError("the serving path did not run K1 for every biLSTM layer")

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


def run(dev: torch.device, smi: str) -> None:
    """Every phase on ``dev``; prints the kernels' record and the result line."""
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(dev)}; TF32 off in every phase")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] nvcc for {_build.sources()}: {time.perf_counter() - t0:.2f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    records = kernel_phase(dev)
    flagship_phase(dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches = serving_phase(dev, tmp)

    kernels = []
    for name, line in (("lstm_scan_grouped", 180), ("lstm_scan", 81)):
        rec = records[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": f"{PALLAS}:{line}", "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "shape": rec["shape"],
            "on_main_path": name == "lstm_scan_grouped", "serving": rec["serving"],
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
