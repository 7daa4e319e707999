"""Command-line interface: extract / svm / cnnlstm / predict / reproduce.

Counterpart of ``robust_speech_analysis_framework_tpu/cli.py``. The
reference ships no CLI (its entry points are three notebooks run in order);
these commands run the same workflows:

    python -m robust_speech_analysis_framework_tpu_torch.cli extract \\
        --corpus /data/Androids-Corpus --out data/Processed_Features \\
        --wav2vec2-checkpoint /models/wav2vec2-base-960h
    python -m robust_speech_analysis_framework_tpu_torch.cli svm \\
        --processed data/Processed_Features --out results/all_svm_results.pkl
    python -m robust_speech_analysis_framework_tpu_torch.cli cnnlstm \\
        --processed data/Processed_Features --corpus /data/Androids-Corpus \\
        --out results --models models

Every command runs on the card unless given ``--device cpu``. ``extract``
and ``cnnlstm`` take the JAX CLI's ``--devices``/``--mp`` flags: by default
they split over every CUDA device when there are several
(``parallel.mesh.auto_mesh``); ``--devices 1`` keeps one device;
``--devices N --mp M`` lays an (N/M, M) grid over the first N CUDA devices,
or over N CPU entries with ``--device cpu``. The JAX CLI's ``bench``
command (which runs the JAX ``bench.py``) is not carried.
"""

from __future__ import annotations

import argparse
import sys


def _w2v2_precision_kwargs(precision: str) -> dict:
    """'strict' = float32 end to end; 'fast' = int16 waveform upload +
    bfloat16 matmuls and convs + float16 sequence download; 'fastest' =
    'fast' with int8 per-frame quantised sequence download."""
    if precision in ("fast", "fastest"):
        import numpy as np

        return {
            "compute_dtype": "bfloat16",
            "sequence_transfer_dtype": np.int8 if precision == "fastest" else np.float16,
            "upload_dtype": np.int16,
        }
    return {}


def _mesh_from_args(args):
    """The ``mesh`` argument of ``--devices``/``--mp``: ``"auto"`` without
    flags, None for ``--devices 1``, else an explicit (N/M, M) grid (over N
    CPU entries with ``--device cpu``; raises when fewer than N CUDA
    devices exist)."""
    n, mp = args.devices, args.mp
    if n is None:
        if mp != 1:
            raise SystemExit("error: --mp needs --devices")
        return "auto"
    if n == 1:
        return None
    from .parallel.mesh import make_mesh

    if args.device == "cpu":
        return make_mesh(devices=["cpu"] * n, mp=mp)
    return make_mesh(n_devices=n, mp=mp)


def _cmd_extract(args) -> int:
    from .experiments import extract_all_features
    from .features.wav2vec2 import Wav2Vec2Extractor

    features = args.features.split(",")
    extractor = None
    mesh = _mesh_from_args(args)
    w2v2_kw = dict(_w2v2_precision_kwargs(args.wav2vec2_precision), device=args.device)
    if mesh is not None:
        from .parallel.mesh import resolve_mesh

        w2v2_kw["mesh"] = resolve_mesh(mesh, args.device)
    if args.wav2vec2_checkpoint:
        extractor = Wav2Vec2Extractor.from_hf_checkpoint(args.wav2vec2_checkpoint, **w2v2_kw)
    elif args.allow_random_wav2vec2:
        extractor = Wav2Vec2Extractor(allow_random_init=True, **w2v2_kw)
    elif "wav2vec2" in features:
        # fail fast: otherwise the mshds/opensmile stages run for minutes
        # before the wav2vec2 stage hits the random-weights guard
        print(
            "error: --features includes wav2vec2 but no --wav2vec2-checkpoint "
            "was given (the reference always runs pretrained "
            "facebook/wav2vec2-base-960h). Pass --wav2vec2-checkpoint PATH, "
            "--allow-random-wav2vec2 (throughput testing only), or drop "
            "wav2vec2 from --features.",
            file=sys.stderr,
        )
        return 2
    opensmile_config = None
    if args.opensmile_conf:
        from .features.conf_parser import opensmile_config_from_conf

        with open(args.opensmile_conf) as fh:
            opensmile_config = opensmile_config_from_conf(fh.read())
    if args.opensmile_reference_compat:
        from dataclasses import replace

        from .features.opensmile import OpenSmileConfig

        opensmile_config = replace(opensmile_config or OpenSmileConfig(), reference_compat=True)
    paths = extract_all_features(
        args.corpus,
        args.out,
        features=features,
        skip_existing=not args.force,
        wav2vec2_extractor=extractor,
        opensmile_config=opensmile_config,
        verbose=not args.quiet,
        device=args.device,
        mesh=mesh,
    )
    for name, path in paths.items():
        print(f"{name}: {path}")
    return 0


def _cmd_svm(args) -> int:
    from .experiments import run_all_svm_experiments

    results = run_all_svm_experiments(
        args.processed,
        out_path=args.out,
        n_features_standard=args.k_standard,
        skip_existing=not args.force,
        verbose=not args.quiet,
        solver=args.solver,
        device=args.device,
    )
    for name, r in results.items():
        df = r["results_df"]
        print(
            f"{name}: acc {df['accuracy'].mean():.3f}±{df['accuracy'].std():.3f} "
            f"f1 {df['f1_score'].mean():.3f} auc {df['auc'].mean():.3f}"
        )
    return 0


def _cmd_cnnlstm(args) -> int:
    from .experiments import run_cnn_lstm_experiments

    results = run_cnn_lstm_experiments(
        args.processed,
        args.corpus,
        args.out,
        models_dir=args.models,
        n_trials=args.trials,
        skip_existing=not args.force,
        verbose=not args.quiet,
        trial_batch=args.trial_batch,
        device=args.device,
        mesh=_mesh_from_args(args),
    )
    for name, r in results.items():
        df = r["results_df"]
        print(
            f"{name}: f1 {df['f1_score'].mean():.3f}±{df['f1_score'].std():.3f} "
            f"auc {df['auc'].mean():.3f}"
        )
    return 0


def _cmd_predict(args) -> int:
    from .features.wav2vec2 import Wav2Vec2Extractor
    from .serving import Predictor

    extractor = None
    if args.wav2vec2_checkpoint:
        extractor = Wav2Vec2Extractor.from_hf_checkpoint(
            args.wav2vec2_checkpoint, device=args.device,
            **_w2v2_precision_kwargs(args.wav2vec2_precision),
        )
    load = Predictor.from_reference_checkpoint if args.reference_format else Predictor.from_checkpoint
    predictor = load(args.model, extractor, device=args.device)
    out = predictor.predict_files(args.audio)
    for name, pred in out.items():
        print(f"{name}: {pred.label} (P(Patient)={pred.probability:.3f}, "
              f"{pred.latency_seconds * 1e3:.0f} ms)")
    return 0


def _cmd_reproduce(args) -> int:
    from .eval.reproduce import run_reproduction

    comparison = run_reproduction(
        args.corpus, args.processed,
        wav2vec2_checkpoint=args.wav2vec2_checkpoint,
        out_dir=args.out_dir, verbose=not args.quiet, device=args.device,
    )
    n_off = int((~comparison["within_noise"] & ~comparison["missing"]).sum())
    return 1 if n_off else 0


def _add_device_flag(p) -> None:
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the command computes (default: the card; without one, "
             "pass --device cpu)",
    )


def _add_mesh_flags(p) -> None:
    p.add_argument(
        "--devices", type=int, default=None,
        help="devices to split over (default: every CUDA device when there are "
             "several; --devices 1 keeps one device; with --device cpu, N CPU entries)",
    )
    p.add_argument(
        "--mp", type=int, default=1,
        help="model-parallel axis of the (dp, mp) grid (must divide --devices; "
             "dp = devices / mp)",
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="robust_speech_analysis_framework_tpu_torch",
        description="Speech analysis framework CLI (PyTorch/CUDA port)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("extract", help="run corpus feature extraction")
    p.add_argument("--corpus", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--features", default="mshds,opensmile,wav2vec2")
    p.add_argument(
        "--wav2vec2-checkpoint", default=None,
        help="local HF wav2vec2-base-960h checkpoint dir; REQUIRED for "
             "meaningful wav2vec2 features (the reference always runs "
             "pretrained weights)",
    )
    p.add_argument(
        "--allow-random-wav2vec2", action="store_true",
        help="run wav2vec2 on random weights (throughput testing only; "
             "embeddings are meaningless)",
    )
    p.add_argument(
        "--opensmile-conf", default=None,
        help="openSMILE .conf file (Androids.conf subset) configuring the "
             "911-feature extractor declaratively",
    )
    p.add_argument(
        "--opensmile-reference-compat", action="store_true",
        help="emit the reference's observed 911-column openSMILE schema "
             "(first emitted feature dropped, matching the reference's "
             "instname-column assumption, src/opensmile_extractor.py:83); "
             "default is the full native 912-column schema",
    )
    p.add_argument(
        "--wav2vec2-precision", choices=("strict", "fast", "fastest"), default="strict",
        help="'strict' (default) is float32 end to end; 'fast' uses an int16 "
             "waveform upload, bfloat16 matmuls and convs and a float16 "
             "sequence download; 'fastest' adds an int8 per-frame quantised "
             "sequence download",
    )
    p.add_argument("--force", action="store_true")
    p.add_argument("--quiet", action="store_true")
    _add_device_flag(p)
    _add_mesh_flags(p)
    p.set_defaults(fn=_cmd_extract)

    p = sub.add_parser("svm", help="run the 18 SVM CV experiments")
    p.add_argument("--processed", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--k-standard", type=int, default=25)
    p.add_argument(
        "--solver", choices=("batched", "host"), default="batched",
        help="'batched' (default) fits every SVC of a run as one batched SMO "
             "solve on --device; 'host' fits them one by one with the float64 "
             "host solver, the reference's schedule",
    )
    p.add_argument("--force", action="store_true")
    p.add_argument("--quiet", action="store_true")
    _add_device_flag(p)
    p.set_defaults(fn=_cmd_svm)

    p = sub.add_parser("cnnlstm", help="run the 6 CNN-LSTM CV experiments")
    p.add_argument("--processed", required=True)
    p.add_argument("--corpus", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--models", default=None)
    p.add_argument("--trials", type=int, default=25)
    p.add_argument(
        "--trial-batch", type=int, default=8,
        help="TPE ask-K round size: K trials of one architecture train "
             "together as lanes. 1 = the reference's sequential per-trial "
             "schedule (posterior updates after every trial)",
    )
    p.add_argument("--force", action="store_true")
    p.add_argument("--quiet", action="store_true")
    _add_device_flag(p)
    _add_mesh_flags(p)
    p.set_defaults(fn=_cmd_cnnlstm)

    p = sub.add_parser("predict", help="classify audio files with a trained model")
    p.add_argument("--model", required=True)
    p.add_argument("audio", nargs="+")
    p.add_argument("--reference-format", action="store_true",
                   help="load a reference torch .pt checkpoint")
    p.add_argument("--wav2vec2-checkpoint", default=None)
    p.add_argument("--wav2vec2-precision", choices=("strict", "fast", "fastest"),
                   default="strict")
    _add_device_flag(p)
    p.set_defaults(fn=_cmd_predict)

    p = sub.add_parser(
        "reproduce",
        help="run the full 24-experiment battery and diff every metric "
             "against the reference's published tables (BASELINE.md §6)",
    )
    p.add_argument("--corpus", required=True)
    p.add_argument("--processed", required=True)
    p.add_argument("--wav2vec2-checkpoint", default=None)
    p.add_argument("--out-dir", default=None,
                   help="directory for the comparison CSV + JSON report "
                        "(default: <processed>/reproduction)")
    p.add_argument("--quiet", action="store_true")
    _add_device_flag(p)
    p.set_defaults(fn=_cmd_reproduce)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
