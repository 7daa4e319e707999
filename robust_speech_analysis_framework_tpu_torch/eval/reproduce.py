"""Quality-metric reproduction harness.

Runs the reference's full 24-experiment battery (18 SVM, nb02 cell 3; 6
CNN-LSTM, nb03 cells 3/7) through this framework's pipelines and diffs
every published metric (BASELINE.md §6 / SURVEY.md §6, i.e. the notebook
outputs of `ayushpradhan-dev/robust-speech-analysis-framework`) against the
reproduction, flagging anything outside the published cross-validation
noise band. Needs the Androids corpus on disk (RSAF_CORPUS_DIR) and a
Wav2Vec2 checkpoint — neither ships in CI, so the full run is gated; the
comparison logic itself is pure and unit-tested.

Copy of ``robust_speech_analysis_framework_tpu/eval/reproduce.py`` over the
port's pipelines; pandas is imported inside the functions that build frames.

Usage:
    python -m robust_speech_analysis_framework_tpu_torch.cli reproduce \
        --corpus ... --processed ... --wav2vec2-checkpoint ...
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Mapping, Optional

import numpy as np

from ..device import DeviceLike

# Published mean±std over 5 stratified folds — nb02 cell 4 (SVM) and nb03
# cells 6/9 (CNN-LSTM) outputs, transcribed in BASELINE.md.
PUBLISHED_SVM: Dict[str, dict] = {
    "mshds_reading_standard":      {"accuracy": (0.738, 0.076), "f1_macro": (0.735, 0.081), "auc": (0.810, 0.068)},
    "mshds_reading_nested":        {"accuracy": (0.711, 0.176), "f1_macro": (0.706, 0.176), "auc": (0.764, 0.181)},
    "opensmile_reading_standard":  {"accuracy": (0.594, 0.100), "f1_macro": (0.586, 0.104), "auc": (0.572, 0.096)},
    "opensmile_reading_nested":    {"accuracy": (0.566, 0.093), "f1_macro": (0.563, 0.094), "auc": (0.565, 0.105)},
    "wav2vec2_reading_standard":   {"accuracy": (0.666, 0.070), "f1_macro": (0.664, 0.071), "auc": (0.703, 0.096)},
    "wav2vec2_reading_nested":     {"accuracy": (0.658, 0.039), "f1_macro": (0.654, 0.036), "auc": (0.766, 0.090)},
    "mshds_interview_standard":    {"accuracy": (0.724, 0.098), "f1_macro": (0.718, 0.101), "auc": (0.769, 0.141)},
    "mshds_interview_nested":      {"accuracy": (0.714, 0.095), "f1_macro": (0.709, 0.094), "auc": (0.766, 0.121)},
    "opensmile_interview_standard": {"accuracy": (0.688, 0.035), "f1_macro": (0.685, 0.040), "auc": (0.738, 0.040)},
    "opensmile_interview_nested":  {"accuracy": (0.743, 0.077), "f1_macro": (0.739, 0.081), "auc": (0.798, 0.054)},
    "wav2vec2_interview_standard": {"accuracy": (0.699, 0.121), "f1_macro": (0.697, 0.120), "auc": (0.790, 0.087)},
    "wav2vec2_interview_nested":   {"accuracy": (0.690, 0.128), "f1_macro": (0.687, 0.126), "auc": (0.757, 0.087)},
    "mshds_combined_standard":     {"accuracy": (0.761, 0.059), "f1_macro": (0.758, 0.059), "auc": (0.832, 0.106)},
    "mshds_combined_nested":       {"accuracy": (0.697, 0.060), "f1_macro": (0.693, 0.058), "auc": (0.783, 0.112)},
    "opensmile_combined_standard": {"accuracy": (0.679, 0.028), "f1_macro": (0.676, 0.032), "auc": (0.728, 0.033)},
    "opensmile_combined_nested":   {"accuracy": (0.726, 0.105), "f1_macro": (0.721, 0.107), "auc": (0.789, 0.062)},
    "wav2vec2_combined_standard":  {"accuracy": (0.734, 0.098), "f1_macro": (0.732, 0.100), "auc": (0.808, 0.049)},
    "wav2vec2_combined_nested":    {"accuracy": (0.708, 0.092), "f1_macro": (0.706, 0.093), "auc": (0.806, 0.097)},
}

PUBLISHED_CNN_LSTM: Dict[str, dict] = {
    "wav2vec2_cnn_lstm_standard_reading":   {"f1_macro": (0.629, 0.134), "auc": (0.741, 0.096)},
    "wav2vec2_cnn_lstm_tuned_reading":      {"f1_macro": (0.700, 0.099), "auc": (0.779, 0.052), "accuracy": (0.704, 0.100)},
    "wav2vec2_cnn_lstm_standard_interview": {"f1_macro": (0.740, 0.088), "auc": (0.814, 0.072)},
    "wav2vec2_cnn_lstm_tuned_interview":    {"f1_macro": (0.770, 0.106), "auc": (0.865, 0.096), "accuracy": (0.771, 0.105)},
    "wav2vec2_cnn_lstm_standard_combined":  {"f1_macro": (0.607, 0.157), "auc": (0.777, 0.090)},
    "wav2vec2_cnn_lstm_tuned_combined":     {"f1_macro": (0.779, 0.086), "auc": (0.847, 0.093), "accuracy": (0.781, 0.086)},
}

# per-fold results_df column spellings per published-table metric (first
# entry = eval.metrics.classification_metrics schema; the rest cover
# externally produced pickles)
_METRIC_FALLBACKS = {
    "accuracy": ("accuracy",),
    "f1_macro": ("f1_score", "f1_macro", "f1"),
    "auc": ("auc", "roc_auc"),
}


def _mean_of(results_df, metric: str) -> float:
    for candidate in _METRIC_FALLBACKS[metric]:
        if candidate in results_df.columns:
            return float(np.nanmean(results_df[candidate].to_numpy(float)))
    return float("nan")


def compare_to_published(
    results: Mapping[str, Mapping],
    published: Optional[Mapping[str, dict]] = None,
    noise_sigmas: float = 2.0,
):
    """Diff reproduced per-fold results against the published tables.

    ``results``: {experiment_name: {'results_df': DataFrame with per-fold
    metric columns}} — the schema both ``run_all_svm_experiments`` and
    ``run_cnn_lstm_experiments`` emit. A reproduction is ``within_noise``
    when |ours − published_mean| ≤ noise_sigmas·published_std/√5 + published
    fold-level std accounts for small-sample CV variance; the reference's
    own per-fold stds are large (±0.1), so the default band is generous by
    construction — a failure flags a real pipeline divergence, not noise.
    Returns a DataFrame.
    """
    import pandas as pd

    published = {**PUBLISHED_SVM, **PUBLISHED_CNN_LSTM} if published is None \
        else published
    rows = []
    for name, pub in published.items():
        res = results.get(name)
        for metric, (mean, std) in pub.items():
            ours = float("nan")
            if res is not None and "results_df" in res:
                ours = _mean_of(res["results_df"], metric)
            # std of the MEAN of 5 folds ≈ fold_std/√5; allow noise_sigmas
            band = noise_sigmas * std / np.sqrt(5.0)
            rows.append({
                "experiment": name,
                "metric": metric,
                "ours": ours,
                "published_mean": mean,
                "published_std": std,
                "diff": ours - mean,
                "band": band,
                "within_noise": bool(abs(ours - mean) <= band)
                if np.isfinite(ours) else False,
                "missing": res is None,
            })
    return pd.DataFrame(rows)


def _json_sanitize(obj):
    """NaN/inf → None recursively so the report stays RFC-8259 JSON."""
    if isinstance(obj, dict):
        return {k: _json_sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_sanitize(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def reproduction_report(comparison) -> dict:
    """Summary dict for the JSON report."""
    done = comparison[~comparison["missing"]]
    return {
        "experiments_total": int(comparison["experiment"].nunique()),
        "experiments_run": int(done["experiment"].nunique()),
        "metrics_total": int(len(comparison)),
        "metrics_compared": int(done["ours"].notna().sum()),
        "metrics_within_noise": int(done["within_noise"].sum()),
        "worst_diffs": [
            {k: r[k] for k in ("experiment", "metric", "ours",
                               "published_mean", "diff")}
            for r in done.reindex(
                done["diff"].abs().sort_values(ascending=False).index
            ).head(5).to_dict("records")
        ],
    }


def run_reproduction(
    corpus_dir: str,
    processed_dir: str,
    wav2vec2_checkpoint: Optional[str] = None,
    out_dir: Optional[str] = None,
    verbose: bool = True,
    device: DeviceLike = "cuda",
):
    """Full 24-experiment battery + comparison (corpus + checkpoint needed).

    Mirrors nb01→nb02→nb03 end to end: extraction is cached in
    ``processed_dir`` (skip-if-exists), the SVM battery runs on the 9
    datasets, the CNN-LSTM battery on the 3 sequence sets (tuned +
    standard). Writes ``reproduction_report.json`` and the comparison CSV
    into ``out_dir`` (default: ``<processed_dir>/reproduction``) and
    returns the comparison DataFrame. Every stage runs on ``device``.
    """
    from ..experiments import (
        extract_all_features,
        run_all_svm_experiments,
        run_cnn_lstm_experiments,
    )
    from ..features.wav2vec2 import Wav2Vec2Extractor

    if wav2vec2_checkpoint is None:
        raise ValueError(
            "run_reproduction needs a pretrained Wav2Vec2 checkpoint "
            "(--wav2vec2-checkpoint): the reference's published numbers are "
            "meaningless against random-init embeddings."
        )
    extractor = Wav2Vec2Extractor.from_hf_checkpoint(wav2vec2_checkpoint, device=device)
    extract_all_features(
        corpus_dir, processed_dir,
        wav2vec2_extractor=extractor, verbose=verbose, device=device,
    )
    results: Dict[str, Mapping] = {}
    results.update(run_all_svm_experiments(
        processed_dir,
        out_path=os.path.join(processed_dir, "all_svm_results.pkl"),
        verbose=verbose, device=device,
    ))
    dl = run_cnn_lstm_experiments(
        processed_dir, corpus_dir,
        out_dir=os.path.join(processed_dir, "dl_results"),
        verbose=verbose, device=device,
    )
    # experiments.py keys are tuned_{kind}/standard_{kind}; the published
    # table names them wav2vec2_cnn_lstm_{mode}_{kind}
    for key, val in dl.items():
        mode, _, kind = key.partition("_")
        results[f"wav2vec2_cnn_lstm_{mode}_{kind}"] = val

    comparison = compare_to_published(results)
    report = reproduction_report(comparison)
    base = out_dir or os.path.join(processed_dir, "reproduction")
    os.makedirs(base, exist_ok=True)
    comparison.to_csv(os.path.join(base, "reproduction_comparison.csv"),
                      index=False)
    with open(os.path.join(base, "reproduction_report.json"), "w") as fh:
        json.dump(_json_sanitize(report), fh, indent=2)
    if verbose:
        print(json.dumps(report, indent=2))
    return comparison
