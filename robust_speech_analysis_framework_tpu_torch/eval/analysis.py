"""Result analysis: summary tables, optimism bias, stability measures.

The reference's notebooks end with analysis cells (SURVEY.md §2 C15/C16):
summary tables of mean±std metrics (nb02 cell 4), optimistic-bias analysis
(standard − nested deltas, nb02 cells 5-7), interview-vs-reading gains,
feature-selection stability via per-fold counts (nb02 cell 12), mean ROC
interpolation (nb02 cell 11), CNN-LSTM dimension-level stability from
first-conv weights (nb03 cells 10-17), and tuned-hyperparameter summaries
(nb03 cell 18). This module provides those computations as functions over
the result dictionaries produced by :mod:`..experiments`.

Copy of ``robust_speech_analysis_framework_tpu/eval/analysis.py``; pandas is
imported inside each function that builds a frame, so importing this module
needs none.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Mapping

import numpy as np

METRICS = ["accuracy", "f1_score", "precision", "recall", "auc"]


def summarize_results(results: Mapping[str, dict]) -> pd.DataFrame:
    """Experiment → mean±std row per metric (nb02 cell 4 table)."""
    import pandas as pd

    rows = []
    for name, payload in results.items():
        df = payload["results_df"]
        row = {"experiment": name}
        for m in METRICS:
            if m in df.columns:
                row[f"{m}_mean"] = float(df[m].mean())
                row[f"{m}_std"] = float(df[m].std())
        rows.append(row)
    return pd.DataFrame(rows).set_index("experiment")


def optimism_bias(results: Mapping[str, dict], metric: str = "f1_score") -> pd.DataFrame:
    """standard − nested metric deltas per dataset (nb02 cells 5-7).

    Positive values measure how much the fixed-hyperparameter ('standard')
    protocol overestimates performance relative to nested CV.
    """
    import pandas as pd

    rows = []
    base_names = sorted(
        {n[: -len("_standard")] for n in results if n.endswith("_standard")}
    )
    for base in base_names:
        std_name, nest_name = f"{base}_standard", f"{base}_nested"
        if nest_name not in results:
            continue
        s = results[std_name]["results_df"][metric].mean()
        n = results[nest_name]["results_df"][metric].mean()
        rows.append({"dataset": base, f"{metric}_standard": float(s),
                     f"{metric}_nested": float(n), "bias": float(s - n)})
    return pd.DataFrame(rows)


def task_gain(results: Mapping[str, dict], metric: str = "f1_score",
              protocol: str = "nested") -> pd.DataFrame:
    """Interview-vs-reading metric gain per feature set (nb02 cells 8-9)."""
    import pandas as pd

    rows = []
    for fs in ("mshds", "opensmile", "wav2vec2"):
        r_name = f"{fs}_reading_{protocol}"
        i_name = f"{fs}_interview_{protocol}"
        if r_name not in results or i_name not in results:
            continue
        r = results[r_name]["results_df"][metric].mean()
        i = results[i_name]["results_df"][metric].mean()
        rows.append({"feature_set": fs, "reading": float(r),
                     "interview": float(i), "gain": float(i - r)})
    return pd.DataFrame(rows)


def feature_selection_stability(results_df: pd.DataFrame) -> pd.DataFrame:
    """How often each feature is selected across folds (nb02 cell 12)."""
    import pandas as pd

    counter: Counter = Counter()
    for features in results_df["selected_features"]:
        counter.update(features)
    n_folds = len(results_df)
    return pd.DataFrame(
        [{"feature": f, "count": c, "fraction": c / n_folds}
         for f, c in counter.most_common()]
    )


def dimension_stability(weights: np.ndarray, top_k: int = 50) -> Dict[str, object]:
    """CNN-LSTM input-dimension stability from per-fold first-conv
    importance vectors (nb03 cells 10-17).

    ``weights``: (n_folds, input_dim). Returns per-dim selection counts over
    each fold's top-k dims and the mean pairwise Jaccard overlap.
    """
    import pandas as pd

    n_folds, dim = weights.shape
    top_sets = [set(np.argsort(-w)[:top_k].tolist()) for w in weights]
    counts = Counter()
    for s in top_sets:
        counts.update(s)
    overlaps = []
    for i in range(n_folds):
        for j in range(i + 1, n_folds):
            inter = len(top_sets[i] & top_sets[j])
            union = len(top_sets[i] | top_sets[j])
            overlaps.append(inter / union)
    stable = [d for d, c in counts.items() if c == n_folds]
    return {
        "counts": pd.DataFrame(
            [{"dim": d, "count": c} for d, c in counts.most_common()]
        ),
        "mean_jaccard": float(np.mean(overlaps)) if overlaps else float("nan"),
        "always_selected": sorted(stable),
    }


def tuned_param_summary(results_df: pd.DataFrame) -> pd.DataFrame:
    """Mode/mean of tuned hyperparameters across outer folds (nb03 cell 18)."""
    import pandas as pd

    params: Dict[str, List] = {}
    for bp in results_df["best_params"]:
        for k, v in bp.items():
            params.setdefault(k, []).append(v)
    rows = []
    for k, vals in params.items():
        # continuous params (floats) average; categorical (ints/str) take
        # the mode — the reference's nb03 cell 18 convention
        if all(isinstance(v, float) and not isinstance(v, bool) for v in vals):
            rows.append({"param": k, "summary": float(np.mean(vals)), "kind": "mean"})
        else:
            mode = Counter(vals).most_common(1)[0][0]
            rows.append({"param": k, "summary": mode, "kind": "mode"})
    return pd.DataFrame(rows).set_index("param")
