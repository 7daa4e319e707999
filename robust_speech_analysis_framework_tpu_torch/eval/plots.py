"""Publication-style result plots (the reference notebooks' figure cells).

Matplotlib renderings of the analyses in :mod:`.analysis`: metric box plots
across folds (nb02 cell 10), mean±std ROC curves (nb02 cell 11 / nb03),
optimism-bias bars (nb02 cells 5-7), and train/val loss curves (nb03 cell 5).
Each function returns the Figure; callers save or display.

Copy of ``robust_speech_analysis_framework_tpu/eval/plots.py``: matplotlib
(Agg backend) is imported inside ``_plt``, so importing this module needs
none.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from .metrics import mean_roc_interpolated


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def metric_boxplot(results: Mapping[str, dict], metric: str = "f1_score",
                   title: Optional[str] = None):
    """Across-fold metric distributions per experiment."""
    plt = _plt()
    names = list(results)
    data = [np.asarray(results[n]["results_df"][metric]) for n in names]
    fig, ax = plt.subplots(figsize=(max(6, len(names) * 0.9), 4.5))
    ax.boxplot(data, tick_labels=names)
    ax.set_ylabel(metric)
    ax.set_title(title or f"{metric} across folds")
    ax.tick_params(axis="x", rotation=60)
    fig.tight_layout()
    return fig


def mean_roc_plot(named_predictions: Mapping[str, List[dict]],
                  title: str = "Mean ROC across folds"):
    """Mean±std interpolated ROC per experiment (100-point FPR grid)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5.5, 5))
    for name, preds in named_predictions.items():
        grid, mean_tpr, std_tpr = mean_roc_interpolated(preds)
        auc = float(np.trapezoid(mean_tpr, grid))
        ax.plot(grid, mean_tpr, label=f"{name} (AUC {auc:.3f})")
        ax.fill_between(grid, np.clip(mean_tpr - std_tpr, 0, 1),
                        np.clip(mean_tpr + std_tpr, 0, 1), alpha=0.15)
    ax.plot([0, 1], [0, 1], "k--", lw=0.8)
    ax.set_xlabel("False positive rate")
    ax.set_ylabel("True positive rate")
    ax.set_title(title)
    ax.legend(fontsize=8)
    fig.tight_layout()
    return fig


def bias_bar_plot(bias_df, metric: str = "f1_score"):
    """standard − nested optimism bias per dataset (analysis.optimism_bias)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(max(5, len(bias_df) * 0.8), 4))
    ax.bar(bias_df["dataset"], bias_df["bias"])
    ax.axhline(0, color="k", lw=0.8)
    ax.set_ylabel(f"{metric} bias (standard − nested)")
    ax.tick_params(axis="x", rotation=60)
    fig.tight_layout()
    return fig


def loss_curves_plot(histories: Sequence[dict], title: str = "Training curves"):
    """Per-fold train/val loss trajectories (nb03 cell 5)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    for i, h in enumerate(histories):
        ax.plot(h["train"], alpha=0.8, label=f"fold {i + 1} train")
        ax.plot(h["val"], alpha=0.8, ls="--", label=f"fold {i + 1} val")
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.set_title(title)
    ax.legend(fontsize=7, ncol=2)
    fig.tight_layout()
    return fig


def save_all(results: Mapping[str, dict], out_dir: str) -> Dict[str, str]:
    """Render the standard figure set for an experiment collection."""
    import os

    from .analysis import optimism_bias

    os.makedirs(out_dir, exist_ok=True)
    written = {}

    fig = metric_boxplot(results)
    p = os.path.join(out_dir, "f1_boxplot.png")
    fig.savefig(p, dpi=120)
    written["f1_boxplot"] = p

    preds = {n: r["predictions"] for n, r in results.items() if "predictions" in r}
    if preds:
        fig = mean_roc_plot(preds)
        p = os.path.join(out_dir, "mean_roc.png")
        fig.savefig(p, dpi=120)
        written["mean_roc"] = p

    bias = optimism_bias(results)
    if len(bias):
        fig = bias_bar_plot(bias)
        p = os.path.join(out_dir, "optimism_bias.png")
        fig.savefig(p, dpi=120)
        written["optimism_bias"] = p

    for name, r in results.items():
        if "histories" not in r:
            continue
        fig = loss_curves_plot(r["histories"])
        p = os.path.join(out_dir, f"loss_curves_{name}.png")
        fig.savefig(p, dpi=120)
        written[f"loss_curves_{name}"] = p
    return written
