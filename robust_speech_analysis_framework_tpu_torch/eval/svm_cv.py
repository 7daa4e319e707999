"""SVM cross-validation engines (standard + nested with grid search).

Counterpart of ``robust_speech_analysis_framework_tpu/eval/svm_cv.py``, with
the reference's capabilities (src/cv_strategies.py):

* :func:`run_svm_standard_kfold_cv` (:13-80): stratified 5-fold; per fold
  scaler → SelectKBest(k fixed) → linear SVC with Platt probabilities on
  the train split, recording acc/F1/precision/recall/AUC, the selected
  feature names and the raw (y_true, y_prob) for ROC analysis.
* :func:`run_svm_nested_kfold_cv` (:83-167): outer 5-fold; inner 3-fold
  grid search over k (:func:`default_k_grid`) scored by macro-F1; the
  best-k pipeline refit on the whole outer train split and evaluated on the
  outer test fold, recording ``best_k_found``.

The work is in two pandas-free cores, :func:`standard_svm_cv` and
:func:`nested_svm_cv`, over a float array and its column names, returning
row dicts and predictions; the ``run_svm_*`` front doors keep the JAX
package's signatures and build the DataFrame (pandas is imported there).

``solver`` picks how the SVCs are fitted; nothing is chosen by which
hardware is present:

* ``"batched"`` (default): every fit of a run is a lane of one batched SMO
  solve on ``device`` (:func:`_fit_linear_svcs_batch`): the standard run's
  main and Platt calibration fits at once; the nested run's whole inner
  grid at once (phase A), then its best-k refits (phase B). The JAX
  package's ``device=True``.
* ``"host"``: the float64 host solver fold by fold, the reference's
  schedule (JAX ``device=False``); ``device`` is then only checked.

The JAX package's ``device=None`` (batched on an accelerator backend, host
on the CPU) is not carried.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..device import DeviceLike, resolve_device
from ..models.svm import (
    LinearSVC,
    StandardScaler,
    SVMPipeline,
    f_classif,
    fit_platt_sigmoid,
)
from ..models.svm_device import smo_linear_batch
from .metrics import classification_metrics, f1_macro
from .splits import StratifiedKFold

SOLVERS = ("batched", "host")


def _check_solver(solver: str) -> None:
    if solver not in SOLVERS:
        raise ValueError(f"solver must be one of {SOLVERS}, got {solver!r}")


def _fit_linear_svcs_batch(
    problems: Sequence[Tuple[np.ndarray, np.ndarray]],
    C: float,
    seed: int,
    probability: bool,
    calibration_folds: int = 5,
    device: DeviceLike = "cuda",
) -> List[LinearSVC]:
    """Fit many independent LinearSVCs as ONE batched SMO solve.

    Each problem is (X_fit, y); with ``probability`` every problem also
    contributes its Platt calibration folds (libsvm's internal stratified
    5-fold, exactly as models/svm.py:LinearSVC.fit) as extra lanes. Rows
    pad with a validity mask and features with zero columns, so every
    (fold × grid point × calibration) fit shares one (L, n, d) stack.
    """
    lanes: List[Tuple[np.ndarray, np.ndarray]] = []
    specs = []
    for Xk, y in problems:
        Xk = np.asarray(Xk, dtype=np.float64)
        y = np.asarray(y)
        classes = np.unique(y)
        if len(classes) != 2:
            raise ValueError("LinearSVC is binary; got classes " + str(classes))
        y_pm = np.where(y == classes[1], 1.0, -1.0)
        main = len(lanes)
        lanes.append((Xk, y_pm))
        calib = []
        if probability:
            folds = min(calibration_folds, int(min(np.bincount((y_pm > 0).astype(int)))))
            if folds >= 2:
                skf = StratifiedKFold(folds, shuffle=True, random_state=seed)
                for tr, te in skf.split(Xk, y_pm):
                    calib.append((len(lanes), te))
                    lanes.append((Xk[tr], y_pm[tr]))
        specs.append((main, calib, y_pm, classes, Xk))

    n_max = max(x.shape[0] for x, _ in lanes)
    d_max = max(x.shape[1] for x, _ in lanes)
    Xs = np.zeros((len(lanes), n_max, d_max), np.float32)
    ys = np.ones((len(lanes), n_max), np.float32)
    valid = np.zeros((len(lanes), n_max), bool)
    for lane, (x, y_pm) in enumerate(lanes):
        Xs[lane, : len(x), : x.shape[1]] = x
        ys[lane, : len(x)] = y_pm
        valid[lane, : len(x)] = True
    w, b, _ = smo_linear_batch(Xs, ys, valid, C=C, device=device)

    out: List[LinearSVC] = []
    for main, calib, y_pm, classes, Xk in specs:
        clf = LinearSVC(C=C, probability=probability, random_state=seed)
        clf.classes_ = classes
        d_i = Xk.shape[1]
        clf.coef_ = np.asarray(w[main][:d_i], dtype=np.float64)
        clf.intercept_ = float(b[main])
        if probability:
            if calib:
                dv = np.zeros(len(y_pm))
                for lane, te in calib:
                    dv[te] = Xk[te] @ np.asarray(w[lane][:d_i], np.float64) + float(b[lane])
            else:
                dv = Xk @ clf.coef_ + clf.intercept_
            clf._platt = fit_platt_sigmoid(dv, y_pm > 0)
        out.append(clf)
    return out


def default_k_grid(n_features: int) -> List[int]:
    """Reference k grids (cv_strategies.py:122-126), clamped to the feature
    count and de-duplicated: SelectKBest would silently clamp k>d, making the
    grid search fit identical duplicate models and report a best_k_found
    larger than the actual number of selected features."""
    grid = [5, 10, 15, 20, 25] if n_features < 50 else [10, 20, 30, 40, 50]
    seen, out = set(), []
    for k in grid:
        k = min(k, n_features)
        if k not in seen:
            seen.add(k)
            out.append(k)
    return out


def _fold_result(fold: int, pipe: SVMPipeline, X: np.ndarray, y: np.ndarray, te: np.ndarray,
                 columns: Sequence[str], best_k: Optional[int] = None) -> Tuple[dict, dict]:
    """One outer fold's result row and its (y_true, y_prob) record."""
    y_pred = pipe.predict(X[te])
    y_prob = pipe.predict_proba(X[te])[:, 1]
    row = {"fold": fold + 1}
    if best_k is not None:
        row["best_k_found"] = best_k
    row.update(classification_metrics(y[te], y_pred, y_prob))
    row["selected_features"] = [c for c, keep in zip(columns, pipe.get_support()) if keep]
    return row, {"y_true": y[te], "y_prob": y_prob}


def standard_svm_cv(
    X: np.ndarray,
    y: np.ndarray,
    columns: Optional[Sequence[str]] = None,
    n_splits: int = 5,
    n_features_to_select: int = 50,
    C: float = 1.0,
    seed: int = 42,
    solver: str = "batched",
    device: DeviceLike = "cuda",
) -> Tuple[List[dict], List[dict]]:
    """Fixed-k stratified K-fold SVM evaluation over a float array:
    (result rows, fold predictions). ``columns`` names the features
    (``f0``, ``f1``, ... by default)."""
    _check_solver(solver)
    device = resolve_device(device)
    X, y = np.asarray(X, dtype=float), np.asarray(y)
    columns = list(columns) if columns is not None else [f"f{i}" for i in range(X.shape[1])]
    folds = list(StratifiedKFold(n_splits=n_splits, shuffle=True, random_state=seed).split(X, y))

    pipes: List[SVMPipeline] = []
    if solver == "batched":
        problems = []
        for tr, _ in folds:
            pipe = SVMPipeline(k=n_features_to_select, C=C, probability=True, random_state=seed)
            Xs = pipe.scaler.fit_transform(X[tr])
            problems.append((pipe.selector.fit_transform(Xs, y[tr]), y[tr]))
            pipes.append(pipe)
        for pipe, clf in zip(pipes, _fit_linear_svcs_batch(problems, C, seed, probability=True,
                                                           device=device)):
            pipe.clf = clf
    else:
        for tr, _ in folds:
            pipes.append(SVMPipeline(k=n_features_to_select, C=C, probability=True,
                                     random_state=seed).fit(X[tr], y[tr]))

    results, fold_predictions = [], []
    for fold, ((_, te), pipe) in enumerate(zip(folds, pipes)):
        row, pred = _fold_result(fold, pipe, X, y, te, columns)
        results.append(row)
        fold_predictions.append(pred)
    return results, fold_predictions


def _grid_search_batched(X, y, outer_folds, ks, n_splits_inner, C, seed, device) -> List[int]:
    """Phase A: every (outer fold × inner fold × k) grid fit as one batched
    solve; the per-(outer, inner) scaler and ANOVA-F scores are shared
    across the k grid (SelectKBest only re-slices them). Returns each outer
    fold's best k."""
    problems, meta = [], []
    for fold, (tr, _) in enumerate(outer_folds):
        X_tr, y_tr = X[tr], y[tr]
        inner = StratifiedKFold(n_splits=n_splits_inner, shuffle=True, random_state=seed)
        for ii, (itr, ite) in enumerate(inner.split(X_tr, y_tr)):
            scaler = StandardScaler().fit(X_tr[itr])
            Xs = scaler.transform(X_tr[itr])
            scores, _ = f_classif(Xs, y_tr[itr])
            scores = np.where(np.isnan(scores), -np.inf, scores)
            order = np.argsort(scores, kind="mergesort")
            for ki, k in enumerate(ks):
                idx = np.sort(order[-min(k, Xs.shape[1]):])
                problems.append((Xs[:, idx], y_tr[itr]))
                meta.append((fold, ki, ii, scaler, idx, ite))
    clfs = _fit_linear_svcs_batch(problems, C, seed, probability=False, device=device)
    grid_scores = np.zeros((len(outer_folds), len(ks), n_splits_inner))
    for clf, (fold, ki, ii, scaler, idx, ite) in zip(clfs, meta):
        tr, _ = outer_folds[fold]
        X_tr, y_tr = X[tr], y[tr]
        y_pred = clf.predict(scaler.transform(X_tr[ite])[:, idx])
        grid_scores[fold, ki, ii] = f1_macro(y_tr[ite], y_pred)
    return [ks[int(np.argmax(grid_scores[fold].mean(axis=1)))] for fold in range(len(outer_folds))]


def _grid_search_host(X_tr, y_tr, ks, n_splits_inner, C, seed) -> int:
    """Mean inner-fold macro-F1 per k, fit after fit on the host. The inner
    splitter is re-seeded per outer fold exactly as GridSearchCV re-splits
    the same cv object on each training set."""
    inner = StratifiedKFold(n_splits=n_splits_inner, shuffle=True, random_state=seed)
    inner_splits = list(inner.split(X_tr, y_tr))
    mean_scores = []
    for k in ks:
        scores = []
        for itr, ite in inner_splits:
            pipe = SVMPipeline(k=k, C=C, probability=False, random_state=seed)
            pipe.fit(X_tr[itr], y_tr[itr])
            scores.append(f1_macro(y_tr[ite], pipe.predict(X_tr[ite])))
        mean_scores.append(float(np.mean(scores)))
    return ks[int(np.argmax(mean_scores))]


def nested_svm_cv(
    X: np.ndarray,
    y: np.ndarray,
    columns: Optional[Sequence[str]] = None,
    n_splits_outer: int = 5,
    n_splits_inner: int = 3,
    k_grid: Optional[Sequence[int]] = None,
    C: float = 1.0,
    seed: int = 42,
    solver: str = "batched",
    device: DeviceLike = "cuda",
) -> Tuple[List[dict], List[dict]]:
    """Nested CV over a float array: inner grid search over k, outer
    unbiased evaluation; (result rows with ``best_k_found``, fold
    predictions)."""
    _check_solver(solver)
    device = resolve_device(device)
    X, y = np.asarray(X, dtype=float), np.asarray(y)
    columns = list(columns) if columns is not None else [f"f{i}" for i in range(X.shape[1])]
    ks = list(k_grid) if k_grid is not None else default_k_grid(X.shape[1])
    outer = StratifiedKFold(n_splits=n_splits_outer, shuffle=True, random_state=seed)
    outer_folds = list(outer.split(X, y))

    if solver == "batched":
        best_ks = _grid_search_batched(X, y, outer_folds, ks, n_splits_inner, C, seed, device)
        # phase B: the best-k refit per outer fold (+ calibration lanes)
        best_pipes, refit_problems = [], []
        for fold, (tr, _) in enumerate(outer_folds):
            pipe = SVMPipeline(k=best_ks[fold], C=C, probability=True, random_state=seed)
            Xs = pipe.scaler.fit_transform(X[tr])
            refit_problems.append((pipe.selector.fit_transform(Xs, y[tr]), y[tr]))
            best_pipes.append(pipe)
        for pipe, clf in zip(best_pipes, _fit_linear_svcs_batch(
                refit_problems, C, seed, probability=True, device=device)):
            pipe.clf = clf
    else:
        best_ks, best_pipes = [], []
        for tr, _ in outer_folds:
            best_ks.append(_grid_search_host(X[tr], y[tr], ks, n_splits_inner, C, seed))
            best_pipes.append(SVMPipeline(k=best_ks[-1], C=C, probability=True,
                                          random_state=seed).fit(X[tr], y[tr]))

    results, fold_predictions = [], []
    for fold, ((_, te), pipe) in enumerate(zip(outer_folds, best_pipes)):
        row, pred = _fold_result(fold, pipe, X, y, te, columns, best_k=best_ks[fold])
        results.append(row)
        fold_predictions.append(pred)
    return results, fold_predictions


def _columns_and_values(X) -> Tuple[List[str], np.ndarray]:
    """A DataFrame's column names and float values, or ``f{i}`` names for
    an array."""
    if hasattr(X, "columns"):
        return list(X.columns), X.to_numpy(dtype=float)
    X = np.asarray(X, dtype=float)
    return [f"f{i}" for i in range(X.shape[1])], X


def run_svm_standard_kfold_cv(
    X,
    y,
    n_splits: int = 5,
    n_features_to_select: int = 50,
    C: float = 1.0,
    seed: int = 42,
    solver: str = "batched",
    device: DeviceLike = "cuda",
):
    """Fixed-k stratified K-fold SVM evaluation of a DataFrame (or array):
    (results_df, fold_predictions), the reference's contract."""
    import pandas as pd

    columns, values = _columns_and_values(X)
    results, preds = standard_svm_cv(
        values, np.asarray(y), columns, n_splits=n_splits,
        n_features_to_select=n_features_to_select, C=C, seed=seed, solver=solver, device=device,
    )
    return pd.DataFrame(results), preds


def run_svm_nested_kfold_cv(
    X,
    y,
    n_splits_outer: int = 5,
    n_splits_inner: int = 3,
    k_grid: Optional[Sequence[int]] = None,
    C: float = 1.0,
    seed: int = 42,
    solver: str = "batched",
    device: DeviceLike = "cuda",
):
    """Nested CV of a DataFrame (or array): (results_df with
    ``best_k_found``, fold_predictions), the reference's contract."""
    import pandas as pd

    columns, values = _columns_and_values(X)
    results, preds = nested_svm_cv(
        values, np.asarray(y), columns, n_splits_outer=n_splits_outer,
        n_splits_inner=n_splits_inner, k_grid=k_grid, C=C, seed=seed, solver=solver,
        device=device,
    )
    return pd.DataFrame(results), preds
