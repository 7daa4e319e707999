"""Linear SVM (C-SVC) with Platt probability calibration, plus the
preprocessing stages the reference pipelines use (standardization, ANOVA-F
feature scoring).

Copy of ``robust_speech_analysis_framework_tpu/models/svm.py`` (pure numpy,
float64 on the host), kept here so the port imports nothing of the JAX
package; it is held bit for bit to that module by the tests.

Replaces scikit-learn's libsvm/Cython internals (reference usage:
src/cv_strategies.py:49-53 — Pipeline(StandardScaler → SelectKBest(f_classif)
→ SVC(kernel='linear', probability=True))). The solver is an SMO on the
C-SVC dual with maximal-violating-pair working-set selection and the libsvm
stopping rule (ε=1e-3), maintaining the primal weight vector incrementally
(linear kernel). Probability calibration follows Platt's sigmoid fit with
the Lin-Weng-Keerthi robust Newton iteration on out-of-fold decision values
from an internal stratified 5-fold CV.

This host solver fits one problem at a time, as the reference does; the
CV engines (eval/svm_cv.py) can instead stack every fit of a run into one
batched solve on the device (models/svm_device.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from ..eval.splits import StratifiedKFold


# ---------------------------------------------------------------------------
# Preprocessing
# ---------------------------------------------------------------------------

class StandardScaler:
    """Zero-mean unit-variance per feature (population std, ddof=0)."""

    def fit(self, X: np.ndarray) -> "StandardScaler":
        X = np.asarray(X, dtype=np.float64)
        self.mean_ = X.mean(axis=0)
        std = X.std(axis=0)
        self.scale_ = np.where(std == 0.0, 1.0, std)
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        return (np.asarray(X, dtype=np.float64) - self.mean_) / self.scale_

    def fit_transform(self, X: np.ndarray) -> np.ndarray:
        return self.fit(X).transform(X)


def f_classif(X: np.ndarray, y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """One-way ANOVA F-statistic per feature (sklearn-compatible)."""
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y)
    classes = np.unique(y)
    n = X.shape[0]
    overall_mean = X.mean(axis=0)
    ss_between = np.zeros(X.shape[1])
    ss_within = np.zeros(X.shape[1])
    for c in classes:
        Xc = X[y == c]
        mc = Xc.mean(axis=0)
        ss_between += len(Xc) * (mc - overall_mean) ** 2
        ss_within += ((Xc - mc) ** 2).sum(axis=0)
    df_between = len(classes) - 1
    df_within = n - len(classes)
    ms_between = ss_between / df_between
    ms_within = ss_within / max(df_within, 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        f = np.where(ms_within > 0, ms_between / ms_within, np.inf)
    f = np.where((ms_within == 0) & (ms_between == 0), 0.0, f)
    return f, np.full_like(f, np.nan)


class SelectKBest:
    """Keep the k features with the highest score (default f_classif)."""

    def __init__(self, score_func=f_classif, k: int = 10):
        self.score_func = score_func
        self.k = k

    def fit(self, X: np.ndarray, y: np.ndarray) -> "SelectKBest":
        scores, _ = self.score_func(X, y)
        scores = np.where(np.isnan(scores), -np.inf, scores)
        self.scores_ = scores
        k = min(self.k, X.shape[1])
        # Match sklearn: take the k largest by score (stable on ties via
        # argsort of negated scores).
        idx = np.sort(np.argsort(scores, kind="mergesort")[-k:])
        mask = np.zeros(X.shape[1], dtype=bool)
        mask[idx] = True
        self.support_ = mask
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(X)[:, self.support_]

    def fit_transform(self, X: np.ndarray, y: np.ndarray) -> np.ndarray:
        return self.fit(X, y).transform(X)

    def get_support(self) -> np.ndarray:
        return self.support_


# ---------------------------------------------------------------------------
# SMO solver
# ---------------------------------------------------------------------------

def _smo_linear(
    X: np.ndarray,
    y_pm: np.ndarray,
    C: float,
    tol: float = 1e-3,
    max_iter: int = 100_000,
) -> Tuple[np.ndarray, float, np.ndarray]:
    """SMO for the linear C-SVC dual. Returns (w, b, alpha).

    Maximal-violating-pair selection with the standard libsvm stopping
    criterion ``m(α) − M(α) ≤ tol``. The linear kernel lets both the
    gradient and the primal ``w`` update in O(n·d) per pair.
    """
    n, d = X.shape
    X = np.asarray(X, dtype=np.float64)
    alpha = np.zeros(n)
    grad = -np.ones(n)  # G = Qα − e with Q_ij = y_i y_j x_i·x_j
    sq = np.einsum("ij,ij->i", X, X)  # K_ii diagonal

    for _ in range(max_iter):
        yg = -y_pm * grad
        up = ((y_pm == 1) & (alpha < C)) | ((y_pm == -1) & (alpha > 0))
        low = ((y_pm == 1) & (alpha > 0)) | ((y_pm == -1) & (alpha < C))
        if not up.any() or not low.any():
            break
        i = np.flatnonzero(up)[np.argmax(yg[up])]
        j = np.flatnonzero(low)[np.argmin(yg[low])]
        m_val, M_val = yg[i], yg[j]
        if m_val - M_val <= tol:
            break

        # Feasible direction u = y_i·e_i − y_j·e_j keeps yᵀα fixed; the dual
        # is quadratic along it with curvature η = K_ii + K_jj − 2K_ij and
        # slope −(m − M), so the unconstrained step is λ* = (m − M)/η.
        Kij = X[i] @ X[j]
        eta = max(sq[i] + sq[j] - 2.0 * Kij, 1e-12)
        lam = (m_val - M_val) / eta
        # Box bounds on λ ≥ 0:
        lam = min(
            lam,
            (C - alpha[i]) if y_pm[i] > 0 else alpha[i],
            alpha[j] if y_pm[j] > 0 else (C - alpha[j]),
        )
        if lam <= 0:
            break
        alpha[i] += y_pm[i] * lam
        alpha[j] -= y_pm[j] * lam
        # ΔG = λ · y ∘ (K[:,i] − K[:,j])
        grad += lam * y_pm * (X @ X[i] - X @ X[j])

    yg = -y_pm * grad
    up = ((y_pm == 1) & (alpha < C)) | ((y_pm == -1) & (alpha > 0))
    low = ((y_pm == 1) & (alpha > 0)) | ((y_pm == -1) & (alpha < C))
    m_val = yg[up].max() if up.any() else 0.0
    M_val = yg[low].min() if low.any() else 0.0
    # Free SVs give the sharpest intercept estimate; fall back to midpoint.
    free = (alpha > 1e-12) & (alpha < C - 1e-12)
    if free.any():
        b = float(np.mean(yg[free]))
    else:
        b = (m_val + M_val) / 2.0
    w = (alpha * y_pm) @ X
    return w, b, alpha


# ---------------------------------------------------------------------------
# Platt scaling
# ---------------------------------------------------------------------------

def fit_platt_sigmoid(
    decision_values: np.ndarray, y01: np.ndarray, max_iter: int = 100
) -> Tuple[float, float]:
    """Fit P(y=1|f) = 1/(1+exp(A·f+B)) by regularized max likelihood.

    Newton iteration with backtracking from Lin, Weng & Keerthi (2007), the
    same algorithm libsvm uses for ``probability=True``. Targets use Platt's
    prior-corrected labels.
    """
    f = np.asarray(decision_values, dtype=np.float64)
    y = np.asarray(y01).astype(bool)
    prior1, prior0 = int(y.sum()), int((~y).sum())
    hi = (prior1 + 1.0) / (prior1 + 2.0)
    lo = 1.0 / (prior0 + 2.0)
    t = np.where(y, hi, lo)

    A, B = 0.0, np.log((prior0 + 1.0) / (prior1 + 1.0))
    min_step, sigma = 1e-10, 1e-12

    def fun(A, B):
        z = A * f + B
        # stable log(1+exp(z)) formulation
        pos = z >= 0
        loss = np.where(pos, t * z + np.log1p(np.exp(-z)),
                        (t - 1) * z + np.log1p(np.exp(z)))
        return loss.sum()

    fval = fun(A, B)
    for _ in range(max_iter):
        z = A * f + B
        p = np.where(z >= 0, np.exp(-z) / (1 + np.exp(-z)), 1 / (1 + np.exp(z)))
        q = 1.0 - p  # = sigmoid(z)
        d1 = t - p
        d2 = p * q
        g1 = float((f * d1).sum())
        g2 = float(d1.sum())
        if abs(g1) < 1e-5 and abs(g2) < 1e-5:
            break
        h11 = float((f * f * d2).sum()) + sigma
        h22 = float(d2.sum()) + sigma
        h21 = float((f * d2).sum())
        det = h11 * h22 - h21 * h21
        dA = -(h22 * g1 - h21 * g2) / det
        dB = -(-h21 * g1 + h11 * g2) / det
        gd = g1 * dA + g2 * dB
        step = 1.0
        while step >= min_step:
            nA, nB = A + step * dA, B + step * dB
            nf = fun(nA, nB)
            if nf < fval + 1e-4 * step * gd:
                A, B, fval = nA, nB, nf
                break
            step /= 2.0
        else:
            break
    return A, B


# ---------------------------------------------------------------------------
# Classifier
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LinearSVC:
    """Linear C-SVC with optional Platt probability calibration.

    ``probability=True`` fits the sigmoid on out-of-fold decision values from
    an internal stratified 5-fold CV (libsvm's scheme, deterministic here via
    the given random_state). Binary classes are taken in sorted order;
    decision > 0 predicts the larger class, matching sklearn's convention.
    """

    C: float = 1.0
    tol: float = 1e-3
    probability: bool = False
    random_state: int = 0
    calibration_folds: int = 5

    def fit(self, X: np.ndarray, y: np.ndarray) -> "LinearSVC":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        if len(self.classes_) != 2:
            raise ValueError("LinearSVC is binary; got classes " + str(self.classes_))
        y_pm = np.where(y == self.classes_[1], 1.0, -1.0)
        w, b, alpha = _smo_linear(X, y_pm, self.C, self.tol)
        self.coef_ = w
        self.intercept_ = b
        self.alpha_ = alpha

        if self.probability:
            folds = min(self.calibration_folds, int(min(np.bincount((y_pm > 0).astype(int)))))
            if folds >= 2:
                skf = StratifiedKFold(folds, shuffle=True, random_state=self.random_state)
                dv = np.zeros(len(y))
                for tr, te in skf.split(X, y_pm):
                    wf, bf, _ = _smo_linear(X[tr], y_pm[tr], self.C, self.tol)
                    dv[te] = X[te] @ wf + bf
            else:
                dv = X @ w + b
            self._platt = fit_platt_sigmoid(dv, y_pm > 0)
        return self

    def decision_function(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(X, dtype=np.float64) @ self.coef_ + self.intercept_

    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.where(self.decision_function(X) > 0, self.classes_[1], self.classes_[0])

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        if not hasattr(self, "_platt"):
            raise ValueError("fit with probability=True first")
        A, B = self._platt
        z = A * self.decision_function(X) + B
        p1 = np.where(z >= 0, np.exp(-z) / (1 + np.exp(-z)), 1 / (1 + np.exp(z)))
        return np.stack([1 - p1, p1], axis=1)


class SVMPipeline:
    """StandardScaler → SelectKBest(f_classif, k) → LinearSVC pipeline.

    The modeling pipeline of the reference's SVM experiments
    (src/cv_strategies.py:49-53), fit strictly on training folds.
    """

    def __init__(self, k: int = 50, C: float = 1.0, probability: bool = True,
                 random_state: int = 42):
        self.scaler = StandardScaler()
        self.selector = SelectKBest(f_classif, k=k)
        self.clf = LinearSVC(C=C, probability=probability, random_state=random_state)

    def fit(self, X: np.ndarray, y: np.ndarray) -> "SVMPipeline":
        Xs = self.scaler.fit_transform(X)
        Xk = self.selector.fit_transform(Xs, y)
        self.clf.fit(Xk, y)
        return self

    def _prep(self, X: np.ndarray) -> np.ndarray:
        return self.selector.transform(self.scaler.transform(X))

    def predict(self, X: np.ndarray) -> np.ndarray:
        return self.clf.predict(self._prep(X))

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        return self.clf.predict_proba(self._prep(X))

    def decision_function(self, X: np.ndarray) -> np.ndarray:
        return self.clf.decision_function(self._prep(X))

    def get_support(self) -> np.ndarray:
        return self.selector.get_support()
