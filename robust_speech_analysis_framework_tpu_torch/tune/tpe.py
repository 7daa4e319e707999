"""Tree-structured Parzen Estimator hyperparameter search (numpy).

Copy of ``robust_speech_analysis_framework_tpu/tune/tpe.py``, kept here so
the port imports nothing of the JAX package: the same seed gives the same
suggestions, bit for bit. A drop-in replacement for the reference's Optuna
usage: a ``Study`` with ``suggest_float(log=)`` / ``suggest_categorical``
and ``optimize(objective, n_trials)``. The sampler is a self-contained TPE
(Bergstra et al. 2011): after a random startup phase, completed trials are
split into good/bad sets at the γ-quantile of the objective; new values
maximize the density ratio l(x)/g(x) between Parzen (KDE) models of the two
sets. Categorical parameters use smoothed count ratios.

The search loop is host-side Python driving the trainers; trials run one
after another like the reference (``n_jobs=1``). ``ask``/``tell`` are the
two halves of ``optimize`` for a caller that scores a round of trials
together.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class _FloatSpace:
    low: float
    high: float
    log: bool

    def to_internal(self, x: float) -> float:
        return math.log(x) if self.log else x

    def from_internal(self, z: float) -> float:
        x = math.exp(z) if self.log else z
        return min(max(x, self.low), self.high)

    @property
    def internal_bounds(self):
        if self.log:
            return math.log(self.low), math.log(self.high)
        return self.low, self.high


@dataclasses.dataclass
class _CategoricalSpace:
    choices: List[Any]


class Trial:
    """One evaluation of the objective; records the sampled parameters."""

    def __init__(self, study: "Study", number: int):
        self.study = study
        self.number = number
        self.params: Dict[str, Any] = {}

    def suggest_float(
        self, name: str, low: float, high: float, log: bool = False
    ) -> float:
        space = self.study._register(name, _FloatSpace(low, high, log))
        value = self.study.sampler.sample_float(self.study, name, space)
        self.params[name] = value
        return value

    def suggest_int(self, name: str, low: int, high: int) -> int:
        space = self.study._register(name, _CategoricalSpace(list(range(low, high + 1))))
        value = self.study.sampler.sample_categorical(self.study, name, space)
        self.params[name] = value
        return value

    def suggest_categorical(self, name: str, choices: Sequence[Any]) -> Any:
        space = self.study._register(name, _CategoricalSpace(list(choices)))
        value = self.study.sampler.sample_categorical(self.study, name, space)
        self.params[name] = value
        return value


class TPESampler:
    def __init__(
        self,
        n_startup_trials: int = 10,
        n_candidates: int = 24,
        gamma: float = 0.25,
        seed: Optional[int] = None,
    ):
        self.n_startup_trials = n_startup_trials
        self.n_candidates = n_candidates
        self.gamma = gamma
        self.rng = np.random.RandomState(seed)

    # -- helpers ------------------------------------------------------------

    def _split(self, study: "Study", name: str, sharp: bool = True):
        """Values of `name` from completed trials, split good/bad by score.

        ``sharp=True`` (floats): small good-set ~γ·0.4·n so the Parzen model
        concentrates near the incumbent. ``sharp=False`` (categoricals): the
        full γ-quantile, which is robust to tied scores.
        """
        values, scores = [], []
        for t in study.trials:
            if t["value"] is None or name not in t["params"]:
                continue
            values.append(t["params"][name])
            scores.append(t["value"])
        if not values:
            return [], []
        scores = np.asarray(scores, dtype=float)
        # Internally always *minimize*; Study negates for maximize.
        order = np.argsort(scores, kind="stable")
        frac = self.gamma * (0.4 if sharp else 1.0)
        n_good = max(2, min(int(np.ceil(frac * len(values))), 25))
        n_good = min(n_good, len(values) - 1) if len(values) > 1 else 1
        good_idx = set(order[:n_good].tolist())
        good = [values[i] for i in range(len(values)) if i in good_idx]
        bad = [values[i] for i in range(len(values)) if i not in good_idx]
        return good, bad

    def _parzen(self, points: np.ndarray, lo: float, hi: float):
        """Parzen mixture with a uniform-ish prior component and
        neighbor-distance bandwidths (hyperopt-style): keeps persistent
        exploration mass across the whole domain while letting the model
        sharpen where observations cluster."""
        width = hi - lo
        mid = 0.5 * (lo + hi)
        mus = np.append(points, mid)  # prior component at domain center
        order = np.argsort(mus)
        sorted_mus = mus[order]
        n = len(sorted_mus)
        bws = np.empty(n)
        if n == 1:
            bws[0] = width
        else:
            left = np.diff(sorted_mus, prepend=sorted_mus[0] - (sorted_mus[1] - sorted_mus[0]))
            right = np.diff(sorted_mus, append=sorted_mus[-1] + (sorted_mus[-1] - sorted_mus[-2]))
            bws = np.maximum(left, right)
        bw_min = width / min(100.0, 1.0 + n)
        bws = np.clip(bws, bw_min, width)
        # prior component gets the full-domain bandwidth
        prior_pos = int(np.where(order == n - 1)[0][0])
        bws[prior_pos] = width
        return sorted_mus, bws

    @staticmethod
    def _log_mixture(x: np.ndarray, mus: np.ndarray, bws: np.ndarray) -> np.ndarray:
        d = (x[:, None] - mus[None, :]) / bws[None, :]
        log_k = -0.5 * d * d - np.log(bws[None, :] * math.sqrt(2 * math.pi))
        m = log_k.max(axis=1, keepdims=True)
        return m[:, 0] + np.log(np.exp(log_k - m).mean(axis=1))

    def sample_float(self, study: "Study", name: str, space: _FloatSpace) -> float:
        lo, hi = space.internal_bounds
        good, bad = self._split(study, name)
        if len(study.trials_completed) < self.n_startup_trials or len(good) < 2:
            return space.from_internal(self.rng.uniform(lo, hi))
        g = np.array([space.to_internal(v) for v in good])
        b = np.array([space.to_internal(v) for v in bad]) if bad else g
        g_mus, g_bws = self._parzen(g, lo, hi)
        b_mus, b_bws = self._parzen(b, lo, hi)

        # Draw candidates from the good mixture (prior included → exploration).
        comp = self.rng.randint(len(g_mus), size=self.n_candidates)
        cands = self.rng.normal(g_mus[comp], g_bws[comp])
        # Out-of-domain draws resample uniformly in-bounds rather than hard
        # clipping: clipping piles an atom at exactly lo/hi where the l/g
        # ratio peaks whenever good and bad overlap, making every draw of a
        # batch-ask round return the identical boundary point.
        out = (cands < lo) | (cands > hi)
        if out.any():
            cands[out] = self.rng.uniform(lo, hi, size=int(out.sum()))

        score = self._log_mixture(cands, g_mus, g_bws) - self._log_mixture(
            cands, b_mus, b_bws
        )
        return space.from_internal(float(cands[int(np.argmax(score))]))

    def sample_categorical(
        self, study: "Study", name: str, space: _CategoricalSpace
    ) -> Any:
        choices = space.choices
        good, bad = self._split(study, name, sharp=False)
        if len(study.trials_completed) < self.n_startup_trials or len(good) < 2:
            return choices[self.rng.randint(len(choices))]
        prior = 1.0
        g_counts = np.array([sum(v == c for v in good) + prior for c in choices])
        b_counts = np.array([sum(v == c for v in bad) + prior for c in choices])
        ratio = (g_counts / g_counts.sum()) / (b_counts / b_counts.sum())
        probs = ratio / ratio.sum()
        return choices[self.rng.choice(len(choices), p=probs)]


class Study:
    """Optuna-like study. ``direction`` ∈ {'minimize', 'maximize'}."""

    def __init__(
        self,
        direction: str = "minimize",
        sampler: Optional[TPESampler] = None,
        seed: Optional[int] = None,
    ):
        if direction not in ("minimize", "maximize"):
            raise ValueError(f"Unknown direction {direction!r}")
        self.direction = direction
        self.sampler = sampler or TPESampler(seed=seed)
        self.trials: List[Dict[str, Any]] = []
        self._spaces: Dict[str, Any] = {}
        self._next_number = 0

    def _register(self, name: str, space) -> Any:
        existing = self._spaces.get(name)
        if existing is None:
            self._spaces[name] = space
            return space
        if existing != space:
            # Optuna-equivalent guard: silently sampling from the stale
            # space would confine the search to the first-seen bounds.
            raise ValueError(
                f"parameter {name!r} re-suggested with a different space: "
                f"{existing!r} vs {space!r}"
            )
        return existing

    @property
    def trials_completed(self) -> List[Dict[str, Any]]:
        return [t for t in self.trials if t["value"] is not None]

    def ask(self) -> Trial:
        """Draw a new trial from the current posterior without waiting for
        its result — the dispatch half of an ask/tell (batch-parallel)
        optimization loop. K consecutive asks sample K i.i.d. candidates
        from the same good/bad split (the sampler's RandomState advances,
        so they differ); :meth:`tell` folds results back in."""
        trial = Trial(self, number=self._next_number)
        self._next_number += 1
        return trial

    def tell(self, trial: Trial, raw_value: float) -> None:
        """Record the objective value for a trial returned by :meth:`ask`."""
        value = (
            -float(raw_value) if self.direction == "maximize" else float(raw_value)
        )
        self.trials.append(
            {"number": trial.number, "params": trial.params, "value": value,
             "raw_value": float(raw_value)}
        )

    def optimize(
        self,
        objective: Callable[[Trial], float],
        n_trials: int,
        callbacks: Optional[Sequence[Callable]] = None,
    ) -> None:
        for _ in range(n_trials):
            trial = self.ask()
            self.tell(trial, objective(trial))
            for cb in callbacks or ():
                cb(self, self.trials[-1])

    @property
    def best_trial(self) -> Dict[str, Any]:
        completed = self.trials_completed
        if not completed:
            raise ValueError("No completed trials")
        return min(completed, key=lambda t: t["value"])

    @property
    def best_params(self) -> Dict[str, Any]:
        return self.best_trial["params"]

    @property
    def best_value(self) -> float:
        return self.best_trial["raw_value"]


def create_study(
    direction: str = "minimize", seed: Optional[int] = None
) -> Study:
    return Study(direction=direction, sampler=TPESampler(seed=seed))
