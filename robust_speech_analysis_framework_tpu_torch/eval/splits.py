"""Stratified K-fold splitting, bit-identical to scikit-learn's.

Copy of ``robust_speech_analysis_framework_tpu/eval/splits.py`` (pure numpy),
kept here so the port imports nothing of the JAX package.

The reference's per-fold numbers are only comparable if the fold assignment
matches `sklearn.model_selection.StratifiedKFold(shuffle=True, random_state=42)`
exactly (reference usage: src/cv_strategies.py:38,108-109 and
src/dl_cv_strategies.py:224,291,389). This module re-implements that
assignment algorithm from its published semantics: per class, fold sizes are
allocated round-robin over the sorted class sequence, then the per-class fold
id vector is shuffled with a NumPy ``RandomState`` seeded once for the whole
split. Verified against installed scikit-learn in tests/test_splits.py.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np


class StratifiedKFold:
    """K-fold splitter preserving class proportions in every fold."""

    def __init__(
        self,
        n_splits: int = 5,
        shuffle: bool = False,
        random_state: Optional[Union[int, np.random.RandomState]] = None,
    ):
        if n_splits < 2:
            raise ValueError("n_splits must be >= 2")
        self.n_splits = n_splits
        self.shuffle = shuffle
        self.random_state = random_state

    def _rng(self) -> np.random.RandomState:
        rs = self.random_state
        if isinstance(rs, np.random.RandomState):
            return rs
        return np.random.RandomState(rs)

    def _test_fold_ids(self, y: np.ndarray) -> np.ndarray:
        rng = self._rng()
        # Encode classes by order of FIRST APPEARANCE in y (not sorted order):
        # the per-class shuffles below consume the RNG in encoded-class order,
        # so this ordering is load-bearing for bit-parity with scikit-learn.
        _, y_first, y_sorted_inv = np.unique(y, return_index=True, return_inverse=True)
        class_perm = np.argsort(np.argsort(y_first))
        y_inv = class_perm[y_sorted_inv]
        n_classes = len(y_first)
        n = len(y_inv)
        if np.bincount(y_inv).min() < self.n_splits:
            raise ValueError(
                "n_splits cannot exceed the number of members in each class"
            )
        # Allocate per-fold class counts by dealing the sorted class sequence
        # round-robin into folds: fold i receives elements i, i+k, i+2k, ...
        y_order = np.sort(y_inv)
        allocation = np.asarray(
            [
                np.bincount(y_order[i :: self.n_splits], minlength=n_classes)
                for i in range(self.n_splits)
            ]
        )
        test_folds = np.empty(n, dtype=int)
        for k in range(n_classes):
            folds_for_class = np.arange(self.n_splits).repeat(allocation[:, k])
            if self.shuffle:
                rng.shuffle(folds_for_class)
            test_folds[y_inv == k] = folds_for_class
        return test_folds

    def split(
        self, X: Sequence, y: Sequence
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield ``(train_indices, test_indices)`` for each fold."""
        y = np.asarray(y)
        test_folds = self._test_fold_ids(y)
        indices = np.arange(len(y))
        for k in range(self.n_splits):
            mask = test_folds == k
            yield indices[~mask], indices[mask]

    def get_n_splits(self, X=None, y=None) -> int:
        return self.n_splits


def train_test_indices(
    y: Sequence, n_splits: int = 5, seed: int = 42
) -> Tuple[np.ndarray, np.ndarray]:
    """First stratified fold as a (train, val) split.

    The reference carves an early-stopping validation set by taking the first
    split of a fresh 5-fold stratified splitter (src/dl_cv_strategies.py:316-319,
    404-407); this helper reproduces that 80/20 split.
    """
    skf = StratifiedKFold(n_splits=n_splits, shuffle=True, random_state=seed)
    return next(iter(skf.split(np.zeros(len(y)), y)))
