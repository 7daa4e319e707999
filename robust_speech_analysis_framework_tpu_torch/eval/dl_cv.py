"""Cross-validation engines for the CNN-LSTM (standard + nested with TPE).

Counterpart of ``robust_speech_analysis_framework_tpu/eval/dl_cv.py``:

* :func:`run_dl_standard_kfold_cv`: fixed hyperparameters, stratified
  5-fold, inner 80/20 early-stop split.
* :func:`run_dl_nested_cv`: per-outer-fold TPE search (25-trial default)
  over {lr, dropout, cnn_out_channels, lstm_hidden_dim, activation}, inner
  3-fold scoring at 15 fixed epochs/batch-size 4, then a final 80/20-split
  training with plateau LR decay and early stopping.

Both return (results_df, fold_predictions, ...) with the reference's result
schema: per-fold accuracy/f1/precision/recall/auc rows plus raw predictions
for ROC analysis, first-conv stability vectors, and loss histories.

The work is in two cores that take aligned arrays, :func:`standard_kfold_cv`
and :func:`nested_cv` (``X`` a list of (T, D) arrays or a
:class:`~..train.loops.SeqView`, ``y`` a label vector), and return plain
lists of dicts and numpy arrays. The two ``run_dl_*`` front doors keep the
JAX package's signatures (a sequence mapping and a metadata DataFrame) and
import pandas, inside, only to build the result frame, so a machine without
pandas drives the cores.

The corpus goes to the device once per run (:func:`_as_device_corpus`), or
once for several runs when the caller wraps it in a
:class:`~..train.loops.ResidentCorpus`; every fold and trial then gathers
its batches there. Every fold's eval pass and stability probe stay on the
device until one :func:`~..ops.framing.collect` at the end of the run.

Where it differs from the JAX package, by design:

* Both engines take ``device`` (``"cuda"`` unless the caller asks for the
  CPU) and no ``mesh``: that comes with the multi-device slice.
* A ``Trainer`` here holds an architecture and a device, no compiled
  program, so the trainer cache lives for one engine call and is not shared
  by the process.
* A resident corpus that holds more participants than the metadata names is
  cut to the padded length of the named ones
  (:meth:`~..train.loops.DeviceCorpus.trimmed_to`), which is what the host
  path pads to; the JAX package computes at the length of the longest
  resident row.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.cnn_lstm import CNNLSTM, stability_probe
from ..ops.framing import Deferred, collect
from ..train.loops import (
    DeviceCorpus,
    SeqView,
    TrainConfig,
    Trainer,
    TrainState,
    _device_fold_fits,
    evaluate_model_deferred,
    train_model,
    train_trials_device,
)
from ..tune import Study, TPESampler
from .metrics import classification_metrics, f1_macro
from .splits import StratifiedKFold, train_test_indices

# Default search space: the reference's.
DEFAULT_SEARCH_SPACE = {
    "learning_rate": ("float_log", 1e-5, 1e-3),
    "dropout_rate": ("float", 0.2, 0.5),
    "cnn_out_channels": ("categorical", [32, 64, 128]),
    "lstm_hidden_dim": ("categorical", [64, 128]),
    "activation_fn": ("categorical", ["silu", "gelu"]),
}


def align_sequences_and_labels(
    sequences_dict: Mapping[str, np.ndarray], metadata_df
) -> Tuple[Sequence[np.ndarray], np.ndarray, List[str]]:
    """Join sequences to binary labels on unique_participant_id.

    Label 1 = 'Patient' else 0; participants are the sorted intersection of
    sequence keys and metadata ids. ``metadata_df`` is a pandas DataFrame
    (only its methods are used: pandas is not imported here).
    """
    label_map = (
        metadata_df.drop_duplicates("unique_participant_id")
        .set_index("unique_participant_id")["label"]
        .apply(lambda v: 1 if v == "Patient" else 0)
    )
    common = sorted(set(sequences_dict.keys()) & set(label_map.index))
    if not common:
        raise ValueError(
            "no overlap between sequence keys and metadata "
            "unique_participant_id values — sequences must be keyed by "
            "participant id (e.g. '01_CF30_1'), not by clip filename"
        )
    y = label_map.loc[common].to_numpy()
    if getattr(sequences_dict, "is_resident_sequences", False):
        # the sequences already lie on the device: adopt the tensor as a
        # resident corpus view instead of uploading it again
        rows = np.asarray([sequences_dict.row(pid) for pid in common])
        corpus = DeviceCorpus.from_resident(sequences_dict).trimmed_to(rows)
        return corpus.view(rows), y, common
    X = [np.asarray(sequences_dict[pid], dtype=np.float32) for pid in common]
    return X, y, common


class _TrainerCache:
    """One Trainer per distinct architecture on one device."""

    def __init__(self, input_dim: int, num_classes: int = 2, device: DeviceLike = "cuda"):
        self.input_dim = input_dim
        self.num_classes = num_classes
        self.device = resolve_device(device)
        self._cache: Dict[tuple, Trainer] = {}

    def get(self, hp: Mapping[str, Any]) -> Trainer:
        # dropout_rate is NOT part of the key: it reaches the model at call
        # time (TrainConfig.dropout_rate)
        key = (self.input_dim, self.num_classes, *_arch_key(hp), str(self.device))
        if key not in self._cache:
            model = CNNLSTM(
                input_dim=self.input_dim, num_classes=self.num_classes,
                cnn_out_channels=key[2], lstm_hidden_dim=key[3], activation_fn=key[4],
            )
            self._cache[key] = Trainer(model, device=self.device)
        return self._cache[key]


def _subset(seq: Sequence, idx: np.ndarray):
    if hasattr(seq, "subset"):  # SeqView: keep the device-resident corpus
        return seq.subset(idx)
    return [seq[i] for i in idx]


def _input_dim(X) -> int:
    """Feature dim without touching data: a resident-corpus view reads the
    tensor's shape."""
    if hasattr(X, "corpus"):
        return int(X.corpus.x.shape[2])
    return int(np.asarray(X[0]).shape[1])


# device-resident corpus budget where the device reports no memory size
# (the CPU): one padded (N, T, D) float32 tensor per CV run
_CORPUS_BUDGET_FALLBACK_BYTES = 4 << 30


def _corpus_budget_bytes(device: torch.device) -> int:
    """Resident-corpus budget: a quarter of the card's total memory, so that
    fold activations and optimizer state still fit; the 4 GiB literal on the
    CPU. ``RSAF_CORPUS_BUDGET_BYTES`` overrides both, for workloads that
    know their activation envelope; a value that is not a positive integer
    raises (the JAX package ignores a malformed one, and zero or a negative
    value there turns the resident corpus off without a word)."""
    env = os.environ.get("RSAF_CORPUS_BUDGET_BYTES")
    if env:
        try:
            budget = int(env)
        except ValueError:
            budget = 0
        if budget <= 0:
            raise ValueError(f"RSAF_CORPUS_BUDGET_BYTES={env!r}: expected a positive number "
                             "of bytes")
        return budget
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory // 4
    return _CORPUS_BUDGET_FALLBACK_BYTES


def _as_device_corpus(X, device: DeviceLike = "cuda"):
    """Wrap a sequence list as a resident-corpus view when it fits the
    budget; folds and trials then gather rows on the device instead of
    uploading their batches. A corpus over budget, or one whose allocation
    fails, is left on the host with a logged warning and its folds stream."""
    if isinstance(X, SeqView):  # already resident
        return X
    device = resolve_device(device)
    if DeviceCorpus.nbytes_estimate(X) > _corpus_budget_bytes(device):
        return X
    try:
        corpus = DeviceCorpus(X, device=device)
    except (torch.cuda.OutOfMemoryError, MemoryError) as e:
        # allocation failure only: any other error propagates
        logging.getLogger(__name__).warning(
            "resident-corpus upload failed (%s); streaming folds from host", e
        )
        return X
    return corpus.view(np.arange(len(X)))


def _stability_vector(state: TrainState) -> np.ndarray:
    return stability_probe(state.model).cpu().numpy()


def _stability_deferred(state: TrainState) -> Deferred:
    """The conv1 stability probe; the (input_dim,) vector is fetched with
    the fold's other results in one collect."""
    return Deferred(stability_probe(state.model), np.asarray)


def standard_kfold_cv(
    X: Sequence[np.ndarray],
    y: np.ndarray,
    hyperparams: Mapping[str, Any],
    n_splits: int = 5,
    epochs: int = 100,
    patience: int = 25,
    batch_size: int = 8,
    seed: int = 42,
    verbose: bool = False,
    use_length_masking: bool = True,
    remat: bool = False,
    device: DeviceLike = "cuda",
) -> Tuple[List[dict], List[dict], List[dict], np.ndarray]:
    """The standard engine over aligned arrays: (results, fold_predictions,
    histories, stability_weights), ``results`` one dict per fold."""
    y = np.asarray(y)
    X = _as_device_corpus(X, device)
    cache = _TrainerCache(input_dim=_input_dim(X), device=device)
    cv = StratifiedKFold(n_splits=n_splits, shuffle=True, random_state=seed)

    trainer = cache.get(hyperparams)
    deferreds: List[Deferred] = []
    for fold, (train_idx, test_idx) in enumerate(cv.split(X, y)):
        X_train, y_train = _subset(X, train_idx), y[train_idx]
        X_test, y_test = _subset(X, test_idx), y[test_idx]
        # Inner 80/20 split for early stopping.
        tr_idx, val_idx = train_test_indices(y_train, n_splits=5, seed=seed)
        cfg = TrainConfig(
            learning_rate=float(hyperparams["learning_rate"]),
            epochs=epochs,
            patience=patience,
            batch_size=batch_size,
            seed=seed + fold,
            dropout_rate=float(hyperparams.get("dropout_rate", 0.5)),
            use_length_masking=use_length_masking,
            remat=remat,
        )
        state, hist = train_model(
            trainer, _subset(X_train, tr_idx), y_train[tr_idx],
            _subset(X_train, val_idx), y_train[val_idx], cfg,
            verbose=verbose, defer_histories=True,
        )
        deferreds += [hist, _stability_deferred(state),
                      evaluate_model_deferred(trainer, state, X_test, y_test, cfg)]

    results, fold_predictions, histories, weights = [], [], [], []
    flat = collect(deferreds)
    for fold in range(len(flat) // 3):
        (th, vh), w, (y_true, y_pred, y_prob) = flat[3 * fold : 3 * fold + 3]
        histories.append({"train": th, "val": vh})
        weights.append(w)
        fold_predictions.append({"y_true": y_true, "y_prob": y_prob})
        results.append({"fold": fold + 1, **classification_metrics(y_true, y_pred, y_prob)})
        if verbose:
            print(f"[standard] fold {fold + 1}: {results[-1]}")
    return results, fold_predictions, histories, np.asarray(weights)


def run_dl_standard_kfold_cv(
    sequences_dict: Mapping[str, np.ndarray],
    metadata_df,
    hyperparams: Mapping[str, Any],
    n_splits: int = 5,
    epochs: int = 100,
    patience: int = 25,
    batch_size: int = 8,
    seed: int = 42,
    verbose: bool = False,
    use_length_masking: bool = True,
    remat: bool = False,
    device: DeviceLike = "cuda",
):
    """Standard stratified K-fold with fixed hyperparameters.

    Returns (results_df, fold_predictions, histories, stability_weights),
    the contract of the reference's run_pytorch_standard_kfold_cv.
    """
    import pandas as pd

    resolve_device(device)
    X, y, _ = align_sequences_and_labels(sequences_dict, metadata_df)
    results, fold_predictions, histories, weights = standard_kfold_cv(
        X, y, hyperparams, n_splits=n_splits, epochs=epochs, patience=patience,
        batch_size=batch_size, seed=seed, verbose=verbose,
        use_length_masking=use_length_masking, remat=remat, device=device,
    )
    return pd.DataFrame(results), fold_predictions, histories, weights


def _inner_config(params: Mapping[str, Any], inner_epochs: int, inner_batch_size: int,
                  seed: int, use_length_masking: bool, remat: bool) -> TrainConfig:
    """A tuning trial's fold configuration."""
    return TrainConfig(
        learning_rate=float(params["learning_rate"]),
        epochs=inner_epochs,
        patience=inner_epochs + 1,  # no early stop in the tuning loop
        batch_size=inner_batch_size,
        seed=seed,
        dropout_rate=float(params.get("dropout_rate", 0.5)),
        use_length_masking=use_length_masking,
        remat=remat,
        # the reference _objective trains plain Adam for a FIXED number of
        # epochs and scores the final-epoch weights: no plateau decay, no
        # best-val restore; both would otherwise bias trial scores
        # optimistically
        use_plateau=False,
        restore_best=False,
    )


def _inner_cv_score(
    cache: _TrainerCache,
    params: Mapping[str, Any],
    X_tv: Sequence[np.ndarray],
    y_tv: np.ndarray,
    n_splits_inner: int,
    inner_epochs: int,
    inner_batch_size: int,
    seed: int,
    use_length_masking: bool = True,
    remat: bool = False,
) -> float:
    """Mean inner-fold macro-F1 at fixed short training (the reference's
    _objective: 3 folds × 15 epochs × batch 4); the folds' eval passes are
    fetched together at the end of the trial."""
    inner = StratifiedKFold(n_splits=n_splits_inner, shuffle=True, random_state=seed)
    trainer = cache.get(params)
    cfg = _inner_config(params, inner_epochs, inner_batch_size, seed, use_length_masking, remat)
    deferreds = []
    for tr_idx, val_idx in inner.split(X_tv, y_tv):
        X_val = _subset(X_tv, val_idx)
        state, _ = train_model(
            trainer, _subset(X_tv, tr_idx), y_tv[tr_idx], X_val, y_tv[val_idx], cfg,
            defer_histories=True,
        )
        deferreds.append(evaluate_model_deferred(trainer, state, X_val, y_tv[val_idx], cfg))
    scores = [f1_macro(y_true, y_pred) for y_true, y_pred, _ in collect(deferreds)]
    return float(np.mean(scores))


def _inner_cv_scores_batch(
    cache: _TrainerCache,
    params_list: Sequence[Mapping[str, Any]],
    X_tv: Sequence[np.ndarray],
    y_tv: np.ndarray,
    n_splits_inner: int,
    inner_epochs: int,
    inner_batch_size: int,
    seed: int,
    use_length_masking: bool = True,
    remat: bool = False,
) -> List[float]:
    """:func:`_inner_cv_score` of a BATCH of trials, in their order.

    The trials are grouped by architecture; each group trains as ONE
    :func:`~..train.loops.train_trials_device` call per inner fold (a lane a
    trial) with its eval pass lane-batched too, and every eval pass is
    fetched in one collect: a round of K trials costs (architectures × inner
    folds) fold runs instead of K × inner folds."""
    inner = StratifiedKFold(n_splits=n_splits_inner, shuffle=True, random_state=seed)
    folds = list(inner.split(X_tv, y_tv))
    groups: Dict[tuple, List[int]] = {}
    for i, p in enumerate(params_list):
        groups.setdefault(_arch_key(p), []).append(i)

    deferreds, slots = [], []
    for idxs in groups.values():
        trainer = cache.get(params_list[idxs[0]])
        # the first trial's configuration; every lane takes its own rates
        cfg = _inner_config(params_list[idxs[0]], inner_epochs, inner_batch_size, seed,
                            use_length_masking, remat)
        lrs = [float(params_list[i]["learning_rate"]) for i in idxs]
        rates = [float(params_list[i].get("dropout_rate", 0.5)) for i in idxs]
        for tr_idx, val_idx in folds:
            X_val = _subset(X_tv, val_idx)
            states, _ = train_trials_device(
                trainer, _subset(X_tv, tr_idx), y_tv[tr_idx], X_val, y_tv[val_idx], cfg,
                lrs, rates,
            )
            deferreds.append(trainer.eval_logits_trials_deferred(states, X_val, cfg))
            slots.append((idxs, y_tv[val_idx]))

    per_trial: List[List[float]] = [[] for _ in params_list]
    for logits, (idxs, y_val) in zip(collect(deferreds), slots):
        preds = np.argmax(logits, axis=-1)  # (lanes, n_val)
        for lane, ti in enumerate(idxs):
            per_trial[ti].append(f1_macro(y_val, preds[lane]))
    return [float(np.mean(s)) for s in per_trial]


def _suggest_params(trial, space: Mapping[str, tuple]) -> Dict[str, Any]:
    """Sample one parameter set from a search-space spec via a TPE trial."""
    params: Dict[str, Any] = {}
    for name, spec in space.items():
        kind = spec[0]
        if kind == "float_log":
            params[name] = trial.suggest_float(name, spec[1], spec[2], log=True)
        elif kind == "float":
            params[name] = trial.suggest_float(name, spec[1], spec[2])
        else:
            params[name] = trial.suggest_categorical(name, spec[1])
    return params


def _suggest_round(asked, space: Mapping[str, tuple]) -> List[Dict[str, Any]]:
    """Sample one ask-K round with per-round architecture commitment.

    Categorical parameters (the architecture axes: cnn channels, lstm
    width, activation) are sampled ONCE per round from the current TPE
    posterior and pinned for every trial in the round; continuous
    parameters (lr, dropout) vary per trial, so a round's trials share one
    architecture and can train together. The pinned values are recorded on
    every trial, so the categorical posterior still learns from all K
    scores; architecture exploration happens round-to-round against the
    updated posterior."""
    plist: List[Dict[str, Any]] = []
    pinned: Dict[str, Any] = {}
    for t in asked:
        params: Dict[str, Any] = {}
        for name, spec in space.items():
            kind = spec[0]
            if kind == "float_log":
                params[name] = t.suggest_float(name, spec[1], spec[2], log=True)
            elif kind == "float":
                params[name] = t.suggest_float(name, spec[1], spec[2])
            elif name in pinned:
                t.params[name] = params[name] = pinned[name]
            else:
                pinned[name] = params[name] = t.suggest_categorical(name, spec[1])
        plist.append(params)
    return plist


def _arch_key(p: Mapping[str, Any]) -> tuple:
    return (
        int(p.get("cnn_out_channels", 128)),
        int(p.get("lstm_hidden_dim", 128)),
        str(p.get("activation_fn", "silu")),
    )


def nested_cv(
    X: Sequence[np.ndarray],
    y: np.ndarray,
    n_splits_outer: int = 5,
    n_splits_inner: int = 3,
    n_trials: int = 25,
    epochs: int = 50,
    patience: int = 10,
    batch_size: int = 8,
    inner_epochs: int = 15,
    inner_batch_size: int = 4,
    seed: int = 42,
    search_space: Optional[Mapping[str, tuple]] = None,
    verbose: bool = False,
    use_length_masking: bool = True,
    trial_batch: int = 1,
    remat: bool = False,
    device: DeviceLike = "cuda",
) -> Tuple[List[dict], List[dict], np.ndarray]:
    """The nested engine over aligned arrays: (results, fold_predictions,
    stability_weights), ``results`` one dict per outer fold with its
    ``best_params``. ``trial_batch`` > 1 runs the search in rounds of that
    many trials (see :func:`run_dl_nested_cv`)."""
    space = dict(search_space or DEFAULT_SEARCH_SPACE)
    y = np.asarray(y)
    X = _as_device_corpus(X, device)
    cache = _TrainerCache(input_dim=_input_dim(X), device=device)
    outer = StratifiedKFold(n_splits=n_splits_outer, shuffle=True, random_state=seed)

    deferreds: List[Deferred] = []
    fold_best: List[dict] = []
    for fold, (tv_idx, test_idx) in enumerate(outer.split(X, y)):
        X_tv, y_tv = _subset(X, tv_idx), y[tv_idx]
        X_test, y_test = _subset(X, test_idx), y[test_idx]

        def objective(trial):
            return _inner_cv_score(
                cache, _suggest_params(trial, space), X_tv, y_tv,
                n_splits_inner, inner_epochs, inner_batch_size, seed,
                use_length_masking=use_length_masking, remat=remat,
            )

        study = Study(direction="maximize", sampler=TPESampler(seed=seed + fold))
        probe_cfg = TrainConfig(epochs=inner_epochs, batch_size=inner_batch_size)
        if trial_batch > 1 and (isinstance(X_tv, SeqView)
                                or _device_fold_fits(X_tv, X_tv, probe_cfg)):
            done = 0
            while done < n_trials:
                k = min(trial_batch, n_trials - done)
                asked = [study.ask() for _ in range(k)]
                # one architecture a round keeps its trials in one lane batch
                scores = _inner_cv_scores_batch(
                    cache, _suggest_round(asked, space), X_tv, y_tv,
                    n_splits_inner, inner_epochs, inner_batch_size, seed,
                    use_length_masking=use_length_masking, remat=remat,
                )
                for t, score in zip(asked, scores):
                    study.tell(t, score)
                done += k
        else:
            study.optimize(objective, n_trials=n_trials)
        best_params = study.best_params
        fold_best.append(dict(best_params))
        if verbose:
            print(f"[nested] fold {fold + 1} best: {best_params} "
                  f"(inner F1 {study.best_value:.3f})")

        # Final training on an 80/20 split of the outer train set.
        tr_idx, val_idx = train_test_indices(y_tv, n_splits=5, seed=seed)
        trainer = cache.get(best_params)
        cfg = TrainConfig(
            learning_rate=float(best_params["learning_rate"]),
            epochs=epochs,
            patience=patience,
            batch_size=batch_size,
            seed=seed + fold,
            dropout_rate=float(best_params.get("dropout_rate", 0.5)),
            use_length_masking=use_length_masking,
            remat=remat,
        )
        state, _hist = train_model(
            trainer, _subset(X_tv, tr_idx), y_tv[tr_idx],
            _subset(X_tv, val_idx), y_tv[val_idx], cfg, defer_histories=True,
        )
        deferreds += [_stability_deferred(state),
                      evaluate_model_deferred(trainer, state, X_test, y_test, cfg)]

    results, fold_predictions, weights = [], [], []
    flat = collect(deferreds)
    for fold in range(len(flat) // 2):
        w, (y_true, y_pred, y_prob) = flat[2 * fold : 2 * fold + 2]
        weights.append(w)
        fold_predictions.append({"y_true": y_true, "y_prob": y_prob})
        results.append({
            "fold": fold + 1,
            "best_params": fold_best[fold],
            **classification_metrics(y_true, y_pred, y_prob),
        })
        if verbose:
            print(f"[nested] fold {fold + 1}: {results[-1]}")
    return results, fold_predictions, np.asarray(weights)


def run_dl_nested_cv(
    sequences_dict: Mapping[str, np.ndarray],
    metadata_df,
    n_splits_outer: int = 5,
    n_splits_inner: int = 3,
    n_trials: int = 25,
    epochs: int = 50,
    patience: int = 10,
    batch_size: int = 8,
    inner_epochs: int = 15,
    inner_batch_size: int = 4,
    seed: int = 42,
    search_space: Optional[Mapping[str, tuple]] = None,
    verbose: bool = False,
    use_length_masking: bool = True,
    trial_batch: int = 1,
    remat: bool = False,
    device: DeviceLike = "cuda",
):
    """Nested CV: per-outer-fold TPE hyperparameter search + final training.

    Contract of the reference's run_pytorch_nested_cv_with_optuna: returns
    (results_df incl. best_params per fold, fold_predictions,
    stability_weights).

    ``trial_batch=1`` searches sequentially: the posterior is updated after
    every single trial (same seed → same trials). ``trial_batch`` > 1 runs
    rounds of K trials: K candidates drawn from the current posterior (one
    architecture a round, :func:`_suggest_round`), trained together as lanes
    (:func:`_inner_cv_scores_batch`) and told back as a batch, a schedule
    that is deterministic given the seed but differs from the sequential
    one. It takes the rounds where the outer fold's train part is resident
    or fits the device-fold budget, and the sequential search otherwise, as
    the JAX package does.
    """
    import pandas as pd

    resolve_device(device)
    X, y, _ = align_sequences_and_labels(sequences_dict, metadata_df)
    results, fold_predictions, weights = nested_cv(
        X, y, n_splits_outer=n_splits_outer, n_splits_inner=n_splits_inner,
        n_trials=n_trials, epochs=epochs, patience=patience, batch_size=batch_size,
        inner_epochs=inner_epochs, inner_batch_size=inner_batch_size, seed=seed,
        search_space=search_space, verbose=verbose,
        use_length_masking=use_length_masking, trial_batch=trial_batch, remat=remat,
        device=device,
    )
    return pd.DataFrame(results), fold_predictions, weights
