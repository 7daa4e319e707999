"""End-to-end experiment pipelines (the reference's notebook layer as code).

Counterpart of ``robust_speech_analysis_framework_tpu/experiments.py``:

* :func:`extract_all_features`: notebook 01, corpus → MSHDS / openSMILE /
  Wav2Vec2 features for the reading task and the aggregated interview
  clips, written as CSVs and pickles with skip-if-exists caching.
* :func:`build_svm_datasets` / :func:`run_all_svm_experiments`: notebook
  02, the 9 dataset configurations (3 feature sets × reading / interview /
  combined) and the 18 standard and nested SVM experiments, saved as
  ``all_svm_results.pkl``.
* :func:`build_sequence_sets` / :func:`run_cnn_lstm_experiments`: notebook
  03, participant-level sequence sets and the 6 tuned/standard CNN-LSTM
  experiments with result pickles and final model checkpoints.

Artifact names and schemas are the JAX package's, so either framework's
outputs feed the other's analyses.

Each stage has a pandas-free core over arrays and row dicts, which is what
the front doors above run and what a machine without pandas drives:
:func:`extract_tables` (corpus rows → :class:`FeatureTable` s and sequence
dicts), :func:`svm_datasets` (tables → :class:`SvmDataset` s, the pandas
merges done on arrays), :func:`svm_experiments`, :func:`sequence_sets` and
:func:`cnn_lstm_experiments`. The front doors import pandas, inside, to read
and write the CSVs and to build the result frames.

Where it differs from the JAX package, by design:

* ``device`` (``"cuda"`` unless the caller asks for the CPU) sits beside
  ``mesh``. ``mesh="auto"`` (the default, as in the JAX package) resolves
  to :func:`~.parallel.mesh.auto_mesh` on the card, None on one card or on
  the CPU, so a single device runs exactly the single-device paths; a
  :class:`~.parallel.mesh.DeviceGrid` (a CPU one too) splits the
  extractors' batches and the trial lanes over it, and the rest runs on
  its lead device.
* The SVM engines take ``solver`` (``"batched"``: one SMO solve a run on
  the device, or ``"host"``: the float64 host solver fit by fit); the JAX
  package picks by backend.
* A corpus is decoded once per task and shared by the feature sets, and a
  file the native decoder cannot read is not retried with the Python codec
  (the JAX openSMILE front door retries it).
* The CNN-LSTM corpus goes to the device when it fits the resident budget
  (``eval.dl_cv._as_device_corpus``: one upload per data type, shared by
  the nested search, the standard K-fold and the final model); over budget,
  or when that allocation fails, the folds stream. No other error is
  caught: the JAX package's ``except (RuntimeError, MemoryError): pass``
  would hide a card fault, which torch raises as a ``RuntimeError``.
* The combined sequence set is keyed in sorted participant order (the JAX
  package iterates a set).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .data.aggregate import concat_groups, participant_clips
from .data.corpus import load_androids_rows
from .device import DeviceLike, resolve_device
from .parallel.mesh import MeshLike, resolve_mesh
from .utils.profiling import ThroughputMeter, stage_timer

METADATA_COLUMNS = [
    "unique_participant_id", "original_id_nn", "label", "gender", "age",
    "education", "filepath", "filename", "task_type", "fold",
    "original_session_filename",
]
_DROP = set(METADATA_COLUMNS) | {c + s for c in METADATA_COLUMNS for s in ("_reading", "_interview")}
FEATURE_SETS = ("mshds", "opensmile", "wav2vec2")
TASKS = ("reading", "interview")
# artifact names by (feature set, task)
TABLE_ARTIFACTS = {
    (fs, "reading"): f"features_{fs}_reading_task.csv" for fs in FEATURE_SETS
} | {(fs, "interview"): f"features_{fs}_interview_task_aggregated.csv" for fs in FEATURE_SETS}
SEQUENCE_ARTIFACTS = {"reading": "sequences_wav2vec2_reading.pkl",
                      "interview": "sequences_wav2vec2_interview.pkl"}


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FeatureTable:
    """One feature artifact without pandas: a metadata dict per row (the
    CSV's metadata columns) and the feature block, one row each."""

    meta: List[dict]
    columns: List[str]
    values: np.ndarray

    def frame(self):
        """The artifact's DataFrame: metadata columns, then features."""
        import pandas as pd

        meta = pd.DataFrame(self.meta)
        if not self.columns:
            return meta
        feats = pd.DataFrame(self.values, columns=self.columns)
        return pd.concat([meta, feats], axis=1) if len(meta.columns) else feats

    @classmethod
    def from_frame(cls, df) -> "FeatureTable":
        """A DataFrame (e.g. a CSV artifact read back) split into metadata
        columns and the float feature block."""
        meta_cols = [c for c in df.columns if c in _DROP]
        feat_cols = [c for c in df.columns if c not in _DROP]
        return cls(df[meta_cols].to_dict("records"), feat_cols,
                   df[feat_cols].to_numpy(dtype=float))


def with_metadata(rows: Sequence[Mapping], names: Sequence[str], values: np.ndarray,
                  columns: Sequence[str]) -> FeatureTable:
    """Clip features joined to their corpus rows on ``filename``: the rows
    that have features, in row order (pandas' inner merge keeps the left
    order)."""
    pos = {n: i for i, n in enumerate(names)}
    kept = [r for r in rows if r["filename"] in pos]
    idx = [pos[r["filename"]] for r in kept]
    return FeatureTable([dict(r) for r in kept], list(columns),
                        np.asarray(values)[idx].reshape(len(idx), len(columns)))


def aggregate_table(rows: Sequence[Mapping], names: Sequence[str], values: np.ndarray,
                    columns: Sequence[str]) -> FeatureTable:
    """Clip features collapsed to one row per participant (sorted by id):
    ``<name>_mean`` and ``<name>_std`` (ddof=1) of every column over the
    participant's clips, NaN skipped, as pandas' groupby ``agg(["mean",
    "std"])`` gives them; no clip gives an empty table."""
    pos = {n: i for i, n in enumerate(names)}
    groups = participant_clips(r for r in rows if r["filename"] in pos)
    if not groups:
        return FeatureTable([], [], np.zeros((0, 0)))
    out = np.empty((len(groups), 2 * len(columns)))
    with np.errstate(invalid="ignore", divide="ignore"):
        for g, clips in enumerate(groups.values()):
            block = np.asarray(values, np.float64)[[pos[c] for c in clips]]
            ok = ~np.isnan(block)
            count = ok.sum(axis=0)
            mean = np.where(ok, block, 0.0).sum(axis=0) / count
            sq = np.where(ok, (block - mean) ** 2, 0.0).sum(axis=0)
            out[g, 0::2] = mean
            out[g, 1::2] = np.where(count > 1, np.sqrt(sq / (count - 1)), np.nan)
    return FeatureTable([{"unique_participant_id": pid} for pid in groups],
                        [f"{c}_{s}" for c in columns for s in ("mean", "std")], out)


def _mean_pool(seqs: Mapping[str, np.ndarray]) -> Tuple[List[str], np.ndarray, List[str]]:
    """Each sequence's mean frame (the SVMs' Wav2Vec2 summary features),
    in the sequences' dtype, with columns ``dim_k``."""
    names = list(seqs)
    if not names:
        return [], np.zeros((0, 0), np.float32), []
    means = np.stack([np.asarray(seqs[n]).mean(axis=0) for n in names])
    return names, means, [f"dim_{k}" for k in range(means.shape[1])]


# ---------------------------------------------------------------------------
# Notebook 01: feature extraction
# ---------------------------------------------------------------------------

def _log(verbose: bool, msg: str) -> None:
    if verbose:
        print(msg)


def extract_tables(
    reading_rows: Sequence[Mapping],
    interview_rows: Sequence[Mapping],
    artifacts: Iterable[str],
    wav2vec2_extractor=None,
    opensmile_config=None,
    sequences: Optional[Mapping[str, Mapping[str, np.ndarray]]] = None,
    verbose: bool = True,
    device: DeviceLike = "cuda",
    mesh: MeshLike = "auto",
) -> Tuple[Dict[str, FeatureTable], Dict[str, Dict[str, np.ndarray]]]:
    """The pandas-free extraction core: the named ``artifacts`` (names of
    :data:`TABLE_ARTIFACTS` and :data:`SEQUENCE_ARTIFACTS`) of a corpus given
    as row dicts (``data.corpus.load_androids_rows``).

    Each task's files are decoded once (``audio.native_io``); a file that
    does not decode gives a NaN MSHDS row and is absent from the other sets.
    The Wav2Vec2 tables are the mean frames of the sequences, taken from
    ``sequences`` (by artifact name) where given, else extracted. Returns
    ({artifact: FeatureTable}, {artifact: {filename: (T, H) sequence}}).

    ``mesh`` (``"auto"``, a grid or None) splits MSHDS over the grid's
    devices (a sub-corpus a device) and openSMILE's sub-batches over its dp
    rows; a given ``wav2vec2_extractor`` keeps its own ``mesh``. Each
    extraction stage is timed into a ``ThroughputMeter`` (seconds, audio
    seconds and files per stage), printed at the end when ``verbose``.
    """
    from .audio.native_io import load_corpus_mono_16k

    mesh = resolve_mesh(mesh, device)
    device = resolve_device(device) if mesh is None else mesh.lead
    meter = ThroughputMeter()
    want = set(artifacts)
    unknown = want - set(TABLE_ARTIFACTS.values()) - set(SEQUENCE_ARTIFACTS.values())
    if unknown:
        raise ValueError(f"unknown artifacts {sorted(unknown)}")
    rows = {"reading": list(reading_rows), "interview": list(interview_rows)}
    decoded: Dict[str, Dict[str, np.ndarray]] = {}

    def waves(task):
        if task not in decoded:
            paths = [r["filepath"] for r in rows[task]]
            decoded[task] = load_corpus_mono_16k(paths) if paths else {}
        return decoded[task]

    def table(task, names, values, columns):
        if task == "reading":
            return with_metadata(rows[task], names, values, columns)
        return aggregate_table(rows[task], names, values, columns)

    tables: Dict[str, FeatureTable] = {}
    seqs: Dict[str, Dict[str, np.ndarray]] = dict(sequences or {})
    def audio_s(w, names):
        return sum(len(w[n]) for n in names if n in w) / 16000.0

    for task in TASKS:
        if TABLE_ARTIFACTS["mshds", task] in want:
            from .features.mshds import FEATURE_NAMES, extract_mshds_arrays

            w = waves(task)
            names = [r["filename"] for r in rows[task]]
            values = np.full((len(names), len(FEATURE_NAMES)), np.nan)
            ok = [i for i, n in enumerate(names) if n in w]
            with stage_timer(meter, f"mshds/{task}", audio_s(w, names), len(names)):
                if ok:
                    values[ok] = extract_mshds_arrays(
                        [w[names[i]] for i in ok], 16000, device=device,
                        devices=None if mesh is None else mesh.devices)
            tables[TABLE_ARTIFACTS["mshds", task]] = table(task, names, values, FEATURE_NAMES)
        if TABLE_ARTIFACTS["opensmile", task] in want:
            from .features.opensmile import OpenSmileConfig, OpenSmileExtractor, feature_columns

            cfg = opensmile_config or OpenSmileConfig()
            w = waves(task)
            named = {r["filename"]: w[r["filename"]] for r in rows[task] if r["filename"] in w}
            with stage_timer(meter, f"opensmile/{task}", audio_s(w, named), len(named)):
                names, feats = OpenSmileExtractor(cfg, device=device).extract_arrays(
                    named, verbose=verbose, mesh=mesh)
            tables[TABLE_ARTIFACTS["opensmile", task]] = table(
                task, names, feats.astype(np.float64), feature_columns(cfg.reference_compat))
        seq_name = SEQUENCE_ARTIFACTS[task]
        if (seq_name in want or TABLE_ARTIFACTS["wav2vec2", task] in want) and seq_name not in seqs:
            if wav2vec2_extractor is None:
                raise ValueError("the Wav2Vec2 artifacts need a wav2vec2_extractor")
            w = waves(task)
            named = {r["filename"]: w[r["filename"]] for r in rows[task] if r["filename"] in w}
            with stage_timer(meter, f"wav2vec2/{task}", audio_s(w, named), len(named)):
                seqs[seq_name] = wav2vec2_extractor.extract_sequences(
                    named, verbose=verbose) if rows[task] else {}
        if TABLE_ARTIFACTS["wav2vec2", task] in want:
            tables[TABLE_ARTIFACTS["wav2vec2", task]] = table(task, *_mean_pool(seqs[seq_name]))
    if verbose and meter.stages:
        print("extraction throughput:\n" + meter.report())
    return tables, {k: v for k, v in seqs.items() if k in want}


def extract_all_features(
    corpus_dir: str,
    out_dir: str,
    features: Iterable[str] = FEATURE_SETS,
    skip_existing: bool = True,
    wav2vec2_extractor=None,
    opensmile_config=None,
    verbose: bool = True,
    device: DeviceLike = "cuda",
    mesh: MeshLike = "auto",
) -> Dict[str, str]:
    """Extract every feature set for the reading and interview tasks.

    Returns {artifact name: path}. Cached artifacts are skipped when
    ``skip_existing`` (the reference's idempotency contract, nb01 cell 8).
    With "wav2vec2" in ``features`` and no extractor, this fails before any
    extraction: ``Wav2Vec2Extractor`` refuses to run on random weights.
    ``mesh="auto"`` splits every extractor over the CUDA devices when there
    are several (:func:`extract_tables`); a grid or None is taken as given.
    """
    features = list(features)
    mesh = resolve_mesh(mesh, device)
    if "wav2vec2" in features and wav2vec2_extractor is None:
        from .features.wav2vec2 import Wav2Vec2Extractor

        # fail fast: the guard would otherwise fire only after the MSHDS and
        # openSMILE stages spent minutes extracting
        wav2vec2_extractor = Wav2Vec2Extractor(device=device, mesh=mesh)
    device = resolve_device(device) if mesh is None else mesh.lead

    os.makedirs(out_dir, exist_ok=True)
    reading_rows, interview_rows = load_androids_rows(corpus_dir, verbose=verbose)
    names = [TABLE_ARTIFACTS[fs, task] for fs in FEATURE_SETS if fs in features for task in TASKS]
    if "wav2vec2" in features:
        names += list(SEQUENCE_ARTIFACTS.values())
    paths = {n: os.path.join(out_dir, n) for n in names}
    missing = [n for n in names if not (skip_existing and os.path.exists(paths[n]))]

    # a cached sequence pickle feeds its missing mean-frame table
    cached_seqs = {}
    for task, seq_name in SEQUENCE_ARTIFACTS.items():
        if TABLE_ARTIFACTS["wav2vec2", task] in missing and seq_name not in missing:
            with open(paths[seq_name], "rb") as fh:
                cached_seqs[seq_name] = pickle.load(fh)
    tables, seqs = extract_tables(
        reading_rows, interview_rows, missing, wav2vec2_extractor=wav2vec2_extractor,
        opensmile_config=opensmile_config, sequences=cached_seqs, verbose=verbose,
        device=device, mesh=mesh,
    )
    for name, tab in tables.items():
        tab.frame().to_csv(paths[name], index=False)
    for name, seq in seqs.items():
        with open(paths[name], "wb") as fh:
            pickle.dump(seq, fh)
    return paths


# ---------------------------------------------------------------------------
# Notebook 02: SVM experiments
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SvmDataset:
    """One SVM dataset configuration: features, their names, binary labels
    (1 = Patient) and the participant of each row."""

    X: np.ndarray
    columns: List[str]
    y: np.ndarray
    groups: List[str]
    label_column: str = "label"


def _merge(left: FeatureTable, right: FeatureTable, suffixes=("", "")) -> FeatureTable:
    """pandas' inner merge on ``unique_participant_id``: each left row with
    each matching right row, in left order; a name on both sides (other than
    the key) takes the suffixes."""
    key = "unique_participant_id"
    by_pid: Dict[Any, List[int]] = {}
    for i, m in enumerate(right.meta):
        by_pid.setdefault(m[key], []).append(i)
    left_names = [k for k in (left.meta[0] if left.meta else {})] + left.columns
    right_names = [k for k in (right.meta[0] if right.meta else {}) if k != key] + right.columns
    both = (set(left_names) & set(right_names)) - {key}

    def named(name, suffix):
        return name + suffix if name in both else name

    li, ri = [], []
    for i, m in enumerate(left.meta):
        for j in by_pid.get(m[key], []):
            li.append(i)
            ri.append(j)
    meta = []
    for i, j in zip(li, ri):
        row = {named(k, suffixes[0]): v for k, v in left.meta[i].items()}
        row.update({named(k, suffixes[1]): v for k, v in right.meta[j].items() if k != key})
        meta.append(row)
    values = np.hstack([np.asarray(left.values, np.float64)[li].reshape(len(li), len(left.columns)),
                        np.asarray(right.values, np.float64)[ri].reshape(len(ri), len(right.columns))])
    columns = [named(c, suffixes[0]) for c in left.columns] + [named(c, suffixes[1])
                                                               for c in right.columns]
    return FeatureTable(meta, columns, values)


def _dataset(tab: FeatureTable) -> SvmDataset:
    """``_xy_from_frame``: labels (1 = Patient), metadata columns dropped,
    NaN filled with its column's mean (an all-NaN column stays NaN). The
    means add along each column's values as pandas does."""
    label_col = "label_reading" if tab.meta and "label_reading" in tab.meta[0] else "label"
    keep = [i for i, c in enumerate(tab.columns) if c not in _DROP]
    X = np.asarray(tab.values, np.float64)[:, keep]
    cols = np.ascontiguousarray(X.T)
    nan = np.isnan(cols)
    with np.errstate(invalid="ignore", divide="ignore"):
        means = np.where(nan, 0.0, cols).sum(axis=1) / (~nan).sum(axis=1)
    X = np.where(np.isnan(X), means[None, :], X)
    y = np.asarray([1 if m[label_col] == "Patient" else 0 for m in tab.meta], np.int64)
    return SvmDataset(X, [tab.columns[i] for i in keep], y,
                      [m["unique_participant_id"] for m in tab.meta], label_col)


def svm_datasets(reading: Mapping[str, FeatureTable],
                 interview: Mapping[str, FeatureTable]) -> Dict[str, SvmDataset]:
    """The 9 dataset configurations of nb02 cell 2, keyed
    ``<feature set>_<reading|interview|combined>``: reading rows as they
    are; interview rows for the participants of the MSHDS reading table
    (its metadata, first row of each participant); combined = reading rows
    merged with the interview rows of their participant."""
    first = reading["mshds"].meta[0] if reading["mshds"].meta else {}
    keys = [c for c in METADATA_COLUMNS if c in first]
    seen, meta = set(), []
    for m in reading["mshds"].meta:
        if m["unique_participant_id"] not in seen:
            seen.add(m["unique_participant_id"])
            meta.append({k: m[k] for k in keys})
    participants = FeatureTable(meta, [], np.zeros((len(meta), 0)))
    out: Dict[str, SvmDataset] = {}
    for fs in FEATURE_SETS:
        r, i = reading[fs], interview[fs]
        out[f"{fs}_reading"] = _dataset(r)
        out[f"{fs}_interview"] = _dataset(_merge(participants, i))
        out[f"{fs}_combined"] = _dataset(_merge(r, i, suffixes=("_reading", "_interview")))
    return out


def _tables_from_dir(processed_dir: str) -> Tuple[Dict[str, FeatureTable], Dict[str, FeatureTable]]:
    import pandas as pd

    def load(fs, task):
        return FeatureTable.from_frame(
            pd.read_csv(os.path.join(processed_dir, TABLE_ARTIFACTS[fs, task])))

    return ({fs: load(fs, "reading") for fs in FEATURE_SETS},
            {fs: load(fs, "interview") for fs in FEATURE_SETS})


def build_svm_datasets(processed_dir: str) -> Dict[str, dict]:
    """The 9 (X, y, groups) dataset configurations of nb02 cell 2 from the
    processed directory's CSVs, as DataFrame / Series (see
    :func:`svm_datasets`)."""
    import pandas as pd

    out = {}
    for name, d in svm_datasets(*_tables_from_dir(processed_dir)).items():
        out[name] = {"X": pd.DataFrame(d.X, columns=d.columns),
                     "y": pd.Series(d.y, name=d.label_column),
                     "groups": pd.Series(d.groups, name="unique_participant_id")}
    return out


def _rows(rows):
    return rows


def svm_experiments(
    datasets: Mapping[str, SvmDataset],
    n_features_standard: int = 25,
    solver: str = "batched",
    frame: Callable = _rows,
    verbose: bool = True,
    device: DeviceLike = "cuda",
) -> Dict[str, dict]:
    """The pandas-free battery: every dataset through the standard
    (``k = min(n_features_standard, d)``) and the nested engine. Returns
    ``{<dataset>_standard|_nested: {"results_df": frame(rows),
    "predictions": [...]}}``; ``frame`` builds the result table (the rows
    themselves by default)."""
    from .eval.svm_cv import nested_svm_cv, standard_svm_cv

    results: Dict[str, dict] = {}
    for name, d in datasets.items():
        k_std = min(n_features_standard, d.X.shape[1])
        _log(verbose, f"[svm] {name}: X {d.X.shape}")
        rows, preds = standard_svm_cv(d.X, d.y, d.columns, n_features_to_select=k_std,
                                      solver=solver, device=device)
        results[f"{name}_standard"] = {"results_df": frame(rows), "predictions": preds}
        rows, preds = nested_svm_cv(d.X, d.y, d.columns, solver=solver, device=device)
        results[f"{name}_nested"] = {"results_df": frame(rows), "predictions": preds}
    return results


def run_all_svm_experiments(
    processed_dir: str,
    out_path: Optional[str] = None,
    n_features_standard: int = 25,
    skip_existing: bool = True,
    verbose: bool = True,
    solver: str = "batched",
    device: DeviceLike = "cuda",
) -> Dict[str, dict]:
    """All 18 SVM experiments (9 datasets × standard/nested), nb02 cell 3,
    with DataFrame results; pickled to ``out_path`` when given."""
    import pandas as pd

    resolve_device(device)
    if out_path and skip_existing and os.path.exists(out_path):
        with open(out_path, "rb") as fh:
            return pickle.load(fh)
    results = svm_experiments(svm_datasets(*_tables_from_dir(processed_dir)),
                              n_features_standard=n_features_standard, solver=solver,
                              frame=pd.DataFrame, verbose=verbose, device=device)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "wb") as fh:
            pickle.dump(results, fh)
    return results


# ---------------------------------------------------------------------------
# Notebook 03: CNN-LSTM experiments
# ---------------------------------------------------------------------------

def sequence_sets(
    reading_rows: Sequence[Mapping],
    interview_rows: Sequence[Mapping],
    reading_seqs: Mapping[str, np.ndarray],
    interview_clip_seqs: Mapping[str, np.ndarray],
) -> Tuple[Dict[str, Dict[str, np.ndarray]], List[dict]]:
    """Participant-keyed sequence sets {reading, interview, combined}
    (nb03 cell 1) and the participants' ``unique_participant_id`` and
    ``label`` rows (first row of each, reading rows first). A combined
    sequence is the reading sequence followed by the interview clips."""
    pid_of = {r["filename"]: r["unique_participant_id"] for r in reading_rows}
    reading = {pid_of[n]: s for n, s in reading_seqs.items() if n in pid_of}
    interview = concat_groups(interview_clip_seqs, participant_clips(interview_rows))
    combined = {pid: np.vstack([reading[pid], interview[pid]])
                for pid in sorted(set(reading) & set(interview))}
    seen, meta = set(), []
    for r in list(reading_rows) + list(interview_rows):
        if r["unique_participant_id"] not in seen:
            seen.add(r["unique_participant_id"])
            meta.append({"unique_participant_id": r["unique_participant_id"],
                         "label": r["label"]})
    return {"reading": reading, "interview": interview, "combined": combined}, meta


def build_sequence_sets(processed_dir: str, corpus_dir: str, verbose: bool = True):
    """:func:`sequence_sets` of the processed directory's sequence pickles
    and the corpus's rows; the metadata as a DataFrame."""
    import pandas as pd

    reading_rows, interview_rows = load_androids_rows(corpus_dir, verbose=verbose)
    loaded = {}
    for task, name in SEQUENCE_ARTIFACTS.items():
        with open(os.path.join(processed_dir, name), "rb") as fh:
            loaded[task] = pickle.load(fh)
    sets, meta = sequence_sets(reading_rows, interview_rows, loaded["reading"],
                               loaded["interview"])
    return sets, pd.DataFrame(meta, columns=["unique_participant_id", "label"])


def best_params(results_df) -> Dict[str, Any]:
    """The tuned hyperparameters of the max-F1 outer fold (nb03 cell 7): the
    first fold with the highest ``f1_score``, NaN skipped. ``results_df`` is
    a DataFrame or the rows of one."""
    rows = results_df.to_dict("records") if hasattr(results_df, "to_dict") else list(results_df)
    scores = [r["f1_score"] for r in rows]
    finite = [i for i, s in enumerate(scores) if not np.isnan(s)]
    if not finite:
        raise ValueError("no fold has a finite f1_score")
    best = max(finite, key=lambda i: (scores[i], -i))
    return dict(rows[best]["best_params"])


def _train_final_model(X, y, hyperparams, kind, models_dir, epochs, patience, batch_size,
                       skip_existing=True, device: DeviceLike = "cuda") -> str:
    """Final per-datatype model artifact (nb03 cell 4 schema): the tuned
    hyperparameters trained on an 80/20 split of every participant."""
    from .eval.dl_cv import _input_dim, _subset, _TrainerCache
    from .eval.splits import train_test_indices
    from .train.checkpoints import save_model_checkpoint
    from .train.loops import TrainConfig, train_model

    path = os.path.join(models_dir, f"final_tuned_cnn_lstm_{kind}.pkl")
    if skip_existing and os.path.exists(path):
        return path
    trainer = _TrainerCache(input_dim=_input_dim(X), device=device).get(hyperparams)
    tr, val = train_test_indices(y, n_splits=5, seed=42)
    cfg = TrainConfig(
        learning_rate=float(hyperparams["learning_rate"]),
        epochs=epochs, patience=patience, batch_size=batch_size,
        dropout_rate=float(hyperparams.get("dropout_rate", 0.5)),
    )
    state, th, vh = train_model(trainer, _subset(X, tr), y[tr], _subset(X, val), y[val], cfg)
    save_model_checkpoint(path, hyperparams, state.model, th, vh)
    return path


def cnn_lstm_experiments(
    sets: Mapping[str, Mapping[str, np.ndarray]],
    meta: Sequence[Mapping],
    out_dir: str,
    models_dir: Optional[str] = None,
    n_trials: int = 25,
    nested_epochs: int = 50,
    nested_patience: int = 10,
    standard_epochs: int = 100,
    standard_patience: int = 25,
    batch_size: int = 8,
    skip_existing: bool = True,
    verbose: bool = True,
    trial_batch: int = 8,
    n_splits: int = 5,
    n_splits_outer: int = 5,
    n_splits_inner: int = 3,
    inner_epochs: int = 15,
    search_space: Optional[Mapping[str, tuple]] = None,
    frame: Callable = _rows,
    device: DeviceLike = "cuda",
    mesh: MeshLike = "auto",
) -> Dict[str, dict]:
    """The pandas-free core of :func:`run_cnn_lstm_experiments`: per data
    type the nested engine (``tuned_<kind>``), the standard engine with the
    max-F1 fold's hyperparameters (``standard_<kind>``), result pickles in
    ``out_dir`` and, with ``models_dir``, the final model. ``meta`` rows
    give each participant's ``label``; ``frame`` builds the result tables
    (the rows themselves by default). The fold counts and ``inner_epochs``
    exist to cut the depth of a run. ``mesh`` (``"auto"``, a grid or None)
    splits the nested searches' trial lanes over the grid's dp rows, with
    the corpus on every device of it; the rest runs on its lead device."""
    from .eval.dl_cv import _as_device_corpus, nested_cv, standard_kfold_cv
    from .train.checkpoints import load_results_pickle, save_results_pickle

    mesh = resolve_mesh(mesh, device)
    device = resolve_device(device) if mesh is None else mesh.lead
    os.makedirs(out_dir, exist_ok=True)
    label = {m["unique_participant_id"]: int(m["label"] == "Patient") for m in meta}
    results: Dict[str, dict] = {}
    for kind, seqs in sets.items():
        pids = sorted(set(seqs) & set(label))
        y = np.asarray([label[p] for p in pids])
        # one upload per data type, shared by the nested search, the
        # standard K-fold and the final model
        X = _as_device_corpus([np.asarray(seqs[p], np.float32) for p in pids], device, mesh)

        tuned_path = os.path.join(out_dir, f"results_wav2vec2_cnn_lstm_tuned_{kind}.pkl")
        if skip_existing and os.path.exists(tuned_path):
            results[f"tuned_{kind}"] = load_results_pickle(tuned_path)
        else:
            rows, preds, weights = nested_cv(
                X, y, n_splits_outer=n_splits_outer, n_splits_inner=n_splits_inner,
                n_trials=n_trials, epochs=nested_epochs, patience=nested_patience,
                batch_size=batch_size, inner_epochs=inner_epochs, search_space=search_space,
                verbose=verbose, trial_batch=trial_batch, device=device, mesh=mesh,
            )
            save_results_pickle(tuned_path, frame(rows), preds, weights)
            results[f"tuned_{kind}"] = {"results_df": frame(rows), "predictions": preds,
                                        "weights": weights}
        hyperparams = best_params(results[f"tuned_{kind}"]["results_df"])

        std_path = os.path.join(out_dir, f"results_wav2vec2_cnn_lstm_standard_{kind}.pkl")
        if skip_existing and os.path.exists(std_path):
            results[f"standard_{kind}"] = load_results_pickle(std_path)
        else:
            rows, preds, hist, weights = standard_kfold_cv(
                X, y, hyperparams, n_splits=n_splits, epochs=standard_epochs,
                patience=standard_patience, batch_size=batch_size, verbose=verbose,
                device=device,
            )
            save_results_pickle(std_path, frame(rows), preds, weights, histories=hist)
            results[f"standard_{kind}"] = {"results_df": frame(rows), "predictions": preds,
                                           "weights": weights, "histories": hist}
        if models_dir:
            _train_final_model(X, y, hyperparams, kind, models_dir, epochs=nested_epochs,
                               patience=nested_patience, batch_size=batch_size,
                               skip_existing=skip_existing, device=device)
    return results


def run_cnn_lstm_experiments(
    processed_dir: str,
    corpus_dir: str,
    out_dir: str,
    models_dir: Optional[str] = None,
    n_trials: int = 25,
    nested_epochs: int = 50,
    nested_patience: int = 10,
    standard_epochs: int = 100,
    standard_patience: int = 25,
    batch_size: int = 8,
    skip_existing: bool = True,
    verbose: bool = True,
    trial_batch: int = 8,
    device: DeviceLike = "cuda",
    mesh: MeshLike = "auto",
) -> Dict[str, dict]:
    """The 6 CNN-LSTM experiments (3 data types × tuned/standard) with result
    pickles and final tuned checkpoints (nb03 cells 3-7), DataFrame results.
    ``mesh`` as in :func:`cnn_lstm_experiments`.

    The TPE searches run in ask-K rounds (``trial_batch=8``: K candidates of
    one architecture trained together as lanes), a schedule that differs
    from the reference's sequential per-trial Optuna search (selected
    hyperparameters can differ for the same seed): ``trial_batch=1`` is
    the reference schedule."""
    import pandas as pd

    mesh = resolve_mesh(mesh, device)
    if mesh is None:
        resolve_device(device)
    sets, meta = build_sequence_sets(processed_dir, corpus_dir, verbose=verbose)
    return cnn_lstm_experiments(
        sets, meta.to_dict("records"), out_dir, models_dir=models_dir, n_trials=n_trials,
        nested_epochs=nested_epochs, nested_patience=nested_patience,
        standard_epochs=standard_epochs, standard_patience=standard_patience,
        batch_size=batch_size, skip_existing=skip_existing, verbose=verbose,
        trial_batch=trial_batch, frame=pd.DataFrame, device=device, mesh=mesh,
    )
