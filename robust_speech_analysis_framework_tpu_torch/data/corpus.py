"""Androids Corpus loader.

Counterpart of ``robust_speech_analysis_framework_tpu/data/corpus.py``:
filename metadata parsing, fold-list resolution (csv) and the directory
walk. :func:`load_androids_rows` is the array core, which returns plain
lists of dicts (the card's machine has no pandas); :func:`load_androids_corpus`
wraps them in the two DataFrames of the JAX package.

Corpus layout (relative to a base directory):
  Reading-Task/audio/{HC,PT}/<NN>_<C><G><AA>_<E>.wav
  Interview-Task/audio_clip/<session>/<clip>.wav
  fold-lists.csv   (two header rows; reading folds in `fold1..fold5`,
                    interview folds in `fold1.1..fold5.1`)
"""

from __future__ import annotations

import csv
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

# <id 1-2 digits>_<condition P|C|X><gender M|F><age 2 digits>_<education 1 digit>.wav
_NAME_RE = re.compile(r"^(\d{1,2})_([PCX])([MF])(\d{2})_(\d)\.wav$")

_CONDITION_LABEL = {"P": "Patient", "C": "Control", "X": "Unknown"}
_GENDER_LABEL = {"M": "Male", "F": "Female"}


@dataclass(frozen=True)
class FileMeta:
    """Metadata decoded from an Androids Corpus filename."""

    unique_participant_id: str
    original_id_nn: str
    label: str
    gender: str
    age: int
    education: int

    def as_dict(self) -> dict:
        return {
            "unique_participant_id": self.unique_participant_id,
            "original_id_nn": self.original_id_nn,
            "label": self.label,
            "gender": self.gender,
            "age": self.age,
            "education": self.education,
        }


def parse_androids_filename(filename: str) -> Optional[FileMeta]:
    """Decode participant metadata from a corpus filename; None for names
    outside the corpus grammar (e.g. ``59_PF36_x.wav``), which the loader
    warns about and skips."""
    m = _NAME_RE.match(filename)
    if m is None:
        return None
    nn, cond, gender, age, edu = m.groups()
    return FileMeta(
        unique_participant_id=f"{nn}_{cond}",
        original_id_nn=nn,
        label=_CONDITION_LABEL[cond],
        gender=_GENDER_LABEL[gender],
        age=int(age),
        education=int(edu),
    )


def _mangle_duplicate_columns(names: List[str]) -> List[str]:
    """Pandas-style duplicate-column renaming: repeats become ``name.1``, ``name.2``…"""
    seen: Dict[str, int] = {}
    out: List[str] = []
    for name in names:
        if name not in seen:
            seen[name] = 0
            out.append(name)
            continue
        k = seen[name] + 1
        new = f"{name}.{k}"
        while new in seen:
            k += 1
            new = f"{name}.{k}"
        seen[name] = k
        seen[new] = 0
        out.append(new)
    return out


def load_fold_lists(path: str) -> Tuple[Dict[str, int], Dict[str, int]]:
    """Parse ``fold-lists.csv`` into {base filename -> fold number} maps.

    The second row is the header (the first is a banner). Reading-task folds
    live in columns ``fold1..fold5``, interview-task folds in
    ``fold1.1..fold5.1``; a repeated ``foldN`` header is renamed ``foldN.1``
    as pandas does. Values may be quoted and may carry ``.wav``.

    Returns (reading_map, interview_map); both empty if the file is missing.
    """
    reading_map: Dict[str, int] = {}
    interview_map: Dict[str, int] = {}
    if not os.path.isfile(path):
        return reading_map, interview_map

    with open(path, newline="", encoding="utf-8-sig") as fh:
        rows = list(csv.reader(fh))
    if len(rows) < 2:
        return reading_map, interview_map

    header = _mangle_duplicate_columns([h.strip() for h in rows[1]])
    col_of = {name: i for i, name in enumerate(header)}

    def ingest(col_name: str, fold_num: int, target: Dict[str, int]) -> None:
        idx = col_of.get(col_name)
        if idx is None:
            return
        for row in rows[2:]:
            if idx >= len(row):
                continue
            cell = row[idx].strip().strip("'\"")
            if not cell or cell.lower() == "nan":
                continue
            target[os.path.splitext(cell)[0]] = fold_num

    for k in range(1, 6):
        ingest(f"fold{k}", k, reading_map)
        ingest(f"fold{k}.1", k, interview_map)
    return reading_map, interview_map


def _wav_entries(directory: str) -> List[str]:
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return []
    return [n for n in names if n.endswith(".wav")]


def load_androids_rows(
    base_corpus_path: str, verbose: bool = True
) -> Tuple[List[dict], List[dict]]:
    """Reading-task files and interview-task clips with metadata and folds,
    as lists of row dicts (the array core of :func:`load_androids_corpus`).

    A reading row has [unique_participant_id, original_id_nn, label, gender,
    age, education, filepath, filename, task_type, fold]; an interview row
    has the same with ``original_session_filename`` after ``filename``, and
    inherits metadata and fold from its session folder. Fold is -1 for a
    file absent from fold-lists.csv.
    """
    reading_root = os.path.join(base_corpus_path, "Reading-Task", "audio")
    interview_root = os.path.join(base_corpus_path, "Interview-Task", "audio_clip")
    reading_folds, interview_folds = load_fold_lists(
        os.path.join(base_corpus_path, "fold-lists.csv")
    )
    if verbose:
        print(
            f"Loaded {len(reading_folds)} reading / {len(interview_folds)} "
            "interview fold assignments."
        )

    reading_rows = []
    for condition_dir in ("HC", "PT"):
        cdir = os.path.join(reading_root, condition_dir)
        for name in _wav_entries(cdir):
            meta = parse_androids_filename(name)
            if meta is None:
                if verbose and not name.startswith("."):
                    print(f"Warning: unparseable reading filename '{name}'")
                continue
            row = meta.as_dict()
            row.update(
                filepath=os.path.join(cdir, name),
                filename=name,
                task_type="Reading",
                fold=reading_folds.get(os.path.splitext(name)[0], -1),
            )
            reading_rows.append(row)

    interview_rows = []
    if os.path.isdir(interview_root):
        for session in sorted(os.listdir(interview_root)):
            sdir = os.path.join(interview_root, session)
            if not os.path.isdir(sdir):
                continue
            meta = parse_androids_filename(session + ".wav")
            if meta is None:
                if verbose and not session.startswith("."):
                    print(f"Warning: unparseable interview session '{session}'")
                continue
            fold = interview_folds.get(session, -1)
            for clip in _wav_entries(sdir):
                row = meta.as_dict()
                row.update(
                    filepath=os.path.join(sdir, clip),
                    filename=clip,
                    original_session_filename=session,
                    task_type="Interview_Clip",
                    fold=fold,
                )
                interview_rows.append(row)
    if verbose:
        print(f"Corpus: {len(reading_rows)} reading files, "
              f"{len(interview_rows)} interview clips.")
    return reading_rows, interview_rows


def load_androids_corpus(base_corpus_path: str, verbose: bool = True):
    """``(reading_df, interview_df)``: :func:`load_androids_rows` as two
    pandas DataFrames (empty, without columns, where there are no rows)."""
    import pandas as pd

    reading_rows, interview_rows = load_androids_rows(base_corpus_path, verbose)
    return pd.DataFrame(reading_rows), pd.DataFrame(interview_rows)
