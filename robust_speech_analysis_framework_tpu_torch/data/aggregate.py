"""Session-level aggregation of clip features and sequences.

Counterpart of ``robust_speech_analysis_framework_tpu/data/aggregate.py``:
interview audio arrives as many short clips per participant; summary-feature
classifiers want one (mean, std) vector per participant and sequence models
one concatenated sequence. :func:`participant_clips` (rows as dicts) and
:func:`concat_groups` are the array cores, without pandas:
:func:`aggregate_interview_sequences` is the two over a DataFrame's rows, and
the device-side ``features.wav2vec2.ResidentSequences.regroup`` takes its
groups from :func:`participant_clips`.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping

import numpy as np


def participant_clips(rows: Iterable[Mapping]) -> Dict[str, List[str]]:
    """participant id → its clip filenames in row order, participants in
    sorted order (pandas' ``groupby`` order)."""
    groups: Dict[str, List[str]] = {}
    for row in rows:
        groups.setdefault(row["unique_participant_id"], []).append(row["filename"])
    return {pid: groups[pid] for pid in sorted(groups)}


def concat_groups(
    clip_sequences: Mapping[str, np.ndarray], groups: Mapping[str, List[str]]
) -> Dict[str, np.ndarray]:
    """Each group's member sequences stacked in order, on the host; members
    missing from ``clip_sequences`` are skipped and groups with no member
    left are omitted."""
    out: Dict[str, np.ndarray] = {}
    for key, names in groups.items():
        parts = [clip_sequences[n] for n in names if n in clip_sequences]
        if parts:
            out[key] = np.vstack(parts)
    return out


def aggregate_clip_features(clip_features_df, metadata_df):
    """Collapse clip-level features (a DataFrame) to one row per participant.

    Each feature column becomes ``<name>_mean`` / ``<name>_std`` (std with
    pandas' ddof=1) over the participant's clips, linked through
    ``filename`` → ``unique_participant_id`` in ``metadata_df``; an empty
    input gives an empty DataFrame.
    """
    import pandas as pd

    if clip_features_df.empty or metadata_df.empty:
        return pd.DataFrame()
    keys = metadata_df[["filename", "unique_participant_id"]]
    merged = keys.merge(clip_features_df, on="filename").drop(columns=["filename"])
    agg = merged.groupby("unique_participant_id").agg(["mean", "std"])
    agg.columns = ["_".join(col).strip() for col in agg.columns.to_flat_index()]
    return agg.reset_index().copy()


def aggregate_interview_sequences(
    clip_sequences: Mapping[str, np.ndarray], interview_metadata_df
) -> Dict[str, np.ndarray]:
    """Concatenate each participant's clip sequences into one (T, D) array.

    Clips missing from ``clip_sequences`` (failed extraction, too short) are
    skipped; participants with no clip left are omitted. Concatenation
    follows metadata row order. ``interview_metadata_df`` is a DataFrame
    (its rows are read through ``to_dict``).
    """
    if interview_metadata_df.empty:
        return {}
    groups = participant_clips(interview_metadata_df.to_dict("records"))
    return concat_groups(clip_sequences, groups)
