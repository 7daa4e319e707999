"""Wav2Vec2-Conformer sequence extraction over an in-memory corpus.

The extraction kind (``traffic/extract.py``: its waveforms, window, rate and
check selection) with a Conformer encoder: the program's
``Wav2Vec2Extractor(config=ConformerConfig(...))`` at the configuration's
widths, whose ``extract_sequences`` answers are held to the plain Conformer
reference (``reference/conformer.py``). A pass's answer is each file's
(T, hidden) sequence on the host. The work counts (``conformer_counts.py``)
are the model FLOPs of each chunk at its real length plus each batch's
position rows, and the least time of the relative-position score stage over
the real (query, key) pairs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from .. import conformer_counts
from ..common import precision
from ..reference import conformer as ref_conformer
from ..reference.weights import make_weights
from .extract import Kind as ExtractKind
from .extract import waveforms

FAULTS = ("mirrored", "full_ffn")  # planted in the reference put in the program's place


def encoder_config(cfg: dict):
    """The program's ``ConformerConfig`` at the configuration's widths."""
    from robust_speech_analysis_framework_tpu_torch.models.conformer import ConformerConfig

    names = {f.name for f in dataclasses.fields(ConformerConfig)} - {"compute_dtype"}
    return ConformerConfig(**{n: tuple(cfg[n]) if isinstance(cfg[n], list) else cfg[n]
                              for n in names})


class Kind(ExtractKind):
    def setup(self) -> None:
        from robust_speech_analysis_framework_tpu_torch.features.wav2vec2 import Wav2Vec2Extractor

        cfg = self.cfg
        config = encoder_config(cfg)  # a program without the Conformer stops here
        self.corpus = waveforms(self.p["mix"], self.seed, self.device, cfg["sample_rate"])
        self.weights = make_weights(ref_conformer.conformer_spec(cfg), self.seed, self.device)
        self.extractor = Wav2Vec2Extractor(params=self.weights, config=config,
                                           chunk_seconds=cfg["chunk_seconds"],
                                           overlap_seconds=cfg["overlap_seconds"],
                                           batch_size=cfg["extract_batch_size"],
                                           device=self.device)
        self.extractor.extract_sequences(self.corpus, verbose=False)  # every shape of a pass

    def work(self) -> dict:
        cfg = self.cfg
        chunks = self._chunks()
        frames = [conformer_counts.frames(cfg, n) for n in chunks]
        batches = -(-len(chunks) // cfg["extract_batch_size"])
        t_pad = conformer_counts.frames(cfg, int(cfg["chunk_seconds"] * cfg["sample_rate"]))
        flops = (sum(conformer_counts.chunk_flops(cfg, n) for n in chunks)
                 + batches * conformer_counts.batch_flops(cfg, t_pad))
        return {"flops": self.passes * flops,
                "relpos_score_bound_ms": self.passes * conformer_counts.relpos_score_bound_ms(
                    cfg, frames),
                "chunks": self.passes * len(chunks),
                "attempted": self.passes * len(self.corpus), "failed": 0}

    def reference(self, tf32: bool = False, fault: str = "") -> List[Dict[str, np.ndarray]]:
        faults = {"mirrored": fault == "mirrored", "macaron": fault != "full_ffn"}
        with precision(tf32):
            seqs = ref_conformer.sequences(self.weights,
                                           {n: self.corpus[n] for n in self.checked()},
                                           self.cfg, self.device, **faults)
        return [seqs]
