"""WavLM sequence extraction over an in-memory corpus.

The extraction kind (``traffic/extract.py``: its waveforms, window, rate and
check selection) with a WavLM encoder: the program's
``Wav2Vec2Extractor(config=WavLMConfig(...))`` at the configuration's widths,
whose ``extract_sequences`` answers are held to the plain WavLM reference
(``reference/wavlm.py``). A pass's answer is each file's (T, hidden)
sequence on the host. The work counts (``wavlm_counts.py``) are the model
FLOPs of each chunk at its real length and the least time of the
relative-position softmax kernel over the real (query, key) pairs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from .. import wavlm_counts
from ..common import precision
from ..reference import wavlm as ref_wavlm
from ..reference.weights import make_weights
from .extract import Kind as ExtractKind
from .extract import waveforms

FAULTS = ("ungated", "post_norm")  # planted in the reference put in the program's place


def encoder_config(cfg: dict):
    """The program's ``WavLMConfig`` at the configuration's widths."""
    from robust_speech_analysis_framework_tpu_torch.models.wavlm import WavLMConfig

    names = {f.name for f in dataclasses.fields(WavLMConfig)} - {"compute_dtype"}
    return WavLMConfig(**{n: tuple(cfg[n]) if isinstance(cfg[n], list) else cfg[n]
                          for n in names})


class Kind(ExtractKind):
    def setup(self) -> None:
        from robust_speech_analysis_framework_tpu_torch.features.wav2vec2 import Wav2Vec2Extractor

        cfg = self.cfg
        config = encoder_config(cfg)  # a program without WavLM stops here
        self.corpus = waveforms(self.p["mix"], self.seed, self.device, cfg["sample_rate"])
        self.weights = make_weights(ref_wavlm.wavlm_spec(cfg), self.seed, self.device)
        self.extractor = Wav2Vec2Extractor(params=self.weights, config=config,
                                           chunk_seconds=cfg["chunk_seconds"],
                                           overlap_seconds=cfg["overlap_seconds"],
                                           batch_size=cfg["extract_batch_size"],
                                           device=self.device)
        self.extractor.extract_sequences(self.corpus, verbose=False)  # every shape of a pass

    def work(self) -> dict:
        chunks = self._chunks()
        frames = [wavlm_counts.frames(self.cfg, n) for n in chunks]
        return {"flops": self.passes * sum(wavlm_counts.chunk_flops(self.cfg, n) for n in chunks),
                "relpos_softmax_bound_ms": self.passes * wavlm_counts.relpos_softmax_bound_ms(
                    self.cfg, frames),
                "chunks": self.passes * len(chunks),
                "attempted": self.passes * len(self.corpus), "failed": 0}

    def reference(self, tf32: bool = False, fault: str = "") -> List[Dict[str, np.ndarray]]:
        faults = {"gate": fault != "ungated", "pre_norm": fault != "post_norm"}
        with precision(tf32):
            seqs = ref_wavlm.sequences(self.weights, {n: self.corpus[n] for n in self.checked()},
                                       self.cfg, self.device, **faults)
        return [seqs]
