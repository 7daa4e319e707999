"""Wav2Vec2 sequence extraction over an in-memory corpus.

Traffic: 16 kHz mono speech-like waveforms (``common.speech``) whose lengths
are the groups of ``mix`` ({group: [count, lo s, hi s]}, evenly spaced, the
same set for every seed in an order drawn from it), made from the seed.
The window runs passes of ``Wav2Vec2Extractor.extract_sequences`` over the
whole corpus (float32 transfer, the default); a pass's answer is each
file's (T, 768) sequence on the host. The check compares ``check`` files
drawn from the seed, the longest among them, in the first and the last pass,
with the plain reference.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from .. import flops
from ..common import fixed_lengths, max_rel_err, precision, rng, speech
from ..reference import wav2vec2 as ref_w2v
from ..reference.weights import make_weights, wav2vec2_spec


def encoder_config(cfg: dict):
    """The program's ``Wav2Vec2Config`` at the configuration's widths."""
    from robust_speech_analysis_framework_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    names = {f.name for f in dataclasses.fields(Wav2Vec2Config)} - {"compute_dtype"}
    return Wav2Vec2Config(**{n: tuple(cfg[n]) if isinstance(cfg[n], list) else cfg[n]
                             for n in names})


def build_extractor(cfg: dict, weights, device):
    from robust_speech_analysis_framework_tpu_torch.features.wav2vec2 import Wav2Vec2Extractor

    return Wav2Vec2Extractor(params=weights, config=encoder_config(cfg),
                             chunk_seconds=cfg["chunk_seconds"],
                             overlap_seconds=cfg["overlap_seconds"],
                             batch_size=cfg["extract_batch_size"], device=device)


def waveforms(mix: dict, seed: int, device, sample_rate: int) -> Dict[str, np.ndarray]:
    seconds = fixed_lengths(mix, seed, 6)
    return {f"f{i:03d}": w for i, w in enumerate(speech(seconds, seed, device, sample_rate))}


class Kind:
    def __init__(self, configs: Dict[str, dict], params: dict, seed: int, device):
        self.cfg = configs["model"]
        self.p = params
        self.seed = seed
        self.device = torch.device(device)

    def setup(self) -> None:
        cfg = self.cfg
        self.corpus = waveforms(self.p["mix"], self.seed, self.device, cfg["sample_rate"])
        self.weights = make_weights(wav2vec2_spec(cfg), self.seed, self.device)
        self.extractor = build_extractor(cfg, self.weights, self.device)
        self.extractor.extract_sequences(self.corpus, verbose=False)  # every shape of a pass

    def window(self, seconds: float) -> None:
        keep = set(self.checked())
        self.kept: List[Dict[str, np.ndarray]] = []
        self.passes = 0
        start = time.perf_counter()
        deadline = start + seconds
        while time.perf_counter() < deadline:
            out = self.extractor.extract_sequences(self.corpus, verbose=False)
            self.kept[min(self.passes, 1):] = [{n: out.get(n) for n in keep}]  # first and last
            self.passes += 1
        self.elapsed = time.perf_counter() - start

    def _chunks(self) -> List[int]:
        return [b - a for w in self.corpus.values()
                for a, b in ref_w2v.chunk_bounds(len(w), self.cfg)]

    def end_to_end(self) -> Dict[str, float]:
        audio_s = self.passes * sum(len(w) for w in self.corpus.values()) / self.cfg["sample_rate"]
        return {"extract_audio_s_per_s": audio_s / self.elapsed}

    def work(self) -> dict:
        chunks = self._chunks()
        return {"flops": self.passes * sum(flops.wav2vec2_chunk(self.cfg, n) for n in chunks),
                "chunks": self.passes * len(chunks),
                "attempted": self.passes * len(self.corpus), "failed": 0}

    def release(self) -> None:
        del self.extractor
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the check --------------------------------------------------------------------

    def checked(self) -> List[str]:
        names = sorted(self.corpus)
        longest = max(names, key=lambda n: len(self.corpus[n]))
        rest = [n for n in names if n != longest]
        picked = rng(self.seed, 9).choice(len(rest), size=min(self.p["check"] - 1, len(rest)),
                                          replace=False)
        return sorted([longest] + [rest[i] for i in picked])

    def outputs(self) -> List[Dict[str, np.ndarray]]:
        return self.kept

    def reference(self, tf32: bool = False) -> List[Dict[str, np.ndarray]]:
        with precision(tf32):
            seqs = ref_w2v.sequences(self.weights, {n: self.corpus[n] for n in self.checked()},
                                     self.cfg, self.device)
        return [seqs]

    def compare(self, program, reference) -> Dict[str, float]:
        ref = reference[0]
        errs = [max_rel_err(out[n] if out.get(n) is not None else np.zeros(0), ref[n])
                for out in program for n in ref]
        return {"sequence_err": max(errs) if errs else float("inf")}
