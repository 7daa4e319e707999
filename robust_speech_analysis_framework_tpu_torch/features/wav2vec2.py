"""Batched Wav2Vec2 sequence extraction (PyTorch).

Counterpart of ``robust_speech_analysis_framework_tpu/features/wav2vec2.py``
(``Wav2Vec2Extractor.extract_sequences``), with the reference's chunk
semantics:

* inputs shorter than 0.5 s are skipped;
* long audio is cut into 5 s chunks with 1 s overlap (step 4 s);
* trailing chunks shorter than 0.5 s are discarded;
* chunk sequences are concatenated **without trimming the overlap** (the
  reference duplicates boundary frames and downstream artifacts depend on it).

All chunks of all inputs are gathered into fixed-shape (batch_size, 80000)
float32 batches with per-chunk valid lengths; the masked encoder makes
padded batched inference equal to per-chunk inference. Batches run one
after another (upload, forward, download); sequences come back as float32.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.init import init_weights_
from ..models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model, port_hf_state_dict

SAMPLE_RATE = 16000
MIN_SECONDS = 0.5


@dataclass
class _ChunkRef:
    file_index: int
    order: int  # chunk position within the file
    n_samples: int


class Wav2Vec2Extractor:
    """Reusable extractor owning the encoder and its weights.

    ``params`` is a state dict for :class:`Wav2Vec2Model` (e.g. from
    :func:`..models.weights.wav2vec2_state_dict_from_flat` or
    :func:`..models.wav2vec2.port_hf_state_dict`). Without weights it raises
    unless ``allow_random_init=True`` (tests / throughput runs), in which case
    the weights are drawn from ``torch.Generator().manual_seed(seed)``, a
    warning is emitted and ``.pretrained`` is False.
    """

    def __init__(
        self,
        params: Optional[Mapping[str, torch.Tensor]] = None,
        config: Wav2Vec2Config = Wav2Vec2Config(),
        chunk_seconds: float = 5.0,
        overlap_seconds: float = 1.0,
        batch_size: int = 16,
        normalize: bool = False,
        seed: int = 0,
        allow_random_init: bool = False,
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        self.config = config
        if not 0 <= overlap_seconds < chunk_seconds:
            raise ValueError(
                f"overlap_seconds ({overlap_seconds}) must be in "
                f"[0, chunk_seconds={chunk_seconds}): the chunk step is "
                "chunk_seconds - overlap_seconds and must stay positive."
            )
        self.chunk_size = int(SAMPLE_RATE * chunk_seconds)
        self.step_size = int(SAMPLE_RATE * (chunk_seconds - overlap_seconds))
        self.min_samples = int(SAMPLE_RATE * MIN_SECONDS)
        self.batch_size = batch_size
        # Applied PER CHUNK, as the reference runs its processor per chunk.
        self.normalize = normalize
        self.pretrained = params is not None
        model = Wav2Vec2Model(config)
        if params is None:
            if not allow_random_init:
                raise ValueError(
                    "Wav2Vec2Extractor constructed without weights. The "
                    "reference pipeline always runs pretrained "
                    "facebook/wav2vec2-base-960h; random-init embeddings "
                    "produce garbage downstream results. Load weights with "
                    "Wav2Vec2Extractor.from_hf_checkpoint(path), or pass "
                    "allow_random_init=True if you really want random "
                    "weights (tests/benchmarks only)."
                )
            warnings.warn(
                "Wav2Vec2Extractor is running on RANDOM weights "
                "(allow_random_init=True): embeddings are not meaningful.",
                UserWarning,
                stacklevel=2,
            )
            init_weights_(model, torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(params)
        self.model = model.to(self.device).eval()

    @classmethod
    def from_hf_checkpoint(cls, checkpoint_path_or_name: str, **kwargs) -> "Wav2Vec2Extractor":
        """Load weights from a local HuggingFace checkpoint directory
        (needs the ``transformers`` package)."""
        from transformers import Wav2Vec2Model as HFModel

        hf = HFModel.from_pretrained(checkpoint_path_or_name)
        return cls(params=port_hf_state_dict(hf.state_dict()), **kwargs)

    # ------------------------------------------------------------------

    def _chunk(self, waveform: np.ndarray) -> List[np.ndarray]:
        chunks = []
        for start in range(0, len(waveform), self.step_size):
            c = waveform[start : start + self.chunk_size]
            if len(c) >= self.min_samples:
                chunks.append(c)
        return chunks

    def extract_sequences(
        self, waveforms: Mapping[str, np.ndarray], verbose: bool = True
    ) -> Dict[str, np.ndarray]:
        """{name: 16 kHz mono waveform} → {name: (T, hidden) embeddings}."""
        names, chunk_refs, chunk_data = self._gather_chunks(waveforms, verbose)
        if not names:
            return {}

        out_per_chunk: List[Optional[np.ndarray]] = [None] * len(chunk_data)
        for sel, hidden, out_lens in self._run_batches(chunk_data):
            for j, i in enumerate(sel):
                out_per_chunk[i] = hidden[j, : out_lens[j]]

        sequences: Dict[str, List[Tuple[int, np.ndarray]]] = {n: [] for n in names}
        for ref, emb in zip(chunk_refs, out_per_chunk):
            sequences[names[ref.file_index]].append((ref.order, emb))
        return {
            name: np.vstack([e for _, e in sorted(parts, key=lambda p: p[0])]).astype(
                np.float32, copy=False
            )
            for name, parts in sequences.items()
            if parts
        }

    def _gather_chunks(self, waveforms: Mapping[str, np.ndarray], verbose: bool):
        """Validate + skip sub-0.5 s inputs and flatten every file into
        (names, chunk_refs, chunk_data)."""
        names: List[str] = []
        chunk_refs: List[_ChunkRef] = []
        chunk_data: List[np.ndarray] = []
        for name, wav in waveforms.items():
            wav = np.asarray(wav, dtype=np.float32).reshape(-1)
            if len(wav) < self.min_samples:
                if verbose:
                    print(f"INFO: skipping very short input '{name}'.")
                continue
            file_index = len(names)
            names.append(name)
            for order, c in enumerate(self._chunk(wav)):
                chunk_refs.append(_ChunkRef(file_index, order, len(c)))
                chunk_data.append(c)
        return names, chunk_refs, chunk_data

    def _run_batches(
        self, chunk_data: Sequence[np.ndarray]
    ) -> Iterator[Tuple[range, np.ndarray, np.ndarray]]:
        """Run the chunks through the encoder ``batch_size`` at a time.

        Every batch has the same shape: a short last batch is padded with
        zero chunks of length ``min_samples``. Yields (chunk indices,
        hidden (B, T, D) float32, valid frame counts (B,)) per batch.
        """
        bs = self.batch_size
        for start in range(0, len(chunk_data), bs):
            sel = range(start, min(start + bs, len(chunk_data)))
            batch = np.zeros((bs, self.chunk_size), np.float32)
            lengths = np.full(bs, self.min_samples, np.int32)
            for j, i in enumerate(sel):
                c = chunk_data[i]
                if self.normalize:
                    c = (c - c.mean()) / np.sqrt(c.var() + 1e-7)
                batch[j, : len(c)] = c
                lengths[j] = len(c)
            with torch.inference_mode():
                hidden, out_lens = self.model(
                    torch.from_numpy(batch).to(self.device),
                    torch.from_numpy(lengths).to(self.device),
                )
            yield sel, hidden.cpu().numpy(), out_lens.cpu().numpy()
