"""Batched Wav2Vec2 sequence and embedding extraction (PyTorch).

Counterpart of ``robust_speech_analysis_framework_tpu/features/wav2vec2.py``,
with the reference's chunk semantics:

* inputs shorter than 0.5 s are skipped;
* long audio is cut into 5 s chunks with 1 s overlap (step 4 s);
* trailing chunks shorter than 0.5 s are discarded;
* chunk sequences are concatenated **without trimming the overlap** (the
  reference duplicates boundary frames and downstream artifacts depend on it);
* embeddings are the mean over every frame of every chunk, duplicates
  included.

All chunks of all inputs are gathered into fixed-shape (batch_size, 80000)
batches with per-chunk valid lengths; the masked encoder makes padded
batched inference equal to per-chunk inference. Three ways out of the
encoder:

* :meth:`Wav2Vec2Extractor.extract_sequences`: every chunk's (T, H) frames
  come back to the host, as float32 or quantised on the device to float16,
  int16, int8 or "int24" and dequantised on the host (JAX ``:60-257``,
  ``:279-318``);
* :meth:`Wav2Vec2Extractor.extract_sequences_resident`: every chunk's valid
  frames are written into one device buffer (N, T_pad, H) that the CV
  engines adopt as a resident corpus, with no host round trip (JAX
  ``:413-529``);
* :meth:`Wav2Vec2Extractor.extract_embeddings`: per-chunk masked frame sums
  on the device; only (B, H) sums cross (JAX ``:210-220``, ``:531-564``).

On the card the batches run through a three-stage pipeline: the upload of
batch k+1 on one copy stream, the forward of batch k on the compute stream
and the download of batch k−1 on another copy stream, from and into pinned
host memory, ordered by CUDA events (the JAX package overlaps the same
stages with ``max_inflight`` dispatches and a fetch thread pool). A card
error propagates: there is no retry and no host fallback.

A ``WavLMConfig`` (``models/wavlm.py``) runs WavLM-Large, a
``ConformerConfig`` (``models/conformer.py``) Wav2Vec2-Conformer-Large with
relative positions, through the same chunking, batches, pipeline and entry
points, in float32.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.init import init_weights_
from ..models.wav2vec2 import (ShardedWav2Vec2, Wav2Vec2Config, Wav2Vec2Model,
                               port_hf_state_dict)
from ..models.conformer import (ConformerConfig, ConformerModel, conformer_config_from_hf,
                                port_hf_conformer_state_dict)
from ..models.wavlm import (WavLMConfig, WavLMModel, port_hf_wavlm_state_dict,
                            wavlm_config_from_hf)
from ..ops.cuda.conformer import check_frames
from ..parallel.mesh import DeviceGrid
from ..train.loops import _aligned_length
from ..utils.profiling import count, span, spanned

SAMPLE_RATE = 16000
MIN_SECONDS = 0.5
# batches in flight on the card: upload k+1, forward k, download k-1
PIPELINE_DEPTH = 2
# the encoder each config class names (a subclass takes its nearest base's)
ENCODERS = {Wav2Vec2Config: Wav2Vec2Model, WavLMConfig: WavLMModel,
            ConformerConfig: ConformerModel}
# transformers' model_type → (its backbone class, config reader, state-dict port)
_HF_ROUTES = {
    "wavlm": ("WavLMModel", wavlm_config_from_hf, port_hf_wavlm_state_dict),
    "wav2vec2-conformer": ("Wav2Vec2ConformerModel", conformer_config_from_hf,
                           port_hf_conformer_state_dict),
}


def encoder_class(config: Wav2Vec2Config) -> type:
    """The encoder module ``config``'s class names (:data:`ENCODERS`)."""
    return next(ENCODERS[c] for c in type(config).__mro__ if c in ENCODERS)


@dataclass
class _ChunkRef:
    file_index: int
    order: int  # chunk position within the file
    n_samples: int


def _transfer_name(dtype) -> str:
    """The sequence transfer format: float32, float16, int16, int8 or int24."""
    if isinstance(dtype, str) and dtype == "int24":
        return "int24"
    try:
        name = np.dtype(dtype).name
    except TypeError:
        name = None
    if name not in ("float32", "float16", "int16", "int8"):
        raise ValueError(
            f"unsupported sequence_transfer_dtype {dtype!r}: use np.float32, np.float16, "
            "np.int16 or np.int8 (per-frame max-abs quantized transfer), or 'int24'"
        )
    return name


def quantize_sequences(hidden: torch.Tensor, transfer: str) -> Tuple[torch.Tensor, ...]:
    """(B, T, H) float32 hidden states → the tensors that cross to the host.

    int8/int16: per-frame max-abs quantisation, ``round(h / scale · qmax)``
    (|h| ≤ scale, so no clipping), with one scale per frame (float16 for
    int8, float32 for int16). int24: an int16 value plus an int8 residual
    over 254 of the same step, and a float32 scale (JAX ``:180-207``).
    ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    if transfer == "float32":
        return (hidden,)
    if transfer == "float16":
        return (hidden.to(torch.float16),)
    scale = hidden.abs().amax(dim=-1).clamp_min(1e-12)
    if transfer == "int24":
        s1 = scale[..., None] / 32767.0
        q1 = torch.round(hidden / s1)
        q2 = torch.round((hidden - q1 * s1) / s1 * 254.0)
        return q1.to(torch.int16), q2.to(torch.int8), scale
    if transfer == "int8":
        q = torch.round(hidden / scale[..., None] * 127.0)
        return q.to(torch.int8), scale.to(torch.float16)
    q = torch.round(hidden / scale[..., None] * 32767.0)
    return q.to(torch.int16), scale


def dequantize_sequences(payload: Tuple[np.ndarray, ...]) -> np.ndarray:
    """Host inverse of :func:`quantize_sequences` (JAX ``:292-303``)."""
    if len(payload) == 3:
        q1, q2, scale = payload
        hidden = q1.astype(np.float32) + q2.astype(np.float32) / 254.0
        hidden *= (scale.astype(np.float32) / 32767.0)[..., None]
        return hidden
    if len(payload) == 2:
        q, scale = payload
        qmax = 127.0 if q.dtype == np.int8 else 32767.0
        hidden = q.astype(np.float32)
        hidden *= (scale.astype(np.float32) / qmax)[..., None]
        return hidden
    return payload[0]


def _copy_frames(dst: torch.Tensor, src: torch.Tensor, dst_rows: np.ndarray,
                 dst_offs: np.ndarray, src_rows: np.ndarray, counts: np.ndarray) -> None:
    """``dst[dst_rows[k], dst_offs[k] + t] = src[src_rows[k], t]`` for
    ``t < counts[k]``, as one gather and one scatter over flat frame indices
    built on the host. Only valid frames move, so segments never overlap
    and the order of the writes does not matter."""
    counts = np.asarray(counts, np.int64)
    within = np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts, counts)
    src_idx = np.repeat(np.asarray(src_rows, np.int64) * src.shape[1], counts) + within
    dst_idx = (np.repeat(np.asarray(dst_rows, np.int64) * dst.shape[1]
                         + np.asarray(dst_offs, np.int64), counts) + within)
    hdim = src.shape[2]
    src_idx, dst_idx = (torch.from_numpy(a).to(dst.device, non_blocking=True)
                        for a in (src_idx, dst_idx))
    dst.view(-1, hdim).index_copy_(0, dst_idx, src.reshape(-1, hdim).index_select(0, src_idx))


class Wav2Vec2Extractor:
    """Reusable extractor owning the encoder and its weights.

    The encoder is the one ``config``'s class names (:data:`ENCODERS`):
    Wav2Vec2 for a ``Wav2Vec2Config``, WavLM for a
    :class:`..models.wavlm.WavLMConfig`, the Conformer for a
    :class:`..models.conformer.ConformerConfig` (the last two float32 only;
    a ``mesh`` with mp > 1 raises for them; on a card the Conformer raises
    for chunks over the kernel's 1024 frames, ``chunk_seconds`` > 20.485). ``params`` is a state dict for
    that encoder (e.g. from
    :func:`..models.weights.wav2vec2_state_dict_from_flat`,
    :func:`..models.wav2vec2.port_hf_state_dict`,
    :func:`..models.wavlm.port_hf_wavlm_state_dict` or
    :func:`..models.conformer.port_hf_conformer_state_dict`). Without weights it raises
    unless ``allow_random_init=True`` (tests / throughput runs), in which case
    the weights are drawn from ``torch.Generator().manual_seed(seed)``, a
    warning is emitted and ``.pretrained`` is False.

    ``compute_dtype`` overrides the config's ("float32" keeps strict
    parity; "bfloat16" runs matmuls and convs in bfloat16 at ~1e-3 output
    perturbation). ``upload_dtype=np.int16`` halves the waveform upload: the
    host rounds and clips ``x · 32768`` to int16 and the device multiplies
    by 1/32768, bit-exact for waveforms on the 16-bit PCM lattice; it
    cannot be combined with ``normalize=True``. ``sequence_transfer_dtype``
    sets the download format of :meth:`extract_sequences` (see
    :func:`quantize_sequences`); sequences come back as float32 whatever it
    is, and embeddings always cross in float32.

    ``mesh`` (a :class:`..parallel.mesh.DeviceGrid`) splits every chunk
    batch over its dp rows and the encoder's weights over its mp devices
    (:class:`..models.wav2vec2.ShardedWav2Vec2`); ``batch_size`` must divide
    by dp. The batches are uploaded to, and every result gathered on, the
    grid's lead device, which is then the extractor's ``device``: each
    transfer dtype, the bf16 preset, the embeddings and the resident buffer
    of :meth:`extract_sequences_resident` go through the split the same way.
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
        compute_dtype: Optional[str] = None,
        sequence_transfer_dtype=np.float32,
        upload_dtype=np.float32,
        device: DeviceLike = "cuda",
        mesh: Optional[DeviceGrid] = None,
    ):
        if mesh is not None and batch_size % mesh.dp != 0:
            raise ValueError(f"batch_size {batch_size} not divisible by dp={mesh.dp}")
        encoder = encoder_class(config)
        if mesh is not None and mesh.mp > 1 and encoder is not Wav2Vec2Model:
            raise ValueError(f"{encoder.__name__} is not split over mp > 1 devices "
                             f"(mp={mesh.mp}): give it a mesh with mp=1, or none")
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh.lead
        if compute_dtype is not None and compute_dtype != config.compute_dtype:
            config = dataclasses.replace(config, compute_dtype=compute_dtype)
        self.config = config
        self.transfer = _transfer_name(sequence_transfer_dtype)
        self.upload_dtype = np.dtype(upload_dtype)
        if self.upload_dtype == np.int16 and normalize:
            raise ValueError(
                "upload_dtype=int16 requires normalize=False: per-chunk "
                "normalized samples are not confined to [-1, 1)."
            )
        if self.upload_dtype not in (np.dtype(np.float32), np.dtype(np.int16)):
            raise ValueError(f"unsupported upload_dtype {self.upload_dtype}")
        if not 0 <= overlap_seconds < chunk_seconds:
            raise ValueError(
                f"overlap_seconds ({overlap_seconds}) must be in "
                f"[0, chunk_seconds={chunk_seconds}): the chunk step is "
                "chunk_seconds - overlap_seconds and must stay positive."
            )
        self.chunk_size = int(SAMPLE_RATE * chunk_seconds)
        self.step_size = int(SAMPLE_RATE * (chunk_seconds - overlap_seconds))
        if encoder is ConformerModel:  # the card kernel's frame limit, before any audio
            check_frames(config.output_length(self.chunk_size), self.device)
        self.min_samples = int(SAMPLE_RATE * MIN_SECONDS)
        self.batch_size = batch_size
        # Applied PER CHUNK, as the reference runs its processor per chunk.
        self.normalize = normalize
        self.pretrained = params is not None
        model = encoder(config)
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
        self._sharded = None if mesh is None else ShardedWav2Vec2(self.model, mesh)

    @classmethod
    def from_hf_checkpoint(cls, checkpoint_path_or_name: str, **kwargs) -> "Wav2Vec2Extractor":
        """Load weights from a local HuggingFace checkpoint directory
        (needs the ``transformers`` package). A checkpoint whose
        ``model_type`` is ``"wavlm"`` (the Large layout) gives a WavLM
        extractor, one whose ``model_type`` is ``"wav2vec2-conformer"``
        (relative positions, layer-norm convs) a Conformer extractor, each
        with its ``config`` read from the checkpoint unless given."""
        import transformers

        model_type = transformers.AutoConfig.from_pretrained(checkpoint_path_or_name).model_type
        if model_type in _HF_ROUTES:
            backbone, config_from_hf, port = _HF_ROUTES[model_type]
            hf = getattr(transformers, backbone).from_pretrained(checkpoint_path_or_name)
            kwargs.setdefault("config", config_from_hf(hf.config))
            return cls(params=port(hf.state_dict()), **kwargs)
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

    def _frames(self, n_samples: int) -> int:
        return int(self.config.output_length(n_samples))

    @spanned("w2v2.extract")
    def extract_sequences(
        self, waveforms: Mapping[str, np.ndarray], verbose: bool = True
    ) -> Dict[str, np.ndarray]:
        """{name: 16 kHz mono waveform} → {name: (T, hidden) float32 sequences}."""
        names, chunk_refs, chunk_data = self._gather_chunks(waveforms, verbose)
        if not names:
            return {}

        def forward(sel, wav, lengths):
            return quantize_sequences(self._encode(wav, lengths)[0], self.transfer)

        out_per_chunk: List[Optional[np.ndarray]] = [None] * len(chunk_data)
        for sel, payload in self._run_batches(chunk_data, forward):
            with span("w2v2.assemble"):
                hidden = dequantize_sequences(payload)
                for j, i in enumerate(sel):
                    out_per_chunk[i] = hidden[j, : self._frames(chunk_refs[i].n_samples)]

        with span("w2v2.stack"):
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

    @spanned("w2v2.extract")
    def extract_sequences_resident(
        self,
        waveforms: Mapping[str, np.ndarray],
        verbose: bool = True,
        align: int = 128,
    ) -> "ResidentSequences":
        """Extract the corpus's (T, hidden) sequences into one device buffer.

        The fused extract→train handoff (JAX ``:454-529``): each chunk's
        valid frames are written straight into a zero (N, T_final, H) float32
        buffer at (file row, frame offset), T_final = max(align,
        align-up(max T)), the shape a host-side ``DeviceCorpus`` upload of
        the same sequences has (train-mode BatchNorm takes its statistics
        over padded frames, so the padding width is part of the result).
        Nothing but the chunk batches and their frame indices crosses the
        link. Chunk semantics are those of :meth:`extract_sequences`.

        The JAX package writes each chunk's whole zero-masked window with
        ``dynamic_update_slice`` and is right only because it writes in
        chunk order (a short non-final chunk, as in an 8.9 s file, has a zero
        tail over the next chunk's frames); it pads the buffer by a chunk
        and a scratch row so that no start index is clamped, and trims them.
        Here only valid frames are written (:func:`_copy_frames`), so the
        writes are disjoint and need neither.

        With a ``mesh`` the encoder runs split over the grid and the buffer
        lies on its lead device (the JAX package ignores its mesh here); a
        multi-device CV run over it copies it to each device of its grid
        (``eval.dl_cv._as_device_corpus``).
        """
        names, chunk_refs, chunk_data = self._gather_chunks(waveforms, verbose)
        if not names:
            return ResidentSequences([], None, np.zeros(0, np.int64))
        # per-chunk (row, frame offset): concatenation WITHOUT overlap trimming
        offs, counts, total = [], [], [0] * len(names)
        for ref in chunk_refs:
            offs.append(total[ref.file_index])
            counts.append(self._frames(ref.n_samples))
            total[ref.file_index] += counts[-1]
        rows = [ref.file_index for ref in chunk_refs]
        buf = torch.zeros((len(names), _aligned_length(max(total), align),
                           self.config.hidden_size),
                          dtype=torch.float32, device=self.device)

        def forward(sel, wav, lengths):
            hidden = self._encode(wav, lengths)[0]
            _copy_frames(buf, hidden, [rows[i] for i in sel], [offs[i] for i in sel],
                         np.arange(len(sel)), [counts[i] for i in sel])
            return ()

        for _ in self._run_batches(chunk_data, forward):
            pass
        return ResidentSequences(names, buf, np.asarray(total, np.int64))

    @spanned("w2v2.extract")
    def extract_embeddings_arrays(
        self, waveforms: Mapping[str, np.ndarray], verbose: bool = True
    ) -> Tuple[List[str], np.ndarray]:
        """Mean-pooled embeddings: (names, (N, hidden) float64).

        Pooling runs on the device: per-chunk masked frame sums, so only
        (B, H) float32 sums cross; the host adds them per file in float64
        and divides by the frame count. The per-file mean over summed
        chunks equals the reference's mean over the overlap-duplicated
        concatenation: both average every frame of every chunk.
        """
        names, chunk_refs, chunk_data = self._gather_chunks(waveforms, verbose)
        hdim = self.config.hidden_size
        if not names:
            return [], np.zeros((0, hdim), np.float64)

        def forward(sel, wav, lengths):
            hidden, n_frames = self._encode(wav, lengths)
            t = torch.arange(hidden.shape[1], device=hidden.device)
            mask = (t[None, :] < n_frames[:, None]).to(hidden.dtype)
            return (torch.einsum("bth,bt->bh", hidden, mask),)

        sums = np.zeros((len(names), hdim), np.float64)
        counts = np.zeros(len(names), np.int64)
        for sel, (chunk_sums,) in self._run_batches(chunk_data, forward):
            for j, i in enumerate(sel):
                fi = chunk_refs[i].file_index
                sums[fi] += chunk_sums[j]
                counts[fi] += self._frames(chunk_refs[i].n_samples)
        keep = counts > 0
        return ([n for n, k in zip(names, keep) if k],
                sums[keep] / counts[keep][:, None])

    def extract_embeddings(self, waveforms: Mapping[str, np.ndarray], verbose: bool = True):
        """Mean-pooled summary features as a DataFrame: ``dim_0..dim_{H-1}``
        and ``filename`` (the JAX package's columns, in its order)."""
        import pandas as pd

        names, means = self.extract_embeddings_arrays(waveforms, verbose)
        if not names:
            return pd.DataFrame()
        df = pd.DataFrame(means, columns=[f"dim_{k}" for k in range(means.shape[1])])
        df["filename"] = names
        return df

    # --- the batch pipeline ---------------------------------------------

    @spanned("w2v2.gather")
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

    @spanned("w2v2.pack")
    def _pack(self, chunk_data: Sequence[np.ndarray], sel: range) -> Tuple[np.ndarray, np.ndarray]:
        """One (batch_size, chunk_size) batch in the upload dtype and its
        (batch_size,) int32 sample counts. A short last batch is padded with
        zero chunks of ``min_samples``, so every batch has one shape.
        Counts the batch's real samples (``w2v2.samples``) and the zero
        samples the encoder runs on besides (``w2v2.pad_samples``), and
        its attention's (query, key) pairs: those of the real chunks' frames
        (``w2v2.attn_pairs``, Σ t²) and the rest of the padded batch's
        (``w2v2.attn_pad_pairs``, filler rows included)."""
        batch = np.zeros((self.batch_size, self.chunk_size), self.upload_dtype)
        lengths = np.full(self.batch_size, self.min_samples, np.int32)
        real = pairs = 0
        for j, i in enumerate(sel):
            c = chunk_data[i]
            if self.normalize:
                c = (c - c.mean()) / np.sqrt(c.var() + 1e-7)
            if self.upload_dtype == np.int16:
                c = np.clip(np.round(c * 32768.0), -32768, 32767).astype(np.int16)
            batch[j, : len(c)] = c
            lengths[j] = len(c)
            real += len(c)
            pairs += self._frames(len(c)) ** 2
        count("w2v2.samples", real)
        count("w2v2.pad_samples", batch.size - real)
        count("w2v2.attn_pairs", pairs)
        count("w2v2.attn_pad_pairs", self.batch_size * self._frames(self.chunk_size) ** 2 - pairs)
        return batch, lengths

    @spanned("w2v2.encode")
    def _encode(self, wav: torch.Tensor,
                lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, L) waveforms (int16 → ·1/32768, the inverse of the PCM lattice)
        → (B, T, H) float32 hidden states and (B,) valid frame counts; frames
        past a chunk's count are garbage."""
        if wav.dtype == torch.int16:
            wav = wav.to(torch.float32) * (1.0 / 32768.0)
        with torch.no_grad():
            if self._sharded is not None:
                return self._sharded(wav, lengths)
            return self.model(wav, lengths)

    def _run_batches(
        self,
        chunk_data: Sequence[np.ndarray],
        forward: Callable[[range, torch.Tensor, torch.Tensor], Tuple[torch.Tensor, ...]],
    ) -> Iterator[Tuple[range, Tuple[np.ndarray, ...]]]:
        """Run ``forward(sel, wav, lengths)`` over the chunks ``batch_size``
        at a time; yield (chunk indices, host copies of what it returned)
        per batch, in order.

        On the card, the upload of batch k+1, the forward of batch k and the
        download of batch k−1 overlap (:data:`PIPELINE_DEPTH` batches in
        flight); on the CPU the stages run one after another.
        """
        cuda = self.device.type == "cuda"
        upload = torch.cuda.Stream(self.device) if cuda else None
        download = torch.cuda.Stream(self.device) if cuda else None
        inflight: collections.deque = collections.deque()
        for start in range(0, len(chunk_data), self.batch_size):
            sel = range(start, min(start + self.batch_size, len(chunk_data)))
            wav, lengths = self._upload(self._pack(chunk_data, sel), upload)
            inflight.append((sel, self._download(forward(sel, wav, lengths), download)))
            if len(inflight) > PIPELINE_DEPTH:
                yield _fetched(*inflight.popleft())
        while inflight:
            yield _fetched(*inflight.popleft())

    @spanned("w2v2.upload")
    def _upload(self, arrays: Sequence[np.ndarray], stream) -> List[torch.Tensor]:
        """Host arrays → device tensors: on the card, from pinned memory with
        non-blocking copies on ``stream``, which the compute stream waits
        for."""
        if stream is None:
            return [torch.from_numpy(a).to(self.device) for a in arrays]
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(stream):
            out = [torch.from_numpy(a).pin_memory().to(self.device, non_blocking=True)
                   for a in arrays]
        compute.wait_stream(stream)
        for t in out:
            t.record_stream(compute)  # allocated on the copy stream, used on compute
        return out

    @spanned("w2v2.download")
    def _download(self, payload: Tuple[torch.Tensor, ...], stream):
        """Device tensors → (host tensors, event that marks their arrival):
        on the card, non-blocking copies into pinned memory on ``stream``
        after the compute stream's work so far."""
        if stream is None:
            return tuple(t.cpu() for t in payload), None
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         .copy_(t, non_blocking=True) for t in payload)
            done = torch.cuda.Event()
            done.record(stream)
        for t in payload:
            t.record_stream(stream)
        return host, done


@spanned("w2v2.fetch")
def _fetched(sel: range, pending) -> Tuple[range, Tuple[np.ndarray, ...]]:
    host, done = pending
    if done is None:
        return sel, tuple(t.numpy() for t in host)
    with span("w2v2.wait"):
        done.synchronize()
    # copied out of pinned memory, which goes back to the allocator for the
    # next batches
    return sel, tuple(t.numpy().copy() for t in host)


class ResidentSequences:
    """A corpus of (T, hidden) sequences resident on the device.

    Produced by :meth:`Wav2Vec2Extractor.extract_sequences_resident` and
    :meth:`regroup`: ``x`` is one padded (N, T_pad, H) float32 tensor, row i
    holding ``names[i]`` in its first ``lengths[i]`` frames and zeros after
    them. Behaves as a read-only ``Mapping[str, np.ndarray]`` for host
    consumers (each lookup downloads just that row, cached), while the CV
    engines (``train.loops.DeviceCorpus.from_resident``) read the tensor
    with no transfer.
    """

    is_resident_sequences = True  # duck-type marker for the CV engines

    def __init__(self, names, x: Optional[torch.Tensor], lengths):
        self.names = list(names)
        self.x = x
        self.lengths = np.asarray(lengths, np.int64)
        self._index = {n: i for i, n in enumerate(self.names)}
        self._host_cache: Dict[int, np.ndarray] = {}

    def row(self, name: str) -> int:
        """Row index of ``name`` in ``x`` (for resident-corpus adoption)."""
        return self._index[name]

    # --- Mapping façade ----------------------------------------------------

    def __len__(self) -> int:
        return len(self.names)

    def __iter__(self):
        return iter(self.names)

    def __contains__(self, name) -> bool:
        return name in self._index

    def keys(self):
        return list(self.names)

    def __getitem__(self, name: str) -> np.ndarray:
        i = self._index[name]
        seq = self._host_cache.get(i)
        if seq is None:
            seq = self._host_cache[i] = self.x[i, : int(self.lengths[i])].cpu().numpy()
        return seq

    def items(self):
        return [(n, self[n]) for n in self.names]

    def regroup(self, groups: Mapping[str, Sequence[str]], align: int = 128) -> "ResidentSequences":
        """Concatenate member sequences into new keyed sequences, on the device.

        The resident twin of ``data.aggregate.aggregate_interview_sequences``
        (JAX ``:618-684``): ``groups`` maps each new key to its ordered member
        names (e.g. ``data.aggregate.participant_clips``); members missing
        from this corpus are skipped, and groups with no member left are
        omitted. The result is padded to max(align, align-up(max T)), as a
        host upload of the concatenated sequences would be.
        """
        kept: List[Tuple[str, List[int]]] = []
        for key, members in groups.items():
            idxs = [self._index[m] for m in members if m in self._index]
            if idxs:
                kept.append((key, idxs))
        if not kept:
            return ResidentSequences([], None, np.zeros(0, np.int64))
        dst_rows, dst_offs, src_rows, totals = [], [], [], []
        for new_row, (_, idxs) in enumerate(kept):
            off = 0
            for i in idxs:
                dst_rows.append(new_row)
                dst_offs.append(off)
                src_rows.append(i)
                off += int(self.lengths[i])
            totals.append(off)
        buf = torch.zeros((len(kept), _aligned_length(max(totals), align), self.x.shape[2]),
                          dtype=self.x.dtype, device=self.x.device)
        _copy_frames(buf, self.x, dst_rows, dst_offs, src_rows, self.lengths[src_rows])
        return ResidentSequences([k for k, _ in kept], buf, np.asarray(totals, np.int64))


# --- DataFrame front doors ----------------------------------------------------


def _load_waveforms(input_df, audio_file_column: str, verbose: bool) -> Dict[str, np.ndarray]:
    """Decode each row's file with the Python codec, keyed by basename; a
    duplicate basename or an unreadable file is reported and dropped."""
    from ..audio.io import load_mono_16k

    out = {}
    for path in input_df[audio_file_column]:
        name = os.path.basename(path)
        if name in out:
            if verbose:
                print(
                    f"ERROR: duplicate basename '{name}' (from '{path}'); "
                    "row dropped — filenames must be unique."
                )
            continue
        try:
            out[name] = load_mono_16k(path)
        except Exception as e:  # the reference skips unreadable files
            if verbose:
                print(f"ERROR loading '{name}': {e}. Skipping.")
    return out


def extract_wav2vec2_sequences(
    input_df,
    extractor: Optional[Wav2Vec2Extractor] = None,
    audio_file_column: str = "filepath",
    verbose: bool = True,
    waveforms: Optional[Mapping[str, np.ndarray]] = None,
    **extractor_kwargs,
) -> Dict[str, np.ndarray]:
    """DataFrame-of-filepaths front door (JAX ``:710-729``).

    ``waveforms`` lets callers supply decoded audio (e.g. from
    ``audio.native_io.load_corpus_mono_16k``) instead of the per-file decode
    here. An empty DataFrame (a corpus with no Interview-Task directory)
    gives ``{}``.
    """
    if input_df.empty:
        return {}
    extractor = extractor or Wav2Vec2Extractor(**extractor_kwargs)
    if waveforms is None:
        waveforms = _load_waveforms(input_df, audio_file_column, verbose)
    return extractor.extract_sequences(waveforms, verbose=verbose)


def extract_wav2vec2_embeddings(
    input_df,
    extractor: Optional[Wav2Vec2Extractor] = None,
    audio_file_column: str = "filepath",
    verbose: bool = True,
    waveforms: Optional[Mapping[str, np.ndarray]] = None,
    **extractor_kwargs,
):
    """Mean-pooled embeddings front door (JAX ``:732-745``): a DataFrame of
    ``dim_*`` and ``filename``, empty for an empty input."""
    if input_df.empty:
        import pandas as pd

        return pd.DataFrame()
    extractor = extractor or Wav2Vec2Extractor(**extractor_kwargs)
    if waveforms is None:
        waveforms = _load_waveforms(input_df, audio_file_column, verbose)
    return extractor.extract_embeddings(waveforms, verbose=verbose)
