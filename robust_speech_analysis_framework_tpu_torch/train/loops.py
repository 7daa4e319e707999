"""Training and evaluation of the CNN-LSTM (PyTorch): the fold trainer.

Counterpart of ``robust_speech_analysis_framework_tpu/train/loops.py``, the
fold trainer the CV engines call: epochs of Adam and cross-entropy over
shuffled batches, a validation loss per epoch,
``ReduceLROnPlateau(factor=0.1, patience=5)``, early stopping with
best-weight restore, and an eval pass returning (labels, predictions,
P(class 1)). On the card every train step runs the biLSTM through K5 (the
K3 forward and the K4 reverse sweep, one launch each per layer) and every
eval batch through K1.

A fold takes its batches one of two ways (``TrainConfig.device_fold``):

* **streaming**: each batch is padded on the host to its own bucketed
  length (``pad_batch``) and uploaded;
* **device-resident**: the fold's sequences lie on the trainer's device as
  one padded tensor, either a :class:`DeviceCorpus` uploaded once per CV run
  and shared by every fold and trial through :class:`SeqView` index views,
  or the fold's own train and val sets padded once to ONE bucketed length;
  the epochs' batch plan (:func:`_epoch_batch_plan`, the streaming path's
  shuffles) is uploaded once per fold and every batch is a gather on the
  device (``x[idx]``, ``lengths[idx]``, ``y[idx]``). No batch crosses the
  bus. Every batch is computed at the one global padded length, as in the
  JAX package, so train-mode BatchNorm (whose statistics include padded
  frames) sees that length and not the batch's own bucket: the two paths
  agree bit for bit where all sequences share one bucket and the global
  length equals it, and differ slightly in the BatchNorm statistics
  otherwise, in both packages alike.

Where it differs from the JAX package, by design:

* State is a torch module and optimizer updated in place, not a pure
  function's value: :class:`TrainState` holds them and the learning rate.
  Optax's ``adam(eps=1e-8)`` with the rate injected each step is the same
  arithmetic as ``torch.optim.Adam(eps=1e-8)`` with the group's ``lr`` set.
* The JAX LSTM cell has one bias per direction; the port's modules carry
  torch's two (``bias_ih``, ``bias_hh``, the reference checkpoint names).
  Both get the same gradient and Adam's update is normalised, so training
  both would move their sum twice as far as JAX moves its bias.
  :meth:`Trainer.init_state` folds ``bias_hh`` into ``bias_ih`` and keeps it
  at zero, out of the optimizer.
* The JAX resident fold is one compiled ``lax.while_loop`` program a fold,
  so that a host far from its chip dispatches once. PyTorch compiles
  nothing and the host sits beside the card: both paths here share ONE host
  epoch loop (:func:`_run_epochs`) and differ only in where a batch comes
  from. One fetch an epoch (the losses) stays on both. So
  ``train/aot_cache.py`` and ``_warmup_step_shapes`` have nothing to do
  here: no program is compiled per shape, and the CUDA kernels are built
  once, at first use.
* The JAX resident fold restores only the parameters and BatchNorm
  statistics of the best epoch, its streaming path the whole best state;
  here both restore model, optimizer and rate (:func:`_restore`). A restored
  model's outputs are the same either way.
* ``DeviceCorpus`` and ``ResidentCorpus`` take the ``device`` they upload to
  (``"cuda"`` unless the caller asks for the CPU) and no ``sharding``: a
  multi-device run reads a corpus's device-side copy on each device of its
  grid (:meth:`DeviceCorpus.on`), made once.
* Lane-batched trials (:func:`train_trials_device`): the JAX package vmaps
  its fold program over K trials; here :class:`CNNLSTMLanes` stacks the K
  models on a lane axis and one host epoch loop (:func:`_run_epochs_lanes`)
  keeps each lane's books, so every lane step launches K3, K4 and dWh once a
  biLSTM layer for all lanes, at G = 2K. A lane whose patience runs out is
  computed on and restored at the end, as a batched ``while_loop`` freezes
  it. With ``mesh``, the lanes split into groups, one a device along
  ``lane_axis``, each driven from its own host thread.
* Multi-device training runs in one process (the JAX package's one
  controller), not a process group: :class:`ShardedTrainState` and
  :func:`sharded_train_step` lay a model over a (dp, mp)
  :class:`..parallel.mesh.DeviceGrid`, the batch over dp and the
  rule-matched parameters with their Adam moments over mp, each shard in
  its own host thread; BatchNorm takes the whole batch's statistics and
  dropout the whole batch's masks, so the step is the single-device step
  with its sums in another order.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import threading
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np
import torch
import torch.nn.functional as F

from ..data.batching import batch_iterator, bucket_length, length_sorted_batches, pad_batch
from ..device import DeviceLike, fp32_convs, resolve_device
from ..models.cnn_lstm import CNNLSTM, BatchNorm, CNNLSTMLanes
from ..models.init import init_training_weights_
from ..ops.framing import Deferred
from ..parallel.mesh import DeviceGrid, in_threads
from ..utils.profiling import span, spanned


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 1e-3
    epochs: int = 100
    patience: int = 25
    batch_size: int = 8
    seed: int = 0
    plateau_factor: float = 0.1
    plateau_patience: int = 5
    # Mask padded timesteps (attention/LSTM/conv reads). The torch reference
    # is unmasked, but it pads only to the BATCH max; the bucket ladder pads
    # further, so unmasked here would amplify padding effects beyond the
    # reference and make logits depend on co-batched sequence lengths.
    use_length_masking: bool = True
    min_bucket: int = 64
    # dropout rate passed to the model at call time (between biLSTM layers
    # and on the pooled vector); None -> the model's own dropout_rate
    dropout_rate: Optional[float] = None
    # the reference's inner Optuna objective trains plain fixed-epoch Adam
    # and scores FINAL weights; its outer training uses plateau decay +
    # best-weight restore. Both behaviors are selectable.
    use_plateau: bool = True
    restore_best: bool = True
    # recompute the forward in the backward pass (torch.utils.checkpoint)
    # instead of storing its activations: same numbers, less memory, about
    # one more forward of compute
    remat: bool = False
    # Device-resident fold: batches are gathered on the device from one
    # padded tensor instead of being padded on the host and uploaded. "auto"
    # takes it when train and val are views of one DeviceCorpus or when the
    # padded train+val arrays fit the budget below; "on"/"off" force it.
    # Every batch is then computed at the fold's one global padded length, so
    # train-mode BatchNorm statistics differ slightly from the streaming
    # path's per-batch buckets unless all sequences share one bucket.
    device_fold: str = "auto"
    device_fold_budget_bytes: int = 4 << 30


class ReduceLROnPlateau:
    """Multiply LR by ``factor`` after ``patience`` epochs without val-loss
    improvement (torch ReduceLROnPlateau semantics, mode='min')."""

    def __init__(self, factor: float = 0.1, patience: int = 5, min_lr: float = 0.0,
                 threshold: float = 1e-4):
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.best = float("inf")
        self.num_bad = 0

    def step(self, metric: float, lr: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                lr = max(lr * self.factor, self.min_lr)
                self.num_bad = 0
        return lr


@dataclasses.dataclass
class TrainState:
    """A model being trained: its module (parameters and BatchNorm running
    statistics), its Adam optimizer, and the current learning rate."""

    model: CNNLSTM
    optimizer: torch.optim.Adam
    lr: float


def fold_lstm_biases_(model: CNNLSTM) -> List[torch.nn.Parameter]:
    """Fold each direction's ``bias_hh`` into its ``bias_ih``, zero it and
    freeze it; returns the parameters left to train (all but ``bias_hh``)."""
    trainable = []
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1].startswith("bias_hh"):
                ih = model.get_parameter(name.replace("bias_hh", "bias_ih"))
                ih.add_(p)
                p.zero_()
                p.requires_grad_(False)
            else:
                trainable.append(p)
    return trainable


class LaneAdam:
    """Adam for K lanes, each at its own learning rate.

    ``torch.optim.Adam``'s arithmetic in its order (``lerp_`` of the first
    moment, ``mul_``/``addcmul_`` of the second, ``step_size = lr / (1 −
    β1^t)``, ``denom = sqrt(v) / sqrt(1 − β2^t) + eps``, ``p −= step_size · m /
    denom``) with ``step_size`` a lane's own, so a lane moves as
    ``torch.optim.Adam`` at that lane's rate would move it. The parameters
    (lane-major: (K, ...), or K·C for a BatchNorm) are re-seated in one flat
    buffer and their gradients in another, so one step is a dozen launches
    for every tensor and lane. ``flat``, ``exp_avg``, ``exp_avg_sq`` and
    ``steps`` (a count a lane, which a lane's restore can set apart) are the
    state; ``offsets`` maps a parameter's name to its (start, numel) in the
    flat buffers.
    """

    def __init__(self, named_params: Sequence[Tuple[str, torch.nn.Parameter]], lanes: int,
                 eps: float = 1e-8, betas: Tuple[float, float] = (0.9, 0.999)):
        self.lanes, self.eps, self.betas = lanes, eps, betas
        numels = [p.numel() for _, p in named_params]
        device = named_params[0][1].device
        self.flat = torch.empty(sum(numels), device=device)
        self.grad = torch.zeros_like(self.flat)
        self.offsets: Dict[str, Tuple[int, int]] = {}
        start = 0
        with torch.no_grad():
            for (name, p), n in zip(named_params, numels):
                self.flat[start : start + n].copy_(p.reshape(-1))
                p.data = self.flat[start : start + n].view_as(p)
                # backward adds into a gradient that is already there, in place
                p.grad = self.grad[start : start + n].view_as(p)
                self.offsets[name] = (start, n)
                start += n
        self.exp_avg = torch.zeros_like(self.flat)
        self.exp_avg_sq = torch.zeros_like(self.flat)
        self.steps = [0] * lanes
        # one lane's numel of each tensor, once a lane: repeat_interleave of a
        # (K,) vector tiled once a tensor spreads it over the flat layout
        self._repeats = torch.tensor([n // lanes for n in numels for _ in range(lanes)],
                                     device=device)

    def per_element(self, values: torch.Tensor) -> torch.Tensor:
        """A (K,) vector spread over the flat layout: each element gets its lane's value."""
        return torch.repeat_interleave(values.repeat(len(self.offsets)), self._repeats,
                                       output_size=self.flat.numel())

    def zero_grad(self) -> None:
        self.grad.zero_()

    @torch.no_grad()
    def step(self, lr: torch.Tensor) -> None:
        """One update of every lane; ``lr`` (K,) float64 on the device. The
        lanes share one step count (lanes restored to other epochs' states
        do not: train those one by one, through ``lane_state``)."""
        if len(set(self.steps)) != 1:
            raise ValueError(f"lanes at different step counts {self.steps}")
        beta1, beta2 = self.betas
        self.steps = [s + 1 for s in self.steps]
        self.exp_avg.lerp_(self.grad, 1 - beta1)
        self.exp_avg_sq.mul_(beta2).addcmul_(self.grad, self.grad, value=1 - beta2)
        bc1 = 1 - beta1 ** self.steps[0]
        bc2_sqrt = (1 - beta2 ** self.steps[0]) ** 0.5
        step_size = self.per_element((lr / bc1).to(torch.float32))
        denom = (self.exp_avg_sq.sqrt() / bc2_sqrt).add_(self.eps)
        self.flat.addcdiv_(self.exp_avg * step_size, denom, value=-1.0)

    def lane(self, buf: torch.Tensor, i: int) -> Dict[str, torch.Tensor]:
        """Lane ``i``'s part of each parameter in ``buf`` (one of the flat
        buffers), as flat copies."""
        return {name: buf[start : start + n].view(self.lanes, -1)[i].clone()
                for name, (start, n) in self.offsets.items()}


@dataclasses.dataclass
class LaneTrainState:
    """K trials of one architecture trained together
    (:func:`train_trials_device`): the lane-stacked module, its
    :class:`LaneAdam`, and the lanes' learning rates, a (K,) float64 tensor
    on the device."""

    model: CNNLSTMLanes
    optimizer: LaneAdam
    lr: torch.Tensor

    @classmethod
    def replicate(cls, state: TrainState, lr: torch.Tensor) -> "LaneTrainState":
        """``len(lr)`` lanes that each start as ``state`` (its biases folded,
        its residual blocks' dropout rate kept)."""
        model = CNNLSTMLanes.from_state_dict(
            state.model.state_dict(), len(lr), activation_fn=state.model.activation_fn,
            dropout_rate=state.model.dropout_rate)
        for block in ("res_block1", "res_block2"):
            getattr(model, block).dropout = getattr(state.model, block).dropout
        fold_lstm_biases_(model)
        trainable = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        return cls(model, LaneAdam(trainable, len(lr), eps=state.optimizer.defaults["eps"]), lr)

    def lane_state(self, i: int) -> TrainState:
        """Lane ``i`` as a plain :class:`TrainState`: its parameters, BatchNorm
        statistics, Adam moments and step count, and its rate."""
        model = self.model.lane_model(i)
        lr = float(self.lr[i])
        optimizer = torch.optim.Adam(fold_lstm_biases_(model), lr=lr, eps=self.optimizer.eps)
        steps = self.optimizer.steps[i]
        if steps:
            shapes = self.model.lane_shapes()
            exp_avg = self.optimizer.lane(self.optimizer.exp_avg, i)
            exp_avg_sq = self.optimizer.lane(self.optimizer.exp_avg_sq, i)
            for name, p in model.named_parameters():
                if name in exp_avg:
                    optimizer.state[p] = {
                        "step": torch.tensor(float(steps)),
                        "exp_avg": exp_avg[name].reshape(shapes[name]),
                        "exp_avg_sq": exp_avg_sq[name].reshape(shapes[name]),
                    }
        return TrainState(model=model, optimizer=optimizer, lr=lr)

    def _tensors(self) -> List[torch.Tensor]:
        """Every tensor of the lanes' training state: first the three in the
        flat layout, then the lane-major ones (BatchNorm statistics, rates)."""
        stats = [b for n, b in self.model.named_buffers() if not n.endswith("num_batches_tracked")]
        opt = self.optimizer
        return [opt.flat, opt.exp_avg, opt.exp_avg_sq, *stats, self.lr]

    def snapshot(self) -> Dict[str, Any]:
        return {"tensors": [t.clone() for t in self._tensors()],
                "steps": list(self.optimizer.steps)}

    def copy_lanes(self, dst: Dict[str, Any], src: Dict[str, Any], lanes: Sequence[int]) -> None:
        """Copy lanes ``lanes`` of ``src`` into ``dst``, each a snapshot or
        :meth:`live` (this state itself)."""
        k = self.optimizer.lanes
        if len(lanes) == k:
            for d, s in zip(dst["tensors"], src["tensors"]):
                d.copy_(s)
        else:
            mask = torch.zeros(k, dtype=torch.bool)
            mask[list(lanes)] = True
            mask = mask.to(self.lr.device)
            flat_mask = self.optimizer.per_element(mask)
            for j, (d, s) in enumerate(zip(dst["tensors"], src["tensors"])):
                if j < 3:
                    d.copy_(torch.where(flat_mask, s, d))
                else:
                    d.view(k, -1).copy_(torch.where(mask[:, None], s.view(k, -1), d.view(k, -1)))
        for i in lanes:
            dst["steps"][i] = src["steps"][i]

    def live(self) -> Dict[str, Any]:
        """This state's own tensors, in :meth:`snapshot`'s form."""
        return {"tensors": self._tensors(), "steps": self.optimizer.steps}


class Trainer:
    """Train and eval steps for one CNN-LSTM architecture on one device.

    ``model`` is the architecture: :meth:`init_state` trains a copy of it.
    """

    def __init__(self, model: CNNLSTM, adam_eps: float = 1e-8, device: DeviceLike = "cuda"):
        self.model = model
        self.adam_eps = adam_eps
        self.device = resolve_device(device)

    def init_state(self, seed: int, lr: float,
                   weights: Optional[Mapping[str, torch.Tensor]] = None) -> TrainState:
        """A fresh copy of the model, initialised with the JAX package's
        initialisers from ``seed`` (or loaded from the state dict
        ``weights``), its LSTM biases folded, and Adam over it."""
        model = copy.deepcopy(self.model).cpu()
        if weights is None:
            init_training_weights_(model, torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(weights)
        model.to(self.device)
        optimizer = torch.optim.Adam(fold_lstm_biases_(model), lr=lr, eps=self.adam_eps)
        return TrainState(model=model, optimizer=optimizer, lr=lr)

    def _tensor(self, a, dtype: torch.dtype) -> torch.Tensor:
        """``a`` on the trainer's device as ``dtype``: a host array is
        uploaded; a tensor already there (a batch gathered from a resident
        corpus) is taken as it is."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device, dtype)
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    # --- steps -------------------------------------------------------------

    @spanned("train.step")
    def train_step(self, state: TrainState, batch, lengths, labels,
                   generator: Optional[torch.Generator],
                   masked: bool = True, dropout_rate: Optional[float] = None,
                   remat: bool = False) -> torch.Tensor:
        """One Adam step on a padded batch (host arrays, or tensors on the
        trainer's device); returns the mean cross-entropy (a device scalar,
        not synchronised)."""
        model = state.model.train()
        x = self._tensor(batch, torch.float32)
        lens = self._tensor(lengths, torch.int64) if masked else None
        y = self._tensor(labels, torch.int64)
        if remat:
            logits = _checkpointed_forward(model, x, lens, dropout_rate, generator)
        else:
            logits = model(x, lens, dropout_rate, generator)
        loss = F.cross_entropy(logits, y)
        state.optimizer.zero_grad(set_to_none=True)
        with fp32_convs():  # the convs' backward and a remat forward run here
            loss.backward()
        for group in state.optimizer.param_groups:
            group["lr"] = state.lr
        state.optimizer.step()
        return loss.detach()

    def eval_step(self, state: TrainState, batch, lengths,
                  masked: bool = True) -> torch.Tensor:
        """Logits (B, num_classes) of a padded batch in eval mode, no gradient."""
        model = state.model.eval()
        with torch.no_grad():
            x = self._tensor(batch, torch.float32)
            lens = self._tensor(lengths, torch.int64) if masked else None
            return model(x, lens)

    @spanned("train.step")
    def train_step_lanes(self, state: LaneTrainState, batch, lengths, labels,
                         generator: Optional[torch.Generator], masked: bool = True,
                         dropout_rates: Optional[torch.Tensor] = None,
                         remat: bool = False) -> torch.Tensor:
        """One Adam step of every lane on a padded batch that all lanes read,
        lane k at ``dropout_rates[k]`` ((K,) on the device); returns the (K,)
        mean cross-entropies (on the device, not synchronised)."""
        model = state.model.train()
        x = self._tensor(batch, torch.float32)
        lens = self._tensor(lengths, torch.int64) if masked else None
        y = self._tensor(labels, torch.int64)
        if remat:
            logits = _checkpointed_forward(model, x, lens, dropout_rates, generator)
        else:
            logits = model(x, lens, dropout_rates, generator)
        losses = _lane_cross_entropy(logits, y)
        state.optimizer.zero_grad()
        with fp32_convs():
            losses.sum().backward()  # a lane's parameters see only its own loss
        state.optimizer.step(state.lr)
        return losses.detach()

    def eval_step_lanes(self, state: LaneTrainState, batch, lengths,
                        masked: bool = True) -> torch.Tensor:
        """Logits (K, B, num_classes) of a padded batch in eval mode, no gradient."""
        model = state.model.eval()
        with torch.no_grad():
            x = self._tensor(batch, torch.float32)
            lens = self._tensor(lengths, torch.int64) if masked else None
            return model(x, lens)

    # --- epoch-level API ---------------------------------------------------

    def eval_logits(self, state: TrainState, sequences: Sequence[np.ndarray],
                    cfg: TrainConfig) -> np.ndarray:
        """(N, num_classes) logits; one copy to the host at the end."""
        return self.eval_logits_deferred(state, sequences, cfg).result()

    def _eval_batches(self, sequences, cfg: TrainConfig) -> Iterator[Tuple[np.ndarray, Any, Any]]:
        """(positions in ``sequences``, padded batch, lengths) of an eval pass.

        A list goes in length-sorted batches, each padded to its own bucket
        and uploaded. A :class:`SeqView` goes in view order, in batches
        gathered from the resident tensor (at its one padded length): nothing
        but the view's row indices is uploaded.
        """
        n = len(sequences)
        if isinstance(sequences, SeqView):
            corpus = sequences.corpus
            rows = self._tensor(sequences.idx, torch.int64)
            for start in range(0, n, cfg.batch_size):
                idx = rows[start : start + cfg.batch_size]
                yield (np.arange(start, min(start + cfg.batch_size, n)),
                       corpus.x[idx].to(torch.float32), corpus.lengths[idx])
        else:
            for idx in length_sorted_batches(sequences, cfg.batch_size):
                batch, lengths = pad_batch([sequences[i] for i in idx],
                                           min_bucket=cfg.min_bucket)
                yield idx, batch, lengths

    def eval_logits_deferred(self, state: TrainState, sequences: Sequence[np.ndarray],
                             cfg: TrainConfig) -> Deferred:
        """Run the whole eval pass (:meth:`_eval_batches`) and return a
        :class:`Deferred` whose result is the (N, num_classes) logits array:
        the per-batch logits stay on the device until the caller collects
        them."""
        n = len(sequences)
        groups: List[np.ndarray] = []
        outs: List[torch.Tensor] = []
        with span("train.eval"):
            for idx, batch, lengths in self._eval_batches(sequences, cfg):
                groups.append(idx)
                outs.append(self.eval_step(state, batch, lengths, cfg.use_length_masking))

        def finalize(host):
            logits = np.zeros((n, self.model.num_classes), np.float32)
            for idx, out in zip(groups, host):
                logits[idx] = out
            return logits

        return Deferred(outs, finalize)

    def eval_logits_trials_deferred(self, states: LaneTrainState,
                                    sequences: Sequence[np.ndarray],
                                    cfg: TrainConfig) -> Deferred:
        """:meth:`eval_logits_deferred` for the lanes of
        :func:`train_trials_device`: every lane scores the same batches (one
        gather or upload a batch, one model call for all lanes); the result
        is the (K, N, num_classes) logits array. Lanes split over devices
        (:class:`LaneGroups`) are scored each on its group's device, over
        the corpus's replica there, and come back in lane order."""
        if isinstance(states, LaneGroups):
            parts = [t.eval_logits_trials_deferred(st, _on(sequences, t.device), cfg)
                     for t, st, _ in states.parts]
            return Deferred([p.arrays for p in parts], lambda host: np.concatenate(
                [p.finalize(h) for p, h in zip(parts, host)]))
        n = len(sequences)
        groups: List[np.ndarray] = []
        outs: List[torch.Tensor] = []
        with span("train.eval"):
            for idx, batch, lengths in self._eval_batches(sequences, cfg):
                groups.append(idx)
                outs.append(self.eval_step_lanes(states, batch, lengths, cfg.use_length_masking))

        def finalize(host):
            logits = np.zeros((states.model.lanes, n, self.model.num_classes), np.float32)
            for idx, out in zip(groups, host):
                logits[:, idx] = out
            return logits

        return Deferred(outs, finalize)


def _lane_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of each lane: logits (K, B, C), labels (B,) → (K,)."""
    k = logits.shape[0]
    losses = F.cross_entropy(logits.flatten(0, 1), labels.repeat(k), reduction="none")
    return losses.view(k, -1).mean(dim=1)


def _checkpointed_forward(model: CNNLSTM, x: torch.Tensor, lengths: Optional[torch.Tensor],
                          dropout_rate: Optional[float],
                          generator: Optional[torch.Generator]) -> torch.Tensor:
    """``model(...)`` under ``torch.utils.checkpoint``. The recomputation
    draws the same dropout masks (``generator`` is rewound to its state at
    the forward) and does not move the BatchNorm running statistics again."""
    from torch.utils.checkpoint import checkpoint

    start = generator.get_state() if generator is not None else None
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]

    @contextlib.contextmanager
    def recompute():
        after = generator.get_state() if generator is not None else None
        if generator is not None:
            generator.set_state(start)
        for bn in norms:
            bn.update_running_stats = False
        try:
            yield
        finally:
            for bn in norms:
                bn.update_running_stats = True
            if generator is not None:
                generator.set_state(after)

    return checkpoint(
        model, x, lengths, dropout_rate, generator, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), recompute()),
    )


Batch = Tuple[Any, Any, Any]  # padded batch, lengths, labels: host arrays or device tensors


def _val_loss(trainer: Trainer, state: TrainState, batches: Iterable[Batch],
              cfg: TrainConfig) -> float:
    """Batch-averaged validation loss (mean of per-batch means, as the
    reference's ``val_loss / len(val_loader)``); one fetch per pass."""
    losses = []
    for batch, lengths, labs in batches:
        logits = trainer.eval_step(state, batch, lengths, cfg.use_length_masking)
        losses.append(F.cross_entropy(logits, trainer._tensor(labs, torch.int64)))
    return float(np.mean(torch.stack(losses).cpu().numpy()))


def _mean_val_loss(trainer: Trainer, state: TrainState, sequences, labels,
                   cfg: TrainConfig) -> float:
    """:func:`_val_loss` over host sequences, streamed in order."""
    return _val_loss(trainer, state, batch_iterator(
        sequences, labels, cfg.batch_size, shuffle=False, min_bucket=cfg.min_bucket), cfg)


# --- the device-resident corpus ------------------------------------------------


def _corpus_dtype(dtype) -> torch.dtype:
    """Storage dtype of a resident corpus: ``dtype`` (a torch dtype or its
    name), else the ``RSAF_CORPUS_DTYPE`` environment variable, else float32."""
    if dtype is None:
        dtype = os.environ.get("RSAF_CORPUS_DTYPE") or torch.float32
    if not isinstance(dtype, torch.dtype):
        dtype = getattr(torch, dtype if isinstance(dtype, str) else np.dtype(dtype).name)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"resident corpus dtype must be float32 or bfloat16, not {dtype}")
    return dtype


def _aligned_length(max_len: int, align: int) -> int:
    return max(align, -(-max_len // align) * align)


class DeviceCorpus:
    """A sequence corpus resident on the device as one padded (N, T, D) tensor.

    Uploaded ONCE per CV run; folds and trials reference rows through
    :class:`SeqView` index views, so no fold uploads a batch. Padding is to
    the corpus max length aligned up to ``align`` frames: one shape for
    every fold and trial.
    """

    def __init__(self, sequences: Sequence[np.ndarray], align: int = 128, dtype=None,
                 device: DeviceLike = "cuda"):
        """``dtype`` sets the RESIDENT storage dtype (default float32, or the
        ``RSAF_CORPUS_DTYPE`` environment variable). ``bfloat16`` halves the
        footprint (111 recordings × ~12k frames × 768 are 4.2 GB in float32) at
        a ~3e-3 relative quantisation of the stored embeddings, rounded on
        the host; consumers gather rows and cast back to float32 on the
        device."""
        device = resolve_device(device)
        self.seqs = [np.asarray(s, dtype=np.float32) for s in sequences]
        lens = [len(s) for s in self.seqs]
        buf = np.zeros((len(self.seqs), _aligned_length(max(lens), align),
                        self.seqs[0].shape[1]), np.float32)
        for i, s in enumerate(self.seqs):
            buf[i, : len(s)] = s
        self.x = torch.from_numpy(buf).to(_corpus_dtype(dtype)).to(device)
        self.host_lengths = np.asarray(lens, np.int64)
        self.lengths = torch.from_numpy(self.host_lengths).to(device)

    def view(self, idx: np.ndarray) -> "SeqView":
        return SeqView(self, np.asarray(idx, np.int64))

    def trimmed_to(self, rows: np.ndarray, align: int = 128) -> "DeviceCorpus":
        """The same storage, its time axis cut to the aligned max length of
        ``rows``: what ``DeviceCorpus`` of those rows alone would pad to, so
        rows left out of a CV run do not set its padded length."""
        t_pad = _aligned_length(int(self.host_lengths[np.asarray(rows)].max()), align)
        if t_pad >= self.x.shape[1]:
            return self
        out = copy.copy(self)
        out.__dict__.pop("_replicas", None)  # those hold the untrimmed length
        out.x = self.x[:, :t_pad]
        return out

    def on(self, device: DeviceLike) -> "DeviceCorpus":
        """This corpus on ``device``: itself when it lies there, else a
        device-side copy, made once and shared by every replica of this
        corpus (a multi-device run reads it on each device of its grid)."""
        device = torch.device(device)
        replicas = self.__dict__.setdefault("_replicas", {self.x.device: self})
        if device not in replicas:
            out = copy.copy(self)
            out.x = self.x.to(device)
            out.lengths = self.lengths.to(device)
            replicas[device] = out
        return replicas[device]

    @classmethod
    def from_resident(cls, resident) -> "DeviceCorpus":
        """Corpus over sequences that already lie on the device (a
        :class:`ResidentCorpus`, or an extractor's resident output with
        ``x`` (N[+1], T_pad, D), ``lengths``, ``names`` and row access by
        name). Nothing is copied: the tensor is adopted as it is. Host-side
        row access (``.seqs[i]``) downloads lazily, for the streaming path."""
        own = getattr(resident, "device_corpus", None)
        if own is not None:  # ResidentCorpus already holds one
            return own()
        self = cls.__new__(cls)
        self.x = resident.x
        self.host_lengths = np.asarray(resident.lengths, np.int64)
        self.lengths = torch.from_numpy(self.host_lengths).to(self.x.device)
        self.seqs = _LazyRows(resident)
        return self

    @staticmethod
    def nbytes_estimate(sequences: Sequence[np.ndarray], align: int = 128) -> int:
        t_pad = _aligned_length(max(len(s) for s in sequences), align)
        return 4 * len(sequences) * t_pad * int(np.asarray(sequences[0]).shape[1])


class ResidentCorpus:
    """A host sequence mapping plus its ONE-TIME device upload, reusable
    across CV calls::

        seqs = ResidentCorpus(sequences_dict)
        run_dl_nested_cv(seqs, meta, ...)          # adopts the resident tensor
        run_dl_standard_kfold_cv(seqs, meta, ...)  # no second upload

    The engines detect it through the ``is_resident_sequences`` marker.
    Behaves as a read-only Mapping for host consumers. The arrays are
    adopted by reference: do not mutate them afterwards.
    """

    is_resident_sequences = True  # duck-type marker for the CV engines

    def __init__(self, sequences_dict, align: int = 128, dtype=None,
                 device: DeviceLike = "cuda"):
        self.names = list(sequences_dict.keys())
        self._index = {n: i for i, n in enumerate(self.names)}
        self._corpus = DeviceCorpus([sequences_dict[n] for n in self.names], align=align,
                                    dtype=dtype, device=device)

    def device_corpus(self) -> DeviceCorpus:
        return self._corpus

    def row(self, name: str) -> int:
        return self._index[name]

    def __len__(self) -> int:
        return len(self.names)

    def __iter__(self):
        return iter(self.names)

    def __contains__(self, name) -> bool:
        return name in self._index

    def keys(self):
        return list(self.names)

    def __getitem__(self, name):
        return self._corpus.seqs[self._index[name]]

    def items(self):
        return [(n, self[n]) for n in self.names]


class _LazyRows:
    """List-of-arrays façade over resident sequences that downloads a row
    only when it is indexed."""

    def __init__(self, resident):
        self._resident = resident

    def __len__(self) -> int:
        return len(self._resident.names)

    def __getitem__(self, i: int) -> np.ndarray:
        return self._resident[self._resident.names[i]]


class SeqView:
    """List-of-arrays façade over :class:`DeviceCorpus` rows.

    Behaves like ``[corpus.seqs[i] for i in idx]`` for host consumers
    (len/iteration/indexing), while device consumers (the resident fold,
    ``eval_logits``) read the resident tensor through ``.corpus``/``.idx``
    without any transfer.
    """

    def __init__(self, corpus: DeviceCorpus, idx: np.ndarray):
        self.corpus = corpus
        self.idx = idx

    def __len__(self) -> int:
        return len(self.idx)

    def __getitem__(self, i: int) -> np.ndarray:
        return self.corpus.seqs[self.idx[i]]

    def subset(self, idx: np.ndarray) -> "SeqView":
        return SeqView(self.corpus, self.idx[np.asarray(idx, np.int64)])

    def on(self, device: DeviceLike) -> "SeqView":
        """The same rows of the corpus's replica on ``device``
        (:meth:`DeviceCorpus.on`)."""
        return SeqView(self.corpus.on(device), self.idx)


# --- the device-resident fold ----------------------------------------------------


def _epoch_batch_plan(
    n: int, epochs: int, batch_size: int, seed: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Batch index plan mirroring ``batch_iterator``'s shuffles exactly:
    per epoch, a ``RandomState(seed + epoch)`` permutation chunked into
    full batches (E, S_full, B) plus a trailing remainder (E, r)."""
    s_full, r = divmod(n, batch_size)
    full = np.zeros((epochs, s_full, batch_size), np.int32)
    rem = np.zeros((epochs, r), np.int32)
    for e in range(epochs):
        order = np.arange(n)
        np.random.RandomState(seed + e).shuffle(order)
        if s_full:
            full[e] = order[: s_full * batch_size].reshape(s_full, batch_size)
        if r:
            rem[e] = order[s_full * batch_size:]
    return full, rem


def _pad_all(sequences, min_bucket: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a whole split to ONE global bucketed length (every batch
    gathered from it has that length)."""
    return pad_batch(list(sequences), min_bucket=min_bucket)


def _shared_corpus_views(train_sequences, val_sequences) -> bool:
    return (
        isinstance(train_sequences, SeqView)
        and isinstance(val_sequences, SeqView)
        and train_sequences.corpus is val_sequences.corpus
    )


@spanned("train.operands")
def _fold_operands(train_sequences, train_labels, val_sequences, val_labels,
                   cfg: TrainConfig, put: Callable[[np.ndarray, torch.dtype], torch.Tensor]):
    """The 10 tensor operands of a device-resident fold:
    (x_tr, len_tr, y_tr, full, rem, x_va, len_va, y_va, va_full, va_rem).

    ``put`` places a host array on the device (``Trainer._tensor``). Views
    of one resident corpus use its tensor as it is, with row indices into
    the whole corpus and the labels scattered onto those rows; anything
    else is padded once per split to ONE bucketed length and uploaded once.
    Indices and labels are int64, torch's index type.
    """
    full, rem = _epoch_batch_plan(len(train_sequences), cfg.epochs, cfg.batch_size, cfg.seed)
    sv_full = len(val_sequences) // cfg.batch_size
    if _shared_corpus_views(train_sequences, val_sequences):
        corpus = train_sequences.corpus
        tr_idx, va_idx = train_sequences.idx, val_sequences.idx
        x_tr = x_va = corpus.x
        len_tr = len_va = corpus.lengths
        full, rem = tr_idx[full], tr_idx[rem]
        # labels scattered onto global corpus rows (every gathered id is in
        # exactly one of the two views)
        y_global = np.zeros(len(corpus.seqs), np.int64)
        y_global[tr_idx] = np.asarray(train_labels, np.int64)
        y_global[va_idx] = np.asarray(val_labels, np.int64)
        y_tr = y_va = put(y_global, torch.int64)
        va_order = va_idx
    else:
        x_tr, len_tr = _pad_all(train_sequences, cfg.min_bucket)
        x_va, len_va = _pad_all(val_sequences, cfg.min_bucket)
        x_tr, x_va = put(x_tr, torch.float32), put(x_va, torch.float32)
        len_tr, len_va = put(len_tr, torch.int64), put(len_va, torch.int64)
        y_tr = put(np.asarray(train_labels, np.int64), torch.int64)
        y_va = put(np.asarray(val_labels, np.int64), torch.int64)
        va_order = np.arange(len(val_sequences), dtype=np.int64)
    va_full = va_order[: sv_full * cfg.batch_size].reshape(sv_full, cfg.batch_size)
    va_rem = va_order[sv_full * cfg.batch_size:]
    return (x_tr, len_tr, y_tr, put(full, torch.int64), put(rem, torch.int64),
            x_va, len_va, y_va, put(va_full, torch.int64), put(va_rem, torch.int64))


def _device_fold_fits(train_sequences, val_sequences, cfg: TrainConfig) -> bool:
    """auto-mode gate: padded train+val arrays must fit the budget."""
    if not len(train_sequences) or not len(val_sequences) or cfg.epochs <= 0:
        return False
    d = int(np.asarray(train_sequences[0]).shape[1])
    t_tr = bucket_length(max(len(s) for s in train_sequences), cfg.min_bucket)
    t_va = bucket_length(max(len(s) for s in val_sequences), cfg.min_bucket)
    n_bytes = 4 * d * (len(train_sequences) * t_tr + len(val_sequences) * t_va)
    return n_bytes <= cfg.device_fold_budget_bytes


def _gathered(x: torch.Tensor, lengths: torch.Tensor, y: torch.Tensor,
              index_batches: Iterable[torch.Tensor]) -> Iterator[Batch]:
    """Batches gathered on the device, at the resident tensor's full padded
    length; rows stored as bfloat16 are cast to float32 after the gather."""
    for idx in index_batches:
        if idx.numel():
            yield x[idx].to(torch.float32), lengths[idx], y[idx]


def _train_model_device(trainer: Trainer, train_sequences, train_labels, val_sequences,
                        val_labels, cfg: TrainConfig, state: TrainState,
                        generator: torch.Generator, verbose: bool = False):
    """One device-resident fold: the operands go to the device once, then
    the shared epoch loop runs over gathered batches."""
    (x_tr, len_tr, y_tr, full, rem, x_va, len_va, y_va, va_full, va_rem) = _fold_operands(
        train_sequences, train_labels, val_sequences, val_labels, cfg, trainer._tensor)
    return _run_epochs(
        trainer, state, generator, cfg,
        lambda epoch: _gathered(x_tr, len_tr, y_tr, (*full[epoch], rem[epoch])),
        lambda: _gathered(x_va, len_va, y_va, (*va_full, va_rem)),
        verbose,
    )


# --- the fold ------------------------------------------------------------------------


def _snapshot(state: TrainState) -> Dict[str, Any]:
    return {
        "model": {k: v.detach().clone() for k, v in state.model.state_dict().items()},
        "optimizer": copy.deepcopy(state.optimizer.state_dict()),
        "lr": state.lr,
    }


def _restore(state: TrainState, snap: Dict[str, Any]) -> None:
    state.model.load_state_dict(snap["model"])
    state.optimizer.load_state_dict(snap["optimizer"])
    state.lr = snap["lr"]


def _run_epochs(trainer: Trainer, state: TrainState, generator: torch.Generator,
                cfg: TrainConfig, train_batches: Callable[[int], Iterable[Batch]],
                val_batches: Callable[[], Iterable[Batch]],
                verbose: bool = False) -> Tuple[TrainState, List[float], List[float]]:
    """The epoch loop of both paths: ``train_batches(epoch)`` and
    ``val_batches()`` yield (batch, lengths, labels), as host arrays or as
    tensors on the device. One model call a step, so both paths draw the
    dropout generator in the same order."""
    scheduler = ReduceLROnPlateau(cfg.plateau_factor, cfg.plateau_patience)
    best_val = float("inf")
    best = _snapshot(state)
    epochs_no_improve = 0
    train_hist: List[float] = []
    val_hist: List[float] = []

    for epoch in range(cfg.epochs):
        with span("train.epoch"):
            epoch_losses = [
                trainer.train_step(state, batch, lengths, labs, generator,
                                   cfg.use_length_masking, cfg.dropout_rate, cfg.remat)
                for batch, lengths, labs in train_batches(epoch)
            ]
            with span("train.fetch"):  # one fetch per epoch, not per step
                train_hist.append(float(np.mean(torch.stack(epoch_losses).cpu().numpy())))

            with span("train.val"):
                val_loss = _val_loss(trainer, state, val_batches(), cfg)
            with span("train.books"):
                val_hist.append(val_loss)
                if cfg.use_plateau:
                    state.lr = scheduler.step(val_loss, state.lr)

                if val_loss < best_val:
                    best_val = val_loss
                    best = _snapshot(state)
                    epochs_no_improve = 0
                else:
                    epochs_no_improve += 1
            if verbose:
                print(f"epoch {epoch + 1}: train {train_hist[-1]:.4f} "
                      f"val {val_loss:.4f} lr {state.lr:.2e}")
            if epochs_no_improve >= cfg.patience:
                if verbose:
                    print(f"  > early stop at epoch {epoch + 1}")
                break

    if cfg.restore_best:
        _restore(state, best)
    return state, train_hist, val_hist


def train_model(
    trainer: Trainer,
    train_sequences: Sequence[np.ndarray],
    train_labels: Sequence[int],
    val_sequences: Sequence[np.ndarray],
    val_labels: Sequence[int],
    cfg: TrainConfig,
    verbose: bool = False,
    initial_weights: Optional[Mapping[str, torch.Tensor]] = None,
    defer_histories: bool = False,
):
    """Full training run with early stopping and best-weight restore.

    Returns (state, train_loss_history, val_loss_history): per-epoch mean
    train loss and val loss, plateau LR decay, a stop after ``patience``
    epochs without val improvement, and the best-val-loss weights restored
    (``restore_best``). Batches are shuffled by ``RandomState(seed + epoch)``
    as in the JAX package; dropout draws from a ``torch.Generator`` on the
    trainer's device seeded with ``cfg.seed``. ``initial_weights`` (a port
    state dict) replaces the seeded init, e.g. to start from a JAX model's
    weights.

    ``cfg.device_fold`` picks the path (see the module docstring): ``"on"``,
    or ``"auto"`` with train and val as views of one :class:`DeviceCorpus`
    or with padded arrays that fit ``cfg.device_fold_budget_bytes``, takes
    the device-resident fold; otherwise batches stream from the host.

    With ``defer_histories`` the return is ``(state, Deferred)`` whose result
    is ``(train_hist, val_hist)``, the JAX package's signature for the CV
    engines; the histories are already on the host here (one fetch an
    epoch), so the Deferred is ready.
    """
    state = trainer.init_state(cfg.seed, cfg.learning_rate, initial_weights)
    generator = torch.Generator(device=trainer.device).manual_seed(cfg.seed)
    if cfg.device_fold != "off" and (
        cfg.device_fold == "on"
        or _shared_corpus_views(train_sequences, val_sequences)
        or _device_fold_fits(train_sequences, val_sequences, cfg)
    ):
        state, train_hist, val_hist = _train_model_device(
            trainer, train_sequences, train_labels, val_sequences, val_labels, cfg,
            state, generator, verbose)
    else:
        state, train_hist, val_hist = _run_epochs(
            trainer, state, generator, cfg,
            lambda epoch: batch_iterator(
                train_sequences, train_labels, cfg.batch_size, shuffle=True,
                seed=cfg.seed + epoch, min_bucket=cfg.min_bucket),
            lambda: batch_iterator(
                val_sequences, val_labels, cfg.batch_size, shuffle=False,
                min_bucket=cfg.min_bucket),
            verbose,
        )
    if defer_histories:
        return state, Deferred.ready((train_hist, val_hist))
    return state, train_hist, val_hist


# --- lane-batched trials ----------------------------------------------------------------


def _val_losses_lanes(trainer: Trainer, state: LaneTrainState, batches: Iterable[Batch],
                      cfg: TrainConfig) -> torch.Tensor:
    """Each val batch's mean loss of each lane, (batches, K), on the device."""
    return torch.stack([
        _lane_cross_entropy(trainer.eval_step_lanes(state, batch, lengths, cfg.use_length_masking),
                            trainer._tensor(labs, torch.int64))
        for batch, lengths, labs in batches
    ])


def _run_epochs_lanes(trainer: Trainer, state: LaneTrainState, generator: torch.Generator,
                      cfg: TrainConfig, rates: torch.Tensor, lrs: List[float],
                      train_batches: Callable[[int], Iterable[Batch]],
                      val_batches: Callable[[], Iterable[Batch]]
                      ) -> List[Tuple[List[float], List[float]]]:
    """:func:`_run_epochs` for K lanes, each keeping its own books: plateau
    decay of its rate (``lrs`` is the host's copy of ``state.lr``), best val
    loss and snapshot, and patience. A lane whose patience runs out is
    frozen there: the epochs go on while any lane is active, every lane is
    computed (as in a batched ``while_loop``), and at the end the lane gets
    back the state it stopped in, or its best with ``restore_best``. One
    fetch an epoch (every lane's losses). Returns each lane's (train_hist,
    val_hist), as long as that lane ran."""
    k = len(lrs)
    schedulers = [ReduceLROnPlateau(cfg.plateau_factor, cfg.plateau_patience) for _ in range(k)]
    best_val = [float("inf")] * k
    no_improve = [0] * k
    active = [True] * k
    hists: List[Tuple[List[float], List[float]]] = [([], []) for _ in range(k)]
    best = state.snapshot() if cfg.restore_best else None
    stopped: Optional[Dict[str, Any]] = None  # lanes frozen without restore_best

    for epoch in range(cfg.epochs):
        with span("train.epoch"):
            steps = [
                trainer.train_step_lanes(state, batch, lengths, labs, generator,
                                         cfg.use_length_masking, rates, cfg.remat)
                for batch, lengths, labs in train_batches(epoch)
            ]
            with span("train.val"):
                val = _val_losses_lanes(trainer, state, val_batches(), cfg)
            with span("train.fetch"):
                host = torch.cat([torch.stack(steps), val]).cpu().numpy()  # one fetch
            with span("train.books"):
                train_losses, val_losses = host[: len(steps)], host[len(steps):]
                new_lrs, improved, done = list(lrs), [], []
                for i in (i for i in range(k) if active[i]):
                    # a lane's column alone, so the mean adds as the sequential fold's does
                    hists[i][0].append(float(np.mean(np.ascontiguousarray(train_losses[:, i]))))
                    val_loss = float(np.mean(np.ascontiguousarray(val_losses[:, i])))
                    hists[i][1].append(val_loss)
                    if cfg.use_plateau:
                        new_lrs[i] = schedulers[i].step(val_loss, lrs[i])
                    if val_loss < best_val[i]:
                        best_val[i] = val_loss
                        no_improve[i] = 0
                        improved.append(i)
                    else:
                        no_improve[i] += 1
                    if no_improve[i] >= cfg.patience:
                        active[i] = False
                        done.append(i)
                if new_lrs != lrs:
                    lrs[:] = new_lrs
                    state.lr.copy_(torch.tensor(lrs, dtype=torch.float64))
                if best is not None and improved:
                    state.copy_lanes(best, state.live(), improved)
                if done and best is None:
                    if stopped is None:
                        stopped = state.snapshot()
                    else:
                        state.copy_lanes(stopped, state.live(), done)
            if not any(active):
                break

    with span("train.books"):
        if best is not None:
            state.copy_lanes(state.live(), best, range(k))
        elif stopped is not None:
            state.copy_lanes(state.live(), stopped, [i for i in range(k) if not active[i]])
    return hists


@spanned("train.trials")
def train_trials_device(
    trainer: Trainer,
    train_sequences: Sequence[np.ndarray],
    train_labels: Sequence[int],
    val_sequences: Sequence[np.ndarray],
    val_labels: Sequence[int],
    cfg: TrainConfig,
    learning_rates: Sequence[float],
    dropout_rates: Sequence[float],
    mesh: Optional[DeviceGrid] = None,
    lane_axis: str = "dp",
) -> Tuple[Any, Deferred]:
    """Train K trials of ONE architecture together, one lane each.

    The trials differ only in learning rate and dropout rate. Every lane
    starts from ``trainer.init_state(cfg.seed, cfg.learning_rate)``, draws
    its dropout masks from the one generator seeded with ``cfg.seed`` (each
    lane thresholds the same uniforms at its own rate), and takes the same
    batch plan, on the device-resident path (:func:`_fold_operands`: a
    resident corpus's views, or one upload of the padded splits). So lane i
    reproduces :func:`train_model` of trial i. Every train step runs the K
    models as one (:class:`CNNLSTMLanes`): K3, K4 and dWh at G = 2K.

    With ``mesh`` and K divisible by its ``lane_axis`` size G, the lanes
    split into G contiguous groups, one a device along that axis (the row
    leads for ``"dp"``): each group is its own :class:`CNNLSTMLanes` and
    :class:`LaneAdam` on its device, driven from its own host thread, with
    its own generator seeded and stepped as the single-device one (a
    lane's draws do not depend on the lane count), over the corpus's
    replica on that device. When K does not divide, the lanes are
    replicated, as the JAX package's sharding replicates them: the one
    process computes them once, on the grid's lead device.

    Returns ``(states, histories)``: a :class:`LaneTrainState` (a
    :class:`LaneGroups` when split) and a :class:`Deferred` of each lane's
    (train_hist, val_hist) in lane order, already on the host. Compose with
    :meth:`Trainer.eval_logits_trials_deferred`.
    """
    if len(learning_rates) != len(dropout_rates):
        raise ValueError("learning_rates and dropout_rates must align")
    if cfg.dropout_rate is None:
        raise ValueError("train_trials_device requires cfg.dropout_rate set")
    if mesh is not None:
        k = len(learning_rates)
        devices = _lane_devices(mesh, lane_axis)
        if k % len(devices):
            devices = [mesh.lead]
        per = k // len(devices)
        groups = [list(range(g * per, (g + 1) * per)) for g in range(len(devices))]

        def run(g: int):
            t = trainer if trainer.device == devices[g] else Trainer(
                trainer.model, trainer.adam_eps, device=devices[g])
            return (t, *_train_lanes(t, _on(train_sequences, t.device), train_labels,
                                     _on(val_sequences, t.device), val_labels, cfg,
                                     [learning_rates[i] for i in groups[g]],
                                     [dropout_rates[i] for i in groups[g]]))

        parts = in_threads(run, len(groups))
        states = LaneGroups([(t, st, idx) for (t, st, _), idx in zip(parts, groups)])
        return states, Deferred.ready([h for _, _, hists in parts for h in hists])
    state, hists = _train_lanes(trainer, train_sequences, train_labels, val_sequences,
                                val_labels, cfg, learning_rates, dropout_rates)
    return state, Deferred.ready(hists)


def _train_lanes(trainer: Trainer, train_sequences, train_labels, val_sequences, val_labels,
                 cfg: TrainConfig, learning_rates: Sequence[float],
                 dropout_rates: Sequence[float]
                 ) -> Tuple[LaneTrainState, List[Tuple[List[float], List[float]]]]:
    """The lanes of :func:`train_trials_device` on ``trainer``'s device."""
    lrs = [float(v) for v in learning_rates]
    with span("train.init"):
        state = LaneTrainState.replicate(trainer.init_state(cfg.seed, cfg.learning_rate),
                                         trainer._tensor(np.asarray(lrs), torch.float64))
        rates = trainer._tensor(np.asarray(dropout_rates, np.float64), torch.float64)
        generator = torch.Generator(device=trainer.device).manual_seed(cfg.seed)
    (x_tr, len_tr, y_tr, full, rem, x_va, len_va, y_va, va_full, va_rem) = _fold_operands(
        train_sequences, train_labels, val_sequences, val_labels, cfg, trainer._tensor)
    hists = _run_epochs_lanes(
        trainer, state, generator, cfg, rates, lrs,
        lambda epoch: _gathered(x_tr, len_tr, y_tr, (*full[epoch], rem[epoch])),
        lambda: _gathered(x_va, len_va, y_va, (*va_full, va_rem)),
    )
    return state, hists


def _lane_devices(mesh: DeviceGrid, lane_axis: str) -> List[torch.device]:
    """The devices along ``lane_axis`` of ``mesh``: each dp row's lead, or
    the mp devices of row 0."""
    if lane_axis == "dp":
        return mesh.row_leads()
    if lane_axis == "mp":
        return list(mesh.rows[0])
    raise ValueError(f"lane_axis must be 'dp' or 'mp', not {lane_axis!r}")


def _on(sequences, device: torch.device):
    """A resident corpus's view on ``device`` (its replica there); host
    sequences as they are."""
    return sequences.on(device) if isinstance(sequences, SeqView) else sequences


class LaneGroups:
    """The lanes of :func:`train_trials_device` split over devices:
    ``parts`` is one (trainer, :class:`LaneTrainState`, lane indices) a
    group, each on its trainer's device. ``lanes`` counts every lane;
    :meth:`lane_state` finds lane i in its group."""

    def __init__(self, parts: Sequence[Tuple[Trainer, LaneTrainState, List[int]]]):
        self.parts = list(parts)

    @property
    def lanes(self) -> int:
        return sum(len(idx) for _, _, idx in self.parts)

    def lane_state(self, i: int) -> TrainState:
        for _, state, idx in self.parts:
            if i in idx:
                return state.lane_state(idx.index(i))
        raise IndexError(f"lane {i} of {self.lanes}")


def evaluate_model_deferred(
    trainer: Trainer,
    state: TrainState,
    sequences: Sequence[np.ndarray],
    labels: Sequence[int],
    cfg: TrainConfig,
) -> Deferred:
    """Deferred :func:`evaluate_model`: runs the eval pass and returns a
    Deferred whose result is (y_true, y_pred, p_class1); the softmax is
    taken on the host when the result is collected."""
    d = trainer.eval_logits_deferred(state, sequences, cfg)
    y_true = np.asarray(labels)

    def finalize(host):
        logits = d.finalize(host)
        z = np.exp(logits - logits.max(axis=-1, keepdims=True))
        probs = (z / z.sum(axis=-1, keepdims=True))[:, 1]
        return y_true, np.argmax(logits, axis=-1), probs.astype(np.float32)

    return Deferred(d.arrays, finalize)


def evaluate_model(
    trainer: Trainer,
    state: TrainState,
    sequences: Sequence[np.ndarray],
    labels: Sequence[int],
    cfg: TrainConfig,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(y_true, y_pred, p_class1), the contract of the reference's
    ``_eval_model``."""
    return evaluate_model_deferred(trainer, state, sequences, labels, cfg).result()


# --- the sharded train step ---------------------------------------------------------


class _StatsExchange:
    """Whole-batch BatchNorm statistics for the shards of one batch, each
    computed by its own host thread: at a BatchNorm, a shard posts its
    per-channel sums and waits for every other shard's, then adds them all,
    in shard order, on its own device (an all-reduce through autograd, so
    the gradient reaches every shard)."""

    def __init__(self, n: int):
        self.n = n
        # a shard that died aborts the barrier; the timeout only bounds a hang
        self.barrier = threading.Barrier(n, timeout=600.0)
        self.lock = threading.Lock()
        self.posted: Dict[str, List[Any]] = {}

    def sync_for(self, site: str, shard: int) -> Callable[[torch.Tensor], tuple]:
        def sync(x: torch.Tensor):
            with self.lock:
                self.posted.setdefault(site, [None] * self.n)[shard] = (
                    x.sum(dim=(0, 2)), (x * x).sum(dim=(0, 2)), x.shape[0] * x.shape[2])
            self.barrier.wait()
            parts = self.posted[site]
            count = sum(p[2] for p in parts)
            s1 = s2 = None
            for p1, p2, _ in parts:
                s1 = p1.to(x.device) if s1 is None else s1 + p1.to(x.device)
                s2 = p2.to(x.device) if s2 is None else s2 + p2.to(x.device)
            mean = s1 / count
            return mean, torch.clamp(s2 / count - mean * mean, min=0.0)

        return sync


@dataclasses.dataclass
class ShardedTrainState:
    """A CNN-LSTM's training state laid over a (dp, mp) grid.

    Every dp row holds the whole model: each parameter that a rule of
    ``parallel.sharding`` matches lives as its mp slices on the row's
    devices (``slices[name][r][c]``), with its two Adam moments beside it
    (``optimizers[r][c]``, a ``torch.optim.Adam`` over the leaves at (r, c));
    every other parameter is a copy at each position. ``models[r][c]`` is
    the module that position runs (its parameters are the gathered slices,
    its buffers the BatchNorm statistics, replicated). ``spec`` maps each
    parameter to its split dim (None: replicated)."""

    grid: DeviceGrid
    spec: Dict[str, Optional[int]]
    slices: Dict[str, List[List[torch.Tensor]]]
    models: List[List[CNNLSTM]]
    optimizers: List[List[torch.optim.Adam]]
    lr: float

    @classmethod
    def shard(cls, state: TrainState, grid: DeviceGrid) -> "ShardedTrainState":
        """``state`` (model, Adam moments and rate) laid over ``grid`` by
        the default rule table."""
        from ..parallel.sharding import param_slice, place_params, shard_params

        named = dict(state.model.named_parameters())
        params = {n: p.detach() for n, p in named.items()}
        spec = shard_params(params, grid)
        slices = place_params(params, grid)
        models, optimizers = [], []
        eps = state.optimizer.defaults["eps"]
        moments = {n: state.optimizer.state.get(p) for n, p in named.items()}
        for r, row in enumerate(grid.rows):
            models.append([])
            optimizers.append([])
            for c, dev in enumerate(row):
                model = copy.deepcopy(state.model).to(dev)
                for p in model.parameters():  # the forward takes the gathered slices
                    p.data = torch.empty(0, device=dev)
                leaves = []
                for n, p in named.items():
                    leaf = slices[n][r][c]
                    if p.requires_grad:
                        leaf.requires_grad_(True)
                        leaves.append((n, leaf))
                opt = torch.optim.Adam([leaf for _, leaf in leaves], lr=state.lr, eps=eps)
                for n, leaf in leaves:
                    m = moments[n]
                    if m:
                        opt.state[leaf] = {
                            "step": m["step"].clone(),
                            "exp_avg": param_slice(m["exp_avg"], spec[n], c, grid.mp)
                            .to(dev, copy=True).contiguous(),
                            "exp_avg_sq": param_slice(m["exp_avg_sq"], spec[n], c, grid.mp)
                            .to(dev, copy=True).contiguous(),
                        }
                models[-1].append(model)
                optimizers[-1].append(opt)
        return cls(grid, spec, slices, models, optimizers, state.lr)

    def _gathered(self, r: int, c: int, device: torch.device) -> Dict[str, torch.Tensor]:
        from ..parallel.sharding import gather

        return {n: (s[r][c] if self.spec[n] is None else gather(s[r], self.spec[n], device))
                for n, s in self.slices.items()}

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The whole model as a ``CNNLSTM`` state dict on the grid's lead
        device: row 0's slices gathered, position (0, 0)'s BatchNorm
        statistics."""
        dev = self.grid.lead
        with torch.no_grad():
            params = {n: t.detach().clone() for n, t in self._gathered(0, 0, dev).items()}
        buffers = {n: b.detach().to(dev, copy=True) for n, b in self.models[0][0].named_buffers()}
        return {**params, **buffers}

    def moments(self) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """{trainable parameter: (exp_avg, exp_avg_sq)}, whole, from row 0,
        on the grid's lead device."""
        from ..parallel.sharding import gather

        dev = self.grid.lead
        out = {}
        for n, s in self.slices.items():
            row = s[0]
            states = [self.optimizers[0][c].state.get(row[c]) for c in range(self.grid.mp)]
            if not row[0].requires_grad or not states[0]:
                continue
            out[n] = tuple(
                (states[0][k].to(dev, copy=True) if self.spec[n] is None
                 else gather([st[k] for st in states], self.spec[n], dev))
                for k in ("exp_avg", "exp_avg_sq"))
        return out


def sharded_train_step(state: ShardedTrainState, batch, lengths, labels,
                       generator: torch.Generator, masked: bool = True,
                       dropout_rate: Optional[float] = None) -> torch.Tensor:
    """One Adam step of a :class:`ShardedTrainState` on a padded batch (host
    arrays or tensors); the mean cross-entropy over the whole batch, on the
    grid's lead device.

    The batch splits over dp (``parallel.sharding.batch_sharding``), and a
    row's share over its mp devices, one shard a device. Each shard runs in
    its own host thread with its row's parameters gathered whole on its
    device (K3 and, in the backward, K4 take a direction's whole Wh, as the
    JAX program's kernel does after GSPMD gathers its operand). BatchNorm
    normalises by the whole batch's statistics and moves every replica's
    running statistics by them (``BatchNorm.stats_sync``); dropout draws
    each site at the whole batch's shape on ``generator`` and slices it
    (``models.cnn_lstm.SplitDraws``), so the masks are the single-device
    step's. One backward over the shards' summed losses sends each slice
    its row's gradient; the rows' gradients are summed onto every replica
    of a slice, and each position's Adam steps its slices."""
    from types import SimpleNamespace

    from ..models.cnn_lstm import SplitDraws

    grid = state.grid
    x = torch.as_tensor(batch, dtype=torch.float32)
    lens = torch.as_tensor(lengths, dtype=torch.int64) if masked else None
    y = torch.as_tensor(labels, dtype=torch.int64)
    total = x.shape[0]
    shards = _shards(grid, total)
    exchange = _StatsExchange(len(shards))
    draws = SimpleNamespace(generator=generator, lock=threading.Lock(), draws=[])

    def forward(i: int) -> torch.Tensor:
        r, c, rows = shards[i]
        dev = grid.rows[r][c]
        model = state.models[r][c].train()
        for name, m in model.named_modules():
            if isinstance(m, BatchNorm):
                m.stats_sync = exchange.sync_for(name, i)
        try:
            logits = torch.func.functional_call(model, state._gathered(r, c, dev), (
                x[rows].to(dev), None if lens is None else lens[rows].to(dev), dropout_rate,
                SplitDraws(draws, rows.start, total)))
        except BaseException:
            exchange.barrier.abort()  # release the shards waiting at a BatchNorm
            raise
        finally:
            for m in model.modules():
                if isinstance(m, BatchNorm):
                    m.stats_sync = None
        return F.cross_entropy(logits, y[rows].to(dev), reduction="sum")

    with fp32_convs():
        losses = in_threads(forward, len(shards))
        loss = losses[0].to(grid.lead)
        for part in losses[1:]:
            loss = loss + part.to(grid.lead)
        loss = loss / total
        for row in state.optimizers:
            for opt in row:
                opt.zero_grad(set_to_none=True)
        loss.backward()
    _reduce_gradients(state)
    with torch.no_grad():  # a position that computed no shard takes the statistics
        src = dict(state.models[shards[0][0]][shards[0][1]].named_buffers())
        busy = {(r, c) for r, c, _ in shards}
        for r, row in enumerate(state.models):
            for c, model in enumerate(row):
                if (r, c) not in busy:
                    for n, b in model.named_buffers():
                        b.copy_(src[n])
    for row in state.optimizers:
        for opt in row:
            for group in opt.param_groups:
                group["lr"] = state.lr
            opt.step()
    return loss.detach()


def _shards(grid: DeviceGrid, total: int) -> List[Tuple[int, int, slice]]:
    """(r, c, rows) of each device that computes part of a batch of
    ``total``: the dp split (``batch_sharding``), then each row's share in
    contiguous parts over its mp devices (a device given no row is left
    out)."""
    from ..parallel.sharding import batch_sharding

    shards = []
    for r, rows in enumerate(batch_sharding(grid, total)):
        for c, part in enumerate(np.array_split(np.arange(rows.start, rows.stop), grid.mp)):
            if len(part):
                shards.append((r, c, slice(int(part[0]), int(part[-1]) + 1)))
    return shards


def sharded_eval_step(state: ShardedTrainState, batch,
                      lengths=None) -> torch.Tensor:
    """Logits (B, num_classes) of a padded batch in eval mode, no gradient,
    split over the grid as :func:`sharded_train_step` splits it (K1 on each
    shard), gathered on the grid's lead device."""
    grid = state.grid
    x = torch.as_tensor(batch, dtype=torch.float32)
    lens = None if lengths is None else torch.as_tensor(lengths, dtype=torch.int64)
    shards = _shards(grid, x.shape[0])

    def forward(i: int) -> torch.Tensor:
        r, c, rows = shards[i]
        dev = grid.rows[r][c]
        with torch.no_grad():
            return torch.func.functional_call(
                state.models[r][c].eval(), state._gathered(r, c, dev),
                (x[rows].to(dev), None if lens is None else lens[rows].to(dev)))

    return torch.cat([out.to(grid.lead) for out in in_threads(forward, len(shards))])


def _reduce_gradients(state: ShardedTrainState) -> None:
    """Each trainable slice's gradient summed over the dp rows (a split
    parameter: slice c of every row; a replicated one: every position), in
    grid order on the lead device, and set on every replica."""
    grid = state.grid
    for name, s in state.slices.items():
        if not s[0][0].requires_grad:
            continue
        if state.spec[name] is None:
            columns = [[leaf for row in s for leaf in row]]
        else:
            columns = [[row[c] for row in s] for c in range(grid.mp)]
        for leaves in columns:
            total = None
            for leaf in leaves:
                if leaf.grad is not None:
                    g = leaf.grad.to(grid.lead)
                    total = g if total is None else total + g
            if total is None:
                total = torch.zeros_like(leaves[0], device=grid.lead)
            for leaf in leaves:
                leaf.grad = total.to(leaf.device, copy=True)
