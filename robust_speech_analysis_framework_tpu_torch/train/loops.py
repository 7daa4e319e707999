"""Training and evaluation of the CNN-LSTM (PyTorch): the streaming fold trainer.

Counterpart of ``robust_speech_analysis_framework_tpu/train/loops.py``'s
streaming path, the fold trainer the CV engines call: epochs of Adam and
cross-entropy over shuffled bucket-padded batches, a validation loss per
epoch, ``ReduceLROnPlateau(factor=0.1, patience=5)``, early stopping with
best-weight restore, and an eval pass returning (labels, predictions,
P(class 1)). On the card every train step runs the biLSTM through K5 (the
K3 forward and the K4 reverse sweep, one launch each per layer) and every
eval batch through K1.

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
* The device-resident fold (``device_fold``: the JAX package's
  ``DeviceCorpus``/``ResidentCorpus``/``SeqView`` and whole-fold program)
  is not ported yet (ROADMAP queue 1 item 4): ``"auto"`` and ``"off"`` take
  the streaming path, ``"on"`` raises ``NotImplementedError``.
* ``parallel_warmup`` has nothing to warm up: PyTorch compiles nothing per
  batch shape, and the CUDA kernels are built once, at first use.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data.batching import batch_iterator, length_sorted_batches, pad_batch
from ..device import DeviceLike, resolve_device
from ..models.cnn_lstm import CNNLSTM, BatchNorm
from ..models.init import init_training_weights_


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
    # kept for the JAX package's signature: nothing to warm up here
    parallel_warmup: bool = True
    # "auto" and "off": the streaming path; "on": not ported yet (raises)
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

    def _tensor(self, a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    # --- steps -------------------------------------------------------------

    def train_step(self, state: TrainState, batch: np.ndarray, lengths: np.ndarray,
                   labels: np.ndarray, generator: Optional[torch.Generator],
                   masked: bool = True, dropout_rate: Optional[float] = None,
                   remat: bool = False) -> torch.Tensor:
        """One Adam step on a padded batch; returns the mean cross-entropy
        (a device scalar, not synchronised)."""
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
        loss.backward()
        for group in state.optimizer.param_groups:
            group["lr"] = state.lr
        state.optimizer.step()
        return loss.detach()

    def eval_step(self, state: TrainState, batch: np.ndarray, lengths: np.ndarray,
                  masked: bool = True) -> torch.Tensor:
        """Logits (B, num_classes) of a padded batch in eval mode, no gradient."""
        model = state.model.eval()
        with torch.no_grad():
            x = self._tensor(batch, torch.float32)
            lens = self._tensor(lengths, torch.int64) if masked else None
            return model(x, lens)

    # --- epoch-level API ---------------------------------------------------

    def eval_logits(self, state: TrainState, sequences: Sequence[np.ndarray],
                    cfg: TrainConfig) -> np.ndarray:
        """(N, num_classes) logits over length-sorted batches; one copy to
        the host at the end."""
        pending = []
        for idx in length_sorted_batches(sequences, cfg.batch_size):
            batch, lengths = pad_batch([sequences[i] for i in idx], min_bucket=cfg.min_bucket)
            pending.append((idx, self.eval_step(state, batch, lengths, cfg.use_length_masking)))
        out = np.zeros((len(sequences), self.model.num_classes), np.float32)
        for idx, logits in pending:
            out[idx] = logits.cpu().numpy()
        return out


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


def _mean_val_loss(trainer: Trainer, state: TrainState, sequences, labels,
                   cfg: TrainConfig) -> float:
    """Batch-averaged validation loss (mean of per-batch means, as the
    reference's ``val_loss / len(val_loader)``); one fetch per pass."""
    losses = []
    for batch, lengths, labs in batch_iterator(
        sequences, labels, cfg.batch_size, shuffle=False, min_bucket=cfg.min_bucket
    ):
        logits = trainer.eval_step(state, batch, lengths, cfg.use_length_masking)
        losses.append(F.cross_entropy(logits, trainer._tensor(labs, torch.int64)))
    return float(np.mean(torch.stack(losses).cpu().numpy()))


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


def train_model(
    trainer: Trainer,
    train_sequences: Sequence[np.ndarray],
    train_labels: Sequence[int],
    val_sequences: Sequence[np.ndarray],
    val_labels: Sequence[int],
    cfg: TrainConfig,
    verbose: bool = False,
    initial_weights: Optional[Mapping[str, torch.Tensor]] = None,
) -> Tuple[TrainState, List[float], List[float]]:
    """Full training run with early stopping and best-weight restore.

    Returns (state, train_loss_history, val_loss_history): per-epoch mean
    train loss and val loss, plateau LR decay, a stop after ``patience``
    epochs without val improvement, and the best-val-loss weights restored
    (``restore_best``). Batches are shuffled by ``RandomState(seed + epoch)``
    as in the JAX package; dropout draws from a ``torch.Generator`` on the
    trainer's device seeded with ``cfg.seed``. ``initial_weights`` (a port
    state dict) replaces the seeded init, e.g. to start from a JAX model's
    weights.
    """
    if cfg.device_fold == "on":
        raise NotImplementedError(
            "device_fold='on': the device-resident fold is not ported yet "
            "(ROADMAP queue 1 item 4); use 'auto' or 'off' for the streaming path"
        )
    state = trainer.init_state(cfg.seed, cfg.learning_rate, initial_weights)
    generator = torch.Generator(device=trainer.device).manual_seed(cfg.seed)
    scheduler = ReduceLROnPlateau(cfg.plateau_factor, cfg.plateau_patience)
    best_val = float("inf")
    best = _snapshot(state)
    epochs_no_improve = 0
    train_hist: List[float] = []
    val_hist: List[float] = []

    for epoch in range(cfg.epochs):
        epoch_losses = [
            trainer.train_step(state, batch, lengths, labs, generator,
                               cfg.use_length_masking, cfg.dropout_rate, cfg.remat)
            for batch, lengths, labs in batch_iterator(
                train_sequences, train_labels, cfg.batch_size, shuffle=True,
                seed=cfg.seed + epoch, min_bucket=cfg.min_bucket,
            )
        ]
        # one fetch per epoch, not per step
        train_hist.append(float(np.mean(torch.stack(epoch_losses).cpu().numpy())))

        val_loss = _mean_val_loss(trainer, state, val_sequences, val_labels, cfg)
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


def evaluate_model(
    trainer: Trainer,
    state: TrainState,
    sequences: Sequence[np.ndarray],
    labels: Sequence[int],
    cfg: TrainConfig,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(y_true, y_pred, p_class1), the contract of the reference's
    ``_eval_model``."""
    logits = trainer.eval_logits(state, sequences, cfg)
    probs = torch.softmax(torch.from_numpy(logits), dim=-1)[:, 1].numpy()
    preds = np.argmax(logits, axis=-1)
    return np.asarray(labels), np.asarray(preds), np.asarray(probs)
