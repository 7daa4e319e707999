"""Model and result checkpoints in the JAX package's pickle schemas.

Counterpart of ``robust_speech_analysis_framework_tpu/train/checkpoints.py``:

* model files: a pickled dict ``{'hyperparameters', 'model_state_dict',
  'train_loss_history', 'val_loss_history'}`` whose ``model_state_dict`` is
  the JAX package's flat dict of float32 numpy arrays (``params/...``,
  ``batch_stats/...``; :func:`..models.weights.cnn_lstm_flat_from_state_dict`).
  A model trained in the port loads into the JAX package, and
  ``serving.Predictor.from_checkpoint`` loads a JAX-trained one;
* result files: ``{'results_df', 'predictions'[, 'weights', 'histories']}``;
* whole train states (:func:`save_train_state`, :func:`restore_train_state`):
  the model's parameters and BatchNorm statistics, the Adam state and the
  rate, so a resumed run takes the step an uninterrupted one would. The JAX
  package writes them with Orbax; here they are one ``torch.save`` file,
  read back with ``weights_only=True``.

The model and result files are pickles: load only files you trust.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from ..models.weights import cnn_lstm_flat_from_state_dict
from .loops import TrainState


def save_model_checkpoint(
    path: str,
    hyperparameters: Dict[str, Any],
    model: Union[torch.nn.Module, Mapping[str, torch.Tensor]],
    train_loss_history,
    val_loss_history,
) -> None:
    """Reference-schema model artifact from a port ``CNNLSTM`` (or its state dict)."""
    state_dict = model.state_dict() if isinstance(model, torch.nn.Module) else model
    payload = {
        "hyperparameters": dict(hyperparameters),
        "model_state_dict": cnn_lstm_flat_from_state_dict(state_dict),
        "train_loss_history": list(train_loss_history),
        "val_loss_history": list(val_loss_history),
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as fh:
        pickle.dump(payload, fh)


def load_model_checkpoint(path: str) -> Dict[str, Any]:
    with open(path, "rb") as fh:
        return pickle.load(fh)


def save_results_pickle(path: str, results_df, predictions, weights=None,
                        histories=None) -> None:
    """Reference-schema experiment results artifact."""
    payload: Dict[str, Any] = {
        "results_df": results_df,
        "predictions": predictions,
    }
    if weights is not None:
        payload["weights"] = np.asarray(weights)
    if histories is not None:
        payload["histories"] = histories
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as fh:
        pickle.dump(payload, fh)


def load_results_pickle(path: str) -> Dict[str, Any]:
    with open(path, "rb") as fh:
        return pickle.load(fh)


def _state_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"state_{int(step)}.pt")


def save_train_state(directory: str, state: TrainState, step: int = 0) -> None:
    """Write ``state`` (model state dict, optimizer state dict, rate) to
    ``<directory>/state_<step>.pt``, through a temporary file renamed into
    place, so a reader never sees half a checkpoint."""
    path = _state_path(directory, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
               "lr": float(state.lr)}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _check_entries(kind: str, expected: Mapping[str, Any], got: Mapping[str, Any]) -> None:
    """Raise naming the first key of ``expected`` that ``got`` lacks or holds
    at another shape."""
    for key, want in expected.items():
        if key not in got:
            raise KeyError(f"checkpoint {kind} lacks '{key}'")
        have = got[key]
        if isinstance(want, torch.Tensor) and (not isinstance(have, torch.Tensor)
                                               or have.shape != want.shape):
            shape = tuple(have.shape) if isinstance(have, torch.Tensor) else type(have).__name__
            raise ValueError(f"checkpoint {kind} '{key}' has shape {shape}, the template "
                             f"{tuple(want.shape)}")
    extra = sorted(set(got) - set(expected))
    if extra:
        raise KeyError(f"checkpoint {kind} has '{extra[0]}', which the template lacks")


def restore_train_state(directory: str, template: TrainState, step: int = 0) -> TrainState:
    """Load ``<directory>/state_<step>.pt`` into ``template`` (a TrainState
    of the same architecture, e.g. a fresh ``Trainer.init_state``) on its
    device and return it. A missing, extra or mis-shaped entry raises and
    names its key."""
    device = next(template.model.parameters()).device
    payload = torch.load(_state_path(directory, step), map_location=device, weights_only=True)
    _check_entries("model", template.model.state_dict(), payload["model"])
    params = [p for group in template.optimizer.param_groups for p in group["params"]]
    saved = payload["optimizer"]
    n_saved = sum(len(group["params"]) for group in saved["param_groups"])
    if n_saved != len(params):
        raise ValueError(f"checkpoint optimizer holds {n_saved} parameters, the template "
                         f"{len(params)}")
    for i, p in enumerate(params):
        moments = saved["state"].get(i, {})
        for key in ("exp_avg", "exp_avg_sq"):
            if key in moments and moments[key].shape != p.shape:
                raise ValueError(f"checkpoint optimizer state {i} '{key}' has shape "
                                 f"{tuple(moments[key].shape)}, its parameter {tuple(p.shape)}")
        # a step count lies where a fresh Adam keeps it: on the host unless
        # the optimizer is capturable or fused
        if "step" in moments and not (template.optimizer.defaults.get("capturable")
                                      or template.optimizer.defaults.get("fused")):
            moments["step"] = moments["step"].cpu()
    template.model.load_state_dict(payload["model"])
    template.optimizer.load_state_dict(saved)
    template.lr = float(payload["lr"])
    return template
