"""Model and result checkpoints in the JAX package's pickle schemas.

Counterpart of ``robust_speech_analysis_framework_tpu/train/checkpoints.py``
(the Orbax TrainState checkpoints are not ported):

* model files: a pickled dict ``{'hyperparameters', 'model_state_dict',
  'train_loss_history', 'val_loss_history'}`` whose ``model_state_dict`` is
  the JAX package's flat dict of float32 numpy arrays (``params/...``,
  ``batch_stats/...``; :func:`..models.weights.cnn_lstm_flat_from_state_dict`).
  A model trained in the port loads into the JAX package, and
  ``serving.Predictor.from_checkpoint`` loads a JAX-trained one;
* result files: ``{'results_df', 'predictions'[, 'weights', 'histories']}``.

The files are pickles: load only files you trust.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from ..models.weights import cnn_lstm_flat_from_state_dict


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
