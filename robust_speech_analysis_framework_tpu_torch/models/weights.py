"""Carry weights from the JAX package's flat parameter dicts to the port.

The JAX package saves its models as flat dicts of numpy arrays keyed by the
Flax tree path (``'params/res_block1/conv1/kernel'``,
``'batch_stats/res_block1/bn1/mean'``; ``train/checkpoints.flatten_params``).
These functions turn such a dict into a state dict for the port's modules
(and :func:`cnn_lstm_flat_from_state_dict` turns a port CNN-LSTM back):

* conv kernels ``(k, in, out)`` → ``(out, in, k)``;
* dense kernels ``(in, out)`` → ``(out, in)``;
* norm ``scale``/``bias`` → ``weight``/``bias``; BatchNorm ``mean``/``var``
  → ``running_mean``/``running_var``;
* LSTM ``wx``/``wh`` ``(in, 4H)`` → ``weight_ih``/``weight_hh`` ``(4H, in)``;
  the JAX ``bias`` is ``bias_ih + bias_hh``, so it goes to ``bias_ih`` and
  ``bias_hh`` is zero.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _tensor(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _kernel(k: np.ndarray) -> np.ndarray:
    k = np.asarray(k)
    return k.transpose(2, 1, 0) if k.ndim == 3 else k.T


def cnn_lstm_state_dict_from_flat(flat: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``CNNLSTM`` flat variables → port ``CNNLSTM`` state dict."""
    sd: Dict[str, torch.Tensor] = {}
    bn_names = {"bn1": "bn1", "bn2": "bn2", "shortcut_bn": "shortcut.1"}
    conv_names = {"conv1": "conv1", "conv2": "conv2", "shortcut_conv": "shortcut.0"}
    for key, value in flat.items():
        collection, *path = key.split("/")
        if collection == "batch_stats":
            block, bn, stat = path
            name = {"mean": "running_mean", "var": "running_var"}[stat]
            sd[f"{block}.{bn_names[bn]}.{name}"] = _tensor(value)
            continue
        if collection != "params":
            raise KeyError(f"unexpected collection in {key!r}")
        head = path[0]
        if head.startswith("res_block"):
            block, layer, leaf = path
            if layer in conv_names:
                name = "weight" if leaf == "kernel" else "bias"
                arr = _kernel(value) if leaf == "kernel" else value
                sd[f"{block}.{conv_names[layer]}.{name}"] = _tensor(arr)
            else:
                name = "weight" if leaf == "scale" else "bias"
                sd[f"{block}.{bn_names[layer]}.{name}"] = _tensor(value)
        elif head == "lstm":
            cell, leaf = path[1], path[2]
            direction, layer = cell.split("_")
            sfx = f"l{layer}" + ("_reverse" if direction == "bwd" else "")
            if leaf == "wx":
                sd[f"lstm.weight_ih_{sfx}"] = _tensor(np.asarray(value).T)
            elif leaf == "wh":
                sd[f"lstm.weight_hh_{sfx}"] = _tensor(np.asarray(value).T)
            else:
                sd[f"lstm.bias_ih_{sfx}"] = _tensor(value)
                sd[f"lstm.bias_hh_{sfx}"] = torch.zeros(np.shape(value), dtype=torch.float32)
        elif head == "attention_pooling":
            leaf = path[-1]
            name = "weight" if leaf == "kernel" else "bias"
            arr = _kernel(value) if leaf == "kernel" else value
            sd[f"attention_pooling.attention_weights.{name}"] = _tensor(arr)
        elif head == "fc":
            leaf = path[-1]
            name = "weight" if leaf == "kernel" else "bias"
            sd[f"fc.{name}"] = _tensor(_kernel(value) if leaf == "kernel" else value)
        else:
            raise KeyError(f"unexpected parameter {key!r}")
    return sd


def cnn_lstm_flat_from_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Port ``CNNLSTM`` state dict → JAX flat variables (``params/...`` and
    ``batch_stats/...``, float32 numpy), the inverse of
    :func:`cnn_lstm_state_dict_from_flat`. The JAX cell has one bias, so it
    gets ``bias_ih + bias_hh``; ``num_batches_tracked`` has no counterpart."""
    bn_names = {"bn1": "bn1", "bn2": "bn2", "shortcut.1": "shortcut_bn"}
    conv_names = {"conv1": "conv1", "conv2": "conv2", "shortcut.0": "shortcut_conv"}
    flat: Dict[str, np.ndarray] = {}

    def arr(key: str) -> np.ndarray:
        return state_dict[key].detach().cpu().numpy().astype(np.float32)

    for key in state_dict:
        if key.endswith("num_batches_tracked"):
            continue
        head, rest = key.split(".", 1)
        if head.startswith("res_block"):
            layer, leaf = rest.rsplit(".", 1)
            if layer in conv_names:
                name = "kernel" if leaf == "weight" else "bias"
                value = _kernel(arr(key)) if leaf == "weight" else arr(key)
                flat[f"params/{head}/{conv_names[layer]}/{name}"] = value
            elif leaf in ("running_mean", "running_var"):
                stat = "mean" if leaf == "running_mean" else "var"
                flat[f"batch_stats/{head}/{bn_names[layer]}/{stat}"] = arr(key)
            else:
                name = "scale" if leaf == "weight" else "bias"
                flat[f"params/{head}/{bn_names[layer]}/{name}"] = arr(key)
        elif head == "lstm":
            kind, sfx = rest.rsplit("_l", 1)
            layer, _, rev = sfx.partition("_")
            cell = f"params/lstm/{'bwd' if rev else 'fwd'}_{layer}"
            if kind == "weight_ih":
                flat[f"{cell}/wx"] = arr(key).T.copy()
            elif kind == "weight_hh":
                flat[f"{cell}/wh"] = arr(key).T.copy()
            elif kind == "bias_ih":
                flat[f"{cell}/bias"] = arr(key) + arr(key.replace("bias_ih", "bias_hh"))
        elif head == "attention_pooling":
            leaf = rest.rsplit(".", 1)[-1]
            name = "kernel" if leaf == "weight" else "bias"
            flat[f"params/attention_pooling/score/{name}"] = (
                _kernel(arr(key)).copy() if leaf == "weight" else arr(key))
        elif head == "fc":
            name = "kernel" if rest == "weight" else "bias"
            flat[f"params/fc/{name}"] = _kernel(arr(key)).copy() if rest == "weight" else arr(key)
        else:
            raise KeyError(f"unexpected parameter {key!r}")
    return flat


def wav2vec2_state_dict_from_flat(flat: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``Wav2Vec2Model`` flat params → port ``Wav2Vec2Model`` state dict.

    The port's module names mirror the JAX tree, so each key maps by path:
    ``params/layer_0/q/kernel`` → ``layer_0.q.weight`` (transposed).
    """
    sd: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        collection, *path = key.split("/")
        if collection != "params":
            raise KeyError(f"unexpected collection in {key!r}")
        leaf = path[-1]
        if leaf == "kernel":
            path[-1], value = "weight", _kernel(value)
        elif leaf == "scale":
            path[-1] = "weight"
        sd[".".join(path)] = _tensor(value)
    return sd


def infer_architecture(state_dict: Mapping[str, Any]) -> Dict[str, int]:
    """Recover (input_dim, cnn_out_channels, lstm_hidden_dim, lstm_layers,
    num_classes) from the tensor shapes of a reference-named state dict."""
    conv1 = state_dict["res_block1.conv1.weight"]  # (out, in, k)
    wih0 = state_dict["lstm.weight_ih_l0"]  # (4H, C)
    fc = state_dict["fc.weight"]
    n_layers = 0
    while f"lstm.weight_ih_l{n_layers}" in state_dict:
        n_layers += 1
    return {
        "input_dim": int(conv1.shape[1]),
        "cnn_out_channels": int(conv1.shape[0]),
        "lstm_hidden_dim": int(wih0.shape[0] // 4),
        "lstm_layers": n_layers,
        "num_classes": int(fc.shape[0]),
    }
