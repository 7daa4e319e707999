"""The flagship forward as one callable with example arguments.

Counterpart of ``__graft_entry__.entry``: the flagship CNN-LSTM (reference
architecture scale: input_dim=768, cnn=128, lstm=128) with seeded random
weights, and a (2, 128, 768) batch. ``forward(*args)`` gives the (2, 2)
logits on ``device``. The multi-device training dryrun waits for the port's
multi-device runs.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .models.cnn_lstm import CNNLSTM, build_cnn_lstm


def entry(device: DeviceLike = "cuda") -> Tuple[Callable, Tuple[CNNLSTM, torch.Tensor]]:
    """(forward, (model, x)): ``forward(model, x)`` runs the model in
    inference mode on ``x``."""
    dev = resolve_device(device)
    model = build_cnn_lstm(input_dim=768, cnn_out_channels=128, lstm_hidden_dim=128, seed=0,
                           device=dev)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 128, 768)).astype(np.float32))

    def forward(model: CNNLSTM, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(x)

    return forward, (model, x.to(dev))
