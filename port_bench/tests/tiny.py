"""A copy of the benchmark at tiny widths and loads, for runs on the CPU."""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY_MIX = {"reading": [1, 6.0, 9.0], "interview": [2, 0.6, 2.0]}
TINY_PARAMS = {
    "flagship-score-b128": dict(batch=3, frames=40, padded=48, pool=2, check=2),
    "flagship-train-lanes8": dict(rows=20, min_frames=20, max_frames=60, align=16, lanes=2,
                                  batch=4, epochs=2),
    "w2v2-extract-androids": dict(mix=TINY_MIX, check=2),
}


def _edit(path: str, **changes) -> None:
    with open(path) as fh:
        data = json.load(fh)
    for key, value in changes.items():
        if isinstance(value, dict) and isinstance(data.get(key), dict):
            data[key].update(value)
        else:
            data[key] = value
    with open(path, "w") as fh:
        json.dump(data, fh)


def tiny_root(tmp: str) -> str:
    """``tmp`` made a checkout's root holding BENCHMARK.json and the
    benchmark's folder, its configurations cut to tiny widths and its
    traffic to tiny loads."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp)
    dst = os.path.join(tmp, "port_bench")
    shutil.copytree(os.path.join(REPO, "port_bench"), dst,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    _edit(os.path.join(dst, "configs", "cnnlstm-flagship.json"),
          input_dim=32, cnn_out_channels=8, lstm_hidden_dim=8)
    _edit(os.path.join(dst, "configs", "w2v2-base-cnnlstm.json"),
          hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64, conv_dim=[16] * 7,
          pos_conv_kernel=8, pos_conv_groups=4)
    for cell, params in TINY_PARAMS.items():
        _edit(os.path.join(dst, "workloads", cell + ".json"), params=params)
    return tmp


def config(tmp: str, name: str) -> dict:
    with open(os.path.join(tmp, "port_bench", "configs", name + ".json")) as fh:
        return json.load(fh)
