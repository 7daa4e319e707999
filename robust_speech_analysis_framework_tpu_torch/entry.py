"""The flagship forward as one callable, and the multi-device dryrun.

Counterpart of ``__graft_entry__``:

* :func:`entry`: the flagship CNN-LSTM (reference architecture scale:
  input_dim=768, cnn=128, lstm=128) with seeded random weights, and a
  (2, 128, 768) batch. ``forward(*args)`` gives the (2, 2) logits on
  ``device``.
* :func:`dryrun_multichip`: a (dp, mp) grid over ``n`` devices, ONE full
  training step of the flagship with Adam, sharded (the batch on dp, the
  rule-matched parameters and their Adam moments on mp), then a dp-split
  openSMILE frame stage, a lane-split ``train_trials_device`` and
  ``cli extract --features opensmile`` on a generated corpus over the same
  grid.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .models.cnn_lstm import CNNLSTM, build_cnn_lstm

FLAGSHIP = dict(input_dim=768, cnn_out_channels=128, lstm_hidden_dim=128)
DRYRUN_T = 32


def entry(device: DeviceLike = "cuda") -> Tuple[Callable, Tuple[CNNLSTM, torch.Tensor]]:
    """(forward, (model, x)): ``forward(model, x)`` runs the model in
    inference mode on ``x``."""
    dev = resolve_device(device)
    model = build_cnn_lstm(**FLAGSHIP, seed=0, device=dev)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 128, 768)).astype(np.float32))

    def forward(model: CNNLSTM, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(x)

    return forward, (model, x.to(dev))


def dryrun_batch(n_devices: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The dryrun's batch: one (T=32, 768) sequence per grid slot, labels
    alternating (the JAX dryrun's)."""
    x = np.random.default_rng(0).normal(size=(n_devices, DRYRUN_T, 768)).astype(np.float32)
    return x, np.full(n_devices, DRYRUN_T, np.int64), np.arange(n_devices) % 2


def dryrun_multichip(n_devices: int, devices: Optional[Sequence[DeviceLike]] = None,
                     verbose: bool = True) -> Dict[str, Any]:
    """One sharded flagship train step and the multi-device extraction and
    trial paths over a grid of ``n_devices`` (mp = 2 when ``n_devices`` is
    even, else 1).

    ``devices`` defaults to the CUDA devices (raises without a card); the
    tests pass ``[torch.device("cpu")] * n`` and a one-card machine
    ``[cuda:0] * n``. Returns what each stage produced (the loss, the
    stepped ``ShardedTrainState``, the trial lanes' validation logits, the
    extracted row count) and prints a one-line summary.
    """
    from .eval.dl_cv import _TrainerCache
    from .features.opensmile import OpenSmileExtractor
    from .ops.framing import collect
    from .parallel.mesh import make_mesh
    from .train.loops import (ShardedTrainState, TrainConfig, Trainer, sharded_train_step,
                              train_trials_device)

    mp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    grid = make_mesh(n_devices=n_devices, mp=mp, devices=devices)
    lead = grid.lead

    # the sharded train step: the flagship with Adam, dropout on
    trainer = Trainer(CNNLSTM(**FLAGSHIP), device=lead)
    state = ShardedTrainState.shard(trainer.init_state(0, 1e-3), grid)
    x, lengths, y = dryrun_batch(n_devices)
    generator = torch.Generator(device=lead).manual_seed(1)
    loss = float(sharded_train_step(state, x, lengths, y, generator))
    if not np.isfinite(loss):
        raise RuntimeError(f"sharded train step gave loss {loss}")

    # dp-split feature extraction: the openSMILE frame stage, a row's files a device
    ex = OpenSmileExtractor(device=lead)
    stack = torch.from_numpy(np.random.default_rng(1).normal(size=(n_devices, 8000))
                             .astype(np.float32))
    for dev, rows in zip(grid.row_leads(), np.array_split(np.arange(n_devices), grid.dp)):
        mag = ex.frame_stage(stack[rows].to(dev))[0]
        if not bool(torch.isfinite(mag).all()):
            raise RuntimeError("dp-split openSMILE frame stage is not finite")

    # lane-split trials: a lane a dp row over the same grid
    rng = np.random.default_rng(2)
    seqs = [rng.normal(size=(16 + 8 * (i % 3), 32)).astype(np.float32) for i in range(12)]
    labels = np.array([0, 1] * 6)
    lane_trainer = _TrainerCache(input_dim=32, device=lead).get(
        {"cnn_out_channels": 8, "lstm_hidden_dim": 8, "activation_fn": "silu"})
    lrs = [1e-3 * (i + 1) for i in range(grid.dp)]
    rates = [0.2 + 0.05 * i for i in range(grid.dp)]
    cfg = TrainConfig(learning_rate=lrs[0], epochs=2, patience=3, batch_size=4, seed=0,
                      dropout_rate=rates[0], use_plateau=False, restore_best=False)
    states, hist = train_trials_device(lane_trainer, seqs[:8], labels[:8], seqs[8:], labels[8:],
                                       cfg, lrs, rates, mesh=grid)
    logits, lane_hists = collect([lane_trainer.eval_logits_trials_deferred(states, seqs[8:], cfg),
                                  hist])
    if logits.shape[0] != grid.dp or not np.isfinite(logits).all() \
            or not all(np.isfinite(h[0]).all() for h in lane_hists):
        raise RuntimeError(f"lane-split trials gave {logits.shape} logits")

    n_rows = _dryrun_cli_extract(grid)
    if verbose:
        print(f"dryrun_multichip ok: mesh={grid.shape} devices={[str(d) for d in grid.devices]} "
              f"loss={loss:.4f} extraction_split=dp fold_program_trials={grid.dp} lanes split "
              f"over dp (val logits {logits.shape}) cli_extract_rows={n_rows}")
    return {"grid": grid, "loss": loss, "state": state, "lane_logits": logits,
            "cli_extract_rows": n_rows}


def _write_corpus(root: str) -> None:
    """A four-file Androids-style reading corpus of 0.8 s tones."""
    from .audio.io import write_wav

    sr = 16000
    for i in range(4):
        grp = "PT" if i % 2 else "HC"
        name = f"{i + 1:02d}_{'C' if grp == 'HC' else 'P'}F{30 + i}_1.wav"
        t = np.arange(int(0.8 * sr)) / sr
        folder = os.path.join(root, "Reading-Task", "audio", grp)
        os.makedirs(folder, exist_ok=True)
        write_wav(os.path.join(folder, name), 0.3 * np.sin(2 * np.pi * (120 + 15 * i) * t), sr)


def _cli_devices(grid) -> Optional[list]:
    """The ``--device``/``--devices``/``--mp`` flags that lay ``grid`` out,
    or None when the CLI cannot name it (a CUDA grid that repeats a device
    or skips one)."""
    devs = grid.devices
    if all(d.type == "cpu" for d in devs):
        device = "cpu"
    elif devs == [torch.device("cuda", i) for i in range(len(devs))]:
        device = "cuda"
    else:
        return None
    return ["--device", device, "--devices", str(grid.size), "--mp", str(grid.mp)]


def _dryrun_cli_extract(grid) -> int:
    """``cli extract --features opensmile`` over ``grid`` on a generated
    corpus; the row count. Without pandas (the CLI writes CSVs), or for a
    grid the CLI's flags cannot name, the rows come from the array core the
    CLI runs (``experiments.extract_tables``) on the same grid."""
    from .data.corpus import load_androids_rows
    from .experiments import FeatureTable, extract_tables

    with tempfile.TemporaryDirectory() as td:
        root = os.path.join(td, "corpus")
        _write_corpus(root)
        flags = _cli_devices(grid)
        try:
            import pandas as pd
        except ImportError:
            pd = None
        if pd is not None and flags is not None:
            from .cli import main as cli_main

            out = os.path.join(td, "proc")
            rc = cli_main(["extract", "--corpus", root, "--out", out, "--features", "opensmile",
                           "--quiet", *flags])
            if rc != 0:
                raise RuntimeError(f"cli extract returned {rc}")
            values = FeatureTable.from_frame(pd.read_csv(
                os.path.join(out, "features_opensmile_reading_task.csv"))).values
        else:
            reading, interview = load_androids_rows(root, verbose=False)
            tables, _ = extract_tables(reading, interview, ["features_opensmile_reading_task.csv"],
                                       verbose=False, device=grid.lead, mesh=grid)
            values = tables["features_opensmile_reading_task.csv"].values
        if len(values) != 4 or not np.isfinite(values).all():
            raise RuntimeError(f"cli extract gave {len(values)} rows")
        return len(values)
