"""Batch scoring of embedding sequences by the CNN-LSTM classifier.

Traffic: ``pool`` batches of ``batch`` sequences of ``frames`` real frames
(padded to ``padded``), made on the device from the seed and kept there;
the window scores them in turn through ``CNNLSTM.forward`` in eval mode
under ``inference_mode``, with their lengths, and downloads each batch's
logits. A batch's logits are its answer; the check compares the answers of
``check`` pool batches drawn from the seed, every time they were scored,
with the plain reference.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from .. import flops
from ..common import device_generator, max_rel_err, precision, rng
from ..reference import cnn_lstm as ref_cnn_lstm
from ..reference.weights import cnnlstm_spec, make_weights


def build_classifier(cfg, weights, device):
    """The program's classifier with the benchmark's weights, in eval mode."""
    from robust_speech_analysis_framework_tpu_torch.models.cnn_lstm import CNNLSTM

    model = CNNLSTM(input_dim=cfg["input_dim"], num_classes=cfg["num_classes"],
                    cnn_out_channels=cfg["cnn_out_channels"],
                    lstm_hidden_dim=cfg["lstm_hidden_dim"], lstm_layers=cfg["lstm_layers"],
                    dropout_rate=cfg["dropout_rate"], activation_fn=cfg["activation_fn"])
    model.load_state_dict(weights)
    return model.to(device).eval()


class Kind:
    def __init__(self, configs: Dict[str, dict], params: dict, seed: int, device):
        self.cfg = configs["model"]
        self.p = params
        self.seed = seed
        self.device = torch.device(device)

    def setup(self) -> None:
        p, cfg = self.p, self.cfg
        self.weights = make_weights(cnnlstm_spec(cfg), self.seed, self.device)
        self.model = build_classifier(cfg, self.weights, self.device)
        gen = device_generator(self.seed, 1, self.device)
        shape = (p["pool"], p["batch"], p["padded"], cfg["input_dim"])
        self.x = torch.randn(shape, generator=gen, device=self.device)
        self.x[:, :, p["frames"]:] = 0.0
        self.lengths = torch.full((p["batch"],), p["frames"], dtype=torch.int64, device=self.device)
        for j in range(p["pool"]):  # every shape the window uses
            self._score(j)

    def _score(self, j: int) -> np.ndarray:
        with torch.inference_mode():
            return self.model(self.x[j], self.lengths).cpu().numpy()

    def window(self, seconds: float) -> None:
        from robust_speech_analysis_framework_tpu_torch.ops.cuda import lstm as lstm_ops

        launches = lstm_ops.lstm_scan_grouped.launches
        self.answers: List[tuple] = []
        start = time.perf_counter()
        deadline = start + seconds
        while time.perf_counter() < deadline:
            j = len(self.answers) % self.p["pool"]
            self.answers.append((j, self._score(j)))
        self.elapsed = time.perf_counter() - start
        self.k1_launches = lstm_ops.lstm_scan_grouped.launches - launches

    def end_to_end(self) -> Dict[str, float]:
        n = len(self.answers) * self.p["batch"]
        return {"score_audio_s_per_s": n * self.p["frames"] / self.cfg["frames_per_second"]
                / self.elapsed}

    def work(self) -> dict:
        from .. import peaks

        cfg, p = self.cfg, self.p
        rows = len(self.answers) * p["batch"]
        steps = max(p["frames"] // 2, 1)
        bound = peaks.lstm_bound_ms(steps, 2, p["batch"], cfg["lstm_hidden_dim"])[0]
        return {"flops": flops.cnnlstm_forward(cfg, [p["frames"]] * rows),
                "lstm_fwd_bound_ms": bound * self.k1_launches,
                "attempted": len(self.answers), "failed": 0}

    def release(self) -> None:
        del self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the check ------------------------------------------------------------

    def checked(self) -> List[int]:
        pool = self.p["pool"]
        return sorted(rng(self.seed, 2).choice(pool, size=min(self.p["check"], pool), replace=False))

    def outputs(self) -> Dict[int, List[np.ndarray]]:
        """Every window answer of the checked batches."""
        keep = set(self.checked())
        out: Dict[int, List[np.ndarray]] = {}
        for j, logits in self.answers:
            if j in keep:
                out.setdefault(j, []).append(logits)
        return out

    def reference(self, tf32: bool = False) -> Dict[int, List[np.ndarray]]:
        w = ref_cnn_lstm.lanes(self.weights, 1)
        out = {}
        with torch.no_grad(), precision(tf32):
            for j in self.checked():
                out[j] = [ref_cnn_lstm.forward(w, self.x[j], self.lengths, self.cfg)[0].cpu().numpy()]
        return out

    def compare(self, program, reference) -> Dict[str, float]:
        errs = [max_rel_err(a, reference[j][0]) for j in reference for a in program.get(j, [None])]
        return {"logit_err": max(errs) if errs else float("inf")}
