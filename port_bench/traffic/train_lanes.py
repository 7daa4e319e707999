"""Lane-batched CV trials: rounds of ``train_trials_device``.

Traffic: a resident corpus of ``rows`` embedding sequences whose lengths
are ``rows`` values evenly spaced over [``min_frames``, ``max_frames``] (the
same set for every seed; the seed sets their rows, the data, the labels and
the trials). Rows are given roles by their rank in length, so every seed
trains on the same lengths: a fifth are the outer test fold, and of the rest
every third is the inner fold's validation set (29 rows), the others its
train set (59 rows). A round is one inner fold of a nested-CV tuning round:
``train_trials_device`` with ``lanes`` trials (learning rates log-uniform
over ``lr``, dropout rates uniform over ``dropout``, drawn from the seed),
``epochs`` epochs of batches of ``batch`` with no plateau decay or restore
(the tuning loop's configuration), then the lanes' eval logits of the
validation rows, fetched.

Set-up drives the same trainer and corpus through a round of one epoch,
which runs every shape of a round. Every round of the window is recorded:
its first ``check_steps`` steps, the state before and after its last step,
and its eval logits. The check judges the window's last round: the
reference follows its first steps from the benchmark's weights, takes its
last step again from the program's state before it, and scores the
validation rows with the program's lanes as that step left them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from .. import flops, peaks
from ..common import SEED_MOD, device_generator, leaf_gaps, max_rel_err, precision, rng, worst_leaf_gap
from ..reference import cnn_lstm as ref_cnn_lstm
from ..reference.weights import cnnlstm_spec, make_weights

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8  # the program's Trainer default
BN_MOMENTUM = 0.01  # Flax's 0.99: ra = 0.99 ra + 0.01 batch, biased variance
MOVED = 1e-3  # a leaf whose reference gradient is under this share of the median leaf's is not compared
FAULTS = ("half_batch", "lane_lr")  # planted in the reference put in the program's place


def _running_stats(state) -> Dict[str, torch.Tensor]:
    return {n: b.clone() for n, b in state.model.named_buffers() if ".running_" in n}


def _bench_trainer(model, weights, device):
    """The program's Trainer, started from the benchmark's weights, which
    records a round's steps while ``record`` is set."""
    from robust_speech_analysis_framework_tpu_torch.train.loops import Trainer

    class BenchTrainer(Trainer):
        record = None

        def init_state(self, seed, lr, _weights=None):
            return super().init_state(seed, lr, weights)

        def train_step_lanes(self, state, *args, **kwargs):
            rec = self.record
            if rec is None:
                return super().train_step_lanes(state, *args, **kwargs)
            opt, step = state.optimizer, rec["step"]
            rec["step"] += 1
            if step == 0:
                rec["flat0"], rec["offsets"] = opt.flat.clone(), dict(opt.offsets)
            if step == rec["last"]:
                rec["before"] = {"flat": opt.flat.clone(), "exp_avg": opt.exp_avg.clone(),
                                 "exp_avg_sq": opt.exp_avg_sq.clone(),
                                 "stats": _running_stats(state), "steps": opt.steps[0]}
            losses = super().train_step_lanes(state, *args, **kwargs)
            if step < rec["steps"]:
                rec["losses"].append(losses.clone())
            if step == 0:
                rec["exp_avg1"], rec["flat1"] = opt.exp_avg.clone(), opt.flat.clone()
            if step == rec["steps"] - 1:
                rec["flat"] = opt.flat.clone()
            if step == rec["last"]:
                rec["after"] = {"flat": opt.flat.clone(), "stats": _running_stats(state),
                                "losses": losses.clone()}
            return losses

    return BenchTrainer(model, device=device)


class Kind:
    def __init__(self, configs: Dict[str, dict], params: dict, seed: int, device):
        self.cfg = configs["model"]
        self.p = params
        self.seed = seed
        self.device = torch.device(device)

    # --- traffic ----------------------------------------------------------------

    def _corpus(self) -> None:
        p, cfg = self.p, self.cfg
        n = p["rows"]
        by_rank = np.round(np.linspace(p["min_frames"], p["max_frames"], n)).astype(np.int64)
        r = rng(self.seed, 3)
        row_of_rank = r.permutation(n)
        lengths = np.empty(n, np.int64)
        lengths[row_of_rank] = by_rank
        tv = [row_of_rank[i] for i in range(n) if i % 5 != 0]
        self.val_rows = np.array([row for j, row in enumerate(tv) if j % 3 == 1])
        self.train_rows = np.array([row for j, row in enumerate(tv) if j % 3 != 1])
        labels = np.zeros(n, np.int64)
        for rows in (self.train_rows, self.val_rows):
            labels[rows] = r.permutation(np.arange(len(rows)) % 2)
        self.labels = labels
        align = p["align"]
        t_pad = -(-int(lengths.max()) // align) * align
        gen = device_generator(self.seed, 4, self.device)
        x = torch.randn((n, t_pad, cfg["input_dim"]), generator=gen, device=self.device)
        steps = torch.arange(t_pad, device=self.device)
        lens = torch.from_numpy(lengths).to(self.device)
        x *= (steps[None, :] < lens[:, None]).to(x.dtype)[:, :, None]
        x[:, :, :16] += 0.3 * torch.from_numpy(labels).to(self.device, x.dtype)[:, None, None] \
            * (steps[None, :] < lens[:, None]).to(x.dtype)[:, :, None]
        self.x, self.lengths = x, lengths

    def setup(self) -> None:
        from robust_speech_analysis_framework_tpu_torch.features.wav2vec2 import ResidentSequences
        from robust_speech_analysis_framework_tpu_torch.models.cnn_lstm import CNNLSTM
        from robust_speech_analysis_framework_tpu_torch.train.loops import DeviceCorpus, TrainConfig

        p, cfg = self.p, self.cfg
        self._corpus()
        corpus = DeviceCorpus.from_resident(
            ResidentSequences([f"r{i:03d}" for i in range(len(self.lengths))], self.x, self.lengths))
        self.train_view, self.val_view = corpus.view(self.train_rows), corpus.view(self.val_rows)
        r = rng(self.seed, 5)
        self.lrs = [float(v) for v in np.exp(r.uniform(*np.log(p["lr"]), p["lanes"]))]
        self.rates = [float(v) for v in r.uniform(*p["dropout"], p["lanes"])]
        self.weights = make_weights(cnnlstm_spec(cfg), self.seed, self.device)
        model = CNNLSTM(input_dim=cfg["input_dim"], num_classes=cfg["num_classes"],
                        cnn_out_channels=cfg["cnn_out_channels"],
                        lstm_hidden_dim=cfg["lstm_hidden_dim"], lstm_layers=cfg["lstm_layers"],
                        dropout_rate=cfg["dropout_rate"], activation_fn=cfg["activation_fn"])
        self.trainer = _bench_trainer(model, self.weights, self.device)
        self.train_cfg = TrainConfig(
            learning_rate=self.lrs[0], epochs=p["epochs"], patience=p["epochs"] + 1,
            batch_size=p["batch"], seed=self.seed % SEED_MOD, dropout_rate=self.rates[0],
            use_plateau=False, restore_best=False)
        self.steps_per_epoch = -(-len(self.train_rows) // p["batch"])
        self.recorded = self.eval_logits = None
        self._round(1)  # every shape of a round

    def _round(self, epochs: int) -> np.ndarray:
        from robust_speech_analysis_framework_tpu_torch.train.loops import train_trials_device

        cfg = dataclasses.replace(self.train_cfg, epochs=epochs)
        y_tr, y_va = self.labels[self.train_rows], self.labels[self.val_rows]
        states, _ = train_trials_device(self.trainer, self.train_view, y_tr, self.val_view, y_va,
                                        cfg, self.lrs, self.rates)
        return self.trainer.eval_logits_trials_deferred(states, self.val_view, cfg).result()

    def window(self, seconds: float) -> None:
        from robust_speech_analysis_framework_tpu_torch.ops.cuda import lstm as lstm_ops

        p = self.p
        k3 = lstm_ops.lstm_scan_fwd_res_grouped.launches
        self.rounds = 0
        start = time.perf_counter()
        deadline = start + seconds
        while time.perf_counter() < deadline:
            self.trainer.record = {"steps": p["check_steps"], "losses": [], "step": 0,
                                   "last": p["epochs"] * self.steps_per_epoch - 1}
            logits = self._round(p["epochs"])  # the lanes' eval logits fetched, as a round does
            self.recorded, self.eval_logits = self.trainer.record, logits
            self.rounds += 1
        self.elapsed = time.perf_counter() - start
        self.trainer.record = None
        self.lane_steps = (lstm_ops.lstm_scan_fwd_res_grouped.launches - k3) // self.cfg["lstm_layers"]

    def end_to_end(self) -> Dict[str, float]:
        frames = float(self.lengths[self.train_rows].sum())
        audio_s = self.rounds * self.p["epochs"] * self.p["lanes"] * frames / self.cfg["frames_per_second"]
        return {"train_audio_s_per_s": audio_s / self.elapsed}

    def work(self) -> dict:
        cfg, p = self.cfg, self.p
        train_len = self.lengths[self.train_rows]
        val_len = self.lengths[self.val_rows]
        epochs = self.rounds * p["epochs"]
        per_lane = (epochs * (flops.cnnlstm_train(cfg, train_len) + flops.cnnlstm_forward(cfg, val_len))
                    + self.rounds * flops.cnnlstm_forward(cfg, val_len))
        g, h = 2 * p["lanes"], cfg["lstm_hidden_dim"]
        row_steps = int((train_len // 2).sum())
        bound = (peaks.lstm_bound_ms(row_steps, g, 1, h, save_c=True)[0]
                 + peaks.lstm_bwd_bound_ms(row_steps, g, 1, h)[0])
        return {"flops": p["lanes"] * per_lane,
                "lstm_train_bound_ms": epochs * cfg["lstm_layers"] * bound,
                "lane_steps": self.lane_steps,
                "attempted": self.rounds * p["lanes"], "failed": 0}

    def release(self) -> None:
        del self.trainer, self.train_view, self.val_view
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the check ----------------------------------------------------------------

    def _lane_leaves(self, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Each trained tensor of a flat buffer of the program's, (K, ...)."""
        k, shapes = self.p["lanes"], {n: s for n, s, _, _ in cnnlstm_spec(self.cfg)}
        return {n: buf[a : a + m].view(k, *shapes[n]) for n, (a, m) in self.recorded["offsets"].items()}

    def _norms(self, tensors: Mapping[str, torch.Tensor]) -> Dict[str, float]:
        k = self.p["lanes"]
        return {f"{n}[{lane}]": float(t.reshape(k, -1)[lane].double().norm())
                for n, t in tensors.items() for lane in range(k)}

    def outputs(self) -> dict:
        """The window's last round: the losses of its first steps, the
        first gradient, the changes after step 1 and after the first steps,
        its last step's losses and changes (parameters and BatchNorm
        statistics), and its eval logits."""
        rec, k = self.recorded, self.p["lanes"]
        if rec is None or len(rec["losses"]) < self.p["check_steps"] or "after" not in rec:
            return {"losses": None}
        before, after = rec["before"], rec["after"]
        return {"losses": torch.stack(rec["losses"]).cpu().numpy(),
                "grad": self._norms(self._lane_leaves(rec["exp_avg1"] / (1.0 - BETAS[0]))),
                "change1": self._norms(self._lane_leaves(rec["flat1"] - rec["flat0"])),
                "change": self._norms(self._lane_leaves(rec["flat"] - rec["flat0"])),
                "last_losses": after["losses"].cpu().numpy(),
                "last_change": {**self._norms(self._lane_leaves(after["flat"] - before["flat"])),
                                **self._norms({n: (after["stats"][n] - before["stats"][n]).view(k, -1)
                                               for n in before["stats"]})},
                "eval": self.eval_logits}

    def _adam(self, params, grads, m, v, lrs, t: int) -> None:
        """``torch.optim.Adam``'s update at step ``t``, each lane at its own rate."""
        for (n, prm), g in zip(params.items(), grads):
            m[n].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
            v[n].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
            step_size = (lrs / (1 - BETAS[0] ** t)).to(torch.float32)
            step_size = step_size.view([-1] + [1] * (prm.ndim - 1))
            denom = v[n].sqrt() / (1 - BETAS[1] ** t) ** 0.5 + ADAM_EPS
            prm -= step_size * m[n] / denom

    def _step_loss(self, w, params, rows, draw, rates, fault, stats=None):
        """The lanes' losses (K,) of one train step on ``rows``."""
        k = self.p["lanes"]
        rows = torch.from_numpy(self.train_rows[rows]).to(self.device)
        lens = torch.from_numpy(self.lengths).to(self.device)[rows]
        y = torch.from_numpy(self.labels).to(self.device)[rows]
        logits = ref_cnn_lstm.forward({**w, **params}, self.x[rows], lens, self.cfg, train=True,
                                      rates=rates, draw=draw, stats=stats)
        keep = y.shape[0] // 2 if fault == "half_batch" else y.shape[0]
        return torch.stack([F.cross_entropy(logits[i, :keep], y[:keep]) for i in range(k)])

    def _epoch_order(self, epoch: int) -> np.ndarray:
        """The framework's documented shuffle of an epoch: ``RandomState(seed + epoch)``."""
        order = np.arange(len(self.train_rows))
        np.random.RandomState(self.train_cfg.seed + epoch).shuffle(order)
        return order

    def reference(self, tf32: bool = False, fault: str = "") -> dict:
        """The plain reference of the window's last round: its first steps
        from the benchmark's weights (batches by the documented shuffle,
        dropout uniforms from a generator on the device seeded as the
        trainer's, then per lane cross-entropy, autograd and Adam), its last
        step again from the program's state before it, and the eval logits
        of the validation rows with the lanes that step left."""
        p, k = self.p, self.p["lanes"]
        lrs = torch.tensor(self.lrs, dtype=torch.float64, device=self.device)
        if fault == "lane_lr":
            lrs[int(np.argmax(self.lrs))] *= 2.0
        rates = torch.tensor(self.rates, dtype=torch.float64, device=self.device)
        draw = self._uniforms()
        w = ref_cnn_lstm.lanes(self.weights, k)
        for name in list(w):  # the framework trains bias_hh folded into bias_ih
            if name.startswith("lstm.bias_hh"):
                w[name.replace("bias_hh", "bias_ih")] = w[name.replace("bias_hh", "bias_ih")] + w[name]
                w[name] = torch.zeros_like(w[name])
        params = {n: w[n].clone().requires_grad_(True) for n in self.recorded["offsets"]}
        start = {n: v.detach().clone() for n, v in params.items()}
        m = {n: torch.zeros_like(v) for n, v in params.items()}
        v2 = {n: torch.zeros_like(v) for n, v in params.items()}
        order = self._epoch_order(0)
        losses, grad1, change1 = [], None, None
        with precision(tf32):
            for step in range(p["check_steps"]):
                loss = self._step_loss(w, params, order[step * p["batch"] : (step + 1) * p["batch"]],
                                       draw, rates, fault)
                grads = torch.autograd.grad(loss.sum(), list(params.values()))
                losses.append(loss.detach())
                with torch.no_grad():
                    if grad1 is None:
                        grad1 = dict(zip(params, grads))
                    self._adam(params, grads, m, v2, lrs, step + 1)
                    if change1 is None:
                        change1 = {n: params[n] - start[n] for n in params}
        out = {"losses": torch.stack(losses).cpu().numpy(), "grad": self._norms(grad1),
               "change1": self._norms(change1),
               "change": self._norms({n: params[n].detach() - start[n] for n in params})}
        del params, m, v2, grad1, change1
        out.update(self._last_step(w, lrs, rates, tf32, fault))
        return out

    def _uniforms(self):
        """The dropout uniforms of a round, site after site: a generator on
        the device seeded as the trainer's."""
        gen = torch.Generator(device=self.device).manual_seed(self.train_cfg.seed)
        return lambda shape: torch.rand(shape, generator=gen, device=self.device, dtype=torch.float32)

    def _last_step(self, w, lrs, rates, tf32: bool, fault: str) -> dict:
        p, k, rec = self.p, self.p["lanes"], self.recorded
        before, after = rec["before"], rec["after"]
        n_train, last_epoch = len(self.train_rows), p["epochs"] - 1
        draw = self._uniforms()
        # the dropout uniforms of every earlier step of the round, drawn and passed by
        for step in range(rec["last"]):
            rows = min(p["batch"], n_train - (step % self.steps_per_epoch) * p["batch"])
            for shape in ref_cnn_lstm.draw_shapes(self.cfg, rows, self.x.shape[1]):
                draw(shape)
        order = self._epoch_order(last_epoch)
        rows = order[(self.steps_per_epoch - 1) * p["batch"]:]
        params = {n: t.clone().requires_grad_(True) for n, t in self._lane_leaves(before["flat"]).items()}
        m = {n: t.clone() for n, t in self._lane_leaves(before["exp_avg"]).items()}
        v2 = {n: t.clone() for n, t in self._lane_leaves(before["exp_avg_sq"]).items()}
        stats: Dict = {}
        with precision(tf32):
            loss = self._step_loss(w, params, rows, draw, rates, fault, stats)
            grads = torch.autograd.grad(loss.sum(), list(params.values()))
            with torch.no_grad():
                grad = self._norms(dict(zip(params, grads)))
                start = {n: t.detach().clone() for n, t in params.items()}
                self._adam(params, grads, m, v2, lrs, before["steps"] + 1)
        change = {n: params[n].detach() - start[n] for n in params}
        stat_change = {}
        for name, old in before["stats"].items():
            prefix, which = name.rsplit(".", 1)
            batch = torch.stack([stats[(prefix, lane)][0 if which == "running_mean" else 1]
                                 for lane in range(k)])
            stat_change[name] = BN_MOMENTUM * (batch - old.view(k, -1))
        # the lanes as the program's last step left them: its parameters and statistics
        lanes = {**w, **self._lane_leaves(after["flat"]),
                 **{n: s.view(k, -1) for n, s in after["stats"].items()}}
        del params, m, v2, grads
        logits = []
        val = torch.from_numpy(self.val_rows).to(self.device)
        lens = torch.from_numpy(self.lengths).to(self.device)
        with precision(tf32), torch.no_grad():
            for i in range(0, len(val), p["batch"]):
                idx = val[i : i + p["batch"]]
                logits.append(ref_cnn_lstm.forward(lanes, self.x[idx], lens[idx], self.cfg))
        return {"last_losses": loss.detach().cpu().numpy(), "last_grad": grad,
                "last_change": {**self._norms(change), **self._norms(stat_change)},
                "eval": torch.cat(logits, dim=1).cpu().numpy()}

    def compare(self, program: dict, reference: dict) -> Dict[str, float]:
        if program["losses"] is None:
            return dict.fromkeys(("loss_gap_step1", "loss_gap", "grad_gap", "change_gap_step1",
                                  "change_gap_slow_lane", "change_gap_median", "last_loss_gap",
                                  "last_change_gap", "last_change_median", "eval_logit_err"),
                                 float("inf"))
        k = self.p["lanes"]
        loss_gaps = np.abs(program["losses"] - reference["losses"]) / np.abs(reference["losses"])
        change1, change = (leaf_gaps(program[key], self._moved(reference[key], reference["grad"]))
                           for key in ("change1", "change"))

        def lane_median(gaps, lane):
            return float(np.median([g for n, g in gaps.items() if n.endswith(f"[{lane}]")]))

        last = leaf_gaps(program["last_change"],
                         self._moved(reference["last_change"], reference["last_grad"]))
        return {"loss_gap_step1": float(loss_gaps[0].max()),
                "loss_gap": float(loss_gaps.max()),
                "grad_gap": worst_leaf_gap(program["grad"], reference["grad"]),
                # after one step each lane has moved by its own rate: every lane is held
                "change_gap_step1": max(lane_median(change1, lane) for lane in range(k)),
                # a lane's later steps amplify rounding in proportion to its
                # learning rate: the slowest lane's median reads alike from seed to seed
                "change_gap_slow_lane": lane_median(change, int(np.argmin(self.lrs))),
                "change_gap_median": float(np.median(list(change.values()))),
                "last_loss_gap": float((np.abs(program["last_losses"] - reference["last_losses"])
                                        / np.abs(reference["last_losses"])).max()),
                # the last step from the program's own state: the worst leaf
                # (parameters and BatchNorm statistics) and each lane's median
                "last_change_gap": max(last.values()),
                "last_change_median": max(lane_median(last, lane) for lane in range(k)),
                "eval_logit_err": max_rel_err(program["eval"], reference["eval"])}

    @staticmethod
    def _moved(change: Mapping[str, float], grad: Mapping[str, float]) -> Dict[str, float]:
        """The leaves the reference moves: a leaf that its gradient leaves
        unmoved up to rounding (a conv bias ahead of a BatchNorm, the
        attention score's bias) moves under Adam by round-off alone. The
        BatchNorm statistics, which have no gradient, are kept."""
        median = float(np.median(list(grad.values())))
        return {n: v for n, v in change.items() if n not in grad or grad[n] >= MOVED * median}

    def look(self, program: dict, reference: dict) -> dict:
        """The leaves with the widest gaps, each lane's median change gap,
        and how many leaves the rule on the reference's gradient leaves out."""
        k = self.p["lanes"]
        out = {"lrs": self.lrs, "rates": self.rates,
               "loss_by_step": (np.abs(program["losses"] - reference["losses"])
                                / np.abs(reference["losses"])).max(axis=1).tolist()}
        for key, grad in (("change1", "grad"), ("change", "grad"), ("last_change", "last_grad")):
            moved = self._moved(reference[key], reference[grad])
            gaps = leaf_gaps(program[key], moved)
            out[key] = {"worst": sorted(gaps.items(), key=lambda kv: -kv[1])[:3],
                        "lanes": [float(np.median([g for n, g in gaps.items() if n.endswith(f"[{i}]")]))
                                  for i in range(k)],
                        "moved": len(moved), "leaves": len(reference[key])}
        return out
