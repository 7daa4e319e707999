"""The port's benchmark: one run of one cell.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Everything a cell needs is found by name:
the cell in ``BENCHMARK.json`` and ``port_bench/workloads/<cell>.json``
(its traffic kind and parameters, the limits of its check), its
configuration in ``port_bench/configs/<config>.json``, its traffic kind in
``port_bench/traffic/<kind>.py``, and each per-layer metric's reader in
``port_bench/layer_metrics/<metric>.py`` or, failing that, the file of the
metric's name up to its first dot. A later cell, configuration or metric is
added as files alone.

A run: check the card, set up (weights, inputs, every shape warmed up),
measure the window for ``--seconds`` (traced by ``torch.profiler`` with
``--trace 1``), read the peak memory, free the program's state, compare the
window's answers with the plain reference, and print one JSON line last on
standard output (``--trace 0``: the cell's end-to-end metrics; ``--trace 1``:
its per-layer metrics, the device's busy and window seconds and the
breakdown). Each number compared is printed beside its limit as the last
lines on standard error and as the result line's last key.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()  # set-up starts when the process reaches this module

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "robust_speech_analysis_framework_tpu")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m port_bench.run", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seconds <= 0:
        ap.error("--seconds must be positive")
    return args


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(name: str, root: str = ".") -> SimpleNamespace:
    """The cell ``name``: its BENCHMARK.json entry, workload file, config,
    the end-to-end and per-layer metrics it reports, and its kind's module."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise SystemExit(f"unknown workload {name!r}")
    entry = entries[0]
    bench_dir = os.path.join(root, "port_bench")
    workload = load_json(os.path.join(bench_dir, "workloads", name + ".json"))
    for key in ("config", "traffic", "chips"):
        if workload[key] != entry[key]:
            raise SystemExit(f"{name}: {key} {workload[key]!r} in its workload file, "
                             f"{entry[key]!r} in BENCHMARK.json")
    configs = {"model": load_json(os.path.join(bench_dir, "configs", entry["config"] + ".json"))}

    def reports(m: dict, e2e_names) -> bool:
        if "workloads" in m:
            return name in m["workloads"]
        return m.get("moves") is None or m["moves"] in e2e_names

    e2e = [m for m in bench["end_to_end"] if reports(m, ())]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if reports(m, e2e_names)]
    kind = _load_module(os.path.join(bench_dir, "traffic", workload["kind"] + ".py"),
                        f"port_bench.traffic.{workload['kind']}")
    return SimpleNamespace(name=name, entry=entry, workload=workload, configs=configs,
                           end_to_end=e2e, per_layer=layer, kind=kind, root=root)


def _load_module(path: str, module_name: str):
    if module_name in sys.modules:
        return sys.modules[module_name]
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module
    spec.loader.exec_module(module)
    return module


def reader_for(metric: str, root: str = "."):
    """The per-layer reader of ``metric``: ``layer_metrics/<metric>.py``, or
    the file of its name up to the first dot."""
    base = os.path.join(root, "port_bench", "layer_metrics")
    for stem in (metric, metric.split(".")[0]):
        path = os.path.join(base, stem + ".py")
        if os.path.exists(path):
            return _load_module(path, "port_bench.layer_metrics." + stem.replace(".", "_")).read
    raise SystemExit(f"no reader for per-layer metric {metric!r}")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's own name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_info(torch, chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips))}


def run(args: argparse.Namespace, root: str = ".", device: Optional[str] = None) -> dict:
    """One run of the cell; returns the result line's object. ``device``
    None takes the card (and refuses to run without one); the tests pass
    ``"cpu"`` to drive the rest of a run at tiny sizes."""
    cell = load_cell(args.workload, root)
    import torch

    from . import common
    from . import trace as tracing

    chips = int(cell.entry["chips"])
    on_card = device is None
    marks = {"import": time.perf_counter()}
    if on_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise SystemExit(f"{cell.name} needs {chips} CUDA device(s); "
                             f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        device = "cuda:0"
        torch.zeros(1, device=device)
    marks["context"] = time.perf_counter()
    torch.set_num_threads(min(4, torch.get_num_threads()))
    cfg = cell.configs["model"]
    with common.precision(bool(cfg.get("tf32", False))):
        kind = cell.kind.Kind(cell.configs, cell.workload["params"], args.seed, device)
        kind.setup()
        if on_card:
            torch.cuda.synchronize()
        marks["cell"] = time.perf_counter()
        setup_s = marks["cell"] - _T0
        print("set-up: " + ", ".join(f"{n} {t - prev:.3f} s" for (n, t), prev in
                                     zip(marks.items(), [_T0, *marks.values()])), file=sys.stderr)
        traced = None
        if args.trace:
            with tracing.profiled() as out:
                kind.window(args.seconds)
                if on_card:
                    torch.cuda.synchronize()
            traced = out["trace"]
        else:
            kind.window(args.seconds)
        if on_card:
            torch.cuda.synchronize()
        dev_info = device_info(torch, chips) if on_card else {
            "platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
        e2e = kind.end_to_end()
        work = kind.work()
        program = kind.outputs()
        kind.release()
        reference = kind.reference()
    values = kind.compare(program, reference)
    compared = {n: {"value": float(values[n]), "limit": float(limit)}
                for n, limit in cell.workload["limits"].items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared.values())

    metrics: Dict[str, dict] = {}
    if args.trace:
        ctx = SimpleNamespace(trace=traced, work=work)
        for m in cell.per_layer:
            value = reader_for(m["name"], root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        dev_info.update(busy_s=traced.busy_s, window_s=traced.window_s)
    else:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            else:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    result = {"correct": correct, "attempted": int(work["attempted"]), "failed": int(work["failed"]),
              "metrics": metrics, "device": dev_info}
    if args.trace:
        result["breakdown"] = traced.breakdown()
    result["compared"] = compared
    return result


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    result = run(args)
    found = forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
