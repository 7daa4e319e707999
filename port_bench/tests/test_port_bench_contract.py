"""BENCHMARK.json against the benchmark's contract, the harness's command
line, its refusal without a card, files found by name, and what it imports."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

from port_bench import run as harness
from port_bench.tests.tiny import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def bench() -> dict:
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(REPO, p)) and not p.endswith("_torch")
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) <= 64 * 1024


def test_names_units_and_entries():
    b = bench()
    names = set()
    for cfg in b["configs"]:
        assert set(cfg) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(cfg["name"]) and _line(cfg["source"]) and _line(cfg["why"])
        assert cfg["file"].startswith(b["paths"][0] + "/") and os.path.exists(os.path.join(REPO, cfg["file"]))
        assert len(cfg["reduced"]) <= 16 and all(NAME.match(k) for k in cfg["reduced"])
    cfg_names = [c["name"] for c in b["configs"]]
    assert len(set(cfg_names)) == len(cfg_names)
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in cfg_names and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    cells = [w["name"] for w in b["workloads"]]
    assert len(set(cells)) == len(cells)
    used = {w["config"] for w in b["workloads"]}
    assert used == set(cfg_names)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
        assert set(m.get("workloads", [])) <= set(cells)
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        for cell in m["workloads"]:
            reported = e2e[m["moves"]].get("workloads", cells)
            assert cell in reported
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"
            assert "mfu" in m["name"] or m["name"].split(".")[0].endswith("_roofline")
    for cell in cells:  # setup_s, another end-to-end metric, a per-layer metric
        assert sum(cell in m.get("workloads", cells) for m in b["end_to_end"]) >= 2
        assert any(cell in m.get("workloads", []) for m in b["per_layer"])


def test_workload_files_agree_with_benchmark():
    b = bench()
    for w in b["workloads"]:
        cell = harness.load_cell(w["name"], REPO)
        assert cell.workload["config"] == w["config"] and cell.workload["why"] == w["why"]
        assert cell.workload["end_to_end"] == [m["name"] for m in cell.end_to_end
                                               if m["name"] != "setup_s"]
        for m in cell.per_layer:
            assert callable(harness.reader_for(m["name"], REPO))
    for cfg in b["configs"]:
        with open(os.path.join(REPO, cfg["file"])) as fh:
            data = json.load(fh)
        assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
        assert data["reduced"] == cfg["reduced"]


@pytest.mark.parametrize("argv", [
    [],
    ["--workload", "flagship-score-b128"],
    ["--workload", "x", "--seed", "1", "--seconds", "0", "--trace", "0"],
    ["--workload", "x", "--seed", "1", "--seconds", "1", "--trace", "2"],
])
def test_bad_arguments_are_refused(argv):
    with pytest.raises(SystemExit):
        harness.parse_args(argv)


def test_arguments_take_a_large_seed():
    args = harness.parse_args(["--workload", "flagship-score-b128", "--seed", str(2**31 + 12345),
                               "--seconds", "30", "--trace", "1"])
    assert args.seed == 2**31 + 12345 and args.seconds == 30.0 and args.trace == 1


def test_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", "flagship-score-b128", "--seed",
         "3000000019", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


def test_a_config_and_cell_added_as_files_are_found(tmp_path):
    from port_bench.tests.tiny import tiny_root

    root = tiny_root(str(tmp_path))
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        b = json.load(fh)
    cfg_path = os.path.join(root, "port_bench", "configs", "cnnlstm-narrow.json")
    with open(os.path.join(root, "port_bench", "configs", "cnnlstm-flagship.json")) as fh:
        cfg = json.load(fh)
    cfg.update(name="cnnlstm-narrow", cnn_out_channels=4)
    with open(cfg_path, "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(root, "port_bench", "workloads", "flagship-score-b128.json")) as fh:
        wl = json.load(fh)
    wl.update(config="cnnlstm-narrow", traffic="score-b2")
    wl["params"]["batch"] = 2
    with open(os.path.join(root, "port_bench", "workloads", "narrow-score-b2.json"), "w") as fh:
        json.dump(wl, fh)
    b["configs"].append({"name": "cnnlstm-narrow", "source": cfg["source"],
                         "file": "port_bench/configs/cnnlstm-narrow.json", "reduced": [],
                         "why": "a narrower classifier"})
    b["workloads"].append({"name": "narrow-score-b2", "config": "cnnlstm-narrow",
                           "traffic": "score-b2", "chips": 1, "why": wl["why"]})
    for m in b["end_to_end"] + b["per_layer"]:
        if "flagship-score-b128" in m.get("workloads", []):
            m["workloads"].append("narrow-score-b2")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(b, fh)
    cell = harness.load_cell("narrow-score-b2", root)
    assert cell.configs["model"]["cnn_out_channels"] == 4
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "score_audio_s_per_s"]
    assert {m["name"] for m in cell.per_layer} >= {"idle_pct.score", "mfu.score"}
    args = harness.parse_args(["--workload", "narrow-score-b2", "--seed", "5", "--seconds", "0.3"])
    result = harness.run(args, root=root, device="cpu")
    assert result["correct"] and result["metrics"]["score_audio_s_per_s"]["value"] > 0


def test_reader_found_by_the_name_before_its_first_dot():
    assert harness.reader_for("idle_pct.some_later_cell", REPO) is harness.reader_for("idle_pct.score", REPO)


_IMPORT_ALL = """
import glob, importlib, os, sys
sys.path.insert(0, {repo!r})
import port_bench.run, port_bench.trace, port_bench.flops, port_bench.peaks, port_bench.common
for path in sorted(glob.glob(os.path.join({repo!r}, "port_bench", "traffic", "*.py"))):
    importlib.import_module("port_bench.traffic." + os.path.basename(path)[:-3])
for path in sorted(glob.glob(os.path.join({repo!r}, "port_bench", "layer_metrics", "*.py"))):
    port_bench.run.reader_for(os.path.basename(path)[:-3], {repo!r})
{extra}
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _top_level_modules(extra: str = "") -> set:
    code = _IMPORT_ALL.format(repo=REPO, extra=extra)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=REPO, check=True).stdout
    return set(eval(out.strip().splitlines()[-1]))  # a printed list of names


def test_harness_imports_neither_jax_nor_the_jax_package():
    loaded = _top_level_modules("import robust_speech_analysis_framework_tpu_torch.serving, "
                                "robust_speech_analysis_framework_tpu_torch.train.loops")
    assert not loaded & set(harness.FORBIDDEN)
    assert "robust_speech_analysis_framework_tpu_torch" in loaded  # compared whole, not by prefix


def test_references_import_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, {repo!r})\n"
            "import port_bench.reference.cnn_lstm, port_bench.reference.wav2vec2, "
            "port_bench.reference.weights, port_bench.common, port_bench.flops, port_bench.peaks\n"
            "print(sorted({{m.split('.')[0] for m in sys.modules}}))").format(repo=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    loaded = set(eval(out.strip().splitlines()[-1]))
    assert not loaded & (set(harness.FORBIDDEN) | {"robust_speech_analysis_framework_tpu_torch"})


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "robust_speech_analysis_framework_tpu_torch_x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert harness.forbidden_modules() == ["jaxlib"]
