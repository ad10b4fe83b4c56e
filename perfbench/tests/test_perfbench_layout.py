"""The benchmark's files: every cell, configuration, traffic mix, limit
file and metric reader that ``BENCHMARK.json`` names loads, the file
keeps the contract's shape, and a new cell, configuration or metric is
found from a new file alone."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from _bench import BENCH, CELLS, CONFIGS, ROOT, cell_files

from perfbench import run as bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_files_load(cell):
    w = CELLS[cell]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    config, traffic, limits = cell_files(cell)
    assert config["name"] == w["config"]
    assert limits and set(limits) <= {"loss_gap", "update_gap",
                                      "change_gap", "mask_miss"}
    assert limits["mask_miss"] == 0        # the masks are exact
    assert traffic["round"]["method"] == "eris"
    for group in ("end_to_end", "per_layer"):
        names = {m["name"] for m in bench.metrics_for(BENCH, cell,
                                                      group == "per_layer")}
        assert names, f"{cell} reports no {group} metric"
    assert "setup_s" in {m["name"] for m in bench.metrics_for(BENCH, cell,
                                                              False)}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_files(name):
    c = CONFIGS[name]
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"].startswith("perfbench/")
    body = json.loads((ROOT / c["file"]).read_text())
    assert body["reduced"] == c["reduced"]
    assert body["source"].startswith(c["source"])
    for key in c["reduced"]:
        assert NAME.match(key)
        assert not re.search(r"(size|_dim|_rank|heads|per_tok|experts)$",
                             key), f"{key} is a width"
        assert key in body, f"reduced key {key} not in the file"
    assert any(w["config"] == name for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]]
                         + [m["name"] for m in BENCH["per_layer"]])
def test_metric_readers(metric):
    spec = next(m for m in BENCH["end_to_end"] + BENCH["per_layer"]
                if m["name"] == metric)
    assert NAME.match(metric) and UNIT.match(spec["unit"])
    assert spec["better"] in ("lower", "higher")
    if spec in BENCH["end_to_end"]:
        assert spec["source"] in ("host_clock", "device_trace")
        assert 0.01 <= spec["bound"] <= 0.25
    else:
        assert spec["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert len(spec["layer"]) <= 200
    reader = bench.load_module(ROOT / "perfbench" / "metrics"
                               / f"{metric}.py", f"test_{metric}")
    assert reader.read({"setup_s": 1.0, "rounds": 0, "peak_bytes": 0,
                        "timed": None, "profile": None}) in (None, 1.0)


def test_new_files_are_found(tmp_path):
    """A cell, a configuration, a traffic mix and a metric added as new
    files (and entries) in a copy of the benchmark are found by name,
    with no existing file edited."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench_json = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    d = tmp_path / "perfbench"
    cfg = json.loads((d / "configs" / "eris-gptneo-1.3b.json").read_text())
    cfg["name"] = "throwaway-model"
    (d / "configs" / "throwaway-model.json").write_text(json.dumps(cfg))
    traffic = json.loads((d / "workloads" / "round-fused-8x1024.json")
                         .read_text())
    traffic["seq"] = 2048
    (d / "workloads" / "throwaway-mix.json").write_text(json.dumps(traffic))
    (d / "limits" / "throwaway-cell.json").write_text(json.dumps(
        {"loss_gap": 1, "update_gap": 1, "change_gap": 1}))
    (d / "metrics" / "throwaway_metric.py").write_text(
        "def read(ctx):\n    return 2.0 * ctx['setup_s']\n")
    bench_json["configs"].append(
        {"name": "throwaway-model", "source": "https://example.org/model",
         "file": "perfbench/configs/throwaway-model.json", "reduced": [],
         "why": "a test"})
    bench_json["workloads"].append(
        {"name": "throwaway-cell", "config": "throwaway-model",
         "traffic": "throwaway-mix", "chips": 1, "why": "a test"})
    bench_json["per_layer"].append(
        {"name": "throwaway_metric", "unit": "s", "better": "lower",
         "source": "host_clock", "layer": "device", "moves": "round_ms",
         "workloads": ["throwaway-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench_json))
    copy = bench.load_module(d / "run.py", "throwaway_run")
    cell, config, mix, limits = copy.cell_files(bench_json, "throwaway-cell")
    assert config["name"] == "throwaway-model" and mix["seq"] == 2048
    assert limits["loss_gap"] == 1
    specs = copy.metrics_for(bench_json, "throwaway-cell", True)
    assert "throwaway_metric" in [m["name"] for m in specs]
    assert copy.read_metrics(specs[-1:], {"setup_s": 3.0}) == {
        "throwaway_metric": {"value": 6.0, "unit": "s"}}
    # the old cells do not report the new metric
    assert "throwaway_metric" not in [
        m["name"] for m in copy.metrics_for(bench_json, "gptneo-round-fused",
                                            True)]
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "perfbench").rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[p] == b for p, b in before.items())


def test_no_card_no_result(tmp_path):
    """Without a card (this host) a run exits non-zero and prints no
    result."""
    import subprocess
    import sys
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is not reachable")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
         "gptneo-round-fused", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr
