"""Shared set-up of the benchmark's tests: the repository's paths, the
cells' files, and small sizes of each cell that a CPU test run holds."""
from __future__ import annotations

import copy
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for _path in (ROOT, ROOT / "src"):
    if str(_path) not in sys.path:
        sys.path.insert(0, str(_path))

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = {w["name"]: w for w in BENCH["workloads"]}
CONFIGS = {c["name"]: c for c in BENCH["configs"]}


def cell_files(cell: str) -> tuple:
    w = CELLS[cell]
    config = json.loads((ROOT / CONFIGS[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (ROOT / "perfbench" / "workloads" / f"{w['traffic']}.json")
        .read_text())
    limits = json.loads(
        (ROOT / "perfbench" / "limits" / f"{cell}.json").read_text())
    return config, traffic, limits


def small(cell: str) -> tuple:
    """(config, traffic) of ``cell`` at a CPU test's size: 2 layers of
    width 256, 4 heads of 64, vocab 512, float32 (4 experts of top 2 in
    groups of 32 for moe); 2 rows of 128 tokens a client; the round
    itself (K, A, DSC, the compression path, the checked rounds) as the
    cell runs it."""
    config, traffic, _ = cell_files(cell)
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    m = config["model"]
    m.update(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
             d_ff=512, vocab=512, dtype="float32")
    if m["family"] == "moe":
        m.update(n_experts=4, top_k=2, moe_group_size=32)
    traffic.update(batch=2, seq=128)
    return config, traffic
