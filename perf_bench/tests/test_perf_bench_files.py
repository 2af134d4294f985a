"""BENCHMARK.json and the bench folder agree, and keep to the shape the
benchmark's contract gives them."""

import json
import re

import pytest

from perf_bench import harness
from perf_bench.tests.helpers import BENCH, REPO

B = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_limits():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["perf_bench"]
    assert 1 <= B["run_seconds"] <= 51
    cells = 24  # the most a later PR may reach
    assert (2 + 14 * cells) * (B["run_seconds"] + 60) + cells * 180 \
        + 1200 <= 43200
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in B[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs_are_files_of_their_own():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"perf_bench/configs/{c['name']}.toml"
        meta = json.loads((BENCH / "configs" / f"{c['name']}.json")
                          .read_text())
        assert meta["source"] == c["source"]
        assert meta["reduced"] == c["reduced"]
        assert (REPO / c["file"]).is_file()


def test_cells_match_their_files():
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        cell = harness.load_cell(w["name"])
        for key in ("config", "traffic", "chips", "why"):
            assert cell.workload[key] == w[key]
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        e2e = harness.cell_metrics(cell, "end_to_end")
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert harness.cell_metrics(cell, "per_layer")
    # four cards only where what a cell measures exists only across cards
    fours = sum(w["chips"] == 4 for w in B["workloads"])
    assert fours <= max(1, len(B["workloads"]) // 4)


@pytest.mark.parametrize("m", B["per_layer"], ids=lambda m: m["name"])
def test_each_metric_has_its_reader(m):
    reader = harness.load_reader(BENCH, m["name"])
    assert (reader.LAYER, reader.MOVES, reader.UNIT) == \
        (m["layer"], m["moves"], m["unit"])
    assert UNIT.match(m["unit"])
    e2e = {e["name"]: e for e in B["end_to_end"]}
    cells = [w["name"] for w in B["workloads"]]
    moved = e2e[m["moves"]]
    # every cell of the metric reports the end-to-end metric it moves
    assert set(m.get("workloads", cells)) <= set(moved.get("workloads",
                                                          cells))


def test_end_to_end_metrics():
    for e in B["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
        assert UNIT.match(e["unit"])
