"""A configuration, a cell and a per-layer metric that exist only as new
files are found by name, with no edit to the harness."""

import json

from perf_bench import harness
from perf_bench.tests.helpers import run_line, tiny_sphere
from perf_bench.trace import Trace

READER = '''
LAYER = "host loop"
MOVES = "photons_per_s"
UNIT = "x"


def read(t):
    return float(t.dispatched) if t.dispatched else None
'''


def test_new_files_are_found(bench_root):
    limits = {"photons_missing": 0, "jobs_cut": 0, "emission_diff": 0,
              "nscatt_z": 1e9, "jmean_z": 1e9, "jmean_excess": 1e9,
              "absorb_z": 1e9, "absorb_excess": 1e9}
    cell = tiny_sphere(bench_root, limits, photons=2000, ref=4000,
                       name="fake.cell")
    (bench_root / "metrics" / "fake.count.py").write_text(READER)
    (bench_root.parent / "BENCHMARK.json").write_text(json.dumps({
        "end_to_end": [{"name": "photons_per_s", "unit": "photons/s"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "fake.count", "unit": "x",
                       "workloads": ["fake.cell"]},
                      {"name": "megastep.ms", "unit": "ms",
                       "workloads": ["another.cell"]}]}))
    found = harness.load_cell(cell, bench_root)
    assert found.config["source"]["nphotons"] == 2000
    assert found.meta["reduced"] == ["nphotons", "nxg", "nyg", "nzg"]
    assert [m["name"] for m in harness.cell_metrics(found, "per_layer")] \
        == ["fake.count"]
    reader = harness.load_reader(bench_root, "fake.count")
    assert reader.read(Trace(window_s=1.0, dispatched=7, counted=6)) == 7.0

    rc, line, err = run_line(cell, root=bench_root, trace=True)
    assert rc == 0 and line["correct"] is True
    assert line["window"]["photons"] == 2000
    assert line["window"]["dispatched"] == line["window"]["counted"]
    assert list(line)[-1] == "checks"
