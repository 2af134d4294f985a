"""Each cell of BENCHMARK.json runs on the CPU through the port's plain
twins at a tiny photon count and prints the one contract line, naming the
CPU and holding no metric: a number from the CPU is never a device
metric."""

import json

import pytest
import torch

from perf_bench.tests.helpers import REPO, run_line

CELLS = [w["name"] for w in
         json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
TINY = {"sphere.fluence": (600, 1200), "slab.detect": (4000, 8000),
        "sphere.nofluence": (3000, 6000)}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_prints_one_line_on_the_cpu(cell):
    photons, ref = TINY.get(cell, (1000, 2000))
    rc, line, err = run_line(cell, trace=False, photons=photons,
                             reference_photons=ref)
    assert rc == 0
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["metrics"] == {}
    assert line["device"]["platform"] == "cpu"
    assert line["device"]["count"] == 1
    assert "busy_s" not in line["device"]
    assert line["attempted"] == line["window"]["jobs"] >= 1
    assert list(line)[-1] == "checks"
    checks = line["checks"]
    for name in ("photons_missing", "jobs_cut", "emission_diff",
                 "nscatt_z"):
        assert name in checks
    assert all(c["limit"] is not None for c in checks.values())
    # the compared numbers come last on standard error too
    tail = err.strip().splitlines()[-len(checks):]
    assert [t.split(":")[0] for t in tail] == [f"check {n}" for n in checks]


def test_without_a_card_the_command_prints_nothing(tmp_path):
    import io

    from perf_bench import harness

    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run("slab.detect", 1, 1.0, False, out=out, err=err)
    assert rc != 0 and out.getvalue() == ""
