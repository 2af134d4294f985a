"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
nothing reads ``bench.py`` or ``BENCH_*.json``."""

import json
import os
import subprocess
import sys

import pytest

from perf_bench.tests.helpers import BENCH, REPO, tiny_sphere

CHILD = r"""
import io, json, sys
from perf_bench import control, harness, run, trace
out, err = io.StringIO(), io.StringIO()
rc = harness.run("slab.detect", 5, 0.01, True, device="cpu", out=out,
                 err=err, photons=2000, reference_photons=4000)
tops = sorted({m.split(".")[0] for m in sys.modules})
print(json.dumps({"rc": rc, "tops": tops,
                  "line": out.getvalue().strip().splitlines()[-1]}))
"""


def test_no_jax_in_the_benchmark_process():
    done = subprocess.run([sys.executable, "-c", CHILD], cwd=REPO,
                          capture_output=True, text=True, timeout=600,
                          check=True)
    got = json.loads(done.stdout.strip().splitlines()[-1])
    assert got["rc"] == 0
    assert "rsmcrt_tpu_torch" in got["tops"]
    for name in ("jax", "jaxlib", "flax", "rsmcrt_tpu", "bench"):
        assert name not in got["tops"]
    assert json.loads(got["line"])["device"]["platform"] == "cpu"


def test_the_harness_reads_no_old_benchmark():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        for word in ("BENCH_", "bench.py", "MULTICHIP_", "import jax",
                     "rsmcrt_tpu.", "from rsmcrt_tpu import"):
            assert word not in text, (path, word)


PLANTED = r"""
import io, json, sys
from perf_bench import harness
root, cell, site = sys.argv[1:4]
if site == "reference":
    real = harness.plainmc.simulate

    def simulate(*a, **kw):
        import jax  # noqa: F401
        return real(*a, **kw)

    harness.plainmc.simulate = simulate
out, err = io.StringIO(), io.StringIO()
rc = harness.run(cell, 5, 0.01, True, device="cpu", root=root, out=out,
                 err=err)
print(json.dumps({"rc": rc, "out": out.getvalue(), "err": err.getvalue()}))
"""


@pytest.mark.parametrize("site", ["metric_reader", "reference"])
def test_a_module_loaded_after_the_window_that_imports_jax(tmp_path, site):
    """A file that loads only after the window has closed (a per-layer
    reader, the reference) and imports JAX stops the run before its line:
    the look at ``sys.modules`` is made again just before printing."""
    stub = tmp_path / "stub"
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text("")
    root = tmp_path / "bench"
    limits = {"photons_missing": 0, "jobs_cut": 0, "emission_diff": 0}
    cell = tiny_sphere(root, limits, photons=500, ref=1000, max_steps=400)
    (root / "metrics" / "planted.py").write_text(
        ("import jax  # noqa: F401\n" if site == "metric_reader" else "")
        + 'LAYER = "host loop"\nMOVES = "photons_per_s"\nUNIT = "x"\n\n\n'
        "def read(t):\n    return None\n")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(
        {"end_to_end": [], "per_layer": [
            {"name": "planted", "unit": "x", "workloads": [cell]}]}))
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(stub), str(REPO)]))
    done = subprocess.run([sys.executable, "-c", PLANTED, str(root), cell,
                           site], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600, check=True)
    got = json.loads(done.stdout.strip().splitlines()[-1])
    assert got["rc"] != 0
    assert got["out"] == ""
    assert "jax" in got["err"]
