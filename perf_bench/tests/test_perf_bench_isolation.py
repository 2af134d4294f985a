"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
neither in its own process nor in the ranks of a cell on several cards,
and nothing reads ``bench.py`` or ``BENCH_*.json``."""

import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perf_bench import harness, ranks
from perf_bench.tests.helpers import BENCH, REPO, tiny_sphere

FORBIDDEN = ("jax", "jaxlib", "flax", "rsmcrt_tpu")

CHILD = r"""
import io, json, sys
from perf_bench import cell, control, group, harness, ranks, run, trace
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
    for name in (*FORBIDDEN, "bench"):
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


def reporting_rank(r, world, port, parent, cell, root, *rest):
    """A rank that writes the top-level names of its modules beside the
    bench folder once its run has ended."""
    try:
        ranks.rank(r, world, port, parent, cell, root, *rest)
    finally:
        tops = sorted({m.split(".")[0] for m in list(sys.modules)})
        (Path(root).parent / f"rank{r}.modules.json").write_text(
            json.dumps(tops))


def jax_importing_rank(r, world, port, parent, cell, root, *rest):
    """Rank 1 imports a stub ``jax`` (from ``stub/`` beside the bench
    folder) in each job of its window."""
    if r == 1:
        from rsmcrt_tpu_torch import kernels

        real = kernels.run_MCRT

        def run_MCRT(*a, **kw):
            sys.path.insert(0, str(Path(root).parent / "stub"))
            import jax  # noqa: F401
            return real(*a, **kw)

        kernels.run_MCRT = run_MCRT
    ranks.rank(r, world, port, parent, cell, root, *rest)


def run_two_ranks(root, target):
    limits = {"photons_missing": 0, "jobs_cut": 0, "emission_diff": 0}
    cell = tiny_sphere(root, limits, photons=500, ref=1000, chips=2)
    out, err = io.StringIO(), io.StringIO()
    rc = ranks.run(harness.load_cell(cell, root), 5, 0.01, True, "cpu",
                   time.perf_counter(), None, None, out, err,
                   cpu_threads=torch.get_num_threads(), target=target)
    return rc, out.getvalue(), err.getvalue()


def test_no_jax_in_the_ranks(bench_root):
    rc, out, err = run_two_ranks(bench_root, reporting_rank)
    assert rc == 0, err[-2000:]
    assert json.loads(out.strip().splitlines()[-1])["device"]["count"] == 2
    for r in range(2):
        tops = json.loads((bench_root.parent / f"rank{r}.modules.json")
                          .read_text())
        assert "rsmcrt_tpu_torch" in tops
        for name in FORBIDDEN:
            assert name not in tops, (r, name)


def test_a_rank_that_imports_jax_ends_the_run(bench_root, capfd):
    """Rank 1's look at ``sys.modules`` after the window finds ``jax``:
    it names it and exits non-zero, rank 0 prints no line, and neither
    does the parent."""
    stub = bench_root.parent / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    rc, out, err = run_two_ranks(bench_root, jax_importing_rank)
    assert rc != 0
    assert out == ""
    assert "jax" in capfd.readouterr().err
