"""A cell whose ``chips`` is 2 runs as two ranks joined by gloo on the CPU
(:mod:`perf_bench.ranks`): one contract line from rank 0, correct against
the cell's limits, the same jobs on both ranks; a rank that fails or dies
mid-window ends the run, with no rank left behind.

A rank's function is handed to ``ranks.run`` as ``target``; the ones here
break a rank and then run the real :func:`perf_bench.ranks.rank`."""

import io
import json
import multiprocessing
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from perf_bench import group, harness, ranks
from perf_bench.tests.helpers import REPO, real_limits, run_line, tiny_sphere

SEED = 2**31 + 9191
LIMIT_S = 60


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("ranks") / "bench"
    cell = tiny_sphere(root, real_limits("sphere.fluence"), chips=2)
    return run_line(cell, root=root, seed=SEED)


def test_two_ranks_print_one_contract_line(two_ranks):
    rc, line, err = two_ranks
    assert rc == 0, err[-2000:]
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["device"]["count"] == 2
    assert line["device"]["platform"] == "cpu"
    window = line["window"]
    assert window["jobs_by_rank"] == [line["attempted"]] * 2
    assert len(window["memory_peak_bytes_by_rank"]) == 2
    assert list(line)[-1] == "checks"
    checks = line["checks"]
    tail = err.strip().splitlines()[-len(checks):]
    assert [t.split(":")[0] for t in tail] == [f"check {n}" for n in checks]


def test_two_ranks_are_correct(two_ranks):
    _, line, _ = two_ranks
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0
    assert line["checks"]["rank_jobs_differ"] == {"value": 0, "limit": 0}


def _broken(r, how):
    """Breaks ``kernels.run_MCRT`` on rank 1 at its second call (the
    set-up makes one, so this is the window's first job)."""
    if r != 1:
        return
    from rsmcrt_tpu_torch import kernels

    real, calls = kernels.run_MCRT, []

    def run_MCRT(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            if how == "raises":
                raise RuntimeError("a rank broken by the test")
            os.kill(os.getpid(), signal.SIGKILL)
        return real(*a, **kw)

    kernels.run_MCRT = run_MCRT


def raising_rank(r, *args):
    _broken(r, "raises")
    ranks.rank(r, *args)


def dying_rank(r, *args):
    _broken(r, "dies")
    ranks.rank(r, *args)


def miscounting_rank(r, *args):
    """Rank 1 reports one job more than it ran."""
    if r == 1:
        real = group.Group.exchange
        group.Group.exchange = \
            lambda self, row: real(self, [row[0] + 1, *row[1:]])
    ranks.rank(r, *args)


def run_ranks(root, cell, target, seconds):
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    rc = ranks.run(harness.load_cell(cell, root), SEED, seconds, False,
                   "cpu", t0, None, None, out, err,
                   cpu_threads=torch.get_num_threads(), target=target)
    return rc, out.getvalue(), err.getvalue(), time.perf_counter() - t0


@pytest.mark.parametrize("target", [raising_rank, dying_rank],
                         ids=["raises", "dies"])
def test_a_rank_that_fails_mid_window_ends_the_run(bench_root, target):
    cell = tiny_sphere(bench_root, real_limits("sphere.fluence"),
                       photons=2000, ref=4000, chips=2)
    rc, out, err, wall = run_ranks(bench_root, cell, target, seconds=30)
    assert rc != 0
    assert out == ""
    assert "rank 1 of 2 exited" in err
    assert wall < LIMIT_S
    assert multiprocessing.active_children() == []


def test_ranks_that_ran_different_jobs_are_not_correct(bench_root):
    cell = tiny_sphere(bench_root, real_limits("sphere.fluence"),
                       photons=2000, ref=4000, chips=2)
    rc, out, err, wall = run_ranks(bench_root, cell, miscounting_rank,
                                   seconds=0.01)
    assert rc == 0, err[-2000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is False
    assert line["checks"]["rank_jobs_differ"] == {"value": 1, "limit": 0}
    assert wall < LIMIT_S


PARENT = r"""
import io, json, sys, time
from perf_bench import cell, ranks
out, err = io.StringIO(), io.StringIO()
rc = ranks.run(cell.load_cell(sys.argv[2], sys.argv[1]), 5, 0.01, False,
               "cpu", time.perf_counter(), None, None, out, err,
               cpu_threads=int(sys.argv[3]))
print(json.dumps({"rc": rc, "torch": "torch" in sys.modules,
                  "line": out.getvalue().strip().splitlines()[-1]}))
"""


def test_the_parent_imports_no_torch(bench_root):
    """The process that takes a cell on several cards spawns the ranks
    without importing PyTorch, so its start-up is paid once, by the
    ranks."""
    limits = {"photons_missing": 0, "jobs_cut": 0, "emission_diff": 0}
    cell = tiny_sphere(bench_root, limits, photons=500, ref=1000, chips=2)
    done = subprocess.run([sys.executable, "-c", PARENT, str(bench_root),
                           cell, str(torch.get_num_threads())], cwd=REPO,
                          capture_output=True, text=True, timeout=LIMIT_S,
                          check=True)
    got = json.loads(done.stdout.strip().splitlines()[-1])
    assert got["rc"] == 0
    assert got["torch"] is False
    assert json.loads(got["line"])["device"]["count"] == 2
