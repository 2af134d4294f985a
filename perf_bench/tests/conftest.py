"""Fixtures of the benchmark's CPU tests."""

import os
import shutil

import pytest
import torch

from perf_bench.tests.helpers import BENCH, REPO


def pytest_configure(config):
    # share the cores among the test workers: the runs here are CPU-bound
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))


@pytest.fixture
def bench_root(tmp_path):
    root = tmp_path / "bench"
    root.mkdir()
    return root


@pytest.fixture
def copy_bench(tmp_path):
    """A copy of the real bench folder and BENCHMARK.json."""
    root = tmp_path / "perf_bench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "tests", "results", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return root
