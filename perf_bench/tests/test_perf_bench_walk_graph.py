"""``megastep.walk_graph_share`` and ``megastep.walk_captures`` read the
program's walk-graph counters (over the window's dispatches, and as a
count), and nothing from a program without the walk's graphs (the parent
of the change that added them) or without its modules."""

import sys

import pytest

from perf_bench import harness
from perf_bench.trace import Trace

METRICS = ("megastep.walk_graph_share", "megastep.walk_captures")


def read(metric, t):
    return harness.load_reader(harness.ROOT, metric).read(t)


def test_walk_graph_metrics_read_the_counters(monkeypatch):
    from rsmcrt_tpu_torch import obs

    t = Trace(window_s=10.0, dispatched=120, counted=118)
    monkeypatch.setattr(obs, "counters", {"megastep.walk_replays": 90,
                                          "megastep.walk_captures": 2})
    assert read("megastep.walk_graph_share", t) == pytest.approx(75.0)
    assert read("megastep.walk_captures", t) == 2.0
    monkeypatch.setattr(obs, "counters", {})
    assert read("megastep.walk_graph_share", t) == 0.0
    assert read("megastep.walk_captures", t) == 0.0
    idle = Trace(window_s=1.0, dispatched=0, counted=0)
    assert read("megastep.walk_graph_share", idle) is None


@pytest.mark.parametrize("metric", METRICS)
def test_walk_graph_metrics_without_the_graphs(monkeypatch, metric):
    from rsmcrt_tpu_torch.transport import engine

    monkeypatch.delattr(engine, "walk_graphs")
    assert read(metric, Trace(window_s=10.0, dispatched=120,
                              counted=118)) is None


@pytest.mark.parametrize("metric", METRICS)
def test_walk_graph_metrics_without_the_module(monkeypatch, metric):
    import rsmcrt_tpu_torch

    monkeypatch.delattr(rsmcrt_tpu_torch, "obs", raising=False)
    monkeypatch.setitem(sys.modules, "rsmcrt_tpu_torch.obs", None)
    assert read(metric, Trace(window_s=10.0, dispatched=120,
                              counted=118)) is None
