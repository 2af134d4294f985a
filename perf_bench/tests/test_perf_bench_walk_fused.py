"""``megastep.walk_fused_share`` reads the program's count of walks that
ran as the hand-written kernel over the window's dispatches, and nothing
from a program without the kernel's dispatch (the parent of the change
that added it) or without its modules."""

import sys

import pytest

from perf_bench import harness
from perf_bench.trace import Trace

METRIC = "megastep.walk_fused_share"


def read(t):
    return harness.load_reader(harness.ROOT, METRIC).read(t)


@pytest.mark.parametrize("counters, share", [
    ({"megastep.walk_fused": 120}, 100.0),
    ({"megastep.walk_fused": 30, "megastep.walk_replays": 120}, 25.0),
    ({}, 0.0)])
def test_walk_fused_share_reads_the_counter(monkeypatch, counters, share):
    from rsmcrt_tpu_torch import obs

    monkeypatch.setattr(obs, "counters", counters)
    t = Trace(window_s=10.0, dispatched=120, counted=118)
    assert read(t) == pytest.approx(share)


def test_walk_fused_share_without_dispatches():
    assert read(Trace(window_s=1.0, dispatched=0, counted=0)) is None


def test_walk_fused_share_without_the_kernel(monkeypatch):
    from rsmcrt_tpu_torch.transport import engine

    monkeypatch.delattr(engine, "_fused_engages")
    assert read(Trace(window_s=10.0, dispatched=120, counted=118)) is None


def test_walk_fused_share_without_the_module(monkeypatch):
    import rsmcrt_tpu_torch

    monkeypatch.delattr(rsmcrt_tpu_torch, "obs", raising=False)
    monkeypatch.setitem(sys.modules, "rsmcrt_tpu_torch.obs", None)
    assert read(Trace(window_s=10.0, dispatched=120, counted=118)) is None
