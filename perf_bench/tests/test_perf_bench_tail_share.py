"""``host_loop.tail_share`` reads the program's tail counter over the
window's dispatches, and nothing from a program without the counter's
module (the parent of the change that added it)."""

import sys

import pytest

from perf_bench import harness
from perf_bench.trace import Trace


def read(t):
    return harness.load_reader(harness.ROOT, "host_loop.tail_share").read(t)


def test_tail_share_reads_the_counter(monkeypatch):
    from rsmcrt_tpu_torch import obs

    monkeypatch.setattr(obs, "counters", {"host_loop.tail_megasteps": 30})
    t = Trace(window_s=10.0, dispatched=120, counted=118)
    assert read(t) == pytest.approx(25.0)
    monkeypatch.setattr(obs, "counters", {})
    assert read(t) == 0.0
    assert read(Trace(window_s=1.0, dispatched=0, counted=0)) is None


def test_tail_share_without_the_module(monkeypatch):
    import rsmcrt_tpu_torch

    monkeypatch.delattr(rsmcrt_tpu_torch, "obs", raising=False)
    monkeypatch.setitem(sys.modules, "rsmcrt_tpu_torch.obs", None)
    assert read(Trace(window_s=10.0, dispatched=120, counted=118)) is None
