"""The per-layer readers on synthetic traces: overlapping device intervals
count once, the stretch leaves the megastep time, and a reader with
nothing to read gives nothing."""

import math

import pytest

from perf_bench import harness, roofline
from perf_bench.trace import DeviceOp, Trace, breakdown, gaps, union_seconds


def ops():
    # overlap: [0, 3] and [2, 5] cover 5 s, not 6;
    # [4, 4.5] lies inside; [7, 8] after a 2-s gap; a copy at [9, 9.5]
    return [DeviceOp("deposit_add_kernel<float, false>", 0.0, 3.0),
            DeviceOp("void at::native::elementwise_kernel<128, 2, "
                     "at::native::where_kernel_impl>", 2.0, 5.0),
            DeviceOp("deposit_add_kernel<float, false>", 4.0, 4.5),
            DeviceOp("void at::native::vectorized_elementwise_kernel<4, "
                     "at::native::MulFunctor<float> >", 7.0, 8.0),
            DeviceOp("Memcpy DtoH (Device -> Pinned)", 9.0, 9.5,
                     "gpu_memcpy")]


def test_union_counts_overlap_once():
    assert union_seconds(ops()) == pytest.approx(6.5)
    assert sum(o.end_s - o.start_s for o in ops()) == pytest.approx(8.0)
    assert union_seconds([]) == 0.0


def test_gaps_and_breakdown():
    assert [round(s, 6) for s, _ in gaps(ops())] == [2.0, 1.0]
    b = breakdown(ops())
    assert b["idle_gaps"][0] == ["launching vectorized_elementwise_kernel"
                                 "[MulFunctor]", pytest.approx(2.0)]
    names = dict(b["device_ops"])
    assert names["deposit_add_kernel"] == pytest.approx(3.5)
    assert names["elementwise_kernel[where_kernel_impl]"] == \
        pytest.approx(3.0)
    assert len(breakdown(ops() * 20, top=3)["device_ops"]) == 3


def read(metric, t):
    return harness.load_reader(harness.ROOT, metric).read(t)


def trace(**kw):
    base = dict(window_s=20.0, dispatched=22, counted=20, stretch_s=10.0,
                stretch_dispatched=2, stretch_span_s=12.0,
                device_ops=ops(), deposit_launches=[(1000, 100, 4)])
    base.update(kw)
    return Trace(**base)


def test_readers_on_a_synthetic_trace():
    t = trace()
    assert read("host_loop.dispatched_per_counted", t) == pytest.approx(1.1)
    # the stretch (12 s with the profiler's start and stop, 2 megasteps)
    # is left out: 8 s over 20 megasteps
    assert read("megastep.ms", t) == pytest.approx(400.0)
    assert read("megastep.kernels", t) == pytest.approx(2.0)  # 4 / 2
    assert read("device.idle_share", t) == pytest.approx(35.0)  # 1 - 6.5/10
    need = roofline.deposit_add_bytes(1000, 100, 4)
    assert need == 8 * 1000 + 2 * 4 * 100
    want = 100.0 * need / roofline.H100_HBM_BYTES_PER_S / 3.5
    assert read("deposit_add_roofline", t) == pytest.approx(want)


def test_readers_find_nothing_to_read():
    empty = Trace(window_s=5.0, dispatched=0, counted=0)
    for metric in ("host_loop.dispatched_per_counted", "megastep.ms",
                   "megastep.kernels", "device.idle_share",
                   "deposit_add_roofline"):
        assert read(metric, empty) is None
    # a stretch without a deposit kernel has no roofline, never 0
    t = trace(device_ops=ops()[1:2], deposit_launches=[])
    assert read("deposit_add_roofline", t) is None
    assert not math.isnan(read("device.idle_share", t))
