"""Per cent of the traced stretch in which no operation ran on the
card: 1 - (union of the kernel, copy and set intervals) / (the
stretch's host-clock wall between two synchronisations)."""

from perf_bench.trace import union_seconds

LAYER = "device"
MOVES = "photons_per_s"
UNIT = "%"


def read(t):
    if not t.device_ops or not t.stretch_s:
        return None
    return 100.0 * (1.0 - union_seconds(t.device_ops) / t.stretch_s)
