"""Per cent of the card's NVLink peak a direction that the all-reduce of
the shared jobs' tallies reaches on rank 0: the bus bytes of the
program's counter ``dist.reduce_bytes`` over ``dist.world`` ranks
(:func:`perf_bench.collective.busbw_bytes`) over ``dist.reduce_ns`` (the
SUM all-reduces of every job, timed up to a synchronisation of the
card), over the peak of :mod:`perf_bench.collective`.  None from a
program that shares no job over the ranks."""

from perf_bench.collective import H100_NVLINK_BYTES_PER_S, busbw_bytes

LAYER = "ranks"
MOVES = "photons_per_s"
UNIT = "%"


def read(t):
    try:
        from rsmcrt_tpu_torch import obs
    except ImportError:
        return None
    c = obs.counters
    reduced, ns, world = (c.get("dist.reduce_bytes"), c.get("dist.reduce_ns"),
                          c.get("dist.world"))
    if not reduced or not ns or not world or world < 2:
        return None
    per_s = busbw_bytes(reduced, world) / (ns * 1e-9)
    return 100.0 * per_s / H100_NVLINK_BYTES_PER_S
