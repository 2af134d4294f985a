"""Per cent of its memory roofline that the deposit kernel reaches in
the traced stretch: the least time for the bytes its launches' rows
and touched cells need at the card's peak bandwidth, over the
``deposit_add_kernel`` launches' device time."""

from perf_bench.roofline import bound_seconds, deposit_add_bytes

LAYER = "deposit kernels"
MOVES = "photons_per_s"
UNIT = "%"


def read(t):
    busy = sum(op.end_s - op.start_s for op in t.device_ops
               if op.kind == "kernel" and "deposit_add_kernel" in op.name)
    if busy <= 0.0 or not t.deposit_launches:
        return None
    need = sum(deposit_add_bytes(*launch) for launch in t.deposit_launches)
    return 100.0 * bound_seconds(need) / busy
