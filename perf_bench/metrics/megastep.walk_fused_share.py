"""Per cent of the window's megasteps whose chained walk was the
hand-written walk kernel: the program's counter ``megastep.walk_fused``
(``rsmcrt_tpu_torch.obs``; set-up counts none) over the megasteps the
window dispatched.  None from a program without the kernel's dispatch
(``engine._fused_engages``)."""

LAYER = "megastep"
MOVES = "photons_per_s"
UNIT = "%"


def read(t):
    try:
        from rsmcrt_tpu_torch import obs
        from rsmcrt_tpu_torch.transport import engine
    except ImportError:
        return None
    if t.dispatched <= 0 or not hasattr(engine, "_fused_engages"):
        return None
    return 100.0 * obs.counters.get("megastep.walk_fused", 0) / t.dispatched
