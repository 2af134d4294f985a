"""Per cent of the window's megasteps whose chained walk the program
replayed from a CUDA graph: the program's counter
``megastep.walk_replays`` (``rsmcrt_tpu_torch.obs``; set-up counts none)
over the megasteps the window dispatched.  None from a program without
the walk's graphs (``engine.walk_graphs``)."""

LAYER = "megastep"
MOVES = "photons_per_s"
UNIT = "%"


def read(t):
    try:
        from rsmcrt_tpu_torch import obs
        from rsmcrt_tpu_torch.transport import engine
    except ImportError:
        return None
    if t.dispatched <= 0 or not hasattr(engine, "walk_graphs"):
        return None
    return 100.0 * obs.counters.get("megastep.walk_replays", 0) \
        / t.dispatched
