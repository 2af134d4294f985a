"""Captures of the chained walk's CUDA graph in the window: the program's
counter ``megastep.walk_captures`` (``rsmcrt_tpu_torch.obs``; set-up
counts none).  A capture in the window is a walk the set-up did not
capture, paid for inside the timed jobs.  None from a program without
the walk's graphs (``engine.walk_graphs``)."""

LAYER = "megastep"
MOVES = "photons_per_s"
UNIT = "captures"


def read(t):
    try:
        from rsmcrt_tpu_torch import obs
        from rsmcrt_tpu_torch.transport import engine
    except ImportError:
        return None
    if not hasattr(engine, "walk_graphs"):
        return None
    return float(obs.counters.get("megastep.walk_captures", 0))
