"""Milliseconds of window a megastep: the traced window over the
megasteps dispatched in it (host clock), leaving out the profiled
stretch and the profiler's start and stop around it, which run
slower."""

LAYER = "megastep"
MOVES = "photons_per_s"
UNIT = "ms"


def read(t):
    n = t.dispatched - t.stretch_dispatched
    if n <= 0:
        return None
    return 1e3 * (t.window_s - t.stretch_span_s) / n
