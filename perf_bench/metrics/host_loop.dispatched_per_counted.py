"""Megasteps the host loop dispatched over the megasteps the run
counted (``carry.step``), over the whole traced window: what the loop
queues on the card beyond the work it does."""

LAYER = "host loop"
MOVES = "photons_per_s"
UNIT = "x"


def read(t):
    if t.dispatched <= 0 or t.counted <= 0:
        return None
    return t.dispatched / t.counted
