"""Per cent of the window's megasteps that the host loop dispatched below
their job's first lane width: the tail, after the photon budget is spent
and the survivors are compacted.  The program's counter
``host_loop.tail_megasteps`` (``rsmcrt_tpu_torch.obs``; set-up dispatches
none) over the megasteps the window dispatched.  None from a program
without that module."""

LAYER = "host loop"
MOVES = "photons_per_s"
UNIT = "%"


def read(t):
    try:
        from rsmcrt_tpu_torch import obs
    except ImportError:
        return None
    if t.dispatched <= 0:
        return None
    return 100.0 * obs.counters.get("host_loop.tail_megasteps", 0) \
        / t.dispatched
