"""Per cent of rank 0's window spent at the end of its jobs waiting for
the slowest rank: the program's counter ``dist.wait_ns``
(``rsmcrt_tpu_torch.obs``, the MAX all-reduce of a shared job's steps,
timed up to a synchronisation of the card) over the window.  None from a
program that shares no job over the ranks."""

LAYER = "ranks"
MOVES = "photons_per_s"
UNIT = "%"


def read(t):
    try:
        from rsmcrt_tpu_torch import obs
    except ImportError:
        return None
    wait_ns = obs.counters.get("dist.wait_ns")
    if wait_ns is None or t.window_s <= 0:
        return None
    return 100.0 * wait_ns * 1e-9 / t.window_s
