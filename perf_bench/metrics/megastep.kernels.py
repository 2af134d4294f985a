"""Device kernels a megastep: the kernels the profiler saw in the
traced stretch over the megasteps dispatched in it.  A count; CUDA
graphs or a fused megastep move it."""

LAYER = "megastep"
MOVES = "photons_per_s"
UNIT = "kernels/megastep"


def read(t):
    kernels = sum(1 for op in t.device_ops if op.kind == "kernel")
    if not kernels or t.stretch_dispatched <= 0:
        return None
    return kernels / t.stretch_dispatched
