"""A cell whose ``chips`` is N > 1: N processes, one a card, joined by a
``torch.distributed`` process group, as the reference runs under MPI
(``README.md``, "A cell on several cards", is the contract).

The process that took the command (the parent) imports neither PyTorch
nor the program: it spawns the ranks, watches them, and prints what rank 0
sends back.  Each rank joins the group and runs
:func:`perf_bench.harness.run_cell` with a :class:`perf_bench.group.Group`.
A rank that exits with another code than 0, or dies, ends the run: the
parent ends the other ranks and exits with that code.
"""

from __future__ import annotations

import ctypes
import datetime
import io
import multiprocessing
import multiprocessing.connection
import os
import signal
import socket
import sys
from pathlib import Path

from .cell import Cell, clean, load_cell

# how long a collective (the barrier, a job's decision, the exchange) may
# wait on a rank before it fails
TIMEOUT_S = 300
# how long an ended rank is given between SIGTERM and SIGKILL
GRACE_S = 10


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _die_with(parent: int):
    """SIGKILL this process when the parent dies (Linux), so that a
    parent killed from outside leaves no rank behind."""
    try:
        ctypes.CDLL(None).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        return
    if os.getppid() != parent:
        os._exit(1)


def rank(r: int, world: int, port: int, parent: int, cell_name: str,
         root: str, seed: int, seconds: float, trace: bool, device: str,
         t0: float, threads: int, photons, reference_photons, conn):
    """Rank ``r`` of ``world`` (the target of a spawned process): runs the
    cell and exits with its code; rank 0 first sends ``(code, standard
    output, standard error)`` through ``conn``."""
    _die_with(parent)
    os.environ["LOCAL_RANK"] = str(r)
    import torch

    from . import harness
    from .group import Group

    torch.set_num_threads(threads)
    on_card = device == "cuda"
    if on_card:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < world:
            print(f"perf_bench: {cell_name} needs {world} CUDA cards; "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            sys.exit(3)
        dev = torch.device("cuda", r)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    from rsmcrt_tpu_torch.parallel import distributed

    distributed.initialize(backend="nccl" if on_card else "gloo",
                           init_method=f"tcp://localhost:{port}",
                           world_size=world, rank=r,
                           timeout=datetime.timedelta(seconds=TIMEOUT_S))
    group = Group(r, world, dev if on_card else torch.device("cpu"))
    out, err = (io.StringIO(), io.StringIO()) if r == 0 else \
        (sys.stdout, sys.stderr)
    try:
        code = harness.run_cell(load_cell(cell_name, Path(root)), seed,
                                seconds, trace, dev, t0, photons,
                                reference_photons, out, err, group=group)
    finally:
        group.close()
    if r == 0:
        conn.send((code, out.getvalue(), err.getvalue()))
    sys.exit(code)


def _end(procs):
    """Ends every rank still running: SIGTERM, then SIGKILL."""
    procs = [p for p in procs if p.pid is not None]  # started
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(GRACE_S)
        if p.is_alive():
            p.kill()
            p.join()


def _watch(procs, conn):
    """Waits until every rank has ended or one has failed; returns (rank
    0's message or None, the first rank that failed or None)."""
    message, waiting = None, {p.sentinel: p for p in procs}
    conns = [conn]
    while waiting:
        for ready in multiprocessing.connection.wait(list(waiting) + conns):
            if ready is conn:
                try:
                    message = conn.recv()
                except EOFError:
                    pass
                conns = []
                continue
            p = waiting.pop(ready)
            p.join()
            if p.exitcode != 0:
                return message, p
    if conns and conn.poll():
        message = conn.recv()
    return message, None


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
        t0: float, photons, reference_photons, out, err,
        cpu_threads: int | None = None, target=rank) -> int:
    """The cell on ``chips`` ranks, which share ``cpu_threads`` (all the
    cores by default) for PyTorch's CPU work; ``target`` is each rank's
    function, :func:`rank` but in tests.  Returns the exit code, having
    printed rank 0's line and compared numbers."""
    world = cell.chips
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    threads = max(1, (cpu_threads or os.cpu_count() or 1) // world)
    reader, writer = ctx.Pipe(duplex=False)
    procs = [ctx.Process(
        target=target, name=f"perf_bench.rank{r}", daemon=True,
        args=(r, world, port, os.getpid(), cell.name, str(cell.root), seed,
              seconds, trace, device, t0, threads, photons,
              reference_photons, writer if r == 0 else None))
        for r in range(world)]
    try:
        for p in procs:
            p.start()
        writer.close()
        message, failed = _watch(procs, reader)
    finally:
        _end(procs)
        reader.close()
    if message is not None:
        code, text, errors = message
        err.write(errors)
        err.flush()
    if failed is not None:
        print(f"perf_bench: rank {procs.index(failed)} of {world} exited "
              f"with {failed.exitcode}; the others were ended", file=err)
        return failed.exitcode if failed.exitcode > 0 else 1
    if message is None:
        print("perf_bench: rank 0 sent no result", file=err)
        return 1
    if not clean(err):
        return 4
    out.write(text)
    out.flush()
    return code
