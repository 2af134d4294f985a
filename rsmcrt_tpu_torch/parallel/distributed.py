"""Photon sharding over processes (port of
``rsmcrt_tpu/parallel/distributed.py``).

Reference: the MPI rank reduction (src/kernelsMod.f90:2351-2357) -- every
rank simulates its share of the photon budget and the tally grids are
SUM-reduced to rank 0 at the end.  Here every process calls
:func:`initialize` (``torch.distributed``: NCCL between cards, gloo on
the CPU or for several processes sharing one card).  Two paths share a
job over the group's ranks:

- ``kernels.run_MCRT`` under an initialised group of world size W > 1:
  rank r runs :func:`job_share` of the job's photons on its own card with
  the generator of ``mesh.shard_seed(seed, r)`` (fixing the reference's
  un-offset MPI rank seeds, kernelsMod.f90:1846-1851);
- :func:`simulate_distributed`: every rank runs its local shards
  (:func:`global_mesh`, one card a process by default), seeded from the
  *global* shard index.

Both end in :func:`reduce_result`: the tallies, detector bins and photon
counts are all-reduced, so every rank ends with the reduced result (the
reference's replicated ``_reduce``).  The collectives run once, at the end
of the job: the communication shape of the reference's ``mpi_reduce``.

NCCL refuses two ranks on one device, so on a single card NCCL runs at
world size 1 only, and two processes sharing the card use gloo.  NCCL
across several cards, one process a card, is run by ``run_MCRT`` under a
group, which the benchmark's four-card cell ``sphere.fluence.x4`` drives.
"""

from __future__ import annotations

import math
import os
import time

import torch
import torch.distributed as tdist

from .. import obs
from ..transport.engine import TransportConfig
from .mesh import _check_sharded_cfg, make_mesh, reduce_runs, run_shards


def initialize(backend=None, init_method=None, world_size=None, rank=None,
               **kw):
    """``torch.distributed.init_process_group``: NCCL when a card is
    visible, gloo otherwise (or as ``backend`` says).  ``init_method``
    (e.g. ``tcp://localhost:29500``), ``world_size`` and ``rank`` are
    passed on; without them PyTorch reads ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    tdist.init_process_group(backend=backend, init_method=init_method,
                             world_size=world_size, rank=rank, **kw)


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", tdist.get_rank()))


def global_mesh() -> list:
    """This rank's local card: ``cuda:(local rank % visible cards)`` (the
    local rank from ``LOCAL_RANK``, else the global rank).  Raises when no
    card is visible: pass the mesh (e.g. ``[torch.device("cpu")]``) to
    run on the CPU."""
    cards = make_mesh()
    return [cards[_local_rank() % len(cards)]]


def comm_device(device) -> torch.device:
    """Where the collectives' tensors live for a rank running on
    ``device``: that card for NCCL, the host for gloo."""
    if tdist.get_backend() == "nccl":
        return torch.device(device)
    return torch.device("cpu")


def shared_rank():
    """``(rank, world)`` of the initialised process group that a job is
    shared over; None without one, or at world size 1."""
    if not (tdist.is_available() and tdist.is_initialized()):
        return None
    world = tdist.get_world_size()
    return (tdist.get_rank(), world) if world > 1 else None


def job_share(nphotons: int, rank: int, world: int) -> int:
    """Rank ``rank``'s photons of a job of ``nphotons`` shared over
    ``world`` ranks: the shares differ by at most one and add up to
    ``nphotons`` exactly."""
    return nphotons // world + (1 if rank < nphotons % world else 0)


def _all_reduce_(t: torch.Tensor, op, comm: torch.device) -> torch.Tensor:
    """All-reduce ``t`` in place through ``comm``'s memory."""
    if t.numel() == 0:
        return t
    if t.device == comm:
        tdist.all_reduce(t, op=op)
        return t
    buf = t.to(comm)
    tdist.all_reduce(buf, op=op)
    t.copy_(buf)
    return t


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reduce_result(tallies, bank, launched, steps, comm: torch.device):
    """One rank's part of a job all-reduced over the process group, in
    place: first ``steps`` with MAX, alone, so that its time is the wait
    for the slowest rank (span ``dist.wait``); then every tensor of
    ``tallies``, the detector bins of ``bank`` and ``launched`` with SUM
    (span ``dist.reduce``).  ``comm`` is :func:`comm_device`'s.  Each
    phase is timed on the host clock up to a synchronisation of ``comm``,
    into the counters ``dist.wait_ns`` and ``dist.reduce_ns``;
    ``dist.reduce_bytes`` adds the bytes the SUM carried,
    ``dist.jobs_shared`` one, and ``dist.world`` holds the world size.
    Returns ``(tallies, bank, launched, steps)``, the same on every
    rank."""
    t0 = time.perf_counter_ns()
    with obs.span("dist.wait"):
        _all_reduce_(steps, tdist.ReduceOp.MAX, comm)
        _sync(comm)
    t1 = time.perf_counter_ns()
    summed = [t for t in vars(tallies).values()
              if isinstance(t, torch.Tensor)]
    if bank is not None:
        summed += [fam.data for _, fam in bank.families()]
    summed.append(launched)
    with obs.span("dist.reduce"):
        for t in summed:
            _all_reduce_(t, tdist.ReduceOp.SUM, comm)
        _sync(comm)
    t2 = time.perf_counter_ns()
    obs.count("dist.jobs_shared")
    obs.counters["dist.world"] = tdist.get_world_size()
    obs.count("dist.wait_ns", t1 - t0)
    obs.count("dist.reduce_ns", t2 - t1)
    obs.count("dist.reduce_bytes",
              sum(t.numel() * t.element_size() for t in summed))
    return tallies, bank, launched, steps


def simulate_distributed(scene, source, grid, seed: int,
                         cfg: TransportConfig, bank=None, mesh=None,
                         chunk_steps: int = 16, nphotons=None,
                         progress=None):
    """The forward simulation photon-sharded over every rank's local
    shards (``mesh``, :func:`global_mesh` by default; every rank lists
    its own devices).  Global shard ``s`` runs ``ceil(n / n_shards)``
    photons with the generator of ``mesh.shard_seed(seed, s)``; the
    ranks' shards are numbered in rank order.  Refuses path history, as
    the reference does (distributed.py:66).

    Returns ``(tallies, bank, launched, steps)`` on ``mesh[0]``, the same
    on every rank, reduced by :func:`reduce_result`: tallies, detector
    bins and ``launched`` with SUM, steps with MAX."""
    _check_sharded_cfg(cfg)
    mesh = global_mesh() if mesh is None else make_mesh(mesh)
    comm = comm_device(mesh[0])
    world, rank = tdist.get_world_size(), tdist.get_rank()
    counts = torch.zeros(world, dtype=torch.int64, device=comm)
    counts[rank] = len(mesh)
    tdist.all_reduce(counts)
    counts = counts.tolist()
    first = sum(counts[:rank])
    n_target = int(cfg.nphotons if nphotons is None else nphotons)
    per_shard = math.ceil(n_target / sum(counts))
    runs = run_shards(scene, source, grid, seed, cfg, bank, mesh,
                      range(first, first + len(mesh)), per_shard,
                      chunk_steps, progress=progress)
    tallies, bank_out, launched, steps = reduce_runs(runs, mesh[0])
    return reduce_result(tallies, bank_out, launched, steps, comm)
