"""Photon sharding over processes (port of
``rsmcrt_tpu/parallel/distributed.py``).

Reference: the MPI rank reduction (src/kernelsMod.f90:2351-2357) -- every
rank simulates its share of the photon budget and the tally grids are
SUM-reduced to rank 0 at the end.  Here every process calls
:func:`initialize` (``torch.distributed``: NCCL between cards, gloo on
the CPU or for several processes sharing one card), runs its local shards
(:func:`global_mesh`, one card a process by default) with generators
seeded from the *global* shard index (fixing the reference's un-offset
MPI rank seeds, kernelsMod.f90:1846-1851), and the tallies, detector bins
and photon counts are all-reduced, so every rank ends with the reduced
result (the reference's replicated ``_reduce``).  The collectives run once,
at the end of the run: the communication shape of the reference's
``mpi_reduce``.

NCCL refuses two ranks on one device, so on a single card NCCL runs at
world size 1 only, and two processes sharing the card use gloo; NCCL
across several cards is untested.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as tdist

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


def _comm_device(mesh) -> torch.device:
    """Where the collectives' tensors live: the rank's card for NCCL, the
    host for gloo."""
    if tdist.get_backend() == "nccl":
        return mesh[0]
    return torch.device("cpu")


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
    on every rank: tallies and detector bins all-reduced with SUM,
    ``launched`` with SUM, steps with MAX."""
    _check_sharded_cfg(cfg)
    mesh = global_mesh() if mesh is None else make_mesh(mesh)
    comm = _comm_device(mesh)
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
    SUM, MAX = tdist.ReduceOp.SUM, tdist.ReduceOp.MAX
    for t in vars(tallies).values():
        if isinstance(t, torch.Tensor):
            _all_reduce_(t, SUM, comm)
    if bank_out is not None:
        for _, fam in bank_out.families():
            _all_reduce_(fam.data, SUM, comm)
    _all_reduce_(launched, SUM, comm)
    _all_reduce_(steps, MAX, comm)
    return tallies, bank_out, launched, steps
