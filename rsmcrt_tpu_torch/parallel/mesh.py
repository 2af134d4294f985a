"""Data parallelism over photons on the cards of one process (port of
``rsmcrt_tpu/parallel/mesh.py``).

The reference's only parallel axes were OpenMP threads over photons and an
MPI SUM-reduction of the tally grids at the end
(reference: src/kernelsMod.f90:1833-1892, :2351-2357).  Here a "mesh" is a
list of devices, one shard each: every shard runs the wavefront engine on
its own device with its own ``torch.Generator`` and ``ceil(nphotons /
n_shards)`` photons, and the tallies and detector bins are summed at the
end.  One device may appear more than once (several shards on one card).
Geometry, optical properties and the grid are copied to each device (they
are small); only the photon work divides.  The reference's per-rank RNG
was a latent bug (MPI rank seeds not offset, kernelsMod.f90:1846-1851);
here every shard's generator is seeded from ``(seed, shard index)``.

The shards are driven from one host loop (:class:`engine.SimRun`): each
round queues a chunk of megasteps on every shard before it synchronises
on any of them, so shards on different cards run together.  The host
waits on a card only to keep it at most ``engine.IN_FLIGHT`` megasteps
ahead, and then only once before it moves on to the next card.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from dataclasses import replace

import numpy as np
import torch

from ..transport.engine import SimRun, TransportConfig


def make_mesh(devices=None) -> list:
    """The shards' devices as a list of ``torch.device``: ``devices`` as
    given (names, indices or devices; one may repeat), or every visible
    card.  Raises when no list is given and no card is visible."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("no CUDA card is visible: pass the devices "
                               "(e.g. [\"cpu\", \"cpu\"]) to shard on the "
                               "CPU")
        return [torch.device("cuda", i) for i in range(n)]
    out = []
    for d in devices:
        d = torch.device("cuda", d) if isinstance(d, int) else torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    if not out:
        raise ValueError("the mesh needs at least one device")
    return out


def _check_sharded_cfg(cfg: TransportConfig):
    """History tracks are slot-indexed path buffers: summing them
    elementwise across shards is garbage.  :func:`simulate_sharded`
    therefore refuses them (as the reference's in-worker psum path does);
    :func:`simulate_sharded_chunked` instead gathers each shard's tracks
    at the reduce.  All other tallies -- including ``pmc_stats`` and the
    phasor -- are plain sums."""
    if cfg.history_len > 0 or cfg.max_tracks > 0:
        raise ValueError(
            "photon history tracks cannot be psum-reduced: use the "
            "chunked sharded driver (simulate_sharded_chunked), which "
            "gathers per-shard track buffers at the reduce"
        )


def shard_seed(seed: int, shard: int) -> int:
    """The generator seed of shard ``shard`` of a run seeded ``seed``:
    distinct for distinct shards, the same on every rerun."""
    words = np.random.SeedSequence([int(seed), int(shard)]).generate_state(
        2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def shard_generator(seed: int, shard: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(shard_seed(seed, shard))
    return gen


def to_device(obj, device, _memo=None):
    """A copy of ``obj`` (a scene, source, grid or detector bank: nested
    dataclasses, tuples, lists and dicts of tensors) with every tensor on
    ``device``; fields set in ``__post_init__`` are moved as they are."""
    memo = {} if _memo is None else _memo
    if id(obj) in memo:
        return memo[id(obj)]
    if isinstance(obj, torch.Tensor):
        out = obj.to(device)
    elif isinstance(obj, torch.device):
        out = torch.device(device)
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        out = type(obj)(*(to_device(v, device, memo) for v in obj))
    elif isinstance(obj, (list, tuple)):
        out = type(obj)(to_device(v, device, memo) for v in obj)
    elif isinstance(obj, dict):
        out = {k: to_device(v, device, memo) for k, v in obj.items()}
    elif (type(obj).__module__.startswith("rsmcrt_tpu_torch.")
          and hasattr(obj, "__dict__") and not isinstance(obj, type)
          and not callable(obj)):
        out = copy.copy(obj)
        for k, v in vars(obj).items():
            object.__setattr__(out, k, to_device(v, device, memo))
    else:
        out = obj
    memo[id(obj)] = out
    return out


def _on(device, scene, source, grid, bank):
    """``(scene, source, grid, bank)`` on ``device``: the originals when
    the scene already lies there."""
    here = scene.device
    if here.type == device.type and (here.index or 0) == (device.index or 0):
        return scene, source, grid, bank
    return tuple(None if x is None else to_device(x, device)
                 for x in (scene, source, grid, bank))


def run_shards(scene, source, grid, seed, cfg: TransportConfig, bank,
               devices, shard_ids, per_shard: int, chunk_steps: int = 16,
               progress=None) -> list:
    """One :class:`SimRun` of ``per_shard`` photons for each of
    ``devices``, shard ``shard_ids[i]`` on ``devices[i]``, driven to the
    end from one host loop: every round queues a chunk on each unfinished
    shard, in turns that stop at each card's run-ahead bound
    (:meth:`SimRun.launch`), then settles each.  Returns the runs."""
    runs = []
    for dev, sid in zip(devices, shard_ids):
        sc, src, g, bk = _on(dev, scene, source, grid, bank)
        runs.append(SimRun(sc, src, g, shard_generator(seed, sid, dev),
                           replace(cfg, nphotons=per_shard), bank=bk,
                           chunk_steps=chunk_steps))
    active = list(runs)
    while active:
        # a card at its run-ahead bound gives way to the others: each pass
        # waits on a card at most once, before its first megastep
        queuing = active
        while queuing:
            queuing = [r for r in queuing if not r.launch(wait=False)]
        for run in active:
            run.settle()
        active = [r for r in active if not r.done]
        if progress is not None:
            progress(sum(r.launched for r in runs),
                     per_shard * len(runs), max(r.step for r in runs),
                     [r.carry for r in runs])
    return runs


def _gathered_tracks(tallies_list, device):
    parts = [t.tracks[:int(t.track_count)].to(device)
             for t in tallies_list]
    return torch.cat(parts)


def reduce_tallies(tallies_list, device):
    """The shards' tallies summed on ``device``; kept tracks are
    gathered (concatenated in shard order), not summed."""
    first = tallies_list[0]
    out = {}
    for f in dataclasses.fields(first):
        vals = [getattr(t, f.name) for t in tallies_list]
        if f.name in ("tracks", "track_count") or vals[0] is None:
            continue
        out[f.name] = sum(v.to(device) for v in vals)
    tracks = _gathered_tracks(tallies_list, device)
    out["tracks"] = tracks
    out["track_count"] = torch.tensor(tracks.shape[0], dtype=torch.int32,
                                      device=device)
    return replace(first, **out)


def reduce_banks(banks, device):
    """The shards' detector banks as one on ``device``: the bins
    (``data``) summed, geometry and ``target_values`` from the first (the
    reference sums every leaf and divides the replicated ones back by the
    shard count, mesh.py:140-162)."""
    first = banks[0]
    if first is None:
        return None
    out = first.to(device)
    fams = {}
    for name, fam in out.families():
        data = sum(getattr(b, name).data.to(device) for b in banks)
        fams[name] = replace(fam, data=data)
    return replace(out, **fams)


def reduce_runs(runs, device):
    """``(tallies, bank, launched, steps)`` of the shards' runs, reduced
    on ``device``: every tally summed (the phasor, ``escape_tot`` and
    ``pmc_stats`` included), the tracks gathered, the detector bins
    summed, ``launched`` summed, steps taken as the largest (each shard
    compacts its own tail, so they end at different steps)."""
    res = [r.result() for r in runs]
    tallies = reduce_tallies([r[0] for r in res], device)
    bank = reduce_banks([r[1] for r in res], device)
    launched = torch.tensor(sum(int(r[2]) for r in res), dtype=torch.int32,
                            device=device)
    steps = torch.tensor(max(int(r[3]) for r in res), dtype=torch.int32,
                         device=device)
    return tallies, bank, launched, steps


def simulate_sharded_chunked(scene, source, grid, seed: int,
                             cfg: TransportConfig, bank=None, mesh=None,
                             chunk_steps: int = 16, progress=None,
                             nphotons=None):
    """The forward simulation photon-sharded over ``mesh`` (a list of
    devices, :func:`make_mesh`'s by default), driven chunk by chunk from
    one host loop: each round launches every shard's chunk before it
    synchronises on any.  Each shard runs ``ceil(n / n_shards)`` photons
    (``n`` = ``nphotons`` or ``cfg.nphotons``) on ``cfg.n_lanes`` lanes
    with the generator of :func:`shard_seed`.  Path history is drained
    from every shard each chunk and gathered at the end (the reference's
    mesh.py:209-259).  ``progress(launched, n, step, carries)`` is called
    every round.

    Returns ``(tallies, bank, launched, steps)`` on the first shard's
    device, reduced as :func:`reduce_runs` says."""
    mesh = make_mesh(mesh)
    n_target = int(cfg.nphotons if nphotons is None else nphotons)
    per_shard = math.ceil(n_target / len(mesh))
    runs = run_shards(scene, source, grid, seed, cfg, bank, mesh,
                      range(len(mesh)), per_shard, chunk_steps, progress)
    return reduce_runs(runs, mesh[0])


def simulate_sharded(scene, source, grid, seed: int, cfg: TransportConfig,
                     bank=None, mesh=None):
    """Run the forward simulation photon-sharded over ``mesh``; refuses
    path history (:func:`_check_sharded_cfg`), as the reference's
    in-worker psum path does.  The shards run as in
    :func:`simulate_sharded_chunked`, and the result is reduced the same
    way: ``(tallies, bank, launched, steps)``, every tally and detector
    bin summed over the shards."""
    _check_sharded_cfg(cfg)
    return simulate_sharded_chunked(scene, source, grid, seed, cfg,
                                    bank=bank, mesh=mesh)
