"""Worker for tests/test_torch_run_mcrt_ranks.py: one process running
``kernels.run_MCRT`` on the CPU.  Invoked as

    python torch_run_mcrt_ranks_worker.py <mode> <rank> <world> <port> \
        <toml> <nphotons> <seed> <outfile>

``shared``: rank ``rank`` of a gloo group of ``world`` ranks runs two jobs
(seeds ``seed`` and ``seed + 1``) with spans on, and writes what each job
handed to ``simulate`` and returned, the ``dist.*`` counters and the
parents of the ``dist.*`` spans.  ``alone``: one job with no group, the
same job by ``engine.simulate`` seeded as before jobs were shared, then
the job again in a gloo group of one, counting the collectives."""

import sys

import numpy as np
import torch
import torch.distributed as tdist

from rsmcrt_tpu_torch import kernels, obs
from rsmcrt_tpu_torch.parallel import distributed as D
from rsmcrt_tpu_torch.transport import engine

mode, rank, world, port, toml, n, seed, out = sys.argv[1:]
rank, world, n, seed = int(rank), int(world), int(n), int(seed)
torch.set_num_threads(1)

seen = []  # (photons, lanes, generator seed) of each simulate call
real_simulate = kernels.simulate


def simulate(scene, source, grid, gen, cfg, **kw):
    seen.append((cfg.nphotons, cfg.n_lanes, gen.initial_seed()))
    return real_simulate(scene, source, grid, gen, cfg, **kw)


kernels.simulate = simulate


def tensors(prefix, res):
    return {f"{prefix}{k}": v.numpy() for k, v in vars(res.tallies).items()
            if isinstance(v, torch.Tensor)}


def job_record(prefix, res):
    return {f"{prefix}launched": res.launched, f"{prefix}steps": res.steps,
            **tensors(f"{prefix}tl_", res)}


def init(size, r):
    D.initialize(backend="gloo", init_method=f"tcp://localhost:{port}",
                 world_size=size, rank=r)


parsed, scene = kernels.setup(toml, device="cpu")
rec = {}
if mode == "shared":
    init(world, rank)
    obs.enable()
    for j in range(2):
        rec.update(job_record(f"job{j}_", kernels.run_MCRT(
            parsed, scene, nphotons=n, seed=seed + j)))
    snap = obs.snapshot()
    names = {s["id"]: s["name"] for s in snap["spans"]}
    dist_spans = [(s["name"], names.get(s["parent"], ""))
                  for s in snap["spans"] if s["name"].startswith("dist.")]
    rec.update(
        rank=tdist.get_rank(), world=tdist.get_world_size(),
        spans=np.array([f"{a}<{b}" for a, b in dist_spans]),
        **{f"counter_{k}": v for k, v in snap["counters"].items()
           if k.startswith("dist.")})
    tdist.destroy_process_group()
else:
    alone = kernels.run_MCRT(parsed, scene, nphotons=n, seed=seed)
    cfg_seen = []
    kernels.simulate = lambda *a, **kw: (cfg_seen.append(a[4]),
                                         simulate(*a, **kw))[1]
    kernels.run_MCRT(parsed, scene, nphotons=n, seed=seed)
    kernels.simulate = simulate
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    tl, _, launched, steps = engine.simulate(
        scene, parsed.source, parsed.settings.grid, gen, cfg_seen[0],
        bank=parsed.detectors)
    rec.update(job_record("alone_", alone))
    rec.update(before_launched=int(launched), before_steps=int(steps),
               **{f"before_tl_{k}": v.numpy() for k, v in vars(tl).items()
                  if isinstance(v, torch.Tensor)})
    init(1, 0)
    collectives = []
    real_all_reduce = tdist.all_reduce
    tdist.all_reduce = lambda *a, **kw: (collectives.append(1),
                                         real_all_reduce(*a, **kw))[1]
    rec.update(job_record("group1_", kernels.run_MCRT(
        parsed, scene, nphotons=n, seed=seed)))
    tdist.all_reduce = real_all_reduce
    rec.update(collectives=len(collectives),
               dist_counters=len([k for k in obs.counters
                                  if k.startswith("dist.")]))
    tdist.destroy_process_group()
rec["seen"] = np.array(seen, dtype=np.int64)
np.savez(out, **rec)
