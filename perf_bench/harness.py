"""The benchmark of ``rsmcrt_tpu_torch``: one run of one cell.

A cell is found by name, as files of its own (see ``README.md``):
``workloads/<cell>.json`` names its configuration and traffic and holds the
limits of its comparison; ``configs/<config>.toml`` is the frozen input the
program runs (its ``nphotons`` are a job's photons), ``configs/<config>.json``
its source and cuts; ``traffic/<traffic>.json`` how the jobs run;
``metrics/<metric>.py`` the reader of a per-layer metric, which
``BENCHMARK.json`` lists for the cell.

A run: set-up (parse the frozen config with ``kernels.setup``, load the
kernel library, ``engine.warmup`` at the lane width the program chooses for
the job), then a window
of whole ``kernels.run_MCRT`` jobs back to back until ``seconds`` have
passed (the last job finishes), then the plain reference, the comparison,
and one JSON line on standard output.  ``photons_per_s`` is every photon
of every job over the window.  With ``trace`` the window is counted and a
stretch of it profiled (:mod:`perf_bench.trace`), and the line carries the
cell's per-layer metrics instead of its end-to-end ones.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from . import compare
from .cell import ROOT, Cell, cell_metrics, clean, load_cell
from .reference import plainmc
from .trace import Tracer, breakdown, union_seconds, warm_profiler

MASK63 = (1 << 63) - 1


def load_reader(root: Path, metric: str):
    """The module ``metrics/<metric>.py`` (``LAYER``, ``MOVES``, ``UNIT``,
    ``read(trace)``)."""
    path = Path(root) / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"perf_bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mix(seed: int, k: int) -> int:
    """A 63-bit seed from the run's ``seed`` and a stream index
    (SplitMix64), so jobs and the reference draw unrelated numbers."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + (k + 1) * 0xBF58476D1CE4E5B9) \
        & ((1 << 64) - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (z ^ (z >> 31)) & MASK63


REFERENCE_STREAM = 1 << 40


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card_info(dev) -> dict:
    """The card's name and power limit (``nvidia-smi``), for the peaks'
    sake."""
    if dev.type != "cuda":
        return {"name": "cpu"}
    info = {"name": torch.cuda.get_device_name(dev)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(dev.index or 0)],
            capture_output=True, text=True, timeout=30, check=True).stdout
        info["power_limit_w"] = float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        info["power_limit_w"] = None
    return info


class _JobConfig(Exception):
    pass


def job_config(kernels, parsed, scene, **job):
    """The ``TransportConfig`` that ``kernels.run_MCRT(parsed, scene,
    **job)`` hands to ``simulate``, taken from the call itself."""
    seen = {}
    real = kernels.simulate

    def capture(scene_, source, grid, gen, cfg, **kw):
        seen["cfg"] = cfg
        raise _JobConfig

    kernels.simulate = capture
    try:
        kernels.run_MCRT(parsed, scene, **job)
    except _JobConfig:
        pass
    finally:
        kernels.simulate = real
    return seen["cfg"]


def binned(flat: torch.Tensor, counts, block) -> torch.Tensor:
    """A flat ``(x*ny + y)*nz + z`` voxel tally summed into blocks of
    ``block`` voxels, flattened the same way, in float64."""
    nx, ny, nz = counts
    bx, by, bz = block
    v = flat.double().reshape(nx // bx, bx, ny // by, by, nz // bz, bz)
    return v.sum(dim=(1, 3, 5)).reshape(-1)


def job_tallies(res, photons: int, max_steps: int, counts, block,
                fluence: bool) -> dict:
    """One job's outputs reduced to the reference's bins."""
    tl = res.tallies
    out = {"photons": photons, "launched": int(res.launched),
           "cut": int(res.steps) >= max_steps,
           "nscatt": float(tl.nscatt),
           "emission": binned(tl.emission, counts, block),
           "absorb": binned(tl.absorb, counts, block)}
    if fluence:
        out["jmean"] = binned(tl.jmean, counts, block)
    bank = res.bank
    if bank is not None:
        out["detector"] = torch.cat([
            getattr(bank, fam).data[m].reshape(-1).double()
            for fam, m in bank.order])
    return out


def reference_tallies(cell: Cell, seed: int, device, photons=None,
                      dtype=torch.float32, acc_dtype=torch.float64,
                      strict: bool = True, max_events: int = 20_000):
    """The plain reference's tallies for the cell at its reference photon
    count (or ``photons``), in ``dtype``, from its own stream of
    ``seed``."""
    w, cfg = cell.workload, cell.config
    scene = importlib.import_module(
        f"perf_bench.reference.{cfg['geometry']['geom_name']}").build(cfg)
    return plainmc.simulate(
        cfg, scene, int(photons or w["reference_photons"]),
        mix(seed, REFERENCE_STREAM), device=device, dtype=dtype,
        acc_dtype=acc_dtype, fluence=bool(cell.traffic["record_fluence"]),
        block=tuple(w["block"]), chunk=int(w["reference_chunk"]),
        strict=strict, max_events=max_events)


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", root: Path = ROOT, t0: float | None = None,
        photons: int | None = None, reference_photons: int | None = None,
        out=None, err=None) -> int:
    """One run of ``cell_name``: prints the result line to ``out`` and
    the compared numbers to ``err``; returns the exit code.  ``device``
    other than ``cuda`` (and ``photons``, ``reference_photons``) is for
    the CPU tests: the line then carries no metric.  A cell whose
    ``chips`` is N > 1 runs as N processes, one a card
    (:mod:`perf_bench.ranks`)."""
    t0 = time.perf_counter() if t0 is None else t0
    out = sys.stdout if out is None else out
    err = sys.stderr if err is None else err
    cell = load_cell(cell_name, root)
    chips = cell.chips
    on_card = device == "cuda"
    if on_card and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < chips):
        print(f"perf_bench: {cell_name} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=err)
        return 3
    if chips > 1:
        from . import ranks

        return ranks.run(cell, seed, seconds, trace, device, t0, photons,
                         reference_photons, out, err,
                         cpu_threads=torch.get_num_threads())
    return run_cell(cell, seed, seconds, trace,
                    torch.device("cuda:0" if on_card else device), t0,
                    photons, reference_photons, out, err)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, dev,
             t0: float, photons: int | None, reference_photons: int | None,
             out, err, group=None) -> int:
    """The run itself, on ``dev``.  With ``group`` (a
    :class:`perf_bench.group.Group`) this process is one rank of several:
    every rank sets up, meets the others, and runs the same jobs; rank 0
    alone traces, and once the ranks have exchanged their job counts and
    peaks it alone compares and prints."""
    lead = group is None or group.rank == 0
    on_card = dev.type == "cuda"

    from rsmcrt_tpu_torch import kernels
    from rsmcrt_tpu_torch.transport import engine

    traffic = cell.traffic
    n_job = int(photons or cell.config["source"]["nphotons"])
    fluence = bool(traffic["record_fluence"])
    max_steps = int(traffic["max_steps"])
    job = {"nphotons": n_job, "record_fluence": fluence,
           "max_steps": max_steps}

    # ---- set-up -------------------------------------------------------
    parsed, scene = kernels.setup(str(cell.toml), device=dev)
    cfg = job_config(kernels, parsed, scene, **job)
    gen = torch.Generator(device=dev)
    gen.manual_seed(mix(seed, REFERENCE_STREAM + 1))
    engine.warmup(scene, parsed.source, parsed.settings.grid, gen, cfg,
                  bank=parsed.detectors)
    if trace and on_card and lead:
        warm_profiler(dev)
    _sync(dev)
    if group is not None:
        group.barrier()
    setup_s = time.perf_counter() - t0

    # ---- window ---------------------------------------------------------
    tracer = Tracer(engine, int(traffic["trace_from_megastep"]),
                    int(traffic["trace_megasteps"]), profile=on_card) \
        if trace and lead else None
    results = []
    with tracer or contextlib.nullcontext():
        _sync(dev)
        start = time.perf_counter()
        while True:
            results.append(kernels.run_MCRT(
                parsed, scene, seed=mix(seed, len(results)), **job))
            more = time.perf_counter() - start < seconds
            if group is not None:
                more = group.decide(more)  # rank 0's clock decides
            if not more:
                break
        # run_MCRT synchronised; the ranks, in decide
        window_s = time.perf_counter() - start
    photons_done = sum(r.launched for r in results)
    job_steps = [int(r.steps) for r in results]
    job_s = [r.elapsed for r in results]
    ok = clean(err)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    by_rank = None
    if group is not None:
        # every rank's jobs, peak and look at sys.modules; leaves the group
        by_rank = group.exchange([len(results), peak, int(ok)])
        if not lead:
            return 0 if ok else 4
        ok = all(row[2] for row in by_rank)
        peak = max(row[1] for row in by_rank)
    if not ok:
        return 4
    counted = sum(job_steps)
    grid = plainmc.Grid.from_toml(cell.config, tuple(cell.workload["block"]))
    jobs = [job_tallies(r, n_job, max_steps, grid.counts, grid.block,
                        fluence) for r in results]
    del results
    layer_trace = tracer.trace(window_s, counted) if tracer else None
    if on_card:
        torch.cuda.empty_cache()

    # ---- the reference and the comparison ---------------------------------
    t_ref = time.perf_counter()
    ref = reference_tallies(cell, seed, dev, photons=reference_photons)
    _sync(dev)
    reference_s = time.perf_counter() - t_ref
    limits = cell.workload["limits"]
    per_job = [compare.job_numbers(j, ref) for j in jobs]
    failed = sum(not compare.judge(n, limits)[0] for n in per_job)
    correct, checks = compare.judge(compare.worst(per_job), limits)
    if by_rank is not None:
        jobs_by_rank = [row[0] for row in by_rank]
        differ = max(jobs_by_rank) - min(jobs_by_rank)
        checks["rank_jobs_differ"] = {"value": differ, "limit": 0}
        correct = correct and differ == 0

    # ---- the line ---------------------------------------------------------
    metrics, extra = {}, {}
    card = card_info(dev)
    device_rec = {"platform": "gpu" if on_card else "cpu",
                  "kind": card["name"],
                  "count": 1 if group is None else group.world,
                  "memory_peak_bytes": int(peak)}
    window = {"jobs": len(jobs), "photons": photons_done,
              "job_megasteps": job_steps, "job_s": job_s,
              "window_s": window_s, "photons_per_s": photons_done / window_s,
              "reference_s": reference_s, "seed": seed}
    if by_rank is not None:
        window.update(jobs_by_rank=jobs_by_rank,
                      memory_peak_bytes_by_rank=[row[1] for row in by_rank])
    if trace and layer_trace is not None:
        window.update(dispatched=layer_trace.dispatched, counted=counted,
                      stretch_s=layer_trace.stretch_s)
        readers = [(m, load_reader(cell.root, m["name"]))
                   for m in cell_metrics(cell, "per_layer")]
        if on_card:
            for m, reader in readers:
                v = reader.read(layer_trace)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            if layer_trace.device_ops:
                device_rec["busy_s"] = union_seconds(layer_trace.device_ops)
                device_rec["window_s"] = layer_trace.stretch_s
                extra["breakdown"] = breakdown(layer_trace.device_ops)
    elif on_card:
        values = {"photons_per_s": photons_done / window_s,
                  "setup_s": setup_s}
        for m in cell_metrics(cell, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    line = {"correct": correct, "attempted": len(jobs), "failed": failed,
            "metrics": metrics, "device": device_rec, **extra,
            "card": card, "window": window, "checks": checks}
    # the reference's scene and the metric readers have loaded since
    if not clean(err):
        return 4
    print(json.dumps(line), file=out, flush=True)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=err, flush=True)
    return 0
