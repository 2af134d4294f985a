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
import math
import subprocess
import sys
import time
import tomllib
from dataclasses import dataclass
from pathlib import Path

import torch

from . import compare
from .reference import plainmc
from .trace import Tracer, breakdown, union_seconds, warm_profiler

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rsmcrt_tpu")
MASK63 = (1 << 63) - 1


@dataclass
class Cell:
    name: str
    workload: dict
    traffic: dict
    toml: Path
    meta: dict
    root: Path

    @property
    def config(self) -> dict:
        with open(self.toml, "rb") as f:
            return tomllib.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` from the files under ``root``."""
    root = Path(root)
    w = json.loads((root / "workloads" / f"{name}.json").read_text())
    traffic = json.loads((root / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    meta = json.loads((root / "configs" / f"{w['config']}.json").read_text())
    return Cell(name, w, traffic, root / "configs" / f"{w['config']}.toml",
                meta, root)


def benchmark_file(root: Path = ROOT) -> dict:
    return json.loads((Path(root).parent / "BENCHMARK.json").read_text())


def cell_metrics(cell: Cell, kind: str) -> list:
    """``BENCHMARK.json``'s ``end_to_end`` or ``per_layer`` entries that
    this cell reports."""
    return [m for m in benchmark_file(cell.root)[kind]
            if cell.name in m.get("workloads", [cell.name])]


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


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _clean(err) -> bool:
    """True when no forbidden module is loaded; else names them on
    ``err``."""
    found = forbidden_modules()
    if found:
        print(f"perf_bench: {found} imported in the benchmark's process",
              file=err)
    return not found


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
    the CPU tests: the line then carries no metric."""
    t0 = time.perf_counter() if t0 is None else t0
    out = sys.stdout if out is None else out
    err = sys.stderr if err is None else err
    cell = load_cell(cell_name, root)
    chips = int(cell.workload.get("chips", 1))
    on_card = device == "cuda"
    if on_card and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < chips):
        print(f"perf_bench: {cell_name} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=err)
        return 3
    dev = torch.device("cuda:0" if on_card else device)

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
    if trace and on_card:
        warm_profiler(dev)
    _sync(dev)
    setup_s = time.perf_counter() - t0

    # ---- window ---------------------------------------------------------
    tracer = Tracer(engine, int(traffic["trace_from_megastep"]),
                    int(traffic["trace_megasteps"]), profile=on_card) \
        if trace else None
    results = []
    with tracer or contextlib.nullcontext():
        _sync(dev)
        start = time.perf_counter()
        while True:
            results.append(kernels.run_MCRT(
                parsed, scene, seed=mix(seed, len(results)), **job))
            if time.perf_counter() - start >= seconds:
                break
        window_s = time.perf_counter() - start  # run_MCRT synchronised
    photons_done = sum(r.launched for r in results)
    job_steps = [int(r.steps) for r in results]
    job_s = [r.elapsed for r in results]
    if not _clean(err):
        return 4
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
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

    # ---- the line ---------------------------------------------------------
    metrics, extra = {}, {}
    card = card_info(dev)
    device_rec = {"platform": "gpu" if on_card else "cpu",
                  "kind": card["name"], "count": chips,
                  "memory_peak_bytes": int(peak)}
    window = {"jobs": len(jobs), "photons": photons_done,
              "job_megasteps": job_steps, "job_s": job_s,
              "window_s": window_s, "photons_per_s": photons_done / window_s,
              "reference_s": reference_s, "seed": seed}
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
    if not _clean(err):
        return 4
    print(json.dumps(line), file=out, flush=True)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=err, flush=True)
    return 0


def main(argv=None, t0: float | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="python3 -m perf_bench.run",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    if not math.isfinite(a.seconds) or a.seconds <= 0:
        p.error("--seconds must be positive")
    return run(a.workload, a.seed, a.seconds, bool(a.trace), t0=t0)
