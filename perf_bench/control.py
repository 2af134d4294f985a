"""Readings that the limits of ``correct`` are set from, run apart from
the benchmark's own runs:

    python3 -m perf_bench.control --workload <cell> --seeds 1,2,3 \
        [--jobs N] [--sides control,program] [--sum-dtype float64]

For each seed and side it runs the plain reference at the cell's
reference photon count, then ``--jobs`` jobs of that side: the control
(the reference itself in the program's place, computed in bfloat16, the
nearest precision below the configuration's float32, its sums too unless
``--sum-dtype`` says otherwise), or the program's own jobs exactly as a
run's window drives them (one set-up for all seeds).  Each prints one JSON
line: the seed, the side, every compared number (worst over the jobs) and
whether the cell's limits pass it.  A control walk that stalls on a
surface is cut after ``CONTROL_EVENTS`` events, its stragglers dropped.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback

import torch

from . import compare, harness
from .reference import plainmc


CONTROL_EVENTS = 5000


def control_jobs(cell, seed: int, jobs: int, device, photons=None,
                 dtype=torch.bfloat16, sum_dtype=None) -> list:
    """``jobs`` jobs of the reference in ``dtype`` (its sums in
    ``sum_dtype``, by default the same), as job tallies."""
    out = []
    n_job = int(photons or cell.config["source"]["nphotons"])
    for j in range(jobs):
        agg = harness.reference_tallies(
            cell, harness.mix(seed, j), device, photons=n_job, dtype=dtype,
            acc_dtype=sum_dtype or dtype, strict=False,
            max_events=CONTROL_EVENTS)
        job = {"photons": n_job, "launched": n_job, "cut": False}
        for name, a in agg.items():
            job[name] = a.sum.double()
        job["nscatt"] = float(job["nscatt"][0])
        if not cell.traffic["record_fluence"]:
            job.pop("jmean")
        out.append(job)
    return out


def program_jobs(cell, seed: int, jobs: int, prepared) -> list:
    """``jobs`` of the program's jobs of the cell, as a window runs them
    (set up once by :func:`prepare`)."""
    kernels, parsed, scene, job = prepared
    grid = plainmc.Grid.from_toml(cell.config, tuple(cell.workload["block"]))
    out = []
    for j in range(jobs):
        res = kernels.run_MCRT(parsed, scene, seed=harness.mix(seed, j),
                               **job)
        out.append(harness.job_tallies(res, job["nphotons"],
                                       job["max_steps"], grid.counts,
                                       grid.block, job["record_fluence"]))
    return out


def prepare(cell, device, photons=None):
    """The program set up for the cell's jobs, as a run's set-up does."""
    from rsmcrt_tpu_torch import kernels
    from rsmcrt_tpu_torch.transport import engine

    tr = cell.traffic
    job = {"nphotons": int(photons or cell.config["source"]["nphotons"]),
           "record_fluence": bool(tr["record_fluence"]),
           "max_steps": int(tr["max_steps"])}
    parsed, scene = kernels.setup(str(cell.toml), device=device)
    cfg = harness.job_config(kernels, parsed, scene, **job)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    engine.warmup(scene, parsed.source, parsed.settings.grid, gen, cfg,
                  bank=parsed.detectors)
    return kernels, parsed, scene, job


def readings(cell, seed: int, jobs: int, device, prepared=None,
             photons=None, reference_photons=None, sum_dtype=None) -> dict:
    """One line of readings: of the control, or of the program when
    ``prepared`` (:func:`prepare`) is given."""
    side = "control" if prepared is None else "program"
    ref = harness.reference_tallies(cell, seed, device,
                                    photons=reference_photons)
    line = {"cell": cell.name, "seed": seed, "side": side}
    try:
        made = (control_jobs(cell, seed, jobs, device, photons,
                             sum_dtype=sum_dtype)
                if prepared is None else
                program_jobs(cell, seed, jobs, prepared))
    except RuntimeError:
        line.update(numbers=None, correct=False,
                    error=traceback.format_exc(limit=1).strip()[-300:])
        return line
    numbers = compare.worst([compare.job_numbers(j, ref) for j in made])
    line.update(numbers=numbers,
                correct=compare.judge(numbers,
                                      cell.workload["limits"])[0])
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m perf_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    p.add_argument("--jobs", type=int, default=1)
    p.add_argument("--sides", default="control",
                   help="control, program or both, comma-separated")
    p.add_argument("--sum-dtype", default=None,
                   help="the control's sums (default: bfloat16 as its walk)")
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--photons", type=int, default=None)
    p.add_argument("--reference-photons", type=int, default=None)
    a = p.parse_args(argv)
    dev = torch.device(a.device)
    cell = harness.load_cell(a.workload)
    sides = a.sides.split(",")
    prepared = prepare(cell, dev, a.photons) if "program" in sides else None
    sum_dtype = getattr(torch, a.sum_dtype) if a.sum_dtype else None
    for seed in (int(s) for s in a.seeds.split(",")):
        for side in sides:
            line = readings(cell, seed, a.jobs, dev,
                            prepared if side == "program" else None,
                            a.photons, a.reference_photons, sum_dtype)
            if sum_dtype is not None and side == "control":
                line["sum_dtype"] = a.sum_dtype
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
