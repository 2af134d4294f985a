"""Helpers of the benchmark's CPU tests: a bench folder of one's own in a
temporary directory, built from files only, and a run on the CPU."""

import io
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent


def tiny_sphere(root: Path, limits: dict, photons=20000, ref=40000,
                max_steps=400, name="tiny.fluence", chips=1):
    """A cell of the default sphere on a 40^3 grid (10^3 tally bins), with
    the given limits, on ``chips`` ranks, under ``root``; returns the
    cell's name."""
    for sub in ("configs", "traffic", "workloads", "metrics"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    toml = (BENCH / "configs" / "default_sphere.toml").read_text()
    toml = toml.replace("nphotons = 1000000", f"nphotons = {photons}")
    for axis in "xyz":
        toml = toml.replace(f"n{axis}g = 200", f"n{axis}g = 40")
    (root / "configs" / "tiny_sphere.toml").write_text(toml)
    (root / "configs" / "tiny_sphere.json").write_text(json.dumps(
        {"source": "a test cut of perf_bench/configs/default_sphere.toml",
         "reduced": ["nphotons", "nxg", "nyg", "nzg"], "assumed": {}}))
    (root / "traffic" / "tiny.json").write_text(json.dumps(
        {"record_fluence": True, "max_steps": max_steps,
         "trace_from_megastep": 2, "trace_megasteps": 2}))
    (root / "workloads" / f"{name}.json").write_text(json.dumps(
        {"config": "tiny_sphere", "traffic": "tiny", "chips": chips,
         "why": "test", "block": [4, 4, 4], "reference_photons": ref,
         "reference_chunk": 65536, "limits": limits}))
    bench = root.parent / "BENCHMARK.json"
    if not bench.exists():
        bench.write_text(json.dumps({"end_to_end": [], "per_layer": []}))
    return name


def real_limits(cell: str) -> dict:
    return json.loads((BENCH / "workloads" / f"{cell}.json")
                      .read_text())["limits"]


def run_line(cell, root=BENCH, seconds=0.01, trace=False, seed=2**31 + 77,
             **kw):
    """``harness.run`` on the CPU: (exit code, parsed last line or None,
    standard error)."""
    from perf_bench import harness

    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(cell, seed, seconds, trace, device="cpu", root=root,
                     out=out, err=err, **kw)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
