"""What the command needs before it touches a card, without PyTorch: its
arguments, a cell's files found by name (see ``README.md``), and the look
at ``sys.modules`` for JAX.  The process that takes a cell on several
cards imports nothing more (:mod:`perf_bench.ranks`)."""

from __future__ import annotations

import argparse
import json
import math
import sys
import tomllib
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rsmcrt_tpu")


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

    @property
    def chips(self) -> int:
        return int(self.workload.get("chips", 1))


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


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def clean(err) -> bool:
    """True when no forbidden module is loaded; else names them on
    ``err``."""
    found = forbidden_modules()
    if found:
        print(f"perf_bench: {found} imported in the benchmark's process",
              file=err)
    return not found


def parse_args(argv=None, description=None):
    """The command's arguments: ``--workload``, ``--seed``, ``--seconds``,
    ``--trace``."""
    p = argparse.ArgumentParser(prog="python3 -m perf_bench.run",
                                description=description)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    if not math.isfinite(a.seconds) or a.seconds <= 0:
        p.error("--seconds must be positive")
    return a
