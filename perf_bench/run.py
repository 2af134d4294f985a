"""The benchmark's command:

    python3 -m perf_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout.  Prints one JSON line (the last line of
standard output) and, last on standard error, each compared number beside
its limit.  Needs as many CUDA cards as the cell asks for; a cell on
several cards runs as one process a card (``ranks.py``).
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def _cache_dirs():
    """Kernel caches inside the checkout, at fixed paths, so that only a
    checkout's first run builds (the program's own kernel library goes to
    ``build/rsmcrt_tpu_torch/`` there)."""
    cache = CHECKOUT / "build" / "perf_bench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def main(argv=None) -> int:
    _cache_dirs()
    from perf_bench import cell

    a = cell.parse_args(argv, description=__doc__.split("\n\n")[0])
    found = cell.load_cell(a.workload)
    if found.chips > 1:
        # one process a card; this one imports no PyTorch
        from perf_bench import ranks

        return ranks.run(found, a.seed, a.seconds, bool(a.trace), "cuda",
                         T0, None, None, sys.stdout, sys.stderr)
    from perf_bench import harness

    return harness.run(a.workload, a.seed, a.seconds, bool(a.trace), t0=T0)


if __name__ == "__main__":
    sys.exit(main())
