"""Command line entry point (port of ``rsmcrt_tpu/cli.py``).

Usage::

    python -m rsmcrt_tpu_torch.cli res/sphere.toml
    python -m rsmcrt_tpu_torch.cli --device cpu --nphotons 4000 res/sphere.toml
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="rsmcrt_tpu_torch",
        description="Signed-distance-field Monte Carlo radiation transfer "
                    "(PyTorch / CUDA port)")
    ap.add_argument("config", nargs="?", default="default.toml",
                    help="TOML parameter file")
    ap.add_argument("--kernel", default="default",
                    choices=["default", "test", "escape", "inverse"],
                    help="simulation kernel (only 'default' is ported)")
    ap.add_argument("--data-dir", default="data")
    ap.add_argument("--nphotons", type=int, default=None,
                    help="override photon count")
    ap.add_argument("--lanes", type=int, default=None,
                    help="wavefront width (defaults by device)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch path)")
    args = ap.parse_args(argv)
    if args.kernel != "default":
        raise NotImplementedError(
            f"the {args.kernel!r} kernel is not ported (ROADMAP queue 1, "
            "items 10 and 12)")

    from .kernels import default_MCRT

    default_MCRT(args.config, data_dir=args.data_dir,
                 nphotons=args.nphotons, n_lanes=args.lanes,
                 device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
