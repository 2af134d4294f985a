"""Command line entry point (port of ``rsmcrt_tpu/cli.py``).

Usage::

    python -m rsmcrt_tpu_torch.cli res/sphere.toml
    python -m rsmcrt_tpu_torch.cli --device cpu --nphotons 4000 res/sphere.toml
    python -m rsmcrt_tpu_torch.cli --survival-bias res/validation1.toml
    python -m rsmcrt_tpu_torch.cli --kernel test res/scat_test2.toml
    python -m rsmcrt_tpu_torch.cli --kernel escape res/escape_test.toml
    python -m rsmcrt_tpu_torch.cli --kernel inverse res/inverse_test.toml
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
                    help="simulation kernel (reference app/main.f90 "
                         "compile flags)")
    ap.add_argument("--data-dir", default="data")
    ap.add_argument("--nphotons", type=int, default=None,
                    help="override photon count")
    ap.add_argument("--lanes", type=int, default=None,
                    help="wavefront width (defaults by device)")
    ap.add_argument("--survival-bias", action="store_true",
                    help="weighted packets + Russian roulette "
                         "(reference -DsurvivalBias)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch path)")
    args = ap.parse_args(argv)

    if args.kernel == "escape":
        from . import escape

        escape.escape_function(args.config, data_dir=args.data_dir,
                               n_lanes=args.lanes, device=args.device)
        return 0
    if args.kernel == "inverse":
        from . import inverse

        inverse.inverse_MCRT(args.config, data_dir=args.data_dir,
                             n_lanes=args.lanes, device=args.device)
        return 0

    from . import kernels

    if args.kernel == "test":
        out = kernels.test_kernel(args.config, nphotons=args.nphotons,
                                  n_lanes=args.lanes, device=args.device)
        print("nscatt/photon:", out["nscatt"])
        print("first moments:\n", out["moments1"])
        print("second moments:\n", out["moments2"])
        return 0
    kernels.default_MCRT(args.config, data_dir=args.data_dir,
                         nphotons=args.nphotons, n_lanes=args.lanes,
                         survival_bias=args.survival_bias,
                         device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
