"""Counterpart of ``tools/validateFibreDect.py``: fibre collection
efficiency.

    python -m rsmcrt_tpu_torch.tools.validate_fibre_dect [-n N] [--device cpu]

A fibre-lens detector with aperture a and focal length f collecting light
from an isotropic point source at the focal point has efficiency
0.5 * (1 - cos(atan(a / f))) (model: reference tools/validateFibreDect.py).
Six apertures (0.5 to 3.0) on one bank, a vacuum box, 64^3; each
aperture's efficiency must be within 5% of the formula here, within 12%
in the reference's test gate.  On the card by default.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import default_device
from ..detectors.detectors import DetectorBank, FibreDetectors, totals
from ..grid import cart_grid
from ..optics.properties import mono
from ..sdfs import scene as S
from ..sources.sources import build_source
from ..transport.engine import TransportConfig, simulate


def main(nphotons=200_000, device=None):
    """Returns ``(ok, tot, theory)``: whether every aperture is within 5%,
    the simulated efficiencies and the formula's, as numpy arrays."""
    device = torch.device(device) if device is not None else default_device()
    on_card = device.type == "cuda"
    focal = 2.0
    apertures = [0.5 * j for j in range(1, 7)]
    M = len(apertures)

    def arr(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    fibre = FibreDetectors(
        pos=arr([[0.0, 0.0, -focal]] * M),
        dir=arr([[0.0, 0.0, -1.0]] * M),
        focalLength1=arr([focal] * M),
        focalLength2=arr([focal] * M),
        f1Aperture=arr(apertures),
        f2Aperture=arr([100.0] * M),
        frontOffset=arr([0.0] * M),
        backOffset=arr([focal] * M),
        frontToPinSep=arr([focal] * M),
        pinToBackSep=arr([focal] * M),
        pinAperture=arr([100.0] * M),
        acceptAngle=arr([90.0] * M),
        coreDiameter=arr([1000.0] * M),
        bin_wid=arr([1.0] * M),
        data=torch.zeros((M, 2), dtype=torch.float32, device=device),
        nbins=1,
    )
    bank = DetectorBank(
        circle=None, annulus=None, fibre=fibre, camera=None,
        target_values=torch.full((M,), -1.0, device=device),
        order=tuple(("fibre", j) for j in range(M)),
        ids=tuple(f"f{j}" for j in range(M)),
        layers=(1,) * M,
    )
    # vacuum scene: point source, no scattering, huge grid
    scene = S.build_scene([
        S.box([20.0, 20.0, 20.0], mono(0.0, 1e-9, 0.0, 1.0), 1,
              device=device),
    ], device=device)
    grid = cart_grid(64, 64, 64, 10.0, 10.0, 10.0, device=device)
    src = build_source("point", device=device, position=[0.0, 0.0, 0.0])
    cfg = TransportConfig(nphotons=nphotons,
                          n_lanes=8192 if on_card else 2048)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    tallies, bank_out, launched, _ = simulate(scene, src, grid, gen, cfg,
                                              bank=bank)
    tot = (totals(bank_out) / int(launched)).double().cpu().numpy()
    theory = np.array([0.5 * (1 - np.cos(np.arctan(a / focal)))
                       for a in apertures])
    ok = True
    for j, a in enumerate(apertures):
        diff = abs(tot[j] - theory[j]) / theory[j] * 100
        print(f"aperture {a:.1f}: sim {tot[j]:.5f} theory {theory[j]:.5f} "
              f"(%diff {diff:.2f})")
        ok = ok and diff < 5.0
    print("PASS" if ok else "FAIL")
    return ok, tot, theory


if __name__ == "__main__":
    p = argparse.ArgumentParser(
        prog="rsmcrt_tpu_torch.tools.validate_fibre_dect")
    p.add_argument("-n", type=int, default=200_000, help="photons")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args()
    sys.exit(0 if main(nphotons=args.n, device=args.device)[0] else 1)
