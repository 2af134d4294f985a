"""Counterpart of ``tools/validateRIMismatch.py``: refractive-index-mismatch
depth fluence.

    python -m rsmcrt_tpu_torch.tools.validate_ri_mismatch [-n N] [--device cpu]

Runs a broad-beam slab simulation with an air/tissue refractive-index
mismatch and fits the simulated depth fluence with the published
two-exponential diffusion approximation

    phi(z) ~ c1 * exp(-k1 * z / delta) - c2 * exp(-k2 * z / delta)

with the n = 1.37 constants c1=5.76, k1=1.00, c2=1.31, k2=10.2 (model:
reference tools/validateRIMismatch.py); the acceptance is the fit's R^2.
delta = 1/sqrt(3 mua (mua + mus')) is the diffusion depth.  On the card by
default.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import default_device
from ..grid import cart_grid
from ..maths import transforms as T
from ..optics.properties import mono
from ..sdfs import scene as S
from ..sources.sources import build_source
from ..tally import as_volume, normalise_fluence
from ..transport.engine import TransportConfig, simulate


def main(nphotons=500_000, device=None, mua=1.0, mus=150.0, g=0.0, n=1.37):
    """Returns the R^2 of the diffusion fit to the central depth profile
    between 2 and 8 diffusion depths (> 0.95 expected at 5e5 photons)."""
    device = torch.device(device) if device is not None else default_device()
    on_card = device.type == "cuda"
    musp = mus * (1.0 - g)
    delta = 1.0 / np.sqrt(3.0 * mua * (mua + musp))

    # slab occupying z in [-1, 0.95], vacuum above; broad -z beam from the
    # top face so the transport is effectively 1-D in depth
    ztop = 0.95
    zc = (ztop - 1.0) / 2.0
    scene = S.build_scene([
        S.box([4.0, 4.0, 1.0 + ztop], mono(mus, mua, g, n), 1,
              transform=T.invert(T.translate([0.0, 0.0, zc])),
              device=device),
        S.box([4.2, 4.2, 4.0], mono(0.0, 0.0, 0.0, 1.0), 2, device=device),
    ], device=device)
    grid = cart_grid(40, 40, 400, 1.0, 1.0, 1.0, device=device)
    src = build_source(
        "uniform", device=device,
        point1=[-0.5, -0.5, ztop + 0.02],
        point2=[1.0, 0.0, 0.0],
        point3=[0.0, 1.0, 0.0],
        direction=[0.0, 0.0, -1.0],
    )
    cfg = TransportConfig(nphotons=nphotons,
                          n_lanes=16384 if on_card else 2048,
                          dda_substeps=16)
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    tallies, _, launched, _ = simulate(scene, src, grid, gen, cfg,
                                       min_lanes=256)
    flu = normalise_fluence(grid, as_volume(grid, tallies.jmean),
                            int(launched)).double().cpu().numpy()
    # central-region depth profile
    c = flu[10:30, 10:30, :].mean(axis=(0, 1))
    zs = np.linspace(-1.0, 1.0, 400, endpoint=False) + 1.0 / 400
    depth = ztop - zs  # depth below the slab surface
    sel = (depth > 2 * delta) & (depth < 8 * delta)
    model = (5.76 * np.exp(-1.00 * depth / delta)
             - 1.31 * np.exp(-10.2 * depth / delta))
    msel, csel = model[sel], c[sel]
    norm = (csel * msel).sum() / (msel * msel).sum()
    res = csel - norm * msel
    r2 = 1.0 - (res**2).sum() / ((csel - csel.mean())**2).sum()
    print(f"delta = {delta:.4f} cm; fit region {2*delta:.3f}.."
          f"{8*delta:.3f} cm; R^2 = {r2:.4f} (expect > 0.95)")
    return r2


if __name__ == "__main__":
    p = argparse.ArgumentParser(
        prog="rsmcrt_tpu_torch.tools.validate_ri_mismatch")
    p.add_argument("-n", type=int, default=500_000, help="photons")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args()
    main(nphotons=args.n, device=args.device)
