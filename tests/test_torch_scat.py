"""The reference's scattering law through the port's entry points:
a point source in a tau = 10 sphere scatters tau^2/2 + tau = 57.5 times
per photon (res/scat_test.toml; reference test/end_to_end/test_scat.f90).

The reference's threshold is 0.5 at 1e5 photons; at 20,000 photons on a
32^3 grid (the grid does not enter nscatt) it is widened to 1.0, as
``tests/test_e2e_physics.py`` widens it (standard error ~0.3).
"""

import re

import torch

import rsmcrt_tpu_torch.kernels as tk

torch.set_num_threads(1)


def test_scat_test_nscatt(tmp_path):
    text = open("res/scat_test.toml").read()
    text = re.sub(r"n([xyz])g = 200", r"n\1g = 32", text)
    toml = tmp_path / "scat_small.toml"
    toml.write_text(text)
    parsed, scene = tk.setup(toml, device="cpu")
    res = tk.run_MCRT(parsed, scene, nphotons=20_000, n_lanes=4096)
    assert res.launched == 20_000
    assert abs(res.nscatt_per_photon - 57.5) < 1.0, res.nscatt_per_photon
    # no absorber: every launched photon's weight leaves the sphere
    assert float(res.tallies.absorb.sum()) == 0.0
