"""The reference's analytic acceptance gates (tests/test_analytic_validation.py)
held on the port, through its validators under ``rsmcrt_tpu_torch/tools/``
on the CPU, at the reference tests' photon counts and gates (``-m slow``;
the van de Hulst slab is held by ``chip_smoke.py``'s detector slice and by
tests/test_torch_fluenceless.py):
- fibre collection efficiency: every aperture within 12% of
  0.5 (1 - cos atan(a/f)) at 60,000 photons;
- refractive-index-mismatch depth fluence: the two-exponential diffusion
  fit at R^2 > 0.90 at 50,000 photons."""

import numpy as np
import pytest

from rsmcrt_tpu_torch.tools import validate_fibre_dect, validate_ri_mismatch


@pytest.mark.slow
def test_fibre_collection_efficiency():
    ok, tot, theory = validate_fibre_dect.main(nphotons=60_000,
                                               device="cpu")
    rel = np.abs(tot - theory) / theory
    assert np.all(rel < 0.12), (tot, theory)


@pytest.mark.slow
def test_ri_mismatch_reflectance():
    r2 = validate_ri_mismatch.main(nphotons=50_000, device="cpu")
    assert r2 > 0.90, r2
