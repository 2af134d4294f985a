"""Optical properties (port of ``rsmcrt_tpu/optics/properties.py``;
reference: src/opticalProps/opticalProperties.f90).

``OptProps`` holds the four independent monochromatic quantities;
``SpectralOptProps`` holds a piecewise-1D table of each plus an emission
flux spectrum.  The derived kappa and albedo are formed per layer (and per
wavelength bin) by ``sdfs.scene.SceneTables``."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..grid import as_dtype
from .piecewise import Piecewise1D, sample_piecewise1d_at


@dataclass
class OptProps:
    """Monochromatic optical properties (reference ``mono`` type); values
    are Python floats rounded to the ``dtype`` :func:`mono` was given, or
    tensors (from :meth:`SpectralOptProps.at_wavelength`, or a caller's,
    which may require a gradient)."""

    mus: float
    mua: float
    hgg: float
    n: float


def mono(mus, mua, hgg, n, dtype=torch.float32) -> OptProps:
    """Each value rounded to ``dtype`` (float32 or float64), as the
    reference's ``jnp.asarray(v, dtype)``; a tensor is kept as it is."""
    def r(v):
        return v if isinstance(v, torch.Tensor) else as_dtype(v, dtype)

    return OptProps(r(mus), r(mua), r(hgg), r(n))


@dataclass
class SpectralOptProps:
    """Wavelength dependent optical properties (reference ``spectral``)."""

    mus_tab: Piecewise1D
    mua_tab: Piecewise1D
    hgg_tab: Piecewise1D
    n_tab: Piecewise1D
    flux: Piecewise1D

    def at_wavelength(self, wavelength) -> OptProps:
        """Every property resampled at ``wavelength`` (a tensor)
        (reference: opticalProperties.f90:171-201)."""
        return OptProps(
            mus=sample_piecewise1d_at(self.mus_tab, wavelength),
            mua=sample_piecewise1d_at(self.mua_tab, wavelength),
            hgg=sample_piecewise1d_at(self.hgg_tab, wavelength),
            n=sample_piecewise1d_at(self.n_tab, wavelength),
        )
