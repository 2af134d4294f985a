"""Spectrum samplers (port of ``rsmcrt_tpu/optics/piecewise.py``;
reference: src/opticalProps/piecewise.f90).

- ``Constant``: a single value.
- ``Piecewise1D``: an x/y table with a trapezoid-rule CDF; inverse-CDF
  sampling with linear interpolation, and the y value at given x.
- ``Piecewise2D``: image sampling over a row-major CDF of the flattened
  image (the reference's Morton-order CDF is a CPU cache trick with the
  same statistics).

The CDFs are built on the host in float64 and stored as float32 tensors,
as the JAX package stores them; ``.to(device, dtype)`` gives a float64
run's copy.  Every sampler takes a batch of uniforms
``[B]`` and searches the CDF with ``torch.searchsorted``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Constant:
    value: torch.Tensor  # 0-d float32

    def to(self, device, dtype=None) -> "Constant":
        return Constant(self.value.to(device, dtype))


@dataclass
class Piecewise1D:
    """x/y table with its CDF (reference: piecewise.f90:142-168)."""

    x: torch.Tensor  # [n]
    y: torch.Tensor  # [n]
    cdf: torch.Tensor  # [n], cdf[0] = 0, cdf[-1] = 1

    def to(self, device, dtype=None) -> "Piecewise1D":
        return Piecewise1D(self.x.to(device, dtype), self.y.to(device, dtype),
                           self.cdf.to(device, dtype))


@dataclass
class Piecewise2D:
    """Image sampler (reference: piecewise.f90:64-76, :171-244)."""

    cdf: torch.Tensor  # [h*w] flattened row-major CDF
    width: int
    height: int
    cell_width: torch.Tensor  # 0-d float32
    cell_height: torch.Tensor

    def to(self, device, dtype=None) -> "Piecewise2D":
        return Piecewise2D(self.cdf.to(device, dtype), self.width,
                           self.height, self.cell_width.to(device, dtype),
                           self.cell_height.to(device, dtype))


def _trapz_cdf(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Normalised trapezoid-rule CDF; an all-zero table (a property curve
    read only by y-at-x) keeps a finite CDF."""
    seg = 0.5 * (y[1:] + y[:-1]) * np.diff(x)
    cdf = np.concatenate([[0.0], np.cumsum(seg)])
    return cdf / max(cdf[-1], 1e-300)


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _search(table: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Insertion points of ``v`` after equal entries (the JAX package's
    ``searchsorted(side="right")``)."""
    return torch.searchsorted(table, v.contiguous(), right=True)


def piecewise1d(array, device="cpu") -> Piecewise1D:
    """Build from an ``(n, 2)`` array: column 0 = x, column 1 = y."""
    array = np.asarray(array, dtype=np.float64)
    if array.ndim != 2 or array.shape[1] != 2:
        raise ValueError("Array must be size (n, 2)")
    x, y = array[:, 0], array[:, 1]
    return Piecewise1D(x=_f32(x, device), y=_f32(y, device),
                       cdf=_f32(_trapz_cdf(x, y), device))


def sample_piecewise1d(tab: Piecewise1D, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF samples of x for uniforms ``u`` in [0, 1)
    (reference: piecewise.f90:124-131)."""
    idx = torch.clamp(_search(tab.cdf, u) - 1, 0, tab.cdf.shape[0] - 2)
    c0, c1 = tab.cdf[idx], tab.cdf[idx + 1]
    x0, x1 = tab.x[idx], tab.x[idx + 1]
    frac = (u - c0) / torch.where(c1 > c0, c1 - c0, 1.0)
    return x0 + frac * (x1 - x0)


def sample_piecewise1d_at(tab: Piecewise1D, x: torch.Tensor) -> torch.Tensor:
    """The y value at ``x`` by linear interpolation
    (reference: piecewise.f90:133-137)."""
    idx = torch.clamp(_search(tab.x, x) - 1, 0, tab.x.shape[0] - 2)
    x0, x1 = tab.x[idx], tab.x[idx + 1]
    y0, y1 = tab.y[idx], tab.y[idx + 1]
    frac = (x - x0) / torch.where(x1 > x0, x1 - x0, 1.0)
    return y0 + frac * (y1 - y0)


def piecewise2d(cell_width: float, cell_height: float, image,
                device="cpu") -> Piecewise2D:
    """A 2D sampler of ``image`` (``[width, height]``), over its row-major
    flattened CDF."""
    image = np.asarray(image, dtype=np.float64)
    if not np.any(image > 0.0):
        raise ValueError(
            "piecewise2d image has no positive intensity: cannot build a "
            "sampling CDF (blank spectrum/SLM image)")
    cdf = np.cumsum(image.reshape(-1))
    return Piecewise2D(cdf=_f32(cdf / cdf[-1], device),
                       width=image.shape[0], height=image.shape[1],
                       cell_width=_f32(cell_width, device),
                       cell_height=_f32(cell_height, device))


def sample_piecewise2d(tab: Piecewise2D, u: torch.Tensor, ux: torch.Tensor,
                       uy: torch.Tensor):
    """Pixel coordinates: ``u`` picks the pixel from the CDF, ``ux, uy``
    jitter within the cell by ``(2u - 1) * cell`` (reference:
    piecewise.f90:171-190)."""
    idx = torch.clamp(_search(tab.cdf, u), 0, tab.cdf.shape[0] - 1)
    xr = torch.div(idx, tab.height, rounding_mode="floor").to(torch.float32)
    yr = torch.remainder(idx, tab.height).to(torch.float32)
    x = xr + (2.0 * ux - 1.0) * tab.cell_width
    y = yr + (2.0 * uy - 1.0) * tab.cell_height
    return x, y
