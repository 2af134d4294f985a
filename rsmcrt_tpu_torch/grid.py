"""Uniform cartesian tally grid (port of ``rsmcrt_tpu/grid.py``).

Voxel lookup and wall distances are closed-form.  The grid keeps its half
extents as Python floats rounded to its ``dtype`` (float32 unless a
float64 run asks for more) and caches the derived per-axis tensors (half
extent, voxel size, counts) in that type on its device, so the transport
loop does not rebuild them every call.  Derived scalars are computed in
the grid's type, as the JAX package computes them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


def f32(x) -> float:
    """``x`` rounded to float32, as a Python float (exact in a float32
    tensor op)."""
    return float(np.float32(x))


def as_dtype(x, dtype) -> float:
    """``x`` rounded to ``dtype`` (float32 or float64), as a Python float:
    a constant the reference forms as ``jnp.asarray(x, dtype)``."""
    return f32(x) if dtype == torch.float32 else float(x)


def np_dtype(dtype):
    """The NumPy type of a torch float type."""
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]


@dataclass
class CartGrid:
    """Uniform cartesian grid, half extents (xmax, ymax, zmax), voxel counts
    (nxg, nyg, nzg) (reference: src/grid.f90:14-29), in ``dtype``."""

    xmax: float
    ymax: float
    zmax: float
    nxg: int
    nyg: int
    nzg: int
    device: torch.device = torch.device("cpu")
    dtype: torch.dtype = torch.float32
    half_extent: torch.Tensor = field(init=False, repr=False)
    voxel_size: torch.Tensor = field(init=False, repr=False)
    n_counts: torch.Tensor = field(init=False, repr=False)
    _counts_f: torch.Tensor = field(init=False, repr=False)
    _two_half: torch.Tensor = field(init=False, repr=False)

    def __post_init__(self):
        ft = np_dtype(self.dtype)
        self.xmax, self.ymax, self.zmax = (
            float(ft(self.xmax)), float(ft(self.ymax)), float(ft(self.zmax)))
        self.nxg, self.nyg, self.nzg = (
            int(self.nxg), int(self.nyg), int(self.nzg))
        self.device = torch.device(self.device)
        half = np.asarray([self.xmax, self.ymax, self.zmax], ft)
        counts = np.asarray(self.shape, np.int32)
        dv = ft(2.0) * half / counts.astype(ft)
        dev = self.device
        self.half_extent = torch.as_tensor(half, device=dev)
        self.voxel_size = torch.as_tensor(dv, device=dev)
        self.n_counts = torch.as_tensor(counts, device=dev)
        self._counts_f = torch.as_tensor(counts.astype(ft), device=dev)
        self._two_half = torch.as_tensor(ft(2.0) * half, device=dev)

    @property
    def shape(self):
        return (self.nxg, self.nyg, self.nzg)

    @property
    def n_cells(self) -> int:
        return self.nxg * self.nyg * self.nzg


def cart_grid(nxg, nyg, nzg, xmax, ymax, zmax, dtype=torch.float32,
              device="cpu") -> CartGrid:
    return CartGrid(xmax, ymax, zmax, nxg, nyg, nzg, device=device,
                    dtype=dtype)


def get_voxel(grid: CartGrid, pos: torch.Tensor) -> torch.Tensor:
    """0-based int32 voxel index ``[..., 3]``; -1 on any axis means outside
    (reference get_voxel_cart, src/grid.f90:51-78)."""
    counts = grid.n_counts
    idx = torch.floor(
        grid._counts_f * (pos + grid.half_extent) / grid._two_half
    ).to(torch.int32)
    bad = (idx < 0) | (idx >= counts)
    return torch.where(bad, -1, idx)


def voxel_flat_index(grid: CartGrid, idx: torch.Tensor):
    """Flatten ``[..., 3]`` voxel indices to int32 ``(x*ny + y)*nz + z``;
    invalid voxels map to index 0 with a False mask returned alongside."""
    valid = torch.all(idx >= 0, dim=-1)
    safe = torch.clamp(idx, min=0)
    flat = (safe[..., 0] * grid.nyg + safe[..., 1]) * grid.nzg + safe[..., 2]
    return torch.where(valid, flat, 0), valid


def wall_distance(grid: CartGrid, pos: torch.Tensor,
                  direction: torch.Tensor) -> torch.Tensor:
    """Distance along ``direction`` to the nearest voxel wall
    (reference wall_dist, src/inttau2.f90:467-521)."""
    dv = grid.voxel_size
    pc = pos + grid.half_extent  # corner-origin coordinates
    cell = torch.floor(pc / dv)
    safe_d = torch.where(direction == 0.0, 1.0, direction)
    d_pos = ((cell + 1.0) * dv - pc) / safe_d
    d_neg = (cell * dv - pc) / safe_d
    d = torch.where(direction > 0.0, d_pos,
                    torch.where(direction < 0.0, d_neg, 1e5))
    d = torch.clamp(d, min=0.0)
    return torch.amin(d, dim=-1)


@dataclass
class CylGrid:
    """Cylindrical grid of the escape function's symmetry
    (reference: src/grid.f90:31-43): radius ``rmax`` and half height
    ``zmax`` (rounded to ``dtype``), counts ``(nrg, ntg, nzg)``; theta
    spans ``2 pi`` whatever the config says (src/grid.f90:173)."""

    rmax: float
    zmax: float
    nrg: int
    ntg: int
    nzg: int
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        self.rmax = as_dtype(self.rmax, self.dtype)
        self.zmax = as_dtype(self.zmax, self.dtype)
        self.nrg, self.ntg, self.nzg = (
            int(self.nrg), int(self.ntg), int(self.nzg))

    @property
    def tmax(self) -> float:
        return as_dtype(2.0 * np.pi, self.dtype)

    @property
    def shape(self):
        return (self.nrg, self.ntg, self.nzg)


def cyl_grid(nrg, ntg, nzg, rmax, tmax, zmax,
             dtype=torch.float32) -> CylGrid:
    """``tmax`` is accepted as the reference accepts it and forced to
    ``2 pi``."""
    del tmax
    return CylGrid(rmax, zmax, nrg, ntg, nzg, dtype=dtype)


def get_voxel_cyl(grid: CylGrid, pos: torch.Tensor) -> torch.Tensor:
    """0-based int32 ``(r, theta, z)`` voxel index ``[..., 3]``, -1 on any
    axis outside (reference get_voxel_cyl, src/grid.f90:80-117)."""
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    twopi = grid.tmax
    rad = torch.sqrt(x * x + y * y)
    theta = torch.where(rad == 0.0, 0.0, torch.atan2(y, x))
    theta = torch.where(theta < 0.0, theta + twopi, theta)
    ir = torch.floor(grid.nrg * rad / grid.rmax)
    it = torch.floor(grid.ntg * theta / grid.tmax)
    iz = torch.floor(grid.nzg * (z + grid.zmax) / (2.0 * grid.zmax))
    idx = torch.stack([ir, it, iz], dim=-1).to(torch.int32)
    counts = torch.tensor(grid.shape, dtype=torch.int32, device=pos.device)
    return torch.where((idx < 0) | (idx >= counts), -1, idx)
