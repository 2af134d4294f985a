"""Interpolation helpers of the escape-function mapping (port of
``rsmcrt_tpu/maths/interpolate.py``; reference: src/interpolate.f90):
tri/bi/linear interpolation plus the cylindrical volume-weighted (tri) and
area-weighted (bi) variants, vectorised over leading batch axes.
Arguments may be tensors or NumPy arrays (converted to tensors)."""

from __future__ import annotations

import torch


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


def _frac(x0, x1, x):
    return (x - x0) / torch.where(x1 != x0, x1 - x0, 1.0)


def linear_interpolate(x0, x1, v0, v1, x):
    """reference: interpolate.f90:71-90"""
    x0, x1, v0, v1, x = _t(x0, x1, v0, v1, x)
    xd = _frac(x0, x1, x)
    return v0 * (1.0 - xd) + v1 * xd


def bilinear_interpolate(x0, x1, y0, y1, v00, v01, v10, v11, x, y):
    """v{ij} at (x_i, y_j) (reference: interpolate.f90:44-69)."""
    x0, x1, y0, y1, v00, v01, v10, v11, x, y = _t(
        x0, x1, y0, y1, v00, v01, v10, v11, x, y)
    xd = _frac(x0, x1, x)
    yd = _frac(y0, y1, y)
    c0 = v00 * (1.0 - xd) + v10 * xd
    c1 = v01 * (1.0 - xd) + v11 * xd
    return c0 * (1.0 - yd) + c1 * yd


def trilinear_interpolate(x0, x1, y0, y1, z0, z1, v, x, y, z):
    """``v[i, j, k]`` at the 8 corners as ``v[..., 2, 2, 2]``
    (reference: interpolate.f90:11-42)."""
    x0, x1, y0, y1, z0, z1, v, x, y, z = _t(
        x0, x1, y0, y1, z0, z1, v, x, y, z)
    xd = _frac(x0, x1, x)
    yd = _frac(y0, y1, y)
    zd = _frac(z0, z1, z)
    c00 = v[..., 0, 0, 0] * (1 - xd) + v[..., 1, 0, 0] * xd
    c01 = v[..., 0, 0, 1] * (1 - xd) + v[..., 1, 0, 1] * xd
    c10 = v[..., 0, 1, 0] * (1 - xd) + v[..., 1, 1, 0] * xd
    c11 = v[..., 0, 1, 1] * (1 - xd) + v[..., 1, 1, 1] * xd
    c0 = c00 * (1 - yd) + c10 * yd
    c1 = c01 * (1 - yd) + c11 * yd
    return c0 * (1 - zd) + c1 * zd


def _ring_weights(r0, r1, t0, t1, r, t):
    """The four area weights of a point (r, t) in an annular sector."""
    a00 = 0.5 * (t1 - t) * (r1**2 - r**2)  # low r, low t corner
    a01 = 0.5 * (t - t0) * (r1**2 - r**2)
    a10 = 0.5 * (t1 - t) * (r**2 - r0**2)
    a11 = 0.5 * (t - t0) * (r**2 - r0**2)
    return a00, a01, a10, a11


def cyl_bilinear_interpolate(r0, r1, t0, t1, v00, v01, v10, v11, r, t):
    """Area-weighted bilinear in (r, theta); v{ij} at (r_i, theta_j)
    (reference: interpolate.f90:140-177)."""
    r0, r1, t0, t1, v00, v01, v10, v11, r, t = _t(
        r0, r1, t0, t1, v00, v01, v10, v11, r, t)
    area = 0.5 * (t1 - t0) * (r1**2 - r0**2)
    safe = torch.where(area != 0.0, area, 1.0)
    a00, a01, a10, a11 = _ring_weights(r0, r1, t0, t1, r, t)
    return (a00 * v00 + a01 * v01 + a10 * v10 + a11 * v11) / safe


def cyl_trilinear_interpolate(r0, r1, t0, t1, z0, z1, v, r, t, z):
    """Volume-weighted trilinear in (r, theta, z); ``v[..., 2, 2, 2]``
    indexed [ri, ti, zi] (reference: interpolate.f90:92-138)."""
    r0, r1, t0, t1, z0, z1, v, r, t, z = _t(
        r0, r1, t0, t1, z0, z1, v, r, t, z)
    vol = 0.5 * (t1 - t0) * (r1**2 - r0**2) * (z1 - z0)
    safe = torch.where(vol != 0.0, vol, 1.0)
    a00, a01, a10, a11 = _ring_weights(r0, r1, t0, t1, r, t)
    out = (
        a00 * (z1 - z) * v[..., 0, 0, 0] + a00 * (z - z0) * v[..., 0, 0, 1]
        + a01 * (z1 - z) * v[..., 0, 1, 0] + a01 * (z - z0) * v[..., 0, 1, 1]
        + a10 * (z1 - z) * v[..., 1, 0, 0] + a10 * (z - z0) * v[..., 1, 0, 1]
        + a11 * (z1 - z) * v[..., 1, 1, 0] + a11 * (z - z0) * v[..., 1, 1, 1]
    )
    return out / safe
