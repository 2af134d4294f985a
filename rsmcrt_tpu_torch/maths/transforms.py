"""Homogeneous 4x4 transform helpers (port of
``rsmcrt_tpu/maths/transforms.py``; reference:
src/sdfs/sdfHelpers.f90:23-183).

Convention: a point ``p`` is transformed as the row-vector product
``[x, y, z, 1] @ M`` -- translations live in row 3 of the matrix.  SDFs
store the *inverse* of the world transform (scenes call
``invert(translate(pos))``, reference: src/setupGeometry.f90:64).  Angles
are in degrees, as in the reference; matrices are float32 unless asked
otherwise.
"""

from __future__ import annotations

import math

import torch


def deg2rad(angle, dtype=torch.float32, device="cpu") -> torch.Tensor:
    return torch.as_tensor(angle, dtype=dtype, device=device) * (
        math.pi / 180.0)


def _rows(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r) for r in rows])


def rotate_x(angle, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Rotation about x by ``angle`` degrees (sdfHelpers.f90:23-41)."""
    a = deg2rad(angle, dtype, device)
    c, s = torch.cos(a), torch.sin(a)
    z, one = torch.zeros_like(c), torch.ones_like(c)
    return _rows([[one, z, z, z], [z, c, s, z], [z, -s, c, z],
                  [z, z, z, one]])


def rotate_y(angle, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Rotation about y by ``angle`` degrees (sdfHelpers.f90:43-62)."""
    a = deg2rad(angle, dtype, device)
    c, s = torch.cos(a), torch.sin(a)
    z, one = torch.zeros_like(c), torch.ones_like(c)
    return _rows([[c, z, -s, z], [z, one, z, z], [s, z, c, z],
                  [z, z, z, one]])


def rotate_z(angle, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Rotation about z by ``angle`` degrees (sdfHelpers.f90:64-83)."""
    a = deg2rad(angle, dtype, device)
    c, s = torch.cos(a), torch.sin(a)
    z, one = torch.zeros_like(c), torch.ones_like(c)
    return _rows([[c, s, z, z], [-s, c, z, z], [z, z, one, z],
                  [z, z, z, one]])


def rotmat(axis, angle, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Axis-angle rotation, angle in degrees (sdfHelpers.f90:85-112)."""
    axis = torch.as_tensor(axis, dtype=dtype, device=device)
    u = axis / torch.linalg.vector_norm(axis)
    a = deg2rad(angle, dtype, device)
    s, c = torch.sin(a), torch.cos(a)
    oc = 1.0 - c
    x, y, z = u[0], u[1], u[2]
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return _rows([
        [oc * x * x + c, oc * x * y + z * s, oc * z * x - y * s, zero],
        [oc * x * y - z * s, oc * y * y + c, oc * y * z + x * s, zero],
        [oc * z * x + y * s, oc * y * z - x * s, oc * z * z + c, zero],
        [zero, zero, zero, one]])


def skew_symm(a) -> torch.Tensor:
    """Skew symmetric matrix of a vector (sdfHelpers.f90:155-167)."""
    x, y, z = a[0], a[1], a[2]
    zero = torch.zeros_like(x)
    return _rows([[zero, z, -y, zero], [-z, zero, x, zero],
                  [y, -x, zero, zero], [zero, zero, zero, zero]])


def rotation_align(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation aligning unit vector ``a`` onto ``b``
    (sdfHelpers.f90:114-140).  Undefined for ``a == -b`` like the
    reference."""
    v = torch.linalg.cross(a, b)
    c = torch.dot(a, b)
    k = 1.0 / (1.0 + c)
    vx = skew_symm(v)
    return torch.eye(4, dtype=a.dtype, device=a.device) + vx + (vx @ vx) * k


def identity(dtype=torch.float32, device="cpu") -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def apply_transform(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``[p, 1] @ m`` restricted to the first three output components.
    ``p`` is ``[..., 3]``; ``m`` is ``[4, 4]`` or a stack ``[S, 4, 4]`` that
    broadcasts against ``p``'s leading axes.  Expanded elementwise in the
    reference's order of operations."""
    return (
        p[..., 0:1] * m[..., 0, :3]
        + p[..., 1:2] * m[..., 1, :3]
        + p[..., 2:3] * m[..., 2, :3]
        + m[..., 3, :3]
    )


def apply_rotation(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate a direction (no translation part)."""
    return (
        v[..., 0:1] * m[..., 0, :3]
        + v[..., 1:2] * m[..., 1, :3]
        + v[..., 2:3] * m[..., 2, :3]
    )


def translate(o, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Translation matrix (reference: src/sdfs/sdfHelpers.f90:169-182)."""
    m = torch.eye(4, dtype=dtype, device=device)
    m[3, :3] = torch.as_tensor(o, dtype=dtype, device=device)
    return m


def invert(m: torch.Tensor) -> torch.Tensor:
    """4x4 matrix inverse (reference: src/mat_class.f90:154-207)."""
    return torch.linalg.inv(m)
