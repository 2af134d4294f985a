"""Homogeneous 4x4 transform helpers (port of
``rsmcrt_tpu/maths/transforms.py``, the part the slice uses).

Convention: a point ``p`` is transformed as the row-vector product
``[x, y, z, 1] @ M`` -- translations live in row 3 of the matrix.  SDFs
store the *inverse* of the world transform (scenes call
``invert(translate(pos))``, reference: src/setupGeometry.f90:64).
"""

from __future__ import annotations

import torch


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
