"""Henyey-Greenstein / isotropic scattering (port of
``rsmcrt_tpu/transport/scatter.py``; reference: src/photon.f90:1045-1103)."""

from __future__ import annotations

import torch

from ..constants import TWOPI


def sample_hg_cost(u: torch.Tensor, hgg) -> torch.Tensor:
    """Sample cos(theta) from the HG phase function; isotropic when g == 0
    (reference: src/photon.f90:1063-1069)."""
    g = torch.as_tensor(hgg, dtype=u.dtype, device=u.device)
    safe_g = torch.where(g == 0.0, 0.5, g)
    temp = (1.0 - safe_g * safe_g) / (1.0 - safe_g + 2.0 * safe_g * u)
    cost_hg = (1.0 + safe_g * safe_g - temp * temp) / (2.0 * safe_g)
    cost_iso = 2.0 * u - 1.0
    return torch.where(g == 0.0, cost_iso, torch.clamp(cost_hg, -1.0, 1.0))


def scatter_direction(direction: torch.Tensor, cost: torch.Tensor,
                      phi: torch.Tensor) -> torch.Tensor:
    """Rotate ``direction [..., 3]`` by polar angle acos(cost) and azimuth
    ``phi`` (reference: src/photon.f90:1070-1102, including the
    near-perpendicular special cases at |nz| ~ 1)."""
    sint = torch.sqrt(torch.clamp(1.0 - cost * cost, min=1e-30))
    cosp = torch.cos(phi)
    sinp = torch.sin(phi)
    nx, ny, nz = direction[..., 0], direction[..., 1], direction[..., 2]

    temp = torch.sqrt(torch.clamp(1.0 - nz * nz, min=1e-30))
    safe_t = torch.where(temp > 0.0, temp, 1.0)
    uxx_g = sint * ((nx * nz * cosp - ny * sinp) / safe_t) + nx * cost
    uyy_g = sint * ((ny * nz * cosp + nx * sinp) / safe_t) + ny * cost
    uzz_g = -sint * cosp * safe_t + nz * cost

    # near-perpendicular cases; the reference's 1e-12 threshold underflows
    # against 1.0 in float32
    tol = 1e-12 if direction.dtype == torch.float64 else 1e-6
    up = nz > 1.0 - tol
    down = nz < -1.0 + tol
    updown = up | down
    uxx = torch.where(updown, sint * cosp, uxx_g)
    uyy = torch.where(updown, sint * sinp, uyy_g)
    uzz = torch.where(up, cost, torch.where(down, -cost, uzz_g))

    out = torch.stack([uxx, uyy, uzz], dim=-1)
    norm = torch.sqrt(torch.sum(out * out, dim=-1, keepdim=True) + 1e-30)
    return out / torch.where(norm > 0.0, norm, 1.0)


def hg_scatter(direction: torch.Tensor, u_cost: torch.Tensor,
               u_phi: torch.Tensor, hgg) -> torch.Tensor:
    cost = sample_hg_cost(u_cost, hgg)
    phi = TWOPI * u_phi
    return scatter_direction(direction, cost, phi)


def hg_logpdf_dg(cost: torch.Tensor, hgg) -> torch.Tensor:
    """d/dg log p_HG(cost; g), the per-scatter score of the perturbation-MC
    gradient of detector totals with respect to the anisotropy, with
    p_HG = 0.5 (1 - g^2) / (1 + g^2 - 2 g cost)^{3/2}."""
    g = torch.as_tensor(hgg, dtype=cost.dtype, device=cost.device)
    denom = 1.0 + g * g - 2.0 * g * cost
    return (-2.0 * g) / torch.clamp(1.0 - g * g, min=1e-12) - 1.5 * (
        2.0 * g - 2.0 * cost) / torch.clamp(denom, min=1e-12)
