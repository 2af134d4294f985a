"""Fresnel reflection / refraction (port of
``rsmcrt_tpu/transport/fresnel.py``; reference: src/surfaces.f90).
Branch-free on direction batches ``[..., 3]``."""

from __future__ import annotations

import torch


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def fresnel_coeff(incident: torch.Tensor, normal: torch.Tensor, n1, n2):
    """Unpolarised Fresnel reflection coefficient (reference:
    src/surfaces.f90:86-127).  Returns 1.0 on total internal reflection."""
    costt = torch.clamp(torch.abs(_dot(incident, normal)), 0.0, 1.0)
    sintt = torch.sqrt(torch.clamp(1.0 - costt * costt, min=1e-30))
    sint2 = (n1 / n2) * sintt
    tir = sint2 > 1.0
    sint2c = torch.clamp(sint2, max=1.0)
    cost2 = torch.sqrt(torch.clamp(1.0 - sint2c * sint2c, min=1e-30))
    denom1 = n1 * costt + n2 * cost2
    denom2 = n1 * cost2 + n2 * costt
    f1 = torch.abs((n1 * costt - n2 * cost2)
                   / torch.where(denom1 == 0.0, 1.0, denom1)) ** 2
    f2 = torch.abs((n1 * cost2 - n2 * costt)
                   / torch.where(denom2 == 0.0, 1.0, denom2)) ** 2
    coeff = 0.5 * (f1 + f2)
    # perpendicular incidence transmits (reference :111-114)
    coeff = torch.where(costt == 1.0, 0.0, coeff)
    return torch.where(tir, 1.0, coeff)


def reflect(incident: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Mirror reflection (reference: src/surfaces.f90:42-55)."""
    return incident - 2.0 * _dot(normal, incident)[..., None] * normal


def refract(incident: torch.Tensor, normal: torch.Tensor, eta) -> torch.Tensor:
    """Snell refraction with eta = n1/n2 (reference: src/surfaces.f90:57-84).
    Caller must ensure no TIR (eta^2 (1-c1^2) <= 1)."""
    c1 = _dot(normal, incident)
    # flip normal to oppose the incident direction like the reference
    ntmp = torch.where(c1[..., None] < 0.0, normal, -normal)
    c1 = torch.abs(c1)
    eta = torch.as_tensor(eta, dtype=incident.dtype, device=incident.device)
    c2 = torch.sqrt(torch.clamp(1.0 - eta**2 * (1.0 - c1 * c1), min=1e-30))
    etab = eta if eta.ndim == 0 else eta[..., None]
    return etab * incident + (eta * c1 - c2)[..., None] * ntmp
