"""Signed distance functions and their closed-form gradients (port of
``rsmcrt_tpu/sdfs/primitives.py``: sphere and box; reference
src/sdfs/sdfs.f90:494-525).  The other eight primitives are still to port
(ROADMAP queue 1, item 11).

Each takes positions ``p [..., 3]`` and parameters that broadcast against
``p``'s leading axes.  The gradients reproduce what ``jax.grad`` gives for
the reference formulas, including its tie conventions (a ``maximum`` or
``minimum`` at a tie passes half the cotangent each way; a ``max``
reduction splits it evenly over the tied entries; ``abs`` has slope 0 at 0).
"""

from __future__ import annotations

import torch


def _length(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _length_safe(v):
    """``|v|`` that is exactly 0 at v = 0 (reference ``_length_safe``)."""
    s = torch.sum(v * v, dim=-1)
    pos = s > 0.0
    return torch.sqrt(torch.where(pos, s, 1.0)) * pos.to(s.dtype)


def sd_sphere(p, radius):
    """reference: src/sdfs/sdfs.f90:494-508"""
    return _length(p) - radius


def sd_box(p, half_lengths):
    """``half_lengths`` are the box half extents (reference sdfs.f90:510)."""
    q = torch.abs(p) - half_lengths
    outside = _length_safe(torch.clamp(q, min=0.0))
    inside = torch.clamp(torch.amax(q, dim=-1), max=0.0)
    return outside + inside


def _tie_slope(x):
    """d/dx max(x, 0) as jax.grad takes it: 1 above, 1/2 at the tie."""
    return torch.where(x > 0.0, 1.0, torch.where(x == 0.0, 0.5, 0.0))


def grad_sd_sphere(p, radius):
    """d sd_sphere / dp."""
    return p / _length(p)[..., None]


def grad_sd_box(p, half_lengths):
    """d sd_box / dp."""
    q = torch.abs(p) - half_lengths
    m = torch.clamp(q, min=0.0)
    ss = torch.sum(m * m, dim=-1, keepdim=True)
    g_out = torch.where(ss > 0.0, m / torch.sqrt(torch.where(ss > 0.0, ss,
                                                             1.0)), 0.0)
    g_out = g_out * _tie_slope(q)
    mx = torch.amax(q, dim=-1, keepdim=True)
    ties = (q == mx).to(p.dtype)
    g_in = _tie_slope(-mx) * ties / torch.sum(ties, dim=-1, keepdim=True)
    return (g_out + g_in) * torch.sign(p)
