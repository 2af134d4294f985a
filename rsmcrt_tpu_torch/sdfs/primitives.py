"""Signed distance functions for the 10 reference primitives (port of
``rsmcrt_tpu/sdfs/primitives.py``; Inigo Quilez formulas as the reference
uses them, src/sdfs/sdfs.f90:494-736), plus closed-form gradients of the
sphere and box.

Each takes positions ``p [..., 3]`` and parameters that broadcast against
``p``'s leading axes (scalar parameters against ``p[..., 0]``).  The
closed-form gradients reproduce what ``jax.grad`` gives for the reference
formulas, including its tie conventions (a ``maximum`` or ``minimum`` at a
tie passes half the cotangent each way; a ``max`` reduction splits it
evenly over the tied entries; ``abs`` has slope 1 at 0).  The other kinds
are differentiated by autograd (``raycast.surface_normal``).  Autograd's
own ties differ from JAX's (``abs`` has slope 0 at 0, ``clamp`` slope 1 at
a bound), so the kinks go through :func:`abs_jt`, :func:`relu_jt` and
:func:`clip_jt`, which take JAX's slopes when their input requires a
gradient and are the plain op otherwise.
"""

from __future__ import annotations

import torch


def _length(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _length_safe(v):
    """``|v|`` that is exactly 0 at v = 0 with a finite gradient there
    (reference ``_length_safe``: the where-guard keeps the value exact)."""
    s = torch.sum(v * v, dim=-1)
    pos = s > 0.0
    return torch.sqrt(torch.where(pos, s, 1.0)) * pos.to(s.dtype)


def abs_jt(x):
    """``|x|``; differentiated, its slope at 0 is 1, as ``jax.grad`` takes
    ``jnp.abs``."""
    if x.requires_grad:
        return torch.where(x >= 0.0, x, -x)
    return torch.abs(x)


def _above(x, bound):
    """``jnp.maximum(x, bound)`` for autograd: JAX scales the cotangent
    by 1 above the bound, 1/2 at it and 0 below, so a NaN cotangent stays
    NaN where autograd's masked backward would drop it.  The values are
    exact: ``x * 1``, ``(x + bound) / 2`` at the bound, ``0 + bound``."""
    s = ((x > bound).to(x.dtype) + 0.5 * (x == bound).to(x.dtype)).detach()
    return x * s + bound * (1.0 - s)


def relu_jt(x):
    """``max(x, 0)``; differentiated, its slope at 0 is 1/2, as
    ``jax.grad`` takes ``jnp.maximum(x, 0.0)``.  ``min(x, 0)`` is
    ``-relu_jt(-x)``."""
    if x.requires_grad:
        return _above(x, 0.0)
    return torch.clamp(x, min=0.0)


def clip_jt(x, lo: float, hi: float):
    """``jnp.clip(x, lo, hi)``; differentiated, its slope at a bound is
    1/2, as ``jax.grad`` takes it."""
    if x.requires_grad:
        return -_above(-_above(x, lo), -hi)
    return torch.clamp(x, lo, hi)


def sd_sphere(p, radius):
    """reference: src/sdfs/sdfs.f90:494-508"""
    return _length(p) - radius


def sd_box(p, half_lengths):
    """``half_lengths`` are the box half extents (reference sdfs.f90:510)."""
    q = abs_jt(p) - half_lengths
    outside = _length_safe(relu_jt(q))
    inside = -relu_jt(-torch.amax(q, dim=-1))
    return outside + inside


def sd_torus(p, oradius, iradius):
    """reference: src/sdfs/sdfs.f90:527-542"""
    qx = _length(torch.stack([p[..., 0], p[..., 2]], dim=-1)) - oradius
    q = torch.stack([qx, p[..., 1]], dim=-1)
    return _length(q) - iradius


def sd_cylinder(p, a, b, radius):
    """Capped cylinder from ``a`` to ``b`` (reference: sdfs.f90:544-581)."""
    ba = b - a
    pa = p - a
    baba = torch.sum(ba * ba, dim=-1)
    paba = torch.sum(pa * ba, dim=-1)
    x = _length(pa * baba[..., None] - ba * paba[..., None]) - radius * baba
    y = abs_jt(paba - baba * 0.5) - baba * 0.5
    x2 = x * x
    y2 = y * y * baba
    inside = (x < 0.0) & (y < 0.0)
    d_in = -torch.minimum(x2, y2)
    d_out = torch.where(x > 0.0, x2, 0.0) + torch.where(y > 0.0, y2, 0.0)
    d = torch.where(inside, d_in, d_out)
    return torch.sign(d) * torch.sqrt(abs_jt(d)) / baba


def sd_triprism(p, h1, h2):
    """Triangular prism; h1 = height, h2 = length (sdfs.f90:583-597)."""
    q = abs_jt(p)
    return torch.maximum(
        q[..., 2] - h2,
        torch.maximum(q[..., 0] * 0.866025 + p[..., 1] * 0.5, -p[..., 1])
        - h1 * 0.5)


def sd_segment(p, a, b):
    """2D segment with the reference's fixed 0.1 thickness
    (sdfs.f90:599-626)."""
    return sd_capsule(p, a, b, 0.1)


def sd_capsule(p, a, b, r):
    """reference: src/sdfs/sdfs.f90:628-648"""
    pa = p - a
    ba = b - a
    h = clip_jt(torch.sum(pa * ba, dim=-1) / torch.sum(ba * ba, dim=-1),
                0.0, 1.0)
    return _length(pa - ba * h[..., None]) - r


def sd_cone(p, a, b, ra, rb):
    """Capped cone, base centre ``a`` radius ``ra``, tip ``b`` radius ``rb``
    (reference: sdfs.f90:650-686)."""
    rba = rb - ra
    ba = b - a
    baba = torch.sum(ba * ba, dim=-1)
    papa = torch.sum((p - a) * (p - a), dim=-1)
    paba = torch.sum((p - a) * ba, dim=-1) / baba
    x2 = papa - baba * paba ** 2
    x2p = x2 > 0.0
    # exact 0 on the axis with a finite gradient (see _length_safe)
    x = torch.sqrt(torch.where(x2p, x2, 1.0)) * x2p.to(x2.dtype)
    cax = relu_jt(x - torch.where(paba < 0.5, ra, rb))
    cay = abs_jt(paba - 0.5) - 0.5
    k = rba ** 2 + baba
    f = clip_jt((rba * (x - ra) + paba * baba) / k, 0.0, 1.0)
    cbx = x - ra - f * rba
    cby = paba - f
    s = torch.where((cbx < 0.0) & (cay < 0.0), -1.0, 1.0)
    return s * torch.sqrt(torch.minimum(cax ** 2 + baba * cay ** 2,
                                        cbx ** 2 + baba * cby ** 2))


def sd_egg(p, r1, r2, h):
    """Moss egg (reference: sdfs.f90:688-718); r1 = base radius, r2 = top
    radius, h = y of top circle.  The reference takes 3D lengths (the z
    component participates), matching its use under ``revolution``."""
    px = abs_jt(p[..., 0])
    py = p[..., 1]
    pz = p[..., 2]
    r = r1 - r2
    h_in = h + r
    el = (h_in ** 2 - r ** 2) / (2.0 * r)

    d_bottom = torch.sqrt(px * px + py * py + pz * pz) - r1
    d_top = torch.sqrt(px * px + (py - h_in) ** 2 + pz * pz) - (
        (r1 + el) - torch.sqrt(h_in ** 2 + el ** 2))
    d_side = torch.sqrt((px + el) ** 2 + py * py + pz * pz) - (r1 + el)

    use_top = (py - h_in) * el > px * h_in
    d_upper = torch.where(use_top, d_top, d_side)
    return torch.where(py <= 0.0, d_bottom, d_upper)


def sd_plane(p, a):
    """Half space with (normalised) normal ``a`` (reference:
    sdfs.f90:720-735)."""
    return torch.sum(p * a, dim=-1)


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
