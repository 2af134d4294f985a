"""Analytic ray-surface intersection (port of
``rsmcrt_tpu/sdfs/raycast.py`` for the sphere and box prims).

For rigid-transformed primitives the first surface crossing along a ray
has a closed form, so the transport engine jumps a whole segment in one
step.  The cylinder, capsule, cone, plane, torus, triprism and
revolved-egg raycasts are still to port (ROADMAP queue 1, item 11).
"""

from __future__ import annotations

import torch

from ..maths.transforms import apply_rotation, apply_transform
from . import primitives as sdp

_INF = torch.inf

# prim kinds with closed-form ray crossings in this package
ANALYTIC_KINDS = ("sphere", "box")


def _first_pos(*ts):
    """Elementwise smallest strictly-positive among candidates (inf if
    none).  Invalid candidates must already be +inf."""
    out = None
    for t in ts:
        t = torch.where(t > 0.0, t, _INF)
        out = t if out is None else torch.minimum(out, t)
    return out


def ray_sphere(p, d, radius):
    """First crossing of ``|p + t d| = radius`` (both sides)."""
    b = torch.sum(p * d, dim=-1)
    c = torch.sum(p * p, dim=-1) - radius * radius
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=1e-30))
    t1 = -b - sq
    t2 = -b + sq
    return torch.where(disc < 0.0, _INF, _first_pos(t1, t2))


def ray_box(p, d, half_lengths):
    """Slab method; first crossing of the box surface from either side."""
    d0 = d == 0.0
    safe_d = torch.where(d0, 1.0, d)
    ta = (-half_lengths - p) / safe_d
    tb = (half_lengths - p) / safe_d
    # d == 0 on an axis: inside that slab -> (-inf, inf); outside -> empty
    inside_slab = torch.abs(p) <= half_lengths
    lo = torch.where(d0, torch.where(inside_slab, -_INF, _INF),
                     torch.minimum(ta, tb))
    hi = torch.where(d0, torch.where(inside_slab, _INF, -_INF),
                     torch.maximum(ta, tb))
    tn = torch.amax(lo, dim=-1)
    tf = torch.amin(hi, dim=-1)
    return torch.where(tn > tf, _INF, _first_pos(tn, tf))


def _ray_prim(spec, params, pos, dirn):
    T = params["transform"]
    p = apply_transform(T, pos)
    d = apply_rotation(T, dirn)
    if spec.kind == "sphere":
        return ray_sphere(p, d, params["radius"])
    if spec.kind == "box":
        return ray_box(p, d, params["half_lengths"])
    raise NotImplementedError(f"no analytic raycast for {spec.kind!r}")


def analytic_column_mask(scene) -> tuple:
    """Static per-prim (user order) bool: has a closed-form crossing."""
    mask = []
    for spec, size in zip(scene.specs, scene.group_sizes):
        mask += [spec.kind in ANALYTIC_KINDS] * size
    return tuple(mask[c] for c in scene.perm)


def ray_bound_idx(scene, pos, dirn):
    """Smallest positive crossing parameter over the analytic prims and the
    prim that owns it: ``(t [...], idx [...] int32)`` with ``idx`` in
    concatenated-group order (the order :func:`surface_normal` consumes);
    ``idx`` is 0 when nothing crosses (t = +inf)."""
    best = torch.full(pos.shape[:-1], _INF, dtype=pos.dtype,
                      device=pos.device)
    bidx = torch.zeros(pos.shape[:-1], dtype=torch.int32, device=pos.device)
    offset = 0
    pm, dm = pos[..., None, :], dirn[..., None, :]
    for spec, params, size in zip(scene.specs, scene.group_params,
                                  scene.group_sizes):
        if spec.kind not in ANALYTIC_KINDS:
            offset += size
            continue
        ts = _ray_prim(spec, params, pm, dm)  # [..., size]
        if size == 1:
            t = ts[..., 0]
            better = t < best
            bidx = torch.where(better, offset, bidx)
        else:
            t, arg = torch.min(ts, dim=-1)
            better = t < best
            bidx = torch.where(better, offset + arg.to(torch.int32), bidx)
        best = torch.where(better, t, best)
        offset += size
    return best, bidx


def surface_normal(scene, pos, idx):
    """Unit surface normal of prim ``idx`` (concatenated-group order, from
    :func:`ray_bound_idx`) at world points ``pos [B, 3]``: the closed-form
    gradient of that prim's world-space SDF.  With the row-vector transform
    ``p_local = p @ M[:3, :3] + M[3, :3]`` the world gradient is
    ``M[:3, :3] @ grad_local``.  Normalised with the reference's +1e-30
    under the square root."""
    out = torch.zeros_like(pos)
    offset = 0
    for spec, params, size in zip(scene.specs, scene.group_params,
                                  scene.group_sizes):
        if size == 1:
            prm = {k: v[0] for k, v in params.items()}
        else:
            member = torch.clamp(idx - offset, 0, size - 1).long()
            prm = {k: v[member] for k, v in params.items()}
        T = prm["transform"]
        p = apply_transform(T, pos)
        args = {k: prm[k] for k in ("radius", "half_lengths") if k in prm}
        g = _grad(spec.kind, p, args)
        rot = T[..., :3, :3]
        n = (g[..., None, :] * rot).sum(-1)
        norm = torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-30)
        n = n / norm
        sel = (idx >= offset) & (idx < offset + size)
        out = torch.where(sel[..., None], n, out)
        offset += size
    return out


def _grad(kind, p, args):
    if kind == "sphere":
        return sdp.grad_sd_sphere(p, args["radius"])
    if kind == "box":
        return sdp.grad_sd_box(p, args["half_lengths"])
    raise NotImplementedError(f"no surface normal for {kind!r}")
