"""Analytic ray-surface intersection (port of
``rsmcrt_tpu/sdfs/raycast.py``).

For rigid-transformed primitives the first surface crossing along a ray
has a closed form, so the transport engine jumps a whole segment in one
step and lands ``eps/2`` before the true crossing.  The torus and the
revolved egg take the roots of a float32 quartic, Newton-polished on the
true SDF and validated on the surface.  Every other spec (the other
modifiers, CSG models) is *non-analytic*: the engine's bounded
sphere-trace march (``engine._segment_probe``) finds its surfaces, bounded
by the analytic crossings of the rest.

Parameters carry a leading member axis that broadcasts against the
positions' ``[..., 1, 3]`` member axis, as in ``scene.eval_scene``.
Assumes rigid transforms (rotation + translation), as the SDF metric
does.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import obs
from ..maths.transforms import apply_rotation, apply_transform
from . import primitives as sdp
from .scene import _leaves, eval_spec, tree_map

_INF = torch.inf

# prim kinds with closed-form ray crossings; everything else (modifiers
# other than revolution-of-egg, CSG models) is marched
ANALYTIC_KINDS = ("sphere", "box", "plane", "cylinder", "capsule",
                  "segment", "cone", "torus", "triprism")


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


def ray_plane(p, d, a):
    """Crossing of the half-space boundary ``a . x = 0``."""
    dn = torch.sum(d * a, dim=-1)
    s = torch.sum(p * a, dim=-1)
    t = -s / torch.where(dn == 0.0, 1.0, dn)
    return torch.where(dn == 0.0, _INF, _first_pos(t))


def _axis_decomp(p, d, a, b):
    """Shared cylinder/capsule/cone machinery: axial parameter u in
    [0, 1] and the radial quadratic coefficients."""
    ba = b - a
    m = p - a
    baba = torch.sum(ba * ba, dim=-1)
    safe = torch.where(baba == 0.0, 1.0, baba)
    u_m = torch.sum(m * ba, dim=-1) / safe  # axial coord of ray origin
    u_d = torch.sum(d * ba, dim=-1) / safe  # axial rate along ray
    mp = m - ba * u_m[..., None]
    dp = d - ba * u_d[..., None]
    A = torch.sum(dp * dp, dim=-1)
    B = torch.sum(mp * dp, dim=-1)
    return u_m, u_d, mp, dp, A, B


def _side_roots(A, B, C):
    disc = B * B - A * C
    safeA = torch.where(A == 0.0, 1.0, A)
    sq = torch.sqrt(torch.clamp(disc, min=1e-30))
    t1 = (-B - sq) / safeA
    t2 = (-B + sq) / safeA
    bad = (disc < 0.0) | (A == 0.0)
    t1 = torch.where(bad, _INF, t1)
    t2 = torch.where(bad, _INF, t2)
    # degenerate linear case (cone slant-parallel rays): A=0, B!=0
    lin = (A == 0.0) & (B != 0.0)
    t_lin = -C / torch.where(B == 0.0, 1.0, 2.0 * B)
    return torch.where(lin, t_lin, t1), t2


def _on_span(u_m, u_d, t, extra=None):
    u = u_m + t * u_d
    ok = (u >= 0.0) & (u <= 1.0)
    if extra is not None:
        ok = ok & extra
    return torch.where(ok, t, _INF)


def _cap(u_m, u_d, mp, dp, u_target, radius):
    safe = torch.where(u_d == 0.0, 1.0, u_d)
    t = (u_target - u_m) / safe
    q = mp + dp * t[..., None]  # radial vector at the cap plane
    rr = torch.sum(q * q, dim=-1)
    ok = (u_d != 0.0) & (rr <= radius * radius)
    return torch.where(ok, t, _INF)


def ray_cylinder(p, d, a, b, radius):
    """Capped cylinder from ``a`` to ``b`` (reference sd_cylinder,
    src/sdfs/sdfs.f90:544)."""
    u_m, u_d, mp, dp, A, B = _axis_decomp(p, d, a, b)
    C = torch.sum(mp * mp, dim=-1) - radius * radius
    t1, t2 = _side_roots(A, B, C)
    return _first_pos(_on_span(u_m, u_d, t1), _on_span(u_m, u_d, t2),
                      _cap(u_m, u_d, mp, dp, 0.0, radius),
                      _cap(u_m, u_d, mp, dp, 1.0, radius))


def ray_capsule(p, d, a, b, r):
    """Capsule from ``a`` to ``b`` radius ``r`` (reference sd_capsule,
    src/sdfs/sdfs.f90:628)."""
    u_m, u_d, mp, dp, A, B = _axis_decomp(p, d, a, b)
    C = torch.sum(mp * mp, dim=-1) - r * r
    t1, t2 = _side_roots(A, B, C)

    def cap_sphere(center, beyond_hi):
        # BOTH sphere roots are tested: a ray from inside the capsule
        # exiting axially has its first root inside the cylindrical span
        # and its true cap exit at the second root
        pc = p - center
        bq = torch.sum(pc * d, dim=-1)
        cq = torch.sum(pc * pc, dim=-1) - r * r
        disc = bq * bq - cq
        sq = torch.sqrt(torch.clamp(disc, min=1e-30))
        miss = disc < 0.0

        def ok(t):
            u = u_m + t * u_d
            on_cap = u > 1.0 if beyond_hi else u < 0.0
            return torch.where(miss | ~on_cap, _INF, t)

        return ok(-bq - sq), ok(-bq + sq)

    ca1, ca2 = cap_sphere(a, False)
    cb1, cb2 = cap_sphere(b, True)
    return _first_pos(_on_span(u_m, u_d, t1), _on_span(u_m, u_d, t2),
                      ca1, ca2, cb1, cb2)


def ray_cone(p, d, a, b, ra, rb):
    """Capped cone, radius ``ra`` at ``a`` linearly to ``rb`` at ``b``
    (reference sd_cone, src/sdfs/sdfs.f90:650).  Lateral sheet:
    ``|radial(t)| = ra + (rb-ra) u(t)`` -> a quadratic in t."""
    u_m, u_d, mp, dp, A, B = _axis_decomp(p, d, a, b)
    rba = rb - ra
    c0 = ra + rba * u_m
    c1 = rba * u_d
    qa = A - c1 * c1
    qb = B - c0 * c1
    qc = torch.sum(mp * mp, dim=-1) - c0 * c0
    t1, t2 = _side_roots(qa, qb, qc)

    def side_ok(t):  # on the span and on the same nappe of the cone
        return _on_span(u_m, u_d, t, c0 + c1 * t >= 0.0)

    return _first_pos(side_ok(t1), side_ok(t2),
                      _cap(u_m, u_d, mp, dp, 0.0, ra),
                      _cap(u_m, u_d, mp, dp, 1.0, rb))


def _needs_graph(*tensors) -> bool:
    """Whether a derivative taken inside the forward must itself be
    differentiable: grad mode is on and an input requires a gradient (the
    reference's ``jax.jvp`` slope and ``jax.grad`` normal are
    differentiated through by an outer ``jax.grad``).  Outside that case
    the inner derivative is a constant and keeps no graph."""
    return torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in tensors)


def _value_and_slope(sd_fn, p, d, t, params=()):
    """``sd_fn(p + t d)`` and its derivative in ``t``, the reference's
    ``jax.jvp``, taken in reverse mode: each element of ``t`` moves its
    own element of the result only, so the gradient of the sum is the
    elementwise slope.  (Forward-mode dual tensors broadcast against the
    prim parameters through PyTorch's Python reference kernels, which
    are far slower.)  When ``p``, ``d``, ``t`` or a tensor of ``params``
    (what ``sd_fn`` closes over) requires a gradient under grad mode, the
    value and the slope stay in the graph (``create_graph``)."""
    if _needs_graph(p, d, t, *params):
        s = t if t.requires_grad else t.detach().requires_grad_(True)
        f = sd_fn(p + s[..., None] * d)
        (fp,) = torch.autograd.grad(f.sum(), s, create_graph=True)
        return f, fp
    with torch.enable_grad():
        s = t.detach().requires_grad_(True)
        f = sd_fn(p + s[..., None] * d)
        (fp,) = torch.autograd.grad(f.sum(), s)
    return f.detach(), fp


def _newton_polish(sd_fn, p, d, t, iters=2, scale=1.0, params=()):
    """Refine root candidates ``t`` of ``sd_fn(p + t d) = 0`` with Newton
    steps.  Invalid (inf) lanes pass through untouched; steps are clamped
    to ``0.05 * scale`` so a polish never jumps to another sheet."""
    fin = torch.isfinite(t)
    tf = torch.where(fin, t, 0.0)
    clamp = 0.05 * scale
    for _ in range(iters):
        f, fp = _value_and_slope(sd_fn, p, d, tf, params)
        step = f / torch.where(torch.abs(fp) < 1e-8,
                               torch.sign(fp) * 1e-8 + 1e-12, fp)
        tf = tf - torch.minimum(torch.maximum(step, -clamp), clamp)
    return torch.where(fin, tf, t)


def _validated_first(sd_fn, p, d, cands, tol=2e-3, t_min=1e-5, iters=2,
                     scale=1.0, params=()):
    """Newton-polish each candidate and keep the first strictly positive
    one that lies on the surface (``|sd| < tol * scale``): f32 quartic
    roots carry O(1e-2) error; validation discards spurious and
    wrong-branch roots."""
    best = torch.full(p.shape[:-1], _INF, dtype=p.dtype, device=p.device)
    tol = tol * scale
    for t in cands:
        t = _newton_polish(sd_fn, p, d, t, iters=iters, scale=scale,
                           params=params)
        sd_at = sd_fn(p + t[..., None] * d)
        ok = torch.isfinite(t) & (t > t_min) & (torch.abs(sd_at) < tol)
        best = torch.minimum(best, torch.where(ok, t, _INF))
    return best


def _cbrt(x):
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _solve_depressed_quartic(p, q, r):
    """Real roots of ``u^4 + p u^2 + q u + r = 0`` (Ferrari; resolvent
    cubic by the trigonometric method).  Returns 4 candidates, +inf where
    complex.  f32: callers must polish and validate the roots."""
    # resolvent cubic m^3 + a2 m^2 + a1 m + a0 = 0
    a2 = p
    a1 = 0.25 * p * p - r
    a0 = -0.125 * q * q
    Q = (3.0 * a1 - a2 * a2) / 9.0
    R = (9.0 * a2 * a1 - 27.0 * a0 - 2.0 * a2 ** 3) / 54.0
    disc = Q ** 3 + R * R
    # three-real-root branch: largest root via cos
    mQ = torch.sqrt(torch.clamp(-Q, min=1e-30))
    cosarg = torch.clamp(R / torch.clamp(mQ ** 3, min=1e-30), -1.0, 1.0)
    theta = torch.arccos(cosarg)
    m_tri = 2.0 * mQ * torch.cos(theta / 3.0) - a2 / 3.0
    # one-real-root branch
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    m_one = _cbrt(R + sq) + _cbrt(R - sq) - a2 / 3.0
    m = torch.where(disc <= 0.0, m_tri, m_one)
    # the resolvent has a root >= 0 whenever the quartic has real roots
    # (f(0) = -q^2/8 <= 0); clamp round-off
    m = torch.clamp(m, min=0.0)
    s = torch.sqrt(torch.clamp(2.0 * m, min=0.0))
    biquad = s < 1e-6  # q ~ 0: u^4 + p u^2 + r = 0
    safe_s = torch.where(biquad, 1.0, s)
    c1 = 0.5 * (p + 2.0 * m - q / safe_s)
    c2 = 0.5 * (p + 2.0 * m + q / safe_s)

    def quad_roots(b, c):
        # u^2 + b u + c = 0; slightly negative discriminants stay as
        # tangent candidates (the polish + validation keeps real ones)
        dq = b * b - 4.0 * c
        tol = 1e-4 * (b * b + torch.abs(c)) + 1e-6
        sdq = torch.sqrt(torch.clamp(dq, min=1e-30))
        bad = dq < -tol
        return (torch.where(bad, _INF, 0.5 * (-b - sdq)),
                torch.where(bad, _INF, 0.5 * (-b + sdq)))

    f1a, f1b = quad_roots(s, c1)
    f2a, f2b = quad_roots(-s, c2)
    # biquadratic fallback: u^2 = (-p +- sqrt(p^2 - 4 r)) / 2
    dbq = p * p - 4.0 * r
    sbq = torch.sqrt(torch.clamp(dbq, min=1e-30))

    def bq_pair(u2):
        su = torch.sqrt(torch.clamp(u2, min=1e-30))
        good = (dbq >= 0.0) & (u2 >= 0.0)
        return torch.where(good, -su, _INF), torch.where(good, su, _INF)

    b1a, b1b = bq_pair(0.5 * (-p - sbq))
    b2a, b2b = bq_pair(0.5 * (-p + sbq))
    return [torch.where(biquad, ba, fa)
            for fa, ba in ((f1a, b1a), (f1b, b1b), (f2a, b2a), (f2b, b2b))]


def _torus_quartic_cands(p, d, R2, rad):
    """Root candidates of ``(sqrt(x^2+z^2) - R)^2 + y^2 = rad^2`` along
    ``p + t d`` where only R^2 enters (valid for negative major radii).
    The origin shifts to the closest approach to the centre so the
    coefficients stay O(1) and the quartic is already depressed."""
    t0 = -torch.sum(p * d, dim=-1)
    o = p + t0[..., None] * d
    m = torch.sum(o * o, dim=-1)
    alpha = R2 - rad * rad
    axy = d[..., 0] ** 2 + d[..., 2] ** 2
    bxy = 2.0 * (o[..., 0] * d[..., 0] + o[..., 2] * d[..., 2])
    cxy = o[..., 0] ** 2 + o[..., 2] ** 2
    ma = m + alpha
    C = 2.0 * ma - 4.0 * R2 * axy
    D = -4.0 * R2 * bxy
    E = ma * ma - 4.0 * R2 * cxy
    return [u + t0 for u in _solve_depressed_quartic(C, D, E)]


def ray_torus(p, d, oradius, iradius):
    """First crossing of the torus around the y axis (reference sd_torus,
    src/sdfs/sdfs.f90:527-542): quartic roots + Newton polish on the true
    SDF + on-surface validation."""
    def sd_fn(q):
        return sdp.sd_torus(q, oradius, iradius)

    scale = oradius + iradius  # characteristic size for tol/clamp/margin
    # bounding-sphere reject keeps the quartic well-conditioned
    t0 = -torch.sum(p * d, dim=-1)
    o = p + t0[..., None] * d
    near = torch.sum(o * o, dim=-1) <= (1.5 * scale) ** 2
    cands = _torus_quartic_cands(p, d, oradius * oradius, iradius)
    t = _validated_first(sd_fn, p, d, cands, scale=scale,
                         params=(oradius, iradius))
    return torch.where(near, t, _INF)


def ray_triprism(p, d, h1, h2):
    """Triangular prism (reference sd_triPrism, src/sdfs/sdfs.f90:583-597):
    a convex polyhedron of 5 planes -- generalised slab method."""
    c866, c05 = 0.866025, 0.5
    # (normal, offset) with inside = n.x <= b
    planes = [((0.0, 0.0, 1.0), h2), ((0.0, 0.0, -1.0), h2),
              ((0.0, -1.0, 0.0), 0.5 * h1), ((c866, c05, 0.0), 0.5 * h1),
              ((-c866, c05, 0.0), 0.5 * h1)]
    shape = torch.broadcast_shapes(p.shape[:-1], d.shape[:-1],
                                   torch.as_tensor(h1).shape)
    lo = torch.full(shape, -_INF, dtype=p.dtype, device=p.device)
    hi = torch.full(shape, _INF, dtype=p.dtype, device=p.device)
    for n, b in planes:
        nv = torch.as_tensor(n, dtype=p.dtype, device=p.device)
        s = torch.sum(p * nv, dim=-1) - b  # > 0 outside this half-space
        dn = torch.sum(d * nv, dim=-1)
        t = -s / torch.where(dn == 0.0, 1.0, dn)
        para_in = (dn == 0.0) & (s <= 0.0)
        l_i = torch.where(dn < 0.0, t,
                          torch.where(dn > 0.0, -_INF,
                                      torch.where(para_in, -_INF, _INF)))
        h_i = torch.where(dn > 0.0, t,
                          torch.where(dn < 0.0, _INF,
                                      torch.where(para_in, _INF, -_INF)))
        lo = torch.maximum(lo, l_i)
        hi = torch.minimum(hi, h_i)
    return torch.where(lo > hi, _INF, _first_pos(lo, hi))


def ray_egg_revolution(p, d, center, o, r1, r2, h):
    """Revolution of the Moss egg (the egg scene's shell and albumen,
    reference setupGeometry.f90:149-247 + sdfModifiers.f90:303-321).  In
    the (rho, y) half-plane the boundary is three circular arcs, so the
    revolved surface is made of sphere / torus sheets (bottom and top:
    major radius ``o``; side: major radius ``o - el``); every sheet's
    candidates are polished and validated on the true revolved SDF, which
    also applies the region selection."""
    r = r1 - r2
    h_in = h + r
    el = (h_in ** 2 - r ** 2) / (2.0 * r)
    rtop = (r1 + el) - torch.sqrt(h_in ** 2 + el ** 2)

    def sd_fn(q):
        qc = q - center
        rho = torch.sqrt(qc[..., 0] ** 2 + qc[..., 2] ** 2)
        q2 = torch.stack([rho - o, qc[..., 1], torch.zeros_like(rho)],
                         dim=-1)
        return sdp.sd_egg(q2, r1, r2, h)

    pc = p - center
    # bottom / top sheets: at o = 0 the quartic degenerates to a sphere
    # whose roots are already exact, so one polish iteration suffices
    shift = torch.zeros_like(pc)
    shift[..., 1] = 1.0
    cands_sph = _torus_quartic_cands(pc, d, o * o, r1)
    cands_sph += _torus_quartic_cands(pc - shift * h_in[..., None], d, o * o,
                                      rtop)
    # side sheet: torus(R = o - el, rad = r1 + el)
    Rs = o - el
    cands_q = _torus_quartic_cands(pc, d, Rs * Rs, r1 + el)
    scale = r1 + torch.abs(o)  # characteristic size for tol/clamp
    prm = (center, o, r1, r2, h)
    t_sph = _validated_first(sd_fn, p, d, cands_sph, iters=1, scale=scale,
                             params=prm)
    t_q = _validated_first(sd_fn, p, d, cands_q, iters=2, scale=scale,
                           params=prm)
    return torch.minimum(t_sph, t_q)


def _ray_prim(spec, params, pos, dirn):
    kind = spec.kind
    if kind == "revolution":
        # modifiers carry no transform; analytic only for an egg child
        # with the identity transform (checked by _is_analytic_spec)
        ch = params["child0"]
        return ray_egg_revolution(pos, dirn, params["center"], params["o"],
                                  ch["r1"], ch["r2"], ch["h"])
    T = params["transform"]
    p = apply_transform(T, pos)
    d = apply_rotation(T, dirn)
    if kind == "sphere":
        return ray_sphere(p, d, params["radius"])
    if kind == "box":
        return ray_box(p, d, params["half_lengths"])
    if kind == "plane":
        return ray_plane(p, d, params["a"])
    if kind == "cylinder":
        return ray_cylinder(p, d, params["a"], params["b"], params["radius"])
    if kind == "capsule":
        return ray_capsule(p, d, params["a"], params["b"], params["r"])
    if kind == "segment":
        # fixed 0.1 thickness capsule (reference sdfs.f90:624)
        return ray_capsule(p, d, params["a"], params["b"], 0.1)
    if kind == "cone":
        return ray_cone(p, d, params["a"], params["b"], params["ra"],
                        params["rb"])
    if kind == "torus":
        return ray_torus(p, d, params["oradius"], params["iradius"])
    if kind == "triprism":
        return ray_triprism(p, d, params["h1"], params["h2"])
    raise ValueError(f"no analytic raycast for {kind!r}")


def _is_analytic_spec(spec) -> bool:
    """Structural predicate: does this spec have a closed-form raycast?
    Decided once per spec (the child transform is read on the host)."""
    cached = getattr(spec, "_analytic", None)
    if cached is None:
        cached = spec.kind in ANALYTIC_KINDS
        if (spec.kind == "revolution" and len(spec.children) == 1
                and spec.children[0].kind == "egg"):
            # ray_egg_revolution assumes the child egg sits at the
            # origin: a child with a transform is marched instead
            ct = spec.children[0].params.get("transform")
            cached = ct is None or bool(np.allclose(
                torch.as_tensor(ct).detach().cpu().numpy(), np.eye(4),
                atol=1e-7))
        spec._analytic = cached
    return cached


def analytic_column_mask(scene) -> tuple:
    """Static per-prim (user order) bool: has a closed-form crossing."""
    mask = []
    for spec, size in zip(scene.specs, scene.group_sizes):
        mask += [_is_analytic_spec(spec)] * size
    return tuple(mask[c] for c in scene.perm)


def ray_bound(scene, pos, dirn):
    """Smallest positive crossing parameter over the analytic prims:
    ``pos [..., 3], dirn [..., 3] -> t [...]`` (+inf when none cross)."""
    return ray_bound_idx(scene, pos, dirn)[0]


def ray_bound_idx(scene, pos, dirn):
    """Smallest positive crossing parameter over the analytic prims and the
    prim that owns it: ``(t [...], idx [...] int32)`` with ``idx`` in
    concatenated-group order (the order :func:`surface_normal` consumes);
    ``idx`` is 0 when nothing crosses (t = +inf).  A ``geometry`` span."""
    with obs.span("geometry"):
        best = torch.full(pos.shape[:-1], _INF, dtype=pos.dtype,
                          device=pos.device)
        bidx = torch.zeros(pos.shape[:-1], dtype=torch.int32,
                           device=pos.device)
        offset = 0
        pm, dm = pos[..., None, :], dirn[..., None, :]
        for spec, params, size in zip(scene.specs, scene.group_params,
                                      scene.group_sizes):
            if not _is_analytic_spec(spec):
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
                bidx = torch.where(better, offset + arg.to(torch.int32),
                                   bidx)
            best = torch.where(better, t, best)
            offset += size
        return best, bidx


def _autograd_normal(spec, prm, pos):
    """Gradient of the spec's SDF at ``pos`` by autograd (each lane's
    distance depends on its own position only, so the gradient of the sum
    is the per-lane gradient).  Under grad mode with ``pos`` or a
    parameter requiring a gradient, the normal stays in the graph
    (``create_graph``), as the reference's ``jax.grad`` normal is
    differentiated through."""
    if _needs_graph(pos, *_leaves(prm)):
        p = pos if pos.requires_grad else pos.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(eval_spec(spec, prm, p).sum(), p,
                                   create_graph=True)
        return g
    with torch.enable_grad():
        p = pos.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(eval_spec(spec, prm, p).sum(), p)
    return g


def surface_normal(scene, pos, idx):
    """Unit surface normal of prim ``idx`` (concatenated-group order, from
    :func:`ray_bound_idx` or the marched probe) at world points
    ``pos [B, 3]``: the gradient of that prim's world-space SDF.  Sphere
    and box take their closed forms (with the row-vector transform
    ``p_local = p @ M[:3, :3] + M[3, :3]`` the world gradient is
    ``M[:3, :3] @ grad_local``); every other kind -- modifiers and CSG
    models included -- is differentiated by autograd through
    :func:`~rsmcrt_tpu_torch.sdfs.scene.eval_spec`.  Normalised with the
    reference's +1e-30 under the square root.  A ``geometry`` span."""
    with obs.span("geometry"):
        out = torch.zeros_like(pos)
        offset = 0
        for spec, params, size in zip(scene.specs, scene.group_params,
                                      scene.group_sizes):
            if size == 1:
                prm = tree_map(lambda v: v[0], params)
            else:
                member = torch.clamp(idx - offset, 0, size - 1).long()
                prm = tree_map(lambda v: v[member], params)
            if spec.kind in ("sphere", "box"):
                T = prm["transform"]
                p = apply_transform(T, pos)
                if spec.kind == "sphere":
                    g = sdp.grad_sd_sphere(p, prm["radius"])
                else:
                    g = sdp.grad_sd_box(p, prm["half_lengths"])
                n = (g[..., None, :] * T[..., :3, :3]).sum(-1)
            else:
                n = _autograd_normal(spec, prm, pos)
            n = n / torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-30)
            sel = (idx >= offset) & (idx < offset + size)
            out = torch.where(sel[..., None], n, out)
            offset += size
        return out
