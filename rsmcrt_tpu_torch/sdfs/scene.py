"""Scene representation and batched SDF evaluation (port of
``rsmcrt_tpu/sdfs/scene.py``).

A scene is a tuple of ``PrimSpec`` trees (a primitive, a modifier wrapping
a child, or a CSG model folding children; reference:
src/sdfs/sdf_base.f90, src/sdfs/sdfModifiers.f90) grouped by structural
signature, with each group's parameter tree (nested ``child{i}`` dicts)
stacked along a leading member axis, plus a per-layer optical table.
``eval_scene`` evaluates each group by broadcasting over its members and
permutes the columns back to the user's prim order.  Layer semantics
match the reference: 0 = outside, i+1 = prim i (reference:
src/kernelsMod.f90:1952).  A scene with a prim of spectral optical
properties gets ``[W, N+1]`` tables over ``W`` wavelength bins, which the
transport interpolates per photon wavelength.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from .. import obs
from ..grid import np_dtype
from ..maths.transforms import apply_transform, identity
from ..optics.piecewise import sample_piecewise1d_at
from ..optics.properties import OptProps, SpectralOptProps
from . import primitives as sdp

_PRIM_PARAM_NAMES = {
    "sphere": ("radius",),
    "box": ("half_lengths",),
    "torus": ("oradius", "iradius"),
    "cylinder": ("a", "b", "radius"),
    "triprism": ("h1", "h2"),
    "segment": ("a", "b"),
    "capsule": ("a", "b", "r"),
    "cone": ("a", "b", "ra", "rb"),
    "egg": ("r1", "r2", "h"),
    "plane": ("a",),
}

_PRIM_FNS = {
    "sphere": sdp.sd_sphere,
    "box": sdp.sd_box,
    "torus": sdp.sd_torus,
    "cylinder": sdp.sd_cylinder,
    "triprism": sdp.sd_triprism,
    "segment": sdp.sd_segment,
    "capsule": sdp.sd_capsule,
    "cone": sdp.sd_cone,
    "egg": sdp.sd_egg,
    "plane": sdp.sd_plane,
}

_MODIFIERS = ("revolution", "extrude", "onion", "twist", "bend",
              "elongate", "displacement", "repeat")

_CSG_OPS = ("union", "smooth_union", "subtraction", "intersection")

#: modifier parameters that are 3-vectors; a scalar given for one is
#: broadcast to (3,) at construction so stacked members broadcast against
#: positions the same way the reference's per-member scalars do
VECTOR_PARAMS = {"elongate": ("size",), "repeat": ("c", "la", "lb"),
                 "revolution": ("center",)}


class PrimSpec:
    """One node of a scene: a primitive, a modifier wrapping a child, or a
    CSG model combining children.  ``params`` are float tensors of the
    builder's ``dtype`` (a primitive's include its inverse world
    ``transform``); ``disp_func``
    is the displacement modifier's PyTorch callable ``pos [..., 3] ->
    [...]``."""

    def __init__(self, kind: str, params: dict[str, Any],
                 children: Sequence["PrimSpec"] = (), layer: int = 1,
                 opt: Optional[OptProps] = None, op: Optional[str] = None,
                 disp_func: Optional[Callable] = None):
        self.kind = kind
        self.params = dict(params)
        self.children = list(children)
        self.layer = layer
        self.opt = opt
        self.op = op
        self.disp_func = disp_func

    def signature(self):
        """Static structure key used to group identically shaped prims."""
        return (self.kind, self.op, self.disp_func,
                tuple(sorted(self.params.keys())),
                tuple(c.signature() for c in self.children))


def _as_t(v, device, dtype=torch.float32):
    """A ``dtype`` copy of ``v`` (a number, a sequence, an array or a
    tensor on any device) on ``device``.  A tensor is copied with
    ``Tensor.to``, so one that requires a gradient stays in the graph."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype, copy=True)
    return torch.as_tensor(np.array(v, np_dtype(dtype)), device=device)


def _prim(kind, layer, opt, transform, device, dtype, **params) -> PrimSpec:
    t = (identity(dtype, device) if transform is None
         else _as_t(transform, device, dtype))
    p = {k: _as_t(v, device, dtype) for k, v in params.items()}
    p["transform"] = t
    return PrimSpec(kind, p, layer=layer, opt=opt)


# -- constructor API mirroring the reference init functions ------------------

def sphere(radius, opt, layer, transform=None, device="cpu",
           dtype=torch.float32):
    return _prim("sphere", layer, opt, transform, device, dtype, radius=radius)


def box(lengths, opt, layer, transform=None, device="cpu",
        dtype=torch.float32):
    """``lengths`` are full extents; halved at init like the reference
    (src/sdfs/sdfs.f90:455)."""
    half = (0.5 * lengths if isinstance(lengths, torch.Tensor)
            else 0.5 * np.asarray(lengths, dtype=np.float64))
    return _prim("box", layer, opt, transform, device, dtype,
                 half_lengths=half)


def torus(oradius, iradius, opt, layer, transform=None, device="cpu",
          dtype=torch.float32):
    return _prim("torus", layer, opt, transform, device, dtype,
                 oradius=oradius, iradius=iradius)


def cylinder(a, b, radius, opt, layer, transform=None, device="cpu",
             dtype=torch.float32):
    return _prim("cylinder", layer, opt, transform, device, dtype, a=a, b=b,
                 radius=radius)


def triprism(h1, h2, opt, layer, transform=None, device="cpu",
             dtype=torch.float32):
    return _prim("triprism", layer, opt, transform, device, dtype, h1=h1,
                 h2=h2)


def segment(a, b, opt, layer, transform=None, device="cpu",
            dtype=torch.float32):
    return _prim("segment", layer, opt, transform, device, dtype, a=a, b=b)


def capsule(a, b, r, opt, layer, transform=None, device="cpu",
            dtype=torch.float32):
    return _prim("capsule", layer, opt, transform, device, dtype, a=a, b=b,
                 r=r)


def cone(a, b, ra, rb, opt, layer, transform=None, device="cpu",
         dtype=torch.float32):
    return _prim("cone", layer, opt, transform, device, dtype, a=a, b=b, ra=ra,
                 rb=rb)


def egg(r1, r2, h, opt, layer, transform=None, device="cpu",
        dtype=torch.float32):
    return _prim("egg", layer, opt, transform, device, dtype, r1=r1, r2=r2,
                 h=h)


def plane(a, opt, layer, transform=None, device="cpu",
          dtype=torch.float32):
    return _prim("plane", layer, opt, transform, device, dtype, a=a)


# -- modifiers (reference: src/sdfs/sdfModifiers.f90) ------------------------

def _modifier(kind, child: PrimSpec, device="cpu", dtype=torch.float32,
              **params) -> PrimSpec:
    p = {}
    for k, v in params.items():
        t = _as_t(v, device, dtype)
        if k in VECTOR_PARAMS.get(kind, ()):
            t = torch.broadcast_to(t, (3,)).clone()
        p[k] = t
    return PrimSpec(kind, p, children=[child], layer=child.layer,
                    opt=child.opt)


def revolution(child, o, center=(0.0, 0.0, 0.0), device="cpu",
               dtype=torch.float32):
    return _modifier("revolution", child, device, dtype, o=o, center=center)


def extrude(child, h, device="cpu", dtype=torch.float32):
    return _modifier("extrude", child, device, dtype, h=h)


def onion(child, thickness, device="cpu", dtype=torch.float32):
    return _modifier("onion", child, device, dtype, thickness=thickness)


def twist(child, k, device="cpu", dtype=torch.float32):
    return _modifier("twist", child, device, dtype, k=k)


def bend(child, k, device="cpu", dtype=torch.float32):
    return _modifier("bend", child, device, dtype, k=k)


def elongate(child, size, device="cpu", dtype=torch.float32):
    return _modifier("elongate", child, device, dtype, size=size)


def displacement(child, func: Callable, device="cpu", dtype=torch.float32):
    """``func`` maps positions ``[..., 3]`` to a displacement ``[...]``
    with PyTorch operations."""
    spec = _modifier("displacement", child, device, dtype)
    spec.disp_func = func
    return spec


def repeat(child, c, la, lb, device="cpu", dtype=torch.float32):
    """Finite repetition (the standard Quilez finite-repeat formula; the
    reference declares but never implements it,
    src/sdfs/sdfModifiers.f90:410-426)."""
    return _modifier("repeat", child, device, dtype, c=c, la=la, lb=lb)


def model(children: Sequence[PrimSpec], op: str, k: float = 0.0,
          device="cpu", dtype=torch.float32):
    """CSG model folding children with ``op``
    (reference: src/sdfs/sdf_base.f90:101-161)."""
    if op not in _CSG_OPS:
        raise ValueError(f"unknown CSG op {op!r}")
    return PrimSpec("model", {"k": _as_t(k, device, dtype)},
                    children=list(children), layer=children[0].layer,
                    opt=children[0].opt, op=op)


# ---------------------------------------------------------------------------
# CSG operator functions (reference: sdfModifiers.f90:428-492)
# ---------------------------------------------------------------------------

def op_union(d1, d2, k):
    return torch.minimum(d1, d2)


def op_smooth_union(d1, d2, k):
    h = sdp.relu_jt(k - sdp.abs_jt(d1 - d2)) / k
    return torch.minimum(d1, d2) - h * h * h * k * (1.0 / 6.0)


def op_subtraction(d1, d2, k):
    return torch.maximum(-d1, d2)


def op_intersection(d1, d2, k):
    return torch.maximum(d1, d2)


_OP_FNS = {
    "union": op_union,
    "smooth_union": op_smooth_union,
    "subtraction": op_subtraction,
    "intersection": op_intersection,
}


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

def _rotate_pairs(c, s, pos):
    return torch.stack([c * pos[..., 0] - s * pos[..., 1],
                        s * pos[..., 0] + c * pos[..., 1],
                        torch.broadcast_to(pos[..., 2], c.shape)], dim=-1)


def eval_spec(spec: PrimSpec, params: dict, pos: torch.Tensor):
    """Distance of ``pos [..., 3]`` to the spec tree ``spec`` with the
    parameter tree ``params``, whose leaves may carry leading member axes
    that broadcast against ``pos[..., 0]``."""
    kind = spec.kind
    if kind in _PRIM_FNS:
        p = apply_transform(params["transform"], pos)
        args = {k: params[k] for k in _PRIM_PARAM_NAMES[kind]}
        return _PRIM_FNS[kind](p, **args)
    child = spec.children[0] if spec.children else None
    if kind == "revolution":
        # reference: sdfModifiers.f90:303-321
        p_in = pos - params["center"]
        pxz = torch.sqrt(p_in[..., 0] ** 2 + p_in[..., 2] ** 2)
        q = torch.stack([pxz - params["o"], p_in[..., 1],
                         torch.zeros_like(pxz)], dim=-1)
        return eval_spec(child, params["child0"], q)
    if kind == "extrude":
        # reference: sdfModifiers.f90:286-301
        wx = eval_spec(child, params["child0"], pos)
        wy = sdp.abs_jt(pos[..., 2]) - params["h"]
        first = -sdp.relu_jt(-torch.maximum(wx, wy))
        second = torch.sqrt(sdp.relu_jt(wx) ** 2 + sdp.relu_jt(wy) ** 2)
        return first + second
    if kind == "onion":
        d = eval_spec(child, params["child0"], pos)
        return sdp.abs_jt(d) - params["thickness"]
    if kind == "twist":
        # reference: sdfModifiers.f90:353-371
        a = params["k"] * pos[..., 2]
        q = _rotate_pairs(torch.cos(a), torch.sin(a), pos)
        return eval_spec(child, params["child0"], q)
    if kind == "bend":
        # reference: sdfModifiers.f90:373-391
        a = params["k"] * pos[..., 0]
        q = _rotate_pairs(torch.cos(a), torch.sin(a), pos)
        return eval_spec(child, params["child0"], q)
    if kind == "elongate":
        # reference: sdfModifiers.f90:335-351
        q = sdp.abs_jt(pos) - params["size"]
        w = -sdp.relu_jt(-torch.amax(q, dim=-1))
        return eval_spec(child, params["child0"], sdp.relu_jt(q)) + w
    if kind == "displacement":
        return eval_spec(child, params["child0"], pos) + spec.disp_func(pos)
    if kind == "repeat":
        c = params["c"]
        q = pos - c * torch.clamp(torch.round(pos / c), params["la"],
                                  params["lb"])
        return eval_spec(child, params["child0"], q)
    if kind == "model":
        res = eval_spec(spec.children[0], params["child0"], pos)
        fn = _OP_FNS[spec.op]
        for i, ch in enumerate(spec.children[1:], start=1):
            res = fn(res, eval_spec(ch, params[f"child{i}"], pos),
                     params["k"])
        return res
    raise ValueError(f"unknown spec kind {spec.kind!r}")


def collect_params(spec: PrimSpec) -> dict:
    """The spec's parameter tree: its own tensors plus ``child{i}`` for
    each child's tree."""
    out = dict(spec.params)
    for i, ch in enumerate(spec.children):
        out[f"child{i}"] = collect_params(ch)
    return out


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a nested parameter dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_stack(trees, device, dtype):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_stack([t[k] for t in trees], device, dtype)
                for k in first}
    return torch.stack([t.to(device, dtype) for t in trees])


@dataclass
class SceneTables:
    """Per-layer optical property tables, index 0 = outside: ``[N+1]`` for
    a monochromatic scene, ``[W, N+1]`` over ``wavelengths [W]`` for a
    spectral one.  ``kappa`` and ``albedo`` are derived once, in the
    tables' type, as the reference derives them (and again by
    ``dataclasses.replace``, so a ``mua`` that requires a gradient carries
    it into both)."""

    mus: torch.Tensor
    mua: torch.Tensor
    hgg: torch.Tensor
    n: torch.Tensor
    wavelengths: Optional[torch.Tensor] = None
    kappa: torch.Tensor = field(init=False, repr=False)
    albedo: torch.Tensor = field(init=False, repr=False)

    def __post_init__(self):
        self.kappa = self.mus + self.mua
        safe = torch.where(self.kappa > 0.0, self.kappa, 1.0)
        self.albedo = torch.where(self.mua < 1e-9, 1.0, self.mus / safe)


@dataclass
class Scene:
    """Grouped scene.  ``group_params[g]`` holds the stacked parameter
    trees of every prim sharing structure ``specs[g]``; ``perm`` maps
    concatenated group columns back to the user's prim order."""

    group_params: list
    tables: SceneTables
    specs: tuple
    group_sizes: tuple
    perm: tuple
    layer_ids: tuple
    n_prims: int
    _perm_idx: Optional[torch.Tensor] = field(init=False, repr=False)
    #: the prims with no closed-form crossing, which the walk marches:
    #: their columns in user order (``eval_scene``'s, long) and in concat
    #: order (what ``surface_normal`` consumes, int32), made here once, as
    #: a copy from the host waits for the card and cannot be captured
    march_cols: tuple = field(init=False, repr=False)
    #: a slot for a table the transport derives from the scene once and
    #: keeps for the scene's life; None until then, and in a scene made by
    #: ``dataclasses.replace``
    walk_table: Optional[tuple] = field(default=None, init=False, repr=False)

    def __post_init__(self):
        from .raycast import analytic_column_mask

        self.perm = tuple(int(p) for p in self.perm)
        if self.perm == tuple(range(self.n_prims)):
            self._perm_idx = None
        else:
            self._perm_idx = torch.as_tensor(
                self.perm, dtype=torch.long, device=self.device)
        na = [i for i, a in enumerate(analytic_column_mask(self)) if not a]
        self.march_cols = (
            torch.as_tensor(na, dtype=torch.long, device=self.device),
            torch.as_tensor([self.perm[i] for i in na], dtype=torch.int32,
                            device=self.device))

    @property
    def device(self) -> torch.device:
        return self.tables.mus.device


def build_scene(prims: Sequence[PrimSpec], device=None,
                n_wavelength_bins: int = 64,
                dtype=torch.float32) -> Scene:
    """Group prims by structural signature and stack their parameter
    trees, in ``dtype`` (float32, or float64 for a float64 run: the
    scene's type is the run's, ``simulate`` reads it from
    ``tables.mus``).  With any prim of :class:`SpectralOptProps`, the
    optical tables are sampled at ``n_wavelength_bins`` wavelengths
    spanning every spectral table (reference package: scene.py:455-490)."""
    if device is None:
        device = next(iter(_leaves(collect_params(prims[0])))).device
    groups: dict = {}
    order: list = []
    for i, pr in enumerate(prims):
        sig = pr.signature()
        if sig not in groups:
            groups[sig] = []
            order.append(sig)
        groups[sig].append(i)

    group_params, specs, group_sizes, concat_order = [], [], [], []
    for sig in order:
        idxs = groups[sig]
        group_params.append(_tree_stack(
            [collect_params(prims[i]) for i in idxs], device, dtype))
        specs.append(prims[idxs[0]])
        group_sizes.append(len(idxs))
        concat_order.extend(idxs)

    # perm[user_index] = column position in the concatenated group output
    perm = [0] * len(prims)
    for col, user_idx in enumerate(concat_order):
        perm[user_idx] = col

    for pr in prims:
        if not isinstance(pr.opt, (OptProps, SpectralOptProps)):
            raise TypeError(
                f"optical properties {type(pr.opt).__name__} are neither "
                "OptProps nor SpectralOptProps")
    spectral = [pr.opt for pr in prims
                if isinstance(pr.opt, SpectralOptProps)]
    wgrid = None
    if spectral:
        tabs = [getattr(o, f"{q}_tab") for o in spectral
                for q in ("mus", "mua", "hgg", "n")]
        lo = min(float(t.x[0]) for t in tabs)
        hi = max(float(t.x[-1]) for t in tabs)
        wgrid = torch.as_tensor(np.linspace(lo, hi, n_wavelength_bins,
                                            dtype=np_dtype(dtype)),
                                device=device)

    def opt_field(name, sentinel):
        if wgrid is None:
            vals = [sentinel] + [getattr(pr.opt, name) for pr in prims]
            return torch.stack([_as_t(v, device, dtype) for v in vals])
        cols = [torch.full_like(wgrid, sentinel)]
        for pr in prims:
            if isinstance(pr.opt, SpectralOptProps):
                tab = getattr(pr.opt, name + "_tab").to(device, dtype)
                cols.append(sample_piecewise1d_at(tab, wgrid))
            else:
                cols.append(torch.full_like(wgrid,
                                            float(getattr(pr.opt, name))))
        return torch.stack(cols, dim=-1)  # [W, N+1]

    tables = SceneTables(
        mus=opt_field("mus", 0.0),
        mua=opt_field("mua", 0.0),
        hgg=opt_field("hgg", 0.0),
        n=opt_field("n", 1.0),
        wavelengths=wgrid,
    )
    return Scene(
        group_params=group_params, tables=tables, specs=tuple(specs),
        group_sizes=tuple(group_sizes), perm=tuple(perm),
        layer_ids=tuple(pr.layer for pr in prims), n_prims=len(prims),
    )


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def eval_scene(scene: Scene, pos: torch.Tensor) -> torch.Tensor:
    """Distances to every prim: ``pos [..., 3] -> ds [..., N]`` in the
    user's prim order.  A ``geometry`` span."""
    with obs.span("geometry"):
        pm = pos[..., None, :]  # member axis of each group
        cols = [eval_spec(spec, params, pm)
                for spec, params in zip(scene.specs, scene.group_params)]
        ds = cols[0] if len(cols) == 1 else torch.cat(cols, dim=-1)
        if scene._perm_idx is None:
            return ds
        return ds.index_select(-1, scene._perm_idx)


def scene_layer(ds: torch.Tensor) -> torch.Tensor:
    """Innermost containing prim: 1-based index of ``maxloc(ds, ds<0)``,
    0 when outside everything (reference: src/kernelsMod.f90:1952).  int32;
    the first index wins a tie, as in the reference."""
    neg = ds < 0.0
    masked = torch.where(neg, ds, -torch.inf)
    idx = torch.argmax(masked, dim=-1).to(torch.int32) + 1
    return torch.where(torch.any(neg, dim=-1), idx, 0)


_TET = ((1.0, -1.0, -1.0), (-1.0, -1.0, 1.0), (-1.0, 1.0, -1.0),
        (1.0, 1.0, 1.0))


def calc_normals(scene: Scene, pos: torch.Tensor, h: float) -> torch.Tensor:
    """Tetrahedron finite-difference surface normals of *every* prim at
    ``pos [..., 3] -> n [..., N, 3]`` (reference:
    src/sdfs/sdf_base.f90:166-190)."""
    offs = torch.as_tensor(_TET, dtype=pos.dtype, device=pos.device)
    ds = eval_scene(scene, pos[..., None, :] + offs * h)  # [..., 4, N]
    n = sum(ds[..., k, :, None] * offs[k] for k in range(4))  # [..., N, 3]
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    return n / torch.where(norm > 0.0, norm, 1.0)
