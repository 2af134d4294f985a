"""Scene representation and batched SDF evaluation (port of
``rsmcrt_tpu/sdfs/scene.py`` for the analytic sphere and box prims).

A scene is a tuple of ``PrimSpec`` structures grouped by signature, with
each group's parameters stacked along a leading member axis, plus a
per-layer optical table.  ``eval_scene`` evaluates each group by
broadcasting over its members and permutes the columns back to the user's
prim order.  Layer semantics match the reference: 0 = outside, i+1 =
prim i (reference: src/kernelsMod.f90:1952).

Modifiers, CSG models, the other eight primitives and spectral optical
tables are still to port (ROADMAP queue 1, item 11); building a scene with
them raises ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..maths.transforms import apply_transform, identity
from ..optics.properties import OptProps
from . import primitives as sdp

_PRIM_PARAM_NAMES = {
    "sphere": ("radius",),
    "box": ("half_lengths",),
}

_PRIM_FNS = {
    "sphere": sdp.sd_sphere,
    "box": sdp.sd_box,
}

_NOT_PORTED = ("only sphere and box prims are ported (ROADMAP queue 1, "
               "item 11: full geometry)")


class PrimSpec:
    """One primitive of a scene: its kind, its parameters (tensors, incl.
    the inverse world ``transform``), its layer and optical properties."""

    def __init__(self, kind: str, params: dict[str, Any], layer: int = 1,
                 opt: Optional[OptProps] = None):
        if kind not in _PRIM_FNS:
            raise NotImplementedError(f"prim kind {kind!r}: {_NOT_PORTED}")
        self.kind = kind
        self.params = dict(params)
        self.layer = layer
        self.opt = opt

    def signature(self):
        """Static structure key used to group identically shaped prims."""
        return (self.kind, tuple(sorted(self.params.keys())))


def _prim(kind, layer, opt, transform, device, **params) -> PrimSpec:
    f = torch.float32
    t = (identity(f, device) if transform is None
         else torch.as_tensor(transform, dtype=f, device=device))
    p = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
         for k, v in params.items()}
    p["transform"] = t
    return PrimSpec(kind, p, layer=layer, opt=opt)


def sphere(radius, opt, layer, transform=None, device="cpu"):
    return _prim("sphere", layer, opt, transform, device, radius=radius)


def box(lengths, opt, layer, transform=None, device="cpu"):
    """``lengths`` are full extents; halved at init like the reference
    (src/sdfs/sdfs.f90:455)."""
    half = 0.5 * np.asarray(lengths, dtype=np.float64)
    return _prim("box", layer, opt, transform, device, half_lengths=half)


def eval_spec(spec: PrimSpec, params: dict, pos: torch.Tensor):
    """Distance of ``pos [..., 3]`` to prim ``spec`` with parameters
    ``params`` (which may carry a member axis that broadcasts)."""
    p = apply_transform(params["transform"], pos)
    args = {k: params[k] for k in _PRIM_PARAM_NAMES[spec.kind]}
    return _PRIM_FNS[spec.kind](p, **args)


@dataclass
class SceneTables:
    """Per-layer optical property table ``[N+1]``, index 0 = outside.
    ``kappa`` and ``albedo`` are derived once, in float32, as the reference
    derives them."""

    mus: torch.Tensor
    mua: torch.Tensor
    hgg: torch.Tensor
    n: torch.Tensor
    wavelengths: object = None
    kappa: torch.Tensor = field(init=False, repr=False)
    albedo: torch.Tensor = field(init=False, repr=False)

    def __post_init__(self):
        if self.wavelengths is not None:
            raise NotImplementedError(
                "spectral optical tables are not ported (ROADMAP queue 1, "
                "item 11: spectral optics)")
        self.kappa = self.mus + self.mua
        safe = torch.where(self.kappa > 0.0, self.kappa, 1.0)
        self.albedo = torch.where(self.mua < 1e-9, 1.0, self.mus / safe)


@dataclass
class Scene:
    """Grouped scene.  ``group_params[g]`` holds the stacked parameters of
    every prim sharing structure ``specs[g]``; ``perm`` maps concatenated
    group columns back to the user's prim order."""

    group_params: list
    tables: SceneTables
    specs: tuple
    group_sizes: tuple
    perm: tuple
    layer_ids: tuple
    n_prims: int
    _perm_idx: Optional[torch.Tensor] = field(init=False, repr=False)

    def __post_init__(self):
        self.perm = tuple(int(p) for p in self.perm)
        if self.perm == tuple(range(self.n_prims)):
            self._perm_idx = None
        else:
            self._perm_idx = torch.as_tensor(
                self.perm, dtype=torch.long, device=self.device)

    @property
    def device(self) -> torch.device:
        return self.tables.mus.device


def build_scene(prims: Sequence[PrimSpec], device=None) -> Scene:
    """Group prims by structural signature and stack their parameters."""
    if device is None:
        device = prims[0].params["transform"].device
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
        keys = prims[idxs[0]].params.keys()
        group_params.append({
            k: torch.stack([prims[i].params[k].to(device, torch.float32)
                            for i in idxs])
            for k in keys
        })
        specs.append(prims[idxs[0]])
        group_sizes.append(len(idxs))
        concat_order.extend(idxs)

    # perm[user_index] = column position in the concatenated group output
    perm = [0] * len(prims)
    for col, user_idx in enumerate(concat_order):
        perm[user_idx] = col

    def opt_field(name, sentinel):
        vals = [sentinel] + [getattr(pr.opt, name) for pr in prims]
        return torch.as_tensor(np.asarray(vals, np.float32), device=device)

    tables = SceneTables(
        mus=opt_field("mus", 0.0),
        mua=opt_field("mua", 0.0),
        hgg=opt_field("hgg", 0.0),
        n=opt_field("n", 1.0),
    )
    return Scene(
        group_params=group_params, tables=tables, specs=tuple(specs),
        group_sizes=tuple(group_sizes), perm=tuple(perm),
        layer_ids=tuple(pr.layer for pr in prims), n_prims=len(prims),
    )


def eval_scene(scene: Scene, pos: torch.Tensor) -> torch.Tensor:
    """Distances to every prim: ``pos [..., 3] -> ds [..., N]`` in the
    user's prim order."""
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
