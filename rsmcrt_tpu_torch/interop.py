"""Carry parameters and state over from the reference package.

Each ``*_from_numpy`` takes an ``rsmcrt_tpu`` object after
``jax.tree_util.tree_map(np.asarray, obj)`` -- so every array leaf is a
NumPy array -- reads it by attribute only, and returns this package's
object on ``device``.  :func:`carry_to_numpy` goes the other way, for
comparison.  Nothing here imports ``jax`` or ``rsmcrt_tpu``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .detectors import detectors as D
from .grid import CartGrid
from .optics.piecewise import Constant, Piecewise1D, Piecewise2D
from .sdfs.scene import (VECTOR_PARAMS, PrimSpec, Scene,
                          SceneTables)
from .sources.sources import Source
from .tally import Tallies
from .transport.engine import LaneState, SimCarry


def _t(a, device):
    return torch.as_tensor(np.array(a, copy=True), device=device)


def grid_from_numpy(g, device="cpu") -> CartGrid:
    return CartGrid(float(np.asarray(g.xmax)), float(np.asarray(g.ymax)),
                    float(np.asarray(g.zmax)), int(g.nxg), int(g.nyg),
                    int(g.nzg), device=device)


def _spec_from_numpy(sp, device, disp_funcs) -> PrimSpec:
    """This package's spec tree for a reference ``PrimSpec`` tree."""
    twin = None
    if sp.disp_func is not None:
        twin = (disp_funcs or {}).get(sp.disp_func)
        if twin is None:
            raise NotImplementedError(
                "a displacement modifier's JAX callable cannot run in "
                "PyTorch: pass its PyTorch twin in disp_funcs")
    params = {k: _vector_param(sp.kind, k, _t(v, device).to(torch.float32),
                               np.ndim(v))
              for k, v in sp.params.items()}
    return PrimSpec(sp.kind, params,
                    children=[_spec_from_numpy(c, device, disp_funcs)
                              for c in sp.children],
                    layer=sp.layer, op=sp.op, disp_func=twin)


def _vector_param(kind, key, t, own_ndim):
    """Broadcast a scalar 3-vector parameter (``elongate`` size,
    ``repeat`` c / la / lb) to a trailing axis of 3, as this package's
    constructors store it."""
    if key in VECTOR_PARAMS.get(kind, ()) and own_ndim == 0:
        return t[..., None].expand(t.shape + (3,)).contiguous()
    return t


def _group_params_from_numpy(spec, sp_ref, gp, device):
    out = {}
    for k, v in gp.items():
        if k.startswith("child") and k[5:].isdigit():
            i = int(k[5:])
            out[k] = _group_params_from_numpy(spec.children[i],
                                              sp_ref.children[i], v, device)
        else:
            out[k] = _vector_param(spec.kind, k,
                                   _t(v, device).to(torch.float32),
                                   np.ndim(sp_ref.params[k]))
    return out


def scene_from_numpy(s, device="cpu", disp_funcs=None) -> Scene:
    """Keeps ``specs`` order, ``group_sizes``, ``perm`` and ``layer_ids``
    as they are, so prim-index conventions (concatenated-group order for
    ``ray_bound_idx`` and ``surface_normal``) agree.  Nested specs
    (modifiers, CSG models) carry over with their ``child{i}`` parameter
    trees; a displacement modifier needs ``disp_funcs``, a map from the
    reference's JAX callable to its PyTorch twin."""
    specs = tuple(_spec_from_numpy(sp, device, disp_funcs)
                  for sp in s.specs)
    group_params = [_group_params_from_numpy(sp, ref, gp, device)
                    for sp, ref, gp in zip(specs, s.specs, s.group_params)]
    tb = s.tables
    wl = getattr(tb, "wavelengths", None)
    tables = SceneTables(mus=_t(tb.mus, device), mua=_t(tb.mua, device),
                         hgg=_t(tb.hgg, device), n=_t(tb.n, device),
                         wavelengths=None if wl is None else _t(wl, device))
    return Scene(group_params=group_params, tables=tables, specs=specs,
                 group_sizes=tuple(s.group_sizes), perm=tuple(s.perm),
                 layer_ids=tuple(s.layer_ids), n_prims=int(s.n_prims))


def spectrum_from_numpy(sp, device="cpu"):
    """A ``Constant``, ``Piecewise1D`` or ``Piecewise2D`` (or None), told
    apart by the reference object's fields."""
    if sp is None:
        return None

    def f(a):
        return _t(a, device).to(torch.float32)

    if hasattr(sp, "value"):
        return Constant(f(sp.value))
    if hasattr(sp, "width"):
        return Piecewise2D(cdf=f(sp.cdf), width=int(sp.width),
                           height=int(sp.height),
                           cell_width=f(sp.cell_width),
                           cell_height=f(sp.cell_height))
    return Piecewise1D(x=f(sp.x), y=f(sp.y), cdf=f(sp.cdf))


def source_from_numpy(src, device="cpu") -> Source:
    return Source(kind=src.kind,
                  params={k: _t(v, device) for k, v in src.params.items()},
                  spectrum=spectrum_from_numpy(src.spectrum, device),
                  subtype=src.subtype)


_FAMILY_CLASS = {"circle": D.CircleDetectors,
                 "annulus": D.AnnulusDetectors,
                 "fibre": D.FibreDetectors, "camera": D.CameraDetectors}


def bank_from_numpy(b, device="cpu"):
    """A ``DetectorBank`` (or None) with the same families, parameters,
    bins and config order."""
    if b is None:
        return None

    def family(name):
        f = getattr(b, name)
        if f is None:
            return None
        cls = _FAMILY_CLASS[name]
        kw = {}
        for fld in dataclasses.fields(cls):
            v = getattr(f, fld.name)
            kw[fld.name] = (int(v) if fld.name == "nbins" else
                            None if v is None else _t(v, device))
        return cls(**kw)

    return D.DetectorBank(
        **{name: family(name) for name in D.FAMILIES},
        target_values=_t(b.target_values, device),
        order=tuple((str(f), int(m)) for f, m in b.order),
        ids=tuple(b.ids), layers=tuple(b.layers))


def carry_from_numpy(c, device="cpu") -> SimCarry:
    state = LaneState(**{f.name: _t(getattr(c.state, f.name), device)
                         for f in dataclasses.fields(LaneState)})
    tallies = Tallies(**{f.name: _t(getattr(c.tallies, f.name), device)
                         for f in dataclasses.fields(Tallies)})
    return SimCarry(state=state, tallies=tallies,
                    bank=bank_from_numpy(getattr(c, "bank", None), device),
                    launched=_t(c.launched, device).to(torch.int32),
                    step=_t(c.step, device).to(torch.int32))


def carry_to_numpy(c: SimCarry) -> dict:
    """``{"state": {field: array}, "tallies": {field: array},
    "launched": int, "step": int}``."""
    def host(x):
        return x.detach().cpu().numpy()

    return {
        "state": {f.name: host(getattr(c.state, f.name))
                  for f in dataclasses.fields(LaneState)},
        "tallies": {f.name: host(getattr(c.tallies, f.name))
                    for f in dataclasses.fields(Tallies)},
        "launched": int(c.launched),
        "step": int(c.step),
    }
