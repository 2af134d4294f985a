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

from .grid import CartGrid
from .optics.piecewise import Constant
from .sdfs.scene import PrimSpec, Scene, SceneTables
from .sources.sources import Source
from .tally import Tallies
from .transport.engine import LaneState, SimCarry


def _t(a, device):
    return torch.as_tensor(np.array(a, copy=True), device=device)


def grid_from_numpy(g, device="cpu") -> CartGrid:
    return CartGrid(float(np.asarray(g.xmax)), float(np.asarray(g.ymax)),
                    float(np.asarray(g.zmax)), int(g.nxg), int(g.nyg),
                    int(g.nzg), device=device)


def scene_from_numpy(s, device="cpu") -> Scene:
    """Keeps ``specs`` order, ``group_sizes``, ``perm`` and ``layer_ids``
    as they are, so prim-index conventions (concatenated-group order for
    ``ray_bound_idx`` and ``surface_normal``) agree."""
    specs = tuple(
        PrimSpec(sp.kind, {k: _t(v, device) for k, v in sp.params.items()},
                 layer=sp.layer)
        for sp in s.specs)
    group_params = [{k: _t(v, device).to(torch.float32)
                     for k, v in gp.items()} for gp in s.group_params]
    tb = s.tables
    if getattr(tb, "wavelengths", None) is not None:
        raise NotImplementedError(
            "spectral optical tables are not ported (ROADMAP queue 1, "
            "item 11)")
    tables = SceneTables(mus=_t(tb.mus, device), mua=_t(tb.mua, device),
                         hgg=_t(tb.hgg, device), n=_t(tb.n, device))
    return Scene(group_params=group_params, tables=tables, specs=specs,
                 group_sizes=tuple(s.group_sizes), perm=tuple(s.perm),
                 layer_ids=tuple(s.layer_ids), n_prims=int(s.n_prims))


def source_from_numpy(src, device="cpu") -> Source:
    spectrum = None
    if src.spectrum is not None:
        if not hasattr(src.spectrum, "value"):
            raise NotImplementedError(
                "only Constant spectra are ported (ROADMAP queue 1, "
                "item 11)")
        spectrum = Constant(_t(src.spectrum.value, device).to(
            torch.float32))
    return Source(kind=src.kind,
                  params={k: _t(v, device) for k, v in src.params.items()},
                  spectrum=spectrum, subtype=src.subtype)


def carry_from_numpy(c, device="cpu") -> SimCarry:
    if getattr(c, "bank", None) is not None:
        raise NotImplementedError(
            "detector banks are not ported (ROADMAP queue 1, item 7)")
    state = LaneState(**{f.name: _t(getattr(c.state, f.name), device)
                         for f in dataclasses.fields(LaneState)})
    tallies = Tallies(**{f.name: _t(getattr(c.tallies, f.name), device)
                         for f in dataclasses.fields(Tallies)})
    return SimCarry(state=state, tallies=tallies, bank=None,
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
