"""Prebuilt experiment scenes (port of ``rsmcrt_tpu/scenes.py``: the
``sphere``, ``box`` and ``scat_test`` scenes) and the registry that
dispatches on the config's ``geom_name`` (reference:
src/setup.f90:33-60)."""

from __future__ import annotations

import torch

from .maths import transforms as T
from .optics.properties import mono
from .sdfs import scene as S


def setup_sphere(params: dict, device="cpu"):
    """Sphere in a vacuum bounding box (reference: setupGeometry.f90:10-71)."""
    mus, mua, hgg, n = (params[k] for k in ("mus", "mua", "hgg", "n"))
    pos = params.get("position", [0.0, 0.0, 0.0])
    bounding = params.get("boundinglength", [2.0, 2.0, 2.0])
    radius = params.get("sphereRadius", 1.0)
    t = T.invert(T.translate(pos, dtype=torch.float32, device=device))
    return [
        S.sphere(radius, mono(mus[0], mua[0], hgg[0], n[0]), 1,
                 transform=t, device=device),
        S.box(bounding, mono(0.0, 0.0, 0.0, 1.0), 2, device=device),
    ]


def setup_box(params: dict, device="cpu"):
    """Box in a vacuum bounding box (reference: setupGeometry.f90:73-147)."""
    mus, mua, hgg, n = (params[k] for k in ("mus", "mua", "hgg", "n"))
    pos = params.get("position", [0.0, 0.0, 0.0])
    bounding = params.get("boundinglength", [2.0, 2.0, 2.0])
    dims = params.get("BoxDimensions", [1.0, 1.0, 1.0])
    t = T.invert(T.translate(pos, dtype=torch.float32, device=device))
    return [
        S.box(dims, mono(mus[0], mua[0], hgg[0], n[0]), 1, transform=t,
              device=device),
        S.box(bounding, mono(0.0, 0.0, 0.0, 1.0), 2, device=device),
    ]


def setup_scat_test(params: dict, device="cpu"):
    """tau-sphere scattering test (reference: setupGeometry.f90:409-435)."""
    tau = params.get("tau", 10.0)
    return [
        S.sphere(1.0, mono(tau, 0.0, 0.0, 1.0), 1, device=device),
        S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0), 2, device=device),
    ]


def setup_simulation(geom_name: str, params: dict, res_dir="res",
                     device="cpu"):
    """Scene registry (reference: src/setup.f90:33-60)."""
    if geom_name == "scat_test":
        return setup_scat_test(params, device)
    if geom_name == "sphere":
        return setup_sphere(params, device)
    if geom_name in ("box", "test_box"):
        return setup_box(params, device)
    raise NotImplementedError(
        f"geometry {geom_name!r} is not ported (ROADMAP queue 1, item 11: "
        "scenes.py)")
