"""Prebuilt experiment scenes (port of ``rsmcrt_tpu/scenes.py``;
reference: src/setupGeometry.f90) and the registry that dispatches on the
config's ``geom_name`` (reference: src/setup.f90:33-60).

Each builder returns a list of :class:`~rsmcrt_tpu_torch.sdfs.scene.PrimSpec`
on ``device``; callers pass it to ``build_scene``.  The logo scene reads
its SVG with this module's own minimal path parser.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np
import torch

from .maths import transforms as T
from .optics.properties import mono
from .sdfs import scene as S

_F = torch.float32


def _moved(pos, device):
    """The inverse world transform of a prim centred at ``pos``."""
    return T.invert(T.translate(pos, dtype=_F, device=device))


def setup_sphere(params: dict, device="cpu"):
    """Sphere in a vacuum bounding box (reference: setupGeometry.f90:10-71)."""
    mus, mua, hgg, n = (params[k] for k in ("mus", "mua", "hgg", "n"))
    pos = params.get("position", [0.0, 0.0, 0.0])
    bounding = params.get("boundinglength", [2.0, 2.0, 2.0])
    radius = params.get("sphereRadius", 1.0)
    return [
        S.sphere(radius, mono(mus[0], mua[0], hgg[0], n[0]), 1,
                 transform=_moved(pos, device), device=device),
        S.box(bounding, mono(0.0, 0.0, 0.0, 1.0), 2, device=device),
    ]


def setup_box(params: dict, device="cpu"):
    """Box in a vacuum bounding box (reference: setupGeometry.f90:73-147)."""
    mus, mua, hgg, n = (params[k] for k in ("mus", "mua", "hgg", "n"))
    pos = params.get("position", [0.0, 0.0, 0.0])
    bounding = params.get("boundinglength", [2.0, 2.0, 2.0])
    dims = params.get("BoxDimensions", [1.0, 1.0, 1.0])
    return [
        S.box(dims, mono(mus[0], mua[0], hgg[0], n[0]), 1,
              transform=_moved(pos, device), device=device),
        S.box(bounding, mono(0.0, 0.0, 0.0, 1.0), 2, device=device),
    ]


def setup_egg(params: dict, device="cpu"):
    """Egg with yolk, albumen and shell (reference:
    setupGeometry.f90:149-248): shell and albumen are revolutions of egg
    SDFs, the yolk a sphere."""
    mus, mua, hgg, n = (params[k] for k in ("mus", "mua", "hgg", "n"))
    pos = params.get("position", [0.0, 0.0, 0.0])
    bounding = params.get("boundinglength", [2.0, 2.0, 2.0])
    r_bot = params.get("BottomSphereRadius", 3.0)
    r_top = params.get("TopSphereRadius", 3.0 * np.sqrt(2.0 - np.sqrt(2.0)))
    sep = params.get("SphereSep", 3.0 * np.sqrt(2.0 - np.sqrt(2.0)))
    thick = params.get("ShellThickness", 0.05)
    yolk_r = params.get("YolkRadius", 1.5)
    shell = S.revolution(
        S.egg(r_bot, r_top, sep, mono(mus[0], mua[0], hgg[0], n[0]), 2,
              device=device),
        0.0, center=pos, device=device)
    albumen = S.revolution(
        S.egg(r_bot * (1 - thick), r_top * (1 - thick), sep * (1 - thick),
              mono(mus[1], mua[1], hgg[1], n[1]), 3, device=device),
        0.0, center=pos, device=device)
    yolk = S.sphere(yolk_r, mono(mus[2], mua[2], hgg[2], n[2]), 1,
                    transform=_moved(pos, device), device=device)
    bbox = S.box(bounding, mono(0.0, 0.0, 0.0, 1.0), 4, device=device)
    return [yolk, albumen, shell, bbox]


def setup_sphere_scene(params: dict, rng: np.random.Generator | None = None,
                       device="cpu"):
    """N random spheres (reference: setupGeometry.f90:250-294)."""
    num = int(params.get("num_spheres", 10))
    rng = rng or np.random.default_rng(1234)
    opt_s = mono(0.0, 0.0, 0.9, 1.37)
    opt_b = mono(1e-17, 1e-17, 0.0, 1.0)
    prims = []
    for i in range(num):
        radius = rng.uniform(0.001, 0.25)
        centre = rng.uniform(-1.0 + radius, 1.0 - radius, 3)
        prims.append(S.sphere(radius, opt_s, i + 1,
                              transform=_moved(np.float32(centre), device),
                              device=device))
    prims.append(S.box([2.0, 2.0, 2.0], opt_b, num + 1, device=device))
    return prims


def setup_tran_and_jacques(device="cpu"):
    """Tran & Jacques n=1.33 sphere validation scene
    (reference: setupGeometry.f90:335-363)."""
    opt1 = mono(0.0, 1e-17, 0.0, 1.0)
    opt2 = mono(0.0, 10000000.0, 0.0, 1.0)
    opt3 = mono(0.0, 1e-17, 0.0, 1.33)
    return [
        S.sphere(0.5, opt3, 1, transform=_moved([0.0, 0.0, 0.0], device),
                 device=device),
        S.box([2.0, 2.0, 2.0], opt1, 2, device=device),
        S.box([2.01, 2.01, 2.01], opt2, 3, device=device),
    ]


def setup_exp(params: dict, device="cpu"):
    """Glass bottle with contents (reference: setupGeometry.f90:365-407)."""
    musb = params.get("musb", 0.0)
    muab = params.get("muab", 0.01)
    musc = params.get("musc", 0.0)
    muac = params.get("muac", 0.01)
    hgg = params.get("hgga", 0.7)
    a = [-8.0, 0.0, 0.0]
    b = [8.0, 0.0, 0.0]
    return [
        S.cylinder(a, b, 1.55, mono(musc, muac, hgg, 1.3), 1, device=device),
        S.cylinder(a, b, 1.75, mono(musb, muab, hgg, 1.5), 2, device=device),
        S.box([20.0, 20.0, 20.0], mono(0.0, 0.0, 0.0, 1.0), 2,
              device=device),
    ]


def setup_lens(params: dict, device="cpu"):
    """Biconvex glass lens in vacuum, the CSG intersection of two spheres
    (an original scene: the reference ships res/lens.toml but has no
    "lens" case in its registry)."""
    n_glass = float(params.get("lensN", 1.52))
    r_curv = float(params.get("lensRadius", 0.9))
    half_thick = float(params.get("lensThickness", 0.25)) / 2.0
    opt_glass = mono(0.0, 1e-8, 0.0, n_glass)
    c = r_curv - half_thick  # sphere centre offset for the cap overlap
    s1 = S.sphere(r_curv, opt_glass, 1,
                  transform=_moved([0.0, 0.0, -c], device), device=device)
    s2 = S.sphere(r_curv, opt_glass, 1,
                  transform=_moved([0.0, 0.0, c], device), device=device)
    return [S.model([s1, s2], "intersection", device=device),
            S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0), 2,
                  device=device)]


def setup_scat_test(params: dict, device="cpu"):
    """tau-sphere scattering test (reference: setupGeometry.f90:409-435)."""
    tau = params.get("tau", 10.0)
    return [
        S.sphere(1.0, mono(tau, 0.0, 0.0, 1.0), 1, device=device),
        S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0), 2, device=device),
    ]


def setup_scat_test2(params: dict, device="cpu"):
    """Near-infinite box scattering test
    (reference: setupGeometry.f90:437-464)."""
    tau = params.get("tau", 10.0)
    hgg = params.get("hgg", [0.9])[0]
    return [S.box([200.0, 200.0, 200.0], mono(tau, 1e-17, hgg, 1.0), 2,
                  device=device)]


def setup_omg_sdf(device="cpu"):
    """The OMG lettering scene: a torus and nine cylinders smooth-unioned
    (reference: setupGeometry.f90:466-549)."""
    opt1 = mono(10.0, 0.16, 0.0, 2.65)
    opt2 = mono(0.0, 0.0, 0.0, 1.0)
    layer = 1
    # O
    parts = [S.torus(0.2, 0.05, opt1, layer,
                     transform=_moved([0.0, 0.0, -0.7], device),
                     device=device)]
    # M
    parts.append(S.cylinder(
        [-0.25, 0.0, -0.25], [-0.25, 0.0, 0.25], 0.05, opt1, layer,
        transform=T.invert(T.rotate_y(90.0, device=device)), device=device))
    for a, b in [
        ([-0.25, 0.0, -0.25], [0.25, 0.0, 0.0]),
        ([0.25, 0.0, 0.0], [-0.25, 0.0, 0.25]),
        ([-0.25, 0.0, 0.25], [0.25, 0.0, 0.25]),
        # G
        ([-0.25, 0.0, 0.5], [0.25, 0.0, 0.5]),
        ([-0.25, 0.0, 0.5], [-0.25, 0.0, 0.75]),
        ([0.25, 0.0, 0.5], [0.25, 0.0, 0.75]),
        ([0.25, 0.0, 0.75], [0.0, 0.0, 0.75]),
        ([0.0, 0.0, 0.625], [0.0, 0.0, 0.75]),
    ]:
        parts.append(S.cylinder(a, b, 0.05, opt1, layer, device=device))
    return [S.model(parts, "smooth_union", 0.09, device=device),
            S.box([2.0, 2.0, 2.0], opt2, 2, device=device)]


def get_vessels(res_dir: str | Path = "res", device="cpu"):
    """Blood vessel scene from nodes/edges/radii files
    (reference: setupGeometry.f90:552-652).  Optical properties from
    MCmatlab."""
    res_dir = Path(res_dir)
    nodes = np.loadtxt(res_dir / "nodes.dat")
    edges = np.loadtxt(res_dir / "edges.dat", dtype=int)
    radii = np.loadtxt(res_dir / "radii.dat")

    opt_vessel = mono(94.0, 231.0, 0.9, 1.37)
    opt_derm = mono(357.0, 0.458, 0.9, 1.37)

    res = 0.001  # 0.01 mm
    maxs = np.max(np.abs(nodes), axis=0)
    nodes = (nodes / maxs - 0.5) * maxs * res

    prims = []
    for e0, e1 in edges:
        prims.append(S.capsule(nodes[e0 - 1], nodes[e1 - 1],
                               radii[e0 - 1] * res, opt_vessel, 1,
                               device=device))
    prims.append(S.box([0.32, 0.18, 0.26], opt_derm, 2, device=device))
    return prims


_SVG_NUM = re.compile(r"[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?")


def _parse_svg_segments(svg_file: Path):
    """Straight-line segments of the SVG's path elements (M, L, H, V, Z
    commands, absolute and relative; curve arguments are skipped)."""
    segments = []
    for el in ET.parse(svg_file).iter():
        if not el.tag.endswith("path"):
            continue
        tokens = re.findall(r"[MmLlHhVvZz]|" + _SVG_NUM.pattern,
                            el.attrib.get("d", ""))
        pos = np.zeros(2)
        start = np.zeros(2)
        cmd = None
        i = 0
        while i < len(tokens):
            tok = tokens[i]
            if tok in "MmLlHhVvZz":
                cmd = tok
                i += 1
                if cmd in "Zz":
                    # close the subpath with an explicit segment
                    if not np.allclose(pos, start):
                        segments.append((pos.copy(), start.copy()))
                    pos = start.copy()
                continue
            if cmd in ("M", "m", "L", "l"):
                xy = np.array([float(tokens[i]), float(tokens[i + 1])])
                new = xy if cmd in "ML" else pos + xy
                i += 2
                if cmd in "Mm":
                    start = new.copy()
                    cmd = "L" if cmd == "M" else "l"
                else:
                    segments.append((pos.copy(), new.copy()))
                pos = new
                continue
            if cmd in ("H", "h", "V", "v"):
                v = float(tokens[i])
                ax = 0 if cmd in "Hh" else 1
                new = pos.copy()
                new[ax] = v if cmd in "HV" else pos[ax] + v
                segments.append((pos.copy(), new.copy()))
                pos = new
                i += 1
                continue
            i += 1  # unsupported command args (curves) skipped
    return segments


def setup_logo(svg_file: str | Path = "res/logo.svg", device="cpu"):
    """Logo scene: SVG line segments extruded into SDF slabs (reference:
    setupGeometry.f90:297-332).  The reference's crest takes the
    reference's normalisation constants (res/svg_convert.py); any other
    SVG is normalised by its own segments' bounding box."""
    svg_file = Path(svg_file)
    segments = _parse_svg_segments(svg_file)
    if not segments:
        raise ValueError(f"no line segments found in {svg_file}")
    if svg_file.name == "crest-simple.svg":
        maxx, maxy = 299.15545999999995, 368.92027
        minx, miny = 194.75158, 197.11304
    else:
        pts = np.asarray([p for seg in segments for p in seg])
        minx, miny = pts.min(axis=0)
        maxx, maxy = pts.max(axis=0) - np.array([minx, miny])
    eps = 1e-5

    opt_seg = mono(10.0, 0.1, 0.9, 1.5)
    opt_box = mono(0.0, 0.0, 0.0, 1.0)
    prims = []
    for p0, p1 in segments:
        x1 = (p0[0] - minx) / maxx - 0.5
        x2 = (p1[0] - minx) / maxx - 0.5
        y1 = (p0[1] - miny) / maxy - 0.5
        y2 = (p1[1] - miny) / maxy - 0.5
        if x1 == x2:
            x1 += eps
        if y1 == y2:
            y1 += eps
        seg = S.segment([x1, y1, 0.0], [x2, y2, 0.0], opt_seg, 1,
                        device=device)
        prims.append(S.extrude(seg, 0.5, device=device))
    prims.append(S.box([10.0, 10.0, 2.001], opt_box, 2, device=device))
    return prims


def setup_simulation(geom_name: str, params: dict, res_dir="res",
                     device="cpu"):
    """Scene registry (reference: src/setup.f90:33-60)."""
    if geom_name == "logo":
        # the reference's crest when present, else the shipped original
        crest = Path(res_dir) / "crest-simple.svg"
        return setup_logo(crest if crest.exists()
                          else Path(res_dir) / "logo.svg", device=device)
    builders = {
        "omg": lambda: setup_omg_sdf(device),
        "scat_test": lambda: setup_scat_test(params, device),
        "scat_test2": lambda: setup_scat_test2(params, device),
        "aptran": lambda: setup_tran_and_jacques(device),
        "vessels": lambda: get_vessels(res_dir, device),
        "sphere_scene": lambda: setup_sphere_scene(params, device=device),
        "box": lambda: setup_box(params, device),
        "test_box": lambda: setup_box(params, device),
        "sphere": lambda: setup_sphere(params, device),
        "egg": lambda: setup_egg(params, device),
        "exp": lambda: setup_exp(params, device),
        "lens": lambda: setup_lens(params, device),
    }
    if geom_name not in builders:
        raise ValueError(f"no such routine: {geom_name}")
    return builders[geom_name]()
