"""TOML configuration parsing (port of ``rsmcrt_tpu/config.py``).

Parses the ``[source]``, ``[grid]``, ``[geometry]``, ``[[detectors]]``,
``[output]`` and ``[simulation]`` tables with the reference's defaults and
error cases, every source kind and every spectrum type, and the escape
kernel's ``[symmetry]`` and the inverse kernel's ``[inverse]`` tables.
"""

from __future__ import annotations

import struct
import tomllib
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .detectors.detectors import (AnnulusDetectors, CameraDetectors,
                                  CircleDetectors, DetectorBank,
                                  FibreDetectors)
from .grid import CartGrid, CylGrid, cart_grid, cyl_grid
from .optics.piecewise import Constant, piecewise1d, piecewise2d
from .sources.sources import Source, build_source


class ConfigError(ValueError):
    """Raised on invalid configuration (reference: toml_error paths)."""


@dataclass
class Settings:
    """Mirror of the reference's global ``settings_t`` state
    (reference: src/sim_state.f90:10-58)."""

    nphotons: int = 1_000_000
    iseed: int = 123456789
    render_size: tuple = (200, 200, 200)
    experiment: str = "sphere"
    outfile: str = "fluence.nrrd"
    rendergeomfile: str = "geom_render.nrrd"
    rendersourcefile: str = "source_render.nrrd"
    source: str = "point"
    historyFilename: str = "photPos.obj"
    outfile_absorb: str = "absorb.nrrd"
    grid: Optional[CartGrid] = None
    render_geom: bool = False
    render_source: bool = False
    tev: bool = False
    overwrite: bool = False
    trackHistory: bool = False
    absorb: bool = False
    phasor: bool = False
    ckptfreq: int = 1_000_000
    loadckpt: bool = False
    ckptfile: str = "check.ckpt"
    roulette_bounces: int = 0
    roulette_chance: float = 0.1
    units: str = "cm"
    # escape-function symmetry (reference: parse.f90:188-340)
    symmetry_type: str = "none"
    sym_grid_cart: Optional[CartGrid] = None
    sym_grid_cyl: Optional[CylGrid] = None
    sym_pos: tuple = (0.0, 0.0, 0.0)
    sym_dir: tuple = (0.0, 0.0, 1.0)
    sym_rot: float = 0.0
    # inverse kernel (reference: parse.f90:342-402)
    inverse: Optional[dict] = None


@dataclass
class ParsedConfig:
    settings: Settings
    source: Source
    detectors: Optional[DetectorBank]
    geometry: dict  # geometry params fed to the scene registry
    spectrum: object


def _get_vector(table, key, context, default=None):
    """reference: parse_helpers.f90 get_vector"""
    if key not in table:
        if default is not None:
            return np.asarray(default, np.float64)
        raise ConfigError(f"Need a vector for {key} in {context}")
    v = table[key]
    if not isinstance(v, list) or len(v) != 3 or isinstance(v[0], str):
        raise ConfigError(f"Need a vector of size 3 for {key} in {context}")
    return np.asarray(v, np.float64)


def _parse_spectrum(table, res_dir: Path, device):
    """reference: parse_spectrum.f90:17-118"""
    stype = table.get("spectrum_type", "constant")
    if stype == "constant":
        wavelength = float(table.get("wavelength", 500.0))
        return Constant(torch.tensor(wavelength, dtype=torch.float32,
                                     device=device))
    if stype in ("1D", "2D"):
        sfile = table.get("spectrum_file")
        if sfile is None:
            raise ConfigError(f"{stype} spectrum requires spectrum_file")
        path = res_dir / sfile
    if stype == "1D":
        try:
            arr = np.loadtxt(path)
        except ValueError:
            # the reference's loadtxt also reads comma-separated columns
            # (its blood.dat asset)
            arr = np.loadtxt(path, delimiter=",")
        return piecewise1d(arr, device=device)
    if stype == "2D":
        cell = table.get("cell_size")
        if not isinstance(cell, list) or len(cell) != 2:
            raise ConfigError("Need a vector of size 2 for cell_size")
        image = _load_png_grey(path) if path.suffix == ".png" \
            else np.loadtxt(path)
        return piecewise2d(cell[0], cell[1], image, device=device)
    raise ConfigError("Not a valid spectrum type! expected one of "
                      "['constant', '1D', '2D']")


def _unfilter_row(filt: int, line: np.ndarray, prev: np.ndarray,
                  nchan: int) -> np.ndarray:
    """One PNG scanline with its filter undone (PNG spec section 9)."""
    if filt == 0:
        return line.copy()
    if filt == 2:
        return (line + prev) & 0xFF
    if filt not in (1, 3, 4):
        raise ConfigError("bad png filter")
    out = np.zeros_like(line)
    for i in range(line.size):
        a = int(out[i - nchan]) if i >= nchan else 0
        b = int(prev[i])
        c = int(prev[i - nchan]) if i >= nchan else 0
        if filt == 1:
            pred = a
        elif filt == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (int(line[i]) + pred) & 0xFF
    return out


def _load_png_grey(path: Path) -> np.ndarray:
    """First channel of an 8-bit PNG as float64 ``[width, height]`` (the
    stb_image orientation; reference parse_spectrum.f90:92-101), decoded
    with zlib and the PNG row filters.  The same array as the JAX
    package's loader takes when PIL is absent."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ConfigError(f"{path} is not a PNG")
    pos, idat = 8, b""
    width = height = bitdepth = colortype = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + length]
        if ctype == b"IHDR":
            width, height, bitdepth, colortype = struct.unpack(
                ">IIBB", chunk[:10])
        elif ctype == b"IDAT":
            idat += chunk
        elif ctype == b"IEND":
            break
        pos += 12 + length
    if bitdepth != 8:
        raise ConfigError("only 8-bit PNGs supported")
    nchan = {0: 1, 2: 3, 4: 2, 6: 4}[colortype]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    stride = width * nchan
    rows = raw[:height * (stride + 1)].reshape(height, stride + 1)
    img = np.zeros((height, stride), np.int64)
    prev = np.zeros(stride, np.int64)
    for r in range(height):
        prev = img[r] = _unfilter_row(int(rows[r, 0]),
                                      rows[r, 1:].astype(np.int64), prev,
                                      nchan)
    return img.reshape(height, width, nchan)[:, :, 0].T.astype(np.float64)


_CARDINALS = {"x": (1.0, 0.0, 0.0), "-x": (-1.0, 0.0, 0.0),
              "y": (0.0, 1.0, 0.0), "-y": (0.0, -1.0, 0.0),
              "z": (0.0, 0.0, 1.0), "-z": (0.0, 0.0, -1.0)}


def _parse_source(cfg: dict, settings: Settings, res_dir: Path, device):
    """reference: parse_source.f90:17-264"""
    table = cfg.get("source")
    if table is None:
        raise ConfigError("Simulation needs Source table")
    name = table.get("name", "point")
    settings.source = name
    settings.nphotons = int(table.get("nphotons", 1_000_000))

    pos = None
    if name != "uniform":
        pos = _get_vector(table, "position", "source")

    rotation = None
    if name not in ("uniform", "point", "circular", "pencil"):
        if "rotation" not in table:
            raise ConfigError("Source requires rotation variable")
        rotation = _get_vector(table, "rotation", "source")
        if np.linalg.norm(rotation) < 1e-8:
            raise ConfigError(
                "Need to specify rotation that has length greater than 0.0")
        rotation = rotation / np.linalg.norm(rotation)

    direction = None
    raw_dir = table.get("direction")
    if isinstance(raw_dir, str):
        if raw_dir not in _CARDINALS:
            raise ConfigError(
                "Direction needs a cardinal direction i.e x, y, or z")
        direction = np.asarray(_CARDINALS[raw_dir])
    elif isinstance(raw_dir, list):
        direction = _get_vector(table, "direction", "source")
    elif name not in ("point", "annulus", "focus"):
        raise ConfigError("Need to specify direction for source type!")

    points = {}
    for pkey in ("point1", "point2", "point3"):
        if pkey in table:
            points[pkey] = _get_vector(table, pkey, "source")
        elif name == "uniform":
            raise ConfigError(f"Uniform source requires {pkey} variable")

    spectrum = _parse_spectrum(table, res_dir, device)
    kwargs = dict(
        position=pos, direction=direction,
        radius=float(table.get("radius", 0.5)),
        focalLength=float(table.get("focalLength", 1.0)),
        rhi=float(table.get("rhi", 0.6)), rlo=float(table.get("rlo", 0.5)),
        sigma=float(table.get("sigma", 0.04)),
        beam_size=float(table.get("beam_size", 0.5)),
        rotation=rotation, **points)
    if name == "annulus":
        kwargs["annulus_type"] = table.get("annulus_type", "gaussian")
    if name == "focus":
        kwargs["focus_type"] = table.get("focus_type", "gaussian")
    if name == "point" and direction is None:
        kwargs["direction"] = np.asarray([0.0, 0.0, 1.0])
    if direction is None and name in ("annulus", "focus"):
        kwargs["direction"] = np.asarray([0.0, 0.0, -1.0])
    src = build_source(name, spectrum=spectrum, device=device, **kwargs)
    return src, spectrum


def _parse_grid(cfg: dict, settings: Settings, device):
    """reference: parse.f90:75-112"""
    table = cfg.get("grid")
    if table is None:
        raise ConfigError("Need grid table in input param file")
    settings.units = table.get("units", "cm")
    settings.grid = cart_grid(
        int(table.get("nxg", 200)), int(table.get("nyg", 200)),
        int(table.get("nzg", 200)), float(table.get("xmax", 1.0)),
        float(table.get("ymax", 1.0)), float(table.get("zmax", 1.0)),
        device=device)


def _parse_geometry(cfg: dict, settings: Settings):
    """reference: parse_geometry.f90:17-292.  Returns the scene parameter
    dict keyed like the reference's metadata dict."""
    table = cfg.get("geometry")
    if table is None:
        raise ConfigError("Need geometry table in input param file")
    settings.experiment = table.get("geom_name", "sphere")
    num = int(table.get("numOptProp", 1))
    if num < 1:
        raise ConfigError(
            "Need to set an integer value of at least one or greater for "
            "numOptProp")
    if settings.experiment == "sphere" and num != 1:
        raise ConfigError("For geometry of sphere must set numOptProp to one")
    if settings.experiment == "box" and num != 1:
        raise ConfigError("For geometry of box must set numOptProp to one")
    if settings.experiment == "egg" and num != 3:
        raise ConfigError("For geometry of egg must set numOptProp to three")

    def opt_array(key, default):
        if key in table:
            arr = table[key]
            if not isinstance(arr, list) or len(arr) != num:
                raise ConfigError(
                    f"length of {key} must be equal to numOptProp")
            return [float(v) for v in arr]
        return [default] * num

    params = {
        "numOptProp": num,
        "mua": opt_array("mua", 0.0),
        "mus": opt_array("mus", 1.0),
        "mur": opt_array("mur", 0.0),
        "hgg": opt_array("hgg", 0.0),
        "n": opt_array("n", 1.0),
        "tau": float(table.get("tau", 10.0)),
        "num_spheres": int(table.get("num_spheres", 10)),
        "musb": float(table.get("musb", 0.0)),
        "muab": float(table.get("muab", 0.01)),
        "musc": float(table.get("musc", 0.0)),
        "muac": float(table.get("muac", 0.01)),
        "hgga": float(table.get("hgga", 0.7)),
    }
    params["position"] = list(_get_vector(table, "position", "geometry",
                                          default=[0.0, 0.0, 0.0]))
    params["boundinglength"] = list(_get_vector(
        table, "boundingBox", "geometry", default=[2.0, 2.0, 2.0]))
    if settings.experiment == "sphere":
        params["sphereRadius"] = float(table.get("sphereRadius", 1.0))
    if settings.experiment == "box":
        params["BoxDimensions"] = list(_get_vector(
            table, "BoxDimensions", "geometry", default=[1.0, 1.0, 1.0]))
    if settings.experiment == "egg":
        default_top = 3.0 * np.sqrt(2.0 - np.sqrt(2.0))
        params["BottomSphereRadius"] = float(
            table.get("BottomSphereRadius", 3.0))
        params["TopSphereRadius"] = float(
            table.get("TopSphereRadius", default_top))
        params["SphereSep"] = float(table.get("SphereSep", default_top))
        params["ShellThickness"] = float(table.get("ShellThickness", 0.05))
        params["YolkRadius"] = float(table.get("YolkRadius", 1.5))
    return params


def _parse_detectors(cfg: dict, settings: Settings, device):
    """reference: parse_detectors.f90:17-141.  Builds the stacked families
    in config order."""
    entries = cfg.get("detectors")
    if not entries:
        return None
    families = {"circle": [], "annulus": [], "fibre": [], "camera": []}
    order, ids, layers, targets = [], [], [], []
    for entry in entries:
        kind = entry.get("type")
        if kind not in families:
            raise ConfigError(
                "Invalid detector type. Valid types are "
                "[circle, annulus, camera]")
        if "ID" not in entry:
            raise ConfigError("Need to specify a detector ID")
        if bool(entry.get("trackHistory", False)):
            settings.trackHistory = True
        settings.historyFilename = entry.get("historyFileName",
                                             "photPos.obj")
        targets.append(float(entry.get("inverseTarget", -1.0)))
        ids.append(entry["ID"])
        layers.append(int(entry.get("layer", 1)))
        order.append((kind, len(families[kind])))
        families[kind].append(entry)

    def t(values, dtype=torch.float32):
        return torch.tensor(np.asarray(values), dtype=dtype, device=device)

    def f32(rows, key, default):
        return t([float(r.get(key, default)) for r in rows])

    def vec(rows, key, default):
        return t([_get_vector(r, key, "detector", default=default)
                  for r in rows])

    def unit(v):
        return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)

    def nbins_of(rows, default):
        """Per-detector bin counts (reference detectors each carry their
        own nbins, detectors.f90:107-210); the family's data pads to the
        largest."""
        per = [int(r.get("nbins", default)) for r in rows]
        return max(per), t(per, torch.int32)

    def width(extent, nbins_arr):
        return torch.where(nbins_arr == 0, 1.0,
                           extent / torch.clamp(nbins_arr, min=1))

    def zeros(rows, nbins, dims=1):
        return torch.zeros((len(rows),) + (nbins + 1,) * dims,
                           dtype=torch.float32, device=device)

    circle = annulus = fibre = camera = None
    rows = families["circle"]
    if rows:
        nbins, nbins_arr = nbins_of(rows, 100)
        radius = f32(rows, "radius", 1.0)
        circle = CircleDetectors(
            pos=vec(rows, "position", None),
            dir=unit(vec(rows, "direction", [0.0, 0.0, -1.0])),
            radius=radius, bin_wid=width(radius, nbins_arr),
            data=zeros(rows, nbins), nbins=nbins, nbins_arr=nbins_arr)
    rows = families["annulus"]
    if rows:
        nbins, nbins_arr = nbins_of(rows, 100)
        r1, r2 = f32(rows, "radius1", 0.1), f32(rows, "radius2", 0.2)
        if bool(torch.any(r2 <= r1)):
            raise ConfigError("Radii are invalid: expected radius2 > radius1")
        annulus = AnnulusDetectors(
            pos=vec(rows, "position", None),
            dir=unit(vec(rows, "direction", [0.0, 0.0, -1.0])),
            r1=r1, r2=r2, bin_wid=width(r2 - r1, nbins_arr),
            data=zeros(rows, nbins), nbins=nbins, nbins_arr=nbins_arr)
    rows = families["fibre"]
    if rows:
        nbins, nbins_arr = nbins_of(rows, 1)
        core = f32(rows, "coreDiameter", 0.01)

        def dflt(key, *fallback):
            return t([float(r.get(key, max(float(r.get(k, 1.0))
                                           for k in fallback)))
                      for r in rows])

        fibre = FibreDetectors(
            pos=vec(rows, "position", None),
            dir=unit(vec(rows, "direction", [0.0, 0.0, -1.0])),
            focalLength1=f32(rows, "focalLength1", 1.0),
            focalLength2=f32(rows, "focalLength2", 1.0),
            f1Aperture=f32(rows, "f1Aperture", 1.0),
            f2Aperture=f32(rows, "f2Aperture", 1.0),
            frontOffset=f32(rows, "frontOffset", 0.0),
            backOffset=dflt("backOffset", "focalLength2"),
            frontToPinSep=dflt("frontToPinSep", "focalLength1"),
            pinToBackSep=dflt("pinToBackSep", "focalLength2"),
            pinAperture=dflt("pinAperture", "f1Aperture", "f2Aperture"),
            acceptAngle=f32(rows, "acceptanceAngle", 90.0),
            coreDiameter=core, bin_wid=width(core / 2.0, nbins_arr),
            data=zeros(rows, nbins), nbins=nbins, nbins_arr=nbins_arr)
    rows = families["camera"]
    if rows:
        nbins, nbins_arr = nbins_of(rows, 100)
        maxval = f32(rows, "maxval", 100.0)
        p1 = vec(rows, "p1", [-1.0, -1.0, -1.0])
        e1 = vec(rows, "p2", [2.0, 0.0, 0.0]) - p1
        e2 = vec(rows, "p3", [0.0, 2.0, 0.0]) - p1
        bw = maxval / (nbins_arr + 1)
        camera = CameraDetectors(
            pos=p1, n=unit(torch.linalg.cross(e2, e1)), e1=e1, e2=e2,
            width=torch.linalg.vector_norm(e1, dim=-1),
            height=torch.linalg.vector_norm(e2, dim=-1),
            bin_wid_x=bw, bin_wid_y=bw.clone(), data=zeros(rows, nbins, 2),
            nbins=nbins, nbins_arr=nbins_arr)
    return DetectorBank(circle=circle, annulus=annulus, fibre=fibre,
                        camera=camera, target_values=t(targets),
                        order=tuple(order), ids=tuple(ids),
                        layers=tuple(layers))


def _parse_output(cfg: dict, settings: Settings):
    """reference: parse.f90:114-157"""
    table = cfg.get("output")
    if table is None:
        raise ConfigError("Need output table in input param file")
    settings.outfile = table.get("fluence", "fluence.nrrd")
    settings.outfile_absorb = table.get("absorb", "absorb.nrrd")
    settings.rendergeomfile = table.get("render_geometry_name",
                                        "geom_render.nrrd")
    settings.render_geom = bool(table.get("render_geometry", False))
    settings.rendersourcefile = table.get("render_source_name",
                                          "source_render.nrrd")
    settings.render_source = bool(table.get("render_source", False))
    rs = table.get("render_size")
    if rs is not None:
        if not isinstance(rs, list) or len(rs) < 3:
            raise ConfigError("Need a vector of size 3 for render_size.")
        settings.render_size = tuple(int(v) for v in rs[:3])
    settings.overwrite = bool(table.get("overwrite", False))


def _parse_simulation(cfg: dict, settings: Settings):
    """reference: parse.f90:159-186"""
    table = cfg.get("simulation")
    if table is None:
        raise ConfigError("Need simulation table in input param file")
    settings.iseed = int(table.get("iseed", 123456789))
    settings.tev = bool(table.get("tev", False))
    settings.absorb = bool(table.get("absorb", False))
    settings.phasor = bool(table.get("phasor", False))
    settings.loadckpt = bool(table.get("load_checkpoint", False))
    settings.ckptfile = table.get("checkpoint_file", "check.ckpt")
    settings.ckptfreq = int(table.get("checkpoint_every_n", 1_000_000))
    settings.roulette_bounces = int(table.get("roulette_bounces", 0))
    settings.roulette_chance = float(table.get("roulette_chance", 0.1))


def _parse_symmetry(cfg: dict, settings: Settings, device):
    """reference: parse.f90:188-340 (escape-function kernel only).
    ``escapenphotons`` replaces ``settings.nphotons``: it is the photon
    count of each source voxel."""
    table = cfg.get("symmetry")
    if table is None:
        settings.symmetry_type = "none"
        settings.nphotons = 100_000
        settings.sym_grid_cart = cart_grid(10, 10, 10, 1.0, 1.0, 1.0,
                                           device=device)
        return
    stype = table.get("symmetryType", "none")
    settings.nphotons = int(table.get("escapenphotons", 100_000))
    gs = table.get("GridSize", [10, 10, 10])
    mv = table.get("maxValues", [1.0, 1.0, 1.0])
    if len(gs) != 3:
        raise ConfigError("Need a vector of size 3 for symmetry grid size.")
    if len(mv) != 3:
        raise ConfigError("Need a vector of size 3 for symmetry max values.")
    pos = table.get("position", [0.0, 0.0, 0.0])
    dirc = table.get("direction", [0.0, 0.0, 1.0])
    rot = float(table.get("rotation", 0.0))
    if rot < 0.0 or rot >= 360.0:
        raise ConfigError(
            "Must specifcy a rotation for symmetry that is between 0.0 and "
            "360.0, inclusive of 0.0")
    if all(v == 0.0 for v in dirc):
        raise ConfigError("Must specify a non-zero direction for symmetry")
    dirc = np.asarray(dirc, np.float64)
    settings.symmetry_type = stype
    settings.sym_pos = tuple(float(v) for v in pos)
    settings.sym_dir = tuple(dirc / np.linalg.norm(dirc))
    settings.sym_rot = rot
    if stype in ("none", "prism", "flipped", "uniformSlab"):
        settings.sym_grid_cart = cart_grid(int(gs[0]), int(gs[1]),
                                           int(gs[2]), mv[0], mv[1], mv[2],
                                           device=device)
    elif stype in ("noneRotational", "360rotational"):
        settings.sym_grid_cyl = cyl_grid(int(gs[0]), int(gs[1]), int(gs[2]),
                                         mv[0], mv[1], mv[2])
    else:
        raise ConfigError("Unrecognised symmetry type")


def _parse_inverse(cfg: dict, settings: Settings):
    """reference: parse.f90:342-402 (inverse kernel only)."""
    table = cfg.get("inverse")
    if table is None:
        raise ConfigError("Need inverse table in input param file")
    if "layer" not in table:
        raise ConfigError("Must specifiy a layer in inverse table")
    settings.inverse = dict(
        maxStepSize=float(table.get("maxStepSize", 1.0)),
        gradStepSize=float(table.get("gradStepSize", 0.0001)),
        accuracy=float(table.get("accuracy", 0.01)),
        maxNumSteps=int(table.get("maxNumSteps", 1000)),
        Findmua=bool(table.get("Findmua", False)),
        Findmus=bool(table.get("Findmus", False)),
        Findg=bool(table.get("Findg", False)),
        Findn=bool(table.get("Findn", False)),
        layer=int(table["layer"]),
    )


def parse_params(filename: str | Path, res_dir: str | Path | None = None,
                 kernel: str = "default", device="cpu") -> ParsedConfig:
    """Entry point (reference: parse.f90:20-72).  ``kernel`` selects the
    extra table parsed: 'escape' -> symmetry, 'inverse' -> inverse.
    Tensors are created on ``device``."""
    filename = Path(filename)
    res_dir = Path(res_dir) if res_dir is not None else filename.parent
    with open(filename, "rb") as fh:
        cfg = tomllib.load(fh)
    settings = Settings()
    source, spectrum = _parse_source(cfg, settings, res_dir, device)
    _parse_grid(cfg, settings, device)
    geometry = _parse_geometry(cfg, settings)
    detectors = _parse_detectors(cfg, settings, device)
    _parse_output(cfg, settings)
    _parse_simulation(cfg, settings)
    if kernel == "escape":
        _parse_symmetry(cfg, settings, device)
    elif kernel == "inverse":
        _parse_inverse(cfg, settings)
    return ParsedConfig(settings=settings, source=source,
                        detectors=detectors, geometry=geometry,
                        spectrum=spectrum)
