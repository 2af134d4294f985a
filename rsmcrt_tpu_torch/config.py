"""TOML configuration parsing (port of ``rsmcrt_tpu/config.py``).

Parses the ``[source]``, ``[grid]``, ``[geometry]``, ``[output]`` and
``[simulation]`` tables with the reference's defaults and error cases.
Parts the port does not run yet raise ``NotImplementedError`` naming their
ROADMAP item: source kinds other than ``point``, spectra other than
``constant``, ``[[detectors]]`` and the escape / inverse kernels' tables.
"""

from __future__ import annotations

import tomllib
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .grid import CartGrid, cart_grid
from .optics.piecewise import Constant
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


@dataclass
class ParsedConfig:
    settings: Settings
    source: Source
    detectors: object  # always None: detector banks are not ported
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


def _parse_spectrum(table, device):
    """reference: parse_spectrum.f90:17-118 (constant spectra only)"""
    stype = table.get("spectrum_type", "constant")
    if stype == "constant":
        wavelength = float(table.get("wavelength", 500.0))
        return Constant(torch.tensor(wavelength, dtype=torch.float32,
                                     device=device))
    if stype in ("1D", "2D"):
        raise NotImplementedError(
            f"spectrum_type {stype!r} is not ported (ROADMAP queue 1, "
            "item 11: spectral optics)")
    raise ConfigError("Not a valid spectrum type! expected one of "
                      "['constant', '1D', '2D']")


def _parse_source(cfg: dict, settings: Settings, device):
    """reference: parse_source.f90:17-264 (point source)"""
    table = cfg.get("source")
    if table is None:
        raise ConfigError("Simulation needs Source table")
    name = table.get("name", "point")
    settings.source = name
    settings.nphotons = int(table.get("nphotons", 1_000_000))
    if name != "point":
        raise NotImplementedError(
            f"source {name!r} is not ported (ROADMAP queue 1, item 4: "
            "sources)")
    pos = _get_vector(table, "position", "source")
    raw_dir = table.get("direction")
    if isinstance(raw_dir, list):
        direction = _get_vector(table, "direction", "source")
    elif isinstance(raw_dir, str):
        cardinals = {"x": (1, 0, 0), "-x": (-1, 0, 0), "y": (0, 1, 0),
                     "-y": (0, -1, 0), "z": (0, 0, 1), "-z": (0, 0, -1)}
        if raw_dir not in cardinals:
            raise ConfigError(
                "Direction needs a cardinal direction i.e x, y, or z")
        direction = np.asarray(cardinals[raw_dir], np.float64)
    else:
        direction = np.asarray([0.0, 0.0, 1.0])
    spectrum = _parse_spectrum(table, device)
    src = build_source(name, spectrum=spectrum, device=device, position=pos,
                       direction=direction)
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
    """reference: parse_geometry.f90:17-292 (the keys the ported scenes
    read)"""
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
    }
    params["position"] = list(_get_vector(table, "position", "geometry",
                                          default=[0.0, 0.0, 0.0]))
    params["boundinglength"] = list(_get_vector(
        table, "boundingBox", "geometry", default=[2.0, 2.0, 2.0]))
    if settings.experiment == "sphere":
        params["sphereRadius"] = float(table.get("sphereRadius", 1.0))
    return params


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


def parse_params(filename: str | Path, res_dir: str | Path | None = None,
                 kernel: str = "default", device="cpu") -> ParsedConfig:
    """Entry point (reference: parse.f90:20-72).  Tensors are created on
    ``device``."""
    if kernel != "default":
        raise NotImplementedError(
            f"the {kernel!r} kernel is not ported (ROADMAP queue 1, "
            "item 12: workloads)")
    filename = Path(filename)
    with open(filename, "rb") as fh:
        cfg = tomllib.load(fh)
    if cfg.get("detectors"):
        raise NotImplementedError(
            "detectors are not ported (ROADMAP queue 1, item 7)")
    settings = Settings()
    source, spectrum = _parse_source(cfg, settings, device)
    _parse_grid(cfg, settings, device)
    geometry = _parse_geometry(cfg, settings)
    _parse_output(cfg, settings)
    _parse_simulation(cfg, settings)
    return ParsedConfig(settings=settings, source=source, detectors=None,
                        geometry=geometry, spectrum=spectrum)
