"""Monochromatic optical properties (port of
``rsmcrt_tpu/optics/properties.py``, ``mono`` type only; spectral
properties are not ported yet).  The derived kappa and albedo are formed
per layer by ``sdfs.scene.SceneTables``."""

from __future__ import annotations

from dataclasses import dataclass

from ..grid import f32


@dataclass
class OptProps:
    """Monochromatic optical properties (reference ``mono`` type); values
    are float32-rounded Python floats."""

    mus: float
    mua: float
    hgg: float
    n: float


def mono(mus, mua, hgg, n) -> OptProps:
    return OptProps(f32(mus), f32(mua), f32(hgg), f32(n))
