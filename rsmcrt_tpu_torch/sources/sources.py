"""Photon source sampling (port of ``rsmcrt_tpu/sources/sources.py``).

A :class:`Source` is a kind plus parameter tensors; ``sample`` consumes a
block of uniforms ``u [B, n]`` and emits a whole wavefront of photons.
Only the ``point`` kind with a ``Constant`` spectrum is ported; the other
kinds raise ``NotImplementedError`` (ROADMAP queue 1, item 4: sources).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..constants import TWOPI
from ..grid import CartGrid
from ..optics.piecewise import Constant

# uniforms consumed per source kind (the reference's SOURCE_UNIFORM_COUNT)
SOURCE_UNIFORM_COUNT = {"point": 3}

_NOT_PORTED = "ROADMAP queue 1, item 4: sources"


@dataclass
class Source:
    kind: str
    params: dict = field(default_factory=dict)
    spectrum: object = None  # Constant | None
    subtype: str = ""

    def __post_init__(self):
        if self.kind not in SOURCE_UNIFORM_COUNT:
            raise NotImplementedError(
                f"source kind {self.kind!r} is not ported ({_NOT_PORTED})")
        if self.spectrum is not None and not isinstance(self.spectrum,
                                                        Constant):
            raise NotImplementedError(
                f"spectrum {type(self.spectrum).__name__} is not ported "
                "(ROADMAP queue 1, item 11: spectral optics)")


def n_source_uniforms(source: Source) -> int:
    return SOURCE_UNIFORM_COUNT[source.kind]


def build_source(kind: str, spectrum=None, device="cpu", **params) -> Source:
    p = {}
    subtype = ""
    for k, v in params.items():
        if v is None:
            continue
        if isinstance(v, str):
            subtype = v
        else:
            p[k] = torch.as_tensor(np.asarray(v, np.float32), device=device)
    return Source(kind=kind, params=p, spectrum=spectrum, subtype=subtype)


def _spectrum_sample(spectrum, u):
    if spectrum is None:
        return torch.full_like(u, 500.0)
    return spectrum.value.to(u.device).expand(u.shape)


def sample(source: Source, grid: CartGrid, u: torch.Tensor):
    """Emit a wavefront from uniforms ``u [B, n_source_uniforms]`` in
    (0, 1).  Returns (pos [B,3], dir [B,3], phase [B], wavelength [B])."""
    p = source.params
    B = u.shape[0]
    # point source, reference: photon.f90:311-359
    phi = u[:, 0] * TWOPI
    cost = 2.0 * u[:, 1] - 1.0
    sint = torch.sqrt(torch.clamp(1.0 - cost * cost, min=0.0))
    direction = torch.stack(
        [sint * torch.cos(phi), sint * torch.sin(phi), cost], dim=-1)
    pos = p["position"].to(u.device).expand(B, 3)
    wavelength = _spectrum_sample(source.spectrum, u[:, 2])
    phase = torch.zeros((B,), dtype=u.dtype, device=u.device)
    return pos, direction, phase, wavelength
