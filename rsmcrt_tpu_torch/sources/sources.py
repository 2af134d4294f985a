"""Photon source sampling (port of ``rsmcrt_tpu/sources/sources.py``;
reference: src/photon.f90:159-1043).

A :class:`Source` is a kind plus parameter tensors; ``sample`` consumes a
block of uniforms ``u [B, n]`` and emits a whole wavefront of photons.
The ``point``, ``pencil``, ``uniform``, ``circular``, ``focus`` (square,
circle, gaussian) and ``annulus`` (tophat, besselAnnulus, gaussian) kinds
with a ``Constant`` spectrum are ported.  Their fixed frames (the
circular source's mirrored branch, the focus and annulus rotations) are
decided once on the host when the source is built, not per photon.  The
``dslit``, ``aperture`` and ``slm`` kinds (ROADMAP queue 1, item 10: the
phasor path) and ``escape_points`` (item 12) raise
``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..constants import TWOPI
from ..grid import CartGrid
from ..maths import transforms as T
from ..optics.piecewise import Constant

# uniforms consumed per source kind (the reference's SOURCE_UNIFORM_COUNT)
SOURCE_UNIFORM_COUNT = {"point": 3, "pencil": 1, "uniform": 3,
                        "circular": 3, "focus": 3, "annulus": 5}

_LATER = {"dslit": "item 10: plain walk and phasor",
          "aperture": "item 10: plain walk and phasor",
          "slm": "item 10: plain walk and phasor",
          "escape_points": "item 12: workloads"}

_BEAM_TYPES = {"focus": ("square", "circle", "gaussian"),
               "annulus": ("tophat", "besselAnnulus", "gaussian")}


def _norm(v):
    """``|v|`` over the last axis as the reference forms it."""
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def _normalise(v):
    return v / _norm(v)


def _normalise_batch(v):
    n = _norm(v)
    return v / torch.where(n > 0.0, n, 1.0)


def _f32(v):
    return torch.as_tensor(v, dtype=torch.float32).detach().cpu()


def _circular_frame(params):
    """The circular source's launch frame (reference photon.f90:214-308):
    the mirrored branch is taken when the beam runs along x."""
    b = _normalise(_f32(params["direction"]))
    mirrored = bool(np.allclose(np.abs(b.numpy()), [1.0, 0.0, 0.0]))
    a = _f32([0.0, 0.0, 1.0] if mirrored else [1.0, 0.0, 0.0])
    t = T.rotation_align(a, b) @ T.invert(T.translate(
        _f32(params["position"])))
    return {"t": t, "dir": b, "mirrored": mirrored}


def _focus_annulus_frame(params):
    """Frame of the focus and annulus sources (reference:
    photon.f90:436-475 / :918-957); the ``b = -a`` mirror case, where the
    Rodrigues alignment is singular, takes the mirror matrix."""
    a = _f32([0.0, 0.0, -1.0])
    b = _normalise(_f32(params["rotation"]))
    mirrored = bool(torch.dot(a, b) < -1.0 + 1e-6)
    t_mirror = torch.diag(_f32([1.0, 1.0, -1.0, 1.0]))
    if mirrored:
        t_dir = t_mirror
        t = torch.eye(4)  # the reference resets t(3,3) = 1 (:469-471)
    else:
        t_dir = t = T.rotation_align(a, b)
    t_pos = t @ T.invert(T.translate(-_f32(params["position"])))
    return {"t_pos": t_pos, "t_dir": t_dir}


@dataclass
class Source:
    kind: str
    params: dict = field(default_factory=dict)
    spectrum: object = None  # Constant | None
    subtype: str = ""
    #: fixed launch frame tensors, built on the host from ``params``
    frame: dict = field(init=False, repr=False, default_factory=dict)

    def __post_init__(self):
        if self.kind not in SOURCE_UNIFORM_COUNT:
            if self.kind in _LATER:
                raise NotImplementedError(
                    f"source kind {self.kind!r} is not ported (ROADMAP "
                    f"queue 1, {_LATER[self.kind]})")
            raise ValueError(f"No such source {self.kind!r}")
        if self.spectrum is not None and not isinstance(self.spectrum,
                                                        Constant):
            raise NotImplementedError(
                f"spectrum {type(self.spectrum).__name__} is not ported "
                "(ROADMAP queue 1, item 11: spectral optics)")
        btype = self.subtype or "gaussian"
        if self.kind in _BEAM_TYPES and btype not in _BEAM_TYPES[self.kind]:
            raise ValueError(f"No such beam type {btype!r}")
        dev = next(iter(self.params.values())).device if self.params \
            else torch.device("cpu")
        frame = {}
        if self.kind == "circular":
            frame = _circular_frame(self.params)
        elif self.kind in _BEAM_TYPES:
            frame = _focus_annulus_frame(self.params)
        self.frame = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
                      for k, v in frame.items()}


def n_source_uniforms(source: Source) -> int:
    return SOURCE_UNIFORM_COUNT[source.kind]


def build_source(kind: str, spectrum=None, device="cpu", **params) -> Source:
    p = {}
    subtype = ""
    for k, v in params.items():
        if v is None:
            continue
        if isinstance(v, str):
            # beam subtypes (focus_type / annulus_type)
            subtype = v
        else:
            p[k] = torch.as_tensor(np.asarray(v, np.float32), device=device)
    return Source(kind=kind, params=p, spectrum=spectrum, subtype=subtype)


def _spectrum_sample(spectrum, u):
    if spectrum is None:
        return torch.full_like(u, 500.0)
    return spectrum.value.to(u.device).expand(u.shape)


def _edge_nudge(pos, grid: CartGrid, shift: float):
    """Push photons launched exactly on a grid face just inside
    (reference: photon.f90:271-285, 614-628, 671-685)."""
    half = grid.half_extent.to(pos.device)
    pos = torch.where(pos == -half, pos + shift, pos)
    return torch.where(pos == half, pos - shift, pos)


def _walk_into_grid(pos, direction, grid: CartGrid, shift: float):
    """Step a photon launched outside the grid along its direction until
    it is inside (reference: photon.f90:502-556 / :982-1036, bounded at
    ~5 tries), one axis at a time like the reference (x, then y, then
    z)."""
    half = grid.half_extent.to(pos.device)
    safe_dir = torch.where(direction == 0.0, 1e-12, direction)

    def plan(pos):
        below = pos <= -half
        above = pos >= half
        target = torch.where(below, -half + shift, half - shift)
        out = below | above
        return out, torch.where(out, (target - pos) / safe_dir, 0.0)

    out, step = plan(pos)
    for _ in range(5):
        for ax in range(3):
            moved = pos + step[..., ax, None] * direction
            pos = torch.where(out[..., ax, None], moved, pos)
            out, step = plan(pos)
    return pos


def _beam_direction(local, fl):
    """Unit launch direction towards the focal point ``(0, 0, -fl)``."""
    targ = torch.stack([torch.zeros_like(fl), torch.zeros_like(fl), -fl])
    delta = local - targ
    return -delta / _norm(delta) * torch.sign(fl)


def sample(source: Source, grid: CartGrid, u: torch.Tensor):
    """Emit a wavefront from uniforms ``u [B, n_source_uniforms]`` in
    (0, 1).  Returns (pos [B,3], dir [B,3], phase [B], wavelength [B])."""
    kind = source.kind
    p = {k: v.to(u.device) for k, v in source.params.items()}
    fr = source.frame
    B = u.shape[0]
    phase = torch.zeros((B,), dtype=u.dtype, device=u.device)
    wavelength = _spectrum_sample(source.spectrum, u[:, 0 if kind == "pencil"
                                                     else 2])
    if kind == "point":
        # reference: photon.f90:311-359
        phi = u[:, 0] * TWOPI
        cost = 2.0 * u[:, 1] - 1.0
        sint = torch.sqrt(torch.clamp(1.0 - cost * cost, min=0.0))
        direction = torch.stack(
            [sint * torch.cos(phi), sint * torch.sin(phi), cost], dim=-1)
        pos = p["position"].expand(B, 3)
    elif kind == "pencil":
        # reference: photon.f90:652-710
        pos = _edge_nudge(p["position"].expand(B, 3), grid, 8e-6)
        direction = _normalise(p["direction"]).expand(B, 3)
    elif kind == "uniform":
        # reference: photon.f90:566-649; pos = p1 + rx*p2 + ry*p3
        pos = p["point1"] + u[:, 0:1] * p["point2"] + u[:, 1:2] * p["point3"]
        pos = _edge_nudge(pos, grid, 8e-6)
        direction = _normalise(p["direction"]).expand(B, 3)
    elif kind == "circular":
        # reference: photon.f90:214-308
        r = p["radius"] * torch.sqrt(u[:, 0])
        theta = u[:, 1] * TWOPI
        rc, rs, z = r * torch.cos(theta), r * torch.sin(theta), \
            torch.zeros_like(r)
        local = torch.stack([rc, rs, z] if fr["mirrored"] else [z, rc, rs],
                            dim=-1)
        pos = _edge_nudge(-T.apply_transform(fr["t"], local), grid, 8e-6)
        direction = fr["dir"].expand(B, 3)
    else:
        phi = TWOPI * u[:, 1]
        if kind == "focus":
            # reference: photon.f90:361-563
            bs = p["beam_size"]
            ftype = source.subtype or "gaussian"
            if ftype == "square":
                x = (2.0 * u[:, 0] - 1.0) * bs
                y = (2.0 * u[:, 1] - 1.0) * bs
            else:
                # gaussian: beam_size is the 1/e radius (reference :411-422)
                radius = bs * (torch.sqrt(u[:, 0]) if ftype == "circle" else
                               torch.sqrt(-torch.log(1.0 - u[:, 0])))
                x = radius * torch.cos(phi)
                y = radius * torch.sin(phi)
            local = torch.stack([x, y, torch.zeros_like(x)], dim=-1)
            aim = local
        else:
            # annulus, reference: photon.f90:850-1043
            rlo, rhi = p["rlo"], p["rhi"]
            btype = source.subtype or "gaussian"
            mid = (rhi + rlo) / 2.0
            if btype == "tophat":
                radius = torch.sqrt(rlo ** 2 + (rhi ** 2 - rlo ** 2) * u[:, 0])
            elif btype == "besselAnnulus":
                radius = rlo + (rhi - rlo) * u[:, 0]
            else:
                r_gauss = torch.sqrt(-2.0 * torch.log(
                    torch.clamp(u[:, 3], min=1e-12)))
                radius = mid + p["sigma"] * r_gauss * torch.cos(
                    TWOPI * u[:, 4])
            cosp, sinp = torch.cos(phi), torch.sin(phi)
            zero = torch.zeros_like(cosp)
            local = torch.stack([radius * cosp, radius * sinp, zero], dim=-1)
            aim = torch.stack([mid * cosp, mid * sinp, zero], dim=-1)
        direction = _beam_direction(aim, p["focalLength"])
        direction = _normalise_batch(T.apply_rotation(fr["t_dir"], direction))
        pos = _walk_into_grid(T.apply_transform(fr["t_pos"], local),
                              direction, grid, 1e-5)
    return pos, direction, phase, wavelength
