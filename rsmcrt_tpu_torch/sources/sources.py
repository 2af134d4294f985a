"""Photon source sampling (port of ``rsmcrt_tpu/sources/sources.py``;
reference: src/photon.f90:159-1043).

A :class:`Source` is a kind plus parameter tensors; ``sample`` consumes a
block of uniforms ``u [B, n]`` and emits a whole wavefront of photons.
Every kind of the reference is ported: ``point``, ``pencil``,
``uniform``, ``circular``, ``focus`` (square, circle, gaussian),
``annulus`` (tophat, besselAnnulus, gaussian), the coherent ``dslit`` and
``aperture`` sources of the phasor tally, the ``slm`` image source, and
the escape function's ``escape_points`` (isotropic photons from the
centre of each lane's source voxel ``sid``); wavelengths come from a ``Constant``, ``Piecewise1D`` or
``Piecewise2D`` spectrum.  The fixed frames (the circular source's
mirrored branch, the focus and annulus rotations) are decided once on the
host when the source is built, not per photon.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..constants import TWOPI
from ..grid import CartGrid, np_dtype
from ..maths import transforms as T
from ..optics.piecewise import (Constant, Piecewise1D, Piecewise2D,
                                sample_piecewise1d, sample_piecewise2d)

# uniforms consumed per source kind (the reference's SOURCE_UNIFORM_COUNT)
SOURCE_UNIFORM_COUNT = {"escape_points": 3, "point": 3, "pencil": 1,
                        "uniform": 3, "circular": 3, "focus": 3,
                        "annulus": 5, "dslit": 6, "aperture": 5, "slm": 3}

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


def _host(v, dtype):
    """``v`` as a ``dtype`` tensor on the host (a frame is built there)."""
    return torch.as_tensor(v, dtype=dtype).detach().cpu()


def _circular_frame(params, dtype):
    """The circular source's launch frame (reference photon.f90:214-308):
    the mirrored branch is taken when the beam runs along x."""
    b = _normalise(_host(params["direction"], dtype))
    mirrored = bool(np.allclose(np.abs(b.numpy()), [1.0, 0.0, 0.0]))
    a = _host([0.0, 0.0, 1.0] if mirrored else [1.0, 0.0, 0.0], dtype)
    t = T.rotation_align(a, b) @ T.invert(T.translate(
        _host(params["position"], dtype), dtype))
    return {"t": t, "dir": b, "mirrored": mirrored}


def _focus_annulus_frame(params, dtype):
    """Frame of the focus and annulus sources (reference:
    photon.f90:436-475 / :918-957); the ``b = -a`` mirror case, where the
    Rodrigues alignment is singular, takes the mirror matrix."""
    a = _host([0.0, 0.0, -1.0], dtype)
    b = _normalise(_host(params["rotation"], dtype))
    mirrored = bool(torch.dot(a, b) < -1.0 + 1e-6)
    t_mirror = torch.diag(_host([1.0, 1.0, -1.0, 1.0], dtype))
    if mirrored:
        t_dir = t_mirror
        # the reference resets t(3,3) = 1 (:469-471)
        t = torch.eye(4, dtype=dtype)
    else:
        t_dir = t = T.rotation_align(a, b)
    t_pos = t @ T.invert(T.translate(-_host(params["position"], dtype),
                                     dtype))
    return {"t_pos": t_pos, "t_dir": t_dir}


@dataclass
class Source:
    """A source's kind and parameter tensors (all of one float type, the
    run's: its frames are built in that type)."""

    kind: str
    params: dict = field(default_factory=dict)
    spectrum: object = None  # Constant | Piecewise1D | Piecewise2D | None
    subtype: str = ""
    #: fixed launch frame tensors, built on the host from ``params``
    frame: dict = field(init=False, repr=False, default_factory=dict)

    def __post_init__(self):
        if self.kind not in SOURCE_UNIFORM_COUNT:
            raise ValueError(f"No such source {self.kind!r}")
        if self.spectrum is not None and not isinstance(
                self.spectrum, (Constant, Piecewise1D, Piecewise2D)):
            raise TypeError(
                f"cannot sample wavelength from {type(self.spectrum)}")
        if self.kind == "slm" and not isinstance(self.spectrum, Piecewise2D):
            raise TypeError("slm source requires a 2D spectrum")
        btype = self.subtype or "gaussian"
        if self.kind in _BEAM_TYPES and btype not in _BEAM_TYPES[self.kind]:
            raise ValueError(f"No such beam type {btype!r}")
        first = next(iter(self.params.values()), None)
        dev = first.device if first is not None else torch.device("cpu")
        dtype = (first.dtype if first is not None and first.is_floating_point()
                 else torch.float32)
        frame = {}
        if self.kind == "circular":
            frame = _circular_frame(self.params, dtype)
        elif self.kind in _BEAM_TYPES:
            frame = _focus_annulus_frame(self.params, dtype)
        self.frame = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
                      for k, v in frame.items()}


def n_source_uniforms(source: Source) -> int:
    n = SOURCE_UNIFORM_COUNT[source.kind]
    if isinstance(source.spectrum, Piecewise2D):
        # 2D image spectra draw two in-cell jitter uniforms (reference
        # sample2D, piecewise.f90:171-190)
        n += 2
    return n


def build_source(kind: str, spectrum=None, device="cpu",
                 dtype=torch.float32, **params) -> Source:
    """A source whose parameters (and spectrum) are ``dtype`` tensors on
    ``device``: float32, or float64 for a float64 run, as the reference's
    ``build_source(dtype=)``."""
    p = {}
    subtype = ""
    for k, v in params.items():
        if v is None:
            continue
        if isinstance(v, str):
            # beam subtypes (focus_type / annulus_type)
            subtype = v
        else:
            p[k] = torch.as_tensor(np.asarray(v, np_dtype(dtype)),
                                   device=device)
    if spectrum is not None and dtype != torch.float32:
        spectrum = spectrum.to(device, dtype)
    return Source(kind=kind, params=p, spectrum=spectrum, subtype=subtype)


def _spectrum_sample(spectrum, u, u_full):
    """A wavelength per lane from the selection uniform ``u``; a 2D image
    spectrum jitters within its cell with the last two columns of
    ``u_full`` and gives the sample's x coordinate (reference
    photon.f90:293/:347 with sample2D, piecewise.f90:171-190)."""
    if spectrum is None:
        return torch.full_like(u, 500.0)
    if isinstance(spectrum, Constant):
        return spectrum.value.to(u.device).expand(u.shape)
    if isinstance(spectrum, Piecewise1D):
        return sample_piecewise1d(spectrum, u)
    x, _ = sample_piecewise2d(spectrum, u, u_full[:, -2], u_full[:, -1])
    return x


def _coherent_launch(dx, dy, dz):
    """Direction and launch phase of the coherent slit / aperture sources.
    The phase is the transverse excess ``t2 / (dist + |dz|)`` of the
    slit-to-screen distance over the axial ``|dz|``, computed without
    cancellation: the full distance (the reference's float64 phase,
    photon.f90:747/:826) has a float32 ulp of ~2 wavelengths, and a
    per-wavelength constant offset cancels in ``|E|^2``."""
    t2 = dx * dx + dy * dy
    adz = torch.abs(dz)
    dist = torch.sqrt(t2 + dz * dz)
    phase = t2 / (dist + adz)
    direction = torch.stack([dx / dist, dy / dist, -adz / dist], dim=-1)
    return direction, phase


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


def sample(source: Source, grid: CartGrid, u: torch.Tensor, sid=None):
    """Emit a wavefront from uniforms ``u [B, n_source_uniforms]`` in
    (0, 1).  Returns (pos [B,3], dir [B,3], phase [B], wavelength [B]).
    ``sid [B]`` is each lane's source voxel, read by ``escape_points``
    only."""
    kind = source.kind
    p = {k: v.to(u.device) for k, v in source.params.items()}
    fr = source.frame
    B = u.shape[0]
    f64 = u.dtype == torch.float64
    # the face nudge and the walk-in margin (reference sources.py:197,
    # :302): a float32 ulp at 1.0 is too coarse for float64's
    shift = 7.9e-7 if f64 else 8e-6
    walk_in = 9e-7 if f64 else 1e-5
    phase = torch.zeros((B,), dtype=u.dtype, device=u.device)
    spec = source.spectrum
    if kind == "slm":
        # reference: photon.f90:159-212, an image source; the wavelength
        # is fixed and the image offset of 100 cells is the reference's
        # own, whatever the grid
        x, y = sample_piecewise2d(spec, u[:, 0], u[:, 1], u[:, 2])
        f = np.float32
        sx = (x - 100.0) / float(f(grid.nxg) / (f(2.0) * f(grid.xmax)))
        sy = (y - 100.0) / float(f(grid.nyg) / (f(2.0) * f(grid.ymax)))
        pos = torch.stack([sx, sy, p["position"][2].expand(B)], dim=-1)
        direction = _normalise(p["direction"]).expand(B, 3)
        return pos, direction, phase, torch.full((B,), 500e-9,
                                                 dtype=u.dtype,
                                                 device=u.device)
    wavelength = _spectrum_sample(
        spec, u[:, 0 if kind in ("pencil", "dslit", "aperture") else 2], u)
    if kind == "dslit":
        # reference: photon.f90:712-780
        a, b = 60.0 * wavelength, 20.0 * wavelength
        x1 = torch.where(u[:, 1] > 0.5, a / 2.0 + b * u[:, 2],
                         -a / 2.0 - b * u[:, 2])
        y1 = (u[:, 3] - 0.5) * b
        z2 = 5.0 - (1e-5 * (2.0 * (5.0 / 400.0)))
        x2 = (2.0 * u[:, 4] - 1.0) * 5.0
        y2 = (2.0 * u[:, 5] - 1.0) * 5.0
        z1 = (10000.0 * wavelength) - 5.0
        pos = torch.stack([x2, y2, torch.full_like(x2, z2)], dim=-1)
        direction, phase = _coherent_launch(x2 - x1, y2 - y1, z2 - z1)
    elif kind == "aperture":
        # reference: photon.f90:782-848
        apwid = 200e-6
        b = apwid / 2.0
        fno = 4.95
        x1 = (2.0 * u[:, 1] - 1.0) * b
        y1 = (2.0 * u[:, 2] - 1.0) * b
        z1 = (1.0 / ((((fno / apwid) ** 2) / 2.0) * wavelength)) - 0.5
        x2 = u[:, 3] - 0.5
        y2 = u[:, 4] - 0.5
        z2 = 0.5 - (1e-5 * (2.0 * 0.5 / 400.0))
        pos = torch.stack([x2, y2, torch.full_like(x2, z2)], dim=-1)
        direction, phase = _coherent_launch(x2 - x1, y2 - y1, z2 - z1)
    elif kind in ("point", "escape_points"):
        # reference: photon.f90:311-359; escape_points launches from the
        # centre of the lane's source voxel (kernelsMod.f90:167-184)
        phi = u[:, 0] * TWOPI
        cost = 2.0 * u[:, 1] - 1.0
        sint = torch.sqrt(torch.clamp(1.0 - cost * cost, min=0.0))
        direction = torch.stack(
            [sint * torch.cos(phi), sint * torch.sin(phi), cost], dim=-1)
        if kind == "point":
            pos = p["position"].expand(B, 3)
        else:
            positions = p["positions"]  # [M, 3]
            pos = positions[torch.clamp(sid, 0, positions.shape[0] - 1)
                            .long()]
    elif kind == "pencil":
        # reference: photon.f90:652-710
        pos = _edge_nudge(p["position"].expand(B, 3), grid, shift)
        direction = _normalise(p["direction"]).expand(B, 3)
    elif kind == "uniform":
        # reference: photon.f90:566-649; pos = p1 + rx*p2 + ry*p3
        pos = p["point1"] + u[:, 0:1] * p["point2"] + u[:, 1:2] * p["point3"]
        pos = _edge_nudge(pos, grid, shift)
        direction = _normalise(p["direction"]).expand(B, 3)
    elif kind == "circular":
        # reference: photon.f90:214-308
        r = p["radius"] * torch.sqrt(u[:, 0])
        theta = u[:, 1] * TWOPI
        rc, rs, z = r * torch.cos(theta), r * torch.sin(theta), \
            torch.zeros_like(r)
        local = torch.stack([rc, rs, z] if fr["mirrored"] else [z, rc, rs],
                            dim=-1)
        pos = _edge_nudge(-T.apply_transform(fr["t"], local), grid, shift)
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
                              direction, grid, walk_in)
    return pos, direction, phase, wavelength
