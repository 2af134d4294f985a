"""Detectors: circle, annulus, fibre (4f system), camera (port of
``rsmcrt_tpu/detectors/detectors.py``; reference:
src/detectors/detector_base.f90, src/detectors/detectors.f90).

Each family holds its detectors' parameters stacked ``[M, ...]``, so every
detector of a family tests a whole wavefront of path segments in one
batched call.  A hit test consumes straight path segments (origin,
direction, length, weight) and returns (hit, bin value) like the
reference's ``hit_t`` protocol (detector_base.f90:9-22).  Bins are added
with one ``index_add_`` per family on the flattened bins.

Reference-parity quirks are kept: the camera counts hits, not weights,
and bins the segment start; the fibre checks the core by signed radius.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from ..constants import TWOPI

FAMILIES = ("circle", "annulus", "fibre", "camera")


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def intersect_plane(n, p0, l0, l):
    """Ray/plane: returns (hit, t) (reference: src/geometryMod.f90:217-241,
    only front-side crossings with denom > 1e-6)."""
    denom = _dot(n, l)
    safe = torch.where(torch.abs(denom) > 0.0, denom, 1.0)
    t = _dot(p0 - l0, n) / safe
    return (denom > 1e-6) & (t > -1e-6), t


def intersect_circle(n, p0, radius, l0, l):
    """Ray/disc: (hit, t, d) with d the radial distance in the disc plane
    (reference: src/geometryMod.f90:244-270)."""
    hit_p, t = intersect_plane(n, p0, l0, l)
    p = l0 + l * t[..., None]
    d = torch.sqrt(torch.clamp(_dot(p - p0, p - p0), min=0.0))
    return hit_p & (d <= radius), t, d


def _solve_quadratic_smallest_positive(a, b, c):
    """(hit, t): smallest non-negative root (reference:
    geometryMod.f90:272-303 + root selection :47-58)."""
    discrim = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp(discrim, min=0.0))
    q = torch.where(b > 0.0, -0.5 * (b + sq), -0.5 * (b - sq))
    x0 = q / torch.where(a != 0.0, a, 1.0)
    x1 = c / torch.where(q != 0.0, q, 1.0)
    t0, t1 = torch.minimum(x0, x1), torch.maximum(x0, x1)
    t = torch.where(t0 < 0.0, t1, t0)
    return (discrim >= 0.0) & (t >= 0.0), t


def intersect_sphere(orig, direction, centre, radius):
    """Ray/sphere smallest positive root (reference: geometryMod.f90:21-62)."""
    L = orig - centre
    return _solve_quadratic_smallest_positive(
        _dot(direction, direction), 2.0 * _dot(direction, L),
        _dot(L, L) - radius**2)


def intersect_cylinder(orig, direction, centre, radius):
    """Infinite z-cylinder (reference: geometryMod.f90:64-108)."""
    L = orig - centre
    dx, dy = direction[..., 0], direction[..., 1]
    return _solve_quadratic_smallest_positive(
        dx**2 + dy**2, 2.0 * (dx * L[..., 0] + dy * L[..., 1]),
        L[..., 0]**2 + L[..., 1]**2 - radius**2)


def intersect_ellipse(orig, direction, centre, semia, semib):
    """Infinite elliptical cylinder along x (reference:
    geometryMod.f90:111-161; z/y axes)."""
    L = orig - centre
    ia, ib = 1.0 / semia**2, 1.0 / semib**2
    dy, dz = direction[..., 1], direction[..., 2]
    return _solve_quadratic_smallest_positive(
        ia * dz**2 + ib * dy**2, 2.0 * (ia * dz * L[..., 2] + ib * dy
                                        * L[..., 1]),
        ia * L[..., 2]**2 + ib * L[..., 1]**2 - 1.0)


def intersect_cone(orig, direction, centre, radius, height):
    """Infinite cone along z (reference: geometryMod.f90:164-215)."""
    k = (radius / height)**2
    L = orig - centre
    dx, dy, dz = direction[..., 0], direction[..., 1], direction[..., 2]
    lz = L[..., 2] - height
    return _solve_quadratic_smallest_positive(
        dx**2 + dy**2 - k * dz**2,
        2.0 * (dx * L[..., 0] + dy * L[..., 1] - k * dz * lz),
        L[..., 0]**2 + L[..., 1]**2 - k * lz**2)


# ---------------------------------------------------------------------------
# Detector families
# ---------------------------------------------------------------------------

@dataclass
class CircleDetectors:
    """Stacked circle detectors (reference: detectors.f90:13-24, :107-164)."""

    pos: torch.Tensor  # [M, 3]
    dir: torch.Tensor  # [M, 3]
    radius: torch.Tensor  # [M]
    bin_wid: torch.Tensor  # [M]
    data: torch.Tensor  # [M, nbins+1]
    nbins: int
    # per-detector bin counts (<= nbins, which pads the family); None
    # means every member uses nbins
    nbins_arr: Optional[torch.Tensor] = None

    def check_hit(self, o, d, seg_len):
        """o, d [B, 3]; seg_len [B] -> (hit [B, M], value [B, M])."""
        hit, t, dist = intersect_circle(self.dir, self.pos, self.radius,
                                        o[:, None, :], d[:, None, :])
        in_seg = (t > 0.0) & (t <= seg_len[:, None])
        return hit & in_seg, dist

    def hit_t(self, o, d):
        return intersect_circle(self.dir, self.pos, self.radius,
                                o[:, None, :], d[:, None, :])[1]


@dataclass
class AnnulusDetectors:
    """Stacked annular detectors (reference: detectors.f90:59-71,
    :166-244).  Hits the r2 disc but not the r1 disc; bins r - r1."""

    pos: torch.Tensor
    dir: torch.Tensor
    r1: torch.Tensor
    r2: torch.Tensor
    bin_wid: torch.Tensor
    data: torch.Tensor
    nbins: int
    nbins_arr: Optional[torch.Tensor] = None

    def check_hit(self, o, d, seg_len):
        hit1, _, _ = intersect_circle(self.dir, self.pos, self.r1,
                                      o[:, None, :], d[:, None, :])
        hit2, t, dist = intersect_circle(self.dir, self.pos, self.r2,
                                         o[:, None, :], d[:, None, :])
        in_seg = (t > 0.0) & (t <= seg_len[:, None])
        return ~hit1 & hit2 & in_seg, dist - self.r1

    def hit_t(self, o, d):
        return intersect_circle(self.dir, self.pos, self.r2,
                                o[:, None, :], d[:, None, :])[1]


@dataclass
class FibreDetectors:
    """Stacked fibre detectors: 4f lens system traced with the thin-lens
    approximation (reference: detectors.f90:26-57, :246-393)."""

    pos: torch.Tensor
    dir: torch.Tensor
    focalLength1: torch.Tensor
    focalLength2: torch.Tensor
    f1Aperture: torch.Tensor
    f2Aperture: torch.Tensor
    frontOffset: torch.Tensor
    backOffset: torch.Tensor
    frontToPinSep: torch.Tensor
    pinToBackSep: torch.Tensor
    pinAperture: torch.Tensor
    acceptAngle: torch.Tensor
    coreDiameter: torch.Tensor
    bin_wid: torch.Tensor
    data: torch.Tensor
    nbins: int
    nbins_arr: Optional[torch.Tensor] = None

    def _lens_pos(self):
        return self.pos + self.dir * self.frontOffset[:, None]

    def check_hit(self, o, d, seg_len):
        hit, t, radius = intersect_circle(
            self.dir, self._lens_pos(), self.f1Aperture, o[:, None, :],
            d[:, None, :])
        hit = hit & (t > 0.0) & (t <= seg_len[:, None])
        costt = torch.clamp(_dot(self.dir, d[:, None, :]), -1.0, 1.0)
        sintt = torch.sqrt(torch.clamp(1.0 - costt * costt, min=0.0))
        gradient = sintt / torch.where(costt != 0.0, costt, 1.0)
        # front lens (thin lens), then pinhole
        gradient = -radius / self.focalLength1 + gradient
        radius = radius + gradient * self.frontToPinSep
        hit = hit & (radius <= self.pinAperture)
        # to the back lens
        radius = radius + gradient * self.pinToBackSep
        hit = hit & (radius <= self.f2Aperture)
        gradient = -radius / self.focalLength2 + gradient
        # to the fibre face; the core test takes the SIGNED radius
        radius = radius + gradient * self.backOffset
        angle = torch.abs(torch.arctan(gradient)) * 360.0 / TWOPI
        hit = hit & (angle <= self.acceptAngle)
        hit = hit & (radius <= self.coreDiameter / 2.0)
        return hit, torch.abs(radius)

    def hit_t(self, o, d):
        return intersect_circle(self.dir, self._lens_pos(), self.f1Aperture,
                                o[:, None, :], d[:, None, :])[1]


@dataclass
class CameraDetectors:
    """Stacked rectangle ("camera") detectors
    (reference: detectors.f90:74-95, :395-469).  2D binning; adds counts,
    not weights (reference: detector_base.f90:229)."""

    pos: torch.Tensor  # p1 corner [M, 3]
    n: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    width: torch.Tensor
    height: torch.Tensor
    bin_wid_x: torch.Tensor
    bin_wid_y: torch.Tensor
    data: torch.Tensor  # [M, nbins+1, nbins+1]
    nbins: int
    nbins_arr: Optional[torch.Tensor] = None

    def check_hit(self, o, d, seg_len):
        denom = _dot(self.n, d[:, None, :])
        safe = torch.where(denom != 0.0, denom, 1.0)
        t = _dot(self.pos - o[:, None, :], self.n) / safe
        v = (o[:, None, :] + t[..., None] * d[:, None, :]) - self.pos
        proj1 = _dot(v, self.e1) / self.width
        proj2 = _dot(v, self.e2) / self.height
        hit = (t >= 0.0) & (denom != 0.0)
        hit &= (proj1 > 0.0) & (proj1 < self.width)
        hit &= (proj2 > 0.0) & (proj2 < self.height)
        # no upper bound on t (the reference's check_hit_camera has none,
        # detectors.f90:447-469), but only real segments may test
        hit &= seg_len[:, None] > 0.0
        # the reference bins the SEGMENT START: x = start.z + det.pos.x,
        # y = start.y + det.pos.y (detector_base.f90:222-223)
        hx = o[:, None, 2] + self.pos[:, 0]
        hy = o[:, None, 1] + self.pos[:, 1]
        return hit, (hx, hy)

    def hit_t(self, o, d):
        denom = _dot(self.n, d[:, None, :])
        return _dot(self.pos - o[:, None, :], self.n) / torch.where(
            denom != 0.0, denom, 1.0)


@dataclass
class DetectorBank:
    """All detectors in a simulation, grouped by family.

    ``order`` maps user detector indices to (family, member) so outputs can
    be reported in config order; ``target_values`` feed the inverse kernel
    (reference: detector_base.f90:41-42)."""

    circle: Optional[CircleDetectors]
    annulus: Optional[AnnulusDetectors]
    fibre: Optional[FibreDetectors]
    camera: Optional[CameraDetectors]
    target_values: torch.Tensor  # [n_dects]
    order: tuple = ()
    ids: tuple = ()
    layers: tuple = ()

    @property
    def n_detectors(self):
        return len(self.order)

    def families(self):
        """``(name, family)`` for each family present."""
        return [(f, getattr(self, f)) for f in FAMILIES
                if getattr(self, f) is not None]

    def to(self, device) -> "DetectorBank":
        """A copy of the bank with every tensor on ``device``."""
        def move(obj):
            return dataclasses.replace(obj, **{
                f.name: getattr(obj, f.name).to(device, copy=True)
                for f in dataclasses.fields(obj)
                if isinstance(getattr(obj, f.name), torch.Tensor)})

        return dataclasses.replace(
            move(self), **{f: move(fam) for f, fam in self.families()})


def _cap(dect, default: int):
    """The per-detector bin cap, ``[1, M]``, or ``default`` for all."""
    return default if dect.nbins_arr is None else dect.nbins_arr[None, :]


def _clip_max(idx, cap):
    return torch.minimum(idx, cap) if torch.is_tensor(cap) \
        else torch.clamp(idx, max=cap)


def _bin_idx_1d(dect, value):
    """Reference 1D binning: round(value / bin_wid) clipped to the
    per-detector bin count (detector_base.f90:144-153)."""
    idx = torch.round(value / dect.bin_wid).to(torch.int32)
    return torch.clamp(_clip_max(idx, _cap(dect, dect.nbins)), min=0)


def _bin_idx_cam(cam, hx, hy):
    """Reference 2D camera binning flattened to one index
    (detector_base.f90:222-227 incl. the negative-wrap quirk)."""
    nb = cam.data.shape[1]
    cap = _cap(cam, nb - 1)
    idx = _clip_max((hx / cam.bin_wid_x).to(torch.int32) + 1, cap)
    idy = _clip_max((hy / cam.bin_wid_y).to(torch.int32) + 1, cap)
    idx = torch.where(idx < 1, cap, idx) - 1
    idy = torch.where(idy < 1, cap, idy) - 1
    return idx * nb + idy


def check_bins(bank: DetectorBank, o, d, seg_len, weight,
               want_t: bool = False):
    """Hit test + bin index for every family with no accumulation:
    ``{family: (idx [B, M] int32, w [B, M])}`` with ``w`` masked by the
    hit (1 per hit for the camera, which counts photons,
    detector_base.f90:229).  The chained walk collects these per round and
    adds them once per megastep with :func:`flush_bins`.  With ``want_t``
    each family also carries the hit distance ``t [B, M]``."""
    out = {}
    for fam, f in bank.families():
        hit, val = f.check_hit(o, d, seg_len)
        if fam == "camera":
            row = [_bin_idx_cam(f, *val), torch.where(hit, 1.0, 0.0)]
        else:
            row = [_bin_idx_1d(f, val),
                   torch.where(hit, weight[:, None], 0.0)]
        if want_t:
            row.append(torch.where(hit, f.hit_t(o, d), 0.0))
        out[fam] = tuple(row)
    return out


def ordered_cols(bank: DetectorBank, fams, col: int):
    """Stack one column of :func:`check_bins` output into config order:
    ``[B, n_detectors]``."""
    cols = [fams[fam][col][:, m] for fam, m in bank.order]
    return torch.stack(cols, dim=-1) if cols else None


def _add_bins(f, idx, w):
    """``f.data`` plus the weights ``w [B', M]`` at bins ``idx [B', M]``:
    one ``index_add_`` on the flattened bins of the family."""
    M = f.data.shape[0]
    nb = f.data[0].numel()
    flat = idx.long() + torch.arange(M, device=idx.device) * nb
    data = f.data.reshape(-1).index_add(0, flat.reshape(-1),
                                        w.reshape(-1).to(f.data.dtype))
    return dataclasses.replace(f, data=data.reshape(f.data.shape))


def flush_bins(bank: DetectorBank, acc) -> DetectorBank:
    """Add collected ``(idx, w)`` rounds into the bank's bins:
    ``acc: {family: (idx [B', M], w [B', M])}``, one ``index_add_`` per
    family."""
    updates = {fam: _add_bins(getattr(bank, fam), *acc[fam][:2])
               for fam, _ in bank.families() if fam in acc}
    return dataclasses.replace(bank, **updates)


def record_hits(bank: DetectorBank, o, d, seg_len, weight,
                want_hit_matrix: bool = False):
    """Bin every segment against every detector, returning an updated bank
    (reference: record_hit_1D_sub / record_hit_2D_sub,
    detector_base.f90:137-163, :206-235).

    With ``want_hit_matrix`` also returns per-lane hit weights and hit
    distances ``[B, n_detectors]`` in config order."""
    if bank is None:
        return (bank, None, None) if want_hit_matrix else bank
    fams = check_bins(bank, o, d, seg_len, weight, want_t=want_hit_matrix)
    new_bank = flush_bins(bank, fams)
    if not want_hit_matrix:
        return new_bank
    return new_bank, ordered_cols(bank, fams, 1), ordered_cols(bank, fams, 2)


def totals(bank: DetectorBank) -> torch.Tensor:
    """Per-detector total counts in user order (reference total_dect,
    detector_base.f90:175-203)."""
    per_family = {fam: f.data.reshape(f.data.shape[0], -1).sum(dim=-1)
                  for fam, f in bank.families()}
    out = [per_family[fam][m] for fam, m in bank.order]
    return torch.stack(out) if out else torch.zeros((0,))


def zero_detectors(bank: DetectorBank) -> DetectorBank:
    """Zero the accumulated bins only (reference zero_dect,
    detector_base.f90:165-173); geometry and targets are preserved."""
    if bank is None:
        return None
    return dataclasses.replace(bank, **{
        fam: dataclasses.replace(f, data=torch.zeros_like(f.data))
        for fam, f in bank.families()})
