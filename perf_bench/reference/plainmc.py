"""Plain Monte Carlo radiation transfer: the benchmark's reference.

An event-by-event photon walk in plain PyTorch, written from the physics
and from the frozen TOML alone.  It imports nothing of the program: no
kernel, no transport code, no scene or detector code.  A scene module of
this folder (``sphere.py``, ``box.py``, found by the TOML's ``geom_name``)
supplies the geometry in closed form.

Each photon starts at the source, flies an exponential optical depth,
then either scatters (Henyey-Greenstein) or is absorbed, in the ratio of
the layer's ``mus`` to ``mus + mua``.  At a surface it is reflected with
the unpolarised Fresnel probability or refracted by Snell's law; it dies
outside every layer or outside the grid.  Tallies, all with weight 1:

- ``jmean``: path length in each tally bin (a block of grid voxels),
- ``absorb``: absorption events in the bin of the absorbing voxel,
- ``emission``: launches in the bin of the launch voxel,
- ``detector``: crossings of each circle detector's disc from its front
  side, binned by ``round(distance / (radius / nbins))``,
- ``nscatt``: scatters, one bin.

Every tally keeps, per bin, the sum over photons of each photon's total
and of its square, and the number of photons that touched the bin, so the
comparison knows the spread of one photon's contribution.  ``dtype`` is
the arithmetic of the walk; ``acc_dtype`` that of the sums.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

TWOPI = 2.0 * math.pi


@dataclass
class Layer:
    mus: float
    mua: float
    g: float
    n: float


@dataclass
class Agg:
    """Per-bin sums over ``n`` photons of each photon's contribution
    (``sum``), of its square (``sumsq``) and the photons that touched the
    bin (``count``); ``total_*`` the same of each photon's sum over all
    bins."""

    sum: torch.Tensor
    sumsq: torch.Tensor
    count: torch.Tensor
    n: int
    # the same of each photon's total over all bins
    total_sumsq: float = 0.0
    total_count: int = 0

    def __add__(self, other: "Agg") -> "Agg":
        return Agg(self.sum + other.sum, self.sumsq + other.sumsq,
                   self.count + other.count, self.n + other.n,
                   self.total_sumsq + other.total_sumsq,
                   self.total_count + other.total_count)


@dataclass
class Grid:
    """The TOML's Cartesian grid, cut into tally bins of ``block`` voxels
    along each axis."""

    counts: tuple
    half: tuple
    block: tuple

    @classmethod
    def from_toml(cls, cfg: dict, block=(1, 1, 1)) -> "Grid":
        g = cfg["grid"]
        counts = (int(g["nxg"]), int(g["nyg"]), int(g["nzg"]))
        for c, b in zip(counts, block):
            if c % b:
                raise ValueError(f"block {block} does not divide {counts}")
        return cls(counts, (float(g["xmax"]), float(g["ymax"]),
                            float(g["zmax"])), tuple(int(b) for b in block))

    @property
    def bins(self) -> tuple:
        return tuple(c // b for c, b in zip(self.counts, self.block))

    @property
    def n_bins(self) -> int:
        bx, by, bz = self.bins
        return bx * by * bz

    def voxel(self, pos):
        """Voxel index ``[..., 3]`` (long) and whether it lies in the grid:
        ``floor(n (p + h) / 2h)`` per axis."""
        t = pos.new_tensor
        c = t(self.counts)
        h = t(self.half)
        idx = torch.floor(c * (pos + h) / (2.0 * h)).long()
        ok = torch.all((idx >= 0) & (idx < torch.tensor(
            self.counts, device=pos.device)), dim=-1)
        return idx, ok

    def bin_of_voxel(self, idx):
        b = torch.tensor(self.block, device=idx.device)
        nb = self.bins
        q = torch.div(idx, b, rounding_mode="floor")
        return (q[..., 0] * nb[1] + q[..., 1]) * nb[2] + q[..., 2]

    def exit_distance(self, pos, d):
        """Distance along ``d`` to leave the grid box (0 outside)."""
        h = pos.new_tensor(self.half)
        safe = torch.where(d == 0.0, torch.ones_like(d), d)
        t = torch.where(d > 0.0, (h - pos) / safe,
                        torch.where(d < 0.0, (-h - pos) / safe,
                                    torch.full_like(d, math.inf)))
        return torch.clamp(torch.amin(t, dim=-1), min=0.0)

    def pieces(self, pos, d, length):
        """Cut the segments ``pos + t d``, ``0 <= t <= length``, at every
        tally-bin wall: ``(segment index, bin, piece length)`` for each
        piece, from the sorted crossings of every axis."""
        dev = pos.device
        S = pos.shape[0]
        h = pos.new_tensor(self.half)
        w = 2.0 * h * pos.new_tensor(self.block) / pos.new_tensor(self.counts)
        lo = -h
        c0 = torch.floor((pos - lo) / w)
        c1 = torch.floor((pos + length[:, None] * d - lo) / w)
        n_ax = torch.abs(c1 - c0).long()  # walls crossed along each axis
        every = torch.arange(S, device=dev)
        lengths = length.double()
        segs = [every, every]
        ts = [torch.zeros_like(lengths), lengths]
        for a in range(3):
            m = n_ax[:, a]
            tot = int(m.sum())
            if tot == 0:
                continue
            sid = torch.repeat_interleave(every, m)
            start = torch.cumsum(m, 0) - m
            j = (torch.arange(tot, device=dev) - start[sid] + 1).to(c0.dtype)
            da = d[sid, a]
            k = torch.where(da > 0.0, c0[sid, a] + j, c0[sid, a] - j + 1.0)
            t = (k * w[a] + lo[a] - pos[sid, a]) / da
            segs.append(sid)
            ts.append(torch.minimum(torch.clamp(t.double(), min=0.0),
                                    lengths[sid]))
        seg = torch.cat(segs)
        t = torch.cat(ts)
        span = torch.clamp(lengths, min=1e-300)
        key = seg.double() + 0.5 * t / span[seg]
        order = torch.argsort(key)
        seg, t = seg[order], t[order]
        same = seg[1:] == seg[:-1]
        t0, t1 = t[:-1][same], t[1:][same]
        sid = seg[:-1][same]
        piece = (t1 - t0).to(pos.dtype)
        keep = piece > 0.0
        sid, t0, t1, piece = sid[keep], t0[keep], t1[keep], piece[keep]
        mid = pos[sid] + (0.5 * (t0 + t1)).to(pos.dtype)[:, None] * d[sid]
        idx, ok = self.voxel(mid)
        idx = torch.minimum(torch.clamp(idx, min=0), torch.tensor(
            self.counts, device=dev) - 1)
        return sid[ok], self.bin_of_voxel(idx)[ok], piece[ok]


@dataclass
class Circle:
    """A circle detector of the TOML (the disc's plane, front side
    ``direction``)."""

    pos: tuple
    dir: tuple
    radius: float
    nbins: int


def circles(cfg: dict) -> list:
    out = []
    for row in cfg.get("detectors", []):
        if row.get("type", "circle") != "circle":
            raise ValueError("the reference bins circle detectors only")
        d = [float(v) for v in row.get("direction", [0.0, 0.0, -1.0])]
        nrm = math.sqrt(sum(v * v for v in d))
        out.append(Circle(tuple(float(v) for v in row["position"]),
                          tuple(v / nrm for v in d), float(row["radius"]),
                          int(row.get("nbins", 100))))
    return out


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def fresnel(cos_i, n1, n2):
    """Unpolarised Fresnel reflectance; 1 past the critical angle."""
    sin_t = (n1 / n2) * torch.sqrt(torch.clamp(1.0 - cos_i * cos_i, min=0.0))
    tir = sin_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=0.0))
    rs = (n1 * cos_i - n2 * cos_t) / (n1 * cos_i + n2 * cos_t)
    rp = (n1 * cos_t - n2 * cos_i) / (n1 * cos_t + n2 * cos_i)
    r = 0.5 * (rs * rs + rp * rp)
    return torch.where(tir, torch.ones_like(r), r)


def refract(d, nrm, eta):
    """Snell refraction of ``d`` through a surface of normal ``nrm`` (any
    orientation), ``eta = n1 / n2``."""
    c = _dot(d, nrm)
    nn = torch.where(c[:, None] < 0.0, nrm, -nrm)
    c = torch.abs(c)
    k = torch.sqrt(torch.clamp(1.0 - eta * eta * (1.0 - c * c), min=0.0))
    out = eta[:, None] * d + (eta * c - k)[:, None] * nn
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)


def reflect(d, nrm):
    return d - 2.0 * _dot(d, nrm)[:, None] * nrm


def hg_direction(d, g, u_cost, u_phi):
    """Rotate ``d`` by a Henyey-Greenstein polar angle and a uniform
    azimuth."""
    gg = torch.where(g == 0.0, torch.full_like(g, 0.5), g)
    tmp = (1.0 - gg * gg) / (1.0 - gg + 2.0 * gg * u_cost)
    cost = torch.where(g == 0.0, 2.0 * u_cost - 1.0,
                       (1.0 + gg * gg - tmp * tmp) / (2.0 * gg))
    cost = torch.clamp(cost, -1.0, 1.0)
    sint = torch.sqrt(torch.clamp(1.0 - cost * cost, min=0.0))
    phi = TWOPI * u_phi
    # an orthonormal frame around d
    helper = torch.where((torch.abs(d[:, 2]) < 0.9)[:, None],
                         d.new_tensor([0.0, 0.0, 1.0]).expand_as(d),
                         d.new_tensor([1.0, 0.0, 0.0]).expand_as(d))
    e1 = torch.linalg.cross(d, helper)
    e1 = e1 / torch.linalg.vector_norm(e1, dim=-1, keepdim=True)
    e2 = torch.linalg.cross(d, e1)
    out = (cost[:, None] * d + (sint * torch.cos(phi))[:, None] * e1
           + (sint * torch.sin(phi))[:, None] * e2)
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)


def sample_source(cfg: dict, n: int, gen, device, dtype):
    """Launch positions and directions of the TOML's source: ``point``
    (isotropic) or ``pencil`` (along its axis)."""
    src = cfg["source"]
    pos = torch.tensor([float(v) for v in src.get("position",
                                                  [0.0, 0.0, 0.0])],
                       device=device, dtype=dtype).expand(n, 3).clone()
    kind = src["name"]
    if kind == "point":
        u = torch.rand((n, 2), generator=gen, device=device, dtype=dtype)
        cost = 2.0 * u[:, 1] - 1.0
        sint = torch.sqrt(torch.clamp(1.0 - cost * cost, min=0.0))
        phi = TWOPI * u[:, 0]
        d = torch.stack([sint * torch.cos(phi), sint * torch.sin(phi), cost],
                        dim=-1)
    elif kind == "pencil":
        axis = src.get("direction", "z")
        vec = {"x": [1.0, 0.0, 0.0], "y": [0.0, 1.0, 0.0],
               "z": [0.0, 0.0, 1.0], "-x": [-1.0, 0.0, 0.0],
               "-y": [0.0, -1.0, 0.0], "-z": [0.0, 0.0, -1.0]}[axis] \
            if isinstance(axis, str) else [float(v) for v in axis]
        d = torch.tensor(vec, device=device, dtype=dtype).expand(n, 3)
        d = (d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)).clone()
    else:
        raise ValueError(f"the reference has no {kind!r} source")
    return pos, d


def _uniform(shape, gen, device, dtype):
    u = torch.rand(shape, generator=gen, device=device, dtype=dtype)
    return torch.clamp(u, min=torch.finfo(dtype).tiny)


class _Rows:
    """Rows ``(photon, bin, value)`` of one tally for one block of
    photons, reduced at the end to per-bin sums of each photon's total
    and of its square."""

    def __init__(self):
        self.p, self.b, self.v = [], [], []

    def add(self, p, b, v):
        if p.numel():
            self.p.append(p)
            self.b.append(b)
            self.v.append(v)

    def reduce(self, n_bins, n_photons, device, acc_dtype) -> Agg:
        z = torch.zeros(n_bins, device=device, dtype=acc_dtype)
        if not self.p:
            return Agg(z, z.clone(), torch.zeros(n_bins, device=device,
                                                 dtype=torch.long),
                       n_photons)
        p, b = torch.cat(self.p), torch.cat(self.b)
        v = torch.cat(self.v).to(acc_dtype)
        keys, inv = torch.unique(p * n_bins + b, return_inverse=True)
        per = torch.zeros(keys.numel(), device=device,
                          dtype=acc_dtype).index_add_(0, inv, v)
        kb = keys % n_bins
        tot = torch.zeros(n_photons, device=device,
                          dtype=acc_dtype).index_add_(0, p, v)
        return Agg(z.index_add(0, kb, per), z.index_add(0, kb, per * per),
                   torch.bincount(kb, minlength=n_bins), n_photons,
                   float((tot * tot).sum()), int((tot != 0).sum()))


def simulate(cfg: dict, scene, nphotons: int, seed: int, device="cpu",
             dtype=torch.float32, acc_dtype=torch.float64,
             fluence: bool = True, block=(1, 1, 1), chunk: int = 1 << 16,
             max_events: int = 20_000, strict: bool = True) -> dict:
    """Run ``nphotons`` photons of the TOML ``cfg`` through ``scene`` in
    blocks of ``chunk``: ``{tally: Agg}``.  A photon still alive after
    ``max_events`` events raises, or with ``strict`` off (a walk in a low
    precision can stall on a surface) is dropped where it stands."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & ((1 << 63) - 1))
    grid = Grid.from_toml(cfg, block)
    dets = circles(cfg)
    det_bins = [c.nbins + 1 for c in dets]
    out = {}
    done = 0
    while done < nphotons:
        n = min(chunk, nphotons - done)
        part = _walk(cfg, scene, grid, dets, det_bins, n, gen, device,
                     dtype, acc_dtype, fluence, max_events, strict)
        out = part if not out else {k: out[k] + part[k] for k in out}
        done += n
    return out


def _walk(cfg, scene, grid, dets, det_bins, n, gen, device, dtype,
          acc_dtype, fluence, max_events, strict):
    layers = scene.layers
    tab = {k: torch.tensor([getattr(lay, k) for lay in layers],
                           device=device, dtype=dtype)
           for k in ("mus", "mua", "g", "n")}
    pos, d = sample_source(cfg, n, gen, device, dtype)
    pid = torch.arange(n, device=device)
    layer = scene.start_layer(pos, d)
    nsc = torch.zeros(n, device=device, dtype=acc_dtype)
    rows = {k: _Rows() for k in ("jmean", "absorb", "emission", "detector")}

    vox, ok = grid.voxel(pos)
    rows["emission"].add(pid[ok], grid.bin_of_voxel(vox)[ok],
                         torch.ones(int(ok.sum()), device=device,
                                    dtype=dtype))
    alive = ok & (layer > 0)
    pos, d, layer, pid = pos[alive], d[alive], layer[alive], pid[alive]
    det_off = [sum(det_bins[:i]) for i in range(len(dets))]
    events = 0
    while pid.numel():
        events += 1
        if events > max_events:
            if strict:
                raise RuntimeError(f"{pid.numel()} photons still alive "
                                   f"after {max_events} events")
            break
        m = pid.numel()
        u = _uniform((m, 5), gen, device, dtype)
        mus, mua, g = tab["mus"][layer], tab["mua"][layer], tab["g"][layer]
        kap = mus + mua
        s = torch.where(kap > 0.0, -torch.log(u[:, 0]) / torch.where(
            kap > 0.0, kap, torch.ones_like(kap)), torch.full_like(kap,
                                                                   math.inf))
        tb, nrm, nxt = scene.exit(pos, d, layer)
        tg = grid.exit_distance(pos, d)
        at_surface = tb <= s
        seg = torch.minimum(s, tb)
        leaves = tg < seg
        seg = torch.minimum(seg, tg)
        if fluence:
            sid, b, piece = grid.pieces(pos, d, seg)
            rows["jmean"].add(pid[sid], b, piece)
        for c, off in zip(dets, det_off):
            cp = pos.new_tensor(c.pos)
            cn = pos.new_tensor(c.dir)
            den = _dot(d, cn)
            t = _dot(cp - pos, cn) / torch.where(den != 0.0, den,
                                                 torch.ones_like(den))
            hit = (den > 1e-6) & (t > 0.0) & (t <= seg)
            dist = torch.linalg.vector_norm(pos + t[:, None] * d - cp,
                                            dim=-1)
            hit = hit & (dist <= c.radius)
            bw = c.radius / c.nbins
            b = torch.clamp(torch.round(dist / bw), 0, c.nbins).long() + off
            rows["detector"].add(pid[hit], b[hit],
                                 torch.ones(int(hit.sum()), device=device,
                                            dtype=dtype))
        pos = pos + seg[:, None] * d
        inside = ~leaves
        interact = inside & ~at_surface
        scatter = interact & (u[:, 1] * kap < mus)
        absorb = interact & ~scatter
        vox, vok = grid.voxel(pos)
        ab = absorb & vok
        rows["absorb"].add(pid[ab], grid.bin_of_voxel(vox[ab]),
                           torch.ones(int(ab.sum()), device=device,
                                      dtype=dtype))
        nsc.index_add_(0, pid[scatter], torch.ones(
            int(scatter.sum()), device=device, dtype=acc_dtype))
        d = torch.where(scatter[:, None], hg_direction(d, g, u[:, 2],
                                                       u[:, 3]), d)
        surf = inside & at_surface
        gone = surf & (nxt == 0)
        n1, n2 = tab["n"][layer], tab["n"][nxt]
        fres = surf & ~gone & (n1 != n2)
        cos_i = torch.clamp(torch.abs(_dot(d, nrm)), max=1.0)
        refl = fres & (u[:, 4] <= fresnel(cos_i, n1, n2))
        through = surf & ~gone & ~refl
        d = torch.where(refl[:, None], reflect(d, nrm),
                        torch.where((through & fres)[:, None],
                                    refract(d, nrm, n1 / n2), d))
        layer = torch.where(through, nxt, layer)
        keep = inside & ~absorb & ~gone
        pos, d, layer, pid = pos[keep], d[keep], layer[keep], pid[keep]

    nb = grid.n_bins
    out = {
        "jmean": rows["jmean"].reduce(nb, n, device, acc_dtype),
        "absorb": rows["absorb"].reduce(nb, n, device, acc_dtype),
        "emission": rows["emission"].reduce(nb, n, device, acc_dtype),
        "nscatt": Agg(nsc.sum()[None], (nsc * nsc).sum()[None],
                      (nsc > 0).sum()[None], n, float((nsc * nsc).sum()),
                      int((nsc > 0).sum())),
    }
    if dets:
        out["detector"] = rows["detector"].reduce(sum(det_bins), n, device,
                                                  acc_dtype)
    return out
