"""``geom_name = "box"``: a box of one medium (full lengths
``BoxDimensions``, centred at ``position``) inside a vacuum box of full
lengths ``boundingBox`` centred at the origin.  Layers: 1 the box, 2 the
vacuum."""

from __future__ import annotations

import math

import torch

from .plainmc import Layer


def medium(g: dict) -> Layer:
    """The first optical properties of the TOML's ``[geometry]``."""
    return Layer(float(g["mus"][0]), float(g["mua"][0]), float(g["hgg"][0]),
                 float(g["n"][0]))


def inside_box(p, half, closed=False):
    a = torch.abs(p)
    return torch.all(a <= half if closed else a < half, dim=-1)


def box_exit(pos, d, half):
    """Distance along ``d`` from inside the origin-centred box of
    half-lengths ``half`` to its wall, and the wall's normal."""
    safe = torch.where(d == 0.0, torch.ones_like(d), d)
    t = torch.where(d > 0.0, (half - pos) / safe,
                    torch.where(d < 0.0, (-half - pos) / safe,
                                torch.full_like(d, math.inf)))
    tmin, axis = torch.min(t, dim=-1)
    nrm = torch.nn.functional.one_hot(axis, 3).to(pos.dtype)
    return torch.clamp(tmin, min=0.0), nrm


def box_entry(pos, d, half):
    """Distance along ``d`` from outside the origin-centred box to its
    wall (inf when the ray misses it) and the wall's normal."""
    safe = torch.where(d == 0.0, torch.full_like(d, 1e-30), d)
    t1, t2 = (-half - pos) / safe, (half - pos) / safe
    near, axis = torch.max(torch.minimum(t1, t2), dim=-1)
    far = torch.amin(torch.maximum(t1, t2), dim=-1)
    hit = (near >= 0.0) & (near <= far)
    nrm = torch.nn.functional.one_hot(axis, 3).to(pos.dtype)
    return torch.where(hit, near, torch.full_like(near, math.inf)), nrm


class BoxInBox:
    def __init__(self, centre, half_in, half_out, layer):
        self.centre, self.half_in, self.half_out = centre, half_in, half_out
        self.layers = [Layer(0.0, 0.0, 0.0, 1.0), layer,
                       Layer(0.0, 0.0, 0.0, 1.0)]

    def _classify(self, p):
        c = p.new_tensor(self.centre)
        in_i = inside_box(p - c, p.new_tensor(self.half_in))
        in_o = inside_box(p, p.new_tensor(self.half_out))
        return torch.where(in_i, 1, torch.where(in_o, 2, 0))

    def start_layer(self, pos, d):
        return self._classify(pos + 1e-7 * d)

    def exit(self, pos, d, layer):
        c = pos.new_tensor(self.centre)
        hi = pos.new_tensor(self.half_in)
        ho = pos.new_tensor(self.half_out)
        t_in_exit, n_in = box_exit(pos - c, d, hi)
        t_out, n_out = box_exit(pos, d, ho)
        t_enter, n_enter = box_entry(pos - c, d, hi)
        in_box = layer == 1
        # leaving the inner box: into the vacuum unless that wall is also
        # the outer box's
        q = pos + t_in_exit[:, None] * d
        shared = torch.sum(n_in * (torch.abs(q) >= ho), dim=-1) > 0
        outside_outer = ~inside_box(q, ho, closed=True)
        after_in = torch.where(shared | outside_outer, 0, 2)
        hits_inner = ~in_box & (t_enter < t_out)
        t = torch.where(in_box, t_in_exit, torch.minimum(t_enter, t_out))
        nrm = torch.where(in_box[:, None], n_in,
                          torch.where(hits_inner[:, None], n_enter, n_out))
        after = torch.where(in_box, after_in, torch.where(hits_inner, 1, 0))
        return t, nrm, after


def build(cfg: dict) -> BoxInBox:
    g = cfg["geometry"]
    dims = [float(v) for v in g.get("BoxDimensions", [1.0, 1.0, 1.0])]
    bound = [float(v) for v in g.get("boundingBox", [2.0, 2.0, 2.0])]
    return BoxInBox(tuple(float(v) for v in g.get("position",
                                                  [0.0, 0.0, 0.0])),
                    tuple(0.5 * v for v in dims),
                    tuple(0.5 * v for v in bound), medium(g))
