"""``geom_name = "sphere"``: a sphere of one medium (``sphereRadius``,
centred at ``position``) inside a vacuum box of full lengths
``boundingBox`` centred at the origin.  Layers: 1 the sphere, 2 the
vacuum."""

from __future__ import annotations

import math

import torch

from .plainmc import Layer, _dot
from .box import box_exit, inside_box, medium


class SphereInBox:
    def __init__(self, centre, radius, half, layer):
        self.centre, self.radius, self.half = centre, radius, half
        self.layers = [Layer(0.0, 0.0, 0.0, 1.0), layer,
                       Layer(0.0, 0.0, 0.0, 1.0)]

    def _classify(self, p):
        c = p.new_tensor(self.centre)
        in_s = torch.linalg.vector_norm(p - c, dim=-1) < self.radius
        in_b = inside_box(p, p.new_tensor(self.half))
        return torch.where(in_s, 1, torch.where(in_b, 2, 0))

    def start_layer(self, pos, d):
        return self._classify(pos + 1e-7 * d)

    def exit(self, pos, d, layer):
        c = pos.new_tensor(self.centre)
        p = pos - c
        b = _dot(p, d)
        cc = _dot(p, p) - self.radius ** 2
        disc = b * b - cc
        root = torch.sqrt(torch.clamp(disc, min=0.0))
        t_out = torch.clamp(-b + root, min=0.0)
        enters = (cc > 0.0) & (b < 0.0) & (disc > 0.0)
        t_in = torch.where(enters, torch.clamp(-b - root, min=0.0),
                           torch.full_like(b, math.inf))
        hb = pos.new_tensor(self.half)
        t_box, n_box = box_exit(pos, d, hb)
        in_sphere = layer == 1
        hits_sphere = ~in_sphere & (t_in < t_box)
        t = torch.where(in_sphere, t_out, torch.minimum(t_in, t_box))
        on_sphere = in_sphere | hits_sphere
        q = p + t[:, None] * d
        n_s = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1,
                                                       keepdim=True),
                              min=1e-30)
        nrm = torch.where(on_sphere[:, None], n_s, n_box)
        after = torch.where(
            in_sphere, torch.where(inside_box(pos + t[:, None] * d, hb,
                                              closed=True), 2, 0),
            torch.where(hits_sphere, 1, 0))
        return t, nrm, after


def build(cfg: dict) -> SphereInBox:
    g = cfg["geometry"]
    bound = [float(v) for v in g.get("boundingBox", [2.0, 2.0, 2.0])]
    return SphereInBox(tuple(float(v) for v in g.get("position",
                                                     [0.0, 0.0, 0.0])),
                       float(g.get("sphereRadius", 1.0)),
                       tuple(0.5 * v for v in bound), medium(g))
