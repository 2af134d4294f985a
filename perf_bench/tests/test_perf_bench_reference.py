"""The plain reference against closed forms and the van de Hulst values
of the slab that ``vdh_slab`` runs."""

import math
import tomllib

import pytest
import torch

from perf_bench.reference import box, plainmc, sphere
from perf_bench.tests.helpers import BENCH


def toml(name):
    with open(BENCH / "configs" / f"{name}.toml", "rb") as f:
        return tomllib.load(f)


def test_the_slab_gives_van_de_hulst():
    cfg = toml("vdh_slab")
    n = 200_000
    out = plainmc.simulate(cfg, box.build(cfg), n, 3, fluence=False)
    det = out["detector"].sum
    rd, td = float(det[:101].sum()) / n, float(det[101:].sum()) / n
    for got, want in ((rd, 0.09739), (td, 0.66096)):
        assert abs(got - want) < 4 * math.sqrt(want * (1 - want) / n)
    # every photon is absorbed or detected
    assert float(out["absorb"].sum.sum()) / n + rd + td == \
        pytest.approx(1.0)
    assert float(out["emission"].sum.sum()) == n


def test_pieces_cover_each_segment():
    grid = plainmc.Grid.from_toml(toml("default_sphere"), (10, 10, 10))
    gen = torch.Generator().manual_seed(1)
    pos = torch.rand((500, 3), generator=gen) * 1.6 - 0.8
    d = torch.nn.functional.normalize(torch.randn((500, 3), generator=gen),
                                      dim=-1)
    length = torch.minimum(torch.rand(500, generator=gen),
                           grid.exit_distance(pos, d))
    sid, b, piece = grid.pieces(pos, d, length)
    per = torch.zeros(500).index_add_(0, sid, piece)
    assert torch.allclose(per, length, atol=1e-5)
    assert int(b.min()) >= 0 and int(b.max()) < grid.n_bins


def test_fresnel_and_snell():
    n1, n2 = torch.tensor([1.38]), torch.tensor([1.0])
    assert float(plainmc.fresnel(torch.tensor([1.0]), n1, n2)) == \
        pytest.approx(((1.38 - 1.0) / 2.38) ** 2)
    # past the critical angle everything reflects
    assert float(plainmc.fresnel(torch.tensor([0.5]), n1, n2)) == 1.0
    d = torch.nn.functional.normalize(torch.tensor([[0.3, 0.0, 1.0]]),
                                      dim=-1)
    out = plainmc.refract(d, torch.tensor([[0.0, 0.0, 1.0]]), n1 / n2)
    assert float(torch.linalg.vector_norm(out[0, :2])) == \
        pytest.approx(1.38 * float(d[0, 0]), rel=1e-5)


def test_the_sphere_walk_ends_and_counts():
    cfg = toml("default_sphere")
    n = 2000
    out = plainmc.simulate(cfg, sphere.build(cfg), n, 9, block=(10, 10, 10))
    assert float(out["emission"].sum.sum()) == n
    assert out["nscatt"].n == n
    assert 0.1 < float(out["absorb"].sum.sum()) / n < 0.25
