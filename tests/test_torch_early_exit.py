"""A chunk of the port's forward run stops where the reference's does.

The reference's chunk is a ``while_loop`` whose ``cond`` stops once the
photon budget is spent and no lane is alive (rsmcrt_tpu/transport/
engine.py:1957).  On the CPU the port's ``simulate`` reads that test
before every megastep, so it dispatches exactly the megasteps it counts
in ``step`` -- at 1,024 lanes or fewer too, where a chunk is 128
megasteps -- and ``launched``, ``step`` and every tally equal those of an
explicit loop of that many ``transport_step`` calls on the same seeded
generator."""

import dataclasses

import pytest
import torch

from rsmcrt_tpu_torch import kernels
from rsmcrt_tpu_torch.grid import cart_grid
from rsmcrt_tpu_torch.optics.properties import mono
from rsmcrt_tpu_torch.parallel import mesh as M
from rsmcrt_tpu_torch.sdfs import scene as S
from rsmcrt_tpu_torch.sources.sources import build_source
from rsmcrt_tpu_torch.tally import Tallies
from rsmcrt_tpu_torch.transport import engine as te

torch.set_num_threads(1)


def _sphere(g=12):
    scene = S.build_scene([
        S.sphere(1.0, mono(10.0, 0.1, 0.9, 1.38), 1),
        S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0), 2)])
    return (scene, build_source("point", position=[0.0, 0.0, 0.0]),
            cart_grid(g, g, g, 1.0, 1.0, 1.0))


def _cfg(n, lanes, chained=True, **kw):
    fast = kernels.fast_path_defaults(device="cpu") if chained else {}
    return te.TransportConfig(nphotons=n, n_lanes=lanes,
                              record_emission=True, **fast, **kw)


class _Counting:
    """``engine.transport_step`` wrapped to count its calls."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = te.transport_step

        def counting(*a, **k):
            self.calls += 1
            return real(*a, **k)

        monkeypatch.setattr(te, "transport_step", counting)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("lanes,chained,kw", [
    (256, True, {}),  # 128-megastep chunks
    (2048, True, dict(min_lanes=256)),  # 16-megastep chunks, tail shrink
    (512, False, {}),  # the plain walk
])
def test_dispatches_exactly_the_counted_megasteps(monkeypatch, lanes,
                                                  chained, kw):
    scene, src, grid = _sphere()
    count = _Counting(monkeypatch)
    tl, _, launched, steps = te.simulate(scene, src, grid, _gen(5),
                                         _cfg(600, lanes, chained), **kw)
    assert int(launched) == 600
    assert count.calls == int(steps) > 0
    assert not bool(torch.any(tl.jmean < 0)) and float(tl.jmean.sum()) > 0


def test_max_steps_still_caps_the_run(monkeypatch):
    scene, src, grid = _sphere()
    count = _Counting(monkeypatch)
    _, _, launched, steps = te.simulate(scene, src, grid, _gen(5),
                                        _cfg(600, 256, max_steps=5))
    assert count.calls == int(steps) == 5 and 256 <= int(launched) < 600


def test_sharded_shards_stop_where_they_finish(monkeypatch):
    scene, src, grid = _sphere()
    count = _Counting(monkeypatch)
    runs = M.run_shards(scene, src, grid, 3, _cfg(600, 256), None,
                        M.make_mesh(["cpu", "cpu"]), range(2), 300)
    assert count.calls == sum(r.step for r in runs)
    assert [r.launched for r in runs] == [300, 300]


@pytest.mark.parametrize("chained", [True, False])
def test_equals_an_explicit_loop(chained):
    scene, src, grid = _sphere()
    cfg = _cfg(700, 256, chained)
    tl, _, launched, steps = te.simulate(scene, src, grid, _gen(11), cfg)
    gen = _gen(11)
    carry = te.init_carry(grid, cfg)
    for _ in range(int(steps)):
        carry = te.transport_step(carry, scene, src, grid, gen, cfg)
    assert not bool(torch.any(carry.state.alive))
    assert int(carry.launched) == int(launched) == 700
    assert int(carry.step) == int(steps)
    for f in dataclasses.fields(Tallies):
        a, b = getattr(tl, f.name), getattr(carry.tallies, f.name)
        assert torch.equal(a, b), f.name
