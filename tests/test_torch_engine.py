"""The port's host loop and lane bookkeeping: tail compaction and the
shrink ladder against the reference, the draw blocks, and the deposit
route a CPU run takes (the card's route is in ``test_torch_cuda.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from rsmcrt_tpu.grid import cart_grid
from rsmcrt_tpu.scenes import setup_sphere
from rsmcrt_tpu.sdfs import scene as S
from rsmcrt_tpu.sources.sources import build_source
from rsmcrt_tpu.transport import engine as je
from rsmcrt_tpu_torch import interop
from rsmcrt_tpu_torch import scenes as tscenes
from rsmcrt_tpu_torch.grid import cart_grid as tcart
from rsmcrt_tpu_torch.sdfs.scene import build_scene as tbuild
from rsmcrt_tpu_torch.sources.sources import build_source as tsource
from rsmcrt_tpu_torch.transport import deposit as tdep
from rsmcrt_tpu_torch.transport import engine as te

torch.set_num_threads(1)

BENCH = dict(mus=[10.0], mua=[0.1], hgg=[0.9], n=[1.38],
             position=[0.0, 0.0, 0.0], boundinglength=[2.0, 2.0, 2.0],
             sphereRadius=1.0)


def _bench(device="cpu", n=16):
    scene = tbuild(tscenes.setup_sphere(BENCH, device=device), device=device)
    grid = tcart(n, n, n, 1.0, 1.0, 1.0, device=device)
    src = tsource("point", device=device, position=[0.0, 0.0, 0.0])
    return scene, grid, src


@pytest.mark.parametrize("n_lanes,min_lanes", [(32768, 4096), (4096, 4096),
                                               (65536, 1024), (300, 64)])
def test_shrink_ladder_matches_reference(n_lanes, min_lanes):
    assert te.shrink_ladder(n_lanes, min_lanes) == \
        je.shrink_ladder(n_lanes, min_lanes)


def test_compact_lanes_matches_reference():
    grid = cart_grid(16, 16, 16, 1.0, 1.0, 1.0)
    cfg = je.TransportConfig(nphotons=300, n_lanes=256, chain_scatter=True,
                             dda_substeps=8, record_emission=True)
    scene = S.build_scene(setup_sphere(BENCH))
    src = build_source("point", position=[0.0, 0.0, 0.0])
    step = jax.jit(lambda c: je.transport_step(c, scene, src, grid,
                                               jax.random.key(3), cfg))
    carry = je.init_carry(grid, cfg)
    for _ in range(8):  # budget spent, part of the lanes dead
        carry = step(carry)
    alive = np.asarray(carry.state.alive)
    assert 0 < alive.sum() < 256
    want = jax.tree_util.tree_map(np.asarray, je._compact_lanes(carry, 128))
    got = te._compact_lanes(interop.carry_from_numpy(
        jax.tree_util.tree_map(np.asarray, carry)), 128)
    for f in dataclasses.fields(te.LaneState):
        np.testing.assert_array_equal(getattr(got.state, f.name).numpy(),
                                      getattr(want.state, f.name), f.name)


def test_draw_blocks():
    scene, grid, src = _bench()
    cfg = te.TransportConfig(nphotons=10, n_lanes=64, chain_scatter=True,
                             chain_respawns=2)
    g = torch.Generator().manual_seed(0)
    d = te.draw_step(g, 64, cfg, src, "cpu")
    assert d.u_all.shape == (64, 3 + 7)
    assert d.uc.shape == (64, cfg.dda_substeps, 4)
    assert d.u_rsp.shape == (2 * 64, 3 + 1)
    for u in d:
        assert u.dtype == torch.float32
        assert float(u.min()) >= 1e-12 and float(u.max()) < 1.0
    off = te.draw_step(g, 64, dataclasses.replace(cfg, chain_respawn=False),
                       src, "cpu")
    assert off.u_rsp is None


def test_cpu_run_takes_the_plain_deposit_and_is_exact_on_launches():
    scene, grid, src = _bench()
    cfg = te.TransportConfig(nphotons=700, n_lanes=256, chain_scatter=True,
                             record_emission=True)
    k0, p0 = tdep.deposit_kernel_launches, tdep.deposit_plain_calls
    runs = [te.simulate(scene, src, grid, torch.Generator().manual_seed(1),
                        cfg, chunk_steps=chunk) for chunk in (1, 4)]
    assert tdep.deposit_kernel_launches == k0
    assert tdep.deposit_plain_calls > p0
    for tallies, bank, launched, steps in runs:
        assert bank is None
        assert int(launched) == 700
        # the point source sits inside the grid: every launch is recorded
        assert float(tallies.emission.sum()) == 700
        assert float(tallies.jmean.min()) >= 0.0
    # megasteps run after the end in a chunk's tail change nothing and are
    # not counted: the chunk length does not change the result
    (ta, _, _, sa), (tb, _, _, sb) = runs
    assert int(sa) == int(sb)
    torch.testing.assert_close(ta.jmean, tb.jmean, rtol=0, atol=0)
    torch.testing.assert_close(ta.perf, tb.perf, rtol=0, atol=0)


def test_warmup():
    scene, grid, src = _bench()
    cfg = te.TransportConfig(nphotons=100, n_lanes=1024, chain_scatter=True)
    te.warmup(scene, src, grid, torch.Generator().manual_seed(2), cfg,
              min_lanes=256)
    # with a detector bank: the caller's bins stay as they were
    from rsmcrt_tpu_torch.detectors import detectors as D

    f = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    bank = D.DetectorBank(
        circle=D.CircleDetectors(
            pos=f([[0.0, 0.0, 0.8]]), dir=f([[0.0, 0.0, -1.0]]),
            radius=f([1.0]), bin_wid=f([1.0 / 32]),
            data=torch.zeros((1, 33)), nbins=32),
        annulus=None, fibre=None, camera=None, target_values=f([-1.0]),
        order=(("circle", 0),), ids=("d0",), layers=(2,))
    te.warmup(scene, src, grid, torch.Generator().manual_seed(2),
              dataclasses.replace(cfg, record_fluence=False), bank=bank,
              min_lanes=256)
    assert float(bank.circle.data.sum()) == 0.0
    # an escape-function and a pMC configuration warm up too, and leave
    # the caller's bins as they were
    for opt in (dict(escape_shape=(2, 1)), dict(inverse_prim=1)):
        te.warmup(scene, src, grid, torch.Generator().manual_seed(2),
                  dataclasses.replace(cfg, record_fluence=False, **opt),
                  bank=bank, min_lanes=256)
    assert float(bank.circle.data.sum()) == 0.0
