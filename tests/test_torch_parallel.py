"""The port's photon sharding (``rsmcrt_tpu_torch.parallel.mesh``) against
the reference's ``rsmcrt_tpu.parallel.mesh`` on conftest's 8-device CPU
mesh, and the sharded path's exact invariants.

Physics is compared statistically, as ``tests/test_multichip.py`` does
(each package with its own RNG): nscatt/photon within 3.0 of the
tau^2/2 + tau law and within 4.0 of the other package (standard error
about 1.3 at 2,000 photons), fluence per photon within 5%.  The
reductions are exact: a sharded run's tallies and detector bins equal
the sums of its shards run one by one with the same generators, and its
tracks their concatenation.
"""

import numpy as np
import pytest
import torch

from rsmcrt_tpu_torch.grid import cart_grid
from rsmcrt_tpu_torch.optics.properties import mono
from rsmcrt_tpu_torch.parallel import mesh as M
from rsmcrt_tpu_torch.sdfs import scene as S
from rsmcrt_tpu_torch.sources.sources import build_source
from rsmcrt_tpu_torch.transport.engine import TransportConfig, simulate

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8


def _scene(mus=10.0, mua=0.0, hgg=0.0):
    return S.build_scene([
        S.sphere(1.0, mono(mus, mua, hgg, 1.0), 1),
        S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0), 2),
    ])


def _circle_bank(z=0.5, radius=1.0):
    from rsmcrt_tpu_torch.detectors.detectors import (CircleDetectors,
                                                      DetectorBank)

    circle = CircleDetectors(
        pos=torch.tensor([[0.0, 0.0, z]]), dir=torch.tensor([[0.0, 0.0, 1.0]]),
        radius=torch.tensor([radius]), bin_wid=torch.tensor([radius / 10]),
        data=torch.zeros((1, 11)), nbins=10)
    return DetectorBank(circle=circle, annulus=None, fibre=None, camera=None,
                        target_values=torch.tensor([-1.0]),
                        order=(("circle", 0),), ids=("c",), layers=(1,))


def _shards_one_by_one(scene, src, grid, seed, cfg, n_shards, bank=None):
    """Each shard of a sharded run alone, through ``engine.simulate``."""
    per = -(-cfg.nphotons // n_shards)
    return [simulate(scene, src, grid, M.shard_generator(seed, i, "cpu"),
                     TransportConfig(**{**cfg.__dict__, "nphotons": per}),
                     bank=bank)
            for i in range(n_shards)]


def test_sharded_physics_matches_reference():
    import jax

    from rsmcrt_tpu.grid import cart_grid as jgrid
    from rsmcrt_tpu.optics.properties import mono as jmono
    from rsmcrt_tpu.parallel import mesh as jmesh
    from rsmcrt_tpu.sdfs import scene as JS
    from rsmcrt_tpu.sources.sources import build_source as jsource
    from rsmcrt_tpu.transport.engine import TransportConfig as JConfig

    jscene = JS.build_scene([
        JS.sphere(1.0, jmono(10.0, 0.0, 0.0, 1.0), 1),
        JS.box([2.0, 2.0, 2.0], jmono(0.0, 0.0, 0.0, 1.0), 2),
    ])
    jm = jmesh.make_mesh()
    assert jm.devices.size == 8
    tj, _, lj, _ = jmesh.simulate_sharded(
        jscene, jsource("point", position=[0.0, 0.0, 0.0]),
        jgrid(32, 32, 32, 1.0, 1.0, 1.0), jax.random.key(5),
        JConfig(nphotons=2000, n_lanes=256), mesh=jm)

    cfg = TransportConfig(nphotons=2000, n_lanes=256)
    tt, _, lt, steps = M.simulate_sharded(
        _scene(), build_source("point", position=[0.0, 0.0, 0.0]),
        cart_grid(32, 32, 32, 1.0, 1.0, 1.0), 5, cfg, mesh=CPU8)
    assert int(lt) == int(lj) == 2000  # 8 x ceil(2000 / 8)
    assert int(steps) > 0
    ns_t = float(tt.nscatt) / int(lt)
    ns_j = float(tj.nscatt) / int(lj)
    assert abs(ns_t - 57.5) < 3.0, ns_t
    assert abs(ns_t - ns_j) < 4.0, (ns_t, ns_j)
    j_t = float(tt.jmean.double().sum()) / int(lt)
    j_j = float(np.asarray(tj.jmean, np.float64).sum()) / int(lj)
    assert abs(j_t - j_j) / j_j < 0.05, (j_t, j_j)


def test_sharded_tallies_and_bins_are_the_sums_of_the_shards():
    scene, grid = _scene(mus=2.0, mua=0.3), cart_grid(16, 16, 16, 1.0, 1.0,
                                                        1.0)
    src = build_source("pencil", position=[0.0, 0.0, 0.0],
                       direction=[0.0, 0.0, 1.0])
    bank = _circle_bank()
    cfg = TransportConfig(nphotons=801, n_lanes=128)
    tl, bk, launched, steps = M.simulate_sharded(
        scene, src, grid, 2, cfg, bank=bank, mesh=["cpu"] * 3)
    parts = _shards_one_by_one(scene, src, grid, 2, cfg, 3, bank=bank)
    assert int(launched) == 3 * 267 == sum(int(p[2]) for p in parts)
    assert int(steps) == max(int(p[3]) for p in parts)
    for name in ("jmean", "absorb", "emission", "nscatt", "mom_pos",
                 "perf", "track_dropped"):
        want = sum(getattr(p[0], name) for p in parts)
        assert torch.equal(getattr(tl, name), want), name
    assert torch.equal(bk.circle.data, sum(p[1].circle.data for p in parts))
    # geometry and targets stay as they were, not summed
    assert torch.equal(bk.circle.radius, bank.circle.radius)
    assert torch.equal(bk.circle.pos, bank.circle.pos)
    assert torch.equal(bk.target_values, bank.target_values)
    # the caller's bank is untouched
    assert float(bank.circle.data.abs().sum()) == 0.0
    # tests/test_multichip.py::test_detector_psum's bounds: the bins are
    # summed once, not once a shard
    from rsmcrt_tpu_torch.detectors.detectors import totals

    tot = float(totals(bk)[0])
    assert int(launched) * 0.5 <= tot < int(launched) * 3.0


def test_history_refused_with_the_reference_message():
    import jax

    from rsmcrt_tpu.grid import cart_grid as jgrid
    from rsmcrt_tpu.optics.properties import mono as jmono
    from rsmcrt_tpu.parallel import mesh as jmesh
    from rsmcrt_tpu.sdfs import scene as JS
    from rsmcrt_tpu.sources.sources import build_source as jsource
    from rsmcrt_tpu.transport.engine import TransportConfig as JConfig

    jscene = JS.build_scene([
        JS.sphere(1.0, jmono(10.0, 0.0, 0.0, 1.0), 1),
        JS.box([2.0, 2.0, 2.0], jmono(0.0, 0.0, 0.0, 1.0), 2),
    ])
    with pytest.raises(ValueError, match="history") as want:
        jmesh.simulate_sharded(
            jscene, jsource("point", position=[0.0, 0.0, 0.0]),
            jgrid(16, 16, 16, 1.0, 1.0, 1.0), jax.random.key(0),
            JConfig(nphotons=64, n_lanes=64, history_len=8, max_tracks=16),
            mesh=jmesh.make_mesh())
    cfg = TransportConfig(nphotons=64, n_lanes=64, history_len=8,
                          max_tracks=16)
    with pytest.raises(ValueError, match="history") as got:
        M.simulate_sharded(_scene(), build_source("point",
                                                  position=[0.0, 0.0, 0.0]),
                           cart_grid(16, 16, 16, 1.0, 1.0, 1.0), 0, cfg,
                           bank=_circle_bank(), mesh=CPU8)
    assert str(got.value) == str(want.value)


def test_chunked_sharded_history_gathers_per_shard():
    """tests/test_history.py::test_history_sharded_gathers_per_shard on the
    port, and the gathered tracks are the shards' own, in shard order."""
    scene = _scene(mus=5.0)
    grid = cart_grid(16, 16, 16, 1.0, 1.0, 1.0)
    src = build_source("point", position=[0.0, 0.0, 0.0])
    bank = _circle_bank(z=0.95, radius=0.9)
    cfg = TransportConfig(nphotons=400, n_lanes=64, history_len=16,
                          max_tracks=256)
    t, _, launched, _ = M.simulate_sharded_chunked(
        scene, src, grid, 4, cfg, bank=bank, mesh=CPU8)
    assert int(launched) == 400
    count = int(t.track_count)
    assert count > 0
    assert t.tracks.shape[0] == count
    tr = t.tracks.numpy()
    starts_origin = np.all(np.abs(tr[:, 0, :3]) < 1e-5, axis=-1)
    assert starts_origin.sum() > 0
    parts = _shards_one_by_one(scene, src, grid, 4, cfg, 8, bank=bank)
    want = torch.cat([p[0].tracks[:int(p[0].track_count)] for p in parts])
    assert torch.equal(t.tracks, want)


def test_sharded_pmc_stats_are_summed():
    """tests/test_multichip.py::test_sharded_pmc_stats on the port: the
    pMC sufficient statistics ``w * [1, cnt, len, hg, fn, bn]`` are the
    sums of the shards' (exact), and per photon the detected weight, count
    and length agree with a single-device run (rtol 0.25).  The score
    columns (``hg``, ``fn``, ``bn``) are sums of signed scores whose mean
    is near 0 at these optical properties; they are held by the exact
    sum, not statistically."""
    scene = _scene(mus=5.0, mua=0.5, hgg=0.3)
    grid = cart_grid(32, 32, 32, 1.0, 1.0, 1.0)
    src = build_source("point", position=[0.0, 0.0, 0.0])
    cfg = TransportConfig(nphotons=2000, n_lanes=128, inverse_prim=1,
                          record_fluence=False)
    t_sh, _, l_sh, _ = M.simulate_sharded(scene, src, grid, 11, cfg,
                                          bank=_circle_bank(),
                                          mesh=["cpu"] * 2)
    parts = _shards_one_by_one(scene, src, grid, 11, cfg, 2,
                               bank=_circle_bank())
    assert torch.equal(t_sh.pmc_stats, parts[0][0].pmc_stats
                       + parts[1][0].pmc_stats)
    gen = torch.Generator().manual_seed(11)
    t_1, _, l_1, _ = simulate(
        scene, src, grid, gen,
        TransportConfig(nphotons=2000, n_lanes=1024, inverse_prim=1,
                        record_fluence=False), bank=_circle_bank())
    sh = t_sh.pmc_stats.numpy() / int(l_sh)
    s1 = t_1.pmc_stats.numpy() / int(l_1)
    assert sh.shape == (1, 6)
    assert float(sh[0, 0]) > 0.0
    assert np.allclose(sh[:, :3], s1[:, :3], rtol=0.25, atol=0.02), (sh, s1)


def test_shard_streams_differ_and_reruns_repeat():
    a = M.shard_generator(7, 0, "cpu")
    b = M.shard_generator(7, 1, "cpu")
    c = M.shard_generator(7, 0, "cpu")
    da, db, dc = (torch.rand(64, generator=g) for g in (a, b, c))
    assert not torch.equal(da, db)
    assert torch.equal(da, dc)
    assert M.shard_seed(7, 0) != M.shard_seed(8, 0)
    scene, grid = _scene(mus=2.0), cart_grid(8, 8, 8, 1.0, 1.0, 1.0)
    src = build_source("point", position=[0.0, 0.0, 0.0])
    cfg = TransportConfig(nphotons=256, n_lanes=64)
    r1 = M.simulate_sharded(scene, src, grid, 3, cfg, mesh=["cpu"] * 2)
    r2 = M.simulate_sharded(scene, src, grid, 3, cfg, mesh=["cpu"] * 2)
    assert torch.equal(r1[0].jmean, r2[0].jmean)
    assert torch.equal(r1[0].nscatt, r2[0].nscatt)
    # the two shards of one run draw different photons
    parts = _shards_one_by_one(scene, src, grid, 3, cfg, 2)
    assert not torch.equal(parts[0][0].jmean, parts[1][0].jmean)


def test_mesh_devices():
    if torch.cuda.is_available():
        pytest.skip("the default mesh is the visible cards")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        M.make_mesh()
    assert M.make_mesh(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError):
        M.make_mesh([])


def test_to_device_moves_every_tensor():
    from rsmcrt_tpu_torch import kernels

    parsed, scene = kernels.setup("res/test_dects.toml", device="cpu")
    objs = (scene, parsed.source, parsed.settings.grid, parsed.detectors)
    moved = M.to_device(objs, "meta")
    seen = []

    def walk(x, depth=0):
        if isinstance(x, torch.Tensor):
            seen.append(x.device.type)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v, depth)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v, depth)
        elif hasattr(x, "__dict__") and depth < 8 and \
                type(x).__module__.startswith("rsmcrt_tpu_torch."):
            for v in vars(x).values():
                walk(v, depth + 1)

    walk(moved)
    assert seen and set(seen) == {"meta"}
    assert moved[2].device == torch.device("meta")
    # the originals stay where they were
    assert scene.device == torch.device("cpu")
    assert M.to_device(scene, "cpu") is not scene
