"""The port on a CUDA card: the kernel path against the CPU plain path.

These tests need a card and skip without one.  They import neither
``jax`` nor ``rsmcrt_tpu``, so they also run on a machine without JAX:

    python -m pytest --noconftest -o addopts="" -m cuda \
        tests/test_torch_cuda.py tests/test_torch_deposit.py
"""

import pytest
import torch

from rsmcrt_tpu_torch import interop
from rsmcrt_tpu_torch import scenes as tscenes
from rsmcrt_tpu_torch.grid import cart_grid as tcart
from rsmcrt_tpu_torch.sdfs.scene import build_scene as tbuild
from rsmcrt_tpu_torch.sources.sources import build_source as tsource
from rsmcrt_tpu_torch.transport import deposit as tdep
from rsmcrt_tpu_torch.transport import engine as te

BENCH = dict(mus=[10.0], mua=[0.1], hgg=[0.9], n=[1.38],
             position=[0.0, 0.0, 0.0], boundinglength=[2.0, 2.0, 2.0],
             sphereRadius=1.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _bench(device="cpu", n=16):
    scene = tbuild(tscenes.setup_sphere(BENCH, device=device), device=device)
    grid = tcart(n, n, n, 1.0, 1.0, 1.0, device=device)
    src = tsource("point", device=device, position=[0.0, 0.0, 0.0])
    return scene, grid, src


@pytest.mark.cuda
def test_card_megastep_matches_cpu_megastep(cuda_device):
    """One megastep on the card (deposit kernel) and on the CPU (plain
    twin) from the same carry and the same draws: lanes agree as in the
    reference parity test, tallies to the atomics' summation order."""
    scene, grid, src = _bench()
    cfg = te.TransportConfig(nphotons=3000, n_lanes=1024, chain_scatter=True,
                             dda_substeps=16, record_emission=True)
    g = torch.Generator().manual_seed(4)
    carry = te.init_carry(grid, cfg)
    for _ in range(3):
        carry = te.transport_step(carry, scene, src, grid, g, cfg)
    draws = te.draw_step(g, cfg.n_lanes, cfg, src, "cpu")
    host = interop.carry_to_numpy(carry)

    def on(dev):
        s, gr, so = _bench(dev)
        c = te.SimCarry(
            state=te.LaneState(**{k: torch.tensor(v, device=dev)
                                  for k, v in host["state"].items()}),
            tallies=te.Tallies(**{k: torch.tensor(v, device=dev)
                                  for k, v in host["tallies"].items()}),
            bank=None,
            launched=torch.tensor(host["launched"], dtype=torch.int32,
                                  device=dev),
            step=torch.tensor(host["step"], dtype=torch.int32, device=dev))
        dr = te.StepDraws(*(u.to(dev) for u in draws))
        return interop.carry_to_numpy(
            te.transport_step(c, s, so, gr, None, cfg, draws=dr))

    k0 = tdep.deposit_kernel_launches
    got, want = on(cuda_device), on(torch.device("cpu"))
    assert tdep.deposit_kernel_launches > k0
    for f in ("alive", "layer", "steps", "bounces", "seg_prim"):
        assert (got["state"][f] == want["state"][f]).mean() >= 0.99, f
    for f in ("jmean", "absorb", "emission"):
        a, b = got["tallies"][f].sum(), want["tallies"][f].sum()
        assert abs(a - b) <= 1e-4 * abs(b), (f, a, b)
    assert got["launched"] == want["launched"]
    assert tdep.out_of_range_count(cuda_device) == 0


@pytest.mark.cuda
def test_card_run_goes_through_the_kernel(cuda_device):
    scene, grid, src = _bench(cuda_device, n=32)
    cfg = te.TransportConfig(nphotons=2000, n_lanes=1024, chain_scatter=True,
                             dda_substeps=64, record_emission=True)
    tdep.reset_counts()
    tallies, _, launched, _ = te.simulate(
        scene, src, grid,
        torch.Generator(device=cuda_device).manual_seed(5), cfg)
    assert int(launched) == 2000
    assert tdep.deposit_kernel_launches > 0 and tdep.deposit_plain_calls == 0
    assert float(tallies.emission.sum()) == 2000
    assert bool(torch.isfinite(tallies.jmean).all())


def _absorber(device):
    """tests/test_autodiff.py's pure absorber box on a 32^3 grid."""
    from rsmcrt_tpu_torch.optics.properties import mono
    from rsmcrt_tpu_torch.sdfs import scene as S

    scene = tbuild([S.box([2.0, 2.0, 2.0], mono(0.0, 0.5, 0.0, 1.0), 1,
                          device=device)], device=device)
    grid = tcart(32, 32, 32, 1.0, 1.0, 1.0, device=device)
    src = tsource("pencil", device=device, position=[0.0, 0.0, -0.99],
                  direction=[0.0, 0.0, 1.0])
    return scene, grid, src


@pytest.mark.cuda
def test_card_backward_matches_cpu(cuda_device):
    """``torch.autograd.grad`` of the total fluence in ``mua`` through 12
    megasteps of the absorber box, on the card (deposit kernel and its
    gather backward) and on the CPU (``index_add_``) from the same draws:
    rel 1e-4; every deposit of a value that needs a gradient went through
    the autograd Function, and each had its gather."""
    import dataclasses

    cfg = te.TransportConfig(nphotons=512, n_lanes=512, dda_substeps=8)
    scene0, _, src0 = _absorber("cpu")
    g = torch.Generator().manual_seed(6)
    draws = [te.draw_step(g, 512, cfg, src0, "cpu", scene0)
             for _ in range(12)]

    def grad_on(dev):
        scene, grid, src = _absorber(dev)
        mua = torch.tensor(0.5, device=dev, requires_grad=True)
        m = scene.tables.mua
        sc = dataclasses.replace(scene, tables=dataclasses.replace(
            scene.tables, mua=torch.cat([m[:1], mua[None]])))
        c = te.init_carry(grid, cfg)
        for d in draws:
            c = te.transport_step(c, sc, src, grid, None, cfg,
                                  draws=te.StepDraws(d.u_all.to(dev), None,
                                                     None))
        loss = c.tallies.jmean.sum() / 512
        return float(loss.detach()), float(torch.autograd.grad(loss, mua)[0])

    tdep.reset_counts()
    (lc, gc), (lh, gh) = grad_on(cuda_device), grad_on("cpu")
    assert tdep.deposit_autograd_calls > 0
    assert tdep.gather_kernel_launches == tdep.deposit_autograd_calls
    assert abs(lc - lh) <= 1e-5 * abs(lh)
    assert abs(gc - gh) <= 1e-4 * abs(gh), (gc, gh)
