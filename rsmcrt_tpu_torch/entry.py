"""Integration points of the port, counterparts of ``__graft_entry__.py``.

``entry()`` returns one forward transport megastep on the flagship sphere
scene and a carry to run it on: the single-card check.

``dryrun_multichip(n)`` runs the photon-sharded simulation over ``n``
devices end to end (wavefront transport on every shard, then the sum of
the tallies and detector bins over the shards: the reference's
parallelism is data parallelism over photons and an MPI tally reduction,
src/kernelsMod.f90:1833-1892, :2351-2357), in both sharded configurations
of the reference's dryrun: the fluence run and the detector bank with the
pMC inverse statistics.

Both run on the card unless the caller names other devices.
"""

from __future__ import annotations

import torch

from . import default_device
from .detectors.detectors import CircleDetectors, DetectorBank, totals
from .grid import cart_grid
from .optics.properties import mono
from .parallel.mesh import make_mesh, simulate_sharded_chunked
from .sdfs import scene as S
from .sources.sources import build_source
from .transport.engine import TransportConfig, init_carry, transport_step


def _flagship(grid_n=64, device="cpu"):
    """The flagship scene: a mus 10, mua 0.1, g 0.9, n 1.38 unit sphere in
    a 2-unit vacuum box, a point source at the centre, a ``grid_n``^3
    grid."""
    scene = S.build_scene([
        S.sphere(1.0, mono(10.0, 0.1, 0.9, 1.38), 1, device=device),
        S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0), 2, device=device),
    ], device=device)
    grid = cart_grid(grid_n, grid_n, grid_n, 1.0, 1.0, 1.0, device=device)
    source = build_source("point", device=device, position=[0.0, 0.0, 0.0])
    return scene, source, grid


def entry(device=None):
    """``(fn, example_args)``: one wavefront transport megastep of the
    flagship scene on 64^3 at 1,024 lanes, and a fresh carry.  ``fn(carry)``
    returns the next carry, its uniforms drawn from a generator seeded 0;
    ``fn(carry, draws)`` takes them as given (``engine.StepDraws``)."""
    device = torch.device(device) if device is not None else default_device()
    scene, source, grid = _flagship(device=device)
    cfg = TransportConfig(nphotons=1024, n_lanes=1024)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    def fn(carry, draws=None):
        return transport_step(carry, scene, source, grid, gen, cfg,
                              draws=draws)

    return fn, (init_carry(grid, cfg),)


def _check(what, cond, got):
    if not cond:
        raise AssertionError(f"dryrun: {what}: {got}")


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run both sharded configurations of the reference's dryrun over the
    first ``n_devices`` of ``devices`` (every visible card by default)
    through ``simulate_sharded_chunked``: the flagship scene on 16^3 with
    8 photons a shard on 64 lanes, with fluence; then the same with one
    circle detector, the pMC inverse statistics (``inverse_prim=1``) and
    no fluence.  Raises when fewer than ``n_devices`` devices are given,
    or when a run launches another count than 8 photons a shard, deposits
    no fluence, or returns ``pmc_stats`` not of shape (1, 6) or a negative
    detector total."""
    mesh = make_mesh(devices)
    if len(mesh) < n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(mesh)}")
    mesh = mesh[:n_devices]
    dev = mesh[0]
    scene, source, grid = _flagship(grid_n=16, device=dev)
    n = 8 * n_devices
    cfg = TransportConfig(nphotons=n, n_lanes=64, max_steps=20000)
    tallies, _, launched, _ = simulate_sharded_chunked(
        scene, source, grid, 1, cfg, mesh=mesh, chunk_steps=256)
    _check("launched", int(launched) == n, int(launched))
    jsum = float(tallies.jmean.sum())
    _check("fluence sum", jsum > 0.0, jsum)

    # the detector bank and the pMC inverse statistics sharded over the
    # same devices: fluenceless, bins and pmc_stats summed over the shards
    def f(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    circ = CircleDetectors(pos=f([[0.0, 0.0, 0.5]]), dir=f([[0.0, 0.0, 1.0]]),
                           radius=f([1.0]), bin_wid=f([0.1]),
                           data=torch.zeros((1, 11), device=dev), nbins=10)
    bank_in = DetectorBank(circle=circ, annulus=None, fibre=None,
                           camera=None, target_values=f([-1.0]),
                           order=(("circle", 0),), ids=("c",), layers=(1,))
    cfg2 = TransportConfig(nphotons=n, n_lanes=64, max_steps=20000,
                           inverse_prim=1, record_fluence=False)
    t2, bank_out, launched2, _ = simulate_sharded_chunked(
        scene, source, grid, 2, cfg2, bank=bank_in, mesh=mesh,
        chunk_steps=256)
    _check("launched (detector bank)", int(launched2) == n, int(launched2))
    _check("pmc_stats shape", tuple(t2.pmc_stats.shape) == (1, 6),
           tuple(t2.pmc_stats.shape))
    total = float(totals(bank_out)[0])
    _check("detector total", total >= 0.0, total)
