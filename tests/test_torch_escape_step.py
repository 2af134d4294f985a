"""One escape-function megastep of the port against the JAX reference,
lane by lane, on both walks (the protocol and gates of
tests/test_torch_plain_step.py: a JAX carry run a few megasteps, carried
across with ``interop``, then one ``transport_step`` in each package on
the uniforms ``jax.random`` draws for it).

The scene is res/escape_test.toml's tau = 2 scat_test sphere with a bank
of two circle detectors; the source is ``escape_points`` at 12 voxel
centres with 150 photons each, so the lanes of one megastep carry many
source voxels.  Beyond the lane gates: ``sid`` equal on every lane whose
integer fields agree, and ``escape_tot`` cell by cell at rtol 1e-4 (its
sum at rel 1e-4 among the tallies).  The chained walk has no in-chain
respawn in escape mode, as in the reference."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsmcrt_tpu.detectors.detectors import CircleDetectors, DetectorBank
from rsmcrt_tpu.grid import cart_grid
from rsmcrt_tpu.optics.properties import mono
from rsmcrt_tpu.sdfs import scene as S
from rsmcrt_tpu.sources.sources import Source
from rsmcrt_tpu.transport import engine as je
from rsmcrt_tpu_torch.transport import engine as te
from test_torch_plain_step import B, check_lanes, run_case

torch.set_num_threads(1)

M, PER_VOXEL = 12, 150


def two_circles():
    """A disc above facing +z and a wider one below facing -z."""
    f = lambda v: jnp.asarray(v, jnp.float32)  # noqa: E731
    return DetectorBank(
        circle=CircleDetectors(
            pos=f([[0.0, 0.0, 0.95], [0.0, 0.0, -0.9]]),
            dir=f([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]]),
            radius=f([0.5, 0.8]), bin_wid=f([0.5 / 16, 0.8 / 16]),
            data=jnp.zeros((2, 17), jnp.float32), nbins=16),
        annulus=None, fibre=None, camera=None,
        target_values=jnp.full((2,), -1.0), order=(("circle", 0),
                                                   ("circle", 1)),
        ids=("above", "below"), layers=(2, 2))


def escape_case(chain, seed, warm):
    scene = S.build_scene([S.sphere(1.0, mono(2.0, 0.0, 0.0, 1.0), 1),
                           S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0),
                                 2)])
    grid = cart_grid(32, 32, 32, 1.0, 1.0, 1.0)
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.55, 0.55, (M, 3)).astype(np.float32)
    src = Source(kind="escape_points", params={"positions": jnp.asarray(pts)})
    cfg = je.TransportConfig(nphotons=M * PER_VOXEL, n_lanes=B,
                             escape_shape=(M, 2), record_fluence=False,
                             chain_scatter=chain, dda_substeps=2)
    before, want, _, got = run_case(scene, grid, src, cfg, seed=seed,
                                    warm=warm, bank=two_circles())
    tcfg = te.TransportConfig(nphotons=1, escape_shape=(M, 2),
                              chain_scatter=chain)
    assert not tcfg.respawns_in_chain(scene) or not chain
    agree = check_lanes(got, want, before,
                        tallies=("absorb", "emission", "escape_tot"))
    # lanes respawned this megastep, and live lanes on several voxels
    assert int(want.launched) > int(before.launched)
    assert len(np.unique(want.state.sid[want.state.alive])) >= 3
    np.testing.assert_array_equal(got["state"]["sid"][agree],
                                  want.state.sid[agree])
    et = want.tallies.escape_tot
    assert et.shape == (M, 2) and (et > 0).sum() >= 4
    np.testing.assert_allclose(got["tallies"]["escape_tot"], et, rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("chain", [True, False], ids=["chained", "plain"])
def test_escape_megastep_matches_reference(chain):
    """The analysis phase's sid-keyed attribution on both walks; on the
    chained walk also the per-lane hit accumulator and its flush."""
    escape_case(chain, seed=5, warm=3 if chain else 8)
