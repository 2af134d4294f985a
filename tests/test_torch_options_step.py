"""One megastep of the port's transport options against the JAX reference,
lane by lane, with the protocol and gates of test_torch_plain_step.py
(four chain rounds a megastep, to keep the reference's compile short):
survival bias on the chained walk (with the quasi-random source block,
which turns in-chain respawn off) and on the plain walk, and a spectral
sphere on the chained walk (per-photon optical properties interpolated
between wavelength rows).

Survival bias: the sphere's albedo is cut to 0.5 so that weights fall
below the roulette threshold (0.01) within the compared megastep; weights
agree to rtol 1e-4 like every float field.
"""

import numpy as np
import torch

import jax.numpy as jnp

from rsmcrt_tpu.grid import cart_grid
from rsmcrt_tpu.optics.piecewise import piecewise1d
from rsmcrt_tpu.optics.properties import SpectralOptProps, mono
from rsmcrt_tpu.sdfs import scene as S
from rsmcrt_tpu.sources.sources import build_source
from rsmcrt_tpu.transport import engine as je
from test_torch_plain_step import B, check_lanes, run_case

torch.set_num_threads(1)


def _lossy_sphere():
    return S.build_scene([S.sphere(1.0, mono(5.0, 5.0, 0.5, 1.38), 1),
                          S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0),
                                2)])


def _survival_gates(before, want, got):
    ws = want.state
    # weights fell to the roulette threshold
    assert (ws.alive & (ws.weight < 0.02)).any()
    np.testing.assert_allclose(got["tallies"]["absorb"], want.tallies.absorb,
                               rtol=1e-4, atol=1e-5)


def test_chained_survival_bias_with_qmc_source_matches_reference():
    """Survival bias chains: every round deposits w (1 - albedo) and plays
    roulette; the Halton source block (the reference's shifts handed in)
    is keyed by the global photon index."""
    scene = _lossy_sphere()
    grid = cart_grid(16, 16, 16, 1.0, 1.0, 1.0)
    src = build_source("point", position=[0.0, 0.0, 0.0])
    cfg = je.TransportConfig(nphotons=3000, n_lanes=B, dda_substeps=4,
                             chain_scatter=True, record_emission=True,
                             survival_bias=True, qmc_source=True)
    before, want, _, got = run_case(scene, grid, src, cfg, seed=29, warm=5)
    assert 0.2 < want.state.alive.mean()
    assert int(want.launched) > int(before.launched)  # lanes respawned
    check_lanes(got, want, before)
    _survival_gates(before, want, got)


def test_plain_survival_bias_matches_reference():
    scene = _lossy_sphere()
    grid = cart_grid(16, 16, 16, 1.0, 1.0, 1.0)
    src = build_source("point", position=[0.0, 0.0, 0.0])
    cfg = je.TransportConfig(nphotons=3000, n_lanes=B, dda_substeps=8,
                             record_emission=True, survival_bias=True)
    before, want, _, got = run_case(scene, grid, src, cfg, seed=31, warm=8)
    check_lanes(got, want, before)
    _survival_gates(before, want, got)


def _spectral_sphere():
    wl = np.array([400.0, 550.0, 700.0])

    def tab(*ys):
        return piecewise1d(np.stack([wl, ys], axis=1))

    opt = SpectralOptProps(mus_tab=tab(5.0, 12.0, 10.0),
                           mua_tab=tab(0.1, 0.3, 0.2),
                           hgg_tab=tab(0.5, 0.7, 0.9),
                           n_tab=tab(1.3, 1.4, 1.5), flux=tab(1.0, 1.0, 1.0))
    scene = S.build_scene([S.sphere(1.0, opt, 1),
                           S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0),
                                 2)])
    src = build_source("point", position=[0.0, 0.0, 0.0],
                       spectrum=piecewise1d(np.stack(
                           [wl, [1.0, 2.0, 1.0]], axis=1)))
    return scene, src


def test_spectral_chained_megastep_matches_reference():
    scene, src = _spectral_sphere()
    grid = cart_grid(16, 16, 16, 1.0, 1.0, 1.0)
    cfg = je.TransportConfig(nphotons=2000, n_lanes=B, dda_substeps=4,
                             chain_scatter=True, record_emission=True)
    before, want, _, got = run_case(scene, grid, src, cfg, seed=37, warm=2)
    assert 0.2 < want.state.alive.mean()
    wl = want.state.wavelength[want.state.alive]
    assert wl.min() < 450.0 and wl.max() > 650.0  # the band is sampled
    check_lanes(got, want, before)
    np.testing.assert_allclose(got["tallies"]["jmean"], want.tallies.jmean,
                               rtol=1e-4, atol=1e-5)
    assert jnp.ndim(scene.tables.mus) == 2
