"""tests/test_gradient_scores.py on the port: the perturbation-MC n and
shape scores of ``TransportConfig.inverse_prim`` in whole CPU runs.

- The Fresnel-choice score, with the angular term the propagated
  direction tangent (``pmc_dd``, ``torch.func.jvp``) carries, against the
  closed-form vacuum-slab dT/dn (the float64 derivative of T = (1 - R) /
  (1 + R) with the reference's ``fresnel_coeff``, evaluated in JAX at n
  +- 1e-4) at 2 and 40 degrees on both walks, at 20,000 photons (the
  reference's 60,000) with the reference's tolerance formula, 5 *
  sqrt(25 / N): 0.177 here against its 0.102.  The plain walk at 2
  degrees also runs at the reference's 60,000 photons, at its limit.
- The boundary-extinction score against a common-random-number central
  difference (two runs of one seeded generator) on the matched-index
  sphere with a mua contrast, at 20,000 photons (the reference's
  60,000), at the reference's tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rsmcrt_tpu.transport.fresnel import fresnel_coeff as jfresnel
from rsmcrt_tpu_torch.detectors.detectors import (CircleDetectors,
                                                  DetectorBank, totals)
from rsmcrt_tpu_torch.grid import cart_grid
from rsmcrt_tpu_torch.optics.properties import mono
from rsmcrt_tpu_torch.sdfs import scene as S
from rsmcrt_tpu_torch.sources.sources import build_source
from rsmcrt_tpu_torch.transport.engine import TransportConfig, simulate

torch.set_num_threads(1)


def _bank(z, radius=2.8):
    f = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    return DetectorBank(
        circle=CircleDetectors(pos=f([[0.0, 0.0, z]]),
                               dir=f([[0.0, 0.0, 1.0]]), radius=f([radius]),
                               bin_wid=f([radius / 4]),
                               data=torch.zeros((1, 5)), nbins=4),
        annulus=None, fibre=None, camera=None, target_values=f([-1.0]),
        order=(("circle", 0),), ids=("t",), layers=(2,))


@pytest.mark.parametrize("chain,theta_deg", [(False, 2.0), (True, 2.0),
                                             (False, 40.0), (True, 40.0)])
def test_fresnel_choice_score_matches_analytic_slab(chain, theta_deg):
    """A vacuum slab (n 1.5) transmits T = (1 - R) / (1 + R); the pMC
    n-score, with the angular term the direction tangent carries, matches
    the closed form's derivative at normal and oblique incidence."""
    _fresnel_slab(chain, theta_deg, 20_000)


def test_fresnel_choice_score_at_reference_size():
    """The plain walk at 2 degrees at the reference's 60,000 photons, so
    at the reference's limit."""
    _fresnel_slab(False, 2.0, 60_000)


def _fresnel_slab(chain, theta_deg, n):
    n_slab = 1.5
    theta = np.deg2rad(theta_deg)
    d = np.array([np.sin(theta), 0.0, np.cos(theta)], np.float32)

    def T_of_n(nv):
        with jax.enable_x64():
            R = float(jfresnel(jnp.asarray(d, jnp.float64)[None],
                               jnp.asarray([[0.0, 0.0, 1.0]], jnp.float64),
                               jnp.asarray([1.0], jnp.float64),
                               jnp.asarray([nv], jnp.float64))[0])
        return (1.0 - R) / (1.0 + R)

    # the derivative of the smooth closed form, central difference in f64
    dT_exact = (T_of_n(n_slab + 1e-4) - T_of_n(n_slab - 1e-4)) / 2e-4
    T_exact = T_of_n(n_slab)
    scene = S.build_scene([
        S.box([5.8, 5.8, 0.2], mono(0.0, 0.0, 0.0, n_slab), 1),
        S.box([6.0, 6.0, 4.0], mono(0.0, 0.0, 0.0, 1.0), 2)])
    grid = cart_grid(16, 16, 16, 3.0, 3.0, 2.0)
    src = build_source("pencil", position=[0.0, 0.0, -1.2],
                       direction=d.tolist())
    cfg = TransportConfig(nphotons=n, n_lanes=4096, inverse_prim=1,
                          record_fluence=False, chain_scatter=chain)
    t, _, launched, _ = simulate(scene, src, grid,
                                 torch.Generator().manual_seed(2), cfg,
                                 bank=_bank(1.0))
    N = int(launched)
    stats = t.pmc_stats.numpy()[0]
    assert stats[0] / N == pytest.approx(
        T_exact, abs=4.0 * np.sqrt(T_exact * (1 - T_exact) / N) + 1e-3)
    sem = np.sqrt(25.0 / N)  # the reference's crude score-variance bound
    assert stats[4] / N == pytest.approx(
        dT_exact, abs=max(5 * sem, 0.02 * abs(dT_exact)))


def test_boundary_extinction_score_matches_crn_fd():
    """A matched-index, mus-continuous sphere with a mua contrast: the
    extinction score is the exact dT/dR; against a central difference of
    two runs of one seeded generator."""
    mus, g = 5.0, 0.3

    def build(r):
        return S.build_scene([S.sphere(r, mono(mus, 1.0, g, 1.0), 1),
                              S.box([2.0, 2.0, 2.0],
                                    mono(mus, 0.05, g, 1.0), 2)])

    grid = cart_grid(16, 16, 16, 1.0, 1.0, 1.0)
    src = build_source("point", position=[0.0, 0.0, 0.0])
    n, r0, h = 20_000, 0.7, 0.03

    def run(scene, inverse=0):
        cfg = TransportConfig(nphotons=n, n_lanes=4096, inverse_prim=inverse,
                              record_fluence=False)
        t, b, launched, _ = simulate(scene, src, grid,
                                     torch.Generator().manual_seed(7), cfg,
                                     bank=_bank(0.9, radius=1.0))
        return (t.pmc_stats.numpy() if inverse else None,
                float(totals(b)[0]), int(launched))

    stats, _, N = run(build(r0), inverse=1)
    dT_score = stats[0][5] / N
    _, T_hi, N_hi = run(build(r0 + h))
    _, T_lo, N_lo = run(build(r0 - h))
    dT_fd = (T_hi / N_hi - T_lo / N_lo) / (2 * h)
    assert dT_score != 0.0
    assert np.sign(dT_score) == np.sign(dT_fd), (dT_score, dT_fd)
    assert dT_score == pytest.approx(dT_fd, rel=0.35,
                                     abs=0.05 * abs(dT_fd) + 0.02)
