"""One perturbation-MC megastep of the port against the JAX reference,
lane by lane, on both walks (the protocol and gates of
tests/test_torch_plain_step.py).

Scene: res/inverse_test.toml's sphere (mus 5, mua 0.5, g 0.5, radius
0.8) with n = 1.38, so photons reflect and refract at its surface, in a
vacuum box, a point source and two circle detectors; ``inverse_prim = 1``.
Beyond the lane gates, the six ``pmc_*`` lane fields (``pmc_dd``, the
direction tangent carried by ``torch.func.jvp``, included) are held at
the float gates -- rtol / atol 1e-4, or 2e-3 on lanes with a surface
event in the step -- on every lane whose integer fields agree, and
``pmc_stats`` at rel 1e-4 of each row's scale.  The Fresnel-choice and
boundary-extinction scores must have changed on some lanes in the step.
"""

import numpy as np
import pytest
import torch

from rsmcrt_tpu.grid import cart_grid
from rsmcrt_tpu.optics.properties import mono
from rsmcrt_tpu.sdfs import scene as S
from rsmcrt_tpu.sources.sources import build_source
from rsmcrt_tpu.transport import engine as je
from test_torch_escape_step import two_circles
from test_torch_plain_step import check_lanes, run_case

torch.set_num_threads(1)

PMC = ("pmc_cnt", "pmc_len", "pmc_hg", "pmc_fn", "pmc_bn", "pmc_dd")


@pytest.mark.parametrize("chain", [True, False], ids=["chained", "plain"])
def test_pmc_megastep_matches_reference(chain):
    scene = S.build_scene([S.sphere(0.8, mono(5.0, 0.5, 0.5, 1.38), 1),
                           S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0),
                                 2)])
    grid = cart_grid(16, 16, 16, 1.0, 1.0, 1.0)
    src = build_source("point", position=[0.0, 0.0, 0.0])
    cfg = je.TransportConfig(nphotons=3000, n_lanes=256, inverse_prim=1,
                             record_fluence=False, chain_scatter=chain,
                             dda_substeps=2)
    before, want, _, got = run_case(scene, grid, src, cfg, seed=17,
                                    warm=4 if chain else 10,
                                    bank=two_circles())
    agree = check_lanes(got, want, before, tallies=("absorb", "emission"))
    b, ws, gs = before.state, want.state, got["state"]
    surf = agree & ((ws.layer != b.layer) | (ws.bounces != b.bounces))
    for f in PMC:
        a, w = gs[f], getattr(ws, f)
        np.testing.assert_allclose(a[agree & ~surf], w[agree & ~surf],
                                   rtol=1e-4, atol=1e-4, err_msg=f)
        np.testing.assert_allclose(a[surf], w[surf], rtol=2e-3, atol=2e-3,
                                   err_msg=f)
    # the surface scores fired in this megastep
    for f in ("pmc_fn", "pmc_bn"):
        assert (getattr(ws, f) != getattr(b, f)).sum() >= 3, f
    assert (np.abs(ws.pmc_dd).sum(axis=-1) > 0).sum() >= 3
    wst = want.tallies.pmc_stats
    assert wst.shape == (2, 6) and wst[:, 0].sum() > 0
    scale = np.abs(wst).max(axis=0, keepdims=True) + 1e-6
    np.testing.assert_allclose(got["tallies"]["pmc_stats"] / scale,
                               wst / scale, rtol=0, atol=1e-4)
