"""The port's inverse kernel and perturbation-MC scores
(``rsmcrt_tpu_torch/inverse.py``, ``TransportConfig.inverse_prim``)
against the JAX reference and closed forms.

- Pure functions on numpy-seeded inputs: ``hg_logpdf_dg`` to float32
  rounding; ``_set_prim_optics`` / ``_set_prim_shape`` /
  ``_prim_location`` / ``_prim_group_slot`` and ``inverse_evaluate``
  against the reference's (tests/test_inverse.py's two tier-1 tests,
  mirrored).
- ``inverse_MCRT`` (both methods) and ``inverse_gradient_descent`` on a
  cut copy of res/inverse_test.toml.
- tests/test_inverse.py's seven statistical recoveries, on the port,
  under ``-m slow`` as the reference marks them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import rsmcrt_tpu.inverse as jinv
from rsmcrt_tpu.kernels import setup as jsetup
from rsmcrt_tpu.transport import scatter as jscat
from rsmcrt_tpu_torch import inverse as tinv
from rsmcrt_tpu_torch.kernels import setup as tsetup
from rsmcrt_tpu_torch.transport import scatter as tscat

torch.set_num_threads(1)

CONFIG = "res/inverse_test.toml"


def test_hg_logpdf_dg_matches_reference():
    rng = np.random.default_rng(0)
    cost = rng.uniform(-1.0, 1.0, 4000).astype(np.float32)
    g = rng.uniform(-0.99, 0.99, 4000).astype(np.float32)
    g[:4] = [0.0, 0.999, -0.999, 1.0]
    cost[:4] = [1.0, 1.0, -1.0, 1.0]
    want = np.asarray(jscat.hg_logpdf_dg(jnp.asarray(cost), jnp.asarray(g)))
    got = tscat.hg_logpdf_dg(torch.as_tensor(cost), torch.as_tensor(g))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=1e-5)


def test_set_prim_shape_roundtrip():
    """tests/test_inverse.py, on the port, with the reference's slot and
    optics edits beside it."""
    parsed, scene = tsetup(CONFIG, kernel="inverse", device="cpu")
    jparsed, jscene = jsetup(CONFIG, kernel="inverse")
    pi = tinv._prim_location(scene, parsed.settings.inverse["layer"])
    assert pi == jinv._prim_location(jscene, 1) == 0
    g, m = tinv._prim_group_slot(scene, 0)
    assert (g, m) == jinv._prim_group_slot(jscene, 0)
    sc2 = tinv._set_prim_shape(scene, 0, "radius", 0.5)
    assert float(sc2.group_params[g]["radius"][m]) == 0.5
    assert np.isclose(float(scene.group_params[g]["radius"][m]), 0.8)
    with pytest.raises(KeyError):
        tinv._set_prim_shape(scene, 0, "bogus", 1.0)
    with pytest.raises(ValueError, match="layer not found"):
        tinv._prim_location(scene, 9)
    got = tinv._set_prim_optics(scene, 0, 4.0, 0.25, 0.3, 1.2).tables
    want = jinv._set_prim_optics(jscene, 0, 4.0, 0.25, 0.3, 1.2).tables
    for f in ("mus", "mua", "hgg", "n", "kappa", "albedo"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert float(scene.tables.mus[1]) == 5.0  # the original untouched


def test_inverse_evaluate_matches_reference_definition():
    """tests/test_inverse.py: error = -(1/M) Sum |total/N - target| over
    detectors with a target (kernelsMod.f90:1766-1786)."""
    totals_ = np.array([100.0, 250.0, 30.0])
    targets = np.array([0.2, -1.0, 0.05])
    err = tinv.inverse_evaluate(totals_, 1000, targets)
    assert np.isclose(err, -0.5 * (abs(0.1 - 0.2) + abs(0.03 - 0.05)))
    assert err == jinv.inverse_evaluate(totals_, 1000, targets)
    assert tinv.inverse_evaluate(totals_, 1000, -np.ones(3)) == 0.0


# --- tests/test_inverse.py's statistical recoveries, on the port ----------

def _grads(**kw):
    return tinv.detector_gradients(CONFIG, n_lanes=4096, seed=3,
                                   device="cpu", **kw)


def _run(res, mus=5.0, mua=0.5, g=0.5, seed=3):
    sc = tinv._set_prim_optics(res["scene"], res["prim_index"], mus, mua, g,
                               1.0)
    tot, _, n = tinv._forward(res["parsed"], sc, res["cfg"], seed,
                              inverse_prim=res["prim_index"] + 1)
    return float(tot[0]), n


@pytest.mark.slow
def test_pmc_gradient_mua_matches_fd():
    res = _grads(nphotons=30000)
    fd = np.mean([(_run(res, mua=0.5 + h)[0] - _run(res, mua=0.5 - h)[0])
                  / (2 * h) for h in (0.02, 0.05)])
    pmc = float(res["dT_dmua"][0])
    assert fd != 0.0 and np.sign(pmc) == np.sign(fd)
    assert abs(pmc - fd) / abs(fd) < 0.20, (pmc, fd)


@pytest.mark.slow
def test_pmc_gradient_signs_and_magnitudes():
    res = _grads(nphotons=30000)
    sec_g = np.mean([(_run(res, g=0.6, seed=s)[0]
                      - _run(res, g=0.4, seed=s)[0]) / 0.2
                     for s in (101, 202)])
    pmc_g = float(res["dT_dg"][0])
    assert pmc_g > 0 and sec_g > 0
    assert 0.4 < pmc_g / sec_g < 2.5, (pmc_g, sec_g)


@pytest.mark.slow
def test_pmc_gradient_mua_tight_vs_seed_averaged_fd():
    res = tinv.detector_gradients(CONFIG, nphotons=40000, n_lanes=8192,
                                  seed=3, device="cpu")
    h = 0.05

    def per(mua, s):
        tot, n = _run(res, mua=mua, seed=s)
        return tot / n

    fd = np.mean([(per(0.5 + h, s) - per(0.5 - h, s)) / (2 * h)
                  for s in (3, 17, 29, 41)])
    pmc = float(res["dT_dmua"][0]) / res["launched"]
    assert abs(pmc - fd) / abs(fd) < 0.12, (pmc, fd)


@pytest.mark.slow
def test_n_gradient_sign_and_consistency():
    r1 = tinv.detector_gradients(CONFIG, nphotons=100000, n_lanes=8192,
                                 seed=3, want_n=True, h_n=0.1,
                                 n_method="fd", device="cpu")
    r2 = tinv.detector_gradients(CONFIG, nphotons=100000, n_lanes=8192,
                                 seed=17, want_n=True, h_n=0.12,
                                 n_method="fd", device="cpu")
    assert float(r1["dT_dn"][0]) < 0 and float(r2["dT_dn"][0]) < 0


@pytest.mark.slow
def test_radius_gradient_sign():
    res = tinv.detector_gradients(CONFIG, nphotons=40000, n_lanes=8192,
                                  seed=3, shape_param="radius", h_shape=0.05,
                                  device="cpu")
    assert float(res["dT_dradius"][0]) < 0


@pytest.mark.slow
def test_joint_recovery_reaches_noise_floor():
    theta, hist = tinv.inverse_gradient_descent(
        "res/inverse_test4.toml", nsteps=6, nphotons=10000, n_lanes=4096,
        lr=0.15, seed=11, verbose=False, device="cpu")
    assert hist[0]["error"] < -0.008
    assert max(h["error"] for h in hist) > -0.004, [h["error"] for h in hist]


@pytest.mark.slow
def test_radius_recovery_converges():
    theta, hist = tinv.inverse_gradient_descent(
        "res/inverse_radius.toml", nsteps=8, nphotons=10000, n_lanes=4096,
        lr=0.08, seed=11, find=[], shape_params=["radius"], verbose=False,
        device="cpu")
    assert abs(theta["radius"] - 0.8) < 0.06, theta
    assert max(h["error"] for h in hist) > hist[0]["error"] + 0.002


@pytest.mark.slow
def test_recovery_uses_scores_with_zero_fd_forwards(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("CRN-FD forward run in score mode")

    monkeypatch.setattr(tinv, "_crn_fd_totals", boom)
    theta, hist = tinv.inverse_gradient_descent(
        "res/inverse_test4.toml", nsteps=3, nphotons=8000, n_lanes=4096,
        lr=0.15, seed=11, verbose=False, device="cpu")
    assert any(h["grads"].get("n") for h in hist)
    theta, hist = tinv.inverse_gradient_descent(
        "res/inverse_radius.toml", nsteps=3, nphotons=8000, n_lanes=4096,
        lr=0.08, seed=11, find=[], shape_params=["radius"], verbose=False,
        device="cpu")
    assert any(h["grads"].get("radius") for h in hist)


def test_inverse_entry_points_run(tmp_path):
    """``inverse_MCRT`` (random search) and ``inverse_gradient_descent``
    on res/inverse_test.toml cut to one step of 2,048 photons on 2,048
    lanes."""
    toml = tmp_path / "inv.toml"
    toml.write_text(open(CONFIG).read().replace("nphotons = 30000",
                                                "nphotons = 2048")
                    .replace("maxNumSteps = 20", "maxNumSteps = 1"))
    best, hist = tinv.inverse_MCRT(toml, data_dir=tmp_path / "d",
                                   method="random", verbose=False,
                                   n_lanes=2048, device="cpu")
    assert len(hist) == 1 and best["error"] <= 0.0
    lines = (tmp_path / "d" / "inverse_results.dat").read_text().splitlines()
    assert len(lines) == 2
    theta, hist = tinv.inverse_gradient_descent(
        toml, nsteps=1, n_lanes=2048, verbose=False, device="cpu")
    assert len(hist) == 1 and set(hist[0]["grads"]) == {"mus", "mua"}
    assert theta["mus"] == 5.0 and theta["mua"] == 0.5  # the best: step 0
