"""The port's transport against the independent native C++ engine
(``native/mcrt.cpp`` through the port's own binding,
``rsmcrt_tpu_torch.native``, built into ``build/native/``): the three
cross-checks of tests/test_native_crossval.py -- the sphere, the egg with
an onion shell and the Fresnel sphere -- at that file's scenes, photon
counts, grids and tolerances (``-m slow``), and the sphere cut from
20,000 photons to 5,000 in tier-1 with each tolerance scaled by
sqrt(20000 / 5000) = 2: nscatt/photon within 2.0, path per photon within
4%, every radial profile bin within 20%."""

import numpy as np
import pytest
import torch

from rsmcrt_tpu import native as jnative
from rsmcrt_tpu_torch import native
from rsmcrt_tpu_torch.grid import cart_grid
from rsmcrt_tpu_torch.optics.properties import mono
from rsmcrt_tpu_torch.sdfs import scene as S
from rsmcrt_tpu_torch.sources.sources import build_source
from rsmcrt_tpu_torch.tally import as_volume
from rsmcrt_tpu_torch.transport.engine import TransportConfig, simulate

torch.set_num_threads(1)


def _port_run(prims, grid_n, pos, n, seed):
    scene = S.build_scene(prims)
    grid = cart_grid(grid_n, grid_n, grid_n, 1.0, 1.0, 1.0)
    src = build_source("point", position=pos)
    gen = torch.Generator()
    gen.manual_seed(seed)
    tl, _, launched, _ = simulate(scene, src, grid, gen,
                                  TransportConfig(nphotons=n, n_lanes=4096))
    assert int(launched) == n
    return (as_volume(grid, tl.jmean).double().numpy(),
            float(tl.nscatt) / n)


def _radial(j, grid_n):
    centre = (np.arange(grid_n) + 0.5) / grid_n * 2.0 - 1.0
    xx, yy, zz = np.meshgrid(centre, centre, centre, indexing="ij")
    r = np.sqrt(xx**2 + yy**2 + zz**2)
    bins = np.linspace(0, 1.0, 11)
    return np.array([j[(r >= a) & (r < b)].mean()
                     for a, b in zip(bins, bins[1:])])


def _sphere_case(n, tol):
    """tests/test_native_crossval.py::test_fluence_crossval_sphere with its
    three tolerances scaled by ``tol``."""
    grid_n = 32
    prims_n = [
        native.sphere([0, 0, 0], 1.0, 10.0, 0.1, 0.5, 1.0),
        native.box([0, 0, 0], [2.0, 2.0, 2.0], 0.0, 0.0, 0.0, 1.0),
    ]
    j_native, nscatt_native = native.run_native(
        prims_n, [grid_n] * 3, [1.0] * 3, 0, [0, 0, 0], None, n, seed=5)
    j_port, ns_p = _port_run([
        S.sphere(1.0, mono(10.0, 0.1, 0.5, 1.0), 1),
        S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0), 2),
    ], grid_n, [0.0, 0.0, 0.0], n, 5)
    ns_n = nscatt_native / n
    assert abs(ns_p - ns_n) < 1.0 * tol, (ns_p, ns_n)
    tp, tn = j_port.sum() / n, j_native.sum() / n
    assert abs(tp - tn) / tn < 0.02 * tol, (tp, tn)
    prof_p, prof_n = _radial(j_port, grid_n), _radial(j_native, grid_n)
    rel = np.abs(prof_p - prof_n) / np.maximum(prof_n, 1e-9)
    assert np.all(rel < 0.1 * tol), rel


def test_binding_builds_outside_native_and_matches_reference():
    """The port's binding builds ``native/mcrt.cpp`` under ``build/`` on
    one thread, so a seed repeats its run exactly, and its runs agree with
    the reference binding's (the same engine; the two builds and thread
    schedules differ, so statistically) at 20,000 photons: nscatt/photon
    within 0.5, path within 1%."""
    lib = native.library_path()
    assert lib.parts[-4:-2] == ("build", "native")
    prims = [native.sphere([0, 0, 0], 1.0, 10.0, 0.1, 0.5, 1.0),
             native.box([0, 0, 0], [2.0, 2.0, 2.0], 0.0, 0.0, 0.0, 1.0)]
    assert prims == [jnative.sphere([0, 0, 0], 1.0, 10.0, 0.1, 0.5, 1.0),
                     jnative.box([0, 0, 0], [2.0, 2.0, 2.0], 0.0, 0.0,
                                 0.0, 1.0)]
    assert native.egg_shell([0, 0, 0], 0.75, 0.3, 0.45, 0.06, 1, 1, 0,
                            1.45) == jnative.egg_shell(
        [0, 0, 0], 0.75, 0.3, 0.45, 0.06, 1, 1, 0, 1.45)
    n = 20000
    jp, nsp = native.run_native(prims, [16] * 3, [1.0] * 3, 0, [0, 0, 0],
                                None, n, seed=5)
    assert native.available() and lib.exists()
    again = native.run_native(prims, [16] * 3, [1.0] * 3, 0, [0, 0, 0],
                              None, n, seed=5)
    assert again[1] == nsp and np.array_equal(again[0], jp)
    jr, nsr = jnative.run_native(prims, [16] * 3, [1.0] * 3, 0, [0, 0, 0],
                                 None, n, seed=5)
    assert jp.shape == (16, 16, 16) and jp.dtype == np.float32
    assert abs(nsp - nsr) / n < 0.5
    assert abs(jp.sum() - jr.sum()) / jr.sum() < 0.01
    with pytest.raises(ValueError):
        native.run_native([[0.0] * 5], [16] * 3, [1.0] * 3, 0, [0, 0, 0],
                          None, 10)


def test_fluence_crossval_sphere_cut():
    _sphere_case(5000, 2.0)


@pytest.mark.slow
def test_fluence_crossval_sphere():
    _sphere_case(20000, 1.0)


@pytest.mark.slow
def test_fluence_crossval_egg_with_shell():
    n = 15000
    grid_n = 24
    egg_args = (0.6, 0.25, 0.35)  # r1, r2, h
    prims_n = [
        native.egg([0, 0, 0], *egg_args, 8.0, 0.2, 0.6, 1.33),
        native.egg_shell([0, 0, 0], 0.75, 0.3, 0.45, 0.06,
                         1.0, 1.0, 0.0, 1.45),
        native.box([0, 0, 0], [2.0, 2.0, 2.0], 0.0, 0.0, 0.0, 1.0),
    ]
    j_native, nscatt_native = native.run_native(
        prims_n, [grid_n] * 3, [1.0] * 3, 0, [0, -0.1, 0], None, n,
        seed=13)
    j_port, ns_p = _port_run([
        S.egg(*egg_args, mono(8.0, 0.2, 0.6, 1.33), 1),
        S.onion(S.egg(0.75, 0.3, 0.45, mono(1.0, 1.0, 0.0, 1.45), 2),
                0.06),
        S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0), 3),
    ], grid_n, [0.0, -0.1, 0.0], n, 13)
    ns_n = nscatt_native / n
    assert abs(ns_p - ns_n) / max(ns_n, 1e-9) < 0.05, (ns_p, ns_n)
    tp, tn = j_port.sum() / n, j_native.sum() / n
    assert abs(tp - tn) / tn < 0.03, (tp, tn)
    # axial (y) fluence profile: the egg is y-asymmetric
    prof_p = j_port.sum(axis=(0, 2))
    prof_n = j_native.sum(axis=(0, 2))
    denom = max(prof_n.sum(), 1e-9)
    assert np.abs(prof_p / prof_p.sum() - prof_n / denom).sum() < 0.08


@pytest.mark.slow
def test_fluence_crossval_fresnel_sphere():
    n = 15000
    grid_n = 24
    prims_n = [
        native.sphere([0, 0, 0], 1.0, 10.0, 0.1, 0.9, 1.38),
        native.box([0, 0, 0], [2.0, 2.0, 2.0], 0.0, 0.0, 0.0, 1.0),
    ]
    j_native, nscatt_native = native.run_native(
        prims_n, [grid_n] * 3, [1.0] * 3, 0, [0, 0, 0], None, n, seed=9)
    j_port, ns_p = _port_run([
        S.sphere(1.0, mono(10.0, 0.1, 0.9, 1.38), 1),
        S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0), 2),
    ], grid_n, [0.0, 0.0, 0.0], n, 9)
    ns_n = nscatt_native / n
    # TIR trapping raises scatter counts well above the index-matched case
    assert abs(ns_p - ns_n) / ns_n < 0.05, (ns_p, ns_n)
    tp, tn = j_port.sum() / n, j_native.sum() / n
    assert abs(tp - tn) / tn < 0.03, (tp, tn)
