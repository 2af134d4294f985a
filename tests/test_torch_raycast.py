"""Analytic raycasts, the analytic-column mask, the ray bounds and the
surface normals of the PyTorch port against the JAX reference.

The scenes are those of ``test_torch_sdfs.py``: per spec kind, two members
of one structure plus a bounding box, and every registry scene, each built
by the port's constructors and converted from the reference's.  Rays are
4096 seeded points with seeded unit directions.

Tolerances:

- crossing parameters ``t`` of the closed-form kinds: rtol 1e-5, atol 1e-5
  (float32 rounding of the two libraries, divided by a direction
  component);
- the torus and the revolved egg take float32 quartic roots that carry
  O(1e-2) error before two Newton polishes on the true SDF, and the
  on-surface test ``|sd| < tol`` can flip at its threshold between the
  libraries: at least 99.9% of the rays must agree on whether they cross
  and on the prim they cross, and the crossings both find agree to rtol
  1e-4, atol 1e-4;
- integer fields (the crossed prim) are equal on at least 99.9% of the
  rays, the lanes where finiteness flips included;
- normals: rtol 1e-4, atol 1e-5.  The SDFs take JAX's autograd slopes at
  their kinks (``abs`` at 0, a clip at its bound), so exact ties agree; a
  lane whose two libraries' distances differ in the last bit can still
  take the other branch of a ``min``/``max`` and a wholly different
  gradient: at most 0.1% of the lanes may, and the test counts them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsmcrt_tpu.sdfs import raycast as jrc
from rsmcrt_tpu_torch.sdfs import raycast as trc

from test_torch_sdfs import (CASES, REGISTRY, _pair, registry_points,
                             registry_scenes)

torch.set_num_threads(1)

QUARTIC = ("torus", "revolution")
ANALYTIC = ("sphere", "box", "plane", "cylinder", "capsule", "segment",
            "cone", "torus", "triprism", "revolution")


def _rays(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    p = (rng.uniform(-1.0, 1.0, (n, 3)) * scale).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return p, d


def _compare_bounds(jt, ji, tt, ti, quartic, what):
    """Crossing parameters and crossed prims, lane by lane."""
    jf, tf = np.isfinite(jt), np.isfinite(tt)
    same_fin = (jf == tf).mean()
    same_idx = (ji == ti).mean()
    both = jf & tf
    if quartic:
        assert same_fin >= 0.999, (what, same_fin)
        assert same_idx >= 0.999, (what, same_idx)
        np.testing.assert_allclose(tt[both], jt[both], rtol=1e-4, atol=1e-4,
                                   err_msg=what)
    else:
        assert same_fin == 1.0, (what, same_fin)
        assert same_idx >= 0.999, (what, same_idx)
        np.testing.assert_allclose(tt[both], jt[both], rtol=1e-5, atol=1e-5,
                                   err_msg=what)
    return both.sum()


@pytest.mark.parametrize("how", ["built", "converted"])
@pytest.mark.parametrize("kind", ANALYTIC)
def test_every_raycast_matches_reference(kind, how):
    js, ts = _pair(kind, how)
    assert jrc.analytic_column_mask(js) == trc.analytic_column_mask(ts)
    assert all(trc.analytic_column_mask(ts))
    p, d = _rays(4096, 21)
    jt, ji = (np.asarray(a) for a in jrc.ray_bound_idx(
        js, jnp.asarray(p), jnp.asarray(d)))
    tt, ti = (a.numpy() for a in trc.ray_bound_idx(
        ts, torch.as_tensor(p), torch.as_tensor(d)))
    n_both = _compare_bounds(jt, ji, tt, ti, kind in QUARTIC, kind)
    assert n_both > 3000  # most rays from inside the box cross something
    # the members, not only the bounding box, are crossed
    assert (ji[np.isfinite(jt)] != js.perm[2]).sum() > 100


@pytest.mark.parametrize("name,params", REGISTRY,
                         ids=[r[0] for r in REGISTRY])
def test_registry_mask_and_bounds(name, params):
    js, built, conv = registry_scenes(name, params)
    mask = jrc.analytic_column_mask(js)
    p, d = registry_points(name, 4096, 12)
    jt, ji = (np.asarray(a) for a in jrc.ray_bound_idx(
        js, jnp.asarray(p), jnp.asarray(d)))
    jb = np.asarray(jrc.ray_bound(js, jnp.asarray(p), jnp.asarray(d)))
    np.testing.assert_array_equal(jb, jt)
    quartic = any(s.kind in QUARTIC for s in js.specs)
    for ts in (built, conv):
        assert trc.analytic_column_mask(ts) == mask
        tt, ti = (a.numpy() for a in trc.ray_bound_idx(
            ts, torch.as_tensor(p), torch.as_tensor(d)))
        _compare_bounds(jt, ji, tt, ti, quartic, name)
        tb = trc.ray_bound(ts, torch.as_tensor(p), torch.as_tensor(d))
        np.testing.assert_array_equal(tb.numpy(), tt)
    if not any(mask):
        assert not np.isfinite(jt).any()


def _normals(js, ts, p, idx):
    jn = np.asarray(jrc.surface_normal(js, jnp.asarray(p), jnp.asarray(idx)))
    tn = trc.surface_normal(ts, torch.as_tensor(p),
                            torch.as_tensor(idx, dtype=torch.int32)).numpy()
    return jn, tn


def _compare_normals(jn, tn, what):
    jf, tf = np.isfinite(jn).all(-1), np.isfinite(tn).all(-1)
    np.testing.assert_array_equal(jf, tf, err_msg=what)
    close = np.isclose(tn, jn, rtol=1e-4, atol=1e-5).all(-1) | ~jf
    flips = int((~close).sum())
    assert flips <= 1e-3 * len(close), (what, flips)
    np.testing.assert_allclose(tn[close & jf], jn[close & jf], rtol=1e-4,
                               atol=1e-5, err_msg=what)
    return flips


@pytest.mark.parametrize("how", ["built", "converted"])
@pytest.mark.parametrize("kind", CASES)
def test_surface_normal_per_kind(kind, how):
    """The normal of the prim a lane names, at seeded points and on the
    surfaces the reference's raycast finds (analytic kinds)."""
    js, ts = _pair(kind, how)
    rng = np.random.default_rng(5)
    p, d = _rays(4096, 23)
    idx = rng.integers(0, js.group_sizes[0], 4096).astype(np.int32)
    flips = _compare_normals(*_normals(js, ts, p, idx), kind)
    if kind in ANALYTIC:
        t, hit = (np.asarray(a) for a in jrc.ray_bound_idx(
            js, jnp.asarray(p), jnp.asarray(d)))
        on = np.isfinite(t)
        ps = (p + t[:, None] * d)[on]
        flips += _compare_normals(*_normals(js, ts, ps, hit[on]),
                                  kind + " on surface")
    assert flips <= 8, flips


def test_surface_normal_at_exact_ties():
    """Points on the symmetry planes of a box, a capped cylinder and a
    capsule, where ``abs`` and the clips sit at their kinks: JAX's slopes
    there, not autograd's."""
    name = "model_union"
    js, ts = _pair(name, "built")
    p = np.zeros((6, 3), np.float32)
    p[:, 0] = [0.0, 0.4, -0.4, 0.0, 0.0, 0.25]
    p[:, 1] = [0.0, 0.0, 0.0, 0.3, -0.3, 0.0]
    idx = np.zeros(6, np.int32)
    jn, tn = _normals(js, ts, p, idx)
    np.testing.assert_allclose(tn, jn, rtol=1e-5, atol=1e-6)
