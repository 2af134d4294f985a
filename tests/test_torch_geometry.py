"""Scene geometry of the PyTorch port against the JAX reference: SDF
evaluation, layers, analytic raycasts and surface normals on the bench
scene (res/sphere.toml) and on a translated sphere.

Both the port's own scene construction and the converter from the
reference's scene are checked.  Integer outputs (layer, crossed prim)
must be equal; floats agree to rtol 1e-5, atol 1e-6 (float32 rounding of
the two libraries).  Normals are held against the reference's ``jax.grad`` normal
away from box edges, where the SDF gradient is not defined.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rsmcrt_tpu import scenes as jscenes
from rsmcrt_tpu.sdfs import raycast as jrc
from rsmcrt_tpu.sdfs import scene as jS
from rsmcrt_tpu_torch import interop
from rsmcrt_tpu_torch import scenes as tscenes
from rsmcrt_tpu_torch.sdfs import raycast as trc
from rsmcrt_tpu_torch.sdfs import scene as tS

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6

BENCH = dict(mus=[10.0], mua=[0.1], hgg=[0.9], n=[1.38],
             position=[0.0, 0.0, 0.0], boundinglength=[2.0, 2.0, 2.0],
             sphereRadius=1.0)
SHIFTED = dict(BENCH, position=[0.3, -0.2, 0.1], sphereRadius=0.6,
               boundinglength=[2.0, 1.6, 2.4])


def _scenes(params, how):
    js = jS.build_scene(jscenes.setup_sphere(params))
    if how == "built":
        ts = tS.build_scene(tscenes.setup_sphere(params))
    else:
        ts = interop.scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    return js, ts


def _points(rng, n, params):
    # uniform in and around the bounding box, with random unit directions
    bl = np.asarray(params["boundinglength"]) / 2
    p = rng.uniform(-1.2, 1.2, (n, 3)) * bl
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return p.astype(np.float32), d.astype(np.float32)


CASES = [("bench", BENCH, "built"), ("bench", BENCH, "converted"),
         ("shifted", SHIFTED, "built"), ("shifted", SHIFTED, "converted")]


@pytest.mark.parametrize("name,params,how", CASES)
def test_eval_scene_and_layer(name, params, how):
    js, ts = _scenes(params, how)
    p, _ = _points(np.random.default_rng(4), 4096, params)
    jd = jS.eval_scene(js, jnp.asarray(p))
    td = tS.eval_scene(ts, torch.as_tensor(p))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), RTOL, ATOL)
    np.testing.assert_array_equal(tS.scene_layer(td).numpy(),
                                  np.asarray(jS.scene_layer(jd)))
    # the 5-point stacked evaluation of the analysis phase
    p5 = p.reshape(-1, 4, 3)
    np.testing.assert_allclose(
        tS.eval_scene(ts, torch.as_tensor(p5)).numpy(),
        np.asarray(jS.eval_scene(js, jnp.asarray(p5))), RTOL, ATOL)


@pytest.mark.parametrize("name,params,how", CASES)
def test_ray_bound_idx(name, params, how):
    js, ts = _scenes(params, how)
    p, d = _points(np.random.default_rng(5), 4096, params)
    jt, ji = jrc.ray_bound_idx(js, jnp.asarray(p), jnp.asarray(d))
    tt, ti = trc.ray_bound_idx(ts, torch.as_tensor(p), torch.as_tensor(d))
    jt, ji = np.asarray(jt), np.asarray(ji)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(np.isfinite(tt.numpy()), np.isfinite(jt))
    fin = np.isfinite(jt)
    np.testing.assert_allclose(tt.numpy()[fin], jt[fin], RTOL, 1e-5)
    np.testing.assert_array_equal(ti.numpy(), ji)
    assert trc.analytic_column_mask(ts) == jrc.analytic_column_mask(js)


@pytest.mark.parametrize("name,params,how", CASES)
def test_surface_normal(name, params, how):
    js, ts = _scenes(params, how)
    p, d = _points(np.random.default_rng(6), 4096, params)
    jt, ji = jrc.ray_bound_idx(js, jnp.asarray(p), jnp.asarray(d))
    jt = np.asarray(jt)
    hit = np.isfinite(jt)
    # surface points, as the chained walk reaches them
    ps = (p + np.where(hit, jt, 0.0)[:, None] * d)[hit].astype(np.float32)
    idx = np.asarray(ji)[hit]
    # away from box edges: at most one box coordinate near its face
    half = np.asarray(params["boundinglength"], np.float32) / 2
    near = np.abs(np.abs(ps) - half) < 1e-3
    keep = near.sum(-1) <= 1
    ps, idx = ps[keep], idx[keep]
    assert len(idx) > 1000 and set(np.unique(idx)) == {0, 1}
    jn = np.asarray(jrc.surface_normal(js, jnp.asarray(ps),
                                       jnp.asarray(idx)))
    tn = trc.surface_normal(ts, torch.as_tensor(ps),
                            torch.as_tensor(idx, dtype=torch.int32))
    np.testing.assert_allclose(tn.numpy(), jn, RTOL, ATOL)


def test_unported_prims_raise():
    """Every prim kind and both kinds of optical properties are ported;
    anything else as a prim's properties, or an unknown kind, raises."""
    from rsmcrt_tpu_torch.optics.piecewise import Constant

    with pytest.raises(TypeError, match="OptProps"):
        tS.build_scene([tS.torus(0.5, 0.1, Constant(torch.tensor(1.0)), 1)])
    with pytest.raises(ValueError, match="unknown spec kind"):
        tS.eval_spec(tS.PrimSpec("hexagon", {}), {}, torch.zeros(1, 3))
