"""SDF evaluation of the PyTorch port against the JAX reference: every
primitive, modifier and CSG op, every registry scene, the rotation
helpers and the tetrahedron normals.

Each case builds the same scene in both packages -- two members of one
structure (so the port's stacked member axis is exercised) plus a
bounding box -- and evaluates it at 4096 seeded points.  The port's scene
is built both by its own constructors and through
``interop.scene_from_numpy``.  Distances agree to rtol 1e-5, atol 1e-6
(float32 rounding of the two libraries); layers are equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rsmcrt_tpu import scenes as jscenes
from rsmcrt_tpu.maths import transforms as jT
from rsmcrt_tpu.optics.properties import mono as jmono
from rsmcrt_tpu.sdfs import scene as jS
from rsmcrt_tpu_torch import interop
from rsmcrt_tpu_torch import scenes as tscenes
from rsmcrt_tpu_torch.maths import transforms as tT
from rsmcrt_tpu_torch.optics.properties import mono as tmono
from rsmcrt_tpu_torch.sdfs import scene as tS

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _np(x):
    return np.asarray(x, np.float32)


#: rigid transforms shared by both packages (the reference's float32
#: matrices, handed to the port as they are)
MOVE = _np(jT.invert(jT.translate(jnp.asarray([0.1, -0.2, 0.05]))))
TURN = _np(jT.invert(jT.rotmat(jnp.asarray([1.0, 2.0, -0.5]), 37.0)
                     @ jT.translate(jnp.asarray([-0.1, 0.15, 0.0]))))


def _sin_bump(sin):
    return lambda p: 0.03 * sin(9.0 * p[..., 0]) * sin(7.0 * p[..., 1])


DISP = {"jax": _sin_bump(jnp.sin), "torch": _sin_bump(torch.sin)}


def _prims(M, lib, opt):
    """The primitive and modifier cases: name -> (spec, spec of the same
    structure with other parameters)."""
    mk = {
        "sphere": lambda s: M.sphere(0.4 * s, opt, 1, transform=MOVE),
        "box": lambda s: M.box([0.6 * s, 0.4, 0.8], opt, 1, transform=TURN),
        "torus": lambda s: M.torus(0.4 * s, 0.1, opt, 1, transform=TURN),
        "cylinder": lambda s: M.cylinder([-0.3, 0.1, 0.0], [0.4, 0.2 * s,
                                                            -0.1],
                                         0.2 * s, opt, 1, transform=MOVE),
        "triprism": lambda s: M.triprism(0.5 * s, 0.3, opt, 1,
                                         transform=TURN),
        "segment": lambda s: M.segment([-0.3, 0.1, 0.0], [0.4 * s, 0.2,
                                                          0.0], opt, 1),
        "capsule": lambda s: M.capsule([-0.3, 0.1, 0.2], [0.4, -0.2 * s,
                                                          0.0],
                                       0.15 * s, opt, 1, transform=MOVE),
        "cone": lambda s: M.cone([0.0, -0.4, 0.1], [0.1 * s, 0.4, 0.0],
                                 0.35 * s, 0.1, opt, 1, transform=TURN),
        "egg": lambda s: M.egg(0.5 * s, 0.3, 0.4, opt, 1),
        "plane": lambda s: M.plane(_np([0.6 * s, 0.8, 0.0])
                                   / np.hypot(0.6 * s, 0.8), opt, 1,
                                   transform=MOVE),
        "revolution": lambda s: M.revolution(M.egg(0.5, 0.3, 0.4, opt, 1),
                                             0.3 * (s - 1.0),
                                             center=[0.1, 0.0, -0.1 * s]),
        "extrude": lambda s: M.extrude(
            M.segment([-0.3, 0.1, 0.0], [0.4, 0.2 * s, 0.0], opt, 1),
            0.3 * s),
        "onion": lambda s: M.onion(M.sphere(0.5, opt, 1, transform=MOVE),
                                   0.05 * s),
        "twist": lambda s: M.twist(M.torus(0.45, 0.12, opt, 1), 2.0 * s),
        "bend": lambda s: M.bend(M.box([0.8, 0.3, 0.4], opt, 1), 1.5 * s),
        "elongate": lambda s: M.elongate(M.sphere(0.2, opt, 1),
                                         [0.3 * s, 0.0, 0.1]),
        "elongate_scalar": lambda s: M.elongate(M.sphere(0.2, opt, 1),
                                                0.15 * s),
        "displacement": lambda s: M.displacement(
            M.sphere(0.45 * s, opt, 1), DISP[lib]),
        "repeat": lambda s: M.repeat(M.sphere(0.1 * s, opt, 1), 0.5,
                                     -1.0, 1.0),
    }
    for op in ("union", "smooth_union", "subtraction", "intersection"):
        mk[f"model_{op}"] = lambda s, op=op: M.model(
            [M.sphere(0.5, opt, 1, transform=MOVE),
             M.box([0.7, 0.5 * s, 0.6], opt, 1, transform=TURN),
             M.cylinder([-0.4, 0.0, 0.0], [0.4, 0.0, 0.0], 0.15, opt, 1)],
            op, 0.1 * s)
    return mk


CASES = sorted(_prims(jS, "jax", None))


def _pair(name, how):
    jopt, topt = jmono(1.0, 0.1, 0.0, 1.4), tmono(1.0, 0.1, 0.0, 1.4)
    jp = _prims(jS, "jax", jopt)[name]
    js = jS.build_scene([jp(1.0), jp(1.3),
                         jS.box([2.0, 2.0, 2.0], jmono(0, 0, 0, 1), 2)])
    if how == "built":
        tp = _prims(tS, "torch", topt)[name]
        ts = tS.build_scene([tp(1.0), tp(1.3),
                             tS.box([2.0, 2.0, 2.0], tmono(0, 0, 0, 1), 2)])
    else:
        ts = interop.scene_from_numpy(
            jax.tree_util.tree_map(np.asarray, js),
            disp_funcs={DISP["jax"]: DISP["torch"]})
    return js, ts


@pytest.mark.parametrize("how", ["built", "converted"])
@pytest.mark.parametrize("name", CASES)
def test_every_spec_kind_matches_reference(name, how):
    js, ts = _pair(name, how)
    # the two members share a group (with the bounding box too when both
    # are boxes)
    assert ts.group_sizes == js.group_sizes
    assert js.group_sizes[0] >= 2
    p = np.random.default_rng(3).uniform(-1.0, 1.0, (4096, 3)).astype(
        np.float32)
    jd = np.asarray(jS.eval_scene(js, jnp.asarray(p)))
    td = tS.eval_scene(ts, torch.as_tensor(p)).numpy()
    np.testing.assert_allclose(td, jd, RTOL, ATOL)
    np.testing.assert_array_equal(tS.scene_layer(torch.as_tensor(td)).numpy(),
                                  np.asarray(jS.scene_layer(jnp.asarray(jd))))
    assert (jd[:, :2] < 0).any() and (jd[:, :2] > 0).any()


REGISTRY = [
    ("sphere", {"mus": [1.0], "mua": [0.1], "hgg": [0.9], "n": [1.38]}),
    ("box", {"mus": [1.0], "mua": [0.1], "hgg": [0.9], "n": [1.38],
             "BoxDimensions": [1.0, 0.5, 1.5]}),
    ("egg", {"mus": [1.0, 0.4, 5.0], "mua": [1.0, 0.01, 0.1],
             "hgg": [0.0, 0.0, 0.9], "n": [1.5, 1.35, 1.42],
             "boundinglength": [12.0, 12.0, 12.0]}),
    ("sphere_scene", {}), ("aptran", {}), ("exp", {}), ("lens", {}),
    ("scat_test", {}), ("scat_test2", {}), ("omg", {}), ("vessels", {}),
    ("logo", {}),
]


def registry_scenes(name, params):
    """The reference's scene and the port's, built by its own registry
    and converted from the reference's."""
    js = jS.build_scene(jscenes.setup_simulation(name, params,
                                                 res_dir="res"))
    built = tS.build_scene(tscenes.setup_simulation(name, params,
                                                    res_dir="res"))
    conv = interop.scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    return js, built, conv


def registry_points(name, n, seed):
    """Seeded points and unit directions spanning the scene (the egg is
    6 wide, the vessels 0.3, the rest about 2)."""
    scale = {"egg": 6.0, "vessels": 0.17, "scat_test2": 100.0}.get(name,
                                                                   1.1)
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1.0, 1.0, (n, 3)) * scale
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return p.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("name,params", REGISTRY, ids=[r[0] for r in REGISTRY])
def test_registry_scene_layers(name, params):
    js, built, conv = registry_scenes(name, params)
    p, _ = registry_points(name, 4096, 8)
    jd = np.asarray(jS.eval_scene(js, jnp.asarray(p)))
    jl = np.asarray(jS.scene_layer(jnp.asarray(jd)))
    for ts in (built, conv):
        assert ts.layer_ids == js.layer_ids and ts.perm == js.perm
        td = tS.eval_scene(ts, torch.as_tensor(p))
        np.testing.assert_allclose(td.numpy(), jd, RTOL, ATOL)
        np.testing.assert_array_equal(tS.scene_layer(td).numpy(), jl)
    np.testing.assert_array_equal(built.tables.n.numpy(),
                                  np.asarray(js.tables.n))
    np.testing.assert_array_equal(built.tables.kappa.numpy(),
                                  np.asarray(js.tables.kappa))


def test_calc_normals_matches_reference():
    js, ts, _ = registry_scenes("omg", {})
    p, _ = registry_points("omg", 2048, 9)
    jn = np.asarray(jS.calc_normals(js, jnp.asarray(p), 1e-4))
    tn = tS.calc_normals(ts, torch.as_tensor(p), 1e-4).numpy()
    # finite differences of step 1e-4 divide float32 rounding by 1e-4
    np.testing.assert_allclose(tn, jn, atol=2e-3)


def test_rotation_helpers_match_reference():
    for j, t in ((jT.rotate_x(33.0), tT.rotate_x(33.0)),
                 (jT.rotate_y(90.0), tT.rotate_y(90.0)),
                 (jT.rotate_z(-71.5), tT.rotate_z(-71.5)),
                 (jT.rotmat(jnp.asarray([1.0, -2.0, 0.5]), 123.0),
                  tT.rotmat([1.0, -2.0, 0.5], 123.0))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)
    a = np.asarray([0.0, 0.0, -1.0], np.float32)
    b = np.asarray([0.3, -0.4, 0.866], np.float32)
    b /= np.linalg.norm(b)
    np.testing.assert_allclose(
        tT.rotation_align(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        np.asarray(jT.rotation_align(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-6)


def test_displacement_needs_its_torch_twin():
    js = jS.build_scene([jS.displacement(
        jS.sphere(0.5, jmono(1, 0, 0, 1), 1), DISP["jax"])])
    with pytest.raises(NotImplementedError, match="disp_funcs"):
        interop.scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))


@pytest.mark.parametrize("name", ["lens", "egg"])
def test_render_geometry_matches_reference(name):
    """Layer IDs rasterised at voxel centres, as the reference renders
    them for ``render_geometry = true``."""
    from rsmcrt_tpu.render import render_geometry as jrender
    from rsmcrt_tpu_torch.render import render_geometry as trender

    params = dict(REGISTRY)[name]
    js, built, _ = registry_scenes(name, params)
    extent = [6.0, 6.0, 6.0] if name == "egg" else [1.0, 1.0, 1.0]
    want = jrender(js, extent, (12, 10, 16))
    got = trender(built, extent, (12, 10, 16))
    assert got.dtype == np.float32 and got.shape == (12, 10, 16)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 1
