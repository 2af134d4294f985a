"""The port's escape-function kernel (``rsmcrt_tpu_torch/escape.py`` and
what it rests on) against the JAX reference and the solid-angle oracle.

- Pure functions, to float32 rounding, on numpy-seeded inputs: the five
  interpolation functions, ``get_voxel_cyl``, ``_axis_bracket``,
  ``_sym_frames``, ``map_escape_cart`` / ``map_escape_cyl`` on a random
  symmetry grid (a rotated, shifted frame, and an identity frame whose
  fluence voxels sit at the grid's faces, at r = 0 and across theta's
  wrap), the ``escape_points`` sample from given uniforms and ``sid``, and
  the ``[symmetry]`` / ``[inverse]`` tables of every res/*.toml that has
  one.
- tests/test_escape.py's two cartesian mapping cases and
  tests/test_escape_modes.py's two cylindrical goldens, on the port.
- Whole runs of the port on the CPU against tests/test_escape_modes.py's
  near-vacuum box, whose detection efficiency from a voxel is the exact
  solid-angle fraction of the detector disk (gate: 5 sem + 0.01 a voxel,
  mean deviation under 0.01): the ``none`` and ``360rotational`` modes at
  1,000 photons a voxel here; every mode at the reference's 4,000 and
  res/escape_test.toml end to end under ``-m slow``, as the reference
  marks its own.
"""

import glob
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import rsmcrt_tpu.escape as jesc
import rsmcrt_tpu.grid as jgrid
from rsmcrt_tpu.config import parse_params as jparse
from rsmcrt_tpu.constants import TWOPI
from rsmcrt_tpu.maths import interpolate as jint
from rsmcrt_tpu.sources import sources as jsrc
from rsmcrt_tpu_torch import escape as tesc
from rsmcrt_tpu_torch import grid as tgrid
from rsmcrt_tpu_torch import interop
from rsmcrt_tpu_torch.config import parse_params as tparse
from rsmcrt_tpu_torch.kernels import setup as tsetup
from rsmcrt_tpu_torch.maths import interpolate as tint
from rsmcrt_tpu_torch.sources import sources as tsrc

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _f32(rng, *shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def test_interpolation_matches_reference():
    rng = np.random.default_rng(0)
    n = 500
    a = {k: _f32(rng, n) for k in ("x0", "y0", "z0", "x", "y", "z")}
    for k in ("x", "y", "z"):
        a[k + "1"] = a[k + "0"] + _f32(rng, n, lo=0.1, hi=1.0)
    a["x1"][:5] = a["x0"][:5]  # degenerate brackets
    v = [_f32(rng, n) for _ in range(4)]
    cube = _f32(rng, n, 2, 2, 2)
    r0 = _f32(rng, n, lo=0.0, hi=0.5)
    r1 = r0 + _f32(rng, n, lo=0.1, hi=0.5)
    t0 = _f32(rng, n, lo=0.0, hi=6.0)
    t1 = t0 + _f32(rng, n, lo=0.1, hi=0.8)
    r = r0 + (r1 - r0) * _f32(rng, n, lo=0.0, hi=1.0)
    t = t0 + (t1 - t0) * _f32(rng, n, lo=0.0, hi=1.0)
    cases = {
        "linear_interpolate": (a["x0"], a["x1"], v[0], v[1], a["x"]),
        "bilinear_interpolate": (a["x0"], a["x1"], a["y0"], a["y1"], *v,
                                 a["x"], a["y"]),
        "trilinear_interpolate": (a["x0"], a["x1"], a["y0"], a["y1"],
                                  a["z0"], a["z1"], cube, a["x"], a["y"],
                                  a["z"]),
        "cyl_bilinear_interpolate": (r0, r1, t0, t1, *v, r, t),
        "cyl_trilinear_interpolate": (r0, r1, t0, t1, a["z0"], a["z1"],
                                      cube, r, t, a["z"]),
    }
    for name, args in cases.items():
        want = np.asarray(getattr(jint, name)(*map(jnp.asarray, args)))
        got = getattr(tint, name)(*args).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6,
                                   err_msg=name)


def test_get_voxel_cyl_matches_reference():
    rng = np.random.default_rng(1)
    pts = _f32(rng, 2000, 3, lo=-1.3, hi=1.3)
    pts[:4] = [[0.0, 0.0, 0.1], [0.5, -1e-7, 0.0], [0.5, 0.0, -1.0],
               [-0.2, 0.0, 0.99]]  # r = 0, theta just below 2 pi, faces
    jg = jgrid.cyl_grid(5, 8, 6, 1.0, TWOPI, 0.9)
    tg = tgrid.cyl_grid(5, 8, 6, 1.0, TWOPI, 0.9)
    np.testing.assert_array_equal(
        tgrid.get_voxel_cyl(tg, torch.as_tensor(pts)).numpy(),
        np.asarray(jgrid.get_voxel_cyl(jg, jnp.asarray(pts))))


def test_axis_bracket_and_frames_match_reference():
    rng = np.random.default_rng(2)
    p = rng.uniform(-1.2, 1.2, 3000)
    p[:6] = [-1.0, 1.0, -0.75, 0.0, 0.25, 0.999999]
    for half, n in ((1.0, 4), (0.8, 5), (1.0, 1)):
        for a, b in zip(tesc._axis_bracket(p, half, n),
                        jesc._axis_bracket(p, half, n)):
            np.testing.assert_array_equal(a, b)
    for d, rot in (((0.0, 0.0, 1.0), 0.0), ((1.0, 0.0, 0.0), 30.0),
                   ((0.3, -0.2, 0.93), 217.5)):
        d = tuple(np.asarray(d) / np.linalg.norm(d))
        for a, b in zip(tesc._sym_frames(d, rot), jesc._sym_frames(d, rot)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=2e-7)


def _maps(cyl, frames, pos, fg_shape, sym_shape, ext):
    rng = np.random.default_rng(3)
    sym = rng.uniform(0.0, 1.0, (2,) + sym_shape).astype(np.float32)
    jfg = jgrid.cart_grid(*fg_shape, 1.0, 1.0, 1.0)
    tfg = tgrid.cart_grid(*fg_shape, 1.0, 1.0, 1.0)
    if cyl:
        jsg = jgrid.cyl_grid(*sym_shape, ext[0], TWOPI, ext[2])
        tsg = tgrid.cyl_grid(*sym_shape, ext[0], TWOPI, ext[2])
        want = jesc.map_escape_cyl(sym, jsg, jfg, frames, jnp.asarray(pos))
        got = tesc.map_escape_cyl(
            sym, tsg, tfg, tuple(torch.as_tensor(np.asarray(f))
                                 for f in frames), torch.as_tensor(pos))
    else:
        jsg = jgrid.cart_grid(*sym_shape, *ext)
        tsg = tgrid.cart_grid(*sym_shape, *ext)
        want = jesc.map_escape_cart(sym, jsg, jfg, frames, jnp.asarray(pos))
        got = tesc.map_escape_cart(
            sym, tsg, tfg, tuple(torch.as_tensor(np.asarray(f))
                                 for f in frames), torch.as_tensor(pos))
    return got, want


@pytest.mark.parametrize("cyl", [False, True], ids=["cart", "cyl"])
def test_maps_match_reference(cyl):
    """A rotated, shifted frame (the reference's frame matrices handed to
    both), and an identity frame on odd fluence grids, whose voxel centres
    sit on the symmetry grid's faces, at r = 0 and on both sides of
    theta's wrap."""
    rot = jesc._sym_frames(tuple(np.array([0.3, -0.2, 0.93])
                                 / np.linalg.norm([0.3, -0.2, 0.93])), 40.0)
    eye = (jnp.eye(4),) * 4
    pos = np.array([0.1, -0.05, 0.2], np.float32)
    for frames, p, fg in ((rot, pos, (20, 18, 16)),
                          (eye, np.zeros(3, np.float32), (21, 21, 9))):
        shape = (5, 8, 6) if cyl else (5, 4, 6)
        ext = (0.8, 0.7, 0.75)
        got, want = _maps(cyl, frames, p, fg, shape, ext)
        assert (want == -1.0).any() and (want >= 0.0).any()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_cart_map_identity_frame():
    """tests/test_escape.py: a constant field maps to itself inside the
    symmetry grid and to -1 outside."""
    sym = np.full((1, 4, 4, 4), 0.7, np.float32)
    sg = tgrid.cart_grid(4, 4, 4, 0.5, 0.5, 0.5)
    fg = tgrid.cart_grid(16, 16, 16, 1.0, 1.0, 1.0)
    out = tesc.map_escape_cart(sym, sg, fg, (torch.eye(4),) * 4,
                               torch.zeros(3))
    assert np.isclose(out[0, 8, 8, 8], 0.7, atol=1e-5)
    assert out[0, 0, 0, 0] == -1.0


def test_cart_map_gradient_field():
    """tests/test_escape.py: a linear-in-z field interpolates linearly."""
    sg = tgrid.cart_grid(4, 4, 4, 1.0, 1.0, 1.0)
    fg = tgrid.cart_grid(8, 8, 8, 1.0, 1.0, 1.0)
    zc = (np.arange(4) + 0.5) / 4 * 2.0 - 1.0
    sym = np.broadcast_to(zc[None, None, None, :], (1, 4, 4, 4)).astype(
        np.float32).copy()
    out = tesc.map_escape_cart(sym, sg, fg, (torch.eye(4),) * 4,
                               torch.zeros(3))
    zf = (np.arange(8) + 0.5) / 8 * 2.0 - 1.0
    assert np.allclose(out[0, 4, 4, 2:6], zf[2:6], atol=1e-5)


def test_map_escape_cyl_radial_golden():
    """tests/test_escape_modes.py: a radially linear field maps to r."""
    nrg, ntg, nzg = 8, 8, 4
    sg = tgrid.cyl_grid(nrg, ntg, nzg, 1.0, TWOPI, 1.0)
    fg = tgrid.cart_grid(20, 20, 4, 1.0, 1.0, 1.0)
    r_c = (np.arange(nrg) + 0.5) / nrg
    sym = np.broadcast_to(r_c[None, :, None, None],
                          (1, nrg, ntg, nzg)).astype(np.float32).copy()
    out = tesc.map_escape_cyl(sym, sg, fg, (torch.eye(4),) * 4,
                              torch.zeros(3))
    xs = (np.arange(20) + 0.5) / 20 * 2.0 - 1.0
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    rad = np.sqrt(gx**2 + gy**2)
    got = out[0, :, :, 2]
    ring = (got >= 0.0) & (rad > 0.2) & (rad < 0.85)
    assert np.all(np.abs(got[ring] - rad[ring]) < 0.07)
    assert np.all(out[0][rad >= 1.0] == -1.0)


def test_map_escape_cyl_theta_z_golden():
    """tests/test_escape_modes.py: cos(theta) x linear-in-z."""
    nrg, ntg, nzg = 6, 16, 6
    sg = tgrid.cyl_grid(nrg, ntg, nzg, 1.0, TWOPI, 1.0)
    fg = tgrid.cart_grid(16, 16, 8, 1.0, 1.0, 1.0)
    t_c = (np.arange(ntg) + 0.5) / ntg * TWOPI
    z_c = (np.arange(nzg) + 0.5) / nzg * 2.0 - 1.0
    sym = ((2.0 + np.cos(t_c)[None, None, :, None])
           * (1.0 + 0.5 * z_c[None, None, None, :])
           * np.ones((1, nrg, 1, 1))).astype(np.float32)
    out = tesc.map_escape_cyl(sym, sg, fg, (torch.eye(4),) * 4,
                              torch.zeros(3))
    xs = (np.arange(16) + 0.5) / 16 * 2.0 - 1.0
    zs = (np.arange(8) + 0.5) / 8 * 2.0 - 1.0
    gx, gy, gz = np.meshgrid(xs, xs, zs, indexing="ij")
    rad = np.sqrt(gx**2 + gy**2)
    theta = np.mod(np.arctan2(gy, gx), TWOPI)
    expect = (2.0 + np.cos(theta)) * (1.0 + 0.5 * gz)
    ring = (out[0] >= 0.0) & (rad > 0.25) & (rad < 0.85) & (np.abs(gz) < 0.7)
    assert np.all(np.abs(out[0][ring] - expect[ring]) < 0.12)


def test_escape_points_sample_matches_reference():
    rng = np.random.default_rng(4)
    positions = _f32(rng, 7, 3)
    u = rng.uniform(1e-12, 1.0, (400, 3)).astype(np.float32)
    sid = rng.integers(-2, 10, 400).astype(np.int32)  # clipped at both ends
    jsrc_ = jsrc.Source(kind="escape_points",
                        params={"positions": jnp.asarray(positions)})
    tsrc_ = interop.source_from_numpy(jsrc_)
    assert tsrc.n_source_uniforms(tsrc_) == jsrc.n_source_uniforms(jsrc_)
    jg = jgrid.cart_grid(8, 8, 8, 1.0, 1.0, 1.0)
    tg = tgrid.cart_grid(8, 8, 8, 1.0, 1.0, 1.0)
    want = jsrc.sample(jsrc_, jg, jnp.asarray(u), sid=jnp.asarray(sid))
    got = tsrc.sample(tsrc_, tg, torch.as_tensor(u),
                      sid=torch.as_tensor(sid))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("toml", sorted(
    Path(p).name for p in glob.glob(str(ROOT / "res" / "*.toml"))
    if any(t in Path(p).read_text() for t in ("[symmetry]", "[inverse]"))))
def test_symmetry_and_inverse_tables_match_reference(toml):
    path = ROOT / "res" / toml
    kernel = "escape" if "[symmetry]" in path.read_text() else "inverse"
    js = jparse(path, kernel=kernel).settings
    ts = tparse(path, kernel=kernel).settings
    # interop carries the reference's settings across, grids included
    cs = interop.settings_from_numpy(js)
    for name in ("sym_grid_cart", "sym_grid_cyl", "grid"):
        a, b = getattr(cs, name), getattr(ts, name)
        assert (a is None) == (b is None)
        if b is not None:
            assert a.shape == b.shape and repr(a) == repr(b)
    assert (cs.nphotons, cs.inverse, cs.symmetry_type) == (
        ts.nphotons, ts.inverse, ts.symmetry_type)
    assert ts.nphotons == js.nphotons
    assert ts.inverse == js.inverse
    assert ts.symmetry_type == js.symmetry_type
    np.testing.assert_allclose(ts.sym_dir, js.sym_dir, rtol=1e-12)
    assert (ts.sym_pos, ts.sym_rot) == (js.sym_pos, js.sym_rot)
    for name in ("sym_grid_cart", "sym_grid_cyl"):
        a, b = getattr(ts, name), getattr(js, name)
        assert (a is None) == (b is None)
        if b is not None:
            for f in ("xmax", "ymax", "zmax", "rmax"):
                if hasattr(b, f):
                    assert getattr(a, f) == float(np.asarray(getattr(b, f)))
            assert a.shape == tuple(int(x) for x in (
                (b.nxg, b.nyg, b.nzg) if hasattr(b, "nxg")
                else (b.nrg, b.ntg, b.nzg)))


# --- whole runs against the solid-angle oracle (test_escape_modes.py) ---

DECT_POS = np.array([0.0, 0.0, -0.9])
DECT_DIR = np.array([0.0, 0.0, -1.0])
DECT_R = 0.6
CONFIG = (ROOT / "tests" / "test_escape_modes.py").read_text().split(
    'CONFIG = """', 1)[1].split('"""', 1)[0]


def _setup(tmp_path, stype, grid, maxv, nph, extra=""):
    f = tmp_path / "escape_mode.toml"
    f.write_text(CONFIG.format(stype=stype, nph=nph, gx=grid[0], gy=grid[1],
                               gz=grid[2], mx=maxv[0], my=maxv[1],
                               mz=maxv[2], extra=extra))
    return tsetup(f, kernel="escape", res_dir=ROOT / "res", device="cpu")


def disk_oracle(points, n_dirs=200_000):
    """Fraction of isotropic rays from each point crossing the one-sided
    detector disk (Fibonacci-sphere directions)."""
    i = np.arange(n_dirs) + 0.5
    cost = 1.0 - 2.0 * i / n_dirs
    sint = np.sqrt(np.maximum(1.0 - cost * cost, 0.0))
    phi = np.pi * (1.0 + np.sqrt(5.0)) * i
    d = np.stack([sint * np.cos(phi), sint * np.sin(phi), cost], axis=-1)
    front = d @ DECT_DIR > 1e-6
    out = np.empty(len(points))
    for k, p in enumerate(np.asarray(points, np.float64)):
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (DECT_POS[2] - p[2]) / d[:, 2]
        valid = front & (d[:, 2] != 0.0) & (t > 0.0)
        hx = p[0] + t * d[:, 0]
        hy = p[1] + t * d[:, 1]
        out[k] = (valid & (hx * hx + hy * hy < DECT_R * DECT_R)).mean()
    return out


def _check(eff, oracle, n_per_voxel):
    eff = np.asarray(eff, np.float64).reshape(-1)
    sem = np.sqrt(np.maximum(oracle * (1 - oracle), 0.04) / n_per_voxel)
    assert np.all(np.abs(eff - oracle) < 5.0 * sem + 0.01), \
        np.stack([eff, oracle], axis=-1)
    assert abs((eff - oracle).mean()) < 0.01


def _rodrigues_z_to(b):
    a = np.array([0.0, 0.0, 1.0])
    v = np.cross(a, b)
    K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + K + K @ K / (1.0 + float(a @ b))


def _mode_case(tmp_path, stype, nph):
    """Runs one mode; returns (computed efficiencies, their world points)
    after checking the mode's exact symmetric fill."""
    cyl = stype in ("noneRotational", "360rotational")
    grid, maxv, extra = ((3, 4, 3), (0.7, 1.0, 0.7), "") if cyl else \
        ((3, 3, 4), (0.8, 0.8, 0.8), "")
    if stype == "rotated":
        grid, maxv = (2, 2, 3), (0.5, 0.5, 0.5)
        extra = "position = [0.1, 0.0, -0.2]\ndirection = [1.0, 0.0, 0.0]\n"
    parsed, scene = _setup(tmp_path, "none" if stype == "rotated" else stype,
                           grid, maxv, nph, extra)
    sym, frames, gp, is_cyl = tesc.compute_escape_symmetry(parsed, scene,
                                                           n_lanes=4096)
    assert is_cyl == cyl
    st = parsed.settings
    cg = st.sym_grid_cyl if cyl else st.sym_grid_cart
    nx, ny, nz = cg.shape
    centres = tesc._cyl_centres if cyl else tesc._cart_centres
    if stype == "prism":
        for o in range(1, nz):
            np.testing.assert_array_equal(sym[..., o], sym[..., 0])
        mm, nn = (a.ravel() for a in np.meshgrid(np.arange(nx),
                                                 np.arange(ny),
                                                 indexing="ij"))
        return sym[0, mm, nn, 0], centres(cg, mm, nn, np.full(mm.size, 2))
    if stype == "flipped":
        for o in range(nz // 2 + 1):
            np.testing.assert_array_equal(sym[..., nz - 1 - o], sym[..., o])
        nz = nz // 2
    if stype == "uniformSlab":
        np.testing.assert_array_equal(
            sym, np.broadcast_to(sym[:, 1:2, 1:2, :], sym.shape))
        oo = np.arange(nz)
        m0 = np.ones(nz, np.int64)
        return sym[0, 1, 1, :], centres(cg, m0, m0, oo)
    if stype == "360rotational":
        np.testing.assert_array_equal(
            sym, np.broadcast_to(sym[:, :, 0:1, :], sym.shape))
        ny = 1
    mm, nn, oo = (a.ravel() for a in np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"))
    pts = centres(cg, mm, nn, oo)
    if stype == "rotated":
        pts = pts @ _rodrigues_z_to(np.array([1.0, 0.0, 0.0])).T \
            + np.array([0.1, 0.0, -0.2])
    return sym[0, mm, nn, oo], pts


@pytest.mark.parametrize("stype", ["none", "360rotational"])
def test_escape_mode_matches_oracle(tmp_path, stype):
    eff, pts = _mode_case(tmp_path, stype, 1000)
    _check(eff, disk_oracle(pts), 1000)


@pytest.mark.slow
@pytest.mark.parametrize("stype", ["none", "prism", "flipped", "uniformSlab",
                                   "noneRotational", "360rotational",
                                   "rotated"])
def test_escape_mode_matches_oracle_full(tmp_path, stype):
    eff, pts = _mode_case(tmp_path, stype, 4000)
    _check(eff, disk_oracle(pts), 4000)


@pytest.mark.slow
def test_escape_360rotational():
    """tests/test_escape.py's end-to-end run of res/escape_test.toml."""
    escape, sym = tesc.escape_function(ROOT / "res" / "escape_test.toml",
                                       n_lanes=2048, verbose=False,
                                       write_files=False, device="cpu")
    assert sym.shape == (1, 4, 4, 4) and escape.shape == (1, 32, 32, 32)
    assert np.allclose(sym[0, :, 0, :], sym[0, :, 2, :])
    col = escape[0, 16, 16, :]
    assert col[col >= 0.0].max() > 0.05
    assert col[28] > col[4]
    assert escape.min() == -1.0


@pytest.mark.parametrize("table,kernel", [
    ('[symmetry]\nrotation = 360.0\n', "escape"),
    ('[symmetry]\ndirection = [0.0, 0.0, 0.0]\n', "escape"),
    ('[symmetry]\nsymmetryType = "helical"\n', "escape"),
    ('[symmetry]\nGridSize = [4, 4]\n', "escape"),
    ('[symmetry]\nmaxValues = [1.0]\n', "escape"),
    ("", "inverse"),
    ("[inverse]\nFindmua = true\n", "inverse"),
])
def test_symmetry_and_inverse_errors_match_reference(tmp_path, table, kernel):
    """The reference's error cases of the two tables raise here too,
    with its messages."""
    f = tmp_path / "bad.toml"
    text = (ROOT / "res" / "escape_test.toml").read_text()
    f.write_text(text.split("[symmetry]")[0] + table)
    with pytest.raises(ValueError) as want:
        jparse(f, kernel=kernel)
    with pytest.raises(ValueError) as got:
        tparse(f, kernel=kernel)
    assert str(got.value) == str(want.value)
