"""Point- and pencil-source sampling of the PyTorch port against the JAX
reference from the same uniforms (rtol 1e-5, atol 1e-6: float32
sin/cos/sqrt of the two libraries differ in the last bits)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rsmcrt_tpu.grid import cart_grid as jcart
from rsmcrt_tpu.sources import sources as jsrc
from rsmcrt_tpu_torch import interop
from rsmcrt_tpu_torch.config import ConfigError, parse_params
from rsmcrt_tpu_torch.grid import cart_grid as tcart
from rsmcrt_tpu_torch.optics.piecewise import Constant
from rsmcrt_tpu_torch.sources import sources as tsrc

torch.set_num_threads(1)


@pytest.mark.parametrize("position,wavelength", [
    ([0.0, 0.0, 0.0], None), ([0.25, -0.5, 0.125], 650.0)])
def test_point_source_sample(position, wavelength):
    rng = np.random.default_rng(7)
    u = rng.uniform(1e-12, 1.0, (4096, 3)).astype(np.float32)
    jspec = tspec = None
    if wavelength is not None:
        from rsmcrt_tpu.optics.piecewise import Constant as JConstant

        jspec = JConstant(jnp.asarray(wavelength, jnp.float32))
        tspec = Constant(torch.tensor(wavelength, dtype=torch.float32))
    js = jsrc.build_source("point", spectrum=jspec, position=position)
    ts = tsrc.build_source("point", spectrum=tspec, position=position)
    assert tsrc.n_source_uniforms(ts) == jsrc.n_source_uniforms(js)
    jout = jsrc.sample(js, jcart(16, 16, 16, 1.0, 1.0, 1.0), jnp.asarray(u))
    for src in (ts, interop.source_from_numpy(
            jax.tree_util.tree_map(np.asarray, js))):
        tout = tsrc.sample(src, tcart(16, 16, 16, 1.0, 1.0, 1.0),
                           torch.as_tensor(u))
        for t, j in zip(tout, jout):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("position,direction", [
    ([0.0, 0.0, -0.01], [0.0, 0.0, 1.0]),
    # on the grid's faces: nudged inside
    ([-1.0, 0.25, 1.0], [1.0, -2.0, 0.5])])
def test_pencil_source_sample(position, direction):
    rng = np.random.default_rng(9)
    u = rng.uniform(1e-12, 1.0, (512, 1)).astype(np.float32)
    js = jsrc.build_source("pencil", position=position, direction=direction)
    ts = tsrc.build_source("pencil", position=position, direction=direction)
    assert tsrc.n_source_uniforms(ts) == jsrc.n_source_uniforms(js) == 1
    jout = jsrc.sample(js, jcart(16, 16, 16, 1.0, 1.0, 1.0), jnp.asarray(u))
    tout = tsrc.sample(ts, tcart(16, 16, 16, 1.0, 1.0, 1.0),
                       torch.as_tensor(u))
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)
    if position[0] == -1.0:
        assert float(tout[0][0, 0]) > -1.0  # nudged off the face


def test_pencil_config_needs_a_direction(tmp_path):
    cfg = tmp_path / "c.toml"
    for direction, want in (('direction = "-y"', [0.0, -1.0, 0.0]),
                            ("direction = [0.0, 2.0, 0.0]", [0.0, 2.0, 0.0])):
        cfg.write_text('[source]\nname = "pencil"\nposition = [0, 0, 0]\n'
                       f'{direction}\n[grid]\n[geometry]\n[output]\n'
                       '[simulation]\n')
        src = parse_params(cfg).source
        assert src.kind == "pencil"
        np.testing.assert_array_equal(src.params["direction"].numpy(), want)
    cfg.write_text('[source]\nname = "pencil"\nposition = [0, 0, 0]\n')
    with pytest.raises(ConfigError, match="direction"):
        parse_params(cfg)


def test_unported_source_kinds_raise(tmp_path):
    """Only the escape kernel's ``escape_points`` is still to port; the
    coherent sources build, and the image source needs a 2D spectrum."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsrc.build_source("escape_points", position=[0, 0, 0])
    for kind in ("dslit", "aperture"):
        assert tsrc.build_source(kind, position=[0, 0, 0]).kind == kind
    with pytest.raises(TypeError, match="2D spectrum"):
        tsrc.build_source("slm", position=[0, 0, 0])
    cfg = tmp_path / "c.toml"
    cfg.write_text('[source]\nname = "dslit"\n')
    with pytest.raises(ConfigError, match="position"):
        parse_params(cfg)
    cfg.write_text("[grid]\n")
    with pytest.raises(ConfigError):
        parse_params(cfg)


#: the four sources the chained walk carries and every beam subtype, with
#: frames that exercise both branches of each (the circular source's
#: mirrored x beam, the focus and annulus sources' b = -a mirror)
BEAMS = {
    "uniform": dict(point1=[-1.0, -1.0, 0.9999999], point2=[2.0, 0.0, 0.0],
                    point3=[0.0, 2.0, 0.0], direction=[0.0, 0.0, -1.0]),
    "uniform_faces": dict(point1=[-1.0, -0.5, 1.0], point2=[1.0, 0.0, 0.0],
                          point3=[0.0, 0.5, -2.0],
                          direction=[0.3, 0.2, -0.9]),
    "circular": dict(position=[0.1, -0.2, 0.3], direction=[0.0, 0.6, -0.8],
                     radius=0.4),
    "circular_x": dict(position=[-0.9, 0.0, 0.1], direction=[1.0, 0.0, 0.0],
                       radius=0.3),
    "focus_square": dict(position=[0.0, 0.0, 1.5], rotation=[0.2, 0.1, -1.0],
                         focalLength=1.2, beam_size=0.3,
                         focus_type="square"),
    "focus_circle": dict(position=[0.1, 0.0, 0.5],
                         rotation=[0.0, 0.0, -1.0], focalLength=-0.8,
                         beam_size=0.4, focus_type="circle"),
    "focus_gaussian": dict(position=[0.0, 0.2, -1.5],
                           rotation=[0.0, 0.0, 1.0], focalLength=1.0,
                           beam_size=0.2, focus_type="gaussian"),
    "annulus_tophat": dict(position=[0.0, 0.0, 1.5],
                           rotation=[0.1, -0.2, -1.0], focalLength=1.0,
                           rlo=0.3, rhi=0.5, annulus_type="tophat"),
    "annulus_besselAnnulus": dict(position=[0.2, 0.0, 0.8],
                                  rotation=[0.0, 0.0, 1.0], focalLength=0.7,
                                  rlo=0.2, rhi=0.4,
                                  annulus_type="besselAnnulus"),
    "annulus_gaussian": dict(position=[0.0, 0.0, 2.0],
                             rotation=[0.0, 0.0, -1.0], focalLength=1.5,
                             rlo=0.4, rhi=0.6, sigma=0.04,
                             annulus_type="gaussian"),
}


@pytest.mark.parametrize("case", sorted(BEAMS))
def test_beam_sources_match_reference(case):
    """uniform, circular, focus and annulus from the same uniforms: rtol
    1e-5, atol 1e-5 (a launch outside the grid is walked in along its
    direction, which divides a position difference by a direction
    component)."""
    kind = case.split("_")[0]
    params = BEAMS[case]
    js = jsrc.build_source(kind, **params)
    ts = tsrc.build_source(kind, **params)
    n = jsrc.n_source_uniforms(js)
    assert tsrc.n_source_uniforms(ts) == n
    u = np.random.default_rng(11).uniform(1e-7, 1.0 - 1e-7, (4096, n)).astype(
        np.float32)
    jout = jsrc.sample(js, jcart(16, 16, 16, 1.0, 1.0, 1.0), jnp.asarray(u))
    for src in (ts, interop.source_from_numpy(
            jax.tree_util.tree_map(np.asarray, js))):
        tout = tsrc.sample(src, tcart(16, 16, 16, 1.0, 1.0, 1.0),
                           torch.as_tensor(u))
        for what, t, j in zip(("pos", "dir", "phase", "wavelength"), tout,
                              jout):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                       atol=1e-5, err_msg=f"{case} {what}")
    pos = tout[0].numpy()
    assert np.all(np.abs(pos) < 1.0), case  # launched inside the grid
    np.testing.assert_allclose(np.linalg.norm(tout[1].numpy(), axis=-1), 1.0,
                               rtol=1e-5)


def test_beam_sources_parse_like_the_reference(tmp_path):
    """Each kind through ``[source]`` tables: the reference's parser and
    the port's build the same source."""
    from rsmcrt_tpu.config import parse_params as jparse

    tables = {
        "uniform": 'point1 = [-1.0, -1.0, 0.99]\npoint2 = [2.0, 0.0, 0.0]\n'
                   'point3 = [0.0, 2.0, 0.0]\ndirection = "-z"',
        "circular": 'position = [0.0, 0.0, 0.9]\ndirection = "x"\n'
                    'radius = 0.2',
        "focus": 'position = [0.0, 0.0, 0.9]\nrotation = [0.0, 1.0, -1.0]\n'
                 'focus_type = "square"\nbeam_size = 0.1',
        "annulus": 'position = [0.0, 0.0, 0.9]\nrotation = [0.0, 0.0, 2.0]\n'
                   'annulus_type = "tophat"\nrlo = 0.1\nrhi = 0.3',
    }
    for kind, body in tables.items():
        cfg = tmp_path / f"{kind}.toml"
        cfg.write_text(f'[source]\nname = "{kind}"\n{body}\n[grid]\n'
                       '[geometry]\n[output]\n[simulation]\n')
        j, t = jparse(cfg).source, parse_params(cfg).source
        assert (t.kind, t.subtype) == (j.kind, j.subtype)
        assert sorted(t.params) == sorted(j.params), kind
        for k, v in j.params.items():
            np.testing.assert_allclose(t.params[k].numpy(), np.asarray(v),
                                       rtol=1e-7, err_msg=f"{kind} {k}")
