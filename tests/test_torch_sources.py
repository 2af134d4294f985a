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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsrc.build_source("uniform", position=[0, 0, 0])
    cfg = tmp_path / "c.toml"
    cfg.write_text('[source]\nname = "uniform"\n')
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        parse_params(cfg)
    cfg.write_text("[grid]\n")
    with pytest.raises(ConfigError):
        parse_params(cfg)
