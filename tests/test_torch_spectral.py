"""Spectral optics of the PyTorch port against the JAX reference: the
piecewise spectrum builders and samplers, the three spectra configs and
the PNG decoder, spectrum sampling at the source, and the spectral scene
tables with their per-photon lookup.

Tolerances: builders and samplers rtol 1e-6 (both store float32 CDFs built
in float64; a float32 interpolation differs in the last bit at most), 2D
pixel indices equal; spectrum samples through a source rtol 1e-6, atol
1e-6; spectral tables and ``_opt_lookup`` rtol 1e-6, atol 1e-6.  The PNG
decoder must return the same array exactly.

The JAX loader takes PIL where it is installed and then returns the
image untransposed; its own zlib path, which the port always takes (so
that it needs no PIL), returns ``[width, height]``.  The tests compare
against that zlib path, with PIL hidden from the reference.
"""

import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rsmcrt_tpu import config as jcfg
from rsmcrt_tpu.grid import cart_grid as jcart
from rsmcrt_tpu.optics import piecewise as jpw
from rsmcrt_tpu.optics.properties import SpectralOptProps as JSpectral
from rsmcrt_tpu.optics.properties import mono as jmono
from rsmcrt_tpu.sdfs import scene as JS
from rsmcrt_tpu.sources import sources as jsrc
from rsmcrt_tpu.transport import engine as je
from rsmcrt_tpu_torch import config as tcfg
from rsmcrt_tpu_torch import interop
from rsmcrt_tpu_torch.grid import cart_grid as tcart
from rsmcrt_tpu_torch.optics import piecewise as tpw
from rsmcrt_tpu_torch.optics.properties import SpectralOptProps as TSpectral
from rsmcrt_tpu_torch.optics.properties import mono as tmono
from rsmcrt_tpu_torch.sdfs import scene as TS
from rsmcrt_tpu_torch.sources import sources as tsrc
from rsmcrt_tpu_torch.transport import engine as te

torch.set_num_threads(1)

RES = Path(__file__).resolve().parents[1] / "res"


@pytest.fixture
def no_pil(monkeypatch):
    """Hide PIL, so the JAX loader takes its zlib path."""
    monkeypatch.setitem(sys.modules, "PIL", None)


def _tables_1d():
    blood = np.loadtxt(RES / "blood.dat", delimiter=",")
    rng = np.random.default_rng(3)
    x = np.cumsum(rng.uniform(0.5, 2.0, 40)) + 300.0
    y = rng.uniform(0.0, 5.0, 40)
    y[10:14] = 0.0  # a flat stretch of the CDF
    return {"blood": blood, "random": np.stack([x, y], axis=1)}


@pytest.mark.parametrize("name", ["blood", "random"])
def test_piecewise1d_matches_reference(name):
    arr = _tables_1d()[name]
    jt, tt = jpw.piecewise1d(arr), tpw.piecewise1d(arr)
    for f in ("x", "y", "cdf"):
        np.testing.assert_allclose(getattr(tt, f).numpy(),
                                   np.asarray(getattr(jt, f)), rtol=1e-6)
    rng = np.random.default_rng(5)
    # uniforms, plus the CDF's own nodes (searchsorted side "right")
    u = np.concatenate([rng.uniform(0.0, 1.0, 4096),
                        np.asarray(jt.cdf)]).astype(np.float32)
    np.testing.assert_allclose(
        tpw.sample_piecewise1d(tt, torch.as_tensor(u)).numpy(),
        np.asarray(jpw.sample_piecewise1d(jt, jnp.asarray(u))), rtol=1e-6)
    # x inside, on the nodes and beyond both ends
    x0, x1 = float(arr[0, 0]), float(arr[-1, 0])
    x = np.concatenate([rng.uniform(x0 - 20.0, x1 + 20.0, 4096),
                        np.asarray(jt.x)]).astype(np.float32)
    np.testing.assert_allclose(
        tpw.sample_piecewise1d_at(tt, torch.as_tensor(x)).numpy(),
        np.asarray(jpw.sample_piecewise1d_at(jt, jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)


def test_piecewise2d_matches_reference(no_pil):
    img = jcfg._load_png_grey(RES / "spectrum2D.png")
    jt, tt = jpw.piecewise2d(0.5, 0.25, img), tpw.piecewise2d(0.5, 0.25, img)
    assert (tt.width, tt.height) == (jt.width, jt.height)
    np.testing.assert_allclose(tt.cdf.numpy(), np.asarray(jt.cdf), rtol=1e-6)
    rng = np.random.default_rng(6)
    u = np.concatenate([rng.uniform(0.0, 1.0, 4096),
                        np.asarray(jt.cdf)[::7]]).astype(np.float32)
    half = np.full_like(u, 0.5)
    # no jitter: the pixel indices themselves, equal
    for t, j in zip(tpw.sample_piecewise2d(tt, *map(torch.as_tensor,
                                                    (u, half, half))),
                    jpw.sample_piecewise2d(jt, *map(jnp.asarray,
                                                    (u, half, half)))):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    ux, uy = rng.uniform(0.0, 1.0, (2, u.size)).astype(np.float32)
    for t, j in zip(tpw.sample_piecewise2d(tt, *map(torch.as_tensor,
                                                    (u, ux, uy))),
                    jpw.sample_piecewise2d(jt, *map(jnp.asarray,
                                                    (u, ux, uy)))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
    with pytest.raises(ValueError, match="no positive intensity"):
        tpw.piecewise2d(1.0, 1.0, np.zeros((4, 4)))


def _png(rows, width, colortype):
    """An 8-bit PNG of the given filtered scanlines (filter byte first)."""
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    head = struct.pack(">IIBBBBB", width, len(rows), 8, colortype, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", head)
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def test_png_decoder_matches_reference_loader(no_pil, tmp_path):
    """res/spectrum2D.png and a 7x10 RGB image whose rows use every PNG
    filter (0-4) with random bytes: the port's decoder returns exactly the
    JAX loader's zlib-path array, ``[width, height]``."""
    got = tcfg._load_png_grey(RES / "spectrum2D.png")
    want = jcfg._load_png_grey(RES / "spectrum2D.png")
    assert got.shape == (64, 64) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(8)
    width = 7
    rows = [bytes([r % 5]) + rng.integers(0, 256, 3 * width,
                                          dtype=np.uint8).tobytes()
            for r in range(10)]
    path = tmp_path / "filters.png"
    path.write_bytes(_png(rows, width, 2))
    got = tcfg._load_png_grey(path)
    assert got.shape == (width, 10)
    np.testing.assert_array_equal(got, jcfg._load_png_grey(path))


def _spectrum_fields(sp):
    if hasattr(sp, "value"):
        return {"value": sp.value}
    if hasattr(sp, "width"):
        return {"cdf": sp.cdf, "width": sp.width, "height": sp.height,
                "cell_width": sp.cell_width, "cell_height": sp.cell_height}
    return {"x": sp.x, "y": sp.y, "cdf": sp.cdf}


@pytest.mark.parametrize("kind", ["1D", "2D", "const"])
def test_spectra_configs_parse_like_reference(no_pil, kind):
    toml = RES / f"test_spectra_{kind}.toml"
    j, t = jcfg.parse_params(toml), tcfg.parse_params(toml, device="cpu")
    assert type(t.source.spectrum).__name__ == \
        type(j.source.spectrum).__name__
    jf, tf = (_spectrum_fields(s.source.spectrum) for s in (j, t))
    assert sorted(jf) == sorted(tf)
    for k, v in jf.items():
        np.testing.assert_allclose(np.asarray(tf[k]), np.asarray(v),
                                   rtol=1e-6, err_msg=f"{kind} {k}")
    assert tsrc.n_source_uniforms(t.source) == \
        jsrc.n_source_uniforms(j.source)


@pytest.mark.parametrize("kind", ["1D", "2D"])
def test_spectrum_sampling_matches_reference(no_pil, kind):
    """A point source with the config's spectrum, from the same uniforms
    (a 2D spectrum jitters with the last two columns)."""
    toml = RES / f"test_spectra_{kind}.toml"
    js = jcfg.parse_params(toml).source
    ts = tcfg.parse_params(toml, device="cpu").source
    n = jsrc.n_source_uniforms(js)
    u = np.random.default_rng(12).uniform(1e-7, 1.0, (4096, n)).astype(
        np.float32)
    jout = jsrc.sample(js, jcart(16, 16, 16, 1.0, 1.0, 1.0), jnp.asarray(u))
    tout = tsrc.sample(ts, tcart(16, 16, 16, 1.0, 1.0, 1.0),
                       torch.as_tensor(u))
    for what, t, j in zip(("pos", "dir", "phase", "wavelength"), tout, jout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6, err_msg=f"{kind} {what}")
    wl = tout[3].numpy()
    assert wl.min() < wl.max()  # wavelengths really vary


def _spectral_scene(pkg):
    """A sphere whose mus, mua, g and n vary over 400-700 nm next to a
    monochromatic box, and a second spectral prim on a narrower band."""
    pw, Spec, mono, S = pkg
    wl = [400.0, 550.0, 700.0]

    def tab(*ys, x=wl):
        return pw.piecewise1d(np.stack([x, ys], axis=1))

    a = Spec(mus_tab=tab(5.0, 12.0, 10.0), mua_tab=tab(0.1, 0.3, 0.2),
             hgg_tab=tab(0.5, 0.7, 0.9), n_tab=tab(1.3, 1.4, 1.5),
             flux=tab(1.0, 1.0, 1.0))
    band = [450.0, 650.0]
    b = Spec(mus_tab=tab(2.0, 3.0, x=band), mua_tab=tab(1.0, 0.5, x=band),
             hgg_tab=tab(0.0, 0.2, x=band), n_tab=tab(1.2, 1.2, x=band),
             flux=tab(1.0, 1.0, x=band))
    return S.build_scene([S.sphere(0.4, a, 1),
                          S.box([0.5, 0.5, 0.5], b, 2),
                          S.box([2.0, 2.0, 2.0], mono(1.0, 0.0, 0.0, 1.0),
                                3)])


def test_spectral_scene_tables_and_lookup_match_reference():
    js = _spectral_scene((jpw, JSpectral, jmono, JS))
    ts = _spectral_scene((tpw, TSpectral, tmono, TS))
    assert tuple(ts.tables.mus.shape) == tuple(js.tables.mus.shape) \
        == (64, 4)
    for f in ("wavelengths", "mus", "mua", "hgg", "n", "kappa", "albedo"):
        np.testing.assert_allclose(getattr(ts.tables, f).numpy(),
                                   np.asarray(getattr(js.tables, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    # the JAX scene carried across: the same tables
    cs = interop.scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    np.testing.assert_array_equal(cs.tables.mus.numpy(),
                                  np.asarray(js.tables.mus))
    rng = np.random.default_rng(13)
    n = 4096
    layer = rng.integers(0, 4, n).astype(np.int32)
    wl = np.concatenate([rng.uniform(380.0, 720.0, n - 64),
                         np.asarray(js.tables.wavelengths)]).astype(
        np.float32)
    opt = np.stack([np.asarray(js.tables.kappa), np.asarray(js.tables.n)],
                   axis=-1)
    for arr_j, arr_t in ((js.tables.kappa, ts.tables.kappa),
                         (js.tables.hgg, ts.tables.hgg),
                         (jnp.asarray(opt), torch.as_tensor(opt))):
        want = np.asarray(je._opt_lookup(js.tables, arr_j,
                                         jnp.asarray(layer),
                                         jnp.asarray(wl)))
        got = te._opt_lookup(ts.tables, arr_t, torch.as_tensor(layer),
                             torch.as_tensor(wl)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

