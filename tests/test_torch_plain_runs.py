"""Whole runs of the port's plain walk and its options on the CPU, gated
statistically at small sizes:

- the port's plain walk against the JAX plain walk on the sphere at 32^3
  (the same physics from different random streams: nscatt/photon and
  path/photon within 5%, absorbed weight within 5 sigma, the z-profile of
  the fluence within 10% in L1);
- the port's plain walk against its chained walk on the same sphere
  (tests/test_chain.py's gates: fewer megasteps and segment analyses
  chained, tallies within 5%);
- res/dslit.toml's double slit cut to 128 x 4 x 8 and 60,000 photons: the
  coherent intensity near the entry plane is modulated more than 1.5x the
  incoherent fluence (tests/test_phasor.py's gate);
- survival bias against analog transport (tests/test_survival_bias.py's
  gates);
- the ``test`` kernel on res/scat_test2.toml at 20,000 photons: the
  scatter-position moments of Table 7 (test_scat.f90:53-63) at the
  reference's tolerances widened by sqrt(5) for 5x fewer photons than its
  1e5, and its ``nscatt.dat`` / ``positions.dat``;
- the CLI's ``--survival-bias`` and ``--kernel test``, and the kernels it
  still refuses.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from rsmcrt_tpu.grid import cart_grid as jcart
from rsmcrt_tpu.optics.properties import mono as jmono
from rsmcrt_tpu.sdfs import scene as JS
from rsmcrt_tpu.sources.sources import build_source as jbuild
from rsmcrt_tpu.transport import engine as je
from rsmcrt_tpu_torch import cli, kernels
from rsmcrt_tpu_torch.grid import cart_grid
from rsmcrt_tpu_torch.optics.piecewise import Constant
from rsmcrt_tpu_torch.optics.properties import mono
from rsmcrt_tpu_torch.sdfs import scene as S
from rsmcrt_tpu_torch.sources.sources import build_source
from rsmcrt_tpu_torch.transport import engine as te

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _sphere(pkg, opt):
    S_, mono_ = pkg
    return S_.build_scene([S_.sphere(1.0, mono_(*opt), 1),
                           S_.box([2.0, 2.0, 2.0], mono_(0.0, 0.0, 0.0, 1.0),
                                  2)])


def _port_run(scene, grid, src, seed=3, n=4000, lanes=512, **kw):
    cfg = te.TransportConfig(nphotons=n, n_lanes=lanes, dda_substeps=8,
                             **kw)
    gen = torch.Generator().manual_seed(seed)
    tl, _, launched, steps = te.simulate(scene, src, grid, gen, cfg,
                                         chunk_steps=64)
    assert int(launched) == n
    return tl, int(steps)


def _stats(tl, n, g):
    jm = np.asarray(tl.jmean, np.float64)
    prof = jm.reshape(g, g, g).sum(axis=(0, 1))
    return (float(tl.nscatt) / n, jm.sum() / n,
            float(np.asarray(tl.absorb, np.float64).sum()), prof / n)


BENCH = (10.0, 0.1, 0.9, 1.38)
G = 32


@pytest.fixture(scope="module")
def port_plain_sphere():
    """The port's plain walk on the sphere at 32^3, 4000 photons."""
    return _port_run(_sphere((S, mono), BENCH), cart_grid(G, G, G, 1.0, 1.0,
                                                          1.0),
                     build_source("point", position=[0.0, 0.0, 0.0]))


def test_plain_walk_matches_reference_plain_walk(port_plain_sphere):
    n, g = 4000, G
    cfg = je.TransportConfig(nphotons=n, n_lanes=512, dda_substeps=8)
    jt, _, jn, _ = je.simulate(_sphere((JS, jmono), BENCH),
                               jbuild("point", position=[0.0, 0.0, 0.0]),
                               jcart(g, g, g, 1.0, 1.0, 1.0),
                               jax.random.key(3), cfg, chunk_steps=64)
    assert int(jn) == n
    tt, _ = port_plain_sphere
    a = _stats(jax.tree_util.tree_map(np.asarray, jt), n, g)
    b = _stats(tt, n, g)
    assert abs(a[0] - b[0]) / a[0] < 0.05, (a[0], b[0])
    assert abs(a[1] - b[1]) / a[1] < 0.05, (a[1], b[1])
    assert abs(a[2] - b[2]) < 5.0 * max(np.sqrt(a[2]), 1.0), (a[2], b[2])
    assert np.abs(a[3] - b[3]).sum() / a[3].sum() < 0.1


def test_plain_walk_matches_chained_walk(port_plain_sphere):
    g = G
    t0, s0 = port_plain_sphere
    t1, s1 = _port_run(_sphere((S, mono), BENCH),
                       cart_grid(g, g, g, 1.0, 1.0, 1.0),
                       build_source("point", position=[0.0, 0.0, 0.0]),
                       lanes=4096, chain_scatter=True)
    assert s1 < s0  # chaining consumes interactions inside the walk
    assert int(t1.perf[2]) < 0.5 * int(t0.perf[2])
    a, b = _stats(t0, 4000, g), _stats(t1, 4000, g)
    assert abs(a[0] - b[0]) / a[0] < 0.05, (a[0], b[0])
    assert abs(a[1] - b[1]) / a[1] < 0.05, (a[1], b[1])
    assert abs(a[2] - b[2]) < 5.0 * max(np.sqrt(a[2]), 1.0), (a[2], b[2])
    assert np.abs(a[3] - b[3]).sum() / a[3].sum() < 0.1


def test_dslit_makes_fringes(tmp_path):
    toml = tmp_path / "dslit.toml"
    text = (ROOT / "res" / "dslit.toml").read_text()
    text = re.sub(r"nphotons = \d+", "nphotons = 60000", text)
    toml.write_text(text.replace("nxg = 320", "nxg = 128"))
    parsed, scene = kernels.setup(toml, device="cpu")
    cfg = te.TransportConfig(nphotons=1, record_phasor=True,
                             **kernels.fast_path_defaults(device="cpu"))
    assert not cfg.chains(scene)  # the phasor takes the plain walk
    res = kernels.run_MCRT(parsed, scene, n_lanes=8192)
    assert res.launched == 60000
    shape = (128, 4, 8)
    re_ = res.tallies.phasor_re.double().numpy().reshape(shape)
    im_ = res.tallies.phasor_im.double().numpy().reshape(shape)
    # the field near the entry plane, central y
    inten = (re_ ** 2 + im_ ** 2)[:, 1:3, :].sum(axis=(1, 2))
    incoh = res.tallies.jmean.double().numpy().reshape(shape)[
        :, 1:3, :].sum(axis=(1, 2))
    assert inten.sum() > 0.0
    assert (res.tallies.phasor_re.numpy() < 0.0).any()  # signed cells
    mid = slice(32, 96)
    contrast = inten[mid].std() / max(inten[mid].mean(), 1e-12)
    base = incoh[mid].std() / max(incoh[mid].mean(), 1e-12)
    assert contrast > 1.5 * base, (contrast, base)
    kernels.finalise(res, data_dir=tmp_path / "data", verbose=False)
    for name in ("phasor", "phasor_re", "phasor_im"):
        assert (tmp_path / "data" / "phasor" / f"{name}.nrrd").exists()


def test_survival_bias_matches_analog():
    scene = _sphere((S, mono), (5.0, 0.5, 0.5, 1.0))
    grid = cart_grid(32, 32, 32, 1.0, 1.0, 1.0)
    src = build_source("point", position=[0.0, 0.0, 0.0])
    out = {}
    for sb in (False, True):
        tl, _ = _port_run(scene, grid, src, seed=11, n=6000, lanes=2048,
                          survival_bias=sb, chain_scatter=True)
        out[sb] = (float(tl.jmean.double().sum()) / 6000,
                   float(tl.absorb.double().sum()) / 6000)
    (j_a, a_a), (j_b, a_b) = out[False], out[True]
    assert abs(j_a - j_b) / j_a < 0.05, (j_a, j_b)
    assert abs(a_a - a_b) < 0.06, (a_a, a_b)
    assert 0.1 < a_b < 0.9


def test_test_kernel_moments_on_scat_test2(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the kernel writes its files here
    out = kernels.test_kernel(ROOT / "res" / "scat_test2.toml",
                              nphotons=20000, device="cpu")
    m1, m2 = out["moments1"], out["moments2"]
    expect_m1 = np.array([1.0, 1.9, 2.71, 3.349])
    expect_m2 = np.array([[0.0, 0.0, 2.0],
                          [0.1266666, 0.1266666, 5.5466666],
                          [0.469933, 0.469933, 10.28013],
                          [1.091246, 1.091246, 15.91551]])
    w = np.sqrt(5.0)
    assert np.all(np.abs(m1[:, :2]) < 0.1 * w), m1
    assert np.all(np.abs(m1[:, 2] - expect_m1) < 0.143 * w), m1
    assert np.all(np.abs(m2 - expect_m2) < 0.15 * w), m2
    # end_early stops every photon at its 5th scatter, which is counted
    # (kernelsMod.f90:2161-2163)
    assert out["nscatt"] == 5.0
    lines = (tmp_path / "positions.dat").read_text().splitlines()
    assert len(lines) == 8
    np.testing.assert_allclose(np.loadtxt(lines), np.concatenate([m1, m2]),
                               rtol=1e-6)
    assert float((tmp_path / "nscatt.dat").read_text()) == out["nscatt"]


def test_cli_runs_the_new_options(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    slab = ROOT / "res" / "validation1.toml"
    seen = {}
    real = kernels.run_MCRT

    def spy(*a, **k):
        seen.update(k)
        return real(*a, **k)

    monkeypatch.setattr(kernels, "run_MCRT", spy)
    assert cli.main(["--device", "cpu", "--nphotons", "300",
                     "--survival-bias", "--data-dir", str(tmp_path / "d"),
                     str(slab)]) == 0
    assert seen["survival_bias"] is True
    assert (tmp_path / "d" / "detectors").exists()
    assert cli.main(["--device", "cpu", "--nphotons", "500", "--kernel",
                     "test", str(ROOT / "res" / "scat_test2.toml")]) == 0
    assert "nscatt/photon" in capsys.readouterr().out
    assert (tmp_path / "positions.dat").exists()
    # the escape and inverse kernels dispatch to their entry points
    from rsmcrt_tpu_torch import escape, inverse

    calls = []
    monkeypatch.setattr(escape, "escape_function",
                        lambda *a, **k: calls.append(("escape", a, k)))
    monkeypatch.setattr(inverse, "inverse_MCRT",
                        lambda *a, **k: calls.append(("inverse", a, k)))
    for kernel in ("escape", "inverse"):
        assert cli.main(["--device", "cpu", "--kernel", kernel,
                         str(slab)]) == 0
    assert [c[0] for c in calls] == ["escape", "inverse"]
    assert all(c[2]["device"] == "cpu" for c in calls)
    # check_ported: escape and inverse configurations pass
    cfg = te.TransportConfig(nphotons=1)
    for opt in (dict(escape_shape=(2, 1)), dict(inverse_prim=1)):
        dataclasses.replace(cfg, **opt).check_ported()


def test_coherent_source_phase_is_used_as_launched():
    """The dslit launch phase enters the phasor: a source whose launch
    phase is zeroed gives a different field."""
    scene = S.build_scene([S.box([12.0, 12.0, 12.0],
                                 mono(0.0, 200.0, 0.0, 1.0), 1)])
    grid = cart_grid(32, 4, 8, 5.0, 6.0, 6.0)
    src = build_source("dslit", position=[0.0, 0.0, 0.0],
                       spectrum=Constant(torch.tensor(500e-9)))
    tl, _ = _port_run(scene, grid, src, n=2048, lanes=2048,
                      record_phasor=True)
    assert int(torch.count_nonzero(tl.phasor_re)) > 0
    re_ = tl.phasor_re.double()
    im_ = tl.phasor_im.double()
    # |E| per photon is at most 1: sum |E|^2 is bounded by n^2, and far
    # below it (the phases are spread)
    assert float((re_ ** 2 + im_ ** 2).sum()) < 0.5 * 2048 ** 2
