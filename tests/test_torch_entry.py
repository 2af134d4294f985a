"""The port's entry-point plumbing against the JAX reference: TOML
parsing, the scene registry, output files and the command line."""

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import rsmcrt_tpu.kernels as jk
from rsmcrt_tpu.config import parse_params as jparse
from rsmcrt_tpu.io import writer as jw
from rsmcrt_tpu.sdfs import scene as jS
from rsmcrt_tpu_torch import kernels as tk
from rsmcrt_tpu_torch.config import ConfigError, parse_params as tparse
from rsmcrt_tpu_torch.io import tev as ttev
from rsmcrt_tpu_torch.io import writer as tw
from rsmcrt_tpu_torch.sdfs import scene as tS
from torch_fake_tev import FakeTevServer, check_tev_run, tev_sphere

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

SETTINGS = ("nphotons", "iseed", "experiment", "outfile", "outfile_absorb",
            "rendersourcefile", "source", "overwrite", "absorb", "ckptfreq",
            "ckptfile", "loadckpt", "roulette_bounces", "roulette_chance",
            "units", "render_geom", "tev", "phasor")


PARSED = ["sphere.toml", "scat_test.toml", "omg.toml", "egg_test.toml",
          "lens.toml", "exp.toml", "aptran.toml", "scat_test2.toml",
          "validation2.toml", "validation3.toml", "thinBarrier.toml"]


@pytest.mark.parametrize("name", PARSED)
def test_parse_matches_reference(name):
    j = jparse(ROOT / "res" / name)
    t = tparse(ROOT / "res" / name)
    for f in SETTINGS:
        assert getattr(t.settings, f) == getattr(j.settings, f), f
    jg, tg = j.settings.grid, t.settings.grid
    assert tg.shape == (jg.nxg, jg.nyg, jg.nzg)
    for f in ("xmax", "ymax", "zmax"):
        assert getattr(tg, f) == float(getattr(jg, f))
    for k, v in j.geometry.items():
        if k in t.geometry:
            np.testing.assert_allclose(t.geometry[k], v)
    assert t.source.kind == j.source.kind
    assert t.source.subtype == j.source.subtype
    assert sorted(t.source.params) == sorted(j.source.params)
    for k, v in j.source.params.items():
        np.testing.assert_array_equal(t.source.params[k].numpy(),
                                      np.asarray(v), err_msg=k)
    assert float(t.spectrum.value) == float(j.spectrum.value)
    assert (t.detectors is None) == (j.detectors is None)


@pytest.mark.parametrize("name", ["sphere.toml", "scat_test.toml"])
def test_setup_builds_the_reference_scene(name):
    jp, js = jk.setup(ROOT / "res" / name)
    tp, ts = tk.setup(ROOT / "res" / name, device="cpu")
    assert ts.perm == js.perm and ts.layer_ids == js.layer_ids
    assert [s.kind for s in ts.specs] == [s.kind for s in js.specs]
    for f in ("mus", "mua", "hgg", "n", "kappa", "albedo"):
        np.testing.assert_array_equal(getattr(ts.tables, f).numpy(),
                                      np.asarray(getattr(js.tables, f)))
    p = np.random.default_rng(8).uniform(-1.1, 1.1, (1024, 3)).astype(
        np.float32)
    np.testing.assert_allclose(
        tS.eval_scene(ts, torch.as_tensor(p)).numpy(),
        np.asarray(jS.eval_scene(js, p)), rtol=1e-6, atol=1e-6)


BASE = """
[source]
name = "{src}"
nphotons = 100
position = [0.0, 0.0, 0.0]
{extra_source}
[grid]
nxg = 8
nyg = 8
nzg = 8
[geometry]
geom_name = "{geom}"
numOptProp = {num}
[output]
fluence = "out.nrrd"
[simulation]
iseed = 3
{extra}
"""


@pytest.mark.parametrize("fields,err", [
    (dict(geom="sphere", num=2), ConfigError),
    # the reference's error paths for the coherent and image sources and
    # the spectra (rsmcrt_tpu/config.py:111-143, sources.py:375-379)
    (dict(src="dslit"), ConfigError),
    (dict(extra_source='spectrum_type = "1D"'), ConfigError),
    (dict(extra_source='spectrum_type = "bogus"'), ConfigError),
    (dict(src="slm", extra_source='rotation = [0.0, 0.0, 1.0]\n'
          'direction = "-z"'), TypeError),
    # the reference's error paths for the ported sources and scenes
    # (tests/test_parse.py, rsmcrt_tpu/config.py:221-340)
    (dict(geom="egg", num=2), ConfigError),
    (dict(src="uniform", extra_source='point1 = [0.0, 0.0, 0.0]\n'
          'point2 = [1.0, 0.0, 0.0]'), ConfigError),
    (dict(src="focus"), ConfigError),
    (dict(src="annulus", extra_source="rotation = [0.0, 0.0, 0.0]"),
     ConfigError),
    (dict(src="circular"), ConfigError),
    (dict(src="uniform", extra_source='direction = "w"'), ConfigError),
    (dict(src="focus", extra_source='rotation = [0.0, 0.0, 1.0]\n'
          'focus_type = "hexagon"'), ValueError),
])
def test_parse_errors(tmp_path, fields, err):
    body = dict(geom="scat_test", num=1, extra="", extra_source="",
                src="point")
    body.update(fields)
    cfg = tmp_path / "c.toml"
    cfg.write_text(BASE.format(**body))
    with pytest.raises(err):
        tk.setup(cfg, device="cpu")


def test_unported_kernels_raise(tmp_path, monkeypatch):
    """The escape and inverse kernels' tables parse, and the live tev
    viewer, the last piece once unported, runs: a run with ``tev = true``
    sends a fake viewer its slices."""
    st = tparse(ROOT / "res" / "escape_test.toml", kernel="escape").settings
    assert st.symmetry_type == "360rotational" and st.nphotons == 2000
    st = tparse(ROOT / "res" / "inverse_test.toml", kernel="inverse").settings
    assert st.inverse["layer"] == 1 and st.inverse["Findmua"]
    srv = FakeTevServer()
    monkeypatch.setattr(ttev, "TevIPC",
                        functools.partial(ttev.TevIPC, port=srv.port))
    parsed, scene = tk.setup(tev_sphere(tmp_path, nphotons=10),
                             device="cpu")
    res = tk.run_MCRT(parsed, scene, nphotons=10)
    srv.join()
    assert res.launched == 10
    check_tev_run(srv, res, (len(srv.packets) - 2) // 3)


def test_writer_files_match_reference(tmp_path):
    vol = np.random.default_rng(9).uniform(0, 1, (6, 5, 4)).astype(
        np.float32)
    meta = {"nphotons": 10, "source": "point", "flag": True}
    jp = jw.write_nrrd(vol, tmp_path / "j.nrrd", metadata=meta)
    tp = tw.write_nrrd(vol, tmp_path / "t.nrrd", metadata=meta)
    assert Path(jp).read_bytes() == Path(tp).read_bytes()
    back, _ = tw.read_nrrd(tp)
    np.testing.assert_array_equal(back, vol)
    jw.write_checkpoint("a.toml", tmp_path / "j.ckpt", 7, vol)
    tw.write_checkpoint("a.toml", tmp_path / "t.ckpt", 7, vol)
    assert (tmp_path / "j.ckpt").read_bytes() == \
        (tmp_path / "t.ckpt").read_bytes()
    name, n, jm = tw.read_checkpoint(tmp_path / "t.ckpt", vol.shape)
    assert (name, n) == ("a.toml", 7)
    np.testing.assert_array_equal(jm, vol)


def test_display_settings_matches_reference():
    cfg = ROOT / "res" / "sphere.toml"
    assert tk.display_settings(tparse(cfg), cfg) == \
        jk.display_settings(jparse(cfg), cfg)


def test_cli_runs_the_forward_kernel(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    cfg = tmp_path / "c.toml"
    cfg.write_text(BASE.format(geom="sphere", num=1, extra="", src="point",
                               extra_source=""))
    res = subprocess.run(
        [sys.executable, "-m", "rsmcrt_tpu_torch.cli", "--device", "cpu",
         "--nphotons", "300", "--lanes", "256", "--data-dir",
         str(tmp_path / "data"), str(cfg)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "Average # of scatters per photon" in res.stdout
    vol, _ = tw.read_nrrd(tmp_path / "data" / "jmean" / "out.nrrd")
    assert vol.shape == (8, 8, 8) and vol.sum() > 0


def test_default_device_is_the_card(monkeypatch):
    """Without a visible card an entry point refuses to run rather than
    fall back to the CPU; ``device="cpu"`` still runs there."""
    import rsmcrt_tpu_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        rsmcrt_tpu_torch.default_device()
    cfg = ROOT / "res" / "scat_test.toml"
    for call in (lambda: tk.setup(cfg), lambda: tk.default_lanes(100),
                 lambda: tk.fast_path_defaults(),
                 lambda: tk.default_MCRT(cfg, verbose=False)):
        with pytest.raises(RuntimeError, match="--device cpu"):
            call()
    assert tk.default_lanes(100, device="cpu") == 256
    assert tk.setup(cfg, device="cpu")[1].device.type == "cpu"
