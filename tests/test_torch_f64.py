"""float64 transport in the port, against the JAX package under x64.

- One float64 megastep lane by lane (``tests/torch_f64_worker.py``, in a
  child process because ``jax_enable_x64`` is process-global): the bench
  sphere at eps = 1e-8, built in float64 by the JAX package and carried
  over with ``interop``.  Integer lane fields agree on >= 99% of lanes;
  float fields agree to 1e-9 of ``max(|want|, 1)`` on agreeing lanes,
  surface events included (the float64 step agrees to ~2e-14); the
  tallies are float64 and their sums agree to rel 1e-9.
- The port's own float64 builders (``cart_grid``, ``mono``,
  ``build_scene``, ``build_source`` with ``dtype=torch.float64``) give a
  float64 run end to end: float64 tallies and draws, eps = 1e-8 kept as
  it is, every deposit a float64 one.
- ``-m slow``: the whole-run gates of tests/test_f64.py on the port (the
  nscatt law in float64 at eps = 1e-8, and the float64 refractive sphere
  within 5% of the float32 one).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rsmcrt_tpu_torch.grid import cart_grid
from rsmcrt_tpu_torch.optics.properties import mono
from rsmcrt_tpu_torch.sdfs import scene as S
from rsmcrt_tpu_torch.sources.sources import build_source
from rsmcrt_tpu_torch.transport import deposit as tdep
from rsmcrt_tpu_torch.transport import engine as te

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
F64 = torch.float64


def test_one_f64_megastep_matches_reference(tmp_path):
    out = tmp_path / "f64.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    p = subprocess.run(
        [sys.executable, str(Path(__file__).parent / "torch_f64_worker.py"),
         str(out)], env=env, capture_output=True, timeout=600)
    assert p.returncode == 0, p.stderr.decode()[-3000:]
    r = json.loads(out.read_text())
    assert set(r["dtypes"].values()) == {"float64"}, r["dtypes"]
    assert r["tally_dtype"] == "float64"
    assert r["alive_share"] > 0.2  # lanes are mid-flight
    for f, share in r["same"].items():
        assert share >= 0.99, (f, share)
    assert r["surface_lanes"] > 0  # the step crossed surfaces
    for f, (quiet, every) in r["rel"].items():
        assert every <= 1e-9, (f, quiet, every)
    for f, (got, want) in r["sums"].items():
        assert abs(got - want) <= 1e-9 * abs(want), (f, got, want)
    assert r["launched"][0] == r["launched"][1]
    assert r["nscatt"][0] == r["nscatt"][1]


def _sphere_f64(mus, mua, hgg, n, dtype=F64):
    return S.build_scene([
        S.sphere(1.0, mono(mus, mua, hgg, n, dtype=dtype), 1, dtype=dtype),
        S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0, dtype=dtype), 2,
              dtype=dtype),
    ], dtype=dtype)


def test_f64_builders_run_in_f64(monkeypatch):
    """A scene, grid and source built in float64 run in float64: the
    carry, the draws and the tallies are float64, eps stays 1e-8, and
    every deposit hands the deposit wrapper float64 values."""
    scene = _sphere_f64(10.0, 0.1, 0.9, 1.38)
    grid = cart_grid(8, 8, 8, 1.0, 1.0, 1.0, dtype=F64)
    src = build_source("point", position=[0.0, 0.0, 0.0], dtype=F64)
    assert scene.tables.mus.dtype == F64 and grid.voxel_size.dtype == F64
    assert src.params["position"].dtype == F64
    assert te._scalars(te.TransportConfig(nphotons=1, eps=1e-8),
                       F64)[0] == 1e-8
    seen = []
    real = te.deposit_add_

    def spy(tally, idx, val, *a, **k):
        seen.append((tally.dtype, val.dtype))
        return real(tally, idx, val, *a, **k)

    monkeypatch.setattr(te, "deposit_add_", spy)
    cfg = te.TransportConfig(nphotons=300, n_lanes=128, chain_scatter=True,
                             record_emission=True, eps=1e-8)
    tl, _, n, _ = te.simulate(scene, src, grid,
                              torch.Generator().manual_seed(2), cfg)
    assert int(n) == 300
    assert tl.jmean.dtype == F64 and tl.nscatt.dtype == F64
    assert seen and set(seen) == {(F64, F64)}
    assert float(tl.jmean.sum()) > 0 and bool(torch.isfinite(tl.jmean).all())
    d = te.draw_step(torch.Generator(), 4, cfg, src, "cpu", scene, F64)
    assert d.u_all.dtype == F64 and d.uc.dtype == F64


def test_deposit_dtype_rules():
    """float64 tallies take float64 values and float32 tallies float32,
    nothing mixed; bfloat16 has no float64 deposit; the float64 plain
    twin sums in float64."""
    idx = torch.tensor([0, 2, 2], dtype=torch.int32)
    with pytest.raises(TypeError):
        tdep.deposit_add_(torch.zeros(4, dtype=F64), idx, torch.ones(3))
    with pytest.raises(TypeError):
        tdep.deposit_add_(torch.zeros(4), idx, torch.ones(3, dtype=F64))
    with pytest.raises(TypeError):
        tdep.deposit_add_(torch.zeros(4, dtype=F64), idx,
                          torch.ones(3, dtype=F64), torch.bfloat16)
    # 2^-40 is below float32's resolution at 1, not float64's
    val = torch.tensor([1.0, 2.0 ** -40, 1.0], dtype=F64)
    out = tdep.deposit_add_(torch.zeros(4, dtype=F64), idx, val)
    assert out.dtype == F64
    np.testing.assert_array_equal(out.numpy(),
                                  [1.0, 0.0, 1.0 + 2.0 ** -40, 0.0])


@pytest.mark.slow
def test_f64_whole_run_gates():
    """tests/test_f64.py's gates on the port: nscatt/photon of the tau =
    10 sphere in float64 at eps = 1e-8 within 3.5 of 57.5 (SE ~1 at 3,000
    photons), and the float64 refractive sphere's fluence per photon
    within 5% of the float32 run's."""
    grid64 = cart_grid(32, 32, 32, 1.0, 1.0, 1.0, dtype=F64)
    src64 = build_source("point", position=[0.0, 0.0, 0.0], dtype=F64)
    cfg = te.TransportConfig(nphotons=3000, n_lanes=256, eps=1e-8,
                             chain_scatter=True)
    tl, _, n, _ = te.simulate(_sphere_f64(10.0, 0.0, 0.0, 1.0), src64,
                              grid64, torch.Generator().manual_seed(9), cfg,
                              chunk_steps=400)
    assert int(n) == 3000 and tl.jmean.dtype == F64
    assert abs(float(tl.nscatt) / 3000 - 57.5) < 3.5
    t64, _, n64, _ = te.simulate(_sphere_f64(10.0, 0.1, 0.9, 1.38), src64,
                                 grid64, torch.Generator().manual_seed(9),
                                 cfg, chunk_steps=400)
    cfg32 = te.TransportConfig(nphotons=3000, n_lanes=256,
                               chain_scatter=True)
    t32, _, n32, _ = te.simulate(
        _sphere_f64(10.0, 0.1, 0.9, 1.38, torch.float32),
        build_source("point", position=[0.0, 0.0, 0.0]),
        cart_grid(32, 32, 32, 1.0, 1.0, 1.0),
        torch.Generator().manual_seed(9), cfg32, chunk_steps=400)
    j64 = float(t64.jmean.sum()) / int(n64)
    j32 = float(t32.jmean.sum()) / int(n32)
    assert abs(j32 - j64) / j32 < 0.05, (j32, j64)
