"""The detector slice of the port against the JAX reference: the chained
walk with the fluence estimator off, a detector bank, the box scene and
the pencil source (``res/validation1.toml``).

- The slice, ``engine.simulate`` on the sphere scene with the bench's
  circle detector (4000 photons, 512 lanes, K = 8, fluence off, as
  ``tests/test_chain.py::test_chained_fluenceless_matches_plain_
  statistically`` runs the reference): both packages launch every photon,
  detector totals agree within 5 binomial sigma, nscatt/photon within 5%,
  absorbed weight within 5 sigma.  Each package uses its own RNG.
- The van de Hulst slab through the port's entry points at 20,000
  photons: Rd within 0.009 of 0.09739 and Td within 0.013 of 0.66096
  (about 4 standard errors at this count).
- The box scene and the pencil source parse and build as the reference's.
"""

from pathlib import Path

import numpy as np
import torch

import jax
import jax.numpy as jnp

import rsmcrt_tpu.kernels as jk
from rsmcrt_tpu.config import parse_params as jparse
from rsmcrt_tpu.detectors.detectors import CircleDetectors, DetectorBank
from rsmcrt_tpu.detectors.detectors import totals as jtotals
from rsmcrt_tpu.grid import cart_grid
from rsmcrt_tpu.optics.properties import mono
from rsmcrt_tpu.sdfs import scene as jS
from rsmcrt_tpu.sources.sources import build_source
from rsmcrt_tpu.transport import engine as je
from rsmcrt_tpu_torch import interop
from rsmcrt_tpu_torch import kernels as tk
from rsmcrt_tpu_torch.config import parse_params as tparse
from rsmcrt_tpu_torch.detectors.detectors import totals as ttotals
from rsmcrt_tpu_torch.sdfs import scene as tS
from rsmcrt_tpu_torch.transport import deposit as tdep
from rsmcrt_tpu_torch.transport import engine as te

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
N = 4000


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bench_bank():
    # bench.bench_bank: a disc inside the sphere
    return DetectorBank(
        circle=CircleDetectors(
            pos=jnp.asarray([[0.0, 0.0, 0.8]], jnp.float32),
            dir=jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32),
            radius=jnp.asarray([1.0], jnp.float32),
            bin_wid=jnp.asarray([1.0 / 32], jnp.float32),
            data=jnp.zeros((1, 33), jnp.float32), nbins=32),
        annulus=None, fibre=None, camera=None,
        target_values=jnp.full((1,), -1.0), order=(("circle", 0),),
        ids=("d0",), layers=(2,))


def test_fluenceless_slice_matches_reference():
    scene = jS.build_scene([
        jS.sphere(1.0, mono(10.0, 0.1, 0.9, 1.38), 1),
        jS.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0), 2),
    ])
    grid = cart_grid(50, 50, 50, 1.0, 1.0, 1.0)
    src = build_source("point", position=[0.0, 0.0, 0.0])
    bank = _bench_bank()
    cfg = je.TransportConfig(nphotons=N, n_lanes=512, dda_substeps=8,
                             record_fluence=False, chain_scatter=True)
    jt, jb, jn, _ = je.simulate(scene, src, grid, jax.random.key(5), cfg,
                                bank=bank, chunk_steps=256)
    tbank = interop.bank_from_numpy(_np(bank))
    tdep.reset_counts()
    tt, tb, tn, _ = te.simulate(
        interop.scene_from_numpy(_np(scene)),
        interop.source_from_numpy(_np(src)),
        interop.grid_from_numpy(_np(grid)),
        torch.Generator().manual_seed(5),
        te.TransportConfig(nphotons=N, n_lanes=512, dda_substeps=8,
                           record_fluence=False, chain_scatter=True),
        bank=tbank)
    assert int(jn) == int(tn) == N
    assert float(ttotals(tbank)[0]) == 0.0  # the caller's bank is untouched
    assert float(tt.jmean.sum()) == 0.0
    assert tdep.deposit_plain_calls > 0  # the absorb deposits
    d_j, d_t = float(jtotals(jb)[0]), float(ttotals(tb)[0])
    sd = np.sqrt(max(d_j, 1.0))
    assert d_t > 0 and abs(d_t - d_j) < 5 * sd, (d_t, d_j)
    ns_j, ns_t = float(jt.nscatt) / N, float(tt.nscatt) / N
    assert abs(ns_t - ns_j) / ns_j < 0.05, (ns_t, ns_j)
    a_j, a_t = float(jnp.sum(jt.absorb)), float(tt.absorb.sum())
    assert abs(a_t - a_j) < 5 * np.sqrt(max(a_j, 1.0)), (a_t, a_j)


def test_validation_slab_through_the_port(tmp_path):
    parsed, scene = tk.setup(ROOT / "res" / "validation1.toml", device="cpu")
    res = tk.run_MCRT(parsed, scene, nphotons=20_000, record_fluence=False)
    assert res.launched == 20_000
    rd, td = (ttotals(res.bank) / res.launched).tolist()
    assert abs(rd - 0.09739) < 0.009, rd
    assert abs(td - 0.66096) < 0.013, td
    tk.finalise(res, data_dir=tmp_path, verbose=False)
    for i, tot in enumerate((rd, td)):
        raw = np.fromfile(tmp_path / "detectors" / f"detector_{i + 1}.dat",
                          np.float64)
        assert raw[0] == 1.0  # circle
        assert raw[2 + int(raw[1])] == 20_000  # nphotons
        counts = raw[-2 * 101 + 1::2]
        assert abs(counts.sum() / 20_000 - tot) < 1e-6


def test_box_scene_and_pencil_source_match_reference():
    path = ROOT / "res" / "validation1.toml"
    j, t = jparse(path), tparse(path)
    assert t.settings.experiment == j.settings.experiment == "box"
    np.testing.assert_allclose(t.geometry["BoxDimensions"],
                               j.geometry["BoxDimensions"])
    assert t.source.kind == j.source.kind == "pencil"
    for k in ("position", "direction"):
        np.testing.assert_array_equal(t.source.params[k].numpy(),
                                      np.asarray(j.source.params[k]))
    jp, js = jk.setup(path)
    tp, ts = tk.setup(path, device="cpu")
    assert [s.kind for s in ts.specs] == [s.kind for s in js.specs]
    for f in ("mus", "mua", "hgg", "n", "kappa", "albedo"):
        np.testing.assert_array_equal(getattr(ts.tables, f).numpy(),
                                      np.asarray(getattr(js.tables, f)))
    p = np.random.default_rng(3).uniform(-0.02, 0.02, (1024, 3)).astype(
        np.float32) * np.float32([2500.0, 2500.0, 1.0])
    np.testing.assert_allclose(
        tS.eval_scene(ts, torch.as_tensor(p)).numpy(),
        np.asarray(jS.eval_scene(js, p)), rtol=1e-6, atol=1e-6)
