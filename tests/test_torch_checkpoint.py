"""Checkpoints in the port: the npz checkpoint of every tally and detector
bin (``io.writer.write_checkpoint_full`` / ``read_checkpoint_full``) and
the reference-format checkpoint with resume (``kernels.checkpoint_now``,
``default_MCRT`` with ``load_checkpoint``).

- The npz round trip keeps every key, value, type (float32 and float64
  tallies) and flat shape.
- An npz the JAX package writes reads in the port as the same arrays, and
  an npz the port writes reads in the JAX package the same way.
- tests/test_checkpoint_resume.py's run on the port's CPU path: 1,800 of
  3,000 photons checkpointed with ``checkpoint_now``, the resume launches
  the other 1,200, the merged fluence is above the partial one and within
  10% of a full run.  On 2,048 lanes (the reference test runs 1,024).
"""

import dataclasses
from pathlib import Path

import numpy as np
import torch

import jax
import jax.numpy as jnp

from rsmcrt_tpu import kernels as jkernels
from rsmcrt_tpu.io import writer as jwriter
from rsmcrt_tpu.tally import zero_tallies as jzero
from rsmcrt_tpu_torch import interop
from rsmcrt_tpu_torch import kernels as tkernels
from rsmcrt_tpu_torch.grid import cart_grid
from rsmcrt_tpu_torch.io import writer as twriter
from rsmcrt_tpu_torch.tally import Tallies, zero_tallies

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
DECTS = ROOT / "res" / "test_dects.toml"
KEYS = {"toml", "photons_run", "jmean", "absorb", "emission", "nscatt",
        "rng_seed", "dect_circle", "dect_annulus", "dect_camera"}


def _filled(tallies, bank, seed):
    """Random values in every tally and detector bin (in place)."""
    g = torch.Generator().manual_seed(seed)
    for t in (tallies.jmean, tallies.absorb, tallies.emission,
              tallies.nscatt):
        t.copy_(torch.rand(t.shape, generator=g, dtype=t.dtype))
    for _, f in bank.families():
        f.data.copy_(torch.rand(f.data.shape, generator=g,
                                dtype=f.data.dtype))
    return tallies, bank


def _check_payload(got, tallies, bank, toml, n, seed):
    assert set(got) == KEYS, sorted(got)
    assert str(got["toml"]) == toml and int(got["photons_run"]) == n
    assert int(got["rng_seed"]) == seed
    for k in ("jmean", "absorb", "emission", "nscatt"):
        want = getattr(tallies, k).numpy()
        assert got[k].dtype == want.dtype and got[k].shape == want.shape
        np.testing.assert_array_equal(got[k], want)
    for fam, f in bank.families():
        np.testing.assert_array_equal(got[f"dect_{fam}"], f.data.numpy())


def test_npz_round_trip(tmp_path):
    parsed, _ = tkernels.setup(DECTS, device="cpu")
    bank = parsed.detectors
    for dtype in (torch.float32, torch.float64):
        grid = cart_grid(4, 5, 6, 1.0, 1.0, 1.0, dtype=dtype)
        tallies, bank = _filled(zero_tallies(grid, dtype), bank, 5)
        path = tmp_path / f"ckpt_{dtype}.npz"
        twriter.write_checkpoint_full(path, "res/test_dects.toml", 1234,
                                      tallies, bank, rng_seed=77)
        got = twriter.read_checkpoint_full(path)
        _check_payload(got, tallies, bank, "res/test_dects.toml", 1234, 77)
        assert got["jmean"].dtype == np.dtype(str(dtype).split(".")[1])


def test_npz_crosses_between_packages(tmp_path):
    parsed, _ = jkernels.setup(DECTS)
    jbank = parsed.detectors
    grid = parsed.settings.grid
    tl = jzero(grid)
    rng = np.random.default_rng(8)
    tl = tl.__class__(**{**tl.__dict__, **{
        k: jnp.asarray(rng.uniform(size=getattr(tl, k).shape), jnp.float32)
        for k in ("jmean", "absorb", "emission", "nscatt")}})
    ref_path = tmp_path / "ref.npz"
    jwriter.write_checkpoint_full(ref_path, str(DECTS), 900, tl, jbank,
                                  rng_seed=4)
    # the port reads the reference's npz as the same arrays
    got = twriter.read_checkpoint_full(ref_path)
    want = jwriter.read_checkpoint_full(ref_path)
    assert set(got) == set(want) == KEYS
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # the reference reads the port's npz: the same tallies and bins
    port_tl = Tallies(**{f.name: torch.tensor(np.asarray(getattr(tl, f.name)))
                         for f in dataclasses.fields(Tallies)})
    port_bank = interop.bank_from_numpy(
        jax.tree_util.tree_map(np.asarray, jbank))
    port_path = tmp_path / "port.npz"
    twriter.write_checkpoint_full(port_path, str(DECTS), 900, port_tl,
                                  port_bank, rng_seed=4)
    back = jwriter.read_checkpoint_full(port_path)
    assert set(back) == KEYS
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])


CFG = """
[source]
name = "point"
nphotons = {n}
position = [0.0, 0.0, 0.0]

[grid]
nxg = 16
nyg = 16
nzg = 16
xmax = 1.0
ymax = 1.0
zmax = 1.0

[geometry]
geom_name = "scat_test"
tau = 3.0

[output]
fluence = "fluence.nrrd"
overwrite = true

[simulation]
iseed = 99
load_checkpoint = {load}
checkpoint_file = "{ckpt}"
checkpoint_every_n = 1000000
"""


def test_checkpoint_now_and_resume(tmp_path):
    ckpt = tmp_path / "check.ckpt"
    cfg1 = tmp_path / "first.toml"
    cfg1.write_text(CFG.format(n=3000, load="false", ckpt=ckpt))
    full = tkernels.default_MCRT(cfg1, data_dir=tmp_path / "data_full",
                                 n_lanes=2048, verbose=False, device="cpu")
    assert full.launched == 3000
    parsed, scene = tkernels.setup(cfg1, device="cpu")
    part = tkernels.run_MCRT(parsed, scene, nphotons=1800, n_lanes=2048)
    assert part.launched == 1800
    path = tkernels.checkpoint_now(cfg1, part)
    assert Path(path) == ckpt and ckpt.exists()
    cfg2 = tmp_path / "resume.toml"
    cfg2.write_text(CFG.format(n=3000, load="true", ckpt=ckpt))
    resumed = tkernels.default_MCRT(cfg2, data_dir=tmp_path / "data_res",
                                    n_lanes=2048, verbose=False,
                                    device="cpu")
    assert resumed.launched == 1200
    merged = float(resumed.tallies.jmean.sum())
    partial = float(part.tallies.jmean.sum())
    assert merged > partial
    whole = float(full.tallies.jmean.sum())
    assert abs(merged - whole) / whole < 0.1, (merged, whole)
