"""The coherent and image sources, the quasi-random source block, the
signed deposit twin and the path-history writers of the PyTorch port
against the JAX reference.

- ``dslit``, ``aperture`` and ``slm`` from the same uniforms: positions,
  directions, phases and wavelengths to float32 rounding (rtol 1e-6,
  atol 1e-6 on positions and directions; the phase, a transverse excess
  ``t2 / (dist + |dz|)`` of ~1e-2, rtol 1e-5).
- ``radical_inverse`` bit for bit in every base; ``halton_block`` with the
  reference's Cranley-Patterson shifts handed in, bit for bit.
- The signed deposit twin keeps every finite non-zero row, negative ones
  included; the unsigned one still drops them.
- ``write_history`` byte for byte as the reference's writer, in obj, ply
  and json.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rsmcrt_tpu.grid import cart_grid as jcart
from rsmcrt_tpu.io import history as jhist
from rsmcrt_tpu.maths import qmc as jqmc
from rsmcrt_tpu.optics import piecewise as jpw
from rsmcrt_tpu.sources import sources as jsrc
from rsmcrt_tpu_torch import interop
from rsmcrt_tpu_torch.grid import cart_grid as tcart
from rsmcrt_tpu_torch.io import history as thist
from rsmcrt_tpu_torch.maths import qmc as tqmc
from rsmcrt_tpu_torch.optics import piecewise as tpw
from rsmcrt_tpu_torch.sources import sources as tsrc
from rsmcrt_tpu_torch.transport import deposit as tdep

torch.set_num_threads(1)


def _slm_image():
    rng = np.random.default_rng(21)
    img = rng.uniform(0.0, 1.0, (40, 30))
    img[img < 0.3] = 0.0
    return img


def _sources():
    img = _slm_image()
    return {
        "dslit": (dict(position=[0.0, 0.0, 0.0]),
                  jpw.Constant(jnp.asarray(500e-9, jnp.float32)),
                  tpw.Constant(torch.tensor(500e-9))),
        "aperture": (dict(position=[0.0, 0.0, 0.0]),
                     jpw.Constant(jnp.asarray(633e-9, jnp.float32)),
                     tpw.Constant(torch.tensor(633e-9))),
        "slm": (dict(position=[0.0, 0.0, 0.5], direction=[0.0, 0.0, -1.0]),
                jpw.piecewise2d(0.5, 0.5, img),
                tpw.piecewise2d(0.5, 0.5, img)),
    }


@pytest.mark.parametrize("kind", ["dslit", "aperture", "slm"])
def test_coherent_and_image_sources_match_reference(kind):
    params, jspec, tspec = _sources()[kind]
    js = jsrc.build_source(kind, spectrum=jspec, **params)
    ts = tsrc.build_source(kind, spectrum=tspec, **params)
    n = jsrc.n_source_uniforms(js)
    assert tsrc.n_source_uniforms(ts) == n
    u = np.random.default_rng(22).uniform(1e-7, 1.0, (4096, n)).astype(
        np.float32)
    jgrid = jcart(200, 200, 8, 1.0, 1.0, 1.0)
    jout = jsrc.sample(js, jgrid, jnp.asarray(u))
    carried = interop.source_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                               js))
    for src in (ts, carried):
        tout = tsrc.sample(src, tcart(200, 200, 8, 1.0, 1.0, 1.0),
                           torch.as_tensor(u))
        for what, t, j, rtol in zip(("pos", "dir", "phase", "wavelength"),
                                    tout, jout, (1e-6, 1e-6, 1e-5, 1e-6)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                                       atol=1e-6, err_msg=f"{kind} {what}")
    if kind != "slm":
        # the launch phase is the transverse excess over |dz|: positive
        assert np.all(tout[2].numpy() > 0.0)
        np.testing.assert_allclose(np.linalg.norm(tout[1].numpy(), axis=-1),
                                   1.0, rtol=1e-6)


def test_radical_inverse_is_bit_equal():
    rng = np.random.default_rng(23)
    idx = np.concatenate([np.arange(4096),
                          rng.integers(0, 2 ** 31 - 1, 4096),
                          [2 ** 31 - 1, 2 ** 24, 2 ** 24 - 1]]).astype(
        np.int32)
    for base in tqmc.PRIMES:
        want = np.asarray(jqmc.radical_inverse(jnp.asarray(idx), base))
        got = tqmc.radical_inverse(torch.as_tensor(idx), base).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"base {base}")


@pytest.mark.parametrize("n_dims", [1, 3, 8])
def test_halton_block_with_reference_shifts(n_dims):
    key = jax.random.fold_in(jax.random.key(5), 0x9A17)
    shifts = jax.random.uniform(key, (n_dims,), jnp.float32)
    idx = np.arange(100_000, 104_096, dtype=np.int32)
    want = np.asarray(jqmc.halton_block(jnp.asarray(idx), n_dims, key))
    got = tqmc.halton_block(torch.as_tensor(idx), n_dims,
                            torch.as_tensor(np.array(shifts))).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() > 0.0 and got.max() <= 1.0
    gen = torch.Generator().manual_seed(1)
    s = tqmc.halton_shifts(n_dims, gen, "cpu")
    assert s.shape == (n_dims,) and float(s.min()) >= 0.0 \
        and float(s.max()) < 1.0
    with pytest.raises(ValueError, match="dims"):
        tqmc.halton_block(torch.as_tensor(idx), 13, torch.zeros(13))


def test_signed_plain_twin_keeps_negative_rows():
    rng = np.random.default_rng(24)
    n, cells = 20_000, 300
    idx = rng.integers(0, cells, n).astype(np.int32)
    val = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    val[::11] = 0.0
    val[::97] = np.nan
    val[5::97] = np.inf
    val[7::97] = -np.inf
    val[3::13] *= -1.0
    for signed in (False, True):
        keep = (np.isfinite(val) & (val != 0.0)) if signed else val > 0.0
        want = np.zeros(cells, np.float64)
        np.add.at(want, idx[keep], val[keep].astype(np.float64))
        calls = tdep.deposit_plain_calls
        got = tdep.deposit_add_(torch.zeros(cells), torch.as_tensor(idx),
                                torch.as_tensor(val), signed=signed)
        assert tdep.deposit_plain_calls == calls + 1
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        twin = tdep.deposit_add_plain(torch.zeros(cells),
                                      torch.as_tensor(idx),
                                      torch.as_tensor(val), signed=signed)
        np.testing.assert_array_equal(twin.numpy(), got.numpy())
    # the unsigned deposit of the negated rows is empty; the signed one is
    # the negation
    neg = torch.as_tensor(-np.abs(np.nan_to_num(val, posinf=1.0,
                                                neginf=1.0)))
    assert float(tdep.deposit_add_plain(torch.zeros(cells),
                                        torch.as_tensor(idx),
                                        neg).abs().sum()) == 0.0
    assert float(tdep.deposit_add_plain(torch.zeros(cells),
                                        torch.as_tensor(idx), neg,
                                        signed=True).sum()) < 0.0


def _tracks():
    """[n, H, 4] tracks as the engine leaves them: a launch row, rows of
    increasing scatter order, then never-written zero rows; some tracks
    with one point only."""
    rng = np.random.default_rng(25)
    n, H = 40, 12
    tr = np.zeros((n, H, 4), np.float32)
    for i in range(n):
        m = int(rng.integers(1, H + 1))
        tr[i, :m, :3] = rng.uniform(-1.0, 1.0, (m, 3))
        tr[i, :m, 3] = np.arange(m)
    tr[3, 0] = 0.0  # a launch at the origin still counts
    tr[3, 1:4, :3] = 0.25
    tr[3, 1:4, 3] = [1, 2, 3]
    return tr


@pytest.mark.parametrize("suffix", [".obj", ".ply", ".json"])
def test_write_history_is_byte_identical(tmp_path, suffix):
    tracks = _tracks()
    count = tracks.shape[0] - 5  # rows past the count are not written
    want = jhist.write_history(tracks, count, tmp_path / "j" / f"h{suffix}")
    got = thist.write_history(tracks, count, tmp_path / "t" / f"h{suffix}")
    assert got.read_bytes() == want.read_bytes()
    assert len(got.read_bytes()) > 100
    with pytest.raises(ValueError, match="unsupported"):
        thist.write_history(tracks, count, tmp_path / "h.txt")
