"""The port's deposit probes against the Pallas kernels of the JAX
package's tools.

``serial_deposit``'s plain twin is held against
``tools/profile_deposit_pallas_serial.py``'s ``_kernel`` and
``onehot_tile_accumulate``'s against ``tools/profile_deposit_design.py``'s
``kern``, both run in Pallas interpret mode with the tools' own block
specs.  ``kern`` is defined inside the tool's ``main()``, so it is taken
out of the file with ``ast`` (the test follows the file, it does not copy
the kernel).  Tolerances: the serial grid atol 1e-4 (the tool's own
check; both add float32 rows one at a time, in the same order on the
CPU), the tile rtol 1e-6 / atol 1e-5 (the interpret-mode product and the
twin's einsum sum a cell's rows in different orders).  The CUDA
kernels are held to the twins by the ``cuda``-marked tests, which need a
card.  JAX is imported inside the parity tests only, so the ``cuda``
tests also run on a machine without JAX.
"""

import ast
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from rsmcrt_tpu_torch.transport import deposit_probes as dp

torch.set_num_threads(1)

TOOLS = Path(__file__).resolve().parents[1] / "tools"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _pallas():
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    return jax, jnp, pl, pltpu


def _serial_tool():
    """``tools/profile_deposit_pallas_serial.py``, loaded by path (it
    imports ``_timing`` from its own directory)."""
    import sys

    sys.path.insert(0, str(TOOLS))
    try:
        spec = importlib.util.spec_from_file_location(
            "profile_deposit_pallas_serial",
            TOOLS / "profile_deposit_pallas_serial.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(TOOLS))
    return mod


def _serial_reference(idx, val, G, block):
    """``_kernel`` in interpret mode over ``N // block`` blocks, with the
    tool's block specs (the grid zeroed at program 0, block ``c`` read
    through the index map ``(0, c)``)."""
    jax, jnp, pl, pltpu = _pallas()
    tool = _serial_tool()
    n_blk = idx.size // block
    Gr = -(-G // 128)
    out = pl.pallas_call(
        functools.partial(tool._kernel, n_per_block=block, unroll=8),
        grid=(n_blk,),
        in_specs=[pl.BlockSpec((1, block), lambda c: (0, c),
                               memory_space=pltpu.SMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((Gr, 128), jnp.float32),
        interpret=True,
    )(jnp.asarray(idx).reshape(1, -1), jnp.asarray(val).reshape(1, -1))
    return np.asarray(out)


def _kern(C, H):
    """The tool's ``kern``, taken out of ``main()`` with ``ast`` and bound
    to ``C`` and ``H``."""
    jax, jnp, pl, _ = _pallas()
    tree = ast.parse((TOOLS / "profile_deposit_design.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "kern")
    ns = {"jax": jax, "jnp": jnp, "pl": pl, "C": C, "H": H}
    exec(compile(ast.Module([fn], []), "profile_deposit_design.kern",
                 "exec"), ns)
    return ns["kern"]


def _tile_reference(hi, lo, v, H):
    """``kern`` in interpret mode with the tool's ``pallas_call``: a grid
    over the chunks, the tile carried in VMEM scratch."""
    jax, jnp, pl, pltpu = _pallas()
    nchunk, C = hi.shape
    f = pl.pallas_call(
        _kern(C, H),
        grid=(nchunk,),
        in_specs=[pl.BlockSpec((1, C), lambda c: (c, 0),
                               memory_space=pltpu.VMEM)] * 3,
        out_specs=pl.BlockSpec((H, 128), lambda c: (0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((H, 128), jnp.float32),
        scratch_shapes=[pltpu.VMEM((H, 128), jnp.float32)],
        interpret=True,
    )
    return np.asarray(f(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(v)))


def _serial_inputs(n, G, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, G, n).astype(np.int32)
    val = rng.random(n).astype(np.float32)
    # repeats and zero rows among them
    idx[: n // 16] = idx[0]
    val[n // 3: n // 3 + 40] = 0.0
    return idx, val


def _tile_inputs(nchunk, C, H, seed=0):
    """Rows with ``hi`` in ``[-2, H + 2)`` and ``lo`` in ``[-3, 131)``: a
    few out of range on either side."""
    rng = np.random.default_rng(seed)
    hi = rng.integers(-2, H + 2, (nchunk, C)).astype(np.int32)
    lo = rng.integers(-3, 131, (nchunk, C)).astype(np.int32)
    v = rng.uniform(0.0, 2.0, (nchunk, C)).astype(np.float32)
    hi[0, :8] = 3  # a hot row of the tile
    lo[0, :8] = 5
    return hi, lo, v


@pytest.mark.parametrize("n,G,block", [
    (3 * 1024 + 100, 2000, 1024),  # three whole blocks, a dropped tail
    (4096, 1024, 4096),  # the tool's --interpret size
    (5 * 512, 300, 512),  # G not a multiple of 128: a padded last row
])
def test_serial_twin_matches_pallas_interpret(n, G, block):
    idx, val = _serial_inputs(n, G)
    want = _serial_reference(idx, val, G, block)
    got = dp.serial_deposit(torch.from_numpy(idx), torch.from_numpy(val), G,
                            block=block)
    assert got.shape == want.shape == (-(-G // 128), 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    # the rows of a last partial block add nothing
    kept = (n // block) * block
    assert got.sum().item() == pytest.approx(float(val[:kept].sum()),
                                             rel=1e-5)


def test_serial_drops_the_partial_block():
    idx, val = _serial_inputs(2 * 256 + 255, 1000)
    a = dp.serial_deposit(torch.from_numpy(idx), torch.from_numpy(val), 1000,
                          block=256)
    b = dp.serial_deposit(torch.from_numpy(idx[:512]),
                          torch.from_numpy(val[:512]), 1000, block=256)
    assert torch.equal(a, b)


def test_serial_refuses_fewer_rows_than_a_block():
    idx, val = _serial_inputs(100, 1000)
    with pytest.raises(ValueError, match="block"):
        dp.serial_deposit(torch.from_numpy(idx), torch.from_numpy(val), 1000,
                          block=128)


@pytest.mark.parametrize("bad", [-1, 1024, 5000])
def test_serial_raises_on_out_of_range_rows(bad):
    # G = 1000 pads to 1024 cells: 1000..1023 are in range, 1024 is not
    idx, val = _serial_inputs(512, 1000)
    idx[7] = bad
    with pytest.raises(ValueError, match="1 rows"):
        dp.serial_deposit(torch.from_numpy(idx), torch.from_numpy(val), 1000,
                          block=256)
    # a bad row in the dropped tail is not counted
    idx, val = _serial_inputs(600, 1000)
    idx[590] = bad
    dp.serial_deposit(torch.from_numpy(idx), torch.from_numpy(val), 1000,
                      block=256)


def test_serial_into_the_padding_is_kept():
    idx, val = _serial_inputs(256, 1000)
    idx[3] = 1023
    got = dp.serial_deposit(torch.from_numpy(idx), torch.from_numpy(val), 1000,
                            block=256)
    assert got.reshape(-1)[1023] == val[3]


@pytest.mark.parametrize("nchunk,C,H", [(8, 128, 16), (3, 256, 5)])
def test_tile_twin_matches_pallas_interpret(nchunk, C, H):
    hi, lo, v = _tile_inputs(nchunk, C, H)
    want = _tile_reference(hi, lo, v, H)
    got = dp.onehot_tile_accumulate(torch.from_numpy(hi),
                                    torch.from_numpy(lo),
                                    torch.from_numpy(v), H)
    assert got.shape == (H, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    # the same tile from the rows in range, one cell at a time
    ok = (hi >= 0) & (hi < H) & (lo >= 0) & (lo < 128)
    cells = np.zeros(H * 128, np.float64)
    np.add.at(cells, (hi * 128 + lo)[ok], v[ok])
    np.testing.assert_allclose(want.reshape(-1), cells, rtol=1e-6, atol=1e-5)


def test_tile_twin_spreads_a_non_finite_value_as_the_reference():
    """The one-hot product puts ``v * 0`` in every column of a non-finite
    row's tile row (the kernel does not; documented, and the parity tests
    use finite values)."""
    hi, lo, v = _tile_inputs(8, 128, 16, seed=1)
    hi[3, 5], lo[3, 5], v[3, 5] = 0, 75, np.inf
    hi[4, 7], lo[4, 7], v[4, 7] = 2, 0, np.nan
    want = _tile_reference(hi, lo, v, 16)
    got = dp.onehot_tile_accumulate(torch.from_numpy(hi),
                                    torch.from_numpy(lo),
                                    torch.from_numpy(v), 16).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert np.isnan(want[[0, 2]]).sum() == 255  # all but the inf cell
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-6,
                               atol=1e-5)


def test_wrappers_check_their_inputs():
    idx, val = _serial_inputs(512, 1000)
    with pytest.raises(TypeError):
        dp.serial_deposit(torch.from_numpy(idx).long(),
                          torch.from_numpy(val), 1000, block=256)
    with pytest.raises(ValueError):
        dp.serial_deposit(torch.from_numpy(idx), torch.from_numpy(val[:-1]),
                          1000, block=256)
    hi, lo, v = (torch.from_numpy(a) for a in _tile_inputs(2, 128, 4))
    with pytest.raises(TypeError):
        dp.onehot_tile_accumulate(hi, lo, v.double(), 4)
    with pytest.raises(ValueError):
        dp.onehot_tile_accumulate(hi, lo[:1], v, 4)
    with pytest.raises(ValueError):
        dp.onehot_tile_accumulate(hi, lo, v, 0)


def test_cpu_tensors_take_the_twins():
    dp.reset_counts()
    idx, val = _serial_inputs(512, 1000)
    dp.serial_deposit(torch.from_numpy(idx), torch.from_numpy(val), 1000,
                      block=256)
    hi, lo, v = (torch.from_numpy(a) for a in _tile_inputs(2, 128, 4))
    dp.onehot_tile_accumulate(hi, lo, v, 4)
    assert (dp.serial_plain_calls, dp.onehot_plain_calls) == (1, 1)
    assert (dp.serial_kernel_launches, dp.onehot_kernel_launches) == (0, 0)


def test_port_tools_run_on_the_cpu(capsys):
    from rsmcrt_tpu_torch.tools import profile_deposit_design as design
    from rsmcrt_tpu_torch.tools import profile_deposit_pallas_serial as serial

    assert serial.main(["--device", "cpu", "--check"]) == 0
    assert "exact: True" in capsys.readouterr().out
    assert serial.main(["--device", "cpu", "-N", "8192", "-G", "4096",
                        "--block", "1024"]) == 0
    assert design.main(["--device", "cpu", "--lanes", "256", "--rounds",
                        "8", "--grid", "16", "-M", "2"]) == 0
    out = capsys.readouterr().out
    assert "index_add_" in out and "tile plain twin" in out


# --- the CUDA kernels against their twins (need a card) ---------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n,G,block", [
    (1 << 20, 200 ** 3, 4096),  # the tool's size
    (3 * 4096 + 1000, 200 ** 3, 4096),  # a dropped partial block
    (4096, 1024, 4096),  # the tool's --check size
    (5 * 512, 300, 512),
])
def test_cuda_serial_kernel_matches_twin(cuda_device, n, G, block):
    idx, val = _serial_inputs(n, G, seed=2)
    i, v = (torch.from_numpy(a).to(cuda_device) for a in (idx, val))
    dp.reset_counts()
    got = dp.serial_deposit(i, v, G, block=block)
    want, n_bad = dp.serial_deposit_plain(i, v, G, block=block)
    torch.cuda.synchronize(cuda_device)
    assert dp.serial_kernel_launches == 1 and dp.serial_plain_calls == 0
    assert n_bad == 0
    assert got.shape == want.shape
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 + 1e-5 * scale


@pytest.mark.cuda
def test_cuda_serial_kernel_counts_out_of_range_rows(cuda_device):
    idx, val = _serial_inputs(4096, 1000, seed=3)
    idx[[5, 70, 4000]] = [-1, 1024, 99999]
    i, v = (torch.from_numpy(a).to(cuda_device) for a in (idx, val))
    with pytest.raises(ValueError, match="3 rows"):
        dp.serial_deposit(i, v, 1000, block=1024)
    out = dp.serial_deposit(i, v, 1000, block=1024, check=False)
    want, n_bad = dp.serial_deposit_plain(i, v, 1000, block=1024)
    assert n_bad == 3
    assert float((out - want).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("nchunk,C,H", [(512, 1024, 400), (8, 128, 16),
                                        (3, 255, 5)])
def test_cuda_tile_kernel_matches_twin(cuda_device, nchunk, C, H):
    hi, lo, v = (torch.from_numpy(a).to(cuda_device)
                 for a in _tile_inputs(nchunk, C, H, seed=4))
    dp.reset_counts()
    got = dp.onehot_tile_accumulate(hi, lo, v, H)
    want = dp.onehot_tile_accumulate_plain(hi, lo, v, H)
    torch.cuda.synchronize(cuda_device)
    assert dp.onehot_kernel_launches == 1 and dp.onehot_plain_calls == 0
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
def test_cuda_kernels_on_unaligned_rows(cuda_device):
    """Rows 4 bytes past a 16-byte boundary take the scalar loads."""
    idx, val = _serial_inputs(4097, 5000, seed=5)
    i, v = (torch.from_numpy(a).to(cuda_device)[1:] for a in (idx, val))
    got = dp.serial_deposit(i, v, 5000, block=1024)
    want, _ = dp.serial_deposit_plain(i, v, 5000, block=1024)
    assert float((got - want).abs().max()) <= 1e-4
    hi, lo, x = (torch.from_numpy(a).to(cuda_device).reshape(-1)[1:]
                 for a in _tile_inputs(4, 128, 16, seed=6))
    got = dp.onehot_tile_accumulate(hi, lo, x, 16)
    want = dp.onehot_tile_accumulate_plain(hi[None], lo[None], x[None], 16)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
