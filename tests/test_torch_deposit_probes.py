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
    # three kernels a call: sort, add, spill
    assert dp.serial_kernel_launches == 3 and dp.serial_plain_calls == 0
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


# --- the plan of the slab kernels (CPU) -------------------------------------

#: an H100 SXM (and PCIe), an A100 and an L4, as the runtime gives them
H100 = dp.Card(sms=132, block_smem=232_448)
H100_PCIE = dp.Card(sms=114, block_smem=232_448)
A100 = dp.Card(sms=108, block_smem=166_912)
L4 = dp.Card(sms=58, block_smem=101_376)


def _slab_sum(idx, val, size, plan):
    """The grid cut as the slab kernels cut it: each slab summed on its own
    from the rows whose cell lies in it, then the slabs laid end to end."""
    out = []
    for k in range(plan.slabs):
        lo, hi = k * plan.slab, min(size, (k + 1) * plan.slab)
        keep = (idx >= lo) & (idx < hi)
        cells = torch.zeros(hi - lo, dtype=torch.float32)
        cells.index_add_(0, (idx[keep] - lo).long(), val[keep])
        out.append(cells)
    return torch.cat(out)


def test_serial_plan_at_the_tool_size():
    size = dp.padded_rows(200 ** 3) * dp.LANES
    plan = dp.serial_plan(size, 1 << 20, H100)
    # two whole waves of one block an SM; the last slab is ragged
    assert (plan.slab, plan.slabs) == (30_336, 264)
    assert plan.slabs % H100.sms == 0
    assert size - (plan.slabs - 1) * plan.slab == 21_632
    assert plan.slab <= dp.slab_max(H100) == 55_936
    # 256 sorted chunks of 4,096 rows, each with 264 + 1 slab starts and
    # an out-of-range count, beside the heavy slabs' list and count
    assert plan.parts == (1 << 20) // dp.SORT_ROWS == 256
    assert (plan.scratch_rows, plan.table) == (1 << 20,
                                               2 * 264 + 1 + 266 * 256)
    # a slab's block adds at most four times the mean, 3,972 rows
    assert plan.heavy == 4 * 3_972


@pytest.mark.parametrize("G", [1024, 300])
def test_serial_plan_of_a_grid_smaller_than_a_slab(G):
    size = dp.padded_rows(G) * dp.LANES
    plan = dp.serial_plan(size, 4096, H100)
    assert (plan.slab, plan.slabs) == (size, 1)
    assert (plan.parts, plan.scratch_rows, plan.table) == (1, 4096, 6)
    assert plan.heavy == dp.SORT_ROWS  # one chunk never spills


@pytest.mark.parametrize("size,card", [
    (200_064, H100), (1_000_064, H100), (8_000_000, A100), (8_000_000, L4),
    (8_000_128, H100_PCIE), (2 ** 31, H100)])
def test_serial_plan_cuts_any_grid_into_slabs(size, card):
    plan = dp.serial_plan(size, 12345, card)
    assert plan.slab % dp.LANES == 0
    # the slab fits a block's shared memory beside the add block's words
    assert 4 * plan.slab + dp.SLAB_RESERVED <= card.block_smem
    assert (plan.slabs - 1) * plan.slab < size <= plan.slabs * plan.slab
    # whole waves over the SMs where the slab allows
    if plan.slab > dp.MIN_SLAB and plan.slab + dp.LANES <= dp.slab_max(card):
        assert plan.slabs % card.sms == 0 or size % plan.slab
    # one count a slab and the staged chunk fit a block's shared memory
    assert 4 * (plan.slabs + 1) + 8 * dp.SORT_ROWS <= card.block_smem
    assert plan.parts == -(-12345 // dp.SORT_ROWS)
    assert plan.scratch_rows == plan.parts * dp.SORT_ROWS >= 12345
    assert plan.table == 2 * plan.slabs + 1 + (plan.slabs + 2) * plan.parts
    assert plan.heavy >= dp.SORT_ROWS


def test_serial_plan_rejects_what_the_kernels_cannot_take():
    with pytest.raises(ValueError):
        dp.serial_plan(1000, 10, H100)  # not whole rows of 128
    with pytest.raises(ValueError):
        dp.serial_plan(1024, 2 ** 31, H100)
    with pytest.raises(ValueError):
        dp.serial_plan(8_000_000, 10, H100, slab=1000)
    with pytest.raises(ValueError):
        dp.serial_plan(8_000_000, 10, H100, slab=dp.slab_max(H100) + 128)
    with pytest.raises(ValueError):  # 62,500 slab counts in a sorting block
        dp.serial_plan(8_000_000, 10, H100, slab=128)
    assert dp.serial_plan(8_000_000, 10, H100, slab=256).slabs == 31_250


@pytest.mark.parametrize("G,slab", [(5000, None), (5000, 1024), (1000, None),
                                    (40_000, 4096)])
def test_slabs_laid_end_to_end_are_the_grid(G, slab):
    """Summing each slab of the plan on its own gives the plain twin's
    grid: every counted row lands in exactly one slab, the ragged last one
    included."""
    idx, val = _serial_inputs(4096, G, seed=7)
    idx[:50] = G - 1  # rows in the last slab's last cell
    size = dp.padded_rows(G) * dp.LANES
    plan = dp.serial_plan(size, 4096, H100, slab=slab)
    i, v = torch.from_numpy(idx), torch.from_numpy(val)
    want, _ = dp.serial_deposit_plain(i, v, G, block=4096)
    got = _slab_sum(i, v, size, plan)
    assert got.numel() == size
    torch.testing.assert_close(got, want.reshape(-1), rtol=0, atol=1e-5)


def _tool_rows(case, n=1 << 20, G=200 ** 3, seed=13):
    """The serial tool's row count over 200^3, spread as ``case`` says."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, G, n)
    size = dp.padded_rows(G) * dp.LANES
    plan = dp.serial_plan(size, n, H100)
    last = (plan.slabs - 1) * plan.slab
    if case == "one cell":
        idx[:] = G // 2
    elif case == "ragged last slab":
        idx = last + idx % (size - last)
    elif case == "a hot quarter":
        idx[: n // 4] = 12_345
    elif case == "twice the mean in one slab":
        idx[: n // plan.slabs] = plan.slab * 7 + idx[: n // plan.slabs] % 999
    return idx, plan


@pytest.mark.parametrize("case,spills", [
    ("uniform", False), ("twice the mean in one slab", False),
    ("one cell", True), ("ragged last slab", True), ("a hot quarter", True)])
def test_serial_plan_leaves_only_skewed_slabs_to_the_reds(case, spills):
    """At the tool's size (256 chunks: one batch of the add block) a slab
    goes to the spill pass when its rows pass ``heavy``: never for the
    tool's uniform rows or a slab at twice the mean, always for a slab
    that one SM would otherwise add most rows into."""
    idx, plan = _tool_rows(case)
    counts = np.bincount(idx // plan.slab, minlength=plan.slabs)
    assert plan.parts <= dp.SLAB_THREADS
    assert bool((counts > plan.heavy).any()) == spills
    assert int((counts > plan.heavy).sum()) <= 1


# --- the slab kernels on their edge cases (need a card) ---------------------


def _serial_case(name, G=200 ** 3, n=1 << 18, seed=8):
    idx, val = _serial_inputs(n, G, seed=seed)
    size = dp.padded_rows(G) * dp.LANES
    plan = dp.serial_plan(size, n, H100)
    last = (plan.slabs - 1) * plan.slab
    if name == "one cell":
        idx[:] = G // 2
    elif name == "ragged last slab":
        idx = (last + idx % (size - last)).astype(np.int32)
    elif name == "out of range":
        idx[[0, 9, n // 2, n - 1]] = [-5, size, 2 ** 31 - 1, -(2 ** 31)]
    elif name == "zero values":
        val[::3] = 0.0
        val[1::7] = -0.0
        idx[: n // 4] = 77  # a cell that only zeros reach
        val[: n // 4] = -0.0
    return idx, val


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["one cell", "ragged last slab",
                                  "out of range", "zero values"])
def test_cuda_serial_slab_kernels_on_edge_cases(cuda_device, name):
    G = 200 ** 3
    idx, val = _serial_case(name, G)
    i, v = (torch.from_numpy(a).to(cuda_device) for a in (idx, val))
    # the twin in float64: in float32 a quarter million rows into one cell
    # carry ~1e-5 of the cell's rounding in the twin itself
    want, n_bad = dp.serial_deposit_plain(i, v.double(), G, block=4096)
    dp.reset_counts()
    # twice: the second call's table may hold the first call's words
    for _ in range(2):
        got, bad = dp._launch_serial(i, v, G, 4096)
        torch.cuda.synchronize(cuda_device)
        assert int(bad.item()) == n_bad  # the out-of-range count is exact
        scale = float(want.abs().max())
        assert float((got.double() - want).abs().max()) <= (
            1e-4 + 1e-5 * scale)
        # a cell only zeros reach is +0.0, as index_add_ leaves it
        assert torch.equal(torch.signbit(got), torch.signbit(want))
    assert dp.serial_kernel_launches == 6  # sort, add, spill, twice
    assert (n_bad == 4) == (name == "out of range")


@pytest.mark.cuda
def test_cuda_serial_slab_kernel_keeps_a_non_finite_value_in_its_cell(
        cuda_device):
    idx, val = _serial_inputs(8192, 5000, seed=9)
    idx[[10, 11, 4000]] = [17, 17, 4999]
    val[[10, 11, 4000]] = [np.inf, 1.0, np.nan]
    i, v = (torch.from_numpy(a).to(cuda_device) for a in (idx, val))
    got = dp.serial_deposit(i, v, 5000, block=4096)
    want, _ = dp.serial_deposit_plain(i, v, 5000, block=4096)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert int(torch.isfinite(got).logical_not().sum()) == 2
    ok = torch.isfinite(want)
    assert float((got[ok] - want[ok]).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("slab", [128, 4096, 55_936])
def test_cuda_serial_slab_kernels_over_other_slabs(cuda_device, slab):
    """Unaligned rows (4 bytes past a 16-byte boundary) under other slabs,
    down to slabs of one tile row."""
    G = 100_000
    idx, val = _serial_inputs(3 * 4096 + 1, G, seed=10)
    i, v = (torch.from_numpy(a).to(cuda_device)[1:] for a in (idx, val))
    got, bad = dp._launch_serial(i, v, G, 4096, slab=slab)
    want, _ = dp.serial_deposit_plain(i, v, G, block=4096)
    assert int(bad.item()) == 0
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 + 1e-5 * scale


@pytest.mark.cuda
def test_cuda_serial_slab_kernels_spill_from_a_later_batch(cuda_device):
    """1,100 chunks: the add block takes its slab's runs 1,024 chunks at a
    time, and the last 76 chunks, all in one cell, take the slab past
    ``heavy`` only in the second batch, which the spill pass adds."""
    G, n = 200 ** 3, 1100 * 4096
    rng = np.random.default_rng(14)
    idx = rng.integers(0, G, n).astype(np.int32)
    val = rng.random(n).astype(np.float32)
    idx[1024 * 4096:] = 3_000_001
    i, v = (torch.from_numpy(a).to(cuda_device) for a in (idx, val))
    size = dp.padded_rows(G) * dp.LANES
    plan = dp.serial_plan(size, n, dp.card_of(cuda_device))
    k = 3_000_001 // plan.slab
    first = int(((idx[:1024 * 4096] // plan.slab) == k).sum())
    assert first <= plan.heavy < first + 76 * 4096
    got, bad = dp._launch_serial(i, v, G, 4096)
    want, _ = dp.serial_deposit_plain(i, v.double(), G, block=4096)
    assert int(bad.item()) == 0
    scale = float(want.abs().max())
    assert float((got.double() - want).abs().max()) <= 1e-4 + 1e-5 * scale
