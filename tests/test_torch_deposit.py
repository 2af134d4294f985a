"""The port's voxel deposit against the reference's Pallas kernel.

The plain ``deposit_delta`` of the port is held against
``rsmcrt_tpu.transport.deposit.deposit_delta`` run in Pallas interpret
mode (as ``tests/test_deposit.py`` runs it on the CPU), on that file's six
input mixes.  Tolerance rtol 1e-5, atol 1e-5 * max: both sum float32
deposits, in different orders.  The CUDA kernel itself is compared with
the plain version by the ``cuda``-marked test, which needs a card.  JAX
is imported inside the parity test only, so that test also runs on a
machine without JAX (see ``test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from rsmcrt_tpu_torch.transport import deposit as tdep

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _clustered(rng):
    shape = (24, 24, 16)
    n = 512
    cx = rng.integers(0, 20, (4,))
    lane = rng.integers(0, 4, (n,))
    x = np.clip(cx[lane] + rng.integers(0, 4, (n,)), 0, 23)
    y = np.clip(cx[lane] + rng.integers(0, 4, (n,)), 0, 23)
    z = rng.integers(0, 16, (n,))
    val = rng.uniform(0.1, 1.0, (n,)).astype(np.float32)
    return shape, x, y, z, val


def _scattered(rng):
    shape = (32, 24, 16)
    n = 256
    x = rng.integers(0, 32, (n,))
    y = rng.integers(0, 24, (n,))
    z = rng.integers(0, 16, (n,))
    val = rng.uniform(0.1, 1.0, (n,)).astype(np.float32)
    return shape, x, y, z, val


def _collisions_and_padding(rng):
    n = 200
    x, y, z = np.full(n, 7), np.full(n, 9), np.full(n, 3)
    val = np.ones(n, np.float32)
    val[50:100] = 0.0  # padded / dead lanes must be ignored
    x[50:100] = -1  # garbage coordinates on dead lanes
    return (16, 16, 16), x, y, z, val


def _corner_extremes(rng):
    x = np.array([0, 23, 0, 23, 12])
    y = np.array([0, 0, 23, 23, 12])
    z = np.array([0, 7, 7, 0, 4])
    val = np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    return (24, 24, 8), x, y, z, val


def _all_dead(rng):
    n = 64
    z = np.zeros(n, int)
    return (16, 16, 8), z, z, z, np.zeros(n, np.float32)


def _large_random(rng):
    # 90% clustered along short rays (like DDA output), 30% dead rows
    shape = (40, 40, 24)
    n_lane = 128
    lx = rng.integers(0, 39, (n_lane,))
    ly = rng.integers(0, 39, (n_lane,))
    lz = rng.integers(0, 23, (n_lane,))
    d = rng.integers(-1, 2, (n_lane, 3))
    steps = np.arange(8)
    x = np.clip(lx[:, None] + d[:, 0:1] * steps, 0, 39).reshape(-1)
    y = np.clip(ly[:, None] + d[:, 1:2] * steps, 0, 39).reshape(-1)
    z = np.clip(lz[:, None] + d[:, 2:3] * steps, 0, 23).reshape(-1)
    val = rng.uniform(0.01, 1.0, x.shape).astype(np.float32)
    val[rng.uniform(size=x.shape) < 0.3] = 0.0
    return shape, x, y, z, val


CASES = {
    "clustered": _clustered,
    "scattered_worst_case": _scattered,
    "collisions_and_padding": _collisions_and_padding,
    "corner_extremes": _corner_extremes,
    "all_dead_chunk": _all_dead,
    "large_random": _large_random,
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_deposit_matches_pallas_kernel(case):
    import jax.numpy as jnp

    from rsmcrt_tpu.transport.deposit import deposit_delta as jdeposit_delta

    shape, x, y, z, val = CASES[case](np.random.default_rng(11))
    want = np.asarray(jdeposit_delta(
        shape, jnp.asarray(x, jnp.int32), jnp.asarray(y, jnp.int32),
        jnp.asarray(z, jnp.int32), jnp.asarray(val, jnp.float32),
        chunk=128, tx=8, ty=8, interpret=True))
    got = tdep.deposit_delta(
        shape, torch.as_tensor(x, dtype=torch.int32),
        torch.as_tensor(y, dtype=torch.int32),
        torch.as_tensor(z, dtype=torch.int32), torch.as_tensor(val))
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * max(float(want.max()), 1.0))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_deposit_bf16_matches_pallas_kernel(case):
    """``dot_dtype`` bfloat16: each value rounded to bfloat16 before the
    float32 sum, in both packages (same tolerance as above)."""
    import jax.numpy as jnp

    from rsmcrt_tpu.transport.deposit import deposit_delta as jdeposit_delta

    shape, x, y, z, val = CASES[case](np.random.default_rng(11))
    want = np.asarray(jdeposit_delta(
        shape, jnp.asarray(x, jnp.int32), jnp.asarray(y, jnp.int32),
        jnp.asarray(z, jnp.int32), jnp.asarray(val, jnp.float32),
        chunk=128, tx=8, ty=8, interpret=True, dot_dtype=jnp.bfloat16))
    got = tdep.deposit_delta(
        shape, torch.as_tensor(x, dtype=torch.int32),
        torch.as_tensor(y, dtype=torch.int32),
        torch.as_tensor(z, dtype=torch.int32), torch.as_tensor(val),
        dot_dtype=torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * max(float(want.max()), 1.0))


def test_deposit_add_accumulates_in_place_and_skips_nonpositive():
    tally = torch.zeros(27, dtype=torch.float32)
    tally[4] = 2.0
    idx = torch.tensor([4, 4, 26, 0, 13, 13], dtype=torch.int32)
    val = torch.tensor([1.0, 0.5, 3.0, -1.0, 0.0, float("nan")])
    before = tdep.deposit_plain_calls
    out = tdep.deposit_add_(tally, idx, val)
    assert out is tally
    assert tdep.deposit_plain_calls == before + 1
    want = torch.zeros(27)
    want[4], want[26] = 3.5, 3.0
    torch.testing.assert_close(tally, want, rtol=0, atol=0)
    tdep.deposit_add_(tally, idx, val)  # a second call adds again
    torch.testing.assert_close(tally, 2 * want - torch.eye(27)[4] * 2.0,
                               rtol=0, atol=0)


def test_deposit_add_rejects_bad_arguments():
    t = torch.zeros(8)
    with pytest.raises(TypeError):
        tdep.deposit_add_(t, torch.zeros(3, dtype=torch.int64),
                          torch.ones(3))
    with pytest.raises(ValueError):
        tdep.deposit_add_(t, torch.zeros(3, dtype=torch.int32),
                          torch.ones(4))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(12)
    n_cells = 64 ** 3
    n = 1 << 20
    idx = rng.integers(0, n_cells, (n,)).astype(np.int32)
    idx[: n // 4] = 1234  # a hot voxel: many colliding atomics
    val = rng.uniform(-0.5, 1.0, (n,)).astype(np.float32)
    ti, tv = torch.as_tensor(idx), torch.as_tensor(val)
    want = tdep.deposit_add_plain(torch.zeros(n_cells), ti, tv)
    before = tdep.deposit_kernel_launches
    got = tdep.deposit_add_(torch.zeros(n_cells, device=cuda_device),
                            ti.to(cuda_device), tv.to(cuda_device))
    torch.cuda.synchronize(cuda_device)
    assert tdep.deposit_kernel_launches == before + 1
    # float atomics add in a run-dependent order: the hot voxel's float32
    # sum of ~2.6e5 terms differs by rounding between the two orders
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)
    assert tdep.out_of_range_count(cuda_device) == 0


def _design_case(case, rng):
    """Rows aimed at the warp-combining kernel's paths: cell count, int32
    indices, float32 values (100,003 rows: the last 4-row group is
    short)."""
    n_cells = 64 ** 3
    n = 100_003
    if case == "one_cell":
        idx = np.full(n, 4321)
        val = rng.uniform(0.0, 1.0, n)
    elif case == "distinct":
        idx = rng.permutation(n_cells)[:n]
        val = rng.uniform(0.0, 1.0, n)
    elif case == "runs":  # equal indices across threads, slots and warps
        idx = np.repeat(rng.integers(0, n_cells, n),
                        rng.integers(1, 10, n))[:n]
        val = rng.uniform(0.0, 1.0, n)
    else:  # a few hot cells, NaN and negative values
        idx = rng.integers(0, 40, n)
        val = rng.uniform(-1.0, 1.0, n)
        val[rng.uniform(size=n) < 0.05] = np.nan
    return (n_cells, torch.as_tensor(idx.astype(np.int32)),
            torch.as_tensor(val.astype(np.float32)))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["one_cell", "distinct", "runs",
                                  "nan_negative"])
def test_cuda_kernel_designs_match_plain(cuda_device, case, dtype, offset):
    """One cell, all distinct, runs of equal indices, NaN and negative
    values; ``offset`` 1 makes misaligned views (the scalar loads).  rtol
    1e-4 of the largest cell, as chip_smoke.py phase 3 (1e-3 for one cell
    of 100,000 terms, against a float64 sum too)."""
    n_cells, idx, val = _design_case(case, np.random.default_rng(41))
    idx, val = idx[offset:], val[offset:]
    tdt = getattr(torch, dtype)
    want = tdep.deposit_add_plain(torch.zeros(n_cells), idx, val, tdt)
    before = tdep.deposit_kernel_launches
    got = tdep.deposit_add_(torch.zeros(n_cells, device=cuda_device),
                            idx.to(cuda_device), val.to(cuda_device),
                            tdt).cpu()
    assert tdep.deposit_kernel_launches == before + 1
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    rtol = 1e-3 if case == "one_cell" else 1e-4
    assert err <= rtol * scale, (err, scale)
    if case == "one_cell" and dtype == "float32":
        ref = float(val.double().clamp(min=0.0).sum())
        assert abs(float(got[4321]) - ref) <= 1e-3 * ref


def _signed_case(case, rng):
    """Rows of both signs for each warp-combining tier: one cell whose
    rows come in +x / -x pairs (one group, a shuffle sum of ~0), runs of
    equal indices with mixed signs, and scattered rows with zeros, NaN and
    +-inf."""
    n_cells, n = 64 ** 3, 100_003
    if case == "cancelling":
        idx = np.full(n, 777)
        x = rng.uniform(0.0, 1.0, n // 2 + 1)
        val = np.stack([x, -x], axis=-1).reshape(-1)[:n]
    elif case == "runs":
        idx = np.repeat(rng.integers(0, n_cells, n),
                        rng.integers(1, 10, n))[:n]
        val = rng.uniform(-1.0, 1.0, n)
    else:
        idx = rng.integers(0, n_cells, n)
        val = rng.uniform(-1.0, 1.0, n)
        val[rng.uniform(size=n) < 0.1] = 0.0
        val[::89] = np.nan
        val[3::89] = np.inf
        val[5::89] = -np.inf
    return (n_cells, torch.as_tensor(idx.astype(np.int32)),
            torch.as_tensor(val.astype(np.float32)))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("case", ["cancelling", "runs", "scattered"])
def test_cuda_signed_kernel_matches_plain(cuda_device, case, offset):
    """The signed instantiation keeps every finite non-zero row, as its
    plain twin does: atol 1e-4 of the largest cell of |val| (the float
    atomics add in a run-dependent order, and a cell's terms may cancel);
    the unsigned one still drops the negative rows."""
    n_cells, idx, val = _signed_case(case, np.random.default_rng(43))
    idx, val = idx[offset:], val[offset:]
    keep = torch.isfinite(val) & (val != 0.0)
    scale = float(tdep.deposit_add_plain(torch.zeros(n_cells), idx,
                                         torch.where(keep, val.abs(), 0.0)
                                         ).max())
    for signed in (True, False):
        want = tdep.deposit_add_plain(torch.zeros(n_cells), idx, val,
                                      signed=signed)
        before = tdep.deposit_kernel_launches
        got = tdep.deposit_add_(torch.zeros(n_cells, device=cuda_device),
                                idx.to(cuda_device), val.to(cuda_device),
                                signed=signed).cpu()
        assert tdep.deposit_kernel_launches == before + 1
        # +inf rows are kept without ``signed``: their cells are inf in both
        torch.testing.assert_close(got, want, rtol=0.0, atol=1e-4 * scale)
        if not signed:
            assert not bool((got < 0).any())
        elif case != "cancelling":
            assert bool((got < 0).any())
    assert tdep.out_of_range_count(cuda_device) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_kernel_counts_each_bad_row(cuda_device, offset):
    """Live rows with an index outside the tally are counted once a row,
    also when a warp's rows share the bad index; rows with val <= 0 are
    not counted; nothing is written for them."""
    rng = np.random.default_rng(42)
    n_cells, n = 1000, 4099
    idx = rng.integers(0, n_cells, n).astype(np.int32)
    val = rng.uniform(0.1, 1.0, n).astype(np.float32)
    idx[64:128] = -3  # one bad index shared by a warp's rows
    idx[200:204] = n_cells  # four in one thread
    idx[1000::97] = n_cells + 12345
    val[64:80] = 0.0  # dead under a bad index: not counted
    val[1000::194] = -1.0
    ti, tv = torch.as_tensor(idx)[offset:], torch.as_tensor(val)[offset:]
    bad = ((ti < 0) | (ti >= n_cells)) & (tv > 0)
    before = tdep.out_of_range_count(cuda_device)
    got = tdep.deposit_add_(torch.zeros(n_cells, device=cuda_device),
                            ti.to(cuda_device), tv.to(cuda_device))
    torch.cuda.synchronize(cuda_device)
    assert tdep.out_of_range_count(cuda_device) == before + int(bad.sum())
    want = tdep.deposit_add_plain(torch.zeros(n_cells),
                                  torch.where(bad, 0, ti),
                                  torch.where(bad, 0.0, tv))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    # leave the card's count at 0 for the tests that read it whole
    tdep._bad_counter(cuda_device).zero_()
