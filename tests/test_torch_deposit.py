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


def _at(t, offset, device):
    """``t`` on ``device``, ``offset`` elements into a fresh buffer: with
    ``offset`` 1 the pointer sits 4 or 8 bytes past a 16-byte boundary,
    so the kernel takes its scalar loads (a sliced CPU tensor copied to
    the card would start aligned again)."""
    out = torch.empty(t.numel() + offset, dtype=t.dtype,
                      device=device)[offset:]
    return out.copy_(t)


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


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("layout", ["expanded", "expanded_0d", "contiguous",
                                    "every_2nd", "every_3rd"])
def test_gather_operand_reads_stride_0_and_1_as_they_are(layout, dtype):
    """An expanded gradient keeps stride 0 and its storage (one value,
    never materialised), a contiguous one stride 1 and its tensor; any
    other stride is made contiguous, with the same values."""
    tdt = getattr(torch, dtype)
    base = torch.arange(3000, dtype=tdt)
    grad = {"expanded": torch.full((1,), 2.5, dtype=tdt).expand(1000),
            "expanded_0d": torch.full((), 2.5, dtype=tdt).expand(1000),
            "contiguous": base[:1000],
            "every_2nd": base[::2][:1000],
            "every_3rd": base[::3]}[layout]
    g, s = tdep.gather_operand(grad)
    assert g.shape == grad.shape and torch.equal(g, grad)
    if layout.startswith("expanded"):
        assert s == 0 and g.data_ptr() == grad.data_ptr()
        assert g.untyped_storage().nbytes() == grad.element_size()
    elif layout == "contiguous":
        assert s == 1 and g is grad
    else:
        assert s == 1 and g.is_contiguous()


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_gather_of_an_expanded_gradient_on_cpu(dtype, signed):
    """``deposit_gather`` on the CPU with the expanded gradient the
    backward of a sum hands it equals the plain twin on the materialised
    gradient, row by row (kept rows in range get the value, all others
    0)."""
    tdt = getattr(torch, dtype)
    idx = torch.tensor([0, 5, -1, 12, 3, 3, 9], dtype=torch.int32)
    val = torch.tensor([1.0, 0.0, 2.0, 1.0, -1.0, float("nan"), 0.5],
                       dtype=tdt)
    grad = torch.full((), 0.125, dtype=tdt).expand(10)
    before = tdep.gather_plain_calls
    got = tdep.deposit_gather(grad, idx, val, signed=signed)
    assert tdep.gather_plain_calls == before + 1
    want = tdep.deposit_gather_plain(grad.contiguous(), idx, val, signed)
    assert torch.equal(got, want)
    kept = ([0.125, 0.0, 0.0, 0.0, 0.125, 0.0, 0.125] if signed else
            [0.125, 0.0, 0.0, 0.0, 0.0, 0.0, 0.125])
    assert got.tolist() == kept


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_gather_of_an_expanded_gradient_is_the_plain_backward(dtype,
                                                               signed):
    """``deposit_gather`` of the expanded gradient that the backward of a
    sum hands it equals the gradient autograd takes through the plain
    twin on the CPU: the gather is the deposit's transpose."""
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(5)
    n_cells, n = 50, 203
    idx = torch.as_tensor(rng.integers(0, n_cells, n).astype(np.int32))
    val = torch.as_tensor(rng.uniform(-0.5, 1.0, n)).to(tdt)
    val[::17] = float("nan")
    val.requires_grad_(True)
    tally = tdep.deposit_add_(torch.zeros(n_cells, dtype=tdt), idx, val,
                              signed=signed)
    (want,) = torch.autograd.grad(tally.sum(), val)
    ones = torch.ones((), dtype=tdt).expand(n_cells)
    got = tdep.deposit_gather(ones, idx, val.detach(), signed)
    assert torch.equal(got, want)


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
    elif case == "long_runs":  # one index a slot, a warp, a block or more
        idx = np.repeat(rng.integers(0, n_cells, n),
                        rng.integers(20, 3000, n))[:n]
        val = rng.uniform(-0.2, 1.0, n)
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
                            _at(idx, offset, cuda_device),
                            _at(val, offset, cuda_device), tdt).cpu()
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
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("case", ["cancelling", "runs", "scattered"])
def test_cuda_signed_kernel_matches_plain(cuda_device, case, offset, dtype):
    """The signed instantiation keeps every finite non-zero row, as its
    plain twin does: atol 1e-4 (float32) or 1e-12 (float64) of the
    largest cell of |val| (atomics add in a run-dependent order, and a
    cell's terms may cancel); the unsigned one still drops the negative
    rows."""
    n_cells, idx, val = _signed_case(case, np.random.default_rng(43))
    idx, val = idx[offset:], val[offset:].to(getattr(torch, dtype))
    atol = 1e-4 if dtype == "float32" else 1e-12
    keep = torch.isfinite(val) & (val != 0.0)
    zeros = torch.zeros(n_cells, dtype=val.dtype)
    scale = float(tdep.deposit_add_plain(zeros.clone(), idx,
                                         torch.where(keep, val.abs(), 0.0)
                                         ).max())
    for signed in (True, False):
        want = tdep.deposit_add_plain(zeros.clone(), idx, val, signed=signed)
        before = tdep.deposit_kernel_launches
        got = tdep.deposit_add_(zeros.to(cuda_device),
                                _at(idx, offset, cuda_device),
                                _at(val, offset, cuda_device),
                                signed=signed).cpu()
        assert tdep.deposit_kernel_launches == before + 1
        # +inf rows are kept without ``signed``: their cells are inf in both
        torch.testing.assert_close(got, want, rtol=0.0, atol=atol * scale)
        if not signed:
            assert not bool((got < 0).any())
        elif case != "cancelling":
            assert bool((got < 0).any())
    assert tdep.out_of_range_count(cuda_device) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_kernel_counts_each_bad_row(cuda_device, offset, dtype):
    """Live rows with an index outside the tally are counted once a row,
    also when a warp's rows share the bad index; rows with val <= 0 are
    not counted; nothing is written for them.  The same in float64."""
    rng = np.random.default_rng(42)
    n_cells, n = 1000, 4099
    idx = rng.integers(0, n_cells, n).astype(np.int32)
    val = rng.uniform(0.1, 1.0, n).astype(np.float32)
    idx[64:128] = -3  # one bad index shared by a warp's rows
    idx[200:204] = n_cells  # four in one thread
    idx[1000::97] = n_cells + 12345
    val[64:80] = 0.0  # dead under a bad index: not counted
    val[1000::194] = -1.0
    tdt = getattr(torch, dtype)
    ti = torch.as_tensor(idx)[offset:]
    tv = torch.as_tensor(val)[offset:].to(tdt)
    bad = ((ti < 0) | (ti >= n_cells)) & (tv > 0)
    before = tdep.out_of_range_count(cuda_device)
    got = tdep.deposit_add_(torch.zeros(n_cells, dtype=tdt,
                                        device=cuda_device),
                            _at(ti, offset, cuda_device),
                            _at(tv, offset, cuda_device))
    torch.cuda.synchronize(cuda_device)
    assert tdep.out_of_range_count(cuda_device) == before + int(bad.sum())
    want = tdep.deposit_add_plain(torch.zeros(n_cells, dtype=tdt),
                                  torch.where(bad, 0, ti),
                                  torch.where(bad, 0.0, tv))
    tol = 1e-5 if dtype == "float32" else 1e-12
    torch.testing.assert_close(got.cpu(), want, rtol=tol, atol=tol)
    # leave the card's count at 0 for the tests that read it whole
    tdep._bad_counter(cuda_device).zero_()


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("case", ["one_cell", "distinct", "runs",
                                  "long_runs", "nan_negative"])
def test_cuda_f64_kernel_matches_plain(cuda_device, case, offset):
    """The double instantiation on the same rows in float64: rtol 1e-12
    of the largest cell (float64 atomics add in a run-dependent order)."""
    n_cells, idx, val = _design_case(case, np.random.default_rng(41))
    idx, val = idx[offset:], val[offset:].double()
    want = tdep.deposit_add_plain(torch.zeros(n_cells, dtype=torch.float64),
                                  idx, val)
    before = tdep.deposit_kernel_launches
    got = tdep.deposit_add_(
        torch.zeros(n_cells, dtype=torch.float64, device=cuda_device),
        _at(idx, offset, cuda_device), _at(val, offset, cuda_device)).cpu()
    assert tdep.deposit_kernel_launches == before + 1
    assert got.dtype == torch.float64
    err = float((got - want).abs().max())
    assert err <= 1e-12 * float(want.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_f64_kernel_on_a_full_tally_matches_plain(cuda_device, offset):
    """The double deposit over a 200^3 float64 tally (64 MB): rows spread
    over the tally, a hot cell taking a tenth of them (merged across each
    block), NaN, negative and out-of-range rows.  rtol 1e-12 of the
    largest cell; each bad row counted once; one launch."""
    rng = np.random.default_rng(44)
    n_cells, n = 200 ** 3, 300_007
    idx = rng.integers(0, n_cells, n)
    idx[: n // 10] = n_cells // 2
    idx[n // 10: n // 10 + 64] = n_cells // 2 - 1
    idx[5000::1013] = n_cells + 3
    idx[6000::2027] = -1
    val = rng.uniform(-0.2, 1.0, n)
    val[rng.uniform(size=n) < 0.02] = np.nan
    ti = torch.as_tensor(idx.astype(np.int32))[offset:]
    tv = torch.as_tensor(val)[offset:]
    bad = ((ti < 0) | (ti >= n_cells)) & (tv > 0)
    want = tdep.deposit_add_plain(torch.zeros(n_cells, dtype=torch.float64),
                                  torch.where(bad, 0, ti),
                                  torch.where(bad, 0.0, tv))
    tally = torch.zeros(n_cells, dtype=torch.float64, device=cuda_device)
    before = tdep.deposit_kernel_launches
    bad_before = tdep.out_of_range_count(cuda_device)
    tdep.deposit_add_(tally, _at(ti, offset, cuda_device),
                      _at(tv, offset, cuda_device))
    torch.cuda.synchronize(cuda_device)
    assert tdep.deposit_kernel_launches == before + 1
    assert tdep.out_of_range_count(cuda_device) == bad_before + int(bad.sum())
    err = float((tally.cpu() - want).abs().max())
    assert err <= 1e-12 * float(want.abs().max()), err
    tdep._bad_counter(cuda_device).zero_()


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_gather_matches_plain(cuda_device, dtype, signed, offset):
    """The backward kernel equals its plain twin exactly (a gather sums
    nothing), on rows with zeros, NaN, inf, negative values and indices
    out of range."""
    n_cells, idx, val = _signed_case("scattered", np.random.default_rng(5))
    idx = idx.clone()
    idx[::101] = n_cells + 7
    idx[1::101] = -3
    tdt = getattr(torch, dtype)
    idx, val = idx[offset:], val[offset:].to(tdt)
    grad = torch.randn(n_cells, generator=torch.Generator().manual_seed(2),
                       dtype=tdt)
    want = tdep.deposit_gather_plain(grad, idx, val, signed)
    before = tdep.gather_kernel_launches
    i, v = _at(idx, offset, cuda_device), _at(val, offset, cuda_device)
    got = tdep.deposit_gather(grad.to(cuda_device), i, v, signed).cpu()
    assert tdep.gather_kernel_launches == before + 1
    assert torch.equal(got, want)
    # an expanded (stride 0) gradient, as the backward of a sum hands it
    ones = torch.ones((), dtype=tdt, device=cuda_device).expand(n_cells)
    got = tdep.deposit_gather(ones, i, v, signed).cpu()
    assert torch.equal(got, tdep.deposit_gather_plain(
        torch.ones(n_cells, dtype=tdt), idx, val, signed))


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [0, 1, 2])
@pytest.mark.parametrize("offset", [0, 1, 2])
@pytest.mark.parametrize("n", [262_144, 1_001])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_gather_layouts_match_plain(cuda_device, dtype, n, offset,
                                         stride):
    """The gather's vector and scalar paths: phase 24's 262,144 rows and
    a length that is not a multiple of 4, aligned and unaligned (``offset``
    1 and 2) pointers, an expanded (stride 0), a contiguous and a strided
    gradient; equal to the plain twin on the materialised gradient.  An
    expanded gradient is never materialised: the call allocates its
    output and nothing else."""
    rng = np.random.default_rng(17)
    n_cells = 64 ** 3
    tdt = getattr(torch, dtype)
    idx = torch.as_tensor(rng.integers(-5, n_cells + 5, n).astype(np.int32))
    val = torch.as_tensor(rng.uniform(-0.5, 1.0, n)).to(tdt)
    if stride == 0:
        grad = torch.full((1,), 0.75, dtype=tdt).expand(n_cells)
    else:
        grad = torch.randn(n_cells * stride, dtype=tdt,
                           generator=torch.Generator().manual_seed(3))
        grad = grad[::stride]
    want = tdep.deposit_gather_plain(grad.contiguous(), idx, val)
    i, v = _at(idx, offset, cuda_device), _at(val, offset, cuda_device)
    g = grad.to(cuda_device)
    if stride == 0:
        g = g[:1].expand(n_cells)
    else:  # a strided view of the card's own buffer
        g = torch.empty(n_cells * stride, dtype=tdt,
                        device=cuda_device)[::stride]
        g.copy_(grad)
    assert g.stride(0) == stride
    torch.cuda.synchronize(cuda_device)
    torch.cuda.reset_peak_memory_stats(cuda_device)
    held = torch.cuda.memory_allocated(cuda_device)
    before = tdep.gather_kernel_launches
    got = tdep.deposit_gather(g, i, v)
    extra = torch.cuda.max_memory_allocated(cuda_device) - held
    assert tdep.gather_kernel_launches == before + 1
    assert torch.equal(got.cpu(), want)
    if stride == 0:
        assert extra <= got.numel() * got.element_size() + 512, extra


@pytest.mark.cuda
def test_cuda_deposit_type_and_grad_rules(cuda_device):
    """An f64 tally refuses f32 values; bfloat16 refuses float64 values
    and grad mode; under grad mode the deposit goes through the autograd
    Function and the backward launches the gather kernel."""
    idx = torch.tensor([0, 3, 3, 9], dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        tdep.deposit_add_(torch.zeros(10, dtype=torch.float64,
                                      device=cuda_device), idx,
                          torch.ones(4, device=cuda_device))
    with pytest.raises(TypeError):
        tdep.deposit_add_(torch.zeros(10, dtype=torch.float64,
                                      device=cuda_device), idx,
                          torch.ones(4, dtype=torch.float64,
                                     device=cuda_device), torch.bfloat16)
    v = torch.tensor([1.0, 2.0, -1.0, 4.0], device=cuda_device,
                     requires_grad=True)
    with pytest.raises(RuntimeError, match="not differentiable"):
        tdep.deposit_add_(torch.zeros(10, device=cuda_device), idx, v,
                          torch.bfloat16)
    tally = torch.zeros(10, device=cuda_device)
    calls, gathers = tdep.deposit_autograd_calls, tdep.gather_kernel_launches
    tdep.deposit_add_(tally, idx, v * 3.0)
    w = torch.arange(10.0, device=cuda_device)
    (g,) = torch.autograd.grad((tally * w).sum(), v)
    assert tdep.deposit_autograd_calls == calls + 1
    assert tdep.gather_kernel_launches == gathers + 1
    assert g.cpu().tolist() == [0.0, 9.0, 0.0, 27.0]
    assert tally.detach().cpu().tolist() == [
        3.0, 0.0, 0.0, 6.0, 0.0, 0.0, 0.0, 0.0, 0.0, 12.0]
