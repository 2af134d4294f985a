"""The port's windowed deposit against the reference's Pallas
``_window_kernel``.

``deposit_window_delta`` / ``deposit_window_packed`` of the port (their
plain twin, on CPU tensors) are held against
``rsmcrt_tpu.transport.deposit.deposit_window_delta`` run in Pallas
interpret mode, on the three ``tests/test_deposit.py::test_window_*``
input mixes, in float32 and with ``dot_dtype`` bfloat16.  Tolerance rtol
1e-5, atol 1e-5 * max: both sum float32 values (rounded to bfloat16 first
in the bf16 cases) in different orders.  The Morton and packed keys must
be bit-equal.  The CUDA kernel itself is compared with the plain version
by the ``cuda``-marked tests, which need a card.  JAX is imported inside
the parity tests only, so the ``cuda`` tests also run on a machine
without JAX (see ``test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from rsmcrt_tpu_torch.transport import deposit as tdep
from test_torch_deposit import _at

torch.set_num_threads(1)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _jax():
    import jax.numpy as jnp

    from rsmcrt_tpu.transport import deposit as jdep

    return jnp, jdep


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _clustered_and_garbage():
    # tests/test_deposit.py::test_window_clustered_and_garbage, with the
    # port's Morton key (bit-equal to the reference's, tested below)
    rng = np.random.default_rng(3)
    shape = (40, 37, 24)  # deliberately 8-unaligned ny
    m = 96
    lx = rng.integers(0, 40, (m,))
    ly = rng.integers(0, 37, (m,))
    lz = rng.integers(0, 24, (m,))
    d = rng.integers(-1, 2, (m, 3))
    steps = np.arange(8)
    x = np.clip(lx[:, None] + d[:, 0:1] * steps, 0, 39).reshape(-1)
    y = np.clip(ly[:, None] + d[:, 1:2] * steps, 0, 36).reshape(-1)
    z = np.clip(lz[:, None] + d[:, 2:3] * steps, 0, 23).reshape(-1)
    val = rng.uniform(0.01, 1.0, x.shape).astype(np.float32)
    val[rng.uniform(size=x.shape) < 0.3] = 0.0
    x = np.where(val == 0, -7, x)  # garbage coords on dead rows
    key = tdep.morton_key_3d(_i32(x), _i32(y), _i32(z)).numpy()
    o = np.argsort(key, kind="stable")
    return shape, x[o], y[o], z[o], val[o], dict(chunk=256,
                                                 window=(16, 16, 16))


def _corners_collisions_unsorted():
    shape = (24, 24, 16)
    x = np.array([0, 23, 0, 23, 12, 12, 12, 5])
    y = np.array([0, 0, 23, 23, 11, 11, 11, 20])
    z = np.array([0, 15, 15, 0, 8, 8, 8, 3])
    val = np.array([1, 2, 3, 4, 5, 6, 7, 8], np.float32)
    return shape, x, y, z, val, dict(chunk=128, window=(16, 16, 8))


def _all_dead_and_tiny_grid():
    shape = (8, 8, 8)  # grid smaller than the default window
    n = 64
    x = np.concatenate([np.zeros(n, int), [0, 7, 3]])
    val = np.concatenate([np.zeros(n, np.float32),
                          np.array([1.0, 2.0, 3.0], np.float32)])
    return shape, x, x, x, val, dict(chunk=128, window=(32, 32, 32))


CASES = {
    "clustered_and_garbage": _clustered_and_garbage,
    "corners_collisions_unsorted": _corners_collisions_unsorted,
    "all_dead_and_tiny_grid": _all_dead_and_tiny_grid,
}


def _i32(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.int32)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * max(float(np.abs(want).max()),
                                               1.0))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_plain_window_matches_pallas_kernel(case, dtype):
    jnp, jdep = _jax()
    shape, x, y, z, val, kw = CASES[case]()
    jdt, tdt = getattr(jnp, dtype), DTYPES[dtype]
    want = np.asarray(jdep.deposit_window_delta(
        shape, jnp.asarray(x, jnp.int32), jnp.asarray(y, jnp.int32),
        jnp.asarray(z, jnp.int32), jnp.asarray(val, jnp.float32),
        interpret=True, dot_dtype=jdt, **kw))
    before = tdep.window_plain_calls
    got = tdep.deposit_window_delta(shape, _i32(x), _i32(y), _i32(z),
                                    torch.as_tensor(val), dot_dtype=tdt,
                                    **kw)
    assert tdep.window_plain_calls == before + 1
    assert got.shape == shape and got.dtype == torch.float32
    _close(got.numpy(), want)


def test_packed_adds_nonpositive_values_like_the_reference():
    # deposit_window_packed adds every live key, val <= 0 included; only
    # deposit_window_delta masks.  (wy = 16: with wy = 8 the reference's
    # 8-aligned window origin can miss its own anchor, and its loop never
    # ends)
    jnp, jdep = _jax()
    rng = np.random.default_rng(5)
    shape = (20, 13, 9)
    n = 700
    x, y, z = (rng.integers(0, s, (n,)) for s in shape)
    val = rng.uniform(-1.0, 1.0, (n,)).astype(np.float32)
    live = rng.uniform(size=n) < 0.8
    jkeys = jdep.pack_deposit_key(jnp.asarray(x, jnp.int32),
                                  jnp.asarray(y, jnp.int32),
                                  jnp.asarray(z, jnp.int32),
                                  jnp.asarray(live))
    want = np.asarray(jdep.deposit_window_packed(
        shape, jkeys, jnp.asarray(val), chunk=256, window=(8, 16, 8),
        interpret=True))
    keys = tdep.pack_deposit_key(_i32(x), _i32(y), _i32(z),
                                 torch.as_tensor(live))
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys))
    got = tdep.deposit_window_packed(shape, keys, torch.as_tensor(val),
                                     chunk=256, window=(8, 16, 8))
    _close(got.numpy(), want)


def test_keys_are_bit_equal_to_the_reference():
    jnp, jdep = _jax()
    rng = np.random.default_rng(8)
    n = 4096
    a, b, c = (rng.integers(-70_000, 70_000, (n,)).astype(np.int32)
               for _ in range(3))
    small = [rng.integers(0, 1024, (n,)).astype(np.int32) for _ in range(3)]
    live = rng.uniform(size=n) < 0.5
    J = [jnp.asarray(v) for v in (a, b, c)]
    T = [torch.as_tensor(v) for v in (a, b, c)]
    np.testing.assert_array_equal(tdep.morton_key_3d(*T).numpy(),
                                  np.asarray(jdep.morton_key_3d(*J)))
    np.testing.assert_array_equal(tdep.morton_key_xy(*T[:2]).numpy(),
                                  np.asarray(jdep.morton_key_xy(*J[:2])))
    for coords in ([a, b, c], small):
        got = tdep.pack_deposit_key(*map(torch.as_tensor, coords),
                                    torch.as_tensor(live))
        want = jdep.pack_deposit_key(*map(jnp.asarray, coords),
                                     jnp.asarray(live))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _out_of_grid_mix():
    """In-grid keys plus live keys the reference cannot take: x beyond
    the grid, y in the 8-row padding, z beyond, negative coordinates."""
    shape = (10, 13, 6)  # ny pads to 16
    rng = np.random.default_rng(4)
    n = 300
    x, y, z = (rng.integers(0, s, (n,)) for s in shape)
    val = rng.uniform(0.1, 1.0, (n,)).astype(np.float32)
    bad = np.array([[10, 0, 0], [0, 14, 0], [0, 0, 6], [-1, 2, 2],
                    [1023, 1023, 1023]])
    keys = tdep.pack_deposit_key(
        _i32(np.concatenate([x, bad[:, 0]])),
        _i32(np.concatenate([y, bad[:, 1]])),
        _i32(np.concatenate([z, bad[:, 2]])),
        torch.ones(n + len(bad), dtype=torch.bool))
    vals = torch.as_tensor(np.concatenate([val, np.ones(len(bad),
                                                        np.float32)]))
    want = np.zeros(shape, np.float32)
    np.add.at(want, (x, y, z), val)
    return shape, keys, vals, want, len(bad)


def test_out_of_grid_keys_are_counted_not_written():
    shape, keys, vals, want, n_bad = _out_of_grid_mix()
    before = tdep.out_of_range_count("cpu")
    got = tdep.deposit_window_packed(shape, keys, vals, chunk=128,
                                     window=(8, 8, 8))
    assert tdep.out_of_range_count("cpu") == before + n_bad
    _close(got.numpy(), want)


def test_window_entry_point_checks_like_the_reference():
    k = torch.zeros(4, dtype=torch.int32)
    v = torch.ones(4)
    with pytest.raises(ValueError, match="1024"):
        tdep.deposit_window_packed((1025, 8, 8), k, v)
    with pytest.raises(ValueError, match="chunk"):
        tdep.deposit_window_packed((8, 8, 8), k, v, chunk=100)
    with pytest.raises(ValueError, match="wy"):
        tdep.deposit_window_packed((64, 64, 64), k, v, window=(32, 12, 32))
    with pytest.raises(ValueError, match="chunk"):
        tdep.deposit_window_packed((8, 8, 8), k, v, chunk=0)
    with pytest.raises(TypeError):
        tdep.deposit_window_packed((8, 8, 8), k.long(), v)
    # a window larger than the grid or shared memory is not refused: it
    # sizes nothing; the kernel's hash table is sized by the chunk
    got = tdep.deposit_window_packed((8, 8, 8), k, v, window=(64, 64, 64))
    assert float(got.sum()) == 4.0


@pytest.mark.parametrize("chunk,bits", [(128, 8), (256, 9), (1536, 12),
                                        (2048, 12), (16384, 12)])
def test_table_slots_hold_twice_the_chunk_up_to_the_cap(chunk, bits):
    assert tdep.table_slot_bits(chunk) == bits
    slots = 1 << bits
    assert slots >= 2 * chunk or slots == tdep.MAX_TABLE_SLOTS
    assert slots <= tdep.MAX_TABLE_SLOTS


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_window_kernel_matches_plain(cuda_device, case, dtype):
    shape, x, y, z, val, kw = CASES[case]()
    tdt = DTYPES[dtype]
    want = tdep.deposit_window_delta(shape, _i32(x), _i32(y), _i32(z),
                                     torch.as_tensor(val), dot_dtype=tdt,
                                     **kw)
    before = tdep.window_kernel_launches
    got = tdep.deposit_window_delta(
        shape, _i32(x).to(cuda_device), _i32(y).to(cuda_device),
        _i32(z).to(cuda_device), torch.as_tensor(val).to(cuda_device),
        dot_dtype=tdt, **kw)
    torch.cuda.synchronize(cuda_device)
    assert tdep.window_kernel_launches == before + 1
    _close(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
def test_cuda_window_kernel_spread_input_and_counter(cuda_device):
    # unsorted keys over a large grid exceed the round cap: the rest take
    # the kernel's direct atomics; out-of-grid keys are only counted
    rng = np.random.default_rng(6)
    shape = (200, 200, 200)
    n = 1 << 18
    x, y, z = (rng.integers(0, 200, (n,)) for _ in range(3))
    val = rng.uniform(-0.5, 1.0, (n,)).astype(np.float32)
    keys = tdep.pack_deposit_key(_i32(x), _i32(y), _i32(z),
                                 torch.as_tensor(val > -0.25))
    tv = torch.as_tensor(val)
    want = tdep.deposit_window_packed_plain(shape, keys, tv)
    got = tdep.deposit_window_packed(shape, keys.to(cuda_device),
                                     tv.to(cuda_device))
    torch.cuda.synchronize(cuda_device)
    _close(got.cpu().numpy(), want.numpy())
    assert tdep.out_of_range_count(cuda_device) == 0
    shape, keys, vals, want, n_bad = _out_of_grid_mix()
    got = tdep.deposit_window_packed(shape, keys.to(cuda_device),
                                     vals.to(cuda_device), chunk=128,
                                     window=(8, 8, 8))
    torch.cuda.synchronize(cuda_device)
    assert tdep.out_of_range_count(cuda_device) == n_bad
    _close(got.cpu().numpy(), want)


@pytest.mark.cuda
def test_cuda_deposit_add_bf16_matches_plain(cuda_device):
    rng = np.random.default_rng(13)
    n_cells = 32 ** 3
    idx = torch.as_tensor(rng.integers(0, n_cells, (1 << 16,)),
                          dtype=torch.int32)
    val = torch.as_tensor(rng.uniform(-0.5, 1.0, (1 << 16,)),
                          dtype=torch.float32)
    want = tdep.deposit_add_plain(torch.zeros(n_cells), idx, val,
                                  torch.bfloat16)
    got = tdep.deposit_add_(torch.zeros(n_cells, device=cuda_device),
                            idx.to(cuda_device), val.to(cuda_device),
                            torch.bfloat16)
    torch.cuda.synchronize(cuda_device)
    _close(got.cpu().numpy(), want.numpy())


def _window_design_case(case, rng):
    """Inputs aimed at the hash-table kernel's paths: keys, values, grid
    and chunk."""
    shape = (50, 60, 70)
    cells = int(np.prod(shape))
    chunk = 2048
    n = 50_001  # not a multiple of 4: the last group is short
    if case == "one_cell":
        flat = np.full(n, 12345)
    elif case == "distinct":
        flat = rng.permutation(cells)[:n]
    elif case == "overflow":
        # every chunk holds more distinct cells than the table's 4096 slots
        chunk = 16384
        n = 3 * chunk + 5
        flat = rng.permutation(cells)[:n]
    else:  # runs of equal cells across threads, slots and warps
        flat = np.repeat(rng.integers(0, cells, n), rng.integers(1, 10, n))[:n]
    x, y, z = np.unravel_index(flat, shape)
    val = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    live = np.ones(n, bool)
    if case == "runs_nan_negative":
        val[rng.uniform(size=n) < 0.05] = np.nan
        live = rng.uniform(size=n) > 0.2
        x = np.where(live, x, -7)  # garbage coordinates under dead keys
    keys = tdep.pack_deposit_key(_i32(x), _i32(y), _i32(z),
                                 torch.as_tensor(live))
    return shape, keys, torch.as_tensor(val), chunk


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["one_cell", "distinct", "overflow",
                                  "runs_nan_negative"])
def test_cuda_window_hash_table_matches_plain(cuda_device, case, dtype,
                                              offset):
    """One cell, all distinct, more distinct cells than table slots, runs
    with NaN and negative values; ``offset`` 1 makes misaligned views (the
    scalar loads).  rtol 1e-4 of the largest cell (1e-3 for one cell of
    50,000 terms, against a float64 sum too)."""
    shape, keys, val, chunk = _window_design_case(
        case, np.random.default_rng(31))
    keys, val = keys[offset:], val[offset:]
    tdt = DTYPES[dtype]
    want = tdep.deposit_window_packed_plain(shape, keys, val, tdt)
    kd, vd = _at(keys, offset, cuda_device), _at(val, offset, cuda_device)
    before = tdep.window_kernel_launches
    got = tdep.deposit_window_packed(shape, kd, vd, chunk=chunk,
                                     dot_dtype=tdt).cpu()
    assert tdep.window_kernel_launches == before + 1
    np.testing.assert_array_equal(np.isnan(got.numpy()),
                                  np.isnan(want.numpy()))
    fin = torch.isfinite(want)
    err = float((got[fin] - want[fin]).abs().max())
    scale = float(want[fin].abs().max())
    rtol = 1e-3 if case == "one_cell" else 1e-4
    assert err <= rtol * scale, (err, scale)
    if case == "one_cell" and dtype == "float32":
        ref = float(val.double().sum())
        assert abs(float(got.sum()) - ref) <= 1e-3 * abs(ref)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_window_counts_each_bad_key(cuda_device, offset):
    """Live keys outside the grid are counted once a row, also when a
    warp's rows share the bad key; dead keys are not counted."""
    rng = np.random.default_rng(32)
    shape = (20, 30, 40)
    n = 4099
    x, y, z = (rng.integers(0, s, n) for s in shape)
    x[64:128] = 20  # one bad key shared by a warp's rows
    z[300:304] = 45  # four in one thread
    y[1000::97] = 1000
    live = np.ones(n, bool)
    live[64:80] = False  # dead under a bad key: not counted
    keys = tdep.pack_deposit_key(_i32(x), _i32(y), _i32(z),
                                 torch.as_tensor(live))[offset:]
    val = torch.as_tensor(rng.uniform(0.1, 1.0, n).astype(np.float32))
    val = val[offset:]
    inside = (x < 20) & (y < 30) & (z < 40)
    n_bad = int((live & ~inside)[offset:].sum())
    before = tdep.out_of_range_count(cuda_device)
    got = tdep.deposit_window_packed(shape, _at(keys, offset, cuda_device),
                                     _at(val, offset, cuda_device),
                                     chunk=256)
    torch.cuda.synchronize(cuda_device)
    assert tdep.out_of_range_count(cuda_device) == before + n_bad
    before_cpu = tdep.out_of_range_count("cpu")
    want = tdep.deposit_window_packed_plain(shape, keys, val)
    assert tdep.out_of_range_count("cpu") == before_cpu + n_bad
    _close(got.cpu().numpy(), want.numpy())
    # leave the card's count at 0 for the tests that read it whole
    tdep._bad_counter(cuda_device).zero_()
