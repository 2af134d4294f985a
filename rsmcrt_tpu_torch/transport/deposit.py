"""Voxel tally deposits: the hand-written CUDA kernels and their plain
twins.

Port of ``rsmcrt_tpu/transport/deposit.py``, whose two Pallas kernels both
have a counterpart here:

- ``deposit_delta`` (the Pallas ``_deposit_kernel``) sums N voxel deposits
  into a fresh delta grid.  Here :func:`deposit_add_` adds them into the
  running tally in place, which saves zeroing and re-adding the whole grid
  on every call; :func:`deposit_delta` keeps the JAX signature on top of
  it.  On a CUDA tensor it launches ``csrc/deposit.cu``; on a CPU tensor
  it runs :func:`deposit_add_plain`.  ``signed=True`` keeps every finite
  ``val != 0`` row in place of every ``val > 0`` row (the phasor tally).
  A float64 tally takes float64 values and the kernel's ``double``
  instantiation (a float64 run); a float32 tally takes float32 values.
  Under grad mode, with ``val`` requiring a gradient, the launch goes
  through :class:`_DepositAdd`, a ``torch.autograd.Function`` whose
  backward is the hand-written gather :func:`deposit_gather` (the
  transpose of the sum: each kept row gets its cell's gradient);
  otherwise it is the direct launch, so a forward run pays nothing.  On a
  CPU tensor ``index_add_`` is differentiable itself.
- ``deposit_window_packed`` (the Pallas ``_window_kernel``) sums packed
  ``(ix << 20) | (iy << 10) | iz`` keys into a fresh grid.  On a CUDA
  tensor it launches ``csrc/deposit_window.cu``; on a CPU tensor it runs
  :func:`deposit_window_packed_plain`.  :func:`deposit_window_delta`,
  :func:`pack_deposit_key`, :func:`morton_key_3d` and
  :func:`morton_key_xy` keep the JAX names and contracts.

There is no fallback between a kernel and its twin: the device of the
tensors decides.  The ``*_kernel_launches`` and ``*_plain_calls`` counters
say which one ran.  ``dot_dtype=torch.bfloat16`` rounds each value to
bfloat16 (nearest even) before the float32 sum, as the TPU kernels' bf16
contraction does.
"""

from __future__ import annotations

import torch

#: kernel launches made by :func:`deposit_add_` (CUDA tensors)
deposit_kernel_launches = 0
#: plain-version calls made by :func:`deposit_add_` (CPU tensors)
deposit_plain_calls = 0
#: kernel launches made by :func:`deposit_window_packed` (CUDA tensors)
window_kernel_launches = 0
#: plain-version calls made by :func:`deposit_window_packed` (CPU tensors)
window_plain_calls = 0
#: kernel launches made by :func:`deposit_gather` (CUDA tensors)
gather_kernel_launches = 0
#: plain-version calls made by :func:`deposit_gather` (CPU tensors)
gather_plain_calls = 0
#: :func:`deposit_add_` calls on CUDA tensors that went through the autograd
#: Function (each is owed one :func:`deposit_gather` in the backward)
deposit_autograd_calls = 0

_BIG = 2**30  # the dead packed key

# per-device int32 count of deposits whose index was out of range
_bad: dict = {}


def reset_counts():
    global deposit_kernel_launches, deposit_plain_calls
    global window_kernel_launches, window_plain_calls
    global gather_kernel_launches, gather_plain_calls, deposit_autograd_calls
    deposit_kernel_launches = 0
    deposit_plain_calls = 0
    window_kernel_launches = 0
    window_plain_calls = 0
    gather_kernel_launches = 0
    gather_plain_calls = 0
    deposit_autograd_calls = 0


def _round_bf16(dot_dtype, val_dtype=torch.float32) -> bool:
    """Whether values round to bfloat16; a float64 deposit has none (the
    reference's float64 run has no bfloat16 contraction)."""
    if dot_dtype == torch.float32:
        return False
    if dot_dtype == torch.bfloat16:
        if val_dtype == torch.float64:
            raise TypeError("dot_dtype=bfloat16 takes float32 values, not "
                            "float64")
        return True
    raise TypeError(f"dot_dtype must be float32 or bfloat16, not {dot_dtype}")


def _as_dot(val: torch.Tensor, dot_dtype) -> torch.Tensor:
    """Each value rounded to ``dot_dtype`` and back to float32."""
    if _round_bf16(dot_dtype, val.dtype):
        return val.to(torch.bfloat16).to(torch.float32)
    return val


def _bad_counter(device: torch.device) -> torch.Tensor:
    key = (device.type, device.index)
    if key not in _bad:
        _bad[key] = torch.zeros((), dtype=torch.int32, device=device)
    return _bad[key]


def out_of_range_count(device) -> int:
    """Deposits whose index lay outside the tally, summed over every call
    on ``device``: kept rows of :func:`deposit_add_`
    kernel launches and live keys of :func:`deposit_window_packed` (a
    caller bug; must stay 0)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return int(_bad_counter(device).item())


def _kept(val: torch.Tensor, signed: bool) -> torch.Tensor:
    """The rows a deposit keeps: ``val > 0``, or with ``signed`` every
    finite ``val != 0``."""
    if signed:
        return (val != 0.0) & torch.isfinite(val)
    return val > 0.0


def deposit_add_plain(tally_flat: torch.Tensor, flat_idx: torch.Tensor,
                      val: torch.Tensor, dot_dtype=torch.float32,
                      signed: bool = False) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: ``tally[idx] += val`` over the
    kept rows (``val > 0``; with ``signed``, finite ``val != 0``), in
    place."""
    live = _kept(val, signed)
    return tally_flat.index_add_(0, flat_idx[live].long(),
                                 _as_dot(val[live], dot_dtype))


def _check(tally_flat, flat_idx, val):
    if tally_flat.ndim != 1 or tally_flat.dtype not in (torch.float32,
                                                        torch.float64):
        raise TypeError("tally_flat must be a 1-D float32 or float64 tensor")
    if not tally_flat.is_contiguous():
        raise ValueError("tally_flat must be contiguous")
    if flat_idx.dtype != torch.int32 or val.dtype != tally_flat.dtype:
        raise TypeError(f"flat_idx must be int32 and val {tally_flat.dtype} "
                        f"as the tally (got {flat_idx.dtype}, {val.dtype})")
    if flat_idx.shape != val.shape:
        raise ValueError(f"flat_idx {tuple(flat_idx.shape)} and val "
                         f"{tuple(val.shape)} differ in shape")
    if flat_idx.device != tally_flat.device or val.device != tally_flat.device:
        raise ValueError("tally_flat, flat_idx and val must share a device")


def _launch_add(tally_flat, idx, v, round_bf16: bool, signed: bool):
    """The deposit kernel on CUDA tensors (``idx``, ``v`` contiguous, 1-D,
    non-empty): one launch, counted."""
    global deposit_kernel_launches
    from .. import _build

    dev = tally_flat.device
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.rsmcrt_deposit_add(
            tally_flat.data_ptr(), idx.data_ptr(), v.data_ptr(), idx.numel(),
            tally_flat.numel(), int(round_bf16), int(signed),
            int(tally_flat.dtype == torch.float64),
            _bad_counter(dev).data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"deposit kernel launch failed: CUDA error {rc}")
    deposit_kernel_launches += 1


class _DepositAdd(torch.autograd.Function):
    """The deposit kernel under autograd: the forward adds in place (the
    tally is marked dirty, so a view of a tally rebases its base's
    history); the backward passes the tally's gradient on unchanged and
    gives ``val`` the gather of it (:func:`deposit_gather`).  Only the
    indices and values are saved: the tally may change again before the
    backward, and the backward never reads it."""

    @staticmethod
    def forward(ctx, tally_flat, idx, v, signed):
        _launch_add(tally_flat, idx, v, False, signed)
        ctx.mark_dirty(tally_flat)
        ctx.save_for_backward(idx, v)
        ctx.signed = signed
        return tally_flat

    @staticmethod
    def backward(ctx, grad_tally):
        idx, v = ctx.saved_tensors
        grad_val = None
        if ctx.needs_input_grad[2]:
            grad_val = deposit_gather(grad_tally, idx, v, ctx.signed)
        return grad_tally, None, grad_val, None


def deposit_add_(tally_flat: torch.Tensor, flat_idx: torch.Tensor,
                 val: torch.Tensor, dot_dtype=torch.float32,
                 signed: bool = False) -> torch.Tensor:
    """Add every ``val > 0`` into ``tally_flat[flat_idx]`` in place; with
    ``signed``, every finite ``val != 0`` (one kernel, the keep test a
    template parameter).

    ``tally_flat``: float32 or float64 ``[nx*ny*nz]``; ``flat_idx``:
    int32, flattened as ``voxel_flat_index`` does (``(x*ny + y)*nz + z``);
    ``val``: the tally's type, of the same shape.  Differentiable in
    ``val`` and ``tally_flat`` (the gradient of ``val`` is the tally's
    gradient at each kept row, 0 elsewhere), except with
    ``dot_dtype=bfloat16``, which raises under grad mode.  Returns
    ``tally_flat``."""
    global deposit_plain_calls, deposit_autograd_calls
    _check(tally_flat, flat_idx, val)
    round_bf16 = _round_bf16(dot_dtype, val.dtype)
    grad = torch.is_grad_enabled() and val.requires_grad
    if round_bf16 and grad:
        raise RuntimeError("the bfloat16 deposit is not differentiable: "
                           "run it under torch.no_grad() or in float32")
    dev = tally_flat.device
    if dev.type == "cpu":
        deposit_plain_calls += 1
        return deposit_add_plain(tally_flat, flat_idx, val, dot_dtype, signed)
    if dev.type != "cuda":
        raise NotImplementedError(f"no deposit kernel for {dev.type}")
    idx = flat_idx.reshape(-1).contiguous()
    v = val.reshape(-1).contiguous()
    if idx.numel() == 0:
        return tally_flat
    if grad:
        deposit_autograd_calls += 1
        return _DepositAdd.apply(tally_flat, idx, v, signed)
    _launch_add(tally_flat, idx, v, round_bf16, signed)
    return tally_flat


def deposit_gather_plain(grad_tally: torch.Tensor, flat_idx: torch.Tensor,
                         val: torch.Tensor,
                         signed: bool = False) -> torch.Tensor:
    """Plain PyTorch twin of the gather kernel: ``grad_tally[idx]`` on the
    rows :func:`deposit_add_` keeps (the same test) whose index lies in
    the tally, 0 on every other row."""
    n = grad_tally.shape[0]
    ok = _kept(val, signed) & (flat_idx >= 0) & (flat_idx < n)
    safe = torch.where(ok, flat_idx, 0).long()
    return torch.where(ok, grad_tally.index_select(0, safe.reshape(-1))
                       .reshape(safe.shape), 0.0)


def deposit_gather(grad_tally: torch.Tensor, flat_idx: torch.Tensor,
                   val: torch.Tensor, signed: bool = False) -> torch.Tensor:
    """The backward of :func:`deposit_add_` for ``val``: a fresh tensor of
    ``val``'s shape holding ``grad_tally[flat_idx]`` on every row the
    deposit keeps (``val > 0``; with ``signed`` every finite ``val !=
    0``) whose index lies in the tally, 0 elsewhere.  On a CUDA tensor it
    launches ``csrc/deposit.cu``'s ``deposit_gather_kernel`` (one thread a
    row); on a CPU tensor it runs :func:`deposit_gather_plain`."""
    global gather_kernel_launches, gather_plain_calls
    g = grad_tally.contiguous()  # an expanded gradient has stride 0
    _check(g, flat_idx, val)
    dev = g.device
    if dev.type == "cpu":
        gather_plain_calls += 1
        return deposit_gather_plain(g, flat_idx, val, signed)
    if dev.type != "cuda":
        raise NotImplementedError(f"no gather kernel for {dev.type}")
    idx = flat_idx.reshape(-1).contiguous()
    v = val.reshape(-1).contiguous()
    out = torch.empty_like(v)
    if idx.numel() == 0:
        return out.reshape(val.shape)
    from .. import _build

    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.rsmcrt_deposit_gather(
            out.data_ptr(), g.data_ptr(), idx.data_ptr(), v.data_ptr(),
            idx.numel(), g.numel(), int(signed),
            int(g.dtype == torch.float64),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gather kernel launch failed: CUDA error {rc}")
    gather_kernel_launches += 1
    return out.reshape(val.shape)


def deposit_delta(grid_shape, x, y, z, val,
                  dot_dtype=torch.float32) -> torch.Tensor:
    """The JAX ``deposit_delta`` contract: N deposits (int32 voxel
    coordinates ``x, y, z``, float32 ``val``; ``val <= 0`` ignored) summed
    into a fresh ``[nx, ny, nz]`` grid."""
    nx, ny, nz = grid_shape
    out = torch.zeros(nx * ny * nz, dtype=torch.float32, device=val.device)
    live = val > 0.0
    flat = ((x * ny + y) * nz + z).to(torch.int32)
    # dead rows may carry any coordinates: point them at cell 0
    flat = torch.where(live, flat, 0)
    deposit_add_(out, flat, val.to(torch.float32), dot_dtype)
    return out.reshape(nx, ny, nz)


# --- the windowed kernel over packed keys ---------------------------------

#: most slots of the window kernel's shared hash table (4096 x 8 bytes =
#: 32 KB a block, so that four blocks of 512 threads fit an SM)
MAX_TABLE_SLOTS = 4096


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def pack_deposit_key(ix, iy, iz, live) -> torch.Tensor:
    """Pack int32 voxel coordinates into the window kernel's deposit key
    (lexicographic order = x-major); dead deposits get ``_BIG``."""
    key = ((ix.to(torch.int32) << 20) | (iy.to(torch.int32) << 10)
           | iz.to(torch.int32))
    return torch.where(live, key, _BIG).to(torch.int32)


def _decode(keys: torch.Tensor):
    """Unsigned decode of int32 keys, as the TPU kernel's logical shifts."""
    k = keys.to(torch.int64) & 0xFFFFFFFF
    return k >> 20, (k >> 10) & 1023, k & 1023


def deposit_window_packed_plain(grid_shape, keys: torch.Tensor,
                                val: torch.Tensor,
                                dot_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch twin of the window kernel: decode the keys and
    ``index_add_`` every live one into a fresh ``[nx, ny, nz]`` grid.
    Live keys outside the grid are counted, not written."""
    nx, ny, nz = grid_shape
    ix, iy, iz = _decode(keys)
    live = keys != _BIG
    inside = (ix < nx) & (iy < ny) & (iz < nz)
    bad = live & ~inside
    counter = _bad_counter(keys.device)
    counter += torch.sum(bad, dtype=torch.int32)
    m = live & inside
    flat = (ix * ny + iy) * nz + iz
    out = torch.zeros(nx * ny * nz, dtype=torch.float32, device=val.device)
    out.index_add_(0, flat[m], _as_dot(val.to(torch.float32)[m], dot_dtype))
    return out.reshape(nx, ny, nz)


def _check_window(grid_shape, chunk, window):
    """The JAX entry point's checks on the grid, chunk and window."""
    nx, ny, nz = grid_shape
    if max(nx, ny, nz) > 1024:
        raise ValueError("grid dims must be <= 1024 for packed keys")
    if chunk <= 0 or chunk % 128:
        raise ValueError(f"chunk={chunk} must be a positive multiple of 128")
    if min(window[1], _round_up(ny, 8)) % 8:
        raise ValueError(f"wy={window[1]} must be a multiple of 8")


def table_slot_bits(chunk: int) -> int:
    """log2 of the slots of the window kernel's shared hash table for a
    chunk of ``chunk`` keys: the power of two at or above twice the chunk
    (a table at most half full), at most :data:`MAX_TABLE_SLOTS`.  A chunk
    with more distinct cells than the table holds sends the rest straight
    to the grid."""
    return min((2 * chunk - 1).bit_length(),
               MAX_TABLE_SLOTS.bit_length() - 1)


def deposit_window_packed(grid_shape, keys: torch.Tensor, val: torch.Tensor,
                          *, chunk: int = 2048, window=(32, 32, 32),
                          dot_dtype=torch.float32) -> torch.Tensor:
    """Accumulate N packed deposits into a fresh ``[nx, ny, nz]`` grid.

    ``keys``: int32 ``[N]`` from :func:`pack_deposit_key` (``_BIG`` =
    dead; rows ordered so that near deposits are adjacent, e.g. lanes
    sorted by :func:`morton_key_3d`, merge more deposits in a block before
    they reach the grid).  ``val``:
    float32 ``[N]``; every live key's value is added, ``val <= 0``
    included.  On a CUDA tensor this launches ``csrc/deposit_window.cu``
    (one block per ``chunk`` keys, summed in a shared hash table of
    ``2 ** table_slot_bits(chunk)`` slots); on a CPU tensor it runs
    :func:`deposit_window_packed_plain`.  ``window`` is checked as the JAX
    entry point checks it and kept for parity; it no longer sizes
    anything."""
    global window_kernel_launches, window_plain_calls
    _check_window(grid_shape, chunk, window)
    round_bf16 = _round_bf16(dot_dtype)
    if keys.dtype != torch.int32 or val.dtype != torch.float32:
        raise TypeError("keys must be int32 and val float32")
    if keys.shape != val.shape or keys.ndim != 1:
        raise ValueError(f"keys {tuple(keys.shape)} and val "
                         f"{tuple(val.shape)} must be the same 1-D shape")
    if keys.device != val.device:
        raise ValueError("keys and val must share a device")
    dev = keys.device
    if dev.type == "cpu":
        window_plain_calls += 1
        return deposit_window_packed_plain(grid_shape, keys, val, dot_dtype)
    if dev.type != "cuda":
        raise NotImplementedError(f"no window kernel for {dev.type}")
    nx, ny, nz = grid_shape
    out = torch.zeros(nx * ny * nz, dtype=torch.float32, device=dev)
    k, v = keys.contiguous(), val.contiguous()
    n = k.numel()
    if n == 0:
        return out.reshape(nx, ny, nz)
    from .. import _build

    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.rsmcrt_deposit_window(
            out.data_ptr(), k.data_ptr(), v.data_ptr(), n, nx, ny, nz,
            chunk, table_slot_bits(chunk), int(round_bf16),
            _bad_counter(dev).data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"window kernel launch failed: CUDA error {rc}")
    window_kernel_launches += 1
    return out.reshape(nx, ny, nz)


def deposit_window_delta(grid_shape, x, y, z, val, *, chunk: int = 2048,
                         window=(32, 32, 32),
                         dot_dtype=torch.float32) -> torch.Tensor:
    """xyz-coordinate wrapper over :func:`deposit_window_packed` (the
    :func:`deposit_delta` contract: ``val <= 0`` ignored)."""
    keys = pack_deposit_key(x, y, z, val > 0.0)
    return deposit_window_packed(grid_shape, keys, val.to(torch.float32),
                                 chunk=chunk, window=window,
                                 dot_dtype=dot_dtype)


def morton_key_3d(ix, iy, iz) -> torch.Tensor:
    """Interleave the low 10 bits of three int32 coordinate tensors into a
    30-bit Morton (z-order) key: the lane sort key for
    :func:`deposit_window_packed` chunk locality."""

    def part1by2(a):
        a = a & 0x3FF
        a = (a | (a << 16)) & 0x030000FF
        a = (a | (a << 8)) & 0x0300F00F
        a = (a | (a << 4)) & 0x030C30C3
        return (a | (a << 2)) & 0x09249249

    def c(a):
        return torch.clamp(a.to(torch.int32), 0, 1023)

    return (part1by2(c(ix)) | (part1by2(c(iy)) << 1)
            | (part1by2(c(iz)) << 2))


def morton_key_xy(ix, iy) -> torch.Tensor:
    """Interleave the low 16 bits of two int32 coordinate tensors into a
    Morton (z-order) key (int32, wrapping like the reference's)."""

    def part1by1(a):
        a = a & 0xFFFF
        a = (a | (a << 8)) & 0x00FF00FF
        a = (a | (a << 4)) & 0x0F0F0F0F
        a = (a | (a << 2)) & 0x33333333
        return (a | (a << 1)) & 0x55555555

    def c(a):
        return torch.clamp(a.to(torch.int32), min=0)

    return part1by1(c(ix)) | (part1by1(c(iy)) << 1)
