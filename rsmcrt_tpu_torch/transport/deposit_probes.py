"""The deposit design probes of the TPU tools: their hand-written CUDA
kernels and plain twins.

The JAX package's ``tools/`` hold two Pallas kernels that probe designs
for the fluence deposit; both have a counterpart here, in
``csrc/deposit_probes.cu``:

- :func:`serial_deposit` (``tools/profile_deposit_pallas_serial.py``'s
  ``_kernel``): a zeroed ``[ceil(G/128), 128]`` float32 grid to which row
  ``j`` of the first ``(N // block) * block`` rows adds ``val[j]`` at flat
  cell ``idx[j]``.  The rows of a last partial block are dropped, as the
  reference's grid of ``N // block`` steps drops them.
- :func:`onehot_tile_accumulate` (``tools/profile_deposit_design.py``'s
  ``kern``): the ``[H, 128]`` float32 sum over chunks of ``(onehot(hi, H)
  * v)^T @ onehot(lo, 128)``, that is ``tile[hi, lo] += v`` for every row;
  a row with ``hi`` outside ``[0, H)`` or ``lo`` outside ``[0, 128)`` adds
  nothing.

On a CUDA tensor each wrapper launches its kernel, or raises; on a CPU
tensor it runs its plain twin.  There is no fallback between the two: the
device of the tensors decides.  The ``*_kernel_launches`` and
``*_plain_calls`` counters say which one ran.

Where the two differ from the reference, by design: a row of
:func:`serial_deposit` whose cell lies outside the padded grid is never
written, is counted, and makes the wrapper raise (the TPU kernel reads and
writes outside its VMEM buffer); ``N < block`` raises (the reference's
grid of no steps never zeroes its output, which is then undefined); and a
non-finite ``v`` of :func:`onehot_tile_accumulate` reaches only its own
cell in the kernel, where the one-hot product (the reference's, and the
plain twin, which is that product) spreads NaN along the row's tile row
``hi``: every other column of it gets ``v * 0``.  On the TPU an
f32 ``dot_general`` at default precision may take bf16 passes; the CPU's
interpret mode is exact, and the port is held to it.
"""

from __future__ import annotations

import torch

#: kernel launches made by :func:`serial_deposit` (CUDA tensors)
serial_kernel_launches = 0
#: plain-twin calls made by :func:`serial_deposit` (CPU tensors)
serial_plain_calls = 0
#: kernel launches made by :func:`onehot_tile_accumulate` (CUDA tensors)
onehot_kernel_launches = 0
#: plain-twin calls made by :func:`onehot_tile_accumulate` (CPU tensors)
onehot_plain_calls = 0

#: the tile's width, the TPU's lane count
LANES = 128


def reset_counts():
    global serial_kernel_launches, serial_plain_calls
    global onehot_kernel_launches, onehot_plain_calls
    serial_kernel_launches = 0
    serial_plain_calls = 0
    onehot_kernel_launches = 0
    onehot_plain_calls = 0


def padded_rows(G: int) -> int:
    """The grid's rows of 128 cells, ``ceil(G / 128)``."""
    return -(-G // LANES)


def counted_rows(n: int, block: int) -> int:
    """The rows :func:`serial_deposit` adds: its whole blocks."""
    return (n // block) * block


def _check_serial(idx, val, G, block):
    if idx.dtype != torch.int32 or val.dtype != torch.float32:
        raise TypeError(f"idx must be int32 and val float32 (got "
                        f"{idx.dtype}, {val.dtype})")
    if idx.ndim != 1 or idx.shape != val.shape:
        raise ValueError(f"idx {tuple(idx.shape)} and val "
                         f"{tuple(val.shape)} must be the same 1-D shape")
    if idx.device != val.device:
        raise ValueError("idx and val must share a device")
    if G <= 0 or block <= 0:
        raise ValueError(f"G={G} and block={block} must be positive")
    if idx.numel() < block:
        raise ValueError(
            f"N={idx.numel()} < block={block}: the reference's grid has no "
            f"step and never zeroes its output")


def _raise_bad(n_bad: int, size: int):
    if n_bad:
        raise ValueError(f"serial_deposit: {n_bad} rows index cells outside "
                         f"the padded grid [0, {size})")


def serial_deposit_plain(idx: torch.Tensor, val: torch.Tensor, G: int,
                         block: int = 4096):
    """Plain PyTorch twin of the serial kernel: ``(grid, n_bad)``, the
    zeroed ``[ceil(G/128), 128]`` grid plus ``index_add_`` of the counted
    rows whose cell lies in it, and the number of counted rows whose cell
    does not."""
    n = counted_rows(idx.numel(), block)
    size = padded_rows(G) * LANES
    j, v = idx[:n], val[:n]
    ok = (j >= 0) & (j < size)
    out = torch.zeros(size, dtype=torch.float32, device=idx.device)
    out.index_add_(0, j[ok].long(), v[ok])
    return out.view(-1, LANES), int(n - int(ok.sum()))


def _launch_serial(idx, val, G, block):
    """The serial kernel on CUDA tensors: ``(grid, bad)``, ``bad`` a 1-D
    int32 tensor holding the count of out-of-range rows.  One launch,
    counted; no synchronisation."""
    global serial_kernel_launches
    from .. import _build

    dev = idx.device
    n = counted_rows(idx.numel(), block)
    size = padded_rows(G) * LANES
    j, v = idx.contiguous(), val.contiguous()
    # the grid, then one word for the count, zeroed together by the kernel
    buf = torch.empty(size + 1, dtype=torch.float32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.rsmcrt_serial_deposit(
            buf.data_ptr(), size, j.data_ptr(), v.data_ptr(), n,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"serial deposit kernel launch failed: CUDA "
                           f"error {rc}")
    serial_kernel_launches += 1
    return buf[:size].view(-1, LANES), buf[size:].view(torch.int32)


def serial_deposit(idx: torch.Tensor, val: torch.Tensor, G: int,
                   block: int = 4096, unroll: int = 8, *,
                   check: bool = True) -> torch.Tensor:
    """The serial probe's grid: ``[ceil(G/128), 128]`` float32, zero but
    for ``val[j]`` added at flat cell ``idx[j]`` for ``j < (N // block) *
    block``.

    ``idx``: int32 ``[N]``; ``val``: float32 ``[N]``; ``N >= block``.
    ``unroll`` is the reference's and changes nothing.  A counted row
    whose cell lies outside the padded grid raises ``ValueError`` (on a
    CUDA tensor that reads the kernel's count back, a synchronisation;
    ``check=False`` skips it, for timing)."""
    global serial_plain_calls
    del unroll
    _check_serial(idx, val, G, block)
    size = padded_rows(G) * LANES
    dev = idx.device
    if dev.type == "cpu":
        serial_plain_calls += 1
        out, n_bad = serial_deposit_plain(idx, val, G, block)
        _raise_bad(n_bad, size)
        return out
    if dev.type != "cuda":
        raise NotImplementedError(f"no serial deposit kernel for {dev.type}")
    out, bad = _launch_serial(idx, val, G, block)
    if check:
        _raise_bad(int(bad.item()), size)
    return out


def _check_tile(hi, lo, v, H):
    if hi.dtype != torch.int32 or lo.dtype != torch.int32 \
            or v.dtype != torch.float32:
        raise TypeError(f"hi and lo must be int32 and v float32 (got "
                        f"{hi.dtype}, {lo.dtype}, {v.dtype})")
    if not hi.shape == lo.shape == v.shape:
        raise ValueError(f"hi {tuple(hi.shape)}, lo {tuple(lo.shape)} and v "
                         f"{tuple(v.shape)} differ in shape")
    if not hi.device == lo.device == v.device:
        raise ValueError("hi, lo and v must share a device")
    if not 0 < H < 2**31 // LANES:
        raise ValueError(f"H={H} must be in [1, {2**31 // LANES})")


def onehot_tile_accumulate_plain(hi: torch.Tensor, lo: torch.Tensor,
                                 v: torch.Tensor, H: int) -> torch.Tensor:
    """Plain PyTorch twin of the tile kernel: the tool's own two-sided
    one-hot product of each chunk (``mk_mxu``), summed over the chunks.
    ``hi``, ``lo``, ``v``: ``[nchunk, C]`` (or ``[C]``, one chunk)."""
    hi, lo, v = (t.reshape(-1, t.shape[-1]) for t in (hi, lo, v))
    rows = torch.arange(H, dtype=torch.int32, device=v.device)
    cols = torch.arange(LANES, dtype=torch.int32, device=v.device)
    # XLA folds the tool's convert-and-multiply into a select: an
    # infinite v reaches only its row of ohi, as here
    ohi = torch.where(hi[..., None] == rows, v[..., None], 0.0)
    olo = (lo[..., None] == cols).to(torch.float32)
    return torch.einsum("nch,ncw->nhw", ohi, olo).sum(0)


def onehot_tile_accumulate(hi: torch.Tensor, lo: torch.Tensor,
                           v: torch.Tensor, H: int) -> torch.Tensor:
    """The ``[H, 128]`` float32 tile with ``v[j]`` added at ``(hi[j],
    lo[j])`` for every row whose ``hi`` lies in ``[0, H)`` and ``lo`` in
    ``[0, 128)`` (every other row adds nothing).

    ``hi``, ``lo``: int32; ``v``: float32; all of one shape, the tool's
    ``[nchunk, C]``.  On a CUDA tensor this launches
    ``csrc/deposit_probes.cu``'s ``onehot_tile_kernel`` (one RED a row into
    the zeroed tile); on a CPU tensor it runs
    :func:`onehot_tile_accumulate_plain`."""
    global onehot_kernel_launches, onehot_plain_calls
    _check_tile(hi, lo, v, H)
    dev = v.device
    if dev.type == "cpu":
        onehot_plain_calls += 1
        return onehot_tile_accumulate_plain(hi, lo, v, H)
    if dev.type != "cuda":
        raise NotImplementedError(f"no tile kernel for {dev.type}")
    a, b, x = (t.reshape(-1).contiguous() for t in (hi, lo, v))
    tile = torch.empty((H, LANES), dtype=torch.float32, device=dev)
    from .. import _build

    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.rsmcrt_onehot_tile(
            tile.data_ptr(), H, a.data_ptr(), b.data_ptr(), x.data_ptr(),
            x.numel(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tile kernel launch failed: CUDA error {rc}")
    onehot_kernel_launches += 1
    return tile
